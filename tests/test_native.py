"""Native C++ runtime vs python fallbacks (traceback, encode), and the
loader's build rule."""
import os

import numpy as np
import pytest

from mappy_rs_tpu import native
from mappy_rs_tpu.ops.cigar import traceback_one, unpack_ops
from mappy_rs_tpu.ops.extend import ExtendParams, extend_dp
from mappy_rs_tpu.utils.seqcodes import encode as py_encode


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_encode_matches_python():
    s = "ACGTNacgtnXYZuU"
    assert np.array_equal(native.encode(s), py_encode(s))


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_traceback_matches_python():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    P = ExtendParams(2, 4, 4, 2, 24, 1, 1)
    QMAX = TMAX = 128
    W = 64
    J = 8
    q = np.full((J, QMAX), 4, np.uint8)
    t = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for i in range(J):
        n = int(rng.integers(30, 120))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        for _ in range(rng.integers(0, 6)):
            p = int(rng.integers(0, len(b)))
            b[p] = (b[p] + 1) % 4
        q[i, :n] = a
        t[i, : len(b)] = b
        ql[i], tl[i] = n, len(b)
    out = extend_dp(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl),
        QMAX, TMAX, W, P,
    )
    dirs = np.asarray(out["dirs"])
    got = native.traceback_batch(dirs, ql, tl, ql - 1, tl - 1)
    assert got is not None
    for i in range(J):
        exp = traceback_one(dirs[:, i, :], int(ql[i]), int(tl[i]), W,
                            int(ql[i]) - 1, int(tl[i]) - 1)
        # traceback_batch returns packed int32 (len<<4|op) arrays
        assert unpack_ops(got[i]) == exp, f"job {i}"


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_small_dp_matches_device_path():
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    P = ExtendParams(2, 4, 4, 2, 24, 1, 1)
    J = 16
    QS, TS = 64, 128
    q = np.full((J, QS), 4, np.uint8)
    t = np.full((J, TS), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for i in range(J):
        n = int(rng.integers(5, 60))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = list(a)
        for _ in range(int(rng.integers(0, 4))):
            p_ = int(rng.integers(0, len(b)))
            op = rng.integers(0, 3)
            if op == 0:
                b[p_] = (b[p_] + 1) % 4
            elif op == 1:
                b.insert(p_, int(rng.integers(0, 4)))
            else:
                del b[p_]
        b = (b + [int(x) for x in rng.integers(0, 4, 30)])[: TS]
        q[i, :n] = a
        t[i, : len(b)] = b
        ql[i], tl[i] = n, len(b)
    # device reference (W covers everything -> unbanded semantics)
    dev = extend_dp(
        jnp.asarray(np.pad(q, ((0, 0), (0, 128 - QS)), constant_values=4)),
        jnp.asarray(np.pad(t, ((0, 0), (0, 128 - TS)), constant_values=4))
        if TS < 128 else jnp.asarray(t),
        jnp.asarray(ql), jnp.asarray(tl), 128, max(TS, 128), 256, P,
    )
    for mode in (0, 1):
        got = native.extend_small_batch(q, t, ql, tl, P, -1, mode)
        assert got is not None
        dirs = np.asarray(dev["dirs"])
        for i in range(J):
            ops, sc, qc, tc = got[i]
            ops = unpack_ops(ops)
            if mode == 0:
                exp_sc = int(dev["end_sc"][i])
                exp = traceback_one(
                    dirs[:, i, :], int(ql[i]), int(tl[i]), 256,
                    int(ql[i]) - 1, int(tl[i]) - 1,
                )
                assert sc == exp_sc, f"job {i} end_sc"
                assert ops == exp, f"job {i} global cigar"
            else:
                g_sc, b_sc = int(dev["g_sc"][i]), int(dev["best_sc"][i])
                use_end = g_sc > -(1 << 27) and g_sc + (-1) >= b_sc
                if use_end and g_sc > 0:
                    exp_cell = (int(ql[i]) - 1, int(dev["g_j"][i]), g_sc)
                elif b_sc > 0:
                    exp_cell = (int(dev["best_i"][i]), int(dev["best_j"][i]), b_sc)
                else:
                    assert ops == [] and sc == 0
                    continue
                assert (qc - 1, tc - 1, sc) == exp_cell, f"job {i} cell"
                exp = traceback_one(
                    dirs[:, i, :], int(ql[i]), int(tl[i]), 256,
                    exp_cell[0], exp_cell[1],
                )
                assert ops == exp, f"job {i} ext cigar"


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_banded_matches_device_path():
    import jax.numpy as jnp

    rng = np.random.default_rng(33)
    P = ExtendParams(2, 4, 4, 2, 24, 1, 1)
    J = 8
    QS = TS = 300
    W = 128
    q = np.full((J, QS), 4, np.uint8)
    t = np.full((J, TS), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for i in range(J):
        n = int(rng.integers(100, 290))
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = list(a)
        for _ in range(int(rng.integers(0, 12))):
            p_ = int(rng.integers(0, len(b)))
            op = rng.integers(0, 3)
            if op == 0:
                b[p_] = (b[p_] + 1) % 4
            elif op == 1:
                b.insert(p_, int(rng.integers(0, 4)))
            else:
                del b[p_]
        b = np.asarray(b[:TS], np.uint8)
        q[i, :n] = a
        t[i, : len(b)] = b
        ql[i], tl[i] = n, len(b)
    QMAX = TMAX = 512
    dev = extend_dp(
        jnp.asarray(np.pad(q, ((0, 0), (0, QMAX - QS)), constant_values=4)),
        jnp.asarray(np.pad(t, ((0, 0), (0, TMAX - TS)), constant_values=4)),
        jnp.asarray(ql), jnp.asarray(tl), QMAX, TMAX, W, P,
    )
    dirs = np.asarray(dev["dirs"])
    for mode in (0, 1):
        got = native.extend_banded_batch(q, t, ql, tl, W, P, -1, mode)
        assert got is not None
        for i in range(J):
            ops, sc, qc, tc, _zflag = got[i]
            ops = unpack_ops(ops)
            if mode == 0:
                assert sc == int(dev["end_sc"][i]), f"job {i} end_sc"
                exp = traceback_one(
                    dirs[:, i, :], int(ql[i]), int(tl[i]), W,
                    int(ql[i]) - 1, int(tl[i]) - 1,
                )
                assert ops == exp, f"job {i} global cigar"
            else:
                g_sc, b_sc = int(dev["g_sc"][i]), int(dev["best_sc"][i])
                use_end = g_sc > -(1 << 27) and g_sc + (-1) >= b_sc
                if use_end and g_sc > 0:
                    cell = (int(ql[i]) - 1, int(dev["g_j"][i]), g_sc)
                elif b_sc > 0:
                    cell = (int(dev["best_i"][i]), int(dev["best_j"][i]), b_sc)
                else:
                    assert ops == []
                    continue
                assert (qc - 1, tc - 1, sc) == cell, f"job {i} cell"
                exp = traceback_one(
                    dirs[:, i, :], int(ql[i]), int(tl[i]), W, cell[0], cell[1]
                )
                assert ops == exp, f"job {i} cigar"


def test_loader_rebuilds_stale_library(tmp_path, monkeypatch):
    """ensure_built compiles when the library is absent or older than a
    source, and leaves a fresh one alone."""
    so = str(tmp_path / "lib.so")
    built = []
    monkeypatch.setattr(
        native, "build", lambda path: (built.append(path),
                                       open(path, "w").close())
    )
    native.ensure_built(so)  # absent
    assert built == [so]
    native.ensure_built(so)  # fresh
    assert built == [so]
    newest = max(
        os.path.getmtime(os.path.join(native._DIR, s))
        for s in native.SOURCES
    )
    os.utime(so, (newest - 10, newest - 10))  # older than the sources
    assert native.is_stale(so)
    native.ensure_built(so)
    assert built == [so, so]


def test_compile_command_uses_cxx_and_arch(monkeypatch):
    monkeypatch.setenv("CXX", "my-c++")
    monkeypatch.setenv("MAPPY_NATIVE_ARCH", "x86-64-v3")
    cmd = native.compile_command("/x/lib.so")
    assert cmd[0] == "my-c++" and "-march=x86-64-v3" in cmd
    assert cmd[-2:] == ["-o", "/x/lib.so"]
    assert [os.path.basename(c) for c in cmd if c.endswith(".cc")] == list(
        native.SOURCES
    )
