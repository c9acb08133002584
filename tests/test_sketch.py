"""Vectorized sketch vs exact scalar oracle (bit-exactness)."""
import numpy as np
import pytest

from mappy_rs_tpu.index.sketch_host import sketch_host
from mappy_rs_tpu.ops.sketch import sketch, sketch_compact
from mappy_rs_tpu.utils.seqcodes import encode, read_fastx



def _batchify(tests, L=None):
    L = L or max(len(s) for s in tests)
    B = len(tests)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(tests):
        c = encode(s)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return codes, lens


def _compare(tests, k, w):
    import jax.numpy as jnp

    codes, lens = _batchify(tests)
    out = sketch(jnp.asarray(codes), jnp.asarray(lens), k, w)
    mins = np.asarray(out["minimizer"])
    kh = np.asarray(out["key_hi"])
    kl = np.asarray(out["key_lo"])
    st = np.asarray(out["strand"])
    for i, s in enumerate(tests):
        oracle = sorted(
            (key, pos, z) for key, _, pos, z in sketch_host(encode(s), k, w, 0)
        )
        got = sorted(
            ((int(kh[i, j]) << 32) | int(kl[i, j]), j, int(st[i, j]))
            for j in np.nonzero(mins[i])[0]
        )
        assert oracle == got, f"mismatch for read {i} (k={k}, w={w})"


@pytest.mark.parametrize("k,w", [(15, 10), (19, 19), (21, 11)])
def test_sketch_vs_oracle_random(k, w, test_fa):
    rng = np.random.default_rng(42)
    tests = [s for _, s in read_fastx(test_fa)]
    for _ in range(30):
        n = int(rng.integers(k, 150))
        tests.append(
            "".join(rng.choice(list("ACGTN"), p=[0.23] * 4 + [0.08], size=n))
        )
    for _ in range(20):  # tie-heavy two-letter alphabet
        n = int(rng.integers(k, 120))
        tests.append("".join(rng.choice(list("AC"), size=n)))
    _compare(tests, k, w)


def test_sketch_compact_matches_mask(test_fa):
    import jax.numpy as jnp

    tests = [s for _, s in read_fastx(test_fa)]
    codes, lens = _batchify(tests)
    full = sketch(jnp.asarray(codes), jnp.asarray(lens), 15, 10)
    comp = sketch_compact(jnp.asarray(codes), jnp.asarray(lens), 15, 10, 128)
    mask = np.asarray(full["minimizer"])
    for i in range(len(tests)):
        positions = np.nonzero(mask[i])[0]
        n = int(comp["n"][i])
        assert n == len(positions)
        assert np.array_equal(np.asarray(comp["pos"][i][:n]), positions)
