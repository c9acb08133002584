"""Narrow logical bands (mid_band_floor/slack): the C++ engine at a
narrow W must agree with the XLA banded DP (ops/extend.py) at the
same W."""
import numpy as np
import pytest

from mappy_rs_tpu.ops.extend import ExtendParams, extend_dp

P = ExtendParams(a=2, b=4, q=4, e=2, q2=24, e2=1, sc_ambi=1)


def _jobs(J=8, n=300, err=0.06, seed=5):
    rng = np.random.default_rng(seed)
    QS = TS = 384
    q = np.full((J, QS), 4, np.uint8)
    t = np.full((J, TS), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for i in range(J):
        m = int(rng.integers(n - 40, n + 40))
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = list(a)
        for p in rng.integers(0, m - 4, int(m * err)):
            r = rng.random()
            if r < 0.5:
                b[p] = (b[p] + 1) % 4
            elif r < 0.75:
                b.insert(p, rng.integers(0, 4))
            else:
                del b[p]
        b = np.asarray(b[: TS], np.uint8)
        q[i, :m] = a
        t[i, : len(b)] = b
        ql[i], tl[i] = m, len(b)
    return q, t, ql, tl


def test_native_engine_same_w(monkeypatch):
    """C++ engine at W=64 equals the XLA DP at W=64 on scores."""
    import jax.numpy as jnp

    from mappy_rs_tpu import native

    if not native.available():
        pytest.skip("native lib unavailable")
    q, t, ql, tl = _jobs(seed=13)
    W = 64
    dev = extend_dp(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl),
        q.shape[1], t.shape[1], W, P,
    )
    host = native.extend_banded_batch(q, t, ql, tl, W, P, 0, 1, 0)
    for j in range(len(ql)):
        assert host[j][1] == int(np.asarray(dev["best_sc"])[j])
