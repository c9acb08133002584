"""Banded extension DP vs full-matrix brute force."""
import numpy as np
import pytest

from mappy_rs_tpu.ops.cigar import (
    cigar_spans,
    cigar_stats,
    gen_cs,
    gen_md,
    traceback_one,
)
from mappy_rs_tpu.ops.extend import ExtendParams, extend_dp
from mappy_rs_tpu.utils.seqcodes import encode

P = ExtendParams(a=2, b=4, q=4, e=2, q2=24, e2=1, sc_ambi=1)


def brute_global(q, t, p):
    Q, T = len(q), len(t)
    NEG = -(10**9)

    def gap(l):
        return min(p.q + l * p.e, p.q2 + l * p.e2) if l > 0 else 0

    H = np.full((Q + 1, T + 1), NEG, np.int64)
    E1 = np.full_like(H, NEG)
    E2 = np.full_like(H, NEG)
    F1 = np.full_like(H, NEG)
    F2 = np.full_like(H, NEG)
    H[0, 0] = 0
    for j in range(1, T + 1):
        H[0, j] = -gap(j)
    for i in range(1, Q + 1):
        H[i, 0] = -gap(i)
    for i in range(1, Q + 1):
        for j in range(1, T + 1):
            E1[i, j] = max(E1[i, j - 1], H[i, j - 1] - p.q) - p.e
            E2[i, j] = max(E2[i, j - 1], H[i, j - 1] - p.q2) - p.e2
            F1[i, j] = max(F1[i - 1, j], H[i - 1, j] - p.q) - p.e
            F2[i, j] = max(F2[i - 1, j], H[i - 1, j] - p.q2) - p.e2
            s = (
                -p.sc_ambi
                if (q[i - 1] == 4 or t[j - 1] == 4)
                else (p.a if q[i - 1] == t[j - 1] else -p.b)
            )
            H[i, j] = max(H[i - 1, j - 1] + s, E1[i, j], E2[i, j], F1[i, j], F2[i, j])
    return int(H[Q, T])


def _cigar_score(cig, ca, cb, p):
    sc = qi = ti = 0
    for n, op in cig:
        if op == 0:
            for x in range(n):
                sc += (
                    -p.sc_ambi
                    if (ca[qi + x] == 4 or cb[ti + x] == 4)
                    else (p.a if ca[qi + x] == cb[ti + x] else -p.b)
                )
            qi += n
            ti += n
        else:
            sc -= min(p.q + n * p.e, p.q2 + n * p.e2)
            if op == 1:
                qi += n
            else:
                ti += n
    return sc


def test_global_dp_matches_bruteforce():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    s = "".join(rng.choice(list("ACGT"), size=60))
    t = list(s)
    t[10] = "A" if s[10] != "A" else "C"
    cases = [
        (s, s),
        (s, "".join(t)),
        (s[:20] + "ACGT" + s[20:], s),
        (s[:20] + s[27:], s),
        ("".join(rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04], size=100)),
         "".join(rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04], size=95))),
    ]
    QMAX = TMAX = 128
    W = 128
    J = len(cases)
    q = np.full((J, QMAX), 4, np.uint8)
    t_ = np.full((J, TMAX), 4, np.uint8)
    ql = np.zeros(J, np.int32)
    tl = np.zeros(J, np.int32)
    for i, (a, b) in enumerate(cases):
        ca, cb = encode(a), encode(b)
        q[i, : len(ca)] = ca
        t_[i, : len(cb)] = cb
        ql[i], tl[i] = len(ca), len(cb)
    out = extend_dp(
        jnp.asarray(q), jnp.asarray(t_), jnp.asarray(ql), jnp.asarray(tl),
        QMAX, TMAX, W, P,
    )
    dirs = np.asarray(out["dirs"])
    for i, (a, b) in enumerate(cases):
        ca, cb = encode(a), encode(b)
        exp = brute_global(ca, cb, P)
        got = int(out["end_sc"][i])
        assert got == exp, f"case {i}: {got} != {exp}"
        cig = traceback_one(dirs[:, i, :], len(ca), len(cb), W, len(ca) - 1, len(cb) - 1)
        qs, ts = cigar_spans(cig)
        assert (qs, ts) == (len(ca), len(cb))
        assert _cigar_score(cig, ca, cb, P) == exp


def test_extension_best_cell():
    import jax.numpy as jnp

    # query is a prefix of target plus noise: best cell should stop
    # at the prefix end
    core = "ACGTTGCAAGGCTTAGCGAT" * 3
    q_s = core
    t_s = core + "TTTTGGGGCCCCAAAA"
    ca, cb = encode(q_s), encode(t_s)
    q = np.full((8, 128), 4, np.uint8)
    t = np.full((8, 128), 4, np.uint8)
    q[0, : len(ca)] = ca
    t[0, : len(cb)] = cb
    out = extend_dp(
        jnp.asarray(q), jnp.asarray(t),
        jnp.asarray([len(ca)] + [0] * 7, np.int32),
        jnp.asarray([len(cb)] + [0] * 7, np.int32),
        128, 128, 64, P,
    )
    assert int(out["best_sc"][0]) == 2 * len(ca)
    assert int(out["best_i"][0]) == len(ca) - 1
    assert int(out["best_j"][0]) == len(ca) - 1
    # g_sc: best score on the last query row equals the full-prefix match
    assert int(out["g_sc"][0]) == 2 * len(ca)


def test_cs_md_generation():
    ca = encode("ACGTACGTAA")
    cb = encode("ACGTTCGTAA")
    cig = [(10, 0)]
    assert gen_cs(cig, ca, cb) == ":4*ta:5"
    assert gen_md(cig, ca, cb) == "4T5"
    mlen, blen, nm = cigar_stats(cig, ca, cb)
    assert (mlen, blen, nm) == (9, 10, 1)
    # with a deletion
    cig2 = [(4, 0), (2, 2), (6, 0)]
    cb2 = encode("ACGTGGACGTAA")
    assert gen_cs(cig2, ca, cb2) == ":4-gg:6"
    assert gen_md(cig2, ca, cb2) == "4^GG6"


def test_device_dl_equals_host_extension():
    """extension_backend="device_dl" (XLA banded DP on the device, host
    walk) gives the C++ host engine's results job for job."""
    from mappy_rs_tpu import Aligner, native

    if not native.available():
        pytest.skip("native lib unavailable")
    import chip_smoke

    rng = np.random.default_rng(4)
    genome = chip_smoke.make_genome(rng, 200_000)
    reads, _ = chip_smoke.simulate_reads(rng, genome, 48, 1000)
    al = Aligner(seq=genome, preset="map-ont")
    res = chip_smoke.phase_extension(al, reads, 128)
    assert res["jobs"] >= 96 and res["differing"] == 0
