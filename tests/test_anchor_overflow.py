"""Anchor-budget overflow handling (VERDICT r4 weak #4 / next #8).

minimap2 has no per-read anchor cap; the device front end budgets A
slots per read.  A pathological high-occurrence read whose hits
exceed A must NOT be silently truncated: the host detects
n_raw > A (downloaded with the packed anchors) and remaps the read with a boosted budget, recovering the
unique-flank anchors that lexicographic truncation would drop.
"""
import numpy as np
import pytest

import mappy_rs_tpu


@pytest.fixture(scope="module")
def repeat_case(tmp_path_factory):
    rng = np.random.default_rng(5)
    motif = "".join(rng.choice(list("ACGT"), size=400))
    uniq_l = "".join(rng.choice(list("ACGT"), size=30_000))
    uniq_r = "".join(rng.choice(list("ACGT"), size=30_000))
    # 40 interspersed motif copies: every motif minimizer occurs ~40x,
    # so a read containing the motif expands to ~40 * (motif
    # minimizers) anchors >> A = 256
    spacer = [
        "".join(rng.choice(list("ACGT"), size=97)) for _ in range(40)
    ]
    genome = uniq_l + "".join(m + motif for m in spacer) + uniq_r
    # read: unique prefix + one motif copy + unique suffix, drawn
    # verbatim from around the FIRST motif copy
    start = 30_000 - 300 + 97
    read = genome[start - 97 : start + 97 + 400 + 300]
    fa = tmp_path_factory.mktemp("ovf") / "g.fa"
    fa.write_text(f">chr\n{genome}\n")
    return str(fa), read, start - 97


def test_overflow_read_remaps_with_boosted_budget(repeat_case):
    fa, read, true_start = repeat_case
    al = mappy_rs_tpu.Aligner(fa)
    # let the repeat seeds through (the occurrence filter would
    # otherwise thin them before the A budget is reached)
    al._map_opt.mid_occ = 10_000
    ms = al.map(read, cs=True)
    m = al._engine.metrics.snapshot()
    assert m.get("anchor_overflow_retries", 0) >= 1, (
        "read did not exercise the overflow-retry path"
    )
    assert ms, "overflow read must still map"
    best = ms[0]
    assert best.target_start == true_start
    # the boosted budget must cover the read end-to-end (a truncated
    # anchor set maps only the lexicographically-first slice)
    assert best.query_end - best.query_start > len(read) * 0.9


def test_overflow_matches_cpu_front_end(repeat_case):
    if not mappy_rs_tpu.native.available():
        pytest.skip("native lib required")
    fa, read, _ = repeat_case
    al_dev = mappy_rs_tpu.Aligner(fa)
    al_dev._map_opt.mid_occ = 10_000
    al_cpu = mappy_rs_tpu.Aligner(fa)
    al_cpu._engine.cfg.front_end_backend = "cpu"
    al_cpu._map_opt.mid_occ = 10_000
    d = al_dev.map(read, cs=True)
    c = al_cpu.map(read, cs=True)
    assert d and c
    assert (d[0].target_start, d[0].target_end, d[0].cigar_str) == (
        c[0].target_start, c[0].target_end, c[0].cigar_str
    )
