"""Adversarial rare-path floor (VERDICT r4 weak #5 / next #7).

The fused C++ post-chain serves the common case; zdrop-split
chimeras / inversions / overflows fall back to the stage-by-stage
Python path.  A batch that is ~100% fallback reads must (a) stream
through map_batch with results bit-identical to per-read map(), and
(b) not collapse — the floor is measured and printed.
"""
import time

import numpy as np
import pytest

import mappy_rs_tpu

B = "ACGT"
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _s(rng, n):
    return "".join(B[i] for i in rng.integers(0, 4, n))


def _rc(x):
    return "".join(COMP[c] for c in reversed(x))


def make_adversarial(genome, rng, n):
    """Reads engineered to miss the fused fast path: zdrop-split
    chimeras (divergent 500bp patch) and inversion-rescue reads."""
    out = []
    g = len(genome)
    for i in range(n):
        s = int(rng.integers(1000, g - 3000))
        if i % 2 == 0:
            # chimera: 600 match + 500 garbage (replaces 500bp) + 600
            read = (
                genome[s : s + 600] + _s(rng, 500)
                + genome[s + 1100 : s + 1700]
            )
        else:
            # inversion: A + rc(B, mutated) + C
            a = genome[s : s + 500]
            bseg = list(_rc(genome[s + 500 : s + 1300]))
            for j in range(5, len(bseg), 12):
                bseg[j] = B[(B.index(bseg[j]) + 1) % 4]
            read = a + "".join(bseg) + genome[s + 1300 : s + 1800]
        out.append(read)
    return out


@pytest.fixture(scope="module")
def adv_case():
    rng = np.random.default_rng(17)
    genome = _s(rng, 400_000)
    reads = make_adversarial(genome, rng, 64)
    return genome, reads


def test_fallback_batch_parity_and_floor(adv_case):
    genome, reads = adv_case
    al = mappy_rs_tpu.Aligner(seq=genome, preset="map-ont")
    # oracle: per-read map() (single-process, same engine)
    want = [
        [
            (m.target_name, m.target_start, m.target_end, m.strand,
             m.query_start, m.query_end, m.mapq, m.cigar_str, m.cs)
            for m in al.map(r, cs=True)
        ]
        for r in reads
    ]
    fb = al._engine.metrics.snapshot().get("post_chain_fallbacks", 0)
    if mappy_rs_tpu.native.available():
        assert fb >= len(reads) * 0.9, (
            f"batch not adversarial enough: {fb}/{len(reads)} fallbacks"
        )
    al._config.worker_processes = 2
    al.enable_threading(4)
    t0 = time.time()
    got = {}
    for ms, data in al.map_batch(
        [{"i": i, "seq": r} for i, r in enumerate(reads)]
    ):
        got[data["i"]] = [
            (m.target_name, m.target_start, m.target_end, m.strand,
             m.query_start, m.query_end, m.mapq, m.cigar_str, m.cs)
            for m in ms
        ]
    dt = time.time() - t0
    al.enable_threading(0)
    assert len(got) == len(reads)
    for i, w in enumerate(want):
        assert got[i] == w, f"read {i} diverged on the fallback path"
    # floor sanity (CPU mesh): the python path is ~10-30x slower than
    # the fused path but must stay a working streaming pipeline
    print(f"\nrare-path floor (CPU mesh, 2 procs): "
          f"{len(reads) / dt:.0f} reads/s")
    assert len(reads) / dt > 1.0
