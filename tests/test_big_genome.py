"""GRCh38-scale references: build + map a >2^31 bp multi-contig genome.

The reference's own flagship benchmark workload is human hg38
(3.1 Gbp, /root/reference/tests/benchmark.py:9-10) — minimap2 handles
it because its coordinates are per-contig 32-bit.  This build uses the
same per-contig coordinate model end-to-end (index.DeviceIndex
docstring), so the only hard cap is a SINGLE contig at 2^31 bp.

This test builds a synthetic 3.2 Gbp genome (12 x 256 Mi contigs,
total 3,221,225,472 bp > 2^31 = 2,147,483,648) and checks exact
mapping coordinates on contigs whose concatenated offset sits below,
AT, and far above the int32 boundary, on both front ends:
  - the native CPU front end + host extension (production CPU path)
  - the device front end (fused sketch/lookup/chain graph; runs on
    the CPU backend here, the same code path as on the GPU)
"""
import numpy as np
import pytest

CONTIG = 1 << 28  # 256 Mi
N_CONTIG = 12  # total 3.221 Gbp > 2^31
BASES = "ACGT"
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


@pytest.fixture(scope="module")
def big_index():
    from mappy_rs_tpu.config import IndexOptions
    from mappy_rs_tpu.index.build import build_index

    rng = np.random.default_rng(7)
    # one 3.2 GB random buffer; contigs are DISJOINT views into it.
    # Drawn as uint32 words viewed as bytes & 3 — 4 bases per RNG
    # draw, ~4x faster than integers(0, 4, 3.2e9).
    buf = rng.integers(
        0, 1 << 32, CONTIG * N_CONTIG // 4, dtype=np.uint32
    ).view(np.uint8)
    buf &= 3
    contigs = [
        (f"ctg{i:02d}", buf[i * CONTIG : (i + 1) * CONTIG])
        for i in range(N_CONTIG)
    ]
    # w=64 keeps the minimizer table ~100M positions (the coordinate
    # model under test is independent of density; presets stay k=15)
    idx = build_index(contigs, IndexOptions(k=15, w=64))
    assert int(idx.seq_offsets[-1]) == CONTIG * N_CONTIG > 2**31
    return idx, buf


def _sample_reads(buf, rng, n_per_ctg=2, L=1000):
    """Exact 1kb substrings from contigs 0 (offset 0), 8 (global
    offset == 2^31 exactly), and 11 (3.0 Gbp); half reverse strand."""
    reads = []
    for rid in (0, 8, 11):
        for j in range(n_per_ctg):
            st = int(rng.integers(0, CONTIG - L))
            g = rid * CONTIG + st
            s = "".join(BASES[c] for c in buf[g : g + L])
            rev = j % 2 == 1
            if rev:
                s = "".join(_COMP[c] for c in reversed(s))
            reads.append((f"ctg{rid:02d}", st, -1 if rev else 1, s))
    return reads


def test_build_and_map_over_int32_cpu_front_end(big_index):
    from mappy_rs_tpu import native
    from mappy_rs_tpu.config import AlignerConfig, MapOptions
    from mappy_rs_tpu.models.pipeline import AlignmentEngine

    idx, buf = big_index
    assert native.available()
    opt = MapOptions()
    idx.update_map_options(opt)
    cfg = AlignerConfig()
    cfg.front_end_backend = "cpu"
    cfg.extension_backend = "host"
    eng = AlignmentEngine(idx, opt, cfg)
    rng = np.random.default_rng(8)
    reads = _sample_reads(buf, rng)
    out = eng.map_batch([s for _, _, _, s in reads], cs=True)
    for (ctg, st, strand, s), regs in zip(reads, out):
        assert regs, f"no mapping for read on {ctg}@{st}"
        r = regs[0]
        assert idx.seq_names[r.rid] == ctg
        assert (1 if r.rev == 0 else -1) == strand
        # exact substring: exact coordinates and a pure-match CIGAR
        assert r.rs == st and r.re == st + len(s)
        assert r.qs == 0 and r.qe == len(s)
        assert r.cs == f":{len(s)}"


def test_map_over_int32_device_front_end(big_index):
    """The fused device front end (sketch -> lookup -> chain ->
    backtrack on host) maps reads on a >2^31 bp reference — all
    device coordinates are per-contig, so nothing wraps."""
    from mappy_rs_tpu.config import AlignerConfig, MapOptions
    from mappy_rs_tpu.models.pipeline import AlignmentEngine

    idx, buf = big_index
    opt = MapOptions()
    idx.update_map_options(opt)
    cfg = AlignerConfig()
    cfg.front_end_backend = "device"
    cfg.extension_backend = "host"
    eng = AlignmentEngine(idx, opt, cfg)
    rng = np.random.default_rng(9)
    reads = _sample_reads(buf, rng, n_per_ctg=1)
    out = eng.map_batch([s for _, _, _, s in reads])
    for (ctg, st, strand, s), regs in zip(reads, out):
        assert regs, f"no mapping for read on {ctg}@{st}"
        r = regs[0]
        assert idx.seq_names[r.rid] == ctg
        assert (1 if r.rev == 0 else -1) == strand
        assert r.rs == st and r.re == st + len(s)


def test_get_seq_over_int32(big_index):
    """mm_idx_getseq across a contig whose global offset > 2^31."""
    idx, buf = big_index
    got = idx.get_seq("ctg11", 1000, 1016)
    g = 11 * CONTIG + 1000
    want = "".join(BASES[c] for c in buf[g : g + 16])
    assert got == want
