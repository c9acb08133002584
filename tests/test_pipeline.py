"""End-to-end pipeline correctness: golden alignments on test.fa reads
(the oracle role of lib.rs:1093-1106 / python_test.py:124-137, plus
strand/mutation/clipping cases)."""
import numpy as np
import pytest

import mappy_rs_tpu
from mappy_rs_tpu.utils.seqcodes import read_fastx


COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def revcomp(s):
    return "".join(COMP[c] for c in reversed(s))


@pytest.fixture(scope="module")
def al(test_mmi):
    return mappy_rs_tpu.Aligner(test_mmi)


@pytest.fixture(scope="module")
def seqs(test_fa):
    return dict(read_fastx(test_fa))


def test_each_contig_maps_to_itself(al, seqs):
    for name, s in seqs.items():
        hits = al.map(s)
        assert hits, name
        m = hits[0]
        assert m.target_name == name
        assert m.target_start == 0
        assert m.target_end == 400
        assert m.query_start == 0 and m.query_end == 400
        assert m.strand == 1
        assert m.NM == 0
        assert m.mapq >= 40


def test_revcomp_maps_reverse(al, seqs):
    for name, s in seqs.items():
        hits = al.map(revcomp(s))
        assert hits, name
        m = hits[0]
        assert m.target_name == name
        assert m.strand == -1
        assert (m.target_start, m.target_end) == (0, 400)
        assert m.NM == 0


def test_substring_coordinates(al, seqs):
    s = seqs["Escherichia_coli_2"][53:311]
    m = al.map(s)[0]
    assert m.target_name == "Escherichia_coli_2"
    assert (m.target_start, m.target_end) == (53, 311)
    assert (m.query_start, m.query_end) == (0, len(s))
    assert m.NM == 0


def test_mutated_read(al, seqs):
    rng = np.random.default_rng(7)
    s = list(seqs["Bacillus_subtilis"])
    npos = rng.choice(380, 10, replace=False) + 10
    for p in npos:
        s[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[p]]
    m = al.map("".join(s))[0]
    assert m.target_name == "Bacillus_subtilis"
    assert (m.target_start, m.target_end) == (0, 400)
    assert m.NM == 10
    assert m.match_len == 390
    assert m.block_len == 400


def test_read_with_insertion_deletion(al, seqs):
    s = seqs["Enterococcus_faecalis"]
    with_ins = s[:150] + "ACGTA" + s[150:]
    m = al.map(with_ins)[0]
    assert (m.target_start, m.target_end) == (0, 400)
    ops = {op for _, op in m.cigar}
    assert 1 in ops  # insertion present
    with_del = s[:150] + s[157:]
    m = al.map(with_del)[0]
    assert (m.target_start, m.target_end) == (0, 400)
    assert 2 in {op for _, op in m.cigar}


def test_junk_read_no_hits(al):
    assert al.map("ACGT" * 25) == []
    assert al.map("A" * 100) == []


def test_cs_and_md_tags(al, seqs):
    s = seqs["Escherichia_coli_1"]
    m = al.map(s, cs=True, MD=True)[0]
    assert m.cs == ":400"
    assert m.MD == "400"
    m2 = al.map(s)  # not requested -> None
    assert m2[0].cs is None and m2[0].MD is None


def test_batch_matches_single(al, seqs):
    """Lock-step batched mapping must equal one-by-one mapping."""
    rng = np.random.default_rng(11)
    reads = []
    for name, s in seqs.items():
        reads.append(s)
        reads.append(revcomp(s))
        reads.append(s[17:391])
        mut = list(s)
        for p in rng.choice(390, 8, replace=False):
            mut[p] = "ACGT"[(("ACGT".index(mut[p])) + 1) % 4]
        reads.append("".join(mut))
    singles = [al.map(r, cs=True) for r in reads]
    al.enable_threading(2)
    batch_res = {}
    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]
    for mapped, data in al.map_batch(payload):
        batch_res[data["i"]] = mapped
    assert len(batch_res) == len(reads)
    for i in range(len(reads)):
        got = batch_res[i]
        exp = singles[i]
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            assert (g.target_name, g.target_start, g.target_end) == (
                e.target_name, e.target_start, e.target_end,
            )
            assert g.cigar == e.cigar
            assert g.strand == e.strand


def test_duplicate_contig_secondary_and_mapq(tmp_path):
    """Ambiguous placements must yield a secondary hit and collapse the
    primary's mapq (minimap2 semantics)."""
    rng = np.random.default_rng(2)
    core = "".join(rng.choice(list("ACGT"), size=600))
    other = "".join(rng.choice(list("ACGT"), size=600))
    fa = tmp_path / "r.fa"
    fa.write_text(f">copyA\n{core}\n>copyB\n{core}\n>uniq\n{other}\n")
    al = mappy_rs_tpu.Aligner(str(fa))
    hits = al.map(core[50:550])
    assert len(hits) == 2
    assert hits[0].is_primary and not hits[1].is_primary
    assert hits[0].mapq <= 3  # ambiguous
    assert {h.target_name for h in hits} == {"copyA", "copyB"}
    uniq_hits = al.map(other[50:550])
    assert len(uniq_hits) == 1
    assert uniq_hits[0].mapq >= 40


def test_long_read_segmented_alignment(tmp_path):
    """Long reads are aligned anchor-segment-by-segment; the stitched
    CIGAR must cover the full span with correct coordinates."""
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=30_000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">g\n{genome}\n")
    al = mappy_rs_tpu.Aligner(str(fa))
    # 6 kb read with scattered errors and small indels
    start = 4000
    s = list(genome[start : start + 6000])
    for p in rng.choice(5900, 60, replace=False):
        r = rng.random()
        if r < 0.5:
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        elif r < 0.75:
            s[p] = s[p] + "".join(rng.choice(list("ACGT"), size=2))
        else:
            s[p] = ""
    read = "".join(s)
    hits = al.map(read)
    assert hits, "long read failed to map"
    m = hits[0]
    assert m.target_name == "g"
    assert abs(m.target_start - start) < 50
    assert abs(m.target_end - (start + 6000)) < 50
    assert m.query_start < 30 and m.query_end > len(read) - 30
    # CIGAR spans must match the reported intervals exactly
    qspan = sum(n for n, op in m.cigar if op in (0, 1))
    tspan = sum(n for n, op in m.cigar if op in (0, 2))
    assert qspan == m.query_end - m.query_start
    assert tspan == m.target_end - m.target_start
    assert m.NM < 200
    # revcomp long read too
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(read))
    m2 = al.map(rc)[0]
    assert m2.strand == -1
    assert abs(m2.target_start - start) < 50


def test_ultralong_read_32k_bucket(tmp_path):
    """A ~20 kb ONT-style read exercises the 32768 length bucket:
    small-B batch shape, dozens of anchor-cut mid segments, stitched
    coordinates still exact."""
    rng = np.random.default_rng(17)
    genome = "".join(rng.choice(list("ACGT"), size=60_000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">g\n{genome}\n")
    al = mappy_rs_tpu.Aligner(str(fa))
    start = 20_000
    s = list(genome[start : start + 20_000])
    for p in rng.choice(19_800, 160, replace=False):
        r = rng.random()
        if r < 0.5:
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        elif r < 0.75:
            s[p] = s[p] + "".join(rng.choice(list("ACGT"), size=2))
        else:
            s[p] = ""
    read = "".join(s)
    hits = al.map(read)
    assert hits, "ultralong read failed to map"
    m = hits[0]
    assert abs(m.target_start - start) < 50
    assert abs(m.target_end - (start + 20_000)) < 50
    qspan = sum(n for n, op in m.cigar if op in (0, 1))
    tspan = sum(n for n, op in m.cigar if op in (0, 2))
    assert qspan == m.query_end - m.query_start
    assert tspan == m.target_end - m.target_start
