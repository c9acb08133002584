"""Splice (RNA) mapping: presets, intron-state DP, N ops, cs/MD.

The reference supports spliced mapping through ``mm_set_opt("splice")``
(/root/reference/src/lib.rs:334-337 forwarding presets verbatim to
minimap2).  This build's splice stack: is_splice chaining branch
(ops/chain.py / native front_end.cc), intron-state
extension DP (ops/splice.py oracle == native splice_align_batch), and
N-aware CIGAR/cs/MD/stats (ops/cigar.py, native mappy_native.cc).
"""
import numpy as np
import pytest

from mappy_rs_tpu import Aligner
from mappy_rs_tpu.config import (
    MM_F_SPLICE,
    MM_F_SPLICE_FLANK,
    MM_F_SPLICE_FOR,
    MM_F_SPLICE_REV,
    set_opt,
)
from mappy_rs_tpu.ops.splice import splice_align, splice_site_tables

B = "ACGT"


def _s(rng, n):
    return "".join(B[i] for i in rng.integers(0, 4, n))


def _codes(seq):
    return np.asarray(["ACGT".index(c) for c in seq], np.uint8)


def _rc(seq):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(seq))


# ---------------------------------------------------------------- presets
def test_splice_preset_values():
    io, mo = set_opt("splice")
    assert (io.k, io.w) == (15, 5)
    for f in (MM_F_SPLICE, MM_F_SPLICE_FOR, MM_F_SPLICE_REV,
              MM_F_SPLICE_FLANK):
        assert mo.flag & f
    assert (mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2) == (1, 2, 2, 1, 32, 0)
    assert mo.noncan == 9
    assert mo.max_gap == 2000
    assert mo.max_gap_ref == mo.bw == mo.bw_long == 200000
    assert (mo.zdrop, mo.zdrop_inv) == (200, 100)
    assert mo.max_sw_mat == 0


def test_splice_hq_and_cdna_presets():
    _, hq = set_opt("splice:hq")
    assert (hq.b, hq.q, hq.e, hq.q2) == (4, 6, 2, 24)
    assert hq.junc_bonus == 5
    _, cd = set_opt("cdna")
    assert cd.flag & MM_F_SPLICE
    assert cd.noncan == 9


# ----------------------------------------------------------- site tables
def test_site_tables_forward_sense():
    #         0123456789
    t = _codes("AGTACCTAGA")  # GT at 1, AG at 7-8
    don, acc = splice_site_tables(t, +1, False, 9)
    assert don[1] == 0 and acc[8] == 0
    assert don[0] == 9 and acc[0] == 9
    # flank model: GT not followed by A/G -> noncan//2
    don_f, acc_f = splice_site_tables(t, +1, True, 9)
    assert don_f[1] == 0  # GTA = full signal
    t2 = _codes("AGTCCCCTAGA")  # GTC: bare dinucleotide only
    don2, _ = splice_site_tables(t2, +1, True, 9)
    assert don2[1] == 4  # noncan // 2


def test_site_tables_reverse_sense_and_reversed_seq():
    t = _codes("ACTGGGAACA")  # CT at 1, AC at 7-8
    don, acc = splice_site_tables(t, -1, False, 9)
    assert don[1] == 0 and acc[8] == 0
    # reversed orientation of a forward intron GT..AG reads GA..TG
    tr = _codes("AGACCCTGA")  # GA at 1-2, TG at 6-7
    don_r, acc_r = splice_site_tables(tr, +1, False, 9, reversed_seq=True)
    assert don_r[1] == 0 and acc_r[7] == 0


# ------------------------------------------- oracle == native, randomly
def test_native_matches_oracle():
    native = pytest.importorskip("mappy_rs_tpu.native")
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(42)
    for trial in range(40):
        Q = int(rng.integers(1, 50))
        q = rng.integers(0, 5, Q).astype(np.uint8)
        t = rng.integers(0, 5, int(rng.integers(1, 120))).astype(np.uint8)
        if trial % 3 == 0 and Q >= 20:
            e1, e2 = q[: Q // 2], q[Q // 2 :]
            mid = rng.integers(0, 4, int(rng.integers(4, 60)))
            t = np.concatenate([e1, [2, 3], mid, [0, 2], e2]).astype(np.uint8)
        T = len(t)
        mode = 2 if trial % 2 == 0 else 1
        sense = 1 if trial % 4 < 2 else -1
        flank = trial % 5 != 0
        rev = trial % 7 == 0
        eb = int(rng.integers(-2, 10))
        py = splice_align(
            q, t, 1, 2, 2, 1, 32, 9, 1, sense, flank, mode, eb, rev
        )
        nat = native.splice_align_batch(
            q[None, :].copy(), t[None, :].copy(),
            np.array([Q], np.int32), np.array([T], np.int32),
            1, 2, 2, 1, 32, 9, 1, eb, mode, sense, flank, rev,
        )
        ops_n, sc, qc, tc = nat[0]
        assert np.array_equal(py[0], ops_n), (trial, py[0], ops_n)
        assert py[1:] == (sc, qc, tc), (trial, py[1:], (sc, qc, tc))


# --------------------------------------------------------------- end-to-end
@pytest.fixture(scope="module")
def gene_files(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("splice")
    e1, e2, e3 = _s(rng, 300), _s(rng, 250), _s(rng, 200)
    i1 = "GT" + _s(rng, 146) + "AG"  # 150bp canonical fwd intron
    i2 = "GT" + _s(rng, 76) + "AG"   # 80bp
    genome = _s(rng, 3000) + e1 + i1 + e2 + i2 + e3 + _s(rng, 3000)
    fwd = d / "fwd.fa"
    fwd.write_text(">chr1\n" + genome + "\n")
    # reverse-sense gene: CT..AC introns
    i3 = "CT" + _s(rng, 116) + "AC"  # 120bp
    genome_r = _s(rng, 2000) + e1 + i3 + e2 + _s(rng, 2000)
    rev = d / "rev.fa"
    rev.write_text(">chr1\n" + genome_r + "\n")
    return str(fwd), str(rev), (e1, e2, e3)


def test_spliced_read_forward(gene_files):
    fwd, _, (e1, e2, e3) = gene_files
    al = Aligner(fwd, preset="splice")
    hits = al.map(e1 + e2 + e3, cs=True, MD=True)
    assert hits
    h = hits[0]
    assert h.strand == 1 and h.is_primary
    assert h.r_st == 3000 and h.r_en == 3000 + 750 + 150 + 80
    assert h.cigar_str == "300M150N250M80N200M"
    assert h.trans_strand == 1
    assert h.NM == 0
    assert h.blen == 750  # introns excluded
    assert h.mlen == 750
    assert h.cs == ":300~gt150ag:250~gt80ag:200"
    assert h.MD == "750"
    assert h.mapq == 60


def test_spliced_read_reverse_complement(gene_files):
    fwd, _, (e1, e2, e3) = gene_files
    al = Aligner(fwd, preset="splice")
    h = al.map(_rc(e1 + e2 + e3))[0]
    assert h.strand == -1
    assert h.cigar_str == "300M150N250M80N200M"
    assert h.trans_strand == 1  # sense is in ref coordinates


def test_reverse_sense_introns(gene_files):
    _, rev, (e1, e2, _) = gene_files
    al = Aligner(rev, preset="splice")
    h = al.map(e1 + e2, cs=True)[0]
    assert h.cigar_str == "300M120N250M"
    assert h.trans_strand == -1
    assert "~ct120ac" in h.cs


def test_noncanonical_intron_still_spliced():
    rng = np.random.default_rng(11)
    e1, e2 = _s(rng, 300), _s(rng, 250)
    i = "AA" + _s(rng, 96) + "TT"  # 100bp non-canonical intron
    genome = _s(rng, 2000) + e1 + i + e2 + _s(rng, 2000)
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "nc.fa")
        with open(p, "w") as f:
            f.write(">c\n" + genome + "\n")
        al = Aligner(p, preset="splice")
        h = al.map(e1 + e2)[0]
    n_ops = [n for n, op in h.cigar if op == 3]
    # without a splice signal the boundary may shift a couple of bases
    # (coincidental matches at the intron edges), but one N run must
    # carry the intron and the total ref span must be exact
    assert len(n_ops) == 1 and 90 <= n_ops[0] <= 100
    assert h.r_en - h.r_st == 300 + 100 + 250


def test_device_front_end_matches_cpu(gene_files):
    _, rev, (e1, e2, _) = gene_files
    read = e1 + e2
    out = {}
    for fe in ("cpu", "device"):
        al = Aligner(rev, preset="splice")
        al._config = al._config.replace(front_end_backend=fe)
        al._engine.cfg = al._config
        h = al.map(read, cs=True)[0]
        out[fe] = (h.cigar_str, h.r_st, h.r_en, h.trans_strand, h.cs)
    assert out["cpu"] == out["device"]


def test_intronless_read_no_trans_strand(gene_files):
    fwd, _, (e1, _, _) = gene_files
    al = Aligner(fwd, preset="splice")
    h = al.map(e1)[0]
    assert all(op != 3 for _, op in h.cigar)
    assert h.trans_strand == 0


# ----------------------------------------------------- splice chain branch
def test_splice_chain_bridges_long_ref_gap():
    """Under is_splice, comput_sc charges a log-cost penalty for
    reference gaps (candidate introns), so anchors across a multi-kb
    intron chain together; the default linear penalty would break the
    chain (chn_pen_gap * dd >> span)."""
    from mappy_rs_tpu.ops.chain import ChainParams, chain_scores_block

    qpos = np.array([[100, 115, 130, 200, 215]], np.int32)
    rpos = qpos + np.array([[0, 0, 0, 8000, 8000]], np.int32)
    anchors = {
        "rev": np.zeros((1, 5), np.int32),
        "rid": np.zeros((1, 5), np.int32),
        "qpos": qpos,
        "rpos": rpos,
        "valid": np.ones((1, 5), bool),
    }
    base = dict(
        max_dist_x=200000, max_dist_y=2000, bw=200000, q_span=15,
        chn_pen_gap=0.15, chn_pen_skip=0.0,
    )
    f_s, p_s = chain_scores_block(
        anchors, ChainParams(**base, is_splice=1), 8
    )
    f_n, p_n = chain_scores_block(
        anchors, ChainParams(**base, is_splice=0), 8
    )
    # splice: anchor 3 links back across the 7985bp ref gap
    assert int(p_s[0, 3]) == 2
    # default scoring: the linear penalty breaks the chain
    assert int(p_n[0, 3]) == -1
