"""Index layer tests: .mmi round trips, builder equality, introspection
(SURVEY.md §4 tier 1 equivalents of lib.rs:1001-1107).

``raw`` is the .mmi the repo's own writer makes from tests/data/test.fa
(conftest).  Byte parity against minimap2's own ``test.mmi`` runs when
that file and its FASTA are placed in tests/data/minimap2/ and skips
otherwise."""
import os

import numpy as np
import pytest

from mappy_rs_tpu.config import IndexOptions, MapOptions
from mappy_rs_tpu.index.build import build_index, load_or_build
from mappy_rs_tpu.index.index import MinimizerIndex
from mappy_rs_tpu.index.mmi import load_mmi, pack_seq, save_mmi, unpack_seq
from mappy_rs_tpu.utils.seqcodes import decode, encode, read_fastx

MINIMAP2_DIR = os.path.join(os.path.dirname(__file__), "data", "minimap2")


@pytest.fixture(scope="module")
def raw(test_mmi):
    return load_mmi(test_mmi)


def test_minimap2_mmi_parity():
    """The builder reproduces minimap2's own index of the same FASTA,
    key for key and position for position."""
    mmi = os.path.join(MINIMAP2_DIR, "test.mmi")
    fa = os.path.join(MINIMAP2_DIR, "test.fa")
    if not (os.path.exists(mmi) and os.path.exists(fa)):
        pytest.skip("minimap2's test.mmi/test.fa not in tests/data/minimap2")
    ref = load_mmi(mmi)
    built = build_index(list(read_fastx(fa)))
    assert built.seq_names == ref.seq_names
    assert np.array_equal(built.keys, ref.keys)
    assert np.array_equal(built.key_offsets, ref.key_offsets)
    assert np.array_equal(built.positions, ref.positions)


def test_mmi_header(raw):
    assert (raw.k, raw.w, raw.bucket_bits, raw.flag) == (15, 10, 14, 0)
    assert raw.seq_names == [
        "Bacillus_subtilis",
        "Enterococcus_faecalis",
        "Escherichia_coli_1",
        "Escherichia_coli_2",
    ]
    assert list(raw.seq_lens) == [400, 400, 400, 400]


def test_mmi_sequences_match_fasta(raw, test_fa):
    seqs = dict(read_fastx(test_fa))
    offs = raw.seq_offsets
    for i, name in enumerate(raw.seq_names):
        codes = unpack_seq(raw.packed_seq, int(offs[i]), int(offs[i + 1]))
        assert decode(codes) == seqs[name]


def test_built_index_equals_mmi(raw, test_fa):
    built = build_index(list(read_fastx(test_fa)))
    assert built.seq_names == raw.seq_names
    assert np.array_equal(built.keys, raw.keys)
    assert np.array_equal(built.key_offsets, raw.key_offsets)
    assert np.array_equal(built.positions, raw.positions)


def test_mmi_roundtrip(raw, tmp_path, test_fa):
    built = build_index(list(read_fastx(test_fa)))
    p = tmp_path / "rt.mmi"
    save_mmi(str(p), built.to_raw())
    back = load_mmi(str(p))
    assert np.array_equal(back.keys, raw.keys)
    assert np.array_equal(back.positions, raw.positions)
    assert back.seq_names == raw.seq_names


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, 1234).astype(np.uint8)
    packed = pack_seq(codes)
    assert np.array_equal(unpack_seq(packed, 0, len(codes)), codes)
    assert np.array_equal(unpack_seq(packed, 100, 200), codes[100:200])


def test_get_seq_clamps(raw, test_fa):
    idx = MinimizerIndex.from_raw(raw)
    seqs = dict(read_fastx(test_fa))
    full = seqs["Escherichia_coli_1"]
    assert idx.get_seq("Escherichia_coli_1") == full
    assert idx.get_seq("Escherichia_coli_1", 10, 2147483647) == full[10:]
    with pytest.raises(Exception):
        idx.get_seq("nope")
    with pytest.raises(Exception):
        idx.get_seq("Escherichia_coli_1", 400, 500)
    with pytest.raises(Exception):
        idx.get_seq("Escherichia_coli_1", 10, 5)


def test_mapopt_update_mid_occ(raw):
    idx = MinimizerIndex.from_raw(raw)
    mo = MapOptions()
    idx.update_map_options(mo)
    # tiny index: quantile < min_mid_occ -> clamped to 10
    assert mo.mid_occ == 10


def test_builder_host_vs_device_paths(test_fa):
    seqs = list(read_fastx(test_fa))
    a = build_index(seqs, IndexOptions(), use_device=True)
    b = build_index(seqs, IndexOptions(), use_device=False)
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.positions, b.positions)


def test_load_or_build_dispatch(test_mmi, test_fa):
    ia = load_or_build(test_mmi)
    ib = load_or_build(test_fa)
    assert np.array_equal(ia.keys, ib.keys)


def test_fast_fasta_reader_matches_line_reader(tmp_path):
    from mappy_rs_tpu.utils.seqcodes import read_fasta_codes

    rng = np.random.default_rng(3)
    # wrapped lines, CRLF mix, multi-contig, trailing newline quirks
    s1 = "".join(rng.choice(list("ACGTN"), size=997))
    s2 = "".join(rng.choice(list("ACGT"), size=203))
    text = ">c1 descr here\r\n"
    text += "\r\n".join(s1[i : i + 60] for i in range(0, len(s1), 60))
    text += "\n>c2\n" + "\n".join(s2[i : i + 80] for i in range(0, len(s2), 80))
    fa = tmp_path / "x.fa"
    fa.write_text(text)
    fast = read_fasta_codes(str(fa))
    slow = [(n, encode(s)) for n, s in read_fastx(str(fa))]
    assert len(fast) == len(slow) == 2
    for (nf, cf), (ns, cs_) in zip(fast, slow):
        assert nf == ns
        assert np.array_equal(cf, cs_)
