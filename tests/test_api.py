"""API contract tests — port of the reference's tests/python_test.py
(same assertions through the new module; SURVEY.md §4 tier 2)."""
from itertools import repeat

import pytest

import mappy_rs_tpu


def read_fasta(fh):
    name, chunks = None, []
    for line in fh:
        line = line.strip()
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            name, chunks = line[1:], []
        else:
            chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


@pytest.fixture(scope="module")
def al(test_mmi):
    return mappy_rs_tpu.Aligner(test_mmi)


@pytest.fixture
def fasta_list(test_fa):
    with open(test_fa) as fh:
        seqs = [s for _, s in read_fasta(fh)]
    return [
        {"id": i, "seq": seq}
        for i, seq in enumerate(s for _ in range(10) for s in seqs)
    ]


@pytest.fixture
def fasta_iter(fasta_list):
    return iter(fasta_list)


@pytest.fixture
def fasta_tuple(fasta_list):
    return tuple(fasta_list)


@pytest.fixture
def fasta_generator(fasta_list):
    return (item for item in fasta_list)


@pytest.fixture
def fasta(request):
    return request.getfixturevalue(request.param)


def test_bool(al):
    assert al


def test_property_k(al):
    assert al.k == 15


def test_property_w(al):
    assert al.w == 10


def test_property_n_seq(al):
    assert al.n_seq == 4


def test_property_seq_names(al):
    expected = [
        "Bacillus_subtilis",
        "Enterococcus_faecalis",
        "Escherichia_coli_1",
        "Escherichia_coli_2",
    ]
    names = al.seq_names
    names.sort()
    assert names == expected


def test_get_seq(al, test_fa):
    with open(test_fa) as fh:
        seqs = {n.split()[0]: s for n, s in read_fasta(fh)}
    assert al.seq("Bacillus_subtilis") == seqs["Bacillus_subtilis"]
    assert al.seq("Bacillus_subtilis", 5, 10) == seqs["Bacillus_subtilis"][5:10]
    assert al.seq("No_such_contig") is None
    assert al.seq("Bacillus_subtilis", 500, 600) is None


def test_map_one(al, test_fa):
    with open(test_fa) as fh:
        seqs = {n.split()[0]: s for n, s in read_fasta(fh)}
    mappings = al.map(seqs["Enterococcus_faecalis"], cs=True)
    assert len(mappings) == 1
    m = mappings[0]
    assert m.target_start == 0
    assert m.target_end == 400
    assert m.target_name == "Enterococcus_faecalis"
    assert m.strand == 1
    assert m.is_primary
    assert m.cigar == [(400, 0)]
    assert m.cigar_str == "400M"
    assert m.NM == 0
    assert m.cs == ":400"
    # mappy aliases
    assert m.ctg == m.target_name
    assert m.r_st == m.target_start and m.r_en == m.target_end
    assert m.q_st == 0 and m.q_en == 400
    assert m.blen == 400 and m.mlen == 400


def test_map_seq2_not_implemented(al):
    with pytest.raises(NotImplementedError):
        al.map("ACGT", seq2="ACGT")


def test_map_no_op(al):
    m = al.map_no_op("ACGT")
    assert len(m) == 1
    assert m[0].target_name == "Hello"
    assert m[0].target_len == 101010


def test_map_batch_without_threading(al, fasta_list, test_mmi):
    al2 = mappy_rs_tpu.Aligner(test_mmi)
    with pytest.raises(RuntimeError) as excinfo:
        al2.map_batch(fasta_list)
    assert "Multi threading not enabled" in str(excinfo.value)


@pytest.mark.parametrize(
    "fasta",
    ["fasta_iter", "fasta_list", "fasta_tuple", "fasta_generator"],
    indirect=True,
)
def test_map_batch(al, fasta):
    al.enable_threading(2)
    mappings = al.map_batch(fasta)
    n = 0
    for mapped, data in mappings:
        n += 1
        assert "id" in data and "seq" in data
        assert len(mapped) >= 1
    assert n == 40


def test_map_batch_100000(al, fasta_list):
    al.enable_threading(4)
    iter_ = repeat(fasta_list[0], 100_000)
    mappings = al.map_batch(iter_, back_off=True)
    n = sum(1 for _ in mappings)
    assert n == 100_000


def test_map_batch_100000_no_backoff(al, fasta_list):
    al.enable_threading(4)
    iter_ = repeat(fasta_list[0], 100_000)
    with pytest.raises(RuntimeError) as excinfo:
        mappings = al.map_batch(iter_, back_off=False)
        for _ in mappings:
            pass
    assert "Internal error adding data to work queue, without backoff" in str(
        excinfo
    )
    assert (
        "Is your fastq batch larger than 50000? Perhaps try"
        " `map_batch` with back_off=True?" in str(excinfo)
    )


def test_map_batch_fail_dict_single(al, fasta_iter):
    fasta = next(fasta_iter)
    al.enable_threading(2)
    with pytest.raises(TypeError) as excinfo:
        al.map_batch(fasta)
    assert "Unsupported batch type, pass a list, iter, generator or tuple" in str(
        excinfo
    )


def test_map_batch_fail_dict_many(al, fasta_iter):
    fasta = {i: d for i, d in enumerate(fasta_iter)}
    al.enable_threading(2)
    with pytest.raises(TypeError) as excinfo:
        al.map_batch(fasta)
    assert "Unsupported batch type, pass a list, iter, generator or tuple" in str(
        excinfo
    )


def test_map_batch_fail_list_str(al, fasta_iter):
    fasta = [d["seq"] for d in fasta_iter]
    al.enable_threading(2)
    with pytest.raises(TypeError) as excinfo:
        al.map_batch(fasta)
    assert "Element in iterable is not a dictionary" in str(excinfo.value)


def test_map_batch_fail_no_seq_key(al, fasta_iter):
    fasta = [{"SEQ": d["seq"]} for d in fasta_iter]
    al.enable_threading(2)
    with pytest.raises(KeyError) as excinfo:
        al.map_batch(fasta)
    assert "AHHH Key 🗝️  not found in iterated dictionary" in str(excinfo)


def test_map_batch_fail_seq_not_str(al, fasta_iter):
    fasta = [{"seq": d["seq"].encode()} for d in fasta_iter]
    al.enable_threading(2)
    with pytest.raises(ValueError) as excinfo:
        al.map_batch(fasta)
    assert "`seq` must be a string" in str(excinfo)


def test_map_batch_fail_exhausted_iter(al, fasta_iter):
    _ = list(fasta_iter)
    al.enable_threading(2)
    mappings = al.map_batch(fasta_iter)
    assert len(list(mappings)) == 0


def test_no_index():
    with pytest.raises(RuntimeError) as excinfo:
        mappy_rs_tpu.Aligner()
    assert "Did not create or open an index" in str(excinfo)


def test_fasta_input_and_seq_kwarg(tmp_path, test_fa):
    # building from FASTA must equal loading the prebuilt index
    al_fa = mappy_rs_tpu.Aligner(test_fa)
    assert al_fa.k == 15 and al_fa.w == 10 and al_fa.n_seq == 4
    # capability superset vs reference: seq= and fn_idx_out= work
    with open(test_fa) as fh:
        _, s = next(read_fasta(fh))
    al_seq = mappy_rs_tpu.Aligner(seq=s)
    assert al_seq.n_seq == 1
    hits = al_seq.map(s)
    assert hits and hits[0].target_start == 0
    out = tmp_path / "idx.mmi"
    mappy_rs_tpu.Aligner(test_fa, fn_idx_out=str(out))
    al_back = mappy_rs_tpu.Aligner(str(out))
    assert al_back.n_seq == 4


def test_mapping_str_paf_format(al, test_fa):
    with open(test_fa) as fh:
        seqs = {n.split()[0]: s for n, s in read_fasta(fh)}
    m = al.map(seqs["Bacillus_subtilis"])[0]
    fields = str(m).split("\t")
    assert fields[0] == "0" and fields[1] == "400"
    assert fields[2] == "+"
    assert fields[3] == "Bacillus_subtilis"
    assert fields[10] == "tp:A:P"
    assert fields[11] == "cg:Z:400M"


def test_metrics_counters(al):
    al.map("ACGT" * 100)
    m = al.metrics
    assert m["reads"] >= 1
    assert "time_map_batch_s" in m
    assert m.get("dp_cells", 0) >= 0


def test_map_batch_string_input_fails_dict_check(al):
    al.enable_threading(2)
    with pytest.raises(TypeError) as excinfo:
        al.map_batch("ACGTACGT")
    assert "Element in iterable is not a dictionary" in str(excinfo.value)


def test_mappy_module_helpers(tmp_path):
    assert mappy_rs_tpu.revcomp("ACGTN") == "NACGT"
    assert mappy_rs_tpu.revcomp("aacgt") == "acgtt"
    fa = tmp_path / "x.fa"
    fa.write_text(">r1 some comment\nACGT\nACGT\n>r2\nTTTT\n")
    recs = list(mappy_rs_tpu.fastx_read(str(fa)))
    assert recs == [("r1", "ACGTACGT", None), ("r2", "TTTT", None)]
    recs_c = list(mappy_rs_tpu.fastx_read(str(fa), read_comment=True))
    assert recs_c[0] == ("r1", "ACGTACGT", None, "some comment")
    fq = tmp_path / "x.fq"
    fq.write_text("@q1\nACGT\n+\nIIII\n@q2 c2\nGGGG\n+\n!!!!\n")
    recs = list(mappy_rs_tpu.fastx_read(str(fq)))
    assert recs == [("q1", "ACGT", "IIII"), ("q2", "GGGG", "!!!!")]


def test_enable_threading_zero(al, test_mmi):
    al2 = mappy_rs_tpu.Aligner(test_mmi)
    al2.enable_threading(0)
    with pytest.raises(RuntimeError) as excinfo:
        al2.map_batch([{"seq": "ACGT"}])
    assert "Multi threading not enabled" in str(excinfo.value)


def test_degenerate_inputs(al):
    """Empty/tiny/N-only reads and empty/tiny references must never
    crash — they yield no hits, like the C core."""
    assert al.map("") == []
    assert al.map("A") == []
    assert al.map("N" * 50) == []
    al.enable_threading(2)
    res = list(al.map_batch([{"seq": ""}, {"seq": "A"}, {"seq": "N" * 30}]))
    assert len(res) == 3
    assert all(m == [] for m, _ in res)


def test_empty_and_tiny_reference(tmp_path):
    p = tmp_path / "empty.fa"
    p.write_text("")
    al = mappy_rs_tpu.Aligner(str(p))
    assert al.n_seq == 0
    assert al.map("ACGT" * 30) == []
    p2 = tmp_path / "tiny.fa"
    p2.write_text(">tiny\nACGTACGT\n")
    al2 = mappy_rs_tpu.Aligner(str(p2))
    assert al2.n_seq == 1
    assert al2.map("ACGTACGT") == []  # shorter than k: no minimizers


def test_extra_flags_no_print_2nd(tmp_path):
    """extra_flags=0x4000 (MM_F_NO_PRINT_2ND) suppresses secondaries."""
    import numpy as np

    rng = np.random.default_rng(2)
    core = "".join(rng.choice(list("ACGT"), size=600))
    fa = tmp_path / "r.fa"
    fa.write_text(f">copyA\n{core}\n>copyB\n{core}\n")
    al_all = mappy_rs_tpu.Aligner(str(fa))
    al_pri = mappy_rs_tpu.Aligner(str(fa), extra_flags=0x4000)
    read = core[50:550]
    assert len(al_all.map(read)) == 2
    hits = al_pri.map(read)
    assert len(hits) == 1 and hits[0].is_primary


def test_min_dp_score_filter(tmp_path):
    import numpy as np

    rng = np.random.default_rng(3)
    g = "".join(rng.choice(list("ACGT"), size=20_000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">g\n{g}\n")
    read = g[1000:1400]
    al_lo = mappy_rs_tpu.Aligner(str(fa))
    assert len(al_lo.map(read)) == 1  # dp ~ 800
    al_hi = mappy_rs_tpu.Aligner(str(fa), min_dp_score=5000)
    assert al_hi.map(read) == []
