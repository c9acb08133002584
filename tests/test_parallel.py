"""Multi-device sharding: the full sharded map step on the virtual CPU
mesh (__graft_entry__.dryrun_multichip exercises the same path)."""
import numpy as np
import pytest


def test_sharded_map_step_8dev():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_index_key_range_sharding_roundtrip(test_mmi):
    from mappy_rs_tpu.index.build import load_or_build
    from mappy_rs_tpu.parallel.mesh import shard_index_by_key_range

    idx = load_or_build(test_mmi)
    sh = shard_index_by_key_range(idx, 4)
    # every key appears in exactly one shard, in order
    keys = []
    for s in range(4):
        n = int(sh["n_keys"][s])
        hi = sh["key_hi"][s][:n].astype(np.uint64)
        lo = sh["key_lo"][s][:n].astype(np.uint64)
        keys.append((hi << np.uint64(32)) | lo)
    cat = np.concatenate(keys)
    assert np.array_equal(cat, idx.keys)
    # per-shard position counts match offsets
    total = sum(
        int(sh["offcnt"][s][: int(sh["n_keys"][s]), 1].sum())
        for s in range(4)
    )
    assert total == len(idx.positions)
    # the packed reference is sharded into CONTIG-RANGE rows, not
    # replicated: every contig appears once, in its owning shard row
    # at its shard-local offset, byte-identical to the concatenated
    # reference slice
    offs = idx.seq_offsets
    for rid in range(idx.n_seq):
        s = int(sh["rid2shard"][rid])
        lo = int(sh["loc_off"][rid])
        ln = int(idx.seq_lens[rid])
        assert np.array_equal(
            sh["ref_blocks"][s][lo : lo + ln],
            idx.ref_codes[int(offs[rid]) : int(offs[rid]) + ln],
        )
    # contig ranges are contiguous in rid order
    assert (np.diff(sh["rid2shard"]) >= 0).all()


def test_map_batch_positions_sharded(test_mmi, test_fa):
    import mappy_rs_tpu
    from mappy_rs_tpu.utils.seqcodes import read_fastx

    al = mappy_rs_tpu.Aligner(test_mmi)
    al.enable_sharding(n_data=4, n_index=2)
    seqs = dict(read_fastx(test_fa))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = list(seqs.values()) + [
        "".join(comp[c] for c in reversed(seqs["Bacillus_subtilis"]))
    ]
    res = al.map_batch_positions(reads)
    assert len(res) == 5
    for name, r in zip(seqs, res[:4]):
        assert r is not None
        assert r["ctg"] == name
        assert r["strand"] == 1
        assert abs(r["r_en"] - 400) < 20
        assert r["chain_score"] > 300 and r["ext_score"] > 700
    assert res[4] is not None and res[4]["strand"] == -1
    assert res[4]["ctg"] == "Bacillus_subtilis"
    # junk read -> None
    res2 = al.map_batch_positions(["ACGT" * 30])
    assert res2 == [None]


def test_map_batch_mesh_identical_mappings():
    """Full-CIGAR map_batch under enable_mesh(8) must return
    bitwise-identical Mappings to the single-device path (the mesh
    shards only the fused front end; host finalization is shared)."""
    import numpy as np

    import mappy_rs_tpu

    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), size=120_000))

    def simulate(n):
        reads = []
        for _ in range(n):
            s = int(rng.integers(0, len(genome) - 900))
            seq = list(genome[s : s + 800])
            for _ in range(40):  # ~5% edits
                p = int(rng.integers(0, len(seq)))
                seq[p] = "ACGT"[int(rng.integers(4))]
            reads.append("".join(seq))
        return reads

    reads = simulate(24)

    def run(mesh):
        al = mappy_rs_tpu.Aligner(seq=genome, preset="map-ont")
        al._engine.cfg.front_end_backend = "device"
        if mesh:
            al.enable_mesh(8)
        out = []
        for r in reads:
            out.append(
                [
                    (m.ctg, m.r_st, m.r_en, m.q_st, m.q_en, m.strand,
                     m.mapq, m.cigar_str, m.NM, m.is_primary)
                    for m in al.map(r, cs=True, MD=True)
                ]
            )
        return out

    single = run(False)
    multi = run(True)
    assert single == multi
    assert sum(1 for r in single if r) >= 22  # the workload actually maps


def test_map_batch_mesh_sharded_index_identical_mappings():
    """enable_mesh(n_data=4, n_index=2): the full-CIGAR path with the
    key/position tables SHARDED over the index axis (VERDICT r3 #6 —
    previously this path replicated the index) must return
    bitwise-identical Mappings to the single-device path."""
    import numpy as np

    import mappy_rs_tpu

    rng = np.random.default_rng(13)
    genome = "".join(rng.choice(list("ACGT"), size=120_000))
    reads = []
    for _ in range(20):
        s = int(rng.integers(0, len(genome) - 900))
        seq = list(genome[s : s + 800])
        for _ in range(40):
            p = int(rng.integers(0, len(seq)))
            seq[p] = "ACGT"[int(rng.integers(4))]
        reads.append("".join(seq))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads.append("".join(comp[c] for c in reversed(reads[0])))

    def run(shard):
        al = mappy_rs_tpu.Aligner(seq=genome, preset="map-ont")
        al._engine.cfg.front_end_backend = "device"
        if shard:
            al.enable_mesh(4, n_index=2)
        out = []
        for r in reads:
            out.append(
                [
                    (m.ctg, m.r_st, m.r_en, m.q_st, m.q_en, m.strand,
                     m.mapq, m.cigar_str, m.NM, m.is_primary)
                    for m in al.map(r, cs=True, MD=True)
                ]
            )
        if shard:
            # the sharded engine must never build the replicated tables
            assert al._engine.index._device is None
        return out

    single = run(False)
    sharded = run(True)
    assert single == sharded
    assert sum(1 for r in single if r) >= 19


def test_readfish_microbatch_decisions(test_mmi, test_fa):
    """Adaptive-sampling shape (BASELINE config 5): a stream of
    latency-bound MICRO-batches of 350-450bp read prefixes through the
    sharded decision mode — every chunk must be called to the right
    contig/strand with a confident chain, including single-read
    batches, and repeated calls must reuse the compiled step (one
    shape bucket)."""
    import numpy as np

    import mappy_rs_tpu
    from mappy_rs_tpu.utils.seqcodes import read_fastx

    al = mappy_rs_tpu.Aligner(test_mmi)
    al.enable_sharding(n_data=4, n_index=2)
    seqs = dict(read_fastx(test_fa))
    names = list(seqs)
    rng = np.random.default_rng(3)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    n_calls = 0
    for batch_size in (1, 2, 4, 3, 1, 8):
        picks = [names[int(rng.integers(len(names)))] for _ in range(batch_size)]
        chunk = []
        want = []
        for nm in picks:
            s = seqs[nm][: int(rng.integers(350, 450))]
            rev = rng.random() < 0.5
            if rev:
                s = "".join(comp[c] for c in reversed(s))
            chunk.append(s)
            want.append((nm, -1 if rev else 1))
        res = al.map_batch_positions(chunk)
        n_calls += 1
        for r, (nm, strand) in zip(res, want):
            assert r is not None and r["ctg"] == nm and r["strand"] == strand
            assert r["chain_score"] > 200
    assert len(al._sharded_steps) == 1  # one L bucket -> one compile


def test_sharding_refuses_single_contig_over_int32(test_mmi):
    """A SINGLE contig past 2^31 bp must refuse loudly (per-contig
    int32 device coordinates would wrap; minimap2 has the same cap).
    Multi-contig references past 2^31 bp TOTAL are supported — the
    contig-range sharding keeps every device offset shard-local
    (covered end-to-end by tests/test_big_genome.py)."""
    from mappy_rs_tpu.index.build import load_or_build
    from mappy_rs_tpu.parallel.mesh import shard_index_by_key_range

    idx = load_or_build(test_mmi)
    fake_lens = idx.seq_lens.copy().astype(np.int64)
    fake_lens[0] = 2**31
    object.__setattr__(idx, "seq_lens", fake_lens)
    with pytest.raises(OverflowError):
        shard_index_by_key_range(idx, 2)
