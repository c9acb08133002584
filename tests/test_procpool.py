"""Multi-process CPU mapping runtime (runtime/procpool.py).

With the CPU front end, enable_threading's workers proxy to child
processes that each run the full CPU pipeline.  The streaming contract
must hold unchanged, and a read's result must be bit-identical to the
single-process CPU path no matter which child maps it (children run
the unmodified engine on the mmap-shared index).  Worker-start
failures raise instead of falling back to threads.
"""
import numpy as np
import pytest

from mappy_rs_tpu import Aligner


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(11)
    return bytes(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 150_000)]
    ).decode()


@pytest.fixture(scope="module")
def payload(genome):
    rng = np.random.default_rng(12)
    out = []
    for i in range(48):
        s = int(rng.integers(0, len(genome) - 500))
        seq = genome[s : s + 500]
        if i % 3 == 0:  # revcomp a third of them
            comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
            seq = "".join(comp[c] for c in reversed(seq))
        out.append({"i": i, "seq": seq})
    return out


def _cpu_aligner(genome):
    al = Aligner(seq=genome, preset="map-ont")
    al._config.front_end_backend = "cpu"
    return al


def test_procs_map_batch_identical_and_contract(genome, payload):
    # reference results: direct single-process CPU mapping
    al = _cpu_aligner(genome)
    direct = [
        al._to_mappings(r)
        for r in al._engine.map_batch(
            [d["seq"] for d in payload], cs=True, md=False
        )
    ]

    al2 = _cpu_aligner(genome)
    al2._config.worker_processes = 1
    al2._config.proc_chunk = 48
    al2.enable_threading(2)
    from mappy_rs_tpu.runtime.procpool import ProcMapper

    assert isinstance(al2._procs, ProcMapper)
    # the children never open the accelerator
    assert [c["platform"] for c in al2._procs.child_info] == ["cpu"]
    try:
        al2.warmup([payload[0]["seq"]])  # broadcast warm path
        got = {}
        for mappings, data in al2.map_batch(payload):
            got[data["i"]] = mappings
        assert len(got) == len(payload)
        for i in range(len(payload)):
            assert got[i] == direct[i]
        assert any(m for m in got.values()), "no read mapped at all"
        # child metrics are aggregated into the parent snapshot
        m = al2.metrics
        assert m.get("reads", 0) >= len(payload)
        # a second batch through the SAME pool (epoch barrier reuse)
        got2 = {data["i"]: maps for maps, data in al2.map_batch(payload[:10])}
        assert len(got2) == 10
        for i in got2:
            assert got2[i] == direct[i]
    finally:
        al2.enable_threading(0)
    assert al2._procs is None


def test_procs_error_contract(genome, payload):
    """Producer-side error texts are raised before any child work."""
    al = _cpu_aligner(genome)
    al._config.worker_processes = 1
    al.enable_threading(1)
    try:
        with pytest.raises(KeyError, match="AHHH Key"):
            for _ in al.map_batch([{"id": 1}]):
                pass
    finally:
        al.enable_threading(0)


@pytest.mark.parametrize("front_end", ["cpu", "device"])
def test_worker_start_failure_raises(genome, monkeypatch, front_end):
    """Children that cannot load the shared index fail to start; the
    failure surfaces as RuntimeError and leaves no pool behind."""
    import mappy_rs_tpu.index.share as share

    al = Aligner(seq=genome[:20_000], preset="map-ont")
    al._config.front_end_backend = front_end
    al._config.worker_processes = 1
    monkeypatch.setattr(share, "save_index_dir", lambda index, d: None)
    with pytest.raises(RuntimeError, match="failed to start"):
        al.enable_threading(2)
    assert al._procs is None and al._pool is None


def test_procmapper_refuses_device_front_end(genome):
    from mappy_rs_tpu.runtime.procpool import ProcMapper

    al = Aligner(seq=genome[:20_000], preset="map-ont")
    with pytest.raises(ValueError, match="CPU front end"):
        ProcMapper(1, al._index, al._map_opt, al._config)
