"""Device-owner topology (runtime/devowner.py): ONE device front end
in the parent + jax-free post-chain worker processes.

Results must be bit-identical to the single-process path for every
read class: clean forward/reverse reads, multi-bucket batches (the
compact-chain row-width merge), zdrop-split chimeras (child-side
Python fallback), and anchor-overflow repeats (parent-side boosted
retry)."""
import numpy as np
import pytest

from mappy_rs_tpu import Aligner, native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib required"
)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(21)
    seg = bytes(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 600)]
    ).decode()
    return (
        bytes(
            np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 120_000)]
        ).decode()
        + seg * 40  # high-occurrence repeat: overflow retry fodder
        + bytes(
            np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 120_000)]
        ).decode()
    ), seg


@pytest.fixture(scope="module")
def payload(genome):
    g, seg = genome
    rng = np.random.default_rng(22)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    out = []
    for i in range(40):
        ln = 2500 if i % 5 == 0 else 500  # two length buckets
        s = int(rng.integers(0, 120_000 - ln))
        seq = g[s: s + ln]
        if i % 3 == 0:
            seq = "".join(comp[c] for c in reversed(seq))
        out.append({"i": i, "seq": seq})
    garbage = "".join(
        "ACGT"[j] for j in rng.integers(0, 4, 500)
    )
    # zdrop-split chimera -> child python-fallback path
    out.append({"i": 40, "seq": g[2000:2600] + garbage + g[3100:3700]})
    # overflow read (n_raw > A) -> parent-side boosted retry
    out.append({"i": 41, "seq": seg + seg})
    return out


def test_devowner_identical_and_contract(genome, payload):
    g, _seg = genome
    al = Aligner(seq=g, preset="map-ont")
    direct = [
        al._to_mappings(r)
        for r in al._engine.map_batch(
            [d["seq"] for d in payload], cs=True, md=False
        )
    ]

    al2 = Aligner(seq=g, preset="map-ont")
    al2._config.worker_processes = 2
    al2._config.device_batch_size = 32
    al2._config.proc_chunk = 24
    al2.enable_threading(4)
    assert al2._procs is not None, "device-owner workers failed to start"
    from mappy_rs_tpu.runtime.devowner import DevOwnerMapper

    assert isinstance(al2._procs, DevOwnerMapper)
    # the children never open the accelerator
    assert [c["platform"] for c in al2._procs.child_info] == ["cpu"] * 2
    try:
        al2.warmup([payload[0]["seq"]])
        got = {}
        for mappings, data in al2.map_batch(payload):
            got[data["i"]] = mappings
        assert len(got) == len(payload)
        for i in range(len(payload)):
            assert got[i] == direct[i], f"read {i}"
        assert any(m for m in got.values())
        m = al2.metrics
        assert m.get("reads", 0) >= len(payload)
        # the front end ran in the PARENT engine, not the children
        assert al2._engine.metrics.snapshot().get("fe_batches", 0) > 0
        assert m.get("anchor_overflow_retries", 0) > 0
        # second batch through the same pool (epoch barrier reuse)
        got2 = {
            d["i"]: maps for maps, d in al2.map_batch(payload[:10])
        }
        for i in got2:
            assert got2[i] == direct[i]
    finally:
        al2.enable_threading(0)
    assert al2._procs is None
