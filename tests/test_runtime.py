"""Streaming runtime edge cases: abandoned iterators, back-to-back
batches, pool restarts (the disconnect semantics the reference gets
from Rust channel drops, lib.rs:822-826)."""
import gc
import time

import pytest

import mappy_rs_tpu
from mappy_rs_tpu.utils.seqcodes import read_fastx

@pytest.fixture(scope="module")
def payload(test_fa):
    seqs = [s for _, s in read_fastx(test_fa)]
    return [{"i": i, "seq": seqs[i % 4]} for i in range(200)]


def test_abandoned_iterator_does_not_wedge_pool(payload, test_mmi):
    al = mappy_rs_tpu.Aligner(test_mmi)
    al.enable_threading(2)
    it = al.map_batch(payload)
    next(it)  # consume one result, then abandon
    del it
    gc.collect()
    # the pool must recover and serve the next batch fully
    n = sum(1 for _ in al.map_batch(payload))
    assert n == len(payload)


def test_partially_consumed_then_new_batch(payload, test_mmi):
    al = mappy_rs_tpu.Aligner(test_mmi)
    al.enable_threading(2)
    it1 = al.map_batch(payload)
    got1 = [next(it1) for _ in range(5)]
    assert len(got1) == 5
    it1.close()  # explicit disconnect mid-stream
    del it1
    gc.collect()
    for _ in range(3):
        n = sum(1 for _ in al.map_batch(payload[:50]))
        assert n == 50


def test_many_sequential_batches(payload, test_mmi):
    al = mappy_rs_tpu.Aligner(test_mmi)
    al.enable_threading(3)
    for k in range(6):
        n = sum(1 for _ in al.map_batch(payload[: 20 + k]))
        assert n == 20 + k


def test_pool_restart_between_batches(payload, test_mmi):
    al = mappy_rs_tpu.Aligner(test_mmi)
    for n_threads in (1, 3, 2):
        al.enable_threading(n_threads)
        n = sum(1 for _ in al.map_batch(payload[:30]))
        assert n == 30
