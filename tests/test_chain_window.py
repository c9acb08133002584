"""Adversarial test for the bounded chaining window (VERDICT r1 #7).

The device chain DP bounds the predecessor search (block formulation:
[1, 2C) anchors back, C = chain_window), while minimap2 scans up to
max_chain_iter=5000 anchors.

The realistic failure mode: a deletion that skips several copies of a
tandem repeat.  The skipped copies' ref minimizers still match the
query's retained copies, so in (rev, rid, rpos, qpos) sort order
hundreds of anchors sit between the deletion's two true chain
neighbours — the true predecessor falls outside a 128-anchor window
while the deletion size stays under bw (so minimap2's own chaining
would bridge it).  High-occurrence repeat seeds like these survive
seeding at human-scale mid_occ (GRCh38's computed mid_occ is in the
hundreds), so the case is reachable in production.

Oracle: the native CPU front end (native/front_end.cc), which runs
the exact minimap2 recurrence with max_iter=5000 over the same
anchor set (no A-budget truncation; the construction keeps the total
anchor count under the device budget so both paths see identical
anchors).
"""
import numpy as np
import jax.numpy as jnp
import pytest

import mappy_rs_tpu
from mappy_rs_tpu import native
from mappy_rs_tpu.ops.chain import ChainParams, chain_scores_block
from mappy_rs_tpu.ops.lookup import collect_anchors_dev
from mappy_rs_tpu.ops.sketch import sketch_compact
from mappy_rs_tpu.utils.seqcodes import encode
from mappy_rs_tpu.config import IndexOptions
from mappy_rs_tpu.index.build import build_index

MID_OCC = 64  # representative of human-scale computed mid_occ


@pytest.fixture(scope="module")
def repeat_deletion_case():
    """Genome: U1 + 10x60bp tandem unit + U2.  Read: U1 tail + 4 units
    + U2 head — i.e. a 360bp deletion of 6 repeat copies (< bw=500).
    ~260 anchors separate the deletion's true chain neighbours."""
    rng = np.random.default_rng(21)
    u1 = "".join(rng.choice(list("ACGT"), size=800))
    unit = "".join(rng.choice(list("ACGT"), size=60))
    u2 = "".join(rng.choice(list("ACGT"), size=800))
    genome = u1 + unit * 10 + u2
    read = u1[400:] + unit * 4 + u2[:400]
    idx = build_index([("g", encode(genome))], IndexOptions(k=15, w=10))
    return idx, genome, read


def _device_anchors(idx, read, A=2048):
    codes = encode(read)
    L = len(codes)
    batch = np.full((1, L), 4, np.uint8)
    batch[0] = codes
    lens = np.asarray([L], np.int32)
    dev = idx.device
    mins = sketch_compact(
        jnp.asarray(batch), jnp.asarray(lens), idx.k, idx.w,
        max(64, L // max(idx.w // 2, 1)),
    )
    anchors = collect_anchors_dev(
        dev, mins, jnp.asarray(lens), MID_OCC, A, idx.k, 0.0,
    )
    assert int(np.asarray(anchors["n_raw"])[0]) <= A, "A-budget truncation"
    return anchors


def _oracle_best(idx, read):
    params = ChainParams(
        max_dist_x=5000, max_dist_y=5000, bw=500, q_span=idx.k,
        chn_pen_gap=0.8 * 0.01 * idx.k, chn_pen_skip=0.0,
    )
    chains, _rep, n_anchors = native.front_end_batch(
        idx, [encode(read)], MID_OCC, params, 5000, 3, 40, 8, 0, 384
    )
    best = chains[0, 0]
    assert best[0] >= 0, "oracle found no chain"
    return int(best[0]), int(n_anchors[0]), params


def test_narrow_window_loses_wide_recovers(repeat_deletion_case):
    idx, _genome, read = repeat_deletion_case
    oracle_sc, n_anchors, params = _oracle_best(idx, read)
    # sanity: the construction is adversarial but under the A budget
    assert 300 < n_anchors < 2048, n_anchors
    # the full chain must dominate the best no-bridge partial chain
    assert oracle_sc > 800, oracle_sc

    anchors = _device_anchors(idx, read)
    f32, _ = chain_scores_block(anchors, params, 32)  # reach 64
    f_narrow = int(jnp.max(jnp.where(anchors["valid"], f32, -1)))
    f256, _ = chain_scores_block(anchors, params, 256)  # reach 512
    f_wide = int(jnp.max(jnp.where(anchors["valid"], f256, -1)))

    # narrow window must measurably under-score on this construction —
    # if this ever passes at reach 64 the adversarial case has rotted
    assert f_narrow < oracle_sc, (f_narrow, oracle_sc)
    # widened window recovers the oracle's best chain
    assert f_wide >= oracle_sc, (f_wide, oracle_sc)


def test_mapping_with_widened_window_spans_deletion(repeat_deletion_case):
    """End-to-end: with the widened window the read maps as ONE region
    spanning the deletion (a ~360bp D run in the CIGAR); config knobs
    must reach the engine."""
    idx, genome, read = repeat_deletion_case
    al = mappy_rs_tpu.Aligner(seq=genome, preset="map-ont")
    al._engine.cfg.chain_window = 256
    al._engine.opt.mid_occ = MID_OCC
    hits = al.map(read)
    assert hits
    m = hits[0]
    # spans from U1 into U2 across the deletion
    assert m.target_start < 440
    assert m.target_end > len(genome) - 440
    big_dels = [n for n, op in m.cigar if op == 2 and n > 200]
    assert big_dels, m.cigar
