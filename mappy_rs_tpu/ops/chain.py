"""Anchor chaining DP — lock-step windowed recurrence on device.

Device equivalent of the C core's ``mm_chain_dp`` (SURVEY.md §2b
N9).  The reference reaches it through every ``.map()`` call; here a
whole batch of reads runs the recurrence lock-step: one sequential
``lax.scan`` over anchor slots, with the predecessor search over a
static window of H prior anchors vectorized across [B, H] lanes.

Score function matches minimap2's (comput_sc): distance/bandwidth
gates, dg/dd decomposition, linear gap penalty chn_pen_gap*dd and the
0.5*log2(dd+1) term computed with the same float-bit-trick log2
approximation so scores agree integer-for-integer.

Known, documented divergences from the C implementation (both are
heuristic prunings of the same DP):
 - predecessor window is a fixed H (minimap2: up to max_chain_iter=5000
   anchors bounded by max_dist_x); raise H for repeat-dense refs;
 - minimap2's max_chain_skip early-break (a visited-marker heuristic
   that prunes dense regions) is not replicated — this build simply
   scores all H candidates, which can only find equal-or-better chains.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_I32 = jnp.int32
NEG_INF = jnp.int32(-(1 << 30))


def mg_log2(x: jnp.ndarray) -> jnp.ndarray:
    """minimap2's approximate log2 (float bit trick); x >= 1."""
    z = jax.lax.bitcast_convert_type(x.astype(jnp.float32), _I32)
    log_2 = ((z >> 23) & 255) - 128
    z2 = (z & ~(255 << 23)) + (127 << 23)
    zf = jax.lax.bitcast_convert_type(z2, jnp.float32)
    return log_2.astype(jnp.float32) + (
        (-0.34484843 * zf + 2.02466578) * zf - 0.67487759
    )


class ChainParams(NamedTuple):
    max_dist_x: int  # ref-gap bound (opt.max_gap / max_gap_ref)
    max_dist_y: int  # query-gap bound (opt.max_gap)
    bw: int
    q_span: int
    chn_pen_gap: float
    chn_pen_skip: float
    # comput_sc's is_cdna branch (MM_F_SPLICE): a reference gap larger
    # than the query gap is a candidate intron and costs only
    # min(lin_pen, log_pen) — logarithmic for long introns — instead of
    # lin_pen + 0.5*log_pen.
    is_splice: int = 0


def _gap_pen(dr, dq, dd, dg, p: "ChainParams"):
    """comput_sc's gap penalty (int-truncated), incl. the is_cdna
    (splice) branch for reference-gap (possible intron) pairs."""
    lin_pen = p.chn_pen_gap * dd.astype(jnp.float32) + (
        p.chn_pen_skip * dg.astype(jnp.float32)
    )
    log_pen = jnp.where(dd >= 1, mg_log2((dd + 1).astype(jnp.float32)), 0.0)
    pen = (lin_pen + 0.5 * log_pen).astype(_I32)
    # is_splice may be a traced leaf (ChainParams is not always a
    # static argument), so branch with `where`, not python `if`
    splice_pen = jnp.minimum(lin_pen, log_pen).astype(_I32)
    take_splice = (jnp.asarray(p.is_splice) != 0) & (dr > dq)
    return jnp.where(take_splice, splice_pen, pen)


def _pair_scores(ai, aj, p: ChainParams):
    """comput_sc for anchor pairs; ai fields [B,1], aj fields [B,H]."""
    dq = ai["qpos"] - aj["qpos"]
    dr = ai["rpos"] - aj["rpos"]
    same = (ai["rev"] == aj["rev"]) & (ai["rid"] == aj["rid"])
    ok = (
        same
        & aj["valid"]
        & (dq > 0)
        & (dq <= p.max_dist_x)
        & (dq <= p.max_dist_y)
        & (dr != 0)
        & (dr <= p.max_dist_x)
        & (dr > 0)
    )
    dd = jnp.abs(dr - dq)
    ok = ok & (dd <= p.bw)
    dg = jnp.minimum(dr, dq)
    span_j = aj.get("span")
    q_span = p.q_span if span_j is None else span_j
    sc = jnp.minimum(dg, q_span)
    pen = _gap_pen(dr, dq, dd, dg, p)  # C truncation semantics
    sc = jnp.where((dd != 0) | (dg > q_span), sc - pen, sc)
    return jnp.where(ok, sc, NEG_INF)


@partial(jax.jit, static_argnames=("window",))
def chain_scores(anchors: dict, params: ChainParams, window: int = 64):
    """Windowed chaining DP over sorted anchors.

    anchors: dict of [B, A] arrays (rev/rid/rpos/qpos/valid) from
    collect_anchors.  Returns f [B, A] (chain score ending at anchor)
    and parent p [B, A] (predecessor slot or -1), minimap2 tie-break
    (largest j wins ties strictly-greater-than q_span).
    """
    rev, rid = anchors["rev"], anchors["rid"]
    rpos, qpos = anchors["rpos"], anchors["qpos"]
    valid = anchors["valid"]
    B, A = rpos.shape
    H = window

    # pad H slots at the front so the window gather is static-shaped
    def pad(x, fill):
        return jnp.concatenate(
            [jnp.full((B, H), fill, x.dtype), x.astype(x.dtype)], axis=1
        )

    span_arr = anchors.get("span")
    if span_arr is None:
        span_arr = jnp.full_like(rpos, params.q_span)
    prev = {
        "rev": pad(rev, 0),
        "rid": pad(rid, 0),
        "rpos": pad(rpos, 0),
        "qpos": pad(qpos, 0),
        "valid": pad(valid, False),
        "span": pad(span_arr, 0),
    }

    def step(f_pad, i):
        # window of H predecessors: padded slots [i, i+H) = original [i-H, i)
        win = {k: jax.lax.dynamic_slice_in_dim(v, i, H, axis=1) for k, v in prev.items()}
        ai = {
            k2: jax.lax.dynamic_slice_in_dim(prev[k2], i + H, 1, axis=1)
            for k2 in ("rev", "rid", "rpos", "qpos", "valid", "span")
        }
        sc = _pair_scores(ai, win, params)  # [B, H]
        f_win = jax.lax.dynamic_slice_in_dim(f_pad, i, H, axis=1)
        tot = jnp.where(sc > NEG_INF, f_win + sc, NEG_INF)
        best = jnp.max(tot, axis=1)
        # largest-j tie-break: scan reversed, argmax picks first max
        arg = (H - 1) - jnp.argmax(tot[:, ::-1], axis=1)
        q_span = ai["span"][:, 0]  # init = current anchor's span
        take = best > q_span  # strict: minimap2's `sc > max_f` vs init
        f_i = jnp.where(take, best, q_span)
        f_i = jnp.where(ai["valid"][:, 0], f_i, NEG_INF)
        p_i = jnp.where(take & ai["valid"][:, 0], i - H + arg, -1)
        f_pad = jax.lax.dynamic_update_slice_in_dim(
            f_pad, f_i[:, None], i + H, axis=1
        )
        return f_pad, (f_i, p_i)

    f_pad0 = jnp.full((B, A + H), NEG_INF, _I32)
    _, (f_t, p_t) = jax.lax.scan(step, f_pad0, jnp.arange(A, dtype=_I32))
    f = jnp.transpose(f_t)  # [B, A]
    p = jnp.transpose(p_t)
    return f, p


def _pair_scores_grid(cur, win, p: ChainParams):
    """comput_sc with broadcasting: cur fields [..., 1, C] (or [B, A, 1])
    vs win fields [..., 2C, C] — any mutually broadcastable shapes."""
    dq = cur["qpos"] - win["qpos"]
    dr = cur["rpos"] - win["rpos"]
    ok = (
        (cur["rev"] == win["rev"])
        & (cur["rid"] == win["rid"])
        & win["valid"]
        & cur["valid"]
        & (dq > 0)
        & (dq <= p.max_dist_x)
        & (dq <= p.max_dist_y)
        & (dr > 0)
        & (dr <= p.max_dist_x)
    )
    dd = jnp.abs(dr - dq)
    ok = ok & (dd <= p.bw)
    dg = jnp.minimum(dr, dq)
    span_j = win.get("span")
    q_span = p.q_span if span_j is None else span_j
    sc = jnp.minimum(dg, q_span)
    pen = _gap_pen(dr, dq, dd, dg, p)
    sc = jnp.where((dd != 0) | (dg > q_span), sc - pen, sc)
    return jnp.where(ok, sc, NEG_INF)


@partial(jax.jit, static_argnames=("block",))
def chain_scores_block(anchors: dict, params: ChainParams, block: int = 32):
    """Block max-plus chaining DP — the production device formulation.

    Equivalent recurrence to chain_scores but restructured so the
    sequential dimension is anchor BLOCKS of size C, not anchors:

      - ALL pairwise edge scores are computed once, outside the scan,
        as a dense [n_blocks, B, 2C, C] broadcast (prev-block +
        in-block edges per block) — pure elementwise VPU work;
      - the scan consumes the edge blocks as xs; each step applies the
        prev-block contribution as one max-plus vec-mat and closes the
        in-block dependency with C-1 Bellman iterations of [B, C, C]
        elementwise max;
      - predecessors are recovered inside the same step: p[i] =
        largest j in the window with f[j] + sc(j, i) == f[i]
        (minimap2's largest-j tie-break), p = -1 where f[i] == q_span.

    The predecessor window (block reach, [1, 2C) anchors back) differs
    slightly from chain_scores' fixed H; both are heuristic bounds of
    the same DP, like minimap2's max_chain_iter.

    NB: deliberately avoids dynamic_slice-in-scan and 2-D fancy
    gathers; everything here is static reshapes, broadcasts and
    reductions, and each scan step is a few fused [B, 2C, C] ops.
    """
    rev, rid = anchors["rev"], anchors["rid"]
    rpos, qpos = anchors["rpos"], anchors["qpos"]
    valid = anchors["valid"]
    B, A = rpos.shape
    C = block
    n_blocks = (A + C - 1) // C
    A_pad = n_blocks * C
    NB = n_blocks
    span_arr = anchors.get("span")
    if span_arr is None:
        span_arr = jnp.full_like(rpos, params.q_span)

    def pad(x, fill):
        return jnp.concatenate(
            [
                jnp.full((B, C), fill, x.dtype),
                x,
                jnp.full((B, A_pad - A), fill, x.dtype),
            ],
            axis=1,
        )

    def blocks_of(x, fill):
        """[B, C+A_pad] padded -> cur [NB, B, C] and win [NB, B, 2C]
        via static reshapes/concats only."""
        xp = pad(x, fill)
        cur = jnp.moveaxis(xp[:, C:].reshape(B, NB, C), 1, 0)
        prev = jnp.moveaxis(xp[:, :A_pad].reshape(B, NB, C), 1, 0)
        win = jnp.concatenate([prev, cur], axis=2)  # [NB, B, 2C]
        return cur, win

    cur_f, win_f = {}, {}
    for name, x, fill in (
        ("rev", rev, 0),
        ("rid", rid, 0),
        ("rpos", rpos, 0),
        ("qpos", qpos, 0),
        ("span", span_arr, 0),
    ):
        cur_f[name], win_f[name] = blocks_of(x, jnp.array(fill, x.dtype))
    cur_v, win_v = blocks_of(valid, jnp.array(False))
    cur_f["valid"], win_f["valid"] = cur_v, win_v

    # dense edge blocks: [NB, B, 2C, C], rows=window anchors, cols=cur
    E = _pair_scores_grid(
        {k: v[:, :, None, :] for k, v in cur_f.items()},
        {k: v[:, :, :, None] for k, v in win_f.items()},
        params,
    )
    init = jnp.where(cur_f["valid"], cur_f["span"], NEG_INF)  # [NB, B, C]
    # absolute anchor index of window row r in block b is row_start + r
    row_start = jnp.arange(NB, dtype=_I32) * C - C  # [NB]

    def block_step(f_prev, xs):
        E_b, init_b, row_start_b, cur_span_b = xs  # [B,2C,C], [B,C], scalar, [B,C]
        ok = E_b > NEG_INF
        prev_tot = jnp.max(
            jnp.where(ok[:, :C, :], f_prev[:, :, None] + E_b[:, :C, :], NEG_INF),
            axis=1,
        )
        F = jnp.maximum(init_b, prev_tot)
        M = E_b[:, C:, :]
        okM = ok[:, C:, :]
        for _ in range(C - 1):
            hop = jnp.max(jnp.where(okM, F[:, :, None] + M, NEG_INF), axis=1)
            F = jnp.maximum(F, hop)
        # predecessor recovery within the same window
        f_win = jnp.concatenate([f_prev, F], axis=1)  # [B, 2C]
        tot = jnp.where(ok, f_win[:, :, None] + E_b, NEG_INF)
        hit = (tot == F[:, None, :]) & (F[:, None, :] > cur_span_b[:, None, :])
        # largest j wins ties: scan rows reversed, argmax takes first
        r_rev = jnp.argmax(hit[:, ::-1, :], axis=1).astype(_I32)
        any_hit = jnp.any(hit, axis=1)
        r = (2 * C - 1) - r_rev
        p = jnp.where(any_hit, row_start_b + r, -1)
        return F, (F, p)

    f0 = jnp.full((B, C), NEG_INF, _I32)
    _, (f_blocks, p_blocks) = jax.lax.scan(
        block_step, f0, (E, init, row_start, cur_f["span"])
    )
    f = jnp.moveaxis(f_blocks, 0, 1).reshape(B, A_pad)[:, :A]
    p = jnp.moveaxis(p_blocks, 0, 1).reshape(B, A_pad)[:, :A]
    f = jnp.where(valid, f, NEG_INF)
    p = jnp.where(valid & (p < A), p, -1)
    return f, p
