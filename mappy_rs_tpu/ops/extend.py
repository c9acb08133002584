"""Banded dual-affine-gap alignment DP — the hot kernel (ksw2 class).

Device equivalent of ``ksw_extz2_sse`` (SURVEY.md §2b N10), which
the reference triggers on every map call by forcing MM_F_CIGAR
(/root/reference/src/lib.rs:338-339).  Redesign for a vector machine:

- the DP sweeps ANTI-DIAGONALS instead of rows: every in-diagonal
  dependency disappears (up/left come from diag s-1, diagonal from
  s-2), so a whole band of W cells advances lock-step per sequential
  step, batched across J jobs -> [J, W] elementwise ops per step;
- the band follows the (0,0)->(qlen,tlen) line per job (dynamic centre,
  static width), so global alignments of unequal spans stay in band;
- scoring matches minimap2: +a match, -b mismatch, -sc_ambi vs N, and
  dual affine gap cost min(q + l*e, q2 + l*e2) via two E/F channels;
- per-cell traceback directions are emitted as a packed uint8
  [S, J, W] tensor; traceback itself is a cheap O(path) sequential
  walk done host-side (see cigar.py / native module).

Modes: the same sweep serves global (score at (qlen-1, tlen-1)) and
extension (best cell anywhere + best full-query row for end_bonus).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_I32 = jnp.int32
NEG = jnp.int32(-(1 << 28))


class ExtendParams(NamedTuple):
    a: int  # match score (>0)
    b: int  # mismatch penalty (>0)
    q: int
    e: int
    q2: int
    e2: int
    sc_ambi: int  # penalty vs ambiguous base (>0)


# direction byte layout
H_SRC_MASK = 0x07  # 0=diag 1=E1 2=E2 3=F1 4=F2
E1_CONT = 0x08
E2_CONT = 0x10
F1_CONT = 0x20
F2_CONT = 0x40


def _gap_cost(l, p: ExtendParams):
    """min(q + l*e, q2 + l*e2) for l >= 1 (vectorized, int32)."""
    l = l.astype(_I32)
    return jnp.minimum(p.q + l * p.e, p.q2 + l * p.e2)


@partial(jax.jit, static_argnames=("QMAX", "TMAX", "W", "params", "score_only"))
def extend_dp(
    qseq: jnp.ndarray,  # uint8 [J, QMAX]
    tseq: jnp.ndarray,  # uint8 [J, TMAX]
    qlen: jnp.ndarray,  # int32 [J]
    tlen: jnp.ndarray,  # int32 [J]
    QMAX: int,
    TMAX: int,
    W: int,
    params: ExtendParams,
    score_only: bool = False,
):
    """Run the banded DP for a batch of jobs.

    Returns dict:
      dirs:   uint8 [S, J, W] traceback directions (S = QMAX+TMAX-1)
      best_sc/best_i/best_j: extension-mode best cell per job
      g_sc/g_j: best score & ref pos on the last query row (i==qlen-1)
      end_sc: global-mode score at (qlen-1, tlen-1)
    """
    J = qseq.shape[0]
    S = QMAX + TMAX - 1
    p = params
    lanes = jnp.arange(W, dtype=_I32)[None, :]  # [1, W]

    q_i32 = qseq.astype(_I32)
    t_i32 = tseq.astype(_I32)
    qlen = qlen.astype(_I32)
    tlen = tlen.astype(_I32)
    s_last = qlen + tlen - 2  # diagonal of the global end cell

    def lo_of(s):
        # static anti-diagonal band (job-independent): lanes cover
        # j - i in ~[-W/2, W/2); global jobs must be bucketed with
        # W >= 2*|tlen-qlen| + margin (see pipeline job sizing)
        lo = s // 2 - W // 2 + 1
        return jnp.maximum(lo, 0) * jnp.ones_like(qlen)

    def shift_back(x, fill):  # out[d] = x[d-1]
        return jnp.concatenate(
            [jnp.full((J, 1), fill, x.dtype), x[:, :-1]], axis=1
        )

    def shift_fwd(x, fill):  # out[d] = x[d+1]
        return jnp.concatenate(
            [x[:, 1:], jnp.full((J, 1), fill, x.dtype)], axis=1
        )

    def align_prev(x, delta, fill):
        """previous-diag array seen from current lanes: d_prev = d + delta - 1
        for 'up', d_prev = d + delta for 'left' handled by caller shifts."""
        return jnp.where(delta[:, None] == 1, x, shift_back(x, fill))

    def step(carry, s):
        (H1, E1a, E2a, F1a, F2a, H2, lo1, lo2, best) = carry
        lo = lo_of(s)
        delta1 = lo - lo1  # 0/1: shift vs diag s-1
        delta2 = lo - lo2  # 0/1/2: shift vs diag s-2

        i = lo[:, None] + lanes  # [J, W] query row per lane
        j = s - i
        cell_ok = (i <= jnp.minimum(s, qlen[:, None] - 1)) & (j >= 0) & (
            j <= tlen[:, None] - 1
        )

        qb = jnp.take_along_axis(q_i32, jnp.clip(i, 0, QMAX - 1), axis=1)
        tb = jnp.take_along_axis(t_i32, jnp.clip(j, 0, TMAX - 1), axis=1)
        ambi = (qb == 4) | (tb == 4)
        pair = jnp.where(ambi, -p.sc_ambi, jnp.where(qb == tb, p.a, -p.b))

        # ---- predecessors --------------------------------------------
        # up (i-1, j) on s-1: d_up = d + delta1 - 1
        H_up = align_prev(H1, delta1, NEG)
        F1_up = align_prev(F1a, delta1, NEG)
        F2_up = align_prev(F2a, delta1, NEG)
        # left (i, j-1) on s-1: d_left = d + delta1
        H_left = jnp.where(delta1[:, None] == 1, shift_fwd(H1, NEG), H1)
        E1_left = jnp.where(delta1[:, None] == 1, shift_fwd(E1a, NEG), E1a)
        E2_left = jnp.where(delta1[:, None] == 1, shift_fwd(E2a, NEG), E2a)
        # diag (i-1, j-1) on s-2: d_diag = d + delta2 - 1
        d2 = delta2[:, None]
        H_diag = jnp.where(
            d2 == 2,
            shift_fwd(H2, NEG),
            jnp.where(d2 == 1, H2, shift_back(H2, NEG)),
        )

        # ---- borders --------------------------------------------------
        at_i0 = i == 0
        at_j0 = j == 0
        H_diag = jnp.where(
            at_i0 & at_j0,
            0,
            jnp.where(
                at_i0,
                -_gap_cost(j, p),  # H(-1, j-1) = -gap(j)
                jnp.where(at_j0, -_gap_cost(i, p), H_diag),
            ),
        )
        H_left_b = jnp.where(at_j0, -_gap_cost(i + 1, p), H_left)
        E1_left = jnp.where(at_j0, NEG, E1_left)
        E2_left = jnp.where(at_j0, NEG, E2_left)
        H_up_b = jnp.where(at_i0, -_gap_cost(j + 1, p), H_up)
        F1_up = jnp.where(at_i0, NEG, F1_up)
        F2_up = jnp.where(at_i0, NEG, F2_up)

        # ---- gap channels ---------------------------------------------
        e1_open = H_left_b - p.q
        E1 = jnp.maximum(E1_left, e1_open) - p.e
        e1c = (E1_left > e1_open).astype(jnp.uint8) * E1_CONT
        e2_open = H_left_b - p.q2
        E2 = jnp.maximum(E2_left, e2_open) - p.e2
        e2c = (E2_left > e2_open).astype(jnp.uint8) * E2_CONT
        f1_open = H_up_b - p.q
        F1 = jnp.maximum(F1_up, f1_open) - p.e
        f1c = (F1_up > f1_open).astype(jnp.uint8) * F1_CONT
        f2_open = H_up_b - p.q2
        F2 = jnp.maximum(F2_up, f2_open) - p.e2
        f2c = (F2_up > f2_open).astype(jnp.uint8) * F2_CONT

        M = H_diag + pair
        # precedence on ties: M > E1 > E2 > F1 > F2
        H = M
        src = jnp.zeros((J, W), jnp.uint8)
        for val, code in ((E1, 1), (E2, 2), (F1, 3), (F2, 4)):
            better = val > H
            H = jnp.where(better, val, H)
            src = jnp.where(better, jnp.uint8(code), src)
        H = jnp.where(cell_ok, H, NEG)
        E1 = jnp.where(cell_ok, E1, NEG)
        E2 = jnp.where(cell_ok, E2, NEG)
        F1 = jnp.where(cell_ok, F1, NEG)
        F2 = jnp.where(cell_ok, F2, NEG)
        if score_only:
            # score-only mode (serving fast path): no traceback tensor,
            # so HBM traffic is O(W) per diagonal instead of O(S*W)
            dirs = jnp.zeros((J, 0), jnp.uint8)
        else:
            dirs = jnp.where(cell_ok, src | e1c | e2c | f1c | f2c, jnp.uint8(0))

        # ---- bests ----------------------------------------------------
        (best_sc, best_i, best_j, g_sc, g_j, end_sc) = best
        row_best = jnp.max(H, axis=1)
        row_arg = jnp.argmax(H, axis=1).astype(_I32)
        upd = row_best > best_sc
        best_sc = jnp.where(upd, row_best, best_sc)
        best_i = jnp.where(upd, lo + row_arg, best_i)
        best_j = jnp.where(upd, s - (lo + row_arg), best_j)
        # best on the last query row (extension-to-end / end_bonus)
        lastrow = jnp.where((i == qlen[:, None] - 1) & cell_ok, H, NEG)
        lr_best = jnp.max(lastrow, axis=1)
        lr_arg = jnp.argmax(lastrow, axis=1).astype(_I32)
        updg = lr_best > g_sc
        g_sc = jnp.where(updg, lr_best, g_sc)
        g_j = jnp.where(updg, s - (lo + lr_arg), g_j)
        # global end cell
        endmask = jnp.where(
            (i == qlen[:, None] - 1) & (j == tlen[:, None] - 1), H, NEG
        )
        end_here = jnp.max(endmask, axis=1)
        end_sc = jnp.where(s == s_last, jnp.maximum(end_sc, end_here), end_sc)

        carry = (
            H,
            E1,
            E2,
            F1,
            F2,
            H1,
            lo,
            lo1,
            (best_sc, best_i, best_j, g_sc, g_j, end_sc),
        )
        return carry, dirs

    z = jnp.full((J, W), NEG, _I32)
    zeros = jnp.zeros((J,), _I32)
    best0 = (jnp.full((J,), NEG, _I32), zeros, zeros, jnp.full((J,), NEG, _I32), zeros, jnp.full((J,), NEG, _I32))
    carry0 = (z, z, z, z, z, z, zeros, zeros, best0)
    carry, dirs = jax.lax.scan(step, carry0, jnp.arange(S, dtype=_I32))
    best = carry[8]
    return {
        "dirs": dirs,
        "best_sc": best[0],
        "best_i": best[1],
        "best_j": best[2],
        "g_sc": best[3],
        "g_j": best[4],
        "end_sc": best[5],
    }


def band_lo_host(s: int, qlen: int, tlen: int, W: int):
    """Host mirror of the in-kernel band placement (for traceback).
    qlen/tlen accepted for interface stability; the band is static."""
    return max(s // 2 - W // 2 + 1, 0)
