"""Vectorized (k,w) canonical minimizer sketch — device compute path.

Device replacement for the per-read scalar sketch the reference
reaches through FFI on every map call (SURVEY.md §2b N7).  Instead of a
rolling ring buffer, the whole batch of reads is sketched at once as a
dense [B, L] elementwise computation:

- k-mer integers are assembled from k static shifted views (no scan —
  each base occupies a disjoint 2-bit slot, so OR-accumulation maps to
  pure elementwise ops);
- 64-bit hash/compare arithmetic runs on (hi, lo) uint32 pairs
  (utils/u64.py), so the graph needs no 64-bit integer mode;
- the w-window minimum is a static cascade of w-1 shifted pairwise mins;
- the emission rule is evaluated as a mask.  The scalar algorithm's
  ring-buffer control flow (including its tie quirks) reduces to five
  position-based clauses, each a static w-shift loop over the batch.

Derivation of the emission clauses.  Let x[j] be the k-mer hash at end
position j (INF when invalid), run(t) the count of consecutive valid
bases ending at t, m(t)/M(t) the minimum value / LATEST-tie argmin of
the window [t-w+1, t].  The scalar algorithm's buffer at step t always
holds exactly positions [t-w+1, t] (every position pushes one entry for
odd k), and its tracked `min` equals (m(t), M(t)).  A finite position j
is emitted iff any of:

  A  first-window tie emission: ∃ t∈(j, j+w): run(t) == w+k-1,
     x[j] == m(t-1), j != M(t-1)
  B  replacement push: ∃ t∈(j, j+w]: M(t-1) == j, x[t] <= x[j],
     run(t) >= w+k   (t == j+w included: the scalar code checks
     replacement BEFORE expiry, with `min` still holding the value)
  Cp expiry push: with t = j+w: M(t-1) == j (== t-w), x[t] > m(t-1),
     run(t) >= w+k-1
  Ct expiry rescan ties: ∃ t∈(j, j+w): M(t-1) == t-w, x[t] > m(t-1),
     run(t) >= w+k-1, x[j] == m(t), j != M(t)
  D  final flush: j == M(len-1)

B without `run(t) >= w+k` is the scalar code's silently-dropped
minimum (a tie arriving exactly at the first full window replaces the
current minimum before it was ever written out); clause A's exclusion
of M(t-1) matches the `y != min.y` guard.  These clauses reproduce the
scalar oracle bit-for-bit, including N-breaks and homopolymer ties.

Set-equality with the exact scalar oracle (index/sketch_host.py) —and
therefore with minimap2's own sketch, see the test.mmi parity test—is
enforced by tests/test_sketch.py.

Note: for even k, self-complementary k-mers occupy a window slot here
but are skipped entirely by minimap2; every supported preset uses odd k
so the two semantics coincide.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import u64

AMBIG = 4  # base code for non-ACGT
_U32 = jnp.uint32


def _shifted_back(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """x[..., i-d] with `fill` for i-d < 0 (static d >= 0)."""
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), fill, x.dtype)
    return jnp.concatenate([pad, x[..., :-d]], axis=-1)


def _shifted_fwd(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """x[..., i+d] with `fill` past the end (static d >= 0)."""
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), fill, x.dtype)
    return jnp.concatenate([x[..., d:], pad], axis=-1)


def compress_hpc(codes: np.ndarray, lengths: np.ndarray):
    """Homopolymer-compress a padded batch (host, vectorized numpy).

    Returns (ccodes [B, L] padded with 4, clens [B], run_end [B, L]
    uncompressed END position per compressed symbol, spans [B, L]
    k-run spans are NOT computed here — use ``hpc_spans``).
    Runs of the SAME valid base collapse to one symbol positioned at
    the run's last base; ambiguous bases stay one symbol each (they
    occupy window slots in the scalar algorithm).
    """
    B, L = codes.shape
    prev = np.full((B, L), 5, codes.dtype)
    prev[:, 1:] = codes[:, :-1]
    pos = np.arange(L)
    in_len = pos[None, :] < lengths[:, None]
    keep = ((codes != prev) | (codes >= 4) | (prev >= 4)) & in_len
    ccodes = np.full((B, L), 4, np.uint8)
    run_end = np.zeros((B, L), np.int32)
    run_len = np.zeros((B, L), np.int32)
    clens = keep.sum(axis=1).astype(np.int32)
    for b in range(B):
        ks = np.nonzero(keep[b])[0]
        n = len(ks)
        if n == 0:
            continue
        ccodes[b, :n] = codes[b, ks]
        ends = np.empty(n, np.int64)
        ends[:-1] = ks[1:] - 1
        ends[-1] = int(lengths[b]) - 1
        run_end[b, :n] = ends
        run_len[b, :n] = ends - ks + 1
    return ccodes, clens, run_end, run_len


def hpc_spans(run_len: np.ndarray, k: int) -> np.ndarray:
    """span[j] = sum of run lengths of the k runs ending at j (garbage
    across N-breaks; the kernel's validity mask covers those)."""
    cs = np.cumsum(run_len.astype(np.int64), axis=1)
    shifted = np.zeros_like(cs)
    shifted[:, k:] = cs[:, :-k]
    return (cs - shifted).astype(np.int32)


@partial(jax.jit, static_argnames=("k", "w"))
def sketch(
    codes: jnp.ndarray,
    lengths: jnp.ndarray,
    k: int,
    w: int,
    force_inf: jnp.ndarray | None = None,
):
    """Sketch a padded batch of reads.

    Args:
      codes: uint8/int32 [B, L] base codes 0..4; positions >= lengths[b]
        must be padded with AMBIG (4).
      lengths: int32 [B] true read lengths.
      k, w: static sketch parameters (k <= 28, w < 256).

    Returns dict of [B, L] arrays, all aligned to k-mer END position i:
      minimizer: bool — position i emits a minimizer
      key_hi, key_lo: uint32 — 2k-bit hash of the canonical k-mer
      strand: uint8 — 0 forward / 1 reverse-canonical

    Hash values are carried as tuples of uint32 words: ONE word when
    2k <= 32 (every supported small-k preset — halves the elementwise
    arithmetic, the single biggest device front-end cost), two (hi, lo)
    words otherwise.  The emission logic below is width-generic.
    """
    narrow = (2 * k) <= 32  # hash fits one u32 word
    codes = codes.astype(_U32)
    B, L = codes.shape
    valid_base = codes < AMBIG
    clean = jnp.where(valid_base, codes, 0)

    # --- width-generic tuple ops --------------------------------------
    def t_le(a, b):
        return a[0] <= b[0] if len(a) == 1 else u64.le(a, b)

    def t_eq(a, b):
        return a[0] == b[0] if len(a) == 1 else u64.eq(a, b)

    def t_min(a, b):
        if len(a) == 1:
            return (jnp.minimum(a[0], b[0]),)
        return u64.minimum(a, b)

    def t_sel(pred, a, b):
        return tuple(jnp.where(pred, x, y) for x, y in zip(a, b))

    def t_back(a, d, fill):
        return tuple(_shifted_back(x, d, fill) for x in a)

    def t_fwd(a, d, fill):
        return tuple(_shifted_fwd(x, d, fill) for x in a)

    # --- validity: all k bases ending at i are valid ------------------
    invalid = (~valid_base).astype(jnp.int32)
    run_break = jnp.cumsum(invalid, axis=-1)  # inclusive prefix count
    # window [i-k+1, i] has no invalid base
    win_break = run_break - _shifted_back(run_break, k, jnp.int32(0))
    kmer_ok = (win_break == 0) & (
        jnp.arange(L, dtype=jnp.int32)[None, :] >= (k - 1)
    )

    # --- forward / reverse k-mer integers -----------------------------
    kf_hi = jnp.zeros((B, L), _U32)
    kf_lo = jnp.zeros((B, L), _U32)
    kr_hi = jnp.zeros((B, L), _U32)
    kr_lo = jnp.zeros((B, L), _U32)
    for d in range(k):
        b = _shifted_back(clean, d, _U32(0))  # base at distance d back
        s_f = 2 * d  # forward: newest base in lowest bits
        if s_f < 32:
            kf_lo = kf_lo | (b << s_f)
            if s_f > 30:  # 2-bit value straddles the 32-bit boundary
                kf_hi = kf_hi | (b >> (32 - s_f))
        else:
            kf_hi = kf_hi | (b << (s_f - 32))
        comp = b ^ _U32(3)
        s_r = 2 * (k - 1 - d)  # reverse: newest base in highest bits
        if s_r < 32:
            kr_lo = kr_lo | (comp << s_r)
            if s_r > 30:
                kr_hi = kr_hi | (comp >> (32 - s_r))
        else:
            kr_hi = kr_hi | (comp << (s_r - 32))

    # canonical strand: z=1 when reverse complement is smaller
    kf = (kf_lo,) if narrow else (kf_hi, kf_lo)
    kr = (kr_lo,) if narrow else (kr_hi, kr_lo)
    z = t_le(kr, kf)  # kf==kr -> z True (even-k only)
    kmin = t_sel(z, kr, kf)

    mask_bits = 2 * k
    mask_lo = _U32(u64.mask_bits(min(mask_bits, 32)))
    mask_hi = _U32(u64.mask_bits(max(mask_bits - 32, 0)))
    if narrow:
        h = (u64.hash32(kmin[0], mask_lo),)
    else:
        h = u64.hash64(kmin, mask_hi, mask_lo)

    INF_V = _U32(0xFFFFFFFF)
    INF = tuple(jnp.full((B, L), INF_V) for _ in h)
    emit_ok = kmer_ok
    if force_inf is not None:
        emit_ok = emit_ok & (~force_inf)
    x = t_sel(emit_ok, h, INF)
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))

    # run(t): consecutive valid BASES ending at t
    last_bad = jax.lax.cummax(jnp.where(valid_base, jnp.int32(-1), pos), axis=1)
    run = pos - last_bad

    # m(t), M(t): minimum value and LATEST-tie argmin over [t-w+1, t]
    m = x
    for d in range(1, w):
        m = t_min(m, t_back(x, d, INF_V))
    # latest tie = smallest lookback d with x[t-d] == m(t)
    M = jnp.full((B, L), -1, jnp.int32)
    found = jnp.zeros((B, L), bool)
    for d in range(w):
        hit = (~found) & t_eq(t_back(x, d, INF_V), m)
        M = jnp.where(hit, pos - d, M)
        found = found | hit
    # all-INF windows: the scalar code's min slot is still tracked; the
    # INF match above yields the latest INF position, consistent.

    m1 = t_back(m, 1, INF_V)  # m(t-1)
    M1 = _shifted_back(M, 1, jnp.int32(-2))  # M(t-1)

    condA = run == (w + k - 1)
    condB = t_le(x, m1) & (run >= (w + k))
    condCt = (M1 == pos - w) & (~t_le(x, m1)) & (run >= (w + k - 1))

    emitted = jnp.zeros((B, L), bool)
    for d in range(1, w + 1):
        tB = _shifted_fwd(condB, d, False)
        M1_d = _shifted_fwd(M1, d, jnp.int32(-2))
        emitted = emitted | (tB & (M1_d == pos))  # B
        if d < w:
            tA = _shifted_fwd(condA, d, False)
            tCt = _shifted_fwd(condCt, d, False)
            m1_d = t_fwd(m1, d, INF_V)
            m_d = t_fwd(m, d, INF_V)
            M_d = _shifted_fwd(M, d, jnp.int32(-2))
            emitted = emitted | (tA & t_eq(x, m1_d) & (M1_d != pos))  # A
            emitted = emitted | (tCt & t_eq(x, m_d) & (M_d != pos))  # Ct
        else:
            emitted = emitted | (_shifted_fwd(condCt, w, False) & (M1_d == pos))  # Cp

    # D: final flush at each read's true end — emit M(len-1)
    at_end = pos == (lengths[:, None] - 1)
    M_end = jnp.max(jnp.where(at_end, M, -1), axis=-1, keepdims=True)
    emitted = emitted | (pos == M_end)

    emitted = emitted & emit_ok & (pos < lengths[:, None])
    return {
        "minimizer": emitted,
        "key_hi": jnp.zeros((B, L), _U32) if narrow else x[0],
        "key_lo": x[-1],
        "strand": z.astype(jnp.uint8),
    }


@partial(jax.jit, static_argnames=("k", "w", "max_minimizers"))
def sketch_compact(codes: jnp.ndarray, lengths: jnp.ndarray, k: int, w: int,
                   max_minimizers: int,
                   force_inf: jnp.ndarray | None = None,
                   pos_map: jnp.ndarray | None = None,
                   spans: jnp.ndarray | None = None):
    """Sketch + on-device compaction into fixed-width [B, M] slot arrays.

    Returns (n [B], key_hi/key_lo/pos/strand/span [B, M]); slots >= n
    are invalid (key = 0xFFFF..., pos = -1).  For HPC sketching the
    caller passes compressed codes plus `pos_map` (uncompressed END
    position per symbol), `spans` and `force_inf` (span >= 256).
    """
    s = sketch(codes, lengths, k, w, force_inf)
    B, L = codes.shape
    M = max_minimizers
    emitted = s["minimizer"]
    slot = jnp.cumsum(emitted.astype(jnp.int32), axis=-1) - 1
    slot = jnp.where(emitted & (slot < M), slot, M)  # overflow -> dropped
    n = jnp.sum(emitted.astype(jnp.int32), axis=-1)
    n = jnp.minimum(n, M)

    def scatter(src, fill, dtype):
        out = jnp.full((B, M + 1), fill, dtype)
        out = out.at[jnp.arange(B)[:, None], slot].set(src.astype(dtype), mode="drop")
        return out[:, :M]

    if pos_map is None:
        pos = jnp.broadcast_to(
            jnp.arange(L, dtype=jnp.int32)[None, :], (B, L)
        )
    else:
        pos = pos_map.astype(jnp.int32)
    if spans is None:
        span_src = jnp.full((B, L), k, jnp.int32)
    else:
        span_src = spans.astype(jnp.int32)
    narrow = (2 * k) <= 32  # sketch emitted single-word hashes
    out = {"n": n, "key_lo": scatter(s["key_lo"], 0xFFFFFFFF, _U32)}
    out["key_hi"] = (
        jnp.zeros((B, M), _U32) if narrow
        else scatter(s["key_hi"], 0xFFFFFFFF, _U32)
    )
    if L < (1 << 22):
        # pos/span/strand packed into ONE scatter word (each [B, L] ->
        # [B, M] scatter is a full gather-cost device op; 5 -> 2/3 ops):
        # pss = pos<<9 | span<<1 | strand.  span < 256 always (k <= 28;
        # HPC spans >= 256 are force_inf'd out), pos < L < 2^22.
        pss_src = (
            (pos << 9)
            | (span_src << 1)
            | s["strand"].astype(jnp.int32)
        )
        pss = scatter(pss_src, -1, jnp.int32)
        pos_o = pss >> 9  # arithmetic: -1 fill stays -1
        out["pos"] = pos_o
        out["span"] = jnp.where(pos_o >= 0, (pss >> 1) & 255, 0)
        out["strand"] = jnp.where(
            pos_o >= 0, pss & 1, 0
        ).astype(jnp.uint8)
    else:
        out["pos"] = scatter(pos, -1, jnp.int32)
        out["strand"] = scatter(s["strand"], 0, jnp.uint8)
        out["span"] = scatter(span_src, 0, jnp.int32)
    return out
