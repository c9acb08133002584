"""Seed lookup + anchor collection — vectorized gather kernels.

Device replacement for ``mm_idx_get`` + ``collect_seed_hits``
(SURVEY.md §2b N8): query minimizers are matched against the index's
sorted key arrays with a batched branchless binary search (log2(n)
rounds of gathers — XLA turns each round into one HBM gather), then
hit lists are expanded into a fixed per-read anchor budget with a
prefix-sum slot assignment and a second vectorized binary search.

Anchor convention (matches minimap2's seed records so the chaining
scores are comparable):
  rev   = query strand XOR reference strand
  rpos  = position of the k-mer's LAST base on the forward ref strand
  qpos  = k-mer END on the query if rev==0,
          else qlen-1 - (end+1-span) (END in reversed-query coords)
Anchors are sorted per read by (rev, rid, rpos, qpos) via a
multi-operand lexicographic jax.lax.sort.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_I32 = jnp.int32
_U32 = jnp.uint32


def _lower_bound_2key(key_hi, key_lo, q_hi, q_lo, n_pad: int,
                      keys32: bool = False):
    """Branchless lower_bound of (q_hi,q_lo) rows in sorted (key_hi,key_lo).

    key arrays are padded to n_pad (any 128-multiple) with 0xFFFFFFFF
    sentinels.  Returns int32 indices with the shape of q_hi.
    With ``keys32`` (every key < 2^32, k <= 16) the hi word is elided:
    only key_lo is gathered/compared — half the HBM traffic per round.
    """
    steps = max(n_pad - 1, 1).bit_length()
    lo = jnp.zeros_like(q_lo, dtype=_I32)
    hi = jnp.full_like(lo, n_pad)
    for _ in range(steps + 1):
        mid = (lo + hi) >> 1
        ml = key_lo[mid]
        if keys32:
            less = ml < q_lo
        else:
            mh = key_hi[mid]
            less = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


def _lower_bound_2key_ranged(key_hi, key_lo, q_hi, q_lo, lo, hi, rounds,
                             keys32: bool = False):
    """Branchless lower_bound restricted to per-query [lo, hi) ranges
    (the bucket directory's contiguous slice of the sorted key array).
    `rounds` must be >= ceil(log2(max range width)); gathers per query
    drop from 2*log2(n_keys) to 2*(rounds+1) + 2 directory reads."""
    n_pad = key_lo.shape[0]
    for _ in range(rounds + 1):
        mid = jnp.minimum((lo + hi) >> 1, n_pad - 1)
        ml = key_lo[mid]
        if keys32:
            less = ml < q_lo
        else:
            mh = key_hi[mid]
            less = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


#: mm_seed_select's MAX_MAX_HIGH_OCC — cap on rescued seeds per gap
MAX_HIGH_OCC_PER_GAP = 128


def seed_select_keep(pos, cnt, found, qlens, mid_occ, occ_dist, max_max_occ):
    """Vectorized seed occurrence thinning / rescue (minimap2's
    ``mm_seed_select`` + ``mm_collect_matches``, seed.c; SURVEY §2b N8,
    reached from every ``.map()`` via /root/reference/src/lib.rs:482).

    Semantics: seeds (query minimizers that hit the index) with
    occurrence > mid_occ are normally dropped.  When ``occ_dist`` > 0,
    each maximal run of high-occurrence seeds between two low-occurrence
    seeds (query positions ps..pe; 0 / qlen at the array ends) gets up to
    ``floor((pe-ps)/occ_dist + 0.499)`` (capped at 128) of its
    LOWEST-occurrence members rescued, provided their occurrence is
    <= max_max_occ — so long query stretches without usable seeds
    still seed chains in repeat regions.

    All inputs are [B, M] slot arrays except qlens [B] and the scalars;
    ``pos`` (k-mer end positions) must be ascending over valid slots —
    the sketch emits them in position order.  Returns (keep, rescued)
    bool masks: ``keep`` = seeds whose hits enter anchor expansion,
    ``rescued`` = the subset that was over mid_occ.  Scalar arithmetic
    is exact-integer (matches the C++ path bit-for-bit) for query gaps
    < 2^31/1000 bp.
    """
    B, M = pos.shape
    big = jnp.int32(0x7FFFFFFF)
    is_low = found & (cnt <= mid_occ)
    is_high = found & (cnt > mid_occ)
    # ps: position of the last low-occ seed strictly before each slot
    # (0 when none) — exclusive cummax works because pos is ascending
    low_pos = jnp.where(is_low, pos, 0)
    ps = jnp.concatenate(
        [jnp.zeros((B, 1), _I32),
         jax.lax.cummax(low_pos, axis=1)[:, :-1]], axis=1
    )
    # pe: position of the first low-occ seed strictly after (qlen if none)
    low_pos_r = jnp.where(is_low, pos, big)
    suffix_min = jnp.flip(
        jax.lax.cummin(jnp.flip(low_pos_r, axis=1), axis=1), axis=1
    )
    pe = jnp.concatenate([suffix_min[:, 1:],
                          jnp.full((B, 1), big, _I32)], axis=1)
    pe = jnp.minimum(pe, qlens[:, None])
    # budget per gap: floor(gap/dist + 0.499) == the C truncation of
    # (double)gap/dist + .499, done in exact integer arithmetic
    gap = jnp.maximum(pe - ps, 0)
    max_high = jnp.minimum(
        (gap * 1000 + 499 * occ_dist) // (1000 * occ_dist),
        MAX_HIGH_OCC_PER_GAP,
    )
    # rank eligible high-occ seeds within their gap by (occurrence,
    # slot): stable 2-key sort groups each gap's members, then a
    # run-start cummax turns sorted position into an in-segment rank
    gap_id = jnp.cumsum(is_low.astype(_I32), axis=1)
    elig = is_high & (cnt <= max_max_occ)
    g_key = jnp.where(elig, gap_id, big)
    iota = jnp.broadcast_to(jnp.arange(M, dtype=_I32)[None, :], (B, M))
    s_g, _, s_i = jax.lax.sort(
        (g_key, cnt, iota), dimension=1, num_keys=2
    )
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool), s_g[:, 1:] != s_g[:, :-1]], axis=1
    )
    seg_start = jax.lax.cummax(jnp.where(first, iota, 0), axis=1)
    rank_sorted = iota - seg_start
    _, rank = jax.lax.sort((s_i, rank_sorted), dimension=1, num_keys=1)
    rescued = elig & (rank < max_high)
    return is_low | rescued, rescued


def _searchsorted_rows(prefix, targets):
    """Row-wise 'right' searchsorted: for each target t, the largest i
    with prefix[b, i] <= t.  prefix: int32 [B, M+1] nondecreasing;
    targets: int32 [B, A]."""
    B, M1 = prefix.shape
    steps = max(M1 - 1, 1).bit_length()
    lo = jnp.zeros(targets.shape, _I32)
    hi = jnp.full(targets.shape, M1 - 1, _I32)
    rows = jnp.arange(B, dtype=_I32)[:, None]
    for _ in range(steps + 1):
        mid = (lo + hi + 1) >> 1
        v = prefix[rows, mid]
        le = v <= targets
        lo = jnp.where(le, mid, lo)
        hi = jnp.where(le, hi, mid - 1)
    return lo


def _slot_sources(prefix, cnt, n_slots: int):
    """For each anchor slot a in [0, n_slots): the index m of the
    minimizer whose hit range [prefix[m], prefix[m+1]) contains a.

    Scatter-then-cummax formulation: scatter each nonempty minimizer's
    index at its START slot, then a forward running max fills its
    range.  One scatter + one cumulative max in place of the 9-round
    binary `_searchsorted_rows` (whose rounds are a sequentially
    dependent chain of 2-D gathers)."""
    B, M = cnt.shape
    starts = prefix[:, :-1]
    m_iota = jnp.broadcast_to(jnp.arange(M, dtype=_I32)[None, :], (B, M))
    grid = jnp.full((B, n_slots), -1, _I32)
    grid = grid.at[
        jnp.arange(B, dtype=_I32)[:, None], starts
    ].max(jnp.where(cnt > 0, m_iota, -1), mode="drop")
    return jnp.maximum(jax.lax.cummax(grid, axis=1), 0)


def collect_anchors_dev(dev, mins, qlens, mid_occ, max_anchors, span,
                        q_occ_frac=0.0, occ_dist=0, max_max_occ=0):
    """collect_anchors with every index-side argument pulled from a
    DeviceIndex — both probe modes (hash table / bucketed binary
    search) route automatically.  Test/tool convenience; the pipeline
    passes fields explicitly for jit-argument control."""
    return collect_anchors(
        mins, qlens, dev.key_hi, dev.key_lo, dev.offcnt, dev.pos_rp,
        jnp.int32(dev.n_keys), jnp.int32(mid_occ), max_anchors, span,
        q_occ_frac, dev.bucket_start, dev.bucket_bits,
        dev.bucket_rounds, dev.bucket_shift, occ_dist, max_max_occ,
        dev.keys32, dev.hash_rows, dev.hash_val, dev.hash_bits,
        dev.hash_shift,
    )


@partial(
    jax.jit,
    static_argnames=(
        "max_anchors", "span", "q_occ_frac", "bucket_bits",
        "bucket_rounds", "bucket_shift", "occ_dist", "max_max_occ",
        "keys32", "hash_bits", "hash_shift",
    ),
)
def collect_anchors(
    mins: dict,
    qlens: jnp.ndarray,
    key_hi: jnp.ndarray,
    key_lo: jnp.ndarray,
    offcnt: jnp.ndarray,
    pos_rp: jnp.ndarray,
    n_keys: jnp.ndarray,
    mid_occ: jnp.ndarray,
    max_anchors: int,
    span: int,
    q_occ_frac: float = 0.0,
    bucket_start: jnp.ndarray | None = None,
    bucket_bits: int = 0,
    bucket_rounds: int = 0,
    bucket_shift: int = 0,
    occ_dist: int = 0,
    max_max_occ: int = 0,
    keys32: bool | None = None,
    hash_rows: jnp.ndarray | None = None,
    hash_val: jnp.ndarray | None = None,
    hash_bits: int = 0,
    hash_shift: int = 0,
):
    """Expand query minimizers into sorted anchors.

    Args:
      mins: output of sketch_compact — key_hi/key_lo/pos/strand [B, M], n [B].
      qlens: int32 [B] true query lengths.
      key_hi, key_lo: sorted key tables (dummies in hash-probe mode).
      offcnt: int32 [n_pad, 2] fused (position offset, count) rows —
        one gather fetches both (separate arrays paid two gather ops).
      pos_rp: int32 [m_pad, 2] fused (rid, pos_end<<1|strand) rows.
      n_keys, mid_occ: int32 scalars (device).
      max_anchors: static per-read anchor budget A.
      span: static k-mer span (= k, no HPC).
      hash_rows/hash_val/hash_bits/hash_shift: hash-probe table
        (index.DeviceIndex); when present the sorted-key binary search
        is replaced by one two-row window gather + one value gather.

    Returns dict with [B, A] arrays rev/rid/rpos/qpos/valid and n [B].

    Composed from three stages (reused by the index-sharded mesh front
    end, which inserts cross-shard psums between them):
      probe_index   -> found, (off, cnt) per query minimizer
      filter_counts -> occurrence/rescue/q_occ filtering + rep_len
      expand_anchors-> slot expansion, position gather, lex sort
    """
    found, oc = probe_index(
        mins, key_hi, key_lo, offcnt, n_keys,
        bucket_start, bucket_bits, bucket_rounds, bucket_shift,
        keys32, hash_rows, hash_val, hash_bits, hash_shift,
    )
    cnt_raw = jnp.where(found, oc[..., 1], 0)
    cnt, rep_len = filter_counts(
        mins, qlens, found, cnt_raw, mid_occ, span,
        q_occ_frac, occ_dist, max_max_occ,
    )
    out = expand_anchors(
        mins, qlens, cnt, oc[..., 0], pos_rp, max_anchors, span
    )
    out["rep_len"] = rep_len
    return out


def probe_index(
    mins, key_hi, key_lo, offcnt, n_keys,
    bucket_start=None, bucket_bits=0, bucket_rounds=0, bucket_shift=0,
    keys32=None, hash_rows=None, hash_val=None, hash_bits=0,
    hash_shift=0,
):
    """Match query minimizers against the key table.

    Returns (found [B, M] bool, oc [B, M, 2] int32 (offset, count));
    oc rows are garbage where ~found."""
    q_hi, q_lo = mins["key_hi"], mins["key_lo"]
    B, M = q_hi.shape
    n_pad = offcnt.shape[0]
    if keys32 is None:
        # infer from the (static) array shapes: a keys32 DeviceIndex
        # ships a dummy 8-element hi word (see index.DeviceIndex)
        keys32 = key_hi.shape[0] != key_lo.shape[0]

    if hash_rows is not None and hash_bits > 0:
        # hash-probe seeding: slot h = fib_mix(key) >> (32 - t) (same
        # mix as the build, index.HASH_MIX); the key (if present)
        # lives in [h, h+128], fully inside rows h>>7, h>>7+1.
        # Two-word mode (k > 15: keys up to 62 bits, hash_rows
        # [rows, 128, 2]): word0 = low 31 bits, word1 = key >> 31 —
        # both words arrive in the SAME window gather, so the k=19
        # presets pay one extra compare, not one extra gather op.
        two_word = getattr(hash_rows, "ndim", 2) == 3
        if two_word:
            q_up = (q_hi << _U32(1)) | (q_lo >> _U32(31))
            mixv = (q_lo ^ (q_up * _U32(0x85EBCA6B))) * _U32(0x9E3779B1)
        else:
            mixv = q_lo * _U32(0x9E3779B1)
        h = (mixv >> _U32(hash_shift)).astype(_I32)
        # invalid slots carry the 0xFFFF... sentinel: clamp the row so
        # the window gather stays in bounds (they match nothing real —
        # empty table slots yield the idx = n_keys sentinel below)
        r = jnp.minimum(h >> 7, hash_rows.shape[0] - 2)
        win = hash_rows[r[:, :, None] + jnp.arange(2, dtype=_I32)]
        if two_word:
            w2 = win.reshape(B, M, 256, 2)
            q_fp = q_lo & _U32(0x7FFFFFFF)
            match = (w2[..., 0] == q_fp[:, :, None]) & (
                w2[..., 1] == q_up[:, :, None]
            )
        else:
            match = win.reshape(B, M, 256) == q_lo[:, :, None]
        lane = jnp.argmax(match, axis=-1).astype(_I32)
        slot = (r << 7) + lane
        idx = hash_val[slot]
        idx_c = jnp.minimum(idx, n_pad - 1)
        found = (
            jnp.any(match, axis=-1)
            & (idx < n_keys)
            & (mins["pos"] >= 0)
        )
    else:
        if bucket_start is not None and bucket_bits > 0:
            # bucket id = key64 >> bucket_shift (see DeviceIndex);
            # invalid slots carry the 0xFFFF... sentinel key — clamp
            # them into the last bucket (they find nothing there)
            s = bucket_shift
            if s >= 32:
                b_u = q_hi >> _U32(s - 32)
            elif s == 0:
                b_u = q_lo | (q_hi << _U32(0))  # keys fit 32 bits here
            else:
                b_u = (q_lo >> _U32(s)) | (q_hi << _U32(32 - s))
            b = jnp.minimum(b_u, _U32((1 << bucket_bits) - 1)).astype(_I32)
            # ONE gather for both bucket bounds (adjacent directory
            # slots) instead of separate bucket_start[b] / [b+1] gathers
            bs2 = bucket_start[b[:, :, None] + jnp.arange(2, dtype=_I32)]
            idx = _lower_bound_2key_ranged(
                key_hi, key_lo, q_hi, q_lo,
                bs2[..., 0], bs2[..., 1], bucket_rounds,
                keys32=keys32,
            )
        else:
            idx = _lower_bound_2key(
                key_hi, key_lo, q_hi, q_lo, n_pad, keys32=keys32
            )
        idx_c = jnp.minimum(idx, n_pad - 1)
        found = (
            (idx < n_keys)
            & (key_lo[idx_c] == q_lo)
            & (mins["pos"] >= 0)
        )
        if not keys32:
            found &= key_hi[idx_c] == q_hi
    oc = offcnt[idx_c]  # [B, M, 2]: one gather for offset AND count
    return found, oc


def filter_counts(
    mins, qlens, found, cnt_raw, mid_occ, span,
    q_occ_frac=0.0, occ_dist=0, max_max_occ=0,
):
    """Occurrence thinning / seed rescue / query-repeat filtering.

    `cnt_raw` must be the GLOBAL per-minimizer occurrence (over every
    index shard, when sharded) — the filters' semantics depend on it.
    Returns (cnt [B, M] post-filter counts, rep_len [B])."""
    q_hi, q_lo = mins["key_hi"], mins["key_lo"]
    B, M = q_hi.shape
    # seed occurrence filter (mm_mapopt_update's mid_occ, SURVEY §2b N4)
    if occ_dist > 0 and max_max_occ > 0:
        # occ thinning / seed rescue (mm_seed_select): re-enable the
        # lowest-occurrence high-occ seeds in long low-occ-free gaps.
        # Callers gate on max_max_occ > mid_occ host-side (the scalar
        # lives on device here).
        keep, rescued = seed_select_keep(
            mins["pos"], cnt_raw, found, qlens, mid_occ,
            occ_dist, max_max_occ,
        )
        cnt = jnp.where(keep, cnt_raw, 0)
    else:
        rescued = None
        cnt = jnp.where(cnt_raw > mid_occ, 0, cnt_raw)
    # rep_len: union length of query intervals covered by occ-filtered
    # seeds (mm_collect_matches' rep_st/rep_en accounting) — feeds the
    # mapq uniq_ratio attenuation.  Minimizer slots are in ascending
    # end-position order, so the union reduces to an exclusive cummax.
    span_arr = (
        mins["span"].astype(_I32) if "span" in mins
        else jnp.full_like(mins["pos"], span)
    )
    filt = found & (cnt_raw > mid_occ)
    if rescued is not None:
        filt &= ~rescued  # rescued seeds are not repetitive coverage
    en_f = jnp.where(filt, mins["pos"] + 1, 0)
    prev_en = jnp.concatenate(
        [jnp.zeros((B, 1), _I32),
         jax.lax.cummax(en_f, axis=1)[:, :-1]], axis=1
    )
    st_f = mins["pos"] + 1 - span_arr
    contrib = jnp.maximum(en_f - jnp.maximum(st_f, prev_en), 0)
    rep_len = jnp.sum(jnp.where(filt, contrib, 0), axis=1)
    if q_occ_frac > 0.0:
        # query-side repeat filter (mm_seed_mz_flt analogue): drop
        # minimizers over-represented WITHIN the read itself.
        # O(M log M) sort-and-count (the naive [B,M,M] equality
        # broadcast is an O(M^2) memory/compile hazard on long buckets):
        # sort (hi, lo) per read, measure each equal-run's length, then
        # unsort the run lengths back to slot order.
        slot_valid = mins["pos"] >= 0
        pos_iota = jnp.broadcast_to(jnp.arange(M, dtype=_I32)[None, :], (B, M))
        # invalid slots -> max sentinel so they group at the end
        vhi = jnp.where(slot_valid, q_hi, _U32(0xFFFFFFFF))
        vlo = jnp.where(slot_valid, q_lo, _U32(0xFFFFFFFF))
        s_hi, s_lo, s_idx = jax.lax.sort(
            (vhi, vlo, pos_iota), dimension=1, num_keys=2
        )
        first = jnp.concatenate(
            [
                jnp.ones((B, 1), bool),
                (s_hi[:, 1:] != s_hi[:, :-1])
                | (s_lo[:, 1:] != s_lo[:, :-1]),
            ],
            axis=1,
        )
        last = jnp.concatenate([first[:, 1:], jnp.ones((B, 1), bool)], axis=1)
        seg_start = jax.lax.cummax(
            jnp.where(first, pos_iota, 0), axis=1
        )
        seg_end = jnp.flip(
            jax.lax.cummin(
                jnp.flip(jnp.where(last, pos_iota + 1, M), axis=1), axis=1
            ),
            axis=1,
        )
        run_len = seg_end - seg_start
        _, q_cnt = jax.lax.sort((s_idx, run_len), dimension=1, num_keys=1)
        n_mins = jnp.sum(slot_valid, axis=1, keepdims=True)
        q_thresh = jnp.maximum(
            (n_mins.astype(jnp.float32) * q_occ_frac).astype(_I32), 10
        )
        cnt = jnp.where(q_cnt > q_thresh, 0, cnt)
    return cnt, rep_len


def expand_anchors(mins, qlens, cnt, off, pos_rp, max_anchors, span):
    """Expand per-minimizer hit runs into the sorted [B, A] anchor
    arrays.  `cnt`/`off` are this shard's post-filter counts and
    position offsets (zero counts where the shard has no hits)."""
    B, M = cnt.shape

    # slot allocation: prefix[b, i] = anchors before minimizer slot i
    prefix = jnp.concatenate(
        [jnp.zeros((B, 1), _I32), jnp.cumsum(cnt, axis=1, dtype=_I32)], axis=1
    )
    n_anchors = jnp.minimum(prefix[:, -1], max_anchors)

    A = max_anchors
    slots = jnp.broadcast_to(jnp.arange(A, dtype=_I32)[None, :], (B, A))
    src = _slot_sources(prefix, cnt, A)  # minimizer slot per anchor
    rows = jnp.arange(B, dtype=_I32)[:, None]
    a_valid = slots < n_anchors[:, None]
    # per-minimizer metadata consumed at anchor slots, PACKED into two
    # words so one row-gather fetches everything:
    #   doff = off - prefix  (pos_idx = slot + doff[src])
    #   pss  = pos<<9 | span<<1 | strand  (pos < 2^22 — device bucket
    #          lengths are orders of magnitude below; span < 256 always)
    span_col = (
        mins["span"].astype(_I32) if "span" in mins
        else jnp.full_like(mins["pos"], span)
    )
    doff = off - prefix[:, :-1]
    pss = (
        (mins["pos"] << 9)
        | (span_col << 1)
        | mins["strand"].astype(_I32)
    )
    meta = jnp.stack([doff, pss], axis=-1)  # [B, M, 2]
    mrow = meta[rows, src]  # [B, A, 2]
    pos_idx = jnp.where(a_valid, slots + mrow[..., 0], 0)

    rp = pos_rp[pos_idx]  # [B, A, 2]: one gather for rid AND pos
    rid = rp[..., 0]
    ps = jax.lax.bitcast_convert_type(rp[..., 1], _U32)
    rpos = (ps >> _U32(1)).astype(_I32)
    rstrand = (ps & _U32(1)).astype(jnp.uint8)

    mpss = mrow[..., 1]
    q_pos = mpss >> 9
    q_strand = mpss & 1
    q_span = (mpss >> 1) & 255
    rev = q_strand ^ rstrand.astype(_I32)
    qpos = jnp.where(
        rev == 0,
        q_pos,
        qlens[:, None] - (q_pos + 1 - q_span) - 1,
    )

    # sort per read by (valid-last, rev, rid, rpos, qpos)
    sort_first = jnp.where(a_valid, rev, 2)
    srt = jax.lax.sort(
        (sort_first, rid, rpos, qpos, a_valid.astype(_I32), q_span),
        dimension=1,
        num_keys=4,
    )
    return {
        "rev": srt[0],
        "rid": srt[1],
        "rpos": srt[2],
        "qpos": srt[3],
        "valid": srt[4].astype(bool),
        "span": srt[5],
        "n": n_anchors,
        # pre-truncation hit total: lets callers observe reads whose
        # seed hits overflowed the A budget (minimap2 has no such cap,
        # so silent truncation must at least be measurable)
        "n_raw": prefix[:, -1],
    }
