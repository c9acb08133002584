"""Host-side (exact, scalar) minimizer sketch — the correctness oracle.

Implements (k,w) canonical-minimizer sketching with the same observable
semantics as minimap2's sketch stage, which the reference invokes on
every ``map`` call through FFI (SURVEY.md §2b N7; /root/reference/src/
lib.rs:482-488).  Semantics, re-derived (not transcribed) from the
published algorithm:

- bases are 2-bit encoded (A,C,G,T = 0..3); runs are broken by ambiguous
  bases (code 4), and a k-mer is only considered once ``k`` consecutive
  valid bases have been seen;
- for each k-mer ending at position ``i`` the canonical strand is the
  lexicographically smaller of the forward and reverse-complement
  encodings; self-complementary k-mers (only possible for even k) are
  skipped entirely;
- the k-mer key is an invertible integer hash of the canonical 2k-bit
  value (``hash64`` below), so minimizer selection is pseudo-random;
- a sliding window of ``w`` consecutive k-mer positions selects every
  position achieving the window minimum (ties included) from each full
  window, plus the final (possibly partial) window's latest minimum.

Each emitted minimizer is ``(key, pos_end, strand)`` where ``pos_end``
is the position of the k-mer's LAST base and strand is 0/1.

The vectorised device version lives in ``ops/sketch.py`` and is
tested for set-equality against this oracle and against the contents of
the reference's prebuilt ``resources/test/test.mmi``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

U64_MAX = (1 << 64) - 1


def hash64(key: int, mask: int) -> int:
    """Invertible 64-bit mix hash restricted to ``mask`` (Thomas Wang)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def sketch_host(
    codes: np.ndarray, k: int, w: int, rid: int = 0, is_hpc: bool = False
) -> List[Tuple[int, int, int, int]]:
    """Exact scalar sketch.  Returns list of (key, rid, pos_end, strand).

    ``codes``: uint8 array of 0..4 base codes.  With ``is_hpc``,
    homopolymer runs are compressed: one k-mer symbol per run, the
    recorded position is the run's last base, spans (sum of the k runs'
    lengths) must stay < 256 for a candidate to be emitted.
    """
    assert 0 < k <= 28 and 0 < w < 256
    L = len(codes)
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    kf = kr = 0
    run = 0  # consecutive valid bases ending here
    INF = (U64_MAX, U64_MAX, 0)
    buf: List[Tuple[int, int, int]] = [INF] * w  # (x=key, y=pos<<1|strand, span)
    min_item = INF
    min_pos = 0
    buf_pos = 0
    out: List[Tuple[int, int, int]] = []
    tq: List[int] = []  # last <=k run lengths (HPC span queue)
    kmer_span = 0

    def push(item: Tuple[int, int, int]) -> None:
        if item[0] != U64_MAX:
            out.append(item)

    i = -1
    while i + 1 < L:
        i += 1
        c = int(codes[i])
        info = INF
        if c < 4:
            if is_hpc:
                skip_len = 1
                if i + 1 < L and int(codes[i + 1]) == c:
                    skip_len = 2
                    while i + skip_len < L and int(codes[i + skip_len]) == c:
                        skip_len += 1
                    i += skip_len - 1  # i -> end of the run
                tq.append(skip_len)
                kmer_span += skip_len
                if len(tq) > k:
                    kmer_span -= tq.pop(0)
            else:
                kmer_span = min(run + 1, k)
            kf = ((kf << 2) | c) & mask
            kr = (kr >> 2) | ((3 - c) << shift1)
            if kf == kr:
                # strand-ambiguous k-mer: contributes nothing, occupies no
                # window slot (cannot happen for odd k)
                continue
            z = 0 if kf < kr else 1
            run += 1
            if run >= k and kmer_span < 256:
                info = (
                    hash64(kf if z == 0 else kr, mask),
                    (i << 1) | z,
                    kmer_span,
                )
        else:
            run = 0
            tq.clear()
            kmer_span = 0
        buf[buf_pos] = info
        if run == w + k - 1 and min_item != INF:
            # first full window of a run: emit ties of the current minimum
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos)):
                if buf[j][0] == min_item[0] and buf[j][1] != min_item[1]:
                    push(buf[j])
        if info[0] <= min_item[0]:
            if run >= w + k and min_item != INF:
                push(min_item)
            min_item, min_pos = info, buf_pos
        elif buf_pos == min_pos:
            # old minimum fell out of the window: emit it, rescan
            if run >= w + k - 1 and min_item != INF:
                push(min_item)
            min_item = INF
            for j in list(range(buf_pos + 1, w)) + list(range(buf_pos + 1)):
                if min_item[0] >= buf[j][0]:
                    min_item, min_pos = buf[j], j
            if run >= w + k - 1 and min_item != INF:
                for j in list(range(buf_pos + 1, w)) + list(range(buf_pos)):
                    if buf[j][0] == min_item[0] and buf[j][1] != min_item[1]:
                        push(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
    if min_item != INF:
        push(min_item)

    seen = set()
    res = []
    for key, y, span in out:
        if y in seen:
            continue
        seen.add(y)
        if is_hpc:
            res.append((key, rid, y >> 1, y & 1, span))
        else:
            res.append((key, rid, y >> 1, y & 1))
    return res
