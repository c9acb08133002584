"""MinimizerIndex: the device-resident reference index.

Equivalent of the C core's ``mm_idx_t`` + its khash bucket table
(SURVEY.md §2b N3), redesigned for XLA: instead of 2^14 pointer-chasing
hash buckets, the minimizer table is three flat, sorted device arrays —
(key_hi, key_lo) sorted unique hashes, prefix offsets, and a packed
position array — so that seed lookup becomes a vectorized binary
search + gather (ops/lookup.py).  The reference reads `mm_idx_t`
fields directly for introspection (/root/reference/src/lib.rs:438-470,
650-670); the same surface is provided here as properties.

Also covers:
  N4 mm_mapopt_update  -> ``update_map_options`` (mid_occ quantile)
  N5 mm_idx_index_name -> ``name2id`` dict
  N6 mm_idx_getseq     -> ``get_seq`` (host) over the packed reference
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..config import MapOptions
from .mmi import RawIndexData, pack_seq, unpack_seq


#: Fibonacci multiplier for the hash-probe bucket mix (golden-ratio
#: odd constant).  Device probes must use the same constant
#: (ops/lookup.py probe_index).
HASH_MIX = np.uint32(0x9E3779B1)
HASH_MIX2 = np.uint32(0x85EBCA6B)  # two-word probe: mixes the hi word


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclass
class DeviceIndex:
    """Device-side (jnp) flat arrays; see MinimizerIndex.device.

    Coordinate model: every device-side position is PER-CONTIG
    (pos_ps = pos_end<<1|strand within the contig, rid separate), so
    the device path has no dependence on concatenated-reference
    offsets and supports references of any total length — only a
    single contig is bounded (< 2^31 bp, minimap2's own limit).
    The packed reference itself stays host-resident (extension jobs
    are staged per batch); decision mode ships contig-range shards
    (parallel/mesh.py)."""

    key_hi: object  # uint32 [n_keys_pad]; dummy [8] when keys32/hash
    key_lo: object  # uint32 [n_keys_pad]; dummy [8] when hash mode
    offcnt: object  # int32  [n_keys_pad, 2]  (start into positions, count)
    pos_rp: object  # int32  [n_pos, 2]  (rid, bitcast(pos_end<<1|strand))
    n_keys: int
    log2_keys: int
    #: True when every key value fits 32 bits (k <= 16 hashes): the
    #: hi-word array is elided (one dummy row) and lookups compare the
    #: lo word only — halves key-table HBM and the per-round gather
    #: traffic of the binary search.
    keys32: bool = False
    # bucketed key search (mm_idx_t's hash-bucket analogue): the top
    # `bucket_bits` bits of the key's EFFECTIVE width (minimap2 keys
    # are hash64 values within 2k bits, so key_hi alone is useless —
    # bucket id = key64 >> bucket_shift) partition the SORTED key
    # array into contiguous ranges, so a query needs only
    # ceil(log2(max_bucket)) binary-search rounds of HBM gathers
    # instead of log2(n_keys) — the search was the dominant device
    # front-end cost (~45% at B=1024) with full-table rounds.
    bucket_start: object = None  # int32 [2^bucket_bits + 1]
    bucket_bits: int = 0
    bucket_shift: int = 0
    bucket_rounds: int = 0
    # hash-probe seeding (keys < 2^32 only): an ordered-linear-probing
    # open-addressing table over the minimizer keys.  hash_rows holds
    # the stored keys reshaped [T/128, 128] so a query's whole probe
    # window (its slot h = key >> hash_shift plus <= 128 displacement)
    # is fetched by ONE two-row gather; hash_val maps the matched slot
    # back to the sorted-key index (for offcnt).  Replaces the bucket
    # directory + ranged binary search (a ~7-op dependent gather chain)
    # with 2 gathers.
    hash_rows: object = None  # uint32 [T/128 + 1, 128]
    hash_val: object = None   # int32  [T + 128]
    hash_bits: int = 0        # T = 2^hash_bits
    hash_shift: int = 0       # slot = key >> hash_shift (>= 0)


@dataclass
class MinimizerIndex:
    """Host+device minimizer index."""

    k: int
    w: int
    bucket_bits: int
    flag: int
    seq_names: List[str]
    seq_lens: np.ndarray
    keys: np.ndarray  # uint64 [n] sorted
    key_offsets: np.ndarray  # uint64 [n+1]
    positions: np.ndarray  # uint64 [m]: rid<<32 | pos_end<<1 | strand
    ref_codes: np.ndarray  # uint8 [sum_len] 0..4
    _device: Optional[DeviceIndex] = None
    _name2id: Optional[Dict[str, int]] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    # -- introspection (reference parity) ------------------------------
    @property
    def n_seq(self) -> int:
        return len(self.seq_names)

    @property
    def seq_offsets(self) -> np.ndarray:
        # cached: hot per-read paths read this; seq_lens is immutable
        # after construction
        so = getattr(self, "_seq_offsets_cache", None)
        if so is None:
            so = np.concatenate(
                [[0], np.cumsum(self.seq_lens.astype(np.int64))]
            ).astype(np.int64)
            object.__setattr__(self, "_seq_offsets_cache", so)
        return so

    @property
    def name2id(self) -> Dict[str, int]:
        """mm_idx_index_name equivalent (lib.rs:416)."""
        if self._name2id is None:
            self._name2id = {n: i for i, n in enumerate(self.seq_names)}
        return self._name2id

    def get_seq(self, name: str, start: int = 0, end: int = 2147483647) -> str:
        """mm_idx_getseq equivalent with the reference's clamp semantics
        (lib.rs:706-766).  Raises on invalid input; the Python API layer
        converts errors to None."""
        if self.flag & 0x2:  # MM_I_NO_SEQ
            raise ValueError("No sequence in this index")
        rid = self.name2id.get(name, -1)
        if rid < 0 or rid >= self.n_seq:
            raise KeyError("Could not find reference in index")
        ref_len = int(self.seq_lens[rid])
        if start >= ref_len or start >= end:
            raise ValueError("Funky start and end coords")
        if end < 0 or end > ref_len:
            end = ref_len
        off = int(self.seq_offsets[rid])
        codes = self.ref_codes[off + start : off + end]
        if np.any(codes > 4):
            raise ValueError("Got an unknown char, not {ACGTN}")
        from ..utils.seqcodes import decode

        return decode(codes)

    # -- occurrence statistics (mm_mapopt_update / mm_idx_cal_max_occ) --
    def cal_max_occ(self, frac: float) -> int:
        """(1-frac) quantile of per-key occurrence counts, plus one."""
        if frac <= 0.0:
            return 2147483647
        counts = (self.key_offsets[1:] - self.key_offsets[:-1]).astype(np.int64)
        n = len(counts)
        if n == 0:
            return 2147483647
        kth = min(int((1.0 - frac) * n), n - 1)
        return int(np.partition(counts, kth)[kth]) + 1

    def update_map_options(self, opt: MapOptions) -> None:
        """mm_mapopt_update equivalent (lib.rs:414)."""
        if opt.mid_occ <= 0:
            opt.mid_occ = self.cal_max_occ(opt.mid_occ_frac)
            if opt.mid_occ < opt.min_mid_occ:
                opt.mid_occ = opt.min_mid_occ
            if opt.max_mid_occ > opt.min_mid_occ and opt.mid_occ > opt.max_mid_occ:
                opt.mid_occ = opt.max_mid_occ
        if opt.bw_long < opt.bw:
            opt.bw_long = opt.bw

    # -- device upload --------------------------------------------------
    @property
    def device(self) -> DeviceIndex:
        with self._lock:
            if self._device is None:
                self._device = self._build_device()
            return self._device

    def _build_device(self) -> DeviceIndex:
        import jax.numpy as jnp

        n = len(self.keys)
        # per-contig positions must fit pos<<1|strand in 31 bits — the
        # same single-contig bound as minimap2's 32-bit mm128 layout.
        # (TOTAL reference length is unbounded on device: nothing
        # device-side uses concatenated offsets.)
        if len(self.seq_lens) and int(self.seq_lens.max()) >= 2**31:
            raise OverflowError(
                "a single contig exceeds 2^31 bp; per-contig device "
                "coordinates (and minimap2 itself) cap contigs at 2^31"
            )
        # 128-multiple padding (pow2 padding wasted up to ~2x HBM on
        # GRCh38-scale key tables); the branchless binary searches are
        # generic over n_pad, sentinels fill the tail.
        n_pad = max(((max(n, 1) + 127) // 128) * 128, 128)
        eff = int(self.keys[-1]).bit_length() if n else 1
        keys32 = eff <= 32
        offcnt = np.zeros((n_pad, 2), np.int32)
        offcnt[:n, 0] = self.key_offsets[:n].astype(np.int32)
        offcnt[:n, 1] = (
            self.key_offsets[1:] - self.key_offsets[:-1]
        ).astype(np.int32)
        m = len(self.positions)
        m_pad = max(m, 8)
        pos_rp = np.zeros((m_pad, 2), np.int32)
        pos_rp[:m, 0] = (self.positions >> np.uint64(32)).astype(np.int32)
        pos_rp[:m, 1] = (
            (self.positions & np.uint64(0xFFFFFFFF))
            .astype(np.uint32)
            .view(np.int32)
        )
        log2 = max(n_pad - 1, 1).bit_length()
        dummy = np.zeros(8, np.uint32)
        # hash-probe mode (see DeviceIndex docstring): eff <= 31 so the
        # 0xFFFFFFFF empty-slot sentinel can never collide with a real
        # key.  The already-mixed minimizer hashes are near-uniform, so
        # slot = key >> (eff - t) over the SORTED keys is monotone and
        # the ordered-linear-probing layout is a vectorized prefix max.
        use_hash1 = n > 0 and eff <= 31
        # two-word probe (k > 15 presets: map-hifi/asm/splice, eff up
        # to 2k = 56 bits): word0 = key's low 31 bits (so the
        # 0xFFFFFFFF empty sentinel can never collide), word1 =
        # key >> 31; both words travel in ONE packed [rows, 128, 2]
        # window gather, keeping the k>16 device front end out of the
        # binary-search regime (VERDICT r4 missing #3)
        use_hash2 = n > 0 and 31 < eff <= 62
        if use_hash1 or use_hash2:
            # slot = fib_mix(key) >> (32 - t): the raw keys are hash64
            # outputs but under a 2k-bit mask the final mix steps
            # degenerate (the <<31 add is erased), leaving the top bits
            # badly striped — measured max displacement 1.3M at load
            # 0.35 without remixing, 20 at load 0.70 with it.  Keys are
            # placed in mixed order (np.argsort), hash_val maps a slot
            # back to the SORTED-key index for offcnt.
            t = max(int(n / 0.75).bit_length(), 8)
            if use_hash1:
                mixed = self.keys.astype(np.uint32) * HASH_MIX
            else:
                lo32 = (self.keys & np.uint64(0xFFFFFFFF)).astype(
                    np.uint32
                )
                up = (self.keys >> np.uint64(31)).astype(np.uint32)
                mixed = (lo32 ^ (up * HASH_MIX2)) * HASH_MIX
            i = np.arange(n, dtype=np.int64)
            while True:
                h_all = (mixed >> np.uint32(32 - t)).astype(np.int64)
                order = np.argsort(h_all, kind="stable")
                h = h_all[order]
                slot = i + np.maximum.accumulate(h - i)
                # the 2-row probe window covers displacement <= 128
                if int((slot - h).max()) <= 128:
                    break
                t += 1
            T = 1 << t
            rows = T // 128 + 1
            hval = np.full(rows * 128, n, np.int32)  # sentinel idx = n
            hval[slot] = order.astype(np.int32)
            if use_hash1:
                hkeys = np.full(rows * 128, 0xFFFFFFFF, np.uint32)
                hkeys[slot] = self.keys[order].astype(np.uint32)
                hash_rows = hkeys.reshape(rows, 128)
            else:
                hk = np.zeros((rows * 128, 2), np.uint32)
                hk[:, 0] = 0xFFFFFFFF  # fp sentinel (real fp <= 2^31-1)
                kk = self.keys[order]
                hk[slot, 0] = (kk & np.uint64(0x7FFFFFFF)).astype(
                    np.uint32
                )
                hk[slot, 1] = (kk >> np.uint64(31)).astype(np.uint32)
                hash_rows = hk.reshape(rows, 128, 2)
            return DeviceIndex(
                key_hi=jnp.asarray(dummy),
                key_lo=jnp.asarray(dummy),
                offcnt=jnp.asarray(offcnt),
                pos_rp=jnp.asarray(pos_rp),
                n_keys=n,
                log2_keys=log2,
                keys32=keys32,
                bucket_start=jnp.asarray(np.zeros(8, np.int32)),
                hash_rows=jnp.asarray(hash_rows),
                hash_val=jnp.asarray(hval[: T + 128]),
                hash_bits=t,
                hash_shift=32 - t,
            )
        key_lo = np.full(n_pad, 0xFFFFFFFF, np.uint32)
        key_lo[:n] = (self.keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if keys32:
            key_hi = dummy  # never gathered
        else:
            key_hi = np.full(n_pad, 0xFFFFFFFF, np.uint32)
            key_hi[:n] = (self.keys >> np.uint64(32)).astype(np.uint32)
        # bucket directory over the sorted keys (see DeviceIndex).
        # ~1 key/bucket on average: the ranged binary search is a
        # sequentially dependent gather chain, so halving the rounds
        # (vs the old n/16 sizing) is worth the 4x directory (4B per
        # bucket; 33MB at 32Mbp, capped 64MB at GRCh38 scale).
        bb = min(max(max(n, 1).bit_length(), 6), 24, max(eff, 1))
        shift = max(eff - bb, 0)
        b_of_key = (self.keys >> np.uint64(shift)).astype(np.int64)
        bcnts = np.bincount(b_of_key, minlength=1 << bb)
        bucket_start = np.concatenate(
            [[0], np.cumsum(bcnts)]
        ).astype(np.int32)
        rounds = int(max(int(bcnts.max()) if n else 1, 1).bit_length())
        return DeviceIndex(
            key_hi=jnp.asarray(key_hi),
            key_lo=jnp.asarray(key_lo),
            offcnt=jnp.asarray(offcnt),
            pos_rp=jnp.asarray(pos_rp),
            n_keys=n,
            log2_keys=log2,
            keys32=keys32,
            bucket_start=jnp.asarray(bucket_start),
            bucket_bits=bb,
            bucket_shift=shift,
            bucket_rounds=rounds,
        )

    # -- conversions ----------------------------------------------------
    @classmethod
    def from_raw(cls, raw: RawIndexData) -> "MinimizerIndex":
        if raw.packed_seq is not None:
            total = int(raw.seq_lens.astype(np.int64).sum())
            ref_codes = unpack_seq(raw.packed_seq, 0, total)
        else:
            ref_codes = np.empty(0, np.uint8)
        return cls(
            k=raw.k,
            w=raw.w,
            bucket_bits=raw.bucket_bits,
            flag=raw.flag,
            seq_names=list(raw.seq_names),
            seq_lens=raw.seq_lens.copy(),
            keys=raw.keys,
            key_offsets=raw.key_offsets,
            positions=raw.positions,
            ref_codes=ref_codes,
        )

    def to_raw(self) -> RawIndexData:
        return RawIndexData(
            k=self.k,
            w=self.w,
            bucket_bits=self.bucket_bits,
            flag=self.flag,
            seq_names=list(self.seq_names),
            seq_lens=self.seq_lens.astype(np.uint32),
            keys=self.keys,
            key_offsets=self.key_offsets,
            positions=self.positions,
            packed_seq=None if (self.flag & 0x2) else pack_seq(self.ref_codes),
        )
