"""Multi-chip execution: device meshes, index sharding, collectives.

The reference's only parallelism is n OS threads over a shared
read-only index (SURVEY.md §2c).  The scaling story here
replaces that with a 2-D `jax.sharding.Mesh`:

  axis "data"  — reads are data-parallel (the map_batch analogue);
  axis "index" — the minimizer key table is sharded by sorted-key
                 range (the "reference bucket" sharding of
                 BASELINE.json config 4) for GRCh38-scale indexes.

Each device looks its reads' minimizers up in its local key-range
shard, then per-shard anchors are merged with `jax.lax.all_gather`
over the "index" axis (a collective inside the host) and re-sorted
before chaining — exactly the all-gather-hit-merge design from the north star.  Chaining
and score-only extension then run data-parallel.

`build_sharded_map_step` returns a jitted shard_map'd function that the
driver's dryrun exercises on a virtual CPU mesh (__graft_entry__.py).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.index import MinimizerIndex
from ..ops.chain import ChainParams, chain_scores_block
from ..ops.extend import ExtendParams, extend_dp
from ..ops.lookup import collect_anchors
from ..ops.sketch import sketch_compact

P = jax.sharding.PartitionSpec

#: kept for backwards compatibility with round-1/2 callers; the
#: contig-range reference sharding below no longer caps read length
#: (extension windows live entirely inside the owning shard's contig
#: row, so there is no cross-block overlap to outgrow).
REF_OVERLAP = 8192


def make_mesh(
    n_data: int, n_index: int = 1, devices=None
) -> jax.sharding.Mesh:
    """(data, index) mesh over local or global devices.

    Multi-host layout rule: the ONLY cross-device collectives in the
    sharded map step ride the "index" axis (anchor all_gather + the
    extension pmax), so "index" must stay INSIDE a host (NVLink, every
    card reaches every other at the same rate) and "data" can span
    hosts (nothing crosses it, so the network between hosts carries
    zero aligner traffic).  `jax.devices()` under `jax.distributed`
    lists all global devices grouped by process, and this reshape puts
    mesh-adjacent devices along "index" — i.e. the host-local layout
    falls out of device order as long as n_index divides the per-host
    card count.  Pass `devices` to override."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_data * n_index]).reshape(
        n_data, n_index
    )
    return jax.sharding.Mesh(devices, ("data", "index"))


def shard_index_by_key_range(
    index: MinimizerIndex, n_shards: int
) -> dict:
    """Split the sorted key table into n contiguous range shards.

    Returns stacked host arrays with a leading shard axis, each shard
    padded to the same width with 0xFFFFFFFF key sentinels; position
    offsets are rebased per shard.
    """
    n = len(index.keys)
    bounds = [int(round(i * n / n_shards)) for i in range(n_shards + 1)]
    width = max(max(bounds[i + 1] - bounds[i] for i in range(n_shards)), 8)
    # pad to pow2 for the branchless binary search
    w2 = 1
    while w2 < width:
        w2 <<= 1
    width = w2
    key_hi = np.full((n_shards, width), 0xFFFFFFFF, np.uint32)
    key_lo = np.full((n_shards, width), 0xFFFFFFFF, np.uint32)
    offcnt = np.zeros((n_shards, width, 2), np.int32)
    n_keys = np.zeros((n_shards,), np.int32)
    pos_widths = []
    pos_shards = []
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        ks = index.keys[a:b]
        key_hi[s, : b - a] = (ks >> np.uint64(32)).astype(np.uint32)
        key_lo[s, : b - a] = (ks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        pa = int(index.key_offsets[a])
        pb = int(index.key_offsets[b])
        offcnt[s, : b - a, 0] = (
            index.key_offsets[a:b].astype(np.int64) - pa
        ).astype(np.int32)
        offcnt[s, : b - a, 1] = (
            index.key_offsets[a + 1 : b + 1] - index.key_offsets[a:b]
        ).astype(np.int32)
        n_keys[s] = b - a
        pos = index.positions[pa:pb]
        rp = np.zeros((len(pos), 2), np.int32)
        rp[:, 0] = (pos >> np.uint64(32)).astype(np.int32)
        rp[:, 1] = (
            (pos & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        )
        pos_shards.append(rp)
        pos_widths.append(pb - pa)
    pw = max(max(pos_widths), 8)
    pos_rp = np.zeros((n_shards, pw, 2), np.int32)
    for s in range(n_shards):
        pos_rp[s, : pos_widths[s]] = pos_shards[s]
    # the packed reference is SHARDED too (GRCh38-scale indexes don't
    # fit replicated): CONTIG-RANGE blocks — each shard owns a
    # contiguous rid range, concatenated with PER-SHARD LOCAL offsets.
    # All device coordinates stay per-shard int32, so the total
    # reference length is unbounded (only a single contig is capped at
    # 2^31 bp, minimap2's own limit), and extension windows never
    # cross a shard boundary (a window lives inside one contig).
    seq_lens = index.seq_lens.astype(np.int64)
    n_seq = len(seq_lens)
    if n_seq and int(seq_lens.max()) >= 2**31:
        raise OverflowError(
            "a single contig exceeds 2^31 bp; per-contig device "
            "coordinates (and minimap2 itself) cap contigs at 2^31"
        )
    # greedy contiguous partition of contigs into n_shards bins,
    # balanced by total length
    total_len = int(seq_lens.sum())
    target = total_len / max(n_shards, 1)
    rid_bounds = [0]
    acc = 0
    for rid in range(n_seq):
        acc += int(seq_lens[rid])
        if (acc >= target * len(rid_bounds)
                and len(rid_bounds) < n_shards):
            rid_bounds.append(rid + 1)
    while len(rid_bounds) < n_shards:
        rid_bounds.append(n_seq)
    rid_bounds.append(n_seq)
    rid2shard = np.zeros(max(n_seq, 1), np.int32)
    loc_off = np.zeros(max(n_seq, 1), np.int32)
    shard_lens = []
    for s in range(n_shards):
        a, b = rid_bounds[s], rid_bounds[s + 1]
        rid2shard[a:b] = s
        off = 0
        for rid in range(a, b):
            loc_off[rid] = off
            off += int(seq_lens[rid])
        shard_lens.append(off)
    blk = max((max(shard_lens) + 127) // 128 * 128 + 128, 256)
    if blk >= 2**31:
        raise OverflowError(
            "a contig-range shard exceeds 2^31 bp; use more index "
            "shards so each shard's contigs fit int32 offsets"
        )
    ref_blocks = np.full((n_shards, blk), 4, np.uint8)
    offs64 = index.seq_offsets  # int64 [n_seq+1], host only
    for s in range(n_shards):
        a, b = rid_bounds[s], rid_bounds[s + 1]
        if b > a:
            lo = int(offs64[a])
            hi = int(offs64[b])
            ref_blocks[s, : hi - lo] = index.ref_codes[lo:hi]
    return {
        "key_hi": key_hi,
        "key_lo": key_lo,
        "offcnt": offcnt,
        "n_keys": n_keys,
        "pos_rp": pos_rp,
        "ref_blocks": ref_blocks,  # [n_shards, blk] contig-range rows
        "rid2shard": rid2shard,    # int32 [n_seq] replicated
        "loc_off": loc_off,        # int32 [n_seq] shard-local offsets
    }


def build_sharded_map_step(
    mesh: jax.sharding.Mesh,
    k: int,
    w: int,
    max_minimizers: int,
    max_anchors: int,
    chain_params: ChainParams,
    ext_params: ExtendParams,
    mid_occ: int,
    chain_window: int = 16,
    ext_window: int = 64,
    ref_len_pad: int = 0,
):
    """Jitted full map step over a (data, index) mesh.

    Step signature: step(codes [B, L], lens [B], shard_arrays) ->
      dict with per-read best chain score / position / strand and a
      score-only banded extension score around the best chain.

    This is the device-only "decision mode" pipeline (readfish-style:
    where does this read map, with what confidence) — the CIGAR path
    additionally runs traceback host-side.

    The reference is sharded into CONTIG-RANGE blocks over the "index"
    axis (shard_index_by_key_range "ref_blocks"); the shard owning a
    read's contig computes its extension and the scalar results merge
    with a pmax — nothing reference-sized is ever replicated, which is
    what makes GRCh38-scale multi-host layouts fit, and every device
    coordinate is shard-local int32, so total reference length is
    unbounded (>2^31 bp included).  Returned ``ext_end_t`` is the
    extension end PER CONTIG.  `ref_len_pad` is accepted for
    backwards compatibility and ignored.
    """
    A_loc = max_anchors

    def local_step(codes, lens, sh):
        # shard_map gives per-device blocks; squeeze the shard axis
        key_hi = sh["key_hi"][0]
        key_lo = sh["key_lo"][0]
        offcnt = sh["offcnt"][0]
        n_keys = sh["n_keys"][0]
        pos_rp = sh["pos_rp"][0]
        ref_block = sh["ref_blocks"][0]  # [blk] this shard's contigs

        mins = sketch_compact(codes, lens, k, w, max_minimizers)
        loc = collect_anchors(
            mins, lens, key_hi, key_lo, offcnt, pos_rp,
            n_keys, jnp.int32(mid_occ), A_loc, k,
        )
        # merge per-shard anchors: all-gather over the index axis
        merged = {}
        for name in ("rev", "rid", "rpos", "qpos"):
            g = jax.lax.all_gather(loc[name], "index")  # [n_idx, B, A]
            merged[name] = jnp.reshape(
                jnp.swapaxes(g, 0, 1), (codes.shape[0], -1)
            )
        gv = jax.lax.all_gather(loc["valid"], "index")
        merged["valid"] = jnp.reshape(
            jnp.swapaxes(gv, 0, 1), (codes.shape[0], -1)
        )
        # re-sort the merged anchors (invalid to the end)
        sort_first = jnp.where(merged["valid"], merged["rev"], 2)
        srt = jax.lax.sort(
            (
                sort_first,
                merged["rid"],
                merged["rpos"],
                merged["qpos"],
                merged["valid"].astype(jnp.int32),
            ),
            dimension=1,
            num_keys=4,
        )
        anchors = {
            "rev": srt[0],
            "rid": srt[1],
            "rpos": srt[2],
            "qpos": srt[3],
            "valid": srt[4].astype(bool),
        }
        f, p = chain_scores_block(anchors, chain_params, chain_window)
        fv = jnp.where(anchors["valid"], f, -(1 << 30))
        best = jnp.argmax(fv, axis=1)
        rows = jnp.arange(codes.shape[0])
        best_score = fv[rows, best]
        best_rpos = anchors["rpos"][rows, best]
        best_qpos = anchors["qpos"][rows, best]
        best_rev = anchors["rev"][rows, best]
        best_rid = anchors["rid"][rows, best]

        # score-only banded extension of the whole read against a ref
        # window on the best chain's diagonal.  The merged anchors (and
        # so the best chain and its window) are identical on every
        # "index" peer of a data row; only the peer whose CONTIG-RANGE
        # reference shard contains the best chain's contig computes a
        # real extension, and the two scalars per read merge with a
        # pmax over "index" (tiny collective traffic instead of a
        # replicated reference).  All addressing is shard-local int32:
        # owner = rid2shard[rid], window start = loc_off[rid] + the
        # per-contig diagonal — no concatenated-reference coordinate
        # exists on device, so total reference length is unbounded.
        L = codes.shape[1]
        W = ext_window
        TWIN = L + W
        blk = ref_block.shape[0]
        if TWIN > blk:
            raise ValueError(
                f"extension window {TWIN} exceeds the reference shard "
                f"width {blk}"
            )
        # shard-local offset of query position 0 on the best diagonal
        diag_start = sh["loc_off"][best_rid] + best_rpos - best_qpos
        start = jnp.clip(diag_start - W // 2, 0, blk - TWIN)
        owner = sh["rid2shard"][best_rid]
        mine = owner == jax.lax.axis_index("index")
        local_off = start
        twin = jax.vmap(
            lambda s: jax.lax.dynamic_slice_in_dim(ref_block, s, TWIN)
        )(local_off)
        q_al = jnp.where(
            best_rev[:, None] == 1,
            _revcomp_batch(codes, lens),
            codes,
        )
        ext = extend_dp(
            q_al, twin, lens,
            jnp.minimum(lens + W, TWIN), L, TWIN, W,
            ext_params, score_only=True,
        )
        neg = jnp.int32(-(1 << 30))
        ext_sc = jax.lax.pmax(
            jnp.where(mine, ext["best_sc"], neg), "index"
        )
        # PER-CONTIG end coordinate (int32-safe at any genome size)
        end_in_ctg = start + ext["best_j"] + 1 - sh["loc_off"][best_rid]
        ext_end = jax.lax.pmax(
            jnp.where(mine, end_in_ctg, neg), "index"
        )
        return {
            "chain_score": best_score,
            "rev": best_rev,
            "rid": best_rid,
            "rpos": best_rpos,
            "ext_score": ext_sc,
            "ext_end_t": ext_end,
        }

    shard_specs = {
        "key_hi": P("index", None),
        "key_lo": P("index", None),
        "offcnt": P("index", None, None),
        "n_keys": P("index"),
        "pos_rp": P("index", None, None),
        "ref_blocks": P("index", None),
        "rid2shard": P(),
        "loc_off": P(),
    }
    out_spec = P("data")
    step = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P("data", None), P("data"), shard_specs),
            out_specs={
                "chain_score": out_spec,
                "rev": out_spec,
                "rid": out_spec,
                "rpos": out_spec,
                "ext_score": out_spec,
                "ext_end_t": out_spec,
            },
            check_vma=False,
        )
    )
    return step


def _revcomp_batch(codes: jnp.ndarray, lens: jnp.ndarray) -> jnp.ndarray:
    """Per-read reverse complement within true length, padding stays 4."""
    B, L = codes.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lens[:, None] - 1 - pos
    src_c = jnp.clip(src, 0, L - 1)
    g = jnp.take_along_axis(codes, src_c, axis=1)
    comp = jnp.where(g < 4, 3 - g, g)
    return jnp.where(src >= 0, comp, 4).astype(codes.dtype)
