#!/usr/bin/env python
"""Gbp-scale run on one card: build a 3.1 Gbp hg38-like synthetic
genome, put its full map-ont index on the accelerator (ONE device copy
via the device-owner topology), and measure streaming map_batch
throughput + the per-array device footprint.

Genome model: hg38 is ~45% repeat-derived; a uniform-random 3.1 Gbp
genome would need ~16 GB of device index (tools/hbm_budget.py) because
every minimizer key is distinct.  Real genomes collapse far harder
(minimap2's published hg38 map-ont index: ~100M distinct keys for
~560M positions).  Model: 24 contigs x 2^27 bp of random sequence,
then ~45% of each contig overwritten by mutated (2% sub) copies of a
40-element repeat library (300 bp "SINE" to 6 kb "LINE" classes) —
dispersed repeats, vectorized scatter, measured key ratio reported in
the artifact.

Usage (on the machine with the card):
  PYTHONHASHSEED=0 python tools/gbp_chip.py [--gbp=3.1] [--procs=3]
Writes gbp_chip.json at the repo root.
"""
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CONTIG = 1 << 27  # 134.2 Mbp per contig (< 2^31; per-contig coords)
GBP = 3.1
for a in sys.argv[1:]:
    if a.startswith("--gbp="):
        GBP = float(a.split("=", 1)[1])
N_CONTIG = max(1, int(GBP * 1e9) // CONTIG)
N_PROCS = int(next(
    (a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--procs=")),
    "3",
))
N_READS = 8000
READ_LEN = 1000
ERR = 0.05
_COMP = np.array([3, 2, 1, 0], np.uint8)


def _log(m):
    print(f"# [{time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def build_genome(rng):
    """3.1 Gbp as one uint8 code buffer (contigs are disjoint views)."""
    n = CONTIG * N_CONTIG
    buf = rng.integers(0, 1 << 32, n // 4, dtype=np.uint32).view(np.uint8)
    buf &= 3
    # repeat library: 30 SINE-class (300 bp) + 10 LINE-class (6 kb)
    lib = [rng.integers(0, 4, 300, dtype=np.uint8) for _ in range(30)]
    lib += [rng.integers(0, 4, 6000, dtype=np.uint8) for _ in range(10)]
    # NON-OVERLAPPING dispersed placement (random pastes overwrite
    # each other and regenerate novel junction k-mers — measured: the
    # distinct-key ratio barely dropped).  Draw a copy sequence, then
    # distribute the random-sequence budget as inter-copy gaps.
    target = int(0.52 * n)
    lens_lib = np.array([len(e) for e in lib])
    est = int(1.2 * target / lens_lib.mean())
    ids = rng.integers(0, len(lib), est)
    lens = lens_lib[ids]
    keep = np.cumsum(lens) <= target
    ids, lens = ids[keep], lens[keep]
    gap_total = n - int(lens.sum())
    g = rng.random(len(ids) + 1)
    g = np.floor(g / g.sum() * gap_total).astype(np.int64)
    starts = np.cumsum(g[:-1] + np.concatenate(([0], lens[:-1])))
    placed = 0
    for j, e in enumerate(lib):
        sel = starts[ids == j]
        if not len(sel):
            continue
        idx = sel[:, None] + np.arange(len(e))
        copies = np.broadcast_to(e, (len(sel), len(e))).copy()
        # 0.5% divergence per copy: enough to be biologically shaped,
        # low enough that repeat keys actually collapse (2% left the
        # distinct-key ratio near-random; real hg38 collapses to ~0.18)
        mut = rng.random((len(sel), len(e))) < 0.005
        copies[mut] = (copies[mut] + rng.integers(
            1, 4, int(mut.sum()), dtype=np.uint8
        )) & 3
        buf[idx.reshape(-1)] = copies.reshape(-1)
        placed += len(sel) * len(e)
    _log(f"genome {n / 1e9:.2f} Gbp, {placed / n:.0%} repeat-covered")
    return buf, starts, lens


def sample_reads(rng, buf, n, rep_starts, rep_lens):
    """Error-injected 1 kb reads with known origins (bench.simulate's
    model, operating on code buffers).  Also returns a per-read
    `unique` flag: True when the read overlaps no repeat copy —
    placement accuracy is only a meaningful oracle there (repeat-origin
    reads are genuinely multi-mapping, exactly as on hg38)."""
    W = READ_LEN + 64
    n_total = CONTIG * N_CONTIG
    starts = rng.integers(0, n_total - W, n)
    # avoid reads straddling contig ends (they'd map split)
    starts -= np.maximum(0, (starts % CONTIG) - (CONTIG - W))
    i = np.searchsorted(rep_starts, starts)
    prev_end = np.where(
        i > 0, rep_starts[np.maximum(i - 1, 0)]
        + rep_lens[np.maximum(i - 1, 0)], 0
    )
    next_start = np.where(
        i < len(rep_starts), rep_starts[np.minimum(i, len(rep_starts) - 1)],
        n_total,
    )
    unique = (prev_end <= starts) & (next_start >= starts + W)
    tmpl = buf[starts[:, None] + np.arange(W)]
    r = rng.random((n, W))
    sub = r < ERR * 0.6
    rot = rng.integers(1, 4, (n, W), dtype=np.uint8)
    subbed = np.where(sub, (tmpl + rot) & 3, tmpl)
    ins = (r >= ERR * 0.6) & (r < ERR * 0.8)
    dele = (r >= ERR * 0.8) & (r < ERR)
    ins_code = rng.integers(0, 4, (n, W), dtype=np.uint8)
    rc = rng.random(n) < 0.5
    bases = "ACGT"
    reads = []
    cap = READ_LEN + 24
    for i in range(n):
        keep = ~dele[i]
        base = subbed[i][keep]
        insertions = ins_code[i][ins[i]]
        if insertions.size:
            at = np.cumsum(keep)[ins[i]]
            out = np.insert(base, at, insertions)
        else:
            out = base
        out = out[:cap]
        if rc[i]:
            out = _COMP[out[::-1]]
        reads.append("".join(bases[c] for c in out))
    return reads, starts, unique


def main():
    t_all = time.time()
    import jax

    from mappy_rs_tpu.utils.cache import enable_compile_cache

    enable_compile_cache(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from mappy_rs_tpu.api import Aligner, set_opt
    from mappy_rs_tpu.config import MM_F_CIGAR, AlignerConfig
    from mappy_rs_tpu.index.build import build_index
    from mappy_rs_tpu.models.pipeline import AlignmentEngine

    rng = np.random.default_rng(5)
    # genome + host index are deterministic (seeded) and cost ~30 min
    # at 3.1 Gbp — cache them on local disk so a rerun (e.g. after a
    # device-side fix) pays only DeviceIndex build + upload.
    cache = f"/tmp/gbp_cache_{N_CONTIG}x{CONTIG}"
    idx_opt, map_opt = set_opt("map-ont")
    map_opt.flag |= MM_F_CIGAR
    if os.path.exists(os.path.join(cache, "done")):
        from mappy_rs_tpu.index.share import load_index_dir

        t0 = time.time()
        buf = np.load(os.path.join(cache, "genome.npy"), mmap_mode="r")
        rep_starts = np.load(os.path.join(cache, "rep_starts.npy"))
        rep_lens = np.load(os.path.join(cache, "rep_lens.npy"))
        index = load_index_dir(cache)
        genome_s = build_s = 0.0
        _log(f"genome + index from cache {cache}: {time.time() - t0:.0f}s")
    else:
        from mappy_rs_tpu.index.share import save_index_dir

        t0 = time.time()
        buf, rep_starts, rep_lens = build_genome(rng)
        genome_s = time.time() - t0

        contigs = [
            (f"ctg{i:02d}", buf[i * CONTIG: (i + 1) * CONTIG])
            for i in range(N_CONTIG)
        ]
        t0 = time.time()
        index = build_index(contigs, idx_opt)
        build_s = time.time() - t0
        try:
            save_index_dir(index, cache)
            np.save(os.path.join(cache, "genome.npy"), buf)
            np.save(os.path.join(cache, "rep_starts.npy"), rep_starts)
            np.save(os.path.join(cache, "rep_lens.npy"), rep_lens)
            open(os.path.join(cache, "done"), "w").close()
        except OSError as exc:  # disk-full etc: cache is optional
            _log(f"cache save skipped: {exc!r}")
    index.update_map_options(map_opt)
    n_pos = int(index.pos_data.shape[0]) if hasattr(index, "pos_data") else 0
    _log(f"index built in {build_s:.0f}s")

    # hand-assembled Aligner over the prebuilt index (the ctor's
    # seq=/fn_idx_in= paths would round-trip 3 GB through a string)
    al = Aligner.__new__(Aligner)
    al._index = index
    al._map_opt = map_opt
    al._idx_opt = idx_opt
    al._config = AlignerConfig(
        idx_opt=idx_opt, map_opt=map_opt, preset="map-ont"
    )
    al._engine = AlignmentEngine(index, map_opt, al._config)
    al._engine_lock = threading.Lock()
    al._pool = None
    al._procs = None
    al.n_threads = 0

    # ---- the one device upload (device-owner topology) ----
    t0 = time.time()
    dev = al._engine.dev
    arrays = {}
    total = 0
    for name in ("key_hi", "key_lo", "offcnt", "pos_rp", "bucket_start",
                 "hash_rows", "hash_val"):
        arr = getattr(dev, name, None)
        if arr is None or not hasattr(arr, "nbytes"):
            continue
        jax.block_until_ready(arr)
        arrays[name] = int(arr.nbytes)
        total += int(arr.nbytes)
    upload_s = time.time() - t0
    _log(f"device index: {total / 1e9:.2f} GB uploaded in {upload_s:.0f}s "
         f"({ {k: round(v / 1e9, 3) for k, v in arrays.items()} })")

    t0 = time.time()
    reads, starts, uniq = sample_reads(
        rng, buf, 3 * N_READS + 256, rep_starts, rep_lens
    )
    _log(f"simulated {len(reads)} reads ({uniq.mean():.0%} unique-origin):"
         f" {time.time() - t0:.0f}s")
    payloads = [
        [{"i": p * N_READS + i, "seq": s}
         for i, s in enumerate(reads[p * N_READS:(p + 1) * N_READS])]
        for p in range(3)
    ]

    al._config.worker_processes = N_PROCS
    al._config.proc_chunk = 1024
    t0 = time.time()
    al.enable_threading(2 * N_PROCS)
    al.warmup(reads[3 * N_READS:])
    warm_s = time.time() - t0
    _log(f"worker spawn + warmup: {warm_s:.0f}s")
    al.reset_metrics()
    passes = []
    for pl in payloads:
        t0 = time.time()
        n_ok = n_hit = n_uq = n_uq_ok = 0
        for m, d in al.map_batch(pl):
            i = d["i"]
            if m:
                n_hit += 1
            if uniq[i]:
                n_uq += 1
            gs = int(starts[i])
            ok = bool(m) and (
                m[0].target_name == f"ctg{gs // CONTIG:02d}"
                and abs(m[0].target_start - gs % CONTIG) < 100
            )
            n_ok += ok
            n_uq_ok += ok and bool(uniq[i])
        dt = time.time() - t0
        passes.append(round(N_READS / dt, 1))
        _log(f"pass: {passes[-1]:.1f} reads/s ({n_hit} hit; "
             f"unique-origin {n_uq_ok}/{n_uq} correct; "
             f"overall {n_ok}/{N_READS})")
    probe = al.probe_front_end(10)
    al.enable_threading(0)
    v = sorted(passes)
    out = {
        "metric": "gbp_scale_reads_per_sec_chip",
        "genome_bp": CONTIG * N_CONTIG,
        "n_contigs": N_CONTIG,
        "preset": "map-ont (k=15, w=10)",
        "topology": f"device_owner x{N_PROCS} post-chain workers",
        "index_build_s": round(build_s, 1),
        "genome_gen_s": round(genome_s, 1),
        "device_index_bytes": arrays,
        "device_index_gb": round(total / 1e9, 3),
        "upload_s": round(upload_s, 1),
        "warmup_s": round(warm_s, 1),
        "passes": passes,
        "median": v[len(v) // 2],
        "ms_per_batch_pipelined": round(1e3 * probe[0], 2) if probe else None,
        "accuracy_note": (
            f"final pass: unique-origin {n_uq_ok}/{n_uq} within 100bp; "
            f"{n_ok}/{N_READS} overall (repeat-origin reads are "
            f"multi-mapping by construction)"
        ),
        "date": time.strftime("%Y-%m-%d"),
    }
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "gbp_chip.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    _log(f"total {time.time() - t_all:.0f}s")


if __name__ == "__main__":
    main()
