#!/usr/bin/env python
"""Smoke run of the aligner's main path on one NVIDIA GPU.

Drives ``Aligner`` -> ``map`` and ``enable_threading`` + ``map_batch``
against a seeded synthetic reference of 300 Mbp held on the card, and
checks what comes out against the repo's independent CPU path:

  1. device     the platform must be "gpu" (no CPU fallback);
  2. native     rebuild libmappy_native.so on this host, require it;
  3. cache      the persistent compile cache (mappy_rs_tpu/utils/cache.py);
  4. reference  genome + index build, device index bytes, memory stats,
                and the front end's compiled memory analysis;
  5. map()      reads one by one, plus degenerate probes;
  6. streaming  device-owner worker processes, 1 kb + 5 kb + 10 kb
                reads; accuracy, reads/s (a smoke number, not a
                benchmark), one process on the card;
  7. compare    (a) 2,000 reads through the native CPU path: full-tuple
                and coordinate agreement; (b) the jitted front end on
                the GPU and on the CPU backend: bit-identical; (c) XLA
                device extension ("device_dl") vs host extension on 256
                jobs: bit-identical.

Every check that fails raises, so the exit code is non-zero and the
result line is not printed.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

``--four-cards`` runs only the multi-card paths (enable_mesh data
parallel, enable_mesh with a key-range-sharded index, and
map_batch_positions on a (2, 2) mesh), each against the one-card
result on the same reads, on four GPUs.

Usage: python chip_smoke.py [--four-cards] [--genome-mbp N]
       [--stream-reads N] [--trace DIR] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
READ_LEN = 1000
ERROR_RATE = 0.05


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass
class Sizes:
    """Scale of one run; the defaults are the full one-card smoke."""

    genome_mbp: float = 300.0
    n_map: int = 64
    n_stream: int = 16384
    n_long: int = 256  # each of 5 kb and 10 kb
    n_compare: int = 2000
    n_fe_batches: int = 4
    n_ext_jobs: int = 256
    procs: int = 4
    seed: int = 0


# ---------------------------------------------------------------- device
def require_gpu(count: int = 1):
    """The JAX devices, or SystemExit(2) when they are not `count` or
    more GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        print(
            f"chip_smoke: needs {count} GPU(s); JAX found "
            f"{len(devs)} x {devs[0].platform}",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return devs


def nvidia_smi(*query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", *query], check=True, capture_output=True, text=True,
        timeout=60,
    ).stdout.strip()


def card_line() -> str:
    return nvidia_smi(
        "--query-gpu=name,power.limit", "--format=csv,noheader"
    )


def result_line(devs) -> str:
    d = devs[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devs),
        },
    })


# ---------------------------------------------------------------- set-up
def rebuild_native() -> float:
    """Compile libmappy_native.so from the tracked sources on this host
    (the ISA of another host's build may not run here); seconds."""
    from mappy_rs_tpu import native

    t0 = time.time()
    native.build()
    check(native.available(), "native library failed to load")
    return time.time() - t0


def make_genome(rng, n: int) -> str:
    """Uniform ACGT, the same generator as bench.py."""
    return bytes(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    ).decode()


def device_index_bytes(index) -> int:
    dev = index.device
    return int(sum(
        getattr(dev, f.name).nbytes
        for f in dataclasses.fields(dev)
        if hasattr(getattr(dev, f.name), "nbytes")
    ))


def memory_stats(dev) -> dict:
    st = dev.memory_stats() or {}
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    return {k: st[k] for k in keys if k in st}


def front_end_memory(eng, L: int = 1024) -> dict:
    """Compile the fused front end at the full batch shape of bucket L
    and return its compiled.memory_analysis() and compile seconds."""
    from mappy_rs_tpu.models.pipeline import _front_end

    B, M, A = eng.fe_shapes(L)
    _lens, args, statics = eng.fe_inputs([], L, B, M, A)
    t0 = time.time()
    compiled = _front_end.lower(*args, **statics).compile()
    dt = time.time() - t0
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    return {
        "B": B, "L": L, "M": M, "A": A, "compile_s": round(dt, 2),
        **{f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)},
        "hlo_text": compiled.as_text(),
    }


# ---------------------------------------------------------------- reads
def simulate_reads(rng, genome: str, n: int, length: int):
    from bench import simulate

    if n == 0:
        return [], []
    return simulate(rng, genome, n, length, ERROR_RATE)


def n_placed(hits, truth) -> int:
    """Reads whose alignment starts within 100 bp of their origin: the
    leftmost primary hit, so a read whose alignment was split in two
    (zdrop) still counts by the piece that holds its start."""
    return sum(
        1 for ms, t in zip(hits, truth)
        if ms and abs(
            min(m.target_start for m in ms if m.is_primary) - t) < 100
    )


# ---------------------------------------------------------------- phases
def phase_map(al, reads, truth) -> dict:
    """Aligner.map one read at a time, plus degenerate probes."""
    t0 = time.time()
    hits = [al.map(r, cs=True) for r in reads]
    dt = time.time() - t0
    ok = n_placed(hits, truth)
    check(ok >= 0.99 * len(reads),
          f"map(): only {ok}/{len(reads)} reads placed within 100 bp")
    for probe in ("", "A", "N" * 50):
        check(al.map(probe) == [], f"map({probe[:5]!r}...) returned hits")
    return {"reads": len(reads), "placed": ok, "wall_s": round(dt, 3)}


def phase_stream(al, classes, procs: int, trace_dir=None) -> dict:
    """enable_threading + map_batch through the device-owner topology.
    `classes` maps a name to (reads, truth)."""
    import jax

    al._config.worker_processes = procs
    al._config.proc_chunk = 512
    al.enable_threading(3 * procs)
    try:
        from mappy_rs_tpu.runtime.devowner import DevOwnerMapper

        check(isinstance(al._procs, DevOwnerMapper),
              "worker processes are not the device-owner topology")
        platforms = [c["platform"] for c in al._procs.child_info]
        check(platforms == ["cpu"] * procs,
              f"device-owner children report platforms {platforms}")
        # set-up: index upload + every compile the window will need
        t0 = time.time()
        warm = [r for reads, _ in classes.values() for r in reads[:8]]
        al.warmup(warm)
        warm_s = time.time() - t0
        al.reset_metrics()
        payload, truth, cls = [], [], []
        for name, (reads, tr) in classes.items():
            for r, t in zip(reads, tr):
                payload.append({"i": len(payload), "seq": r})
                truth.append(t)
                cls.append(name)
        hits = [None] * len(payload)
        t0 = time.time()
        for mappings, data in al.map_batch(payload):
            hits[data["i"]] = mappings
        wall = time.time() - t0
        check(all(h is not None for h in hits), "map_batch lost reads")
        apps = nvidia_smi(
            "--query-compute-apps=pid", "--format=csv,noheader"
        ) if _has_nvidia_smi() else ""
        pids = [p for p in apps.splitlines() if p.strip()]
        check(len(pids) <= 1,
              f"{len(pids)} processes hold the card: {pids}")
        metrics = al.metrics
        trace = None
        if trace_dir is not None:
            # the 1 kb class only: one front-end executable, so its
            # HLO names the trace's device ops unambiguously
            first = next(iter(classes))
            trace = _traced_window(
                al, [d for d, c in zip(payload, cls) if c == first][:4096],
                trace_dir,
            )
    finally:
        al.enable_threading(0)
    placed = {}
    for name in classes:
        idx = [i for i, c in enumerate(cls) if c == name]
        ok = n_placed([hits[i] for i in idx], [truth[i] for i in idx])
        placed[name] = (ok, len(idx))
        check(ok >= 0.99 * len(idx),
              f"streaming {name}: only {ok}/{len(idx)} reads placed")
    return {
        "reads": len(payload),
        "wall_s": round(wall, 3),
        "reads_per_s": round(len(payload) / wall, 1),
        "warmup_s": round(warm_s, 2),
        "placed": placed,
        "fe_batches": metrics.get("fe_batches", 0),
        "anchor_overflow_retries": metrics.get(
            "anchor_overflow_retries", 0),
        "child_platforms": platforms,
        "compute_apps": pids if pids else "not listed",
        "peak_bytes_in_use": memory_stats(jax.devices()[0]).get(
            "peak_bytes_in_use"),
        "trace": trace,
    }


def _has_nvidia_smi() -> bool:
    from shutil import which

    return which("nvidia-smi") is not None


def _traced_window(al, payload, trace_dir) -> dict:
    """One profiler trace of a streaming window; per-stage device time
    from tools/trace_front_end.py."""
    import jax

    from tools.trace_front_end import (
        add_module_scopes, newest_xplane, reduce_trace,
    )

    eng = al._engine
    scopes = {}
    for L in sorted({eng._bucket_len(len(d["seq"])) for d in payload}):
        add_module_scopes(scopes, front_end_memory(eng, L)["hlo_text"])
    jax.profiler.start_trace(trace_dir)
    try:
        with jax.profiler.TraceAnnotation("stream_window"):
            for _ in al.map_batch(payload):
                pass
    finally:
        jax.profiler.stop_trace()
    out = reduce_trace(newest_xplane(trace_dir), scopes, "stream_window")
    out["reads"] = len(payload)
    return out


def phase_cpu_path(al, reads) -> dict:
    """The same reads through the device front end and through the
    native CPU front end, in this process; full hit tuples compared."""
    from mappy_rs_tpu.models.pipeline import AlignmentEngine
    from tools.concordance import compare

    eng = al._engine
    cpu = AlignmentEngine(
        eng.index, eng.opt,
        eng.cfg.replace(front_end_backend="cpu", extension_backend="host"),
    )
    out_dev = eng.map_batch(reads, cs=True)
    out_cpu = cpu.map_batch(reads, cs=True)
    st = compare(out_dev, out_cpu, eng.index, max_diffs=len(reads))
    mapped = st["both_mapped"] + st["one_side_only"]
    full_pct = 100.0 * st["full"] / max(mapped, 1)
    st["full_pct_of_mapped"] = full_pct
    check(full_pct >= 99.5,
          f"CPU path: full-tuple agreement {full_pct:.2f}% < 99.5%")
    check(st["coords_pct"] >= 99.9,
          f"CPU path: coordinate agreement {st['coords_pct']:.2f}% < 99.9%")
    return st


@contextlib.contextmanager
def _no_persistent_cache():
    """Keep the persistent compile cache out of XLA:CPU compiles: the
    cache directory may outlive the host, and a CPU executable written
    on another host may use instructions this one lacks."""
    import jax
    from jax._src import compilation_cache

    saved = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", saved)
        compilation_cache.reset_cache()


def phase_same_graph(al, reads, n_batches: int) -> dict:
    """The jitted front end on the default device and on the CPU
    backend (index copied there), on full 1 kb batches: the packed
    anchor/chain outputs must be bit-identical."""
    import jax

    from mappy_rs_tpu.models.pipeline import _front_end
    from mappy_rs_tpu.utils.seqcodes import encode

    eng = al._engine
    cpu = jax.devices("cpu")[0]
    L = 1024
    B, M, A = eng.fe_shapes(L)
    diff = total = 0
    cpu_args_cache = {}
    for bi in range(n_batches):
        chunk = [encode(r) for r in reads[bi * B:(bi + 1) * B]]
        if not chunk:
            break
        _lens, args, statics = eng.fe_inputs(chunk, L, B, M, A)
        dev_out = jax.device_get(_front_end(*args, **statics))
        cpu_args = []
        for a in args:
            if isinstance(a, jax.Array) and a.size > 1 << 16:
                # the index tables: copy once
                key = id(a)
                if key not in cpu_args_cache:
                    cpu_args_cache[key] = jax.device_put(a, cpu)
                cpu_args.append(cpu_args_cache[key])
            elif isinstance(a, jax.Array):
                cpu_args.append(jax.device_put(a, cpu))
            else:
                cpu_args.append(a)
        with _no_persistent_cache():
            cpu_out = jax.device_get(_front_end(*cpu_args, **statics))
        for x, y in zip(dev_out, cpu_out):
            diff += int(np.sum(np.asarray(x) != np.asarray(y)))
            total += int(np.asarray(x).size)
    check(total > 0, "same-graph check ran no batch")
    check(diff == 0,
          f"front end differs between backends in {diff}/{total} elements")
    return {"batches": n_batches, "B": B, "L": L, "A": A,
            "elements": total, "differing": diff,
            "cpu_device": str(cpu)}


def _extension_jobs(eng, reads):
    """Extension jobs (and their regions) for `reads`, from the native
    CPU front end's chains."""
    from mappy_rs_tpu import native
    from mappy_rs_tpu.ops.regions import (
        regions_from_compact, select_sub, set_parent,
    )
    from mappy_rs_tpu.utils.seqcodes import encode

    codes = [encode(r) for r in reads]
    od, mmo = eng._seed_select_params()
    chains, _rep, _n = native.front_end_batch(
        eng.index, codes, eng.opt.mid_occ, eng._chain_params,
        eng.cfg.cpu_chain_max_iter, eng.opt.min_cnt,
        eng.opt.min_chain_score, eng.cfg.backtrack_k, 8, eng.SEG_LEN,
        occ_dist=od, max_max_occ=mmo,
    )
    jobs = []
    for ri, c in enumerate(codes):
        regs = regions_from_compact(chains[ri], len(c), eng.index.k)
        set_parent(regs, eng.opt.mask_level, eng.opt.mask_len)
        regs = select_sub(regs, eng.opt.pri_ratio, eng.opt.best_n)
        jobs.extend(eng._make_jobs(regs, c, len(c)))
    return jobs


def _job_result(job):
    r = job.region
    if job.kind == "mid":
        ops, sc = r._mid_parts[job.seg]
        return ("mid", np.asarray(ops).tolist(), int(sc))
    ops, sc, qc, tc = getattr(r, f"_{job.kind}")
    return (job.kind, np.asarray(ops).tolist(), int(sc), int(qc), int(tc))


def phase_extension(al, reads, n_jobs: int) -> dict:
    """XLA banded extension on the device ("device_dl": DP on device,
    host walk) vs the C++ host engine on the same jobs."""
    eng = al._engine
    saved = eng.cfg.extension_backend
    results = {}
    try:
        for backend in ("device_dl", "host"):
            jobs = _extension_jobs(eng, reads)[:n_jobs]
            eng.cfg.extension_backend = backend
            t0 = time.time()
            eng._run_jobs(jobs)
            results[backend] = ([_job_result(j) for j in jobs],
                                time.time() - t0)
    finally:
        eng.cfg.extension_backend = saved
    dl, host = results["device_dl"][0], results["host"][0]
    n_diff = sum(1 for a, b in zip(dl, host) if a != b)
    check(len(dl) > 0, "extension check built no jobs")
    check(n_diff == 0,
          f"device_dl differs from host extension on {n_diff}/{len(dl)} jobs")
    return {"jobs": len(dl), "differing": n_diff,
            "device_dl_s": round(results["device_dl"][1], 3),
            "host_s": round(results["host"][1], 4)}


def one_card_phases(sz: Sizes, trace_dir=None) -> dict:
    """Phases 4-7 (see the module docstring) at the sizes in `sz`."""
    import jax

    from mappy_rs_tpu import Aligner

    dev = jax.devices()[0]
    out = {}
    rng = np.random.default_rng(sz.seed)
    t0 = time.time()
    genome = make_genome(rng, int(sz.genome_mbp * 1_000_000))
    t_genome = time.time() - t0
    t0 = time.time()
    al = Aligner(seq=genome, preset="map-ont")
    t_index = time.time() - t0
    t0 = time.time()
    nbytes = device_index_bytes(al._engine.index)
    t_upload = time.time() - t0
    out["reference"] = {
        "genome_bp": len(genome), "genome_s": round(t_genome, 2),
        "index_build_s": round(t_index, 2),
        "index_upload_s": round(t_upload, 2),
        "device_index_bytes": nbytes, "memory_stats": memory_stats(dev),
    }
    log(f"reference: {out['reference']}")
    fe = front_end_memory(al._engine)
    fe.pop("hlo_text")
    out["front_end_memory"] = fe
    log(f"front end memory_analysis: {fe}")

    reads, truth = simulate_reads(rng, genome, sz.n_map, READ_LEN)
    out["map"] = phase_map(al, reads, truth)
    log(f"map(): {out['map']}")

    short = simulate_reads(rng, genome, sz.n_stream, READ_LEN)
    classes = {
        "1kb": short,
        "5kb": simulate_reads(rng, genome, sz.n_long, 5000),
        "10kb": simulate_reads(rng, genome, sz.n_long, 10000),
    }
    out["stream"] = phase_stream(al, classes, sz.procs, trace_dir)
    log(f"streaming: {json.dumps(out['stream'], default=str)}")

    cmp_reads = short[0][: sz.n_compare]
    out["cpu_path"] = phase_cpu_path(al, cmp_reads)
    st = out["cpu_path"]
    log(f"CPU path: {st['full']}/{st['both_mapped'] + st['one_side_only']}"
        f" full tuples equal ({st['full_pct_of_mapped']:.3f}%), "
        f"coordinates {st['coords_pct']:.3f}%, one side only "
        f"{st['one_side_only']}; differing reads {st['n_diffs']}: "
        f"{st['diffs'][:5]}")
    out["same_graph"] = phase_same_graph(al, short[0], sz.n_fe_batches)
    log(f"same graph, two backends: {out['same_graph']}")
    out["extension"] = phase_extension(
        al, short[0][: sz.n_ext_jobs], sz.n_ext_jobs
    )
    log(f"device_dl vs host extension: {out['extension']}")
    return out


# ------------------------------------------------------------ four cards
def _mapping_tuples(al, regs_per_read):
    return [
        [(m.ctg, m.r_st, m.r_en, m.q_st, m.q_en, m.strand, m.mapq,
          m.cigar_str, m.NM, m.is_primary, m.cs)
         for m in al._to_mappings(r)]
        for r in regs_per_read
    ]


def four_card_phases(sz: Sizes) -> dict:
    """enable_mesh(4), enable_mesh(2, n_index=2) and
    map_batch_positions on a (2, 2) mesh, each against one card."""
    from mappy_rs_tpu import Aligner
    from mappy_rs_tpu.models.pipeline import AlignmentEngine

    out = {}
    rng = np.random.default_rng(sz.seed)
    genome = make_genome(rng, int(sz.genome_mbp * 1_000_000))
    t0 = time.time()
    al = Aligner(seq=genome, preset="map-ont")
    out["index_build_s"] = round(time.time() - t0, 2)
    reads, truth = simulate_reads(rng, genome, sz.n_stream, READ_LEN)

    def engine():
        return AlignmentEngine(al._index, al._map_opt, al._config.replace())

    one = engine()
    t0 = time.time()
    single = _mapping_tuples(al, one.map_batch(reads, cs=True))
    out["one_card_s"] = round(time.time() - t0, 2)
    placed = sum(
        1 for ms, t in zip(single, truth) if ms and abs(ms[0][1] - t) < 100
    )
    check(placed >= 0.99 * len(reads),
          f"one card: only {placed}/{len(reads)} reads placed")
    for name, (n_data, n_index) in (("mesh_dp4", (4, 1)),
                                    ("mesh_2x2_sharded_index", (2, 2))):
        eng = engine()
        eng.enable_mesh(n_data, n_index=n_index)
        t0 = time.time()
        got = _mapping_tuples(al, eng.map_batch(reads, cs=True))
        dt = time.time() - t0
        n_diff = sum(1 for a, b in zip(single, got) if a != b)
        out[name] = {"reads": len(reads), "differing_reads": n_diff,
                     "wall_s": round(dt, 2)}
        log(f"{name}: {out[name]}")
        check(n_diff == 0, f"{name}: {n_diff} reads differ from one card")

    pos_reads = reads[:256]
    al.enable_sharding(n_data=1, n_index=1)
    pos_one = al.map_batch_positions(pos_reads)
    al.enable_sharding(n_data=2, n_index=2)
    pos_mesh = al.map_batch_positions(pos_reads)
    n_diff = sum(1 for a, b in zip(pos_one, pos_mesh) if a != b)
    n_called = sum(1 for p in pos_one if p is not None)
    out["positions_2x2"] = {"reads": len(pos_reads), "called": n_called,
                            "differing": n_diff}
    log(f"positions_2x2: {out['positions_2x2']}")
    check(n_called >= 0.99 * len(pos_reads),
          f"positions: only {n_called}/{len(pos_reads)} reads called")
    check(n_diff == 0, f"positions: {n_diff} reads differ from one card")
    return out


# ------------------------------------------------------------------ main
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--genome-mbp", type=float, default=None)
    ap.add_argument("--stream-reads", type=int, default=None)
    ap.add_argument("--trace", default=None,
                    help="trace one streaming window into this directory")
    ap.add_argument("--out", default=None,
                    help="write the full results as JSON into this directory")
    opts = ap.parse_args(argv)
    count = 4 if opts.four_cards else 1
    devs = require_gpu(count)
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}; count: {len(devs)}")
    log(f"card: {card_line()}")
    t_native = rebuild_native()
    log(f"native library rebuilt on this host: {t_native:.1f}s (set-up)")
    from mappy_rs_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache(ROOT)}")

    sz = Sizes()
    if opts.four_cards:
        sz = dataclasses.replace(sz, genome_mbp=32.0, n_stream=2048)
    if opts.genome_mbp is not None:
        sz = dataclasses.replace(sz, genome_mbp=opts.genome_mbp)
    if opts.stream_reads is not None:
        sz = dataclasses.replace(sz, n_stream=opts.stream_reads)
    t0 = time.time()
    if opts.four_cards:
        res = four_card_phases(sz)
    else:
        res = one_card_phases(sz, opts.trace)
        st = res["stream"]
        log(f"SMOKE reads/s on this card ({card_line()}): "
            f"{st['reads_per_s']} over {st['reads']} reads — a smoke "
            f"number, not a benchmark")
    log(f"phases: {time.time() - t0:.1f}s")
    if opts.out:
        os.makedirs(opts.out, exist_ok=True)
        name = "four_cards.json" if opts.four_cards else "one_card.json"
        with open(os.path.join(opts.out, name), "w") as fh:
            json.dump({"sizes": dataclasses.asdict(sz), **res}, fh,
                      indent=1, default=str)
    log(f"card: {card_line()}")
    print(result_line(devs), flush=True)


if __name__ == "__main__":
    main()
