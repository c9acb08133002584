#!/usr/bin/env python
"""Benchmark: reads/sec/chip on an ONT-like mapping workload, against a
MEASURED in-environment CPU baseline.

Workload (mirrors the reference's benchmark design, tests/benchmark.py
+ README table: ONT fastq vs an hg38 index, scaled to what builds
in-environment): simulated nanopore-like reads (1 kb, 5% edits)
against a synthetic 32 Mbp genome, mapped through the full map_batch
streaming path (sketch -> seed -> chain -> extend -> CIGAR) with the
worker pool enabled.  Genome scale matters: at 1 Mbp the whole
minimizer table is CPU-cache-resident and a 4-thread scalar front end
ties the device; at 32 Mbp (~5.9M keys, ~220MB of index arrays) seed
lookup is memory-bound on the host — the regime the reference's own
hg38 benchmark lives in, and where the device front end pulls ahead.

Baseline: a minimap2-class CPU aligner measured on the same workload
on the same host — this framework's own all-native CPU path
(native/front_end.cc sketch+chain + C++ banded extension, the
reference's architecture: scalar C per read under a worker pool) at
all host cores.  The measurement is written to BASELINE_CPU.json
(untracked, with the workload fingerprint) and reused on later runs on
the same checkout; `--baseline` re-measures it.

Prints ONE JSON line:
  {"metric": "reads/sec/chip", "value": N, "unit": "reads/s",
   "vs_baseline": R, "passes": [...], "median": M, "best": X,
   "baseline": {"value": B, "date": D, ...}}
where value = MEDIAN pass, vs_baseline = median / measured_cpu_rps,
and passes/best publish the spread.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

FALLBACK_BASELINE = 1000.0  # only if the native CPU path is unavailable

# Genome scale is configurable (VERDICT r3 directive 1): the default
# headline stays 32 Mbp; `--genome-mb=300` (or BENCH_GENOME_MB=300)
# runs the >=300 Mbp configuration in-env (index ~55M keys; child
# uploads grow with it, so the large run is for scale evidence, not
# the per-round driver capture).
GENOME_MB = int(os.environ.get("BENCH_GENOME_MB", "32"))
for _a in sys.argv[1:]:
    if _a.startswith("--genome-mb="):
        GENOME_MB = int(_a.split("=", 1)[1])
GENOME_LEN = GENOME_MB * 1_000_000
# 8000 reads/pass: at ~9k reads/s a pass is ~0.9s, so the pipeline
# fill/drain tail (~2 device batches) costs <5% of the measurement
# (at 4000 it was ~10%) — the steady-state number the streaming
# runtime is designed for.  Simulation is vectorized so setup stays
# cheap at this N.
N_READS = 8000
N_READS_CPU = 1500
READ_LEN = 1000
ERROR_RATE = 0.05

#: soft wall budget for the measured part of a single `--once` run:
#: passes after the first stop once this is exceeded (the JSON must
#: reach the driver; extra passes are spread data, not the record).
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "360"))
BASELINE_FILE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "BASELINE_CPU.json"
)


def _workload_fp() -> dict:
    """Fingerprint of the baseline workload: a persisted baseline is
    only valid against the same workload."""
    return {
        "genome_mb": GENOME_MB,
        "n_reads": N_READS_CPU,
        "read_len": READ_LEN,
        "error_rate": ERROR_RATE,
    }


def simulate(rng, genome: str, n: int, length: int, err: float):
    """Nanopore-like reads: i.i.d. substitutions / insertions /
    deletions at `err` (60/20/20 split), half the reads
    reverse-complemented.  Vectorized (numpy) so large N stays cheap;
    the per-read python loop this replaced cost ~3 ms/read."""
    g = np.frombuffer(genome.encode(), np.uint8)
    W = length + 64  # template window: deletions consume extra chars
    starts = rng.integers(0, len(genome) - W, n)
    tmpl = g[starts[:, None] + np.arange(W)]  # [n, W] ASCII
    r = rng.random((n, W))
    # substitutions: rotate within ACGT so the base always changes
    code = np.zeros(256, np.uint8)
    code[ord("C")], code[ord("G")], code[ord("T")] = 1, 2, 3
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sub = r < err * 0.6
    rot = rng.integers(1, 4, (n, W), dtype=np.uint8)
    subbed = np.where(sub, acgt[(code[tmpl] + rot) & 3], tmpl)
    ins = (r >= err * 0.6) & (r < err * 0.8)
    dele = (r >= err * 0.8) & (r < err)
    ins_char = acgt[rng.integers(0, 4, (n, W), dtype=np.uint8)]
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = rng.random(n) < 0.5
    reads = []
    cap = length + 24  # keep every read in one device bucket
    for i in range(n):
        keep = ~dele[i]  # ins implies keep (bands are disjoint)
        base = subbed[i][keep]
        insertions = ins_char[i][ins[i]]
        if insertions.size:
            # np.insert indexes the PRE-insertion array: the slot
            # after kept char j is cumsum(keep)[j]
            at = np.cumsum(keep)[ins[i]]
            out = np.insert(base, at, insertions)
        else:
            out = base
        out = out[:cap]
        if rc[i]:
            out = comp[out[::-1]]
        reads.append(out.tobytes().decode())
    return reads, [int(s) for s in starts]


def _enable_compile_cache() -> None:
    from mappy_rs_tpu.utils.cache import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))


def _log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main() -> None:
    """Run the measurement in a subprocess with a hard timeout, retried
    once: a missing JSON line would lose the run's record."""
    import subprocess

    passthru = [
        a for a in sys.argv[1:]
        if a.startswith("--genome") or a == "--baseline"
    ]
    if "--once" in sys.argv:
        _run()
        return
    env = dict(os.environ)
    # deterministic trace-time hashing keeps the persistent compile
    # cache key stable across processes and runs
    env.setdefault("PYTHONHASHSEED", "0")
    for attempt, tmo in enumerate((1700, 600)):
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--once"]
                + passthru,
                timeout=tmo,
                env=env,
            )
            if proc.returncode == 0:
                return
            print(f"# bench attempt {attempt + 1}: exit "
                  f"{proc.returncode}", file=sys.stderr)
        except subprocess.TimeoutExpired:
            print(f"# bench attempt {attempt + 1}: timed out after "
                  f"{tmo}s", file=sys.stderr)
        time.sleep(20)
    raise SystemExit(1)


def _measure(al, payloads, truth, n_warm=256, reset_after_warm=False,
             deadline=None):
    """Timed passes, one DISJOINT fresh payload per pass (both the CPU
    baseline and the device path get the same treatment).  Multiple
    passes damp run-to-run noise; disjoint reads per pass keep the
    repeat-a-read page-cache artifact out of the number — a rerun of
    identical reads measures cache residency, not mapping throughput.
    Passes after the first stop at `deadline` (time.time() value).

    Returns (passes, best, wall) where passes is a list of
    (reads_per_sec, dt, n_hit, n_correct) and best is the max-rps one.
    """
    for _ in al.map_batch(payloads[0][:n_warm]):
        pass
    if reset_after_warm:
        # stage metrics from here on are STEADY STATE (no compile,
        # no index upload)
        al.reset_metrics()
    passes = []
    wall = 0.0
    for payload in payloads:
        n_correct = 0
        n_hit = 0
        t0 = time.time()
        for mappings, data in al.map_batch(payload):
            if mappings:
                n_hit += 1
                m = mappings[0]
                if abs(m.target_start - truth[data["i"]]) < 100:
                    n_correct += 1
        dt = time.time() - t0
        wall += dt
        passes.append((len(payload) / dt, dt, n_hit, n_correct))
        if deadline is not None and time.time() > deadline:
            _log(f"budget reached after {len(passes)} pass(es)")
            break
    best = max(passes, key=lambda p: p[0])
    return passes, best, wall


def _measure_cpu_baseline(genome, cpu_payloads, truth) -> dict:
    """Measure the all-native CPU aligner at full host parallelism.

    The CPU aligner gets the SAME runtime choices as the device path:
    whichever of thread-mode / multi-process mode is faster for it
    anchors vs_baseline (threads GIL-stall on the per-read python
    glue; processes scale it — fairness demands the CPU side gets the
    better of the two as well)."""
    from mappy_rs_tpu import Aligner

    n_cpu = os.cpu_count() or 4
    cpu_rps = 0.0
    cpu_desc = ""
    for n_procs in (0, n_cpu):
        al_cpu = Aligner(seq=genome, preset="map-ont")
        al_cpu._engine.cfg.front_end_backend = "cpu"
        al_cpu._engine.cfg.extension_backend = "host"
        al_cpu._engine.cfg.worker_processes = n_procs
        al_cpu.enable_threading(n_cpu)
        _passes, best, _w = _measure(al_cpu, cpu_payloads, truth)
        al_cpu.enable_threading(0)
        al_cpu = None
        r, _dt, _hit, ok = best
        mode = f"{n_procs} procs" if n_procs else f"{n_cpu} threads"
        if r > cpu_rps:
            cpu_rps = r
            cpu_desc = f"{mode}, {ok}/{len(cpu_payloads[0])} correct"
    return {
        "value": round(cpu_rps, 1),
        "date": time.strftime("%Y-%m-%d"),
        "desc": f"all-native CPU path, best of threads/procs ({cpu_desc})",
        "n_cores": n_cpu,
        "workload": _workload_fp(),
    }


def _load_baseline() -> dict | None:
    try:
        with open(BASELINE_FILE) as f:
            d = json.load(f)
        if d.get("workload") == _workload_fp() and d.get("value", 0) > 0:
            return d
    except Exception:  # noqa: BLE001 — missing/stale artifact: re-measure
        pass
    return None


def _run() -> None:
    t_start = time.time()
    _enable_compile_cache()
    from mappy_rs_tpu import Aligner, native

    rng = np.random.default_rng(0)
    genome = bytes(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, GENOME_LEN)]
    ).decode()
    # 6 disjoint payloads per measured config (see _measure): the
    # median over 6 damps run-to-run noise.  Disjoint reads per pass
    # keep the repeat-a-read cache artifact out.
    n_pass = 6
    reads, truth = simulate(
        rng, genome, n_pass * N_READS, READ_LEN, ERROR_RATE
    )
    payload = [{"i": i, "seq": r} for i, r in enumerate(reads)]
    payloads = [
        payload[p * N_READS : (p + 1) * N_READS] for p in range(n_pass)
    ]
    cpu_payloads = [
        payload[p * N_READS : p * N_READS + N_READS_CPU] for p in range(3)
    ]
    _log(f"setup (genome + {n_pass * N_READS} simulated reads): "
         f"{time.time() - t_start:.1f}s")

    # ---- CPU baseline: persisted artifact, measured when absent ----
    force_baseline = "--baseline" in sys.argv
    baseline = None if force_baseline else _load_baseline()
    if baseline is None:
        if native.available():
            t0 = time.time()
            baseline = _measure_cpu_baseline(genome, cpu_payloads, truth)
            with open(BASELINE_FILE, "w") as f:
                json.dump(baseline, f, indent=1)
            _log(f"measured + persisted CPU baseline "
                 f"{baseline['value']:.1f} reads/s "
                 f"({time.time() - t0:.1f}s) -> {BASELINE_FILE}")
        else:
            baseline = {
                "value": FALLBACK_BASELINE,
                "date": "none",
                "desc": "native lib unavailable; estimated baseline",
                "workload": _workload_fp(),
            }
    else:
        _log(f"CPU baseline from {BASELINE_FILE}: "
             f"{baseline['value']:.1f} reads/s ({baseline['date']})")
    cpu_rps = float(baseline["value"])
    if force_baseline:
        _log("baseline refresh done")
        return

    # ---- device path: device-owner topology (runtime/devowner.py) —
    # the parent owns the only device client (one index upload, one
    # compile) and N jax-free post-chain children do the host tail ----
    t0 = time.time()
    al = Aligner(seq=genome, preset="map-ont")
    n_procs = int(os.environ.get("MAPPY_RS_TPU_PROCS", "3"))
    al._config.worker_processes = n_procs
    al._config.proc_chunk = int(
        os.environ.get("MAPPY_RS_TPU_PROC_CHUNK", "512")
    )
    _log(f"index build: {time.time() - t0:.1f}s")
    t0 = time.time()
    # 3 proxies per child: proxies run the parent-side front end, so
    # one can sit in its child round-trip while another feeds the
    # device (MAPPY_RS_TPU_PROXIES overrides)
    n_proxies = int(
        os.environ.get("MAPPY_RS_TPU_PROXIES", str(3 * n_procs))
    )
    al.enable_threading(n_proxies)
    # one-time costs before timing: device index upload + compile
    al.warmup(reads[:256])
    _log(f"worker spawn + warmup: {time.time() - t0:.1f}s")
    _cpu0 = time.process_time()
    passes, best, wall = _measure(
        al, payloads, truth, reset_after_warm=True,
        deadline=max(t_start + BUDGET_S, time.time() + 120.0),
    )
    parent_cpu = time.process_time() - _cpu0
    rps, dt, n_hit, n_correct = best
    pass_rates = sorted(p[0] for p in passes)
    median = pass_rates[len(pass_rates) // 2] if len(pass_rates) % 2 else (
        0.5 * (pass_rates[len(pass_rates) // 2 - 1]
               + pass_rates[len(pass_rates) // 2])
    )
    # steady-state device-pipeline seconds per front-end batch
    # (device execution + transfer; no host stages)
    probe = al.probe_front_end(10)
    roof = al.front_end_roofline()

    print(
        json.dumps(
            {
                "metric": "reads/sec/chip",
                # value == median: the honest-by-construction headline
                # (best-of-passes rode the backend's 2x variance)
                "value": round(median, 2),
                "unit": "reads/s",
                "vs_baseline": round(median / cpu_rps, 3),
                "passes": [round(p[0], 1) for p in passes],
                "median": round(median, 1),
                "best": round(rps, 1),
                "baseline": {
                    "value": cpu_rps,
                    "date": baseline.get("date", "?"),
                    "desc": baseline.get("desc", ""),
                },
            }
        ),
        flush=True,
    )
    m = al.metrics
    n_procs = int(m.get("worker_procs", 0)) or 1
    # stage timers are cpu-seconds summed over every worker process
    # and thread; the per-process view is what compares to wall time
    fe = m.get("time_front_end_s", 0.0)
    ext = m.get("time_extend_s", 0.0) + m.get("time_extend_small_s", 0.0)
    fin = m.get("time_finalize_s", 0.0)
    duty_line = ""
    if probe:
        ms_thr = 1000 * probe[0]  # pipelined seconds/batch
        ms_lat = 1000 * probe[-1]  # one-dispatch round trip
        batches = m.get("fe_batches", 0.0)
        # demand-based duty estimate: total device-pipeline time the
        # measured passes dispatched / their wall time, one chip
        duty = (batches * ms_thr / 1000.0) / max(wall, 1e-9)
        chain_cps = m.get("chain_cells", 0.0) / max(
            batches * ms_thr / 1000.0, 1e-9
        )
        duty_line = (
            f"# device: {ms_thr:.1f}ms/batch pipelined "
            f"({ms_lat:.1f}ms blocking RTT), {batches:.0f} batches "
            f"dispatched -> duty~{100 * duty:.0f}% of the {wall:.2f}s "
            f"measured wall; chain-DP ~{chain_cps:.2e} cells/s "
            f"on-device\n"
        )
        if roof:
            # algorithmic work of one batch over its pipelined time
            # (no peak division: ROADMAP S1 brings a per-device peak
            # table)
            t_b = ms_thr / 1e3
            duty_line += (
                f"# work/batch (B={roof['B']} L={roof['L']} "
                f"M={roof['M']} A={roof['A']} W={roof['window']}): "
                f"{roof['int_ops']:.2e} int-ops, "
                f"{roof['hbm_bytes'] / 1e6:.0f}MB -> "
                f"{roof['int_ops'] / t_b:.2e} int-ops/s, "
                f"{roof['hbm_bytes'] / t_b / 1e9:.1f}GB/s\n"
            )
    n_cpu = os.cpu_count() or 4
    print(
        f"# baseline: {baseline.get('desc', '')} = {cpu_rps:.1f} reads/s "
        f"({baseline.get('date', '?')})\n"
        f"# vs_baseline uses the MEASURED same-host CPU aligner "
        f"({n_cpu} cores)\n"
        f"# accuracy: {n_correct}/{N_READS} within 100bp of truth; "
        f"mapped {n_hit}/{N_READS} reads in {dt:.2f}s "
        f"({READ_LEN}bp, {ERROR_RATE:.0%} err, {GENOME_LEN/1e6:.0f}Mbp ref)\n"
        f"# passes: {[round(p[0], 1) for p in passes]} (median "
        f"{median:.1f}, best {rps:.1f}); total wall "
        f"{time.time() - t_start:.1f}s\n"
        f"{duty_line}"
        f"# steady-state stage cpu-seconds over {n_procs} procs "
        f"(per-proc ~= /{n_procs}; measured wall {wall:.2f}s for "
        f"{len(passes) * N_READS} "
        f"reads): front_end={fe:.2f} extend={ext:.2f} "
        f"finalize={fin:.2f}; host dp_cells/s="
        f"{m.get('dp_cells_per_sec', 0):.3e}\n"
        f"# parent-process CPU during measurement: {parent_cpu:.2f}s "
        f"over {wall:.2f}s wall = {parent_cpu / max(wall, 1e-9):.2f} "
        f"cores (of {n_cpu}) spent on IPC deserialize + queues + "
        f"iterator",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
