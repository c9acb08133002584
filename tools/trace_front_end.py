#!/usr/bin/env python
"""Reduce a jax.profiler trace to per-stage device time.

The front end labels its stages with ``jax.named_scope`` (sketch,
lookup, chain; models/pipeline.py) and the host download with a
``TraceAnnotation`` ("fetch").  A GPU kernel event carries its scope
path as the ``tf_op`` stat; failing that, the scope comes from the
``op_name`` metadata of the HLO instruction it ran (``hlo_op``, in
module ``hlo_module``) in the compiled module's HLO text
(``compiled.as_text()``).

    scopes = {}
    add_module_scopes(scopes, compiled.as_text())
    summary = reduce_trace(xplane_path, scopes, window="stream_window")

Device events are the ones on ``/device:`` planes; a CPU-only trace
has none, and then every event with an ``hlo_op`` stat counts (which
lets the reduction be checked without a GPU).  Busy time is the union
of device event intervals inside the host span named `window`.

Usage: python tools/trace_front_end.py TRACE_DIR  (prints the summary
of the newest trace under TRACE_DIR, with module totals only).
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

SCOPES = ("sketch", "lookup", "chain")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def _scope_of(op_name: str) -> Optional[str]:
    parts = op_name.split("/")
    for s in SCOPES:
        if s in parts:
            return s
    return None


def add_module_scopes(table: Dict[str, Dict[str, str]], hlo_text: str):
    """Add {instruction: scope} for one compiled module's HLO text to
    `table` under the module's name; returns that name.  A fusion
    without a scoped op_name of its own takes the first scope found
    in the computations it calls."""
    lines = hlo_text.splitlines()
    module = lines[0].split()[1].rstrip(",") if lines else "?"
    comp_scopes: Dict[str, List[str]] = {}
    instrs: List[Tuple[str, Optional[str], List[str]]] = []
    comp = None
    for ln in lines[1:]:
        m = _COMP.match(ln)
        if m and "=" not in ln.split("{")[0]:
            comp = m.group(1)
            comp_scopes.setdefault(comp, [])
            continue
        mi = _INSTR.match(ln)
        if not mi:
            continue
        mo = _OPNAME.search(ln)
        sc = _scope_of(mo.group(1)) if mo else None
        if comp is not None and sc:
            comp_scopes[comp].append(sc)
        instrs.append((mi.group(1), sc, _CALLS.findall(ln)))
    out = table.setdefault(module, {})
    for name, sc, calls in instrs:
        if sc is None:
            for c in calls:
                if comp_scopes.get(c):
                    sc = comp_scopes[c][0]
                    break
        if sc is not None:
            out[name] = sc
    return module


def _stats(ev) -> dict:
    return {k: v for k, v in ev.stats}


def _union(intervals: Iterable[Tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def reduce_trace(
    xplane_path: str,
    scopes: Dict[str, Dict[str, str]],
    window: Optional[str] = None,
) -> dict:
    """Per-stage device ns, copy ns, device busy/idle share and host
    span totals of one trace (see the module docstring)."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    planes = list(pd.planes)
    dev_planes = [p for p in planes if p.name.startswith("/device:")]
    host_spans: Dict[str, List[Tuple[int, int]]] = {}
    dev_events = []
    for plane in planes:
        is_dev = plane in dev_planes
        for line in plane.lines:
            for ev in line.events:
                t0 = int(ev.start_ns)
                t1 = t0 + int(ev.duration_ns)
                st = _stats(ev)
                if is_dev or (not dev_planes and "hlo_op" in st):
                    dev_events.append((ev.name, t0, t1, st))
                elif not is_dev:
                    host_spans.setdefault(ev.name, []).append((t0, t1))
    w0, w1 = None, None
    if window and host_spans.get(window):
        w0 = min(a for a, _ in host_spans[window])
        w1 = max(b for _, b in host_spans[window])
    by_scope: Dict[str, int] = {}
    by_module: Dict[str, int] = {}
    copies: Dict[str, int] = {}
    unmatched: Dict[str, int] = {}
    stat_keys: set = set()
    n_window = 0
    busy = []
    for name, t0, t1, st in dev_events:
        if w0 is not None and (t1 <= w0 or t0 >= w1):
            continue
        d = t1 - t0
        n_window += 1
        stat_keys.update(st)
        op, mod = st.get("hlo_op"), st.get("hlo_module")
        if op is None:
            if "memcpy" in name.lower():
                key = "d2h" if "d2h" in name.lower() else (
                    "h2d" if "h2d" in name.lower() else "other")
                copies[key] = copies.get(key, 0) + d
                busy.append((t0, t1))
            continue
        busy.append((t0, t1))
        mod = str(mod)
        by_module[mod] = by_module.get(mod, 0) + d
        # the op's scope path, where the profiler records it (GPU
        # kernels carry it as "tf_op"); else the instruction's HLO
        # metadata.  Kernels replayed from a CUDA graph report
        # hlo_op "command_buffer" and their fusion as the event name
        # ("input_reduce_fusion_23" for input_reduce_fusion.23).
        sc = _scope_of(str(st.get("tf_op", "")))
        if sc is None:
            table = scopes.get(mod, {})
            sc = table.get(str(op)) or table.get(
                re.sub(r"_(\d+)$", r".\1", name))
        if sc is None and mod in scopes:
            sc = "front_end_other"
            unmatched[f"{op} | {name}"] = unmatched.get(
                f"{op} | {name}", 0) + d
        if sc is not None:
            by_scope[sc] = by_scope.get(sc, 0) + d
    span = (w1 - w0) if w0 is not None else (
        (max(b for _, b in busy) - min(a for a, _ in busy)) if busy else 0)
    busy_ns = _union(
        (max(a, w0), min(b, w1)) if w0 is not None else (a, b)
        for a, b in busy
    )
    host = {
        k: sum(b - a for a, b in v) for k, v in host_spans.items()
        if k in ("fetch", window)
    }
    return {
        "window_ns": span,
        "device_busy_ns": busy_ns,
        "device_idle_share": (1.0 - busy_ns / span) if span else None,
        "device_ns_by_scope": by_scope,
        "device_ns_by_module": by_module,
        "copy_ns": copies,
        "host_span_ns": host,
        "n_device_events": n_window,
        "device_planes": [p.name for p in dev_planes],
        "device_stat_keys": sorted(stat_keys),
        # the costliest device ops no scope claimed: "hlo_op | event"
        "top_unmatched_ns": dict(sorted(
            unmatched.items(), key=lambda kv: -kv[1])[:12]),
    }


def newest_xplane(logdir: str) -> str:
    paths = sorted(glob.glob(
        os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")
    ))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return paths[-1]


def main() -> None:
    print(json.dumps(reduce_trace(newest_xplane(sys.argv[1]), {}), indent=1))


if __name__ == "__main__":
    main()
