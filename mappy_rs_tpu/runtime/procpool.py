"""Multi-process CPU mapping workers: one full CPU pipeline per child.

Why processes: the per-read host glue (regions, job build, finalize
bookkeeping) is Python and therefore GIL-serialized, which caps ANY
number of threads.  A child process has its own GIL, so N children
scale the host glue with the host cores.

This runtime serves the CPU front end (``front_end_backend="cpu"``,
native/front_end.cc), the reference-style CPU aligner and the bench's
CPU baseline.  Its children never use an accelerator: each pins JAX to
the CPU platform before anything else.  The device front end uses
runtime/devowner.py instead, where the parent owns the only device
client.

Topology: the parent's WorkerPool threads become thin proxies — each
drains reads from the shared bounded work queue (contract unchanged:
capacities, back-off, Done pills) and round-trips one chunk to a
child over a pipe.  Requests carry ids and a per-child reader thread
dispatches replies, so SEVERAL proxies can keep chunks in flight to
the same child — the child's pipe acts as a depth-2 prefetch buffer
and its map loop runs back-to-back.  Children run the unmodified
AlignmentEngine, so a read's result is bit-identical to the
single-process path no matter which child maps it.

The reference's analogue is threads sharing one C index
(/root/reference/src/lib.rs:545); the cross-process index share is
index/share.py (mmap'd pages, one physical copy).
"""
from __future__ import annotations

import atexit
import contextlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List

#: environment every worker child starts with.  JAX_PLATFORMS=cpu keeps
#: the child off the accelerator from its first import on (importing
#: the package creates JAX constants, which initializes a backend —
#: and a second JAX process on the card fails for want of memory).
#: PYTHONHASHSEED=0: hash randomization changes trace-time iteration
#: order in the jitted graphs, so each process would produce different
#: HLO for the same graph and miss the persistent compile cache.
CHILD_ENV = {"JAX_PLATFORMS": "cpu", "PYTHONHASHSEED": "0"}


@contextlib.contextmanager
def child_env():
    """Set CHILD_ENV in os.environ while children are spawned (a
    spawned child copies the parent's environment at start)."""
    saved = {k: os.environ.get(k) for k in CHILD_ENV}
    os.environ.update(CHILD_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _child_main(conn, idx_dir: str, map_opt, cfg) -> None:
    """Entry point of a spawned worker process."""
    try:
        import numpy as np

        from ..config import MM_F_NO_PRINT_2ND
        from ..index.share import load_index_dir
        from ..models.pipeline import AlignmentEngine

        index = load_index_dir(idx_dir)
        eng = AlignmentEngine(index, map_opt, cfg)
        no_2nd = bool(map_opt.flag & MM_F_NO_PRINT_2ND)
        conn.send(("ready", -1, child_info()))
        while True:
            msg = conn.recv()
            if msg is None:
                conn.send(("bye", -1, eng.metrics.snapshot()))
                return
            kind, rid = msg[0], msg[1]
            if kind == "metrics":
                conn.send(("metrics", rid, eng.metrics.snapshot()))
                continue
            if kind == "metrics_reset":
                # steady-state separation: the bench resets after
                # warmup so reported stage times exclude one-time costs
                eng.metrics.reset()
                conn.send(("metrics", rid, {}))
                continue
            seqs, cs, md = msg[2], msg[3], msg[4]
            try:
                key_ix: Dict[str, int] = {}
                for s in seqs:
                    if s not in key_ix:
                        key_ix[s] = len(key_ix)
                keys = list(key_ix)
                # direct-to-wire: fast-path reads go from post_chain.cc
                # arrays straight into the block (no Region objects)
                block = eng.map_batch_packed(keys, cs=cs, md=md,
                                             no_2nd=no_2nd)
                order = (
                    np.fromiter(
                        (key_ix[s] for s in seqs), np.int32, len(seqs)
                    )
                    if len(keys) != len(seqs) else None
                )
                conn.send(("okp", rid, (order, block)))
            except Exception as exc:  # noqa: BLE001 — surface to parent
                conn.send(("error", rid, repr(exc)))
    except (EOFError, KeyboardInterrupt):
        pass
    except Exception as exc:  # noqa: BLE001 — init failure: tell parent
        try:
            conn.send(("error", -1, repr(exc)))
        except Exception:  # noqa: BLE001
            pass


def child_info() -> dict:
    """What a child reports when it is ready: its pid and the JAX
    platform it runs on (always "cpu" for both runtimes' children)."""
    import jax

    return {"pid": os.getpid(), "platform": jax.default_backend()}


class _Child:
    """Parent-side handle: pipe + send lock + reply dispatcher."""

    def __init__(self, proc, conn) -> None:
        self.proc = proc
        self.conn = conn
        self.send_lock = threading.Lock()
        self.pending: Dict[int, "queue.SimpleQueue"] = {}
        self.pending_lock = threading.Lock()
        self.ready_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.bye = threading.Event()
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()

    def _read_loop(self) -> None:
        while True:
            try:
                kind, rid, payload = self.conn.recv()
            except (EOFError, OSError):
                break
            if kind == "ready":
                self.ready_q.put(payload)
                continue
            if kind == "bye":
                self.ready_q.put(payload)  # metrics snapshot
                self.bye.set()
                break
            if rid == -1:  # init-time failure
                self.ready_q.put(RuntimeError(str(payload)))
                continue
            with self.pending_lock:
                waiter = self.pending.pop(rid, None)
            if waiter is not None:
                waiter.put((kind, payload))
        # child gone: fail everything still in flight
        with self.pending_lock:
            waiters = list(self.pending.values())
            self.pending.clear()
        for w in waiters:
            w.put(("error", "worker process exited"))

    def request(self, rid: int, msg) -> tuple:
        waiter: "queue.SimpleQueue" = queue.SimpleQueue()
        with self.pending_lock:
            self.pending[rid] = waiter
        try:
            with self.send_lock:
                self.conn.send(msg)
        except (OSError, ValueError) as exc:
            with self.pending_lock:
                self.pending.pop(rid, None)
            return ("error", f"send failed: {exc!r}")
        return waiter.get()


class ProcMapper:
    """Owns N child CPU-pipeline processes and hands out per-proxy
    map_fns."""

    def __init__(self, n_procs: int, index, map_opt, cfg) -> None:
        from ..index.share import save_index_dir

        if cfg.front_end_backend != "cpu":
            raise ValueError(
                "ProcMapper serves the CPU front end; the device front "
                "end uses runtime/devowner.py"
            )
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="mappy_rs_tpu_idx_")
        save_index_dir(index, self._tmp)
        self._seq_names = list(index.seq_names)
        self._seq_lens = index.seq_lens
        # children: no nested process pools
        child_cfg = cfg.replace(worker_processes=0, single_batch_shape=True)
        self.n_procs = n_procs
        self._children: List[_Child] = []
        self.child_info: List[dict] = []
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._closed = False
        with child_env():
            for _ in range(n_procs):
                parent_c, child_c = ctx.Pipe()
                p = ctx.Process(
                    target=_child_main,
                    args=(child_c, self._tmp, map_opt, child_cfg),
                    daemon=True,
                )
                p.start()
                child_c.close()
                self._children.append(_Child(p, parent_c))
        atexit.register(self.shutdown)

    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def wait_ready(self, timeout: float = 300.0) -> None:
        """Block until every child finished engine construction."""
        self.child_info = wait_children(self._children, timeout)

    def map_fn(self, i: int) -> Callable:
        """A WorkerPool map_fn that round-trips chunks to child
        i % n_procs.  Several proxies may target one child — requests
        interleave on the pipe and the child maps them back-to-back."""
        child = self._children[i % self.n_procs]
        names, lens_ = self._seq_names, self._seq_lens

        def fn(seqs, cs: bool = True, md: bool = False):
            from .pack import unpack_mappings_block

            rid = self._next_rid()
            kind, payload = child.request(
                rid, ("map", rid, seqs, cs, md)
            )
            if kind != "okp":
                raise RuntimeError(f"worker process failed: {payload}")
            order, block = payload
            tables = unpack_mappings_block(block, names, lens_)
            if order is None:
                return tables
            return [tables[k] for k in order.tolist()]

        return fn

    def warmup(self, seqs: List[str]) -> None:
        """Warm every child's one-time costs (mmap'd index pages,
        native lib) up front.  The shared work queue alone cannot
        guarantee this: one fast child can drain the whole warm batch
        while the others stay cold."""
        threads = []
        for i in range(self.n_procs):
            fn = self.map_fn(i)
            t = threading.Thread(target=lambda f=fn: f(seqs), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    def reset_metrics(self) -> None:
        for child in self._children:
            try:
                rid = self._next_rid()
                child.request(rid, ("metrics_reset", rid))
            except Exception:  # noqa: BLE001 — child gone
                continue

    def metrics(self) -> List[dict]:
        out = []
        for child in self._children:
            try:
                rid = self._next_rid()
                kind, snap = child.request(rid, ("metrics", rid))
                if kind == "metrics":
                    out.append(snap)
            except Exception:  # noqa: BLE001 — child gone
                continue
        return out

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for child in self._children:
            try:
                with child.send_lock:
                    child.conn.send(None)
                child.bye.wait(timeout=5.0)
                child.conn.close()
            except Exception:  # noqa: BLE001
                pass
            child.proc.join(timeout=5.0)
            if child.proc.is_alive():
                child.proc.terminate()
        shutil.rmtree(self._tmp, ignore_errors=True)


def wait_children(children: List["_Child"], timeout: float) -> List[dict]:
    """Wait for every child's "ready"; returns their child_info dicts.
    Raises RuntimeError naming the first child that failed to start,
    exited, or was not ready within `timeout` seconds."""
    deadline = time.monotonic() + timeout
    infos = []
    for i, child in enumerate(children):
        while True:
            try:
                got = child.ready_q.get(timeout=1.0)
                break
            except queue.Empty:
                if not child.proc.is_alive():
                    raise RuntimeError(
                        f"worker process {i} failed to start: exited "
                        f"with code {child.proc.exitcode}"
                    ) from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"worker process {i} not ready after "
                        f"{timeout:.0f}s"
                    ) from None
        if isinstance(got, Exception):
            raise RuntimeError(f"worker process {i} failed to start: {got}")
        infos.append(got)
    return infos
