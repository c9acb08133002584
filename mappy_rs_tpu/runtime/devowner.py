"""Device-owner topology: ONE device front-end pipeline (in the parent
process), N jax-free post-chain worker processes.

Why: a JAX process reserves most of the accelerator's memory when it
first touches it, so a second process that opens the same card fails.
Here the PARENT owns the only device client: proxy threads submit
front-end batches through the shared engine (its jit caches and
metrics are thread-safe), collect compact chains, and hand the
device-independent tail — extension, finalize, cs/MD, wire-format
packing — to child processes pinned to the CPU platform.  One index
upload, one compile, one deep dispatch queue; the children spawn in
about a second and scale the post-chain C++ across cores.

The mapped results are bit-identical to the single-process path: the
children run the same AlignmentEngine.post_chain_packed over the same
compact chains the single-process path produces
(tests/test_devowner.py).

Reference analogue: threads sharing one C index
(/root/reference/src/lib.rs:545) — this is the process-scaled version
with the index shared through BOTH the device (one device copy) and
the host (mmap'd pages, index/share.py).
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import queue
import shutil
import tempfile
import threading
from typing import Callable, Dict, List

import numpy as np

from .procpool import _Child, child_env, child_info, wait_children


def _worker_main(conn, idx_dir: str, map_opt, cfg) -> None:
    """Post-chain worker process: compact chains in, packed wire
    blocks out.  Never opens the accelerator (started with
    JAX_PLATFORMS=cpu, procpool.CHILD_ENV; no device code runs here)."""
    try:
        from ..index.share import load_index_dir
        from ..models.pipeline import AlignmentEngine

        index = load_index_dir(idx_dir)
        eng = AlignmentEngine(index, map_opt, cfg)
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
                eng.metrics.reset()
                conn.send(("metrics", rid, {}))
                continue
            try:
                blob, off, chains, rep_len, cs, md, no_2nd = msg[2:]
                codes = [
                    blob[off[i]: off[i + 1]] for i in range(len(off) - 1)
                ]
                block = eng.post_chain_packed(
                    codes, chains, rep_len, cs=cs, md=md, no_2nd=no_2nd
                )
                conn.send(("okp", rid, block))
            except Exception as exc:  # noqa: BLE001 — surface to parent
                conn.send(("error", rid, repr(exc)))
    except (EOFError, KeyboardInterrupt):
        pass
    except Exception as exc:  # noqa: BLE001 — init failure: tell parent
        try:
            conn.send(("error", -1, repr(exc)))
        except Exception:  # noqa: BLE001
            pass


class DevOwnerMapper:
    """ProcMapper-shaped handle for the device-owner topology."""

    #: anchor-budget escalation ladder (matches _map_bucket's
    #: a_boost * 4 recursion capped at 16)
    _BOOSTS = (1, 4, 16)

    def __init__(self, n_procs: int, engine, index, map_opt, cfg) -> None:
        from ..config import MM_F_NO_PRINT_2ND
        from ..index.share import save_index_dir

        self.engine = engine
        # one compiled batch shape.  Mutate in place (restored on
        # shutdown): the engine and the Aligner share this config
        # object, and replacing it would detach the engine from later
        # config tuning.
        self._saved_sbs = engine.cfg.single_batch_shape
        engine.cfg.single_batch_shape = True
        self._no_2nd_default = bool(map_opt.flag & MM_F_NO_PRINT_2ND)
        self._seq_names = list(index.seq_names)
        self._seq_lens = index.seq_lens
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="mappy_rs_tpu_idx_")
        save_index_dir(index, self._tmp)
        child_cfg = cfg.replace(
            worker_processes=0,
            single_batch_shape=True,
            front_end_backend="cpu",
            extension_backend="host",
        )
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
                    target=_worker_main,
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
        """Block until every child is ready; child_info then holds
        each child's pid and JAX platform."""
        self.child_info = wait_children(self._children, timeout)

    # -- the front-end + post-chain round trip --------------------------
    def _front_end_chunk(self, codes: List[np.ndarray]):
        """Whole-chunk device front end in the parent: bucket, submit
        every batch (pipelined on the device), collect, retry
        anchor-overflow reads with boosted budgets.  Returns
        (chains [n, K, W], rep_len [n]) in chunk order."""
        eng = self.engine
        n = len(codes)
        if n == 0:
            return (np.full((0, eng.cfg.backtrack_k, 9), -1, np.int32),
                    np.zeros(0, np.int32))
        buckets: Dict[int, List[int]] = {}
        for i, c in enumerate(codes):
            buckets.setdefault(eng._bucket_len(len(c)), []).append(i)
        # row width varies per bucket (bt_cuts is L-dependent): pad
        # rows to the chunk max with -1 (unused cut slots are -1
        # already — regions_from_compact / post_chain.cc skip them)
        seg = eng.SEG_LEN
        W = max(9 + 2 * min(8, L // seg) for L in buckets)
        K = eng.cfg.backtrack_k
        chains = np.full((n, K, W), -1, np.int32)
        rep_len = np.zeros(n, np.int32)
        retry: Dict[int, List[int]] = {
            L: idxs for L, idxs in buckets.items()
        }
        for boost in self._BOOSTS:
            pend = []
            for L, idxs in retry.items():
                if not idxs:
                    continue
                if boost > 1:
                    eng.metrics.add("anchor_overflow_retries", len(idxs))
                B, _M, A = eng.fe_shapes(L, a_boost=boost)
                for s in range(0, len(idxs), B):
                    sel = np.asarray(idxs[s: s + B])
                    pend.append((
                        sel, L, A,
                        eng.fe_submit(
                            [codes[i] for i in sel], L, a_boost=boost
                        ),
                    ))
            if not pend:
                break
            nxt: Dict[int, List[int]] = {}
            for sel, L, A, ticket in pend:
                ch, rl, n_raw = eng.fe_collect(ticket)
                chains[sel, :, : ch.shape[-1]] = ch
                rep_len[sel] = rl
                if boost < self._BOOSTS[-1]:
                    ov = sel[np.asarray(n_raw) > A]
                    if len(ov):
                        nxt.setdefault(L, []).extend(ov.tolist())
            retry = nxt
        return chains, rep_len

    def map_fn(self, i: int) -> Callable:
        """A WorkerPool map_fn: parent-side device front end, then one
        post-chain round trip to child i % n_procs."""
        from ..utils.seqcodes import encode
        from .pack import unpack_mappings_block

        child = self._children[i % self.n_procs]
        names, lens_ = self._seq_names, self._seq_lens
        no_2nd = self._no_2nd_default

        def fn(seqs, cs: bool = True, md: bool = False):
            key_ix: Dict[str, int] = {}
            for s in seqs:
                if s not in key_ix:
                    key_ix[s] = len(key_ix)
            codes = [encode(s) for s in key_ix]
            chains, rep_len = self._front_end_chunk(codes)
            off = np.zeros(len(codes) + 1, np.int64)
            for j, c in enumerate(codes):
                off[j + 1] = off[j] + len(c)
            blob = (
                np.concatenate(codes) if len(codes)
                else np.empty(0, np.uint8)
            )
            rid = self._next_rid()
            kind, payload = child.request(
                rid,
                ("post", rid, blob, off, chains, rep_len, cs, md, no_2nd),
            )
            if kind != "okp":
                raise RuntimeError(f"worker process failed: {payload}")
            tables = unpack_mappings_block(payload, names, lens_)
            if len(key_ix) == len(seqs):
                return tables
            return [tables[key_ix[s]] for s in seqs]

        return fn

    def warmup(self, seqs: List[str]) -> None:
        """One-time costs up front: the PARENT pays device index upload
        + compile (once, not once per child); each child then warms its
        native lib + mmap'd index pages.  Child 0 first (builds the
        native lib if needed), the rest concurrently."""
        if not seqs:
            return
        try:
            self.map_fn(0)(list(seqs))
        except Exception:  # noqa: BLE001 — warmup is best-effort
            pass
        threads = []
        for i in range(1, self.n_procs):
            fn = self.map_fn(i)
            t = threading.Thread(
                target=lambda f=fn: f(list(seqs)), daemon=True
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join()

    # -- observability ---------------------------------------------------
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
        try:
            self.engine.cfg.single_batch_shape = self._saved_sbs
        except Exception:  # noqa: BLE001
            pass
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
