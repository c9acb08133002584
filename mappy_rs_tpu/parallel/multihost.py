"""Multi-host execution: distributed init, global meshes, data placement.

The reference's only parallelism is one process with n OS threads
(SURVEY.md §2c); it has no multi-host story.  This build's sharded
decision step (parallel/mesh.py build_sharded_map_step) is
multi-host-ready by LAYOUT: the only cross-device collectives (anchor
all_gather + the extension pmax) ride the "index" mesh axis, so
packing "index" inside each host keeps every collective on the
host's own links (NVLink) and the network between hosts carries zero
aligner traffic.  This module supplies the process
plumbing around that design:

  init_distributed()  — jax.distributed bring-up (one call per process)
  make_global_mesh()  — the (data, index) mesh over ALL processes'
                        devices with "index" packed within each host
  put_global()        — build a global jax.Array from per-process host
                        data (each process contributes the shards its
                        devices own; replicated specs just pass the
                        full array)
  gather_results()    — full result pytree on every process

Actually EXECUTED multi-process in tests/test_multihost.py: two OS
processes x 4 CPU devices over the Gloo fabric run the sharded
decision step and must produce bitwise-identical results to a single
8-device process.  On GPU hosts the same code paths ride NVLink
within a host and the network between hosts; nothing here is
CPU-specific.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import numpy as np

from .mesh import make_mesh

P = jax.sharding.PartitionSpec


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[list] = None,
) -> None:
    """Join the multi-process runtime (call ONCE, before first backend
    use; on CPU simulation set XLA_FLAGS=--xla_force_host_platform_
    device_count=N and the cpu platform first)."""
    if num_processes <= 1:
        return  # single-process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def make_global_mesh(n_index: int = 1) -> jax.sharding.Mesh:
    """(data, index) mesh over every device of every process.

    "index" must divide the per-process device count so each index
    group stays inside one host (the host-local layout rule from
    parallel/mesh.make_mesh); "data" then spans hosts.
    """
    n_local = len(jax.local_devices())
    n_total = len(jax.devices())
    if n_index > 1 and n_local % n_index != 0:
        raise ValueError(
            f"n_index={n_index} must divide the per-host device count "
            f"{n_local} so index-axis collectives stay inside a host"
        )
    return make_mesh(n_total // n_index, n_index)


def put_global(
    arr: np.ndarray, mesh: jax.sharding.Mesh, spec: P
) -> jax.Array:
    """Global jax.Array from host data, multi-process safe.

    Each process calls this with ITS view of the array (all processes
    must agree on the global shape).  The callback hands each local
    device exactly the block it owns, so a process only ever touches
    the slices its devices address — with a fully-loaded host array
    this is a pure slice; a production loader can equally serve only
    the local rows.
    """
    sharding = jax.sharding.NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def put_global_tree(
    arrays: Dict[str, np.ndarray],
    mesh: jax.sharding.Mesh,
    specs: Dict[str, P],
) -> Dict[str, jax.Array]:
    return {k: put_global(v, mesh, specs[k]) for k, v in arrays.items()}


def gather_results(tree: Any) -> Any:
    """Fetch a pytree of global (possibly non-addressable) arrays as
    complete numpy arrays on EVERY process."""
    if jax.process_count() == 1:
        return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)
    from jax.experimental import multihost_utils

    return jax.tree.map(
        np.asarray, multihost_utils.process_allgather(tree, tiled=True)
    )


def shard_specs_for_index() -> Dict[str, P]:
    """PartitionSpecs for shard_index_by_key_range's output arrays
    (matches build_sharded_map_step's in_specs)."""
    return {
        "key_hi": P("index", None),
        "key_lo": P("index", None),
        "offcnt": P("index", None, None),
        "n_keys": P("index"),
        "pos_rp": P("index", None, None),
        "ref_blocks": P("index", None),
        "rid2shard": P(),
        "loc_off": P(),
    }
