"""Multi-host worker: one process of a distributed decision-step run.

Launched by tests/test_multihost.py as
``python tests/mh_worker.py <pid> <nproc> <n_local_devices> <out.npz>
<port>``.  Every process builds the same global inputs (the index of
tests/data/test.fa + its reads), joins the distributed runtime, runs the sharded
decision step over the GLOBAL (data, index) mesh, gathers the full
results, and process 0 writes them to ``out.npz``.  With nproc=1 this
doubles as the single-process oracle.
"""
import os
import sys

pid, nproc, n_local, out_path, port = (
    int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
    sys.argv[4], int(sys.argv[5]),
)
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={n_local}"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_platform_name", "cpu")

# must run BEFORE any import that can initialise the XLA backend
# (mappy_rs_tpu modules may touch jax at import time)
if nproc > 1:
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nproc, process_id=pid
    )

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mappy_rs_tpu.config import MapOptions  # noqa: E402
from mappy_rs_tpu.index.build import load_or_build  # noqa: E402
from mappy_rs_tpu.ops.chain import ChainParams  # noqa: E402
from mappy_rs_tpu.ops.extend import ExtendParams  # noqa: E402
from mappy_rs_tpu.parallel.mesh import (  # noqa: E402
    build_sharded_map_step,
    shard_index_by_key_range,
)
from mappy_rs_tpu.parallel.multihost import (  # noqa: E402
    P,
    gather_results,
    make_global_mesh,
    put_global,
    put_global_tree,
    shard_specs_for_index,
)
from mappy_rs_tpu.utils.seqcodes import encode, read_fastx  # noqa: E402

assert len(jax.devices()) == nproc * n_local

N_INDEX = 2
mesh = make_global_mesh(N_INDEX)

FA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "test.fa")
idx = load_or_build(FA)
opt = MapOptions()
idx.update_map_options(opt)
seqs = [s for _, s in read_fastx(FA)]
B, L = 8, 512
codes = np.full((B, L), 4, np.uint8)
lens = np.zeros(B, np.int32)
for i in range(B):
    s = encode(seqs[i % len(seqs)])
    codes[i, : len(s)] = s
    lens[i] = len(s)

cp = ChainParams(
    max_dist_x=opt.max_gap, max_dist_y=opt.max_gap, bw=opt.bw,
    q_span=idx.k, chn_pen_gap=opt.chain_gap_scale * 0.01 * idx.k,
    chn_pen_skip=0.0,
)
ep = ExtendParams(
    a=opt.a, b=opt.b, q=opt.q, e=opt.e, q2=opt.q2, e2=opt.e2,
    sc_ambi=opt.sc_ambi,
)
step = build_sharded_map_step(
    mesh, idx.k, idx.w, max_minimizers=64, max_anchors=128,
    chain_params=cp, ext_params=ep, mid_occ=opt.mid_occ,
    chain_window=16, ext_window=64,
)
shards_np = shard_index_by_key_range(idx, N_INDEX)
codes_d = put_global(codes, mesh, P("data", None))
lens_d = put_global(lens, mesh, P("data"))
shards = put_global_tree(shards_np, mesh, shard_specs_for_index())

out = step(codes_d, lens_d, shards)
jax.block_until_ready(out)
res = gather_results(out)
if pid == 0:
    np.savez(out_path, **res)
print(f"[worker {pid}/{nproc}] ok", flush=True)
