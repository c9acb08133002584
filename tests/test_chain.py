"""Chain DP: block max-plus formulation vs reference scan formulation."""
import numpy as np

from mappy_rs_tpu.config import MapOptions
from mappy_rs_tpu.index.build import load_or_build
from mappy_rs_tpu.ops.chain import ChainParams, chain_scores, chain_scores_block
from mappy_rs_tpu.ops.lookup import collect_anchors_dev
from mappy_rs_tpu.ops.sketch import sketch_compact
from mappy_rs_tpu.utils.seqcodes import encode, read_fastx

def test_block_chain_equals_scan_chain(test_mmi, test_fa):
    import jax.numpy as jnp

    idx = load_or_build(test_mmi)
    opt = MapOptions()
    idx.update_map_options(opt)
    dev = idx.device
    rng = np.random.default_rng(1)
    reads = []
    for _, s in read_fastx(test_fa):
        reads.append(s)
        m = list(s)
        for p_ in rng.choice(390, 25, replace=False):
            m[p_] = "ACGT"[("ACGT".index(m[p_]) + 1) % 4]
        reads.append("".join(m))
        reads.append(s[:150] + s[200:350])
    B, L = 16, 512
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, r in enumerate(reads[:B]):
        c = encode(r)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    mins = sketch_compact(jnp.asarray(codes), jnp.asarray(lens), 15, 10, 102)
    anchors = collect_anchors_dev(
        dev, mins, jnp.asarray(lens), opt.mid_occ, 256, 15,
    )
    cp = ChainParams(5000, 5000, 500, 15, 0.12, 0.0)
    f1, p1 = map(np.asarray, chain_scores(anchors, cp, 64))
    f2, p2 = map(np.asarray, chain_scores_block(anchors, cp, 32))
    valid = np.asarray(anchors["valid"])
    assert np.array_equal(np.where(valid, f1, 0), np.where(valid, f2, 0))
    assert np.array_equal(np.where(valid, p1, 0), np.where(valid, p2, 0))
