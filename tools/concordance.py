"""Cross-engine concordance sweep: device vs CPU front end per preset.

The two front ends share no code or algorithmic structure (JAX
mask-formulated sketch + hash-probe lookup + block max-plus chain vs
scalar C++ rolling sketch + lower_bound + mm_chain_dp), so
full-hit-tuple agreement on a realistic workload is the in-environment
substitute for a mappy oracle (the image is sealed; no external
minimap2 exists).  See tests/test_concordance.py for the rationale,
and CONCORDANCE.md for published numbers (regenerate with
``python tools/concordance.py``).

Preset notes:
  - asm5 is swept WITHOUT MM_F_RMQ: RMQ long-gap chaining routes both
    aligners through the native front end (pipeline.map_batch), which
    would make the comparison self-vs-self.  RMQ behavior has its own
    oracle tests (tests/test_rmq_chain.py).
  - splice runs on genomic (exon-only) reads here; intron handling has
    dedicated oracle tests (tests/test_splice.py).
"""
from __future__ import annotations

import numpy as np

#: preset -> (read lengths, error rates) matched to the preset's regime
PRESET_WORKLOADS = {
    "map-ont": ([420, 800, 1500], [0.0, 0.03, 0.08]),
    "map-hifi": ([800, 1500], [0.0, 0.01]),
    "sr": ([150, 250], [0.0, 0.01]),
    "asm5": ([800, 1500], [0.0, 0.02]),
    "splice": ([420, 800], [0.0, 0.03]),
}


def mixed_genome(rng, size=150_000, repeats=8):
    """Genome with an interspersed ~3%-diverged 1.2kb repeat family so
    some reads are repeat-dense — the hardest mapq/chain regime."""
    base = rng.choice(list("ACGT"), size=size)
    unit = rng.choice(list("ACGT"), size=1200)
    for c in range(repeats):
        start = 12_000 + c * ((size - 24_000) // max(repeats, 1))
        copy = unit.copy()
        muts = rng.integers(0, 1200, size=36)
        copy[muts] = [rng.choice(list("ACGT")) for _ in muts]
        base[start : start + 1200] = copy
    return "".join(base)


def simulate(rng, genome, n, lengths, errs):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = []
    for _ in range(n):
        length = int(rng.choice(lengths))
        err = float(rng.choice(errs))
        start = int(rng.integers(0, len(genome) - length))
        s = []
        j = start
        while j < start + length:
            r = rng.random()
            if r < err * 0.6:
                s.append(rng.choice([c for c in "ACGT" if c != genome[j]]))
                j += 1
            elif r < err * 0.8:
                s.append(genome[j])
                s.append(str(rng.choice(list("ACGT"))))
                j += 1
            elif r < err:
                j += 2
            else:
                s.append(genome[j])
                j += 1
        read = "".join(s)
        if rng.random() < 0.5:
            read = "".join(comp[c] for c in reversed(read))
        reads.append(read)
    return reads


def _tuples(regs, idx):
    from mappy_rs_tpu.ops.cigar import unpack_ops

    return [
        (r.rid, r.rs, r.re, r.qs, r.qe, r.rev, idx.seq_names[r.rid],
         tuple(map(tuple, unpack_ops(r.cigar)))
         if r.cigar is not None else (),
         r.nm, r.mapq, r.parent == r.id)
        for r in regs
    ]


def run_preset(preset: str, n_reads: int, seed: int = 21):
    """Map n_reads through both front ends; returns a stats dict."""
    import mappy_rs_tpu

    rng = np.random.default_rng(seed)
    genome = mixed_genome(rng)
    lengths, errs = PRESET_WORKLOADS[preset]
    reads = simulate(rng, genome, n_reads, lengths, errs)

    def make(backend):
        al = mappy_rs_tpu.Aligner(seq=genome, preset=preset)
        al._engine.cfg.front_end_backend = backend
        al._engine.cfg.extension_backend = "host"
        if preset == "asm5":
            from mappy_rs_tpu.config import MM_F_RMQ

            al._engine.opt.flag &= ~MM_F_RMQ  # see module docstring
        return al

    al_dev, al_cpu = make("device"), make("cpu")
    idx = al_dev._engine.index
    out_dev = al_dev._engine.map_batch(reads)
    out_cpu = al_cpu._engine.map_batch(reads)
    return {"preset": preset, **compare(out_dev, out_cpu, idx)}


def compare(out_dev, out_cpu, idx, max_diffs: int = 5) -> dict:
    """Full-hit-tuple agreement between two per-read Region lists of
    the same reads: counts of reads both sides map, reads only one
    side maps, equal primary coordinates (rid, r_st, r_en, q_st, q_en,
    strand) and equal full tuple lists; the first `max_diffs`
    differing reads as (read index, first tuple A, first tuple B)."""
    full = coords = both = only_one = 0
    diffs = []
    for i, (rd, rc) in enumerate(zip(out_dev, out_cpu)):
        td, tc = _tuples(rd, idx), _tuples(rc, idx)
        if not td and not tc:
            continue
        if bool(td) != bool(tc):
            only_one += 1
            diffs.append((i, td[:1], tc[:1]))
            continue
        both += 1
        if td[0][:6] == tc[0][:6]:
            coords += 1
        if td == tc:
            full += 1
        else:
            diffs.append((i, td[:1], tc[:1]))
    return {
        "n_reads": len(out_dev),
        "both_mapped": both,
        "one_side_only": only_one,
        "full": full,
        "coords": coords,
        "full_pct": 100.0 * full / max(both, 1),
        "coords_pct": 100.0 * coords / max(both, 1),
        "n_diffs": len(diffs),
        "diffs": diffs[:max_diffs],
    }


def main():
    import io
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    buf = io.StringIO()
    buf.write(
        "# CONCORDANCE — device vs CPU front end, full hit tuples\n\n"
        "Two independently implemented aligner paths (JAX device"
        " front end vs\nscalar C++ native front end) mapped the same"
        " reads; a hit tuple is\n(ctg, r_st, r_en, q_st, q_en, strand,"
        " CIGAR, NM, mapq, primary).\nWorkload: 150kb genome with an"
        " 8-copy ~3%-diverged 1.2kb repeat family;\nread lengths/error"
        " rates per preset as in tools/concordance.py.\nBar"
        " (BASELINE.json): >=95% full-tuple concordance per preset at"
        f" N>={n}.\nRegenerate: `python tools/concordance.py {n}`.\n\n"
        "| preset | N | both mapped | one side only | coords eq | "
        "full tuple eq |\n|---|---|---|---|---|---|\n"
    )
    for preset in PRESET_WORKLOADS:
        s = run_preset(preset, n)
        buf.write(
            f"| {s['preset']} | {s['n_reads']} | {s['both_mapped']} | "
            f"{s['one_side_only']} | {s['coords']} "
            f"({s['coords_pct']:.1f}%) | {s['full']} "
            f"({s['full_pct']:.1f}%) |\n"
        )
        print(
            f"{preset}: full {s['full']}/{s['both_mapped']} "
            f"({s['full_pct']:.2f}%), coords {s['coords_pct']:.2f}%, "
            f"one-side {s['one_side_only']}",
            flush=True,
        )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "CONCORDANCE.md"), "w") as fh:
        fh.write(buf.getvalue())
    print("wrote CONCORDANCE.md")


if __name__ == "__main__":
    import os as _os
    import sys as _sys

    _sys.path.insert(
        0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_platform_name", "cpu")
    main()
