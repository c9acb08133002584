#!/usr/bin/env python
"""Device-index memory budget calculator.

Computes the exact per-array device footprint of the minimizer index
from the layout in index/index.py _build_device (hash-probe mode), for
a given genome size / w / k, and reports whether a replicated copy
fits one card or how many index shards (`enable_mesh n_index`,
parallel/mesh.py key-range shards) are needed.  The card's memory is
``memory_stats()["bytes_limit"]`` of the first JAX device when an
accelerator is present, else the H100's 80 GB (NVIDIA data sheet).

Array layout (hash mode, eff <= 31 — always true for k=15, 30-bit
keys):
    offcnt    [n_pad, 2] int32   8 B / distinct key
    pos_rp    [m, 2]    int32    8 B / minimizer position
    hash_rows [T/128+1, 128] u32 4 B / slot,  T = 2^ceil(log2(n/0.75))
    hash_val  [T+128]   int32    4 B / slot

Distinct-key ratio n/m is genome-dependent (repeats): measured 0.695
at 32 Mbp / w=10 / k=15 on the bench's uniform-random genome; real
GRCh38 has more repeats (minimap2's published map-ont index: ~100M
distinct minimizers for ~560M positions -> ~0.18 when multi-occurrence
keys collapse harder).  Both bounds are reported.
"""
import sys

H100_HBM = 80e9  # NVIDIA H100 SXM data sheet
HBM_HEADROOM = 0.9  # leave 10% for activations/compile scratch


def card_bytes() -> float:
    """Usable device memory of the card this process sees, or the
    H100's data-sheet size when JAX finds no accelerator."""
    try:
        import jax

        dev = jax.devices()[0]
        if dev.platform != "cpu":
            limit = (dev.memory_stats() or {}).get("bytes_limit")
            if limit:
                return float(limit)
    except (ImportError, RuntimeError):
        pass
    return H100_HBM


def pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def budget(genome_bp: float, w: int = 10, k: int = 15,
           key_ratio: float = 0.695):
    m = 2.0 * genome_bp / (w + 1)  # E[minimizer positions]
    n = key_ratio * m              # distinct keys
    n_pad = ((int(n) + 127) // 128) * 128
    T = pow2_at_least(int(n / 0.75))
    offcnt = 8.0 * n_pad
    pos_rp = 8.0 * m
    hash_rows = 4.0 * (T // 128 + 1) * 128
    hash_val = 4.0 * (T + 128)
    total = offcnt + pos_rp + hash_rows + hash_val
    return {
        "positions_M": m / 1e6,
        "keys_M": n / 1e6,
        "T_M": T / 1e6,
        "offcnt_GB": offcnt / 1e9,
        "pos_rp_GB": pos_rp / 1e9,
        "hash_GB": (hash_rows + hash_val) / 1e9,
        "total_GB": total / 1e9,
    }


def main():
    import json

    cap = card_bytes()
    rows = []
    for label, bp, ratios in (
        ("32Mbp bench", 32e6, (0.695,)),
        ("300Mbp", 300e6, (0.695,)),
        ("GRCh38 3.1Gbp", 3.1e9, (0.695, 0.18)),
    ):
        for r in ratios:
            b = budget(bp, key_ratio=r)
            shards = 1
            while b["total_GB"] * 1e9 / shards > cap * HBM_HEADROOM:
                shards += 1
            rows.append((label, r, b, shards))
            print(
                f"{label:16s} key_ratio={r:.3f}: "
                f"pos={b['positions_M']:.0f}M keys={b['keys_M']:.0f}M "
                f"T={b['T_M']:.0f}M | offcnt {b['offcnt_GB']:.2f} + "
                f"pos_rp {b['pos_rp_GB']:.2f} + hash {b['hash_GB']:.2f} "
                f"= {b['total_GB']:.2f} GB -> "
                f"{'fits 1 card' if shards == 1 else f'{shards} index shards'}"
            )
    if "--json" in sys.argv:
        print(json.dumps([
            {"label": l, "key_ratio": r, **b, "n_index": s}
            for l, r, b, s in rows
        ]))


if __name__ == "__main__":
    main()
