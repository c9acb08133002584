"""Generate tests/data/test.fa, the small reference the tests map to.

Four contigs of 400 bp, uniform ACGT from a fixed seed, with the names
and lengths the tests assert (they mirror minimap2's own test
resource).  The committed test.fa is this script's output; the .mmi
index is written from it by the repo's own writer in a session
fixture (tests/conftest.py).

Usage: python tests/data/make_test_fa.py
"""
import os

import numpy as np

NAMES = (
    "Bacillus_subtilis",
    "Enterococcus_faecalis",
    "Escherichia_coli_1",
    "Escherichia_coli_2",
)
LENGTH = 400
SEED = 20240501
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test.fa")


def contigs():
    rng = np.random.default_rng(SEED)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [
        (name, acgt[rng.integers(0, 4, LENGTH)].tobytes().decode())
        for name in NAMES
    ]


def main() -> None:
    with open(PATH, "w") as fh:
        for name, seq in contigs():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + "\n")


if __name__ == "__main__":
    main()
