"""64-bit unsigned arithmetic as (hi, lo) uint32 pairs.

JAX's default x64-disabled mode truncates 64-bit integers, and the
pairs keep every device graph in 32-bit integer arithmetic.
Minimizer hashes are up to 2k<=56 bits, so every kernel that touches
hash keys works on explicit (hi, lo) uint32 pairs with the helpers
below.  All shift amounts are Python ints (static under jit).

Only the operations needed by the sketch/lookup kernels are provided:
or/xor/not/and, add (with carry), logical shifts, comparisons, min.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U64 = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo), both uint32

_U32 = jnp.uint32


def const(value: int, shape=(), dtype=jnp.uint32) -> U64:
    hi = jnp.full(shape, (value >> 32) & 0xFFFFFFFF, dtype)
    lo = jnp.full(shape, value & 0xFFFFFFFF, dtype)
    return hi, lo


def from32(lo: jnp.ndarray) -> U64:
    return jnp.zeros_like(lo), lo


def bor(a: U64, b: U64) -> U64:
    return a[0] | b[0], a[1] | b[1]


def bxor(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def band(a: U64, b: U64) -> U64:
    return a[0] & b[0], a[1] & b[1]


def bnot(a: U64) -> U64:
    return ~a[0], ~a[1]


def add(a: U64, b: U64) -> U64:
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(_U32)
    return a[0] + b[0] + carry, lo


def shl(a: U64, n: int) -> U64:
    """Logical shift left by static n (0 <= n < 64)."""
    if n == 0:
        return a
    if n >= 32:
        return (a[1] << (n - 32)) if n > 32 else a[1], jnp.zeros_like(a[1])
    return (a[0] << n) | (a[1] >> (32 - n)), a[1] << n


def shr(a: U64, n: int) -> U64:
    """Logical shift right by static n (0 <= n < 64)."""
    if n == 0:
        return a
    if n >= 32:
        return jnp.zeros_like(a[0]), (a[0] >> (n - 32)) if n > 32 else a[0]
    return a[0] >> n, (a[1] >> n) | (a[0] << (32 - n))


def lt(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] == b[0]) & (a[1] == b[1])


def select(pred: jnp.ndarray, a: U64, b: U64) -> U64:
    return jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1])


def minimum(a: U64, b: U64) -> U64:
    return select(le(a, b), a, b)


def mask_bits(bits: int) -> int:
    return (1 << bits) - 1


def hash32(key: jnp.ndarray, mask_lo: jnp.ndarray) -> jnp.ndarray:
    """hash64 specialized to masks of <= 32 bits (2k <= 32).

    Bit-exact with hash64 on (0, key): every masked step keeps the
    value within mask_lo <= 2^32-1, the unmasked xor/shr steps cannot
    widen it, and u32 wraparound in the adds is erased by the masks —
    so the hi word is identically zero throughout and single-word u32
    arithmetic reproduces the pair result.  Halves the sketch kernel's
    arithmetic for k <= 16 (every elementwise op runs once, not twice).
    """
    key = (~key + (key << 21)) & mask_lo
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask_lo
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask_lo
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask_lo
    return key


def hash64(key: U64, mask_hi: jnp.ndarray, mask_lo: jnp.ndarray) -> U64:
    """Invertible integer mix hash over the low `2k` bits (vectorized).

    Same function the host oracle uses (index/sketch_host.py:hash64),
    computed on (hi, lo) uint32 pairs.  `mask_hi`/`mask_lo` are uint32
    scalars for the 2k-bit mask.
    """
    m: U64 = (mask_hi, mask_lo)

    def masked(x: U64) -> U64:
        return band(x, m)

    key = masked(add(bnot(key), shl(key, 21)))
    key = bxor(key, shr(key, 24))
    key = masked(add(add(key, shl(key, 3)), shl(key, 8)))
    key = bxor(key, shr(key, 14))
    key = masked(add(add(key, shl(key, 2)), shl(key, 4)))
    key = bxor(key, shr(key, 28))
    key = masked(add(key, shl(key, 31)))
    return key
