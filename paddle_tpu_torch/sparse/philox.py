"""Batched counter-based Philox4x64-10: the vectorized lazy-init
kernel of the host sparse table (counterpart of
``paddle_tpu/sparse/philox.py``, a copy of it: the rows a seed and an id
give are the JAX package's, bit for bit, so a table started in either
package materializes the same rows).

The scalar oracle (``SparseTable._reference_init_rows``) draws each
missing row with its own ``np.random.Generator(np.random.Philox(key))``,
keyed ``(seed << 32) ^ (id & 0xFFFFFFFF)``.  This module evaluates the
same keystreams for all missing ids in one batched numpy pass:

* Philox4x64-10 is a pure counter-based function ``(counter, key) ->
  4 x uint64``; numpy's bit generator consumes blocks at counters
  1, 2, ... (the first ``next64`` pre-increments the zero-initialized
  counter) and the block's four lanes in order;
* ``Generator.uniform(low, high, n)`` maps each uint64 ``x`` to
  ``low + (high - low) * ((x >> 11) * 2**-53)``.

Both are reproduced with 64-bit numpy vector ops (the 64x64->128
products via 32-bit limbs), so the batched draw is bit-identical to the
per-id oracle.
"""
from __future__ import annotations

import numpy as np

__all__ = ["philox_uniform_rows"]

# Philox4x64 round multipliers and Weyl key-schedule constants
# (Random123; numpy/random/src/philox/philox.h).
_M0 = np.uint64(0xD2E7470EE14C6C93)
_M1 = np.uint64(0xCA5A826395121157)
_W0 = np.uint64(0x9E3779B97F4A7C15)
_W1 = np.uint64(0xBB67AE8584CAA73B)
_MASK32 = np.uint64(0xFFFFFFFF)
_MASK64 = (1 << 64) - 1
_S32 = np.uint64(32)
_S11 = np.uint64(11)
_INV53 = 1.0 / 9007199254740992.0          # 2**-53
# ids are chunked so the ~10 uint64 temporaries stay tens of MB even for
# checkpoint-restore-sized misses
_CHUNK = 1 << 16


def _mulhilo(a: np.uint64, b: np.ndarray):
    """(high, low) 64-bit halves of the 128-bit product ``a * b``.
    ``a`` is a scalar multiplier, ``b`` an uint64 array; the high half
    comes from 32-bit limb products (each < 2**64, no overflow)."""
    lo = a * b                               # wraps mod 2**64 (the low half)
    a_lo, a_hi = a & _MASK32, a >> _S32
    b_lo, b_hi = b & _MASK32, b >> _S32
    t = a_lo * b_lo
    t2 = a_hi * b_lo + (t >> _S32)
    t3 = a_lo * b_hi + (t2 & _MASK32)
    hi = a_hi * b_hi + (t2 >> _S32) + (t3 >> _S32)
    return hi, lo


def _philox4x64_10(c0, c1, c2, c3, k0, k1):
    """Ten Philox rounds over arrays of counters/keys (any broadcastable
    shape).  Returns the four output lanes."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = k0 + _W0
        k1 = k1 + _W1
    return c0, c1, c2, c3


def philox_uniform_rows(seed: int, ids: np.ndarray, dim: int,
                        low: float, high: float) -> np.ndarray:
    """``[len(ids), dim]`` float64 uniform rows, element-for-element
    bit-identical to drawing each row with
    ``np.random.Generator(np.random.Philox(key=(seed << 32) ^
    (id & 0xFFFFFFFF))).uniform(low, high, dim)``."""
    ids = np.asarray(ids, np.int64)
    n = int(ids.size)
    dim = int(dim)
    base = int(seed) << 32
    if base < 0 or base >> 128:
        # the per-id oracle's Philox(key=...) rejects these too
        raise ValueError(
            f"sparse lazy-init seed {seed} is outside the 128-bit "
            f"Philox key range")
    key_hi = np.uint64((base >> 64) & _MASK64)
    base_lo = np.uint64(base & _MASK64)
    nblk = -(-dim // 4) if dim else 0
    out = np.empty((n, dim), np.float64)
    rng = np.float64(high) - np.float64(low)
    # block counters 1..nblk (numpy's philox_next64 pre-increments the
    # zero counter before generating each block); only the key varies
    # per id, so counters broadcast along the id axis and keys along the
    # block axis (the rounds never mutate in place)
    ctr = np.arange(1, nblk + 1, dtype=np.uint64)[None, :]
    zero = np.zeros((1, 1), np.uint64)
    with np.errstate(over="ignore"):
        for s in range(0, n, _CHUNK):
            chunk = ids[s:s + _CHUNK]
            m = chunk.size
            k0 = (base_lo
                  ^ (chunk.astype(np.uint64) & _MASK32))[:, None]
            o0, o1, o2, o3 = _philox4x64_10(ctr, zero, zero, zero,
                                            k0, key_hi)
            bits = np.empty((m, nblk, 4), np.uint64)
            bits[:, :, 0] = o0
            bits[:, :, 1] = o1
            bits[:, :, 2] = o2
            bits[:, :, 3] = o3
            u = (bits.reshape(m, nblk * 4)[:, :dim] >> _S11) * _INV53
            out[s:s + m] = np.float64(low) + rng * u
    return out
