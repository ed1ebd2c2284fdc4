"""Threefry keys on the host and threefry uniforms on the device.

A key is two uint32 words, as `jax.random.key_data` gives them. The keys come
from `PRNGKey`, `split` and `fold_in` exactly as uvtrace/sim/simulator.py:365
and uvtrace/sim/launch.py:121,131,190 derive them with jax 0.9's partitionable
threefry (`jax_threefry_partitionable` is True there). A key is a few scalars
per chunk, so it is derived in numpy on the host: no device work and no
synchronisation.

`random_bits` and `uniform` draw one value per element on the device, bit-equal
to `jax.random.bits` / `jax.random.uniform` for a 1-D f32 shape: element i is
threefry2x32(key, (0, i)) with its two words xor-ed. They run in torch int64
holding uint32 values, masked after every add and shift.

Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11), as jax/_src/prng.py implements it.
"""

from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 block function: key (2 words) and counter words
    x0, x1 (uint32 arrays of one shape) -> two uint32 arrays."""
    k0, k1 = (np.uint32(int(k) & 0xFFFFFFFF) for k in key)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """uint32[2] key words of `jax.random.PRNGKey(seed)`: [0, seed]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: threefry of the counter [0, data]."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """uint32[num, 2] key words of `jax.random.split(key, num)`: key i is the
    threefry of the counter [0, i] (the partitionable form)."""
    y0, y1 = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def random_bits(key, n: int, device) -> torch.Tensor:
    """int64[n] holding the uint32 values of `jax.random.bits(key, (n,))`:
    threefry2x32 of the counter (0, i), the two output words xor-ed."""
    k0, k1 = (int(k) & _M32 for k in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    x0 = torch.full_like(x1, ks[0])  # counter word 0 is 0 for a 1-D shape
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0 ^ x1


def uniform(key, n: int, device, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32[n] equal bit for bit to `jax.random.uniform(key, (n,), float32,
    minval, maxval)`: 23 random mantissa bits under the exponent of 1.0, minus
    1, then scaled, shifted and clipped below at minval, in f32."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))
