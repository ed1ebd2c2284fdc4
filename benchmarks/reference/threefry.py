"""Threefry-2x32 keys and uniforms, as `jax.random` defines them with the
partitionable threefry (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11; jax/_src/prng.py).

A key is two uint32 words. Keys are derived in numpy on the host; uniform
draws are made in torch int64 holding uint32 values on any device. Element i
of a draw is threefry2x32(key, (0, i)) with its two output words xor-ed; an
f32 uniform keeps the top 23 bits as the mantissa of a number in [1, 2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The block function on uint32 numpy arrays: key words, counter words."""
    k0, k1 = (np.uint32(int(k) & _M32) for k in key)
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


def key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the words [0, seed mod 2^32]."""
    return np.array([0, int(seed) & _M32], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32), np.array([int(data) & _M32], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """uint32[num, 2]: key i is the threefry of the counter (0, i)."""
    y0, y1 = threefry2x32(k, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def bits(k, n: int, device) -> torch.Tensor:
    """int64[n] holding the uint32 values of `jax.random.bits(k, (n,))`."""
    k0, k1 = (int(w) & _M32 for w in k)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0 ^ x1


def uniform(k, shape, device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """f32 of `shape`: `jax.random.uniform(k, shape, float32, lo, hi)`."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    b = (bits(k, math.prod(shape), device) >> 9) | 0x3F800000
    f = b.to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(f * float(hi32 - lo32) + float(lo32), float(lo32)).view(shape)


def wang_hash(s: torch.Tensor) -> torch.Tensor:
    """WangHash of uint32 values held in int64."""
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _M32
    return s ^ (s >> 15)
