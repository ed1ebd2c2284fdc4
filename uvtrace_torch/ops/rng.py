"""Threefry keys on the host, threefry uniforms on the device, and the
reference sampler's WangHash/xorshift32 streams (uvtrace/ops/rng.py).

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

The reference-semantics family (`wang_hash`, `xorshift32`, `random_float`,
`photon_seeds`, `advance_global_seed`) replays cl/tools.cl:2-4 and
cl/generate.cl:13,39 bit for bit: each photon owns a xorshift32 stream seeded
by WangHash of an f32 expression of its thread id and the lamp position.
uint32 values live in int64 tensors, masked to 32 bits after every left shift
and product (torch has no usable uint32 arithmetic on CUDA, and its `>>` on
int32 is arithmetic). Every f32 step is its own tensor op, so nothing is
contracted into a multiply-add.
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


# --------------------------------------------------------------------------
# reference-semantics streams (cl/tools.cl, cl/generate.cl)
# --------------------------------------------------------------------------

UINT32_TO_UNIT_F32 = float(np.float32(2.3283064365387e-10))  # 1/(2^32-1), cl/tools.cl:4
_U32_MAX_F32 = float(np.float32(4294967295.0))  # rounds to 2^32


def wang_hash(s: torch.Tensor) -> torch.Tensor:
    """WangHash (cl/tools.cl:2) of uint32 values held in int64."""
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & _M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & _M32
    return s ^ (s >> 15)


def xorshift32(s: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (cl/tools.cl:3); the new state is the output."""
    s = s ^ ((s << 13) & _M32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & _M32)


def random_float(s: torch.Tensor):
    """(new state, f32 in [0, 1]): RandomFloat (cl/tools.cl:4)."""
    s = xorshift32(s)
    return s, s.to(torch.float32) * UINT32_TO_UNIT_F32


def f32_to_u32_sat(x: torch.Tensor) -> torch.Tensor:
    """f32 -> uint32 (in int64) truncating toward 0 and saturating, as JAX's
    convert gives it after uvtrace's clip: negative -> 0, NaN -> 0, and the
    clip's upper end f32(2^32 - 1) = 2^32 -> 2^32 - 1."""
    x = torch.nan_to_num(x, nan=0.0).clamp(0.0, _U32_MAX_F32)
    return x.to(torch.int64).clamp_max(_M32)


def _wrap_i32(v):
    """int64 values wrapped to int32, as JAX's int32 arithmetic wraps."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def photon_seeds(n: int, light_pos, global_seed: int, start: int = 0, device="cpu") -> torch.Tensor:
    """Per-photon seeds of one generate launch (cl/generate.cl:13):

        seed_i = WangHash(u32(f32(i*17 + 1) + x*13 + y*7 + z*11 + f32(global_seed >> 15)))

    with i = start + arange(n) in int32 and the sum taken in f32 left to right
    (the f32 precision loss for large i included). light_pos: host floats
    (x, y, z) of the 3-D lamp position; global_seed: the uint32 SEED.
    Returns int64[n] holding uint32 values."""
    x, y, z = (np.float32(v) for v in light_pos)
    tid = torch.arange(n, dtype=torch.int64, device=device) + int(_wrap_i32(int(start)))
    acc = _wrap_i32(_wrap_i32(tid) * 17 + 1).to(torch.float32)
    acc = acc + float(x * np.float32(13))
    acc = acc + float(y * np.float32(7))
    acc = acc + float(z * np.float32(11))
    acc = acc + float(np.float32((int(global_seed) & _M32) >> 15))
    return wang_hash(f32_to_u32_sat(acc))


def advance_global_seed(light_pos, global_seed: int) -> int:
    """The reference's cross-launch SEED update (cl/generate.cl:39), replayed
    on the host: thread 0's stream after its rod height, its dir-y and its
    disc rejection rounds (2 draws each, at least one round). Returns the new
    uint32 seed as a Python int; no device value is read."""
    s = photon_seeds(1, light_pos, global_seed)
    s, _ = random_float(s)  # rod height
    s, _ = random_float(s)  # dir y
    while True:
        s, ux = random_float(s)
        s, uz = random_float(s)
        dx, dz = ux * 2 - 1, uz * 2 - 1
        if not bool(dx * dx + dz * dz > 1.0):
            return int(s)
