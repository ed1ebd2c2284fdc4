"""Threefry keys on the host, threefry uniforms on the device, and the
reference sampler's WangHash/xorshift32 streams (uvtrace/ops/rng.py).

A key is two uint32 words, as `jax.random.key_data` gives them. The keys come
from `PRNGKey`, `split` and `fold_in` exactly as uvtrace/sim/simulator.py:365
and uvtrace/sim/launch.py:121,131,190 derive them with jax 0.9's partitionable
threefry (`jax_threefry_partitionable` is True there). A key is a few scalars
per chunk, so it is derived in numpy on the host: no device work and no
synchronisation.

`random_bits` and `uniform` draw one value per element on the device, bit-equal
to `jax.random.bits` / `jax.random.uniform` for an f32 shape: element i (in
row-major order) is threefry2x32(key, (0, i)) with its two words xor-ed.
`choice` is `jax.random.choice` with replacement and probabilities, its
cumulative sum made on the host in XLA:CPU's order. `uniform` launches the
CUDA kernel K1 (csrc/samplers.cu) for a CUDA device; `random_bits` and
`uniform_reference`, its plain version and the CPU path, run in torch int64
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

import math

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


def _threefry_counters(key, n: int, device):
    """The two output words (int64[n] holding uint32 values) of threefry2x32
    of the counters (0, i), i < n, in torch int64 masked after every add and
    shift."""
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
    return x0, x1


def random_bits(key, n: int, device) -> torch.Tensor:
    """int64[n] holding the uint32 values of `jax.random.bits(key, (n,))`:
    threefry2x32 of the counter (0, i), the two output words xor-ed."""
    x0, x1 = _threefry_counters(key, n, device)
    return x0 ^ x1


def split_words(key, n: int, device) -> torch.Tensor:
    """int64[n, 2] holding the uint32 words of `split(key, n)` computed on
    `device` as the kernels derive keys (csrc/threefry.cuh:split_key): key i
    is threefry2x32 of the counter (0, i), both words."""
    return torch.stack(_threefry_counters(key, n, device), dim=1)


def uniform_reference(key, shape, device, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of `uniform`: f32 of `shape` (an int n, or a
    tuple) equal bit for bit to `jax.random.uniform(key, shape, float32,
    minval, maxval)`: 23 random mantissa bits under the exponent of 1.0,
    minus 1, then scaled, shifted and clipped below at minval, in f32. The
    partitionable threefry counts the elements of an N-D shape in row-major
    order, so an N-D draw is the 1-D draw reshaped."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    bits = (random_bits(key, math.prod(shape), device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo)).view(shape)


def _uniform_kernel(key, shape: tuple, device: torch.device, lo: np.float32, hi: np.float32) -> torch.Tensor:
    """One launch of csrc/samplers.cu's threefry_uniform_kernel (K1)."""
    from uvtrace_torch import _build

    n = math.prod(shape)
    _build.check_elements(n)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if n:
        k0, k1 = (int(k) & _M32 for k in key)
        _build.launch("threefry_uniform_launch", device, k0, k1, float(lo), float(hi - lo), n,
                      _build.ptr(out))
        uniform.launches += 1
    return out


def uniform(key, shape, device, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32 of `shape` (an int n, or a tuple) equal bit for bit to
    `jax.random.uniform(key, shape, float32, minval, maxval)`. On a CUDA
    device one launch of the kernel K1 (csrc/samplers.cu), which replaces the
    XLA fusion that `jax.random.uniform` compiles to inside the JAX package's
    launches; on the CPU `uniform_reference`. A launch that fails raises."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_reference(key, shape, device, minval, maxval)
    if device.type != "cuda":
        raise ValueError(f"uniform draws on cpu or cuda, not {device}")
    return _uniform_kernel(key, shape, device, np.float32(minval), np.float32(maxval))


uniform.launches = 0  # K1 launches, counted where the kernel is launched


def cumsum_f32(p, base: int = 16) -> np.ndarray:
    """f32 inclusive prefix sums of p in XLA:CPU's order for `jnp.cumsum`:
    a blocked scan of `base` (its reduce-window rewrite), recursive. p is
    padded to whole blocks, each block summed from its left end, the block
    totals scanned the same way, and each block's exclusive prefix added to
    its elements."""
    p = np.asarray(p, np.float32)
    n = p.shape[0]
    if n <= base:
        return np.cumsum(p, dtype=np.float32)  # numpy's 1-D cumsum runs left to right
    blocks = np.zeros(-(-n // base) * base, np.float32)
    blocks[:n] = p
    inner = np.cumsum(blocks.reshape(-1, base), axis=1, dtype=np.float32)
    prefix = np.concatenate([np.zeros(1, np.float32), cumsum_f32(inner[:, -1], base)[:-1]])
    return (inner + prefix[:, None]).reshape(-1)[:n]


def choice_from_cdf(key, shape, cdf: torch.Tensor) -> torch.Tensor:
    """int64 of `shape`: `jax.random.choice(key, n, shape, replace=True,
    p=p)` for cdf = cumsum_f32(p), made once on the host so that every
    device draws the same indices from it: r = cdf[-1] * (1 - u) for
    uniforms u of `shape`, then the first index whose cumulative sum reaches
    r (searchsorted, left side)."""
    r = cdf[-1] * (1.0 - uniform(key, shape, cdf.device))
    return torch.searchsorted(cdf, r.reshape(-1)).view(r.shape)


def choice(key, n: int, shape, p, device="cpu") -> torch.Tensor:
    """`jax.random.choice(key, n, shape, p=p)` with replacement: int64
    indices in [0, n) drawn with probabilities p (numpy f32[n], on the
    host)."""
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {p.shape}, expected ({n},)")
    return choice_from_cdf(key, shape, torch.from_numpy(cumsum_f32(p)).to(device))


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
