// Threefry-2x32 (20 rounds; Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC'11) on the card, as jax/_src/prng.py implements it and
// uvtrace_torch/ops/rng.py replays it: shared by the samplers (samplers.cu)
// and the launch layer's bounce step (launch_ops.cu), so the rules live once.
//   - `threefry2x32`: the block function of the counter (0, i) under a key,
//     both output words: `split(key)[i]` (rng.py:split) is this pair;
//   - `threefry_bits`: its two words xor-ed, `jax.random.bits` of a 1-D shape
//     at element i (rng.py:random_bits);
//   - `uniform_at`: `jax.random.uniform` at element i (rng.py:uniform_reference).
// uint32_t wraps the way the plain versions' int64 masks do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace uvt {

struct Key {
  uint32_t k0, k1, k2;  // the key words and their parity word
};

__device__ __forceinline__ Key make_key(uint32_t k0, uint32_t k1) { return {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu}; }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry-2x32 (20 rounds) of the counter (0, i): both output words.
__device__ __forceinline__ uint2 threefry2x32(const Key& k, uint32_t i) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k2};
  uint32_t x0 = k.k0;  // counter word 0 is 0
  uint32_t x1 = i + k.k1;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int r0 = (j & 1) ? 17 : 13, r1 = (j & 1) ? 29 : 15, r2 = (j & 1) ? 16 : 26, r3 = (j & 1) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(j + 1) % 3];
    x1 += ks[(j + 2) % 3] + (uint32_t)(j + 1);
  }
  return make_uint2(x0, x1);
}

// key i of split(key, n) (the partitionable form, rng.py:split).
__device__ __forceinline__ Key split_key(const Key& k, uint32_t i) {
  const uint2 w = threefry2x32(k, i);
  return make_key(w.x, w.y);
}

// jax.random.bits of a 1-D shape at element i (rng.py:random_bits).
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t i) {
  const uint2 w = threefry2x32(k, i);
  return w.x ^ w.y;
}

// rng.py:uniform_reference at element i: the mantissa trick, then
// f * scale + lo in f32 (scale = f32(maxval) - f32(minval)), clamped below at lo.
__device__ __forceinline__ float uniform_at(const Key& k, uint32_t i, float lo, float scale) {
  const float f = __fsub_rn(__uint_as_float((threefry_bits(k, i) >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(__fadd_rn(__fmul_rn(f, scale), lo), lo);
}

}  // namespace uvt
