// The Plücker leaf test and the per-ray write-out shared by the fused kernel
// (fused_trace.cu, a packet walk) and the split kernel (traverse_mxu.cu, a
// per-ray tree walk), so the rules live once; the port of the leaf part of
// uvtrace/ops/traverse_mxu.py:_trace (:198-442):
//   - `plucker_dot`: one of the four dot products of a triangle, 10
//     __fmaf_rn in row order, as a K=10 f32 matrix product accumulates;
//     `plucker_rows`: all four of them for R rays at once from a triangle's
//     10 float4 rows, each sum in the same order;
//   - `keep_hit`: min * max >= 0, |den| >= 1e-5, t = q3 / den > 1e-4, and the
//     lexicographic (t, slot) minimum in one 64-bit key, so a walk's result
//     does not depend on its visit order (ties break by the lowest slot; the
//     TPU kernel keeps the first visited cluster);
//   - `write_hit`: t and slot out (1e30 and -1 on a miss), and one integer
//     atomicAdd per hit into the per-slot counts when they are asked for.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace uvt {

constexpr float BIG = 1e30f;
constexpr int KROWS = 10;  // ray features d(3), m = o x d (3), o(3), 1

__device__ __forceinline__ unsigned long long key_of(float t, uint32_t id) {
  return ((unsigned long long)__float_as_uint(t) << 32) | id;
}

// One Plücker quantity of one triangle (a side q0..q2 or the t numerator
// q3): the sum over the 10 feature rows of col(k) * r[k], as 10 explicit fused
// multiply-adds in row order, as a K=10 f32 matrix product accumulates
// (-fmad=false does not touch the intrinsic).
template <class Col>
__device__ __forceinline__ float plucker_dot(const Col& col, const float r[KROWS]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < KROWS; ++k) acc = __fmaf_rn(col(k), r[k], acc);
  return acc;
}

// The four Plücker quantities of one triangle for R rays: rows[k] holds row k
// of the four quantities (triangle-major features), r[i] ray i's features. Each
// row is loaded once and feeds 4 R multiply-adds; every sum runs in
// `plucker_dot`'s order, so q[i][c] has its bits.
template <int R>
__device__ __forceinline__ void plucker_rows(const float4* rows, const float r[R][KROWS], float q[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) q[i][0] = q[i][1] = q[i][2] = q[i][3] = 0.0f;
#pragma unroll
  for (int k = 0; k < KROWS; ++k) {
    const float4 f = rows[k];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      q[i][0] = __fmaf_rn(f.x, r[i][k], q[i][0]);
      q[i][1] = __fmaf_rn(f.y, r[i][k], q[i][1]);
      q[i][2] = __fmaf_rn(f.z, r[i][k], q[i][2]);
      q[i][3] = __fmaf_rn(f.w, r[i][k], q[i][3]);
    }
  }
}

// The hit rule of the reference's Möller–Trumbore (cl/extend.cl:6-27) on the
// four quantities, and the lexicographic (t, slot) minimum into `best`.
__device__ __forceinline__ void keep_hit(const float q[4], uint32_t slot, unsigned long long& best) {
  const float den = q[0] + q[1] + q[2];
  const float mn = fminf(fminf(q[0], q[1]), q[2]);
  const float mx = fmaxf(fmaxf(q[0], q[1]), q[2]);
  if (!(mn * mx >= 0.0f) || !(fabsf(den) >= 1e-5f)) return;
  const float t = q[3] / den;
  if (!(t > 1e-4f)) return;
  const unsigned long long k = key_of(t, slot);
  best = k < best ? k : best;
}

// Ray `ray`'s t and slot from its best key (1e30 and -1 on a miss, as the TPU
// wrapper returns, traverse_mxu.py:535); one atomicAdd per hit into counts
// unless it is null.
__device__ __forceinline__ void write_hit(unsigned long long best, size_t ray, float* __restrict__ t_out,
                                          int* __restrict__ slot_out, int* __restrict__ counts) {
  float t = __uint_as_float((uint32_t)(best >> 32));
  int slot = (int)(uint32_t)(best & 0xFFFFFFFFu);
  if (t >= BIG) {
    t = BIG;
    slot = -1;
  } else if (counts != nullptr) {
    atomicAdd(counts + slot, 1);
  }
  t_out[ray] = t;
  slot_out[ray] = slot;
}

}  // namespace uvt
