// The trace body shared by the fused kernel (fused_trace.cu) and the split
// kernel (traverse_mxu.cu): the port of uvtrace/ops/traverse_mxu.py:_trace
// (:198-442). One block traces one packet of rays:
//   1. `cull_clusters`: the conservative slab test of the packet's frustum
//      (origin and direction intervals) against every cluster AABB, with the
//      one-sided half-line rule for direction intervals that touch 0
//      (:226-254). Each surviving cluster's (entry, id) key goes to shared
//      memory;
//   2. `visit_near_first`: the block takes the least key, stops once its entry
//      exceeds the packet bound (the max over the rays of their best t,
//      block-reduced after every visit), stages the cluster's 10 used feature
//      rows x 4C in shared memory and lets every thread run the four Plücker
//      dot products per triangle for its rays, in f32 with explicit
//      __fmaf_rn in row order (as a K=10 f32 matrix product accumulates);
//   3. each ray keeps its lexicographic (t, slot) minimum in one 64-bit key,
//      so the result does not depend on visit order (ties break by the lowest
//      slot; the TPU kernel keeps the first visited cluster);
//   4. `write_hits`: t and slot out (1e30 and -1 on a miss), and one integer
//      atomicAdd per hit into the per-slot counts when they are asked for.
// The walk visits while entry <= bound, so it returns exactly the brute-force
// lexicographic minimum over all slots that the plain PyTorch version
// (uvtrace_torch/ops/traverse_mxu.py:closest_hits) computes.
//
// Every function here is block-wide: all threads of the block call it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace uvt {

constexpr float BIG = 1e30f;
constexpr float SBIG = 1e18f;  // half-line sentinel; |g| * SBIG stays finite
constexpr int KROWS = 10;      // ray features d(3), m = o x d (3), o(3), 1
constexpr unsigned long long NONE = ~0ULL;

__device__ __forceinline__ unsigned long long key_of(float t, uint32_t id) {
  return ((unsigned long long)__float_as_uint(t) << 32) | id;
}

// Block-wide reductions; every thread gets the result. `red` holds one value
// per warp; the leading barrier keeps a previous reduction's readers safe.
__device__ __forceinline__ unsigned long long block_min_u64(unsigned long long v, unsigned long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < (blockDim.x >> 5) ? red[threadIdx.x & 31] : NONE;
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ float block_max_f32(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < (blockDim.x >> 5) ? red[threadIdx.x & 31] : -INFINITY;
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory of one block: best keys [packet], candidate keys
// [n_clusters], 32 u64 for reductions, then `extra_floats` floats of the
// caller's, the feature tile [KROWS][4 * csz] and 32 f32 for reductions.
__host__ __device__ inline size_t smem_bytes(int packet, int n_clusters, int csz, size_t extra_floats) {
  return sizeof(unsigned long long) * ((size_t)packet + n_clusters + 32) +
         sizeof(float) * (extra_floats + (size_t)KROWS * 4 * csz + 32);
}

struct Smem {
  unsigned long long* best;  // [packet] (t, slot) keys
  unsigned long long* cand;  // [n_clusters] (entry, cid) keys
  unsigned long long* red64; // [32]
  float* extra;              // [extra_floats]
  float* tile;               // [KROWS][4 * csz]
  float* red32;              // [32]
};

__device__ __forceinline__ Smem carve_smem(void* base, int packet, int n_clusters, int csz, size_t extra_floats) {
  Smem s;
  s.best = reinterpret_cast<unsigned long long*>(base);
  s.cand = s.best + packet;
  s.red64 = s.cand + n_clusters;
  s.extra = reinterpret_cast<float*>(s.red64 + 32);
  s.tile = s.extra + extra_floats;
  s.red32 = s.tile + KROWS * 4 * csz;
  return s;
}

// Slab test of the frustum [o_lo, o_hi] x [d_lo, d_hi] against every
// cluster AABB (box6: [n_clusters][6] min.xyz, max.xyz). Writes cand[c] =
// (entry, c) for a cluster the frustum may hit, NONE otherwise.
__device__ __forceinline__ void cull_clusters(const float o_lo[3], const float o_hi[3], const float d_lo[3],
                                              const float d_hi[3], const float* __restrict__ box6,
                                              int n_clusters, unsigned long long* cand) {
  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) {
    float entry = -BIG, exit_ = BIG;
    for (int ax = 0; ax < 3; ++ax) {
      const bool spans = (d_lo[ax] < 0.0f && d_hi[ax] > 0.0f) || (d_lo[ax] == 0.0f && d_hi[ax] == 0.0f);
      const float i_lo = d_hi[ax] == 0.0f ? -SBIG : 1.0f / d_hi[ax];
      const float i_hi = d_lo[ax] == 0.0f ? SBIG : 1.0f / d_lo[ax];
      const float g_lo = box6[6 * c + ax] - o_hi[ax];
      const float g_hi = box6[6 * c + 3 + ax] - o_lo[ax];
      const float p1 = g_lo * i_lo, p2 = g_lo * i_hi, p3 = g_hi * i_lo, p4 = g_hi * i_hi;
      const float s_lo_ax = spans ? -BIG : fminf(fminf(p1, p2), fminf(p3, p4));
      const float s_hi_ax = spans ? BIG : fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
      entry = fmaxf(entry, s_lo_ax);
      exit_ = fminf(exit_, s_hi_ax);
    }
    const bool may_hit = entry <= exit_ && exit_ > 0.0f;
    // entry > 0 ? entry : +0, never -0, whose bits would sort last
    cand[c] = may_hit ? key_of(entry > 0.0f ? entry : 0.0f, (uint32_t)c) : NONE;
  }
}

// Near-first visits while entry <= packet bound. `rays(lane, r)` writes the
// KROWS features of ray `lane` into r; s.best must hold each ray's initial
// key (BIG, ~0) and s.cand the culled candidates. Returns the number of
// clusters visited.
template <class Rays>
__device__ __forceinline__ int visit_near_first(const Rays& rays, int packet, int n_clusters, int csz,
                                                const float* __restrict__ feat10, const Smem& s) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int tile_len = KROWS * 4 * csz;
  float t_ub = BIG;
  int visits = 0;
  while (true) {
    unsigned long long m = NONE;
    for (int c = tid; c < n_clusters; c += nthr) m = s.cand[c] < m ? s.cand[c] : m;
    m = block_min_u64(m, s.red64);
    if (m == NONE || __uint_as_float((uint32_t)(m >> 32)) > t_ub) break;
    const int cid = (int)(m & 0xFFFFFFFFu);
    const float* src = feat10 + (size_t)cid * tile_len;
    for (int i = tid; i < tile_len; i += nthr) s.tile[i] = src[i];
    if (tid == 0) s.cand[cid] = NONE;
    __syncthreads();

    float my_max = 0.0f;
    const uint32_t slot0 = (uint32_t)cid * (uint32_t)csz;
    for (int lane = tid; lane < packet; lane += nthr) {
      float r[KROWS];
      rays(lane, r);
      unsigned long long b = s.best[lane];
      for (int j = 0; j < csz; ++j) {
        float q4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // explicit fused multiply-adds in row order, as a K=10 f32 matrix
          // product accumulates (-fmad=false does not touch the intrinsic)
          const float* col = s.tile + q * csz + j;
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < KROWS; ++k) acc = __fmaf_rn(col[k * 4 * csz], r[k], acc);
          q4[q] = acc;
        }
        const float den = q4[0] + q4[1] + q4[2];
        const float mn = fminf(fminf(q4[0], q4[1]), q4[2]);
        const float mx = fmaxf(fmaxf(q4[0], q4[1]), q4[2]);
        if (!(mn * mx >= 0.0f) || !(fabsf(den) >= 1e-5f)) continue;
        const float t = q4[3] / den;
        if (!(t > 1e-4f)) continue;
        const unsigned long long k = key_of(t, slot0 + (uint32_t)j);
        b = k < b ? k : b;
      }
      s.best[lane] = b;
      my_max = fmaxf(my_max, __uint_as_float((uint32_t)(b >> 32)));
    }
    t_ub = block_max_f32(my_max, s.red32);
    ++visits;
  }
  return visits;
}

// t and slot of the packet's rays (1e30 and -1 on a miss) into t_out/slot_out
// at ray0; one atomicAdd per hit into counts unless it is null.
__device__ __forceinline__ void write_hits(const unsigned long long* best, int packet, size_t ray0,
                                           float* __restrict__ t_out, int* __restrict__ slot_out,
                                           int* __restrict__ counts) {
  for (int lane = threadIdx.x; lane < packet; lane += blockDim.x) {
    const unsigned long long b = best[lane];
    float t = __uint_as_float((uint32_t)(b >> 32));
    int slot = (int)(uint32_t)(b & 0xFFFFFFFFu);
    if (t >= BIG) {
      t = BIG;
      slot = -1;
    } else if (counts != nullptr) {
      atomicAdd(counts + slot, 1);
    }
    t_out[ray0 + lane] = t;
    slot_out[ray0 + lane] = slot;
  }
}

}  // namespace uvt
