// Fused generate + trace + histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel uvtrace/ops/traverse_mxu.py:fused_trace_counts
// (body _fused_kernel + _trace). It computes what that kernel outputs, not how
// it is built: for each packet of P rays (one block per packet) it
//   1. generates the stratified rays with the counter-based WangHash x2 on the
//      key's two words, in the f32 operation order of the TPU kernel;
//   2. culls every cluster AABB against the packet frustum. The frustum is the
//      ANALYTIC stratum-cell bound of the TPU kernel (traverse_mxu.py:707-795)
//      with its one-sided half-line rule for direction intervals that touch 0
//      (:226-253); both are conservative by construction. Each surviving
//      cluster's (entry, id) key stays in shared memory;
//   3. visits the survivors near-first: the block takes the least key, stops
//      once its entry exceeds the packet bound (the max over the rays of their
//      best t, block-reduced after every visit), stages the cluster's 10 used
//      feature rows x 4C in shared memory and lets every thread run the four
//      Plücker dot products per triangle for its rays, in f32;
//   4. keeps each ray's lexicographic (t, slot) minimum, so the result does not
//      depend on visit order (ties break by the lowest slot; the TPU kernel
//      keeps the first visited cluster), and adds one to counts[slot] per hit
//      with an integer atomicAdd (exact and order-free).
// The walk visits while entry <= bound, so it returns exactly the brute-force
// lexicographic minimum over all slots that the plain version
// (uvtrace_torch/ops/traverse_mxu.py:closest_hits) computes. The leaf
// arithmetic and the write-out are trace_common.cuh's, shared with the split
// kernel; the packet walk (steps 2-3) is this kernel's alone, and its
// functions are block-wide: all threads of the block call them.
//
// What bounds it: the feature tiles (about 11 MB of used rows for the 525
// clusters of the 45k-triangle test room) stay in the 50 MB L2, so a visit is
// one L2->shared copy of 20 KB and then 40 multiply-adds per ray and triangle:
// the kernel is instruction-bound in the dot-product loop. The design keeps
// the tile in shared memory (every thread reads the same triangle at once, a
// broadcast), the ray's 10 features in registers, and visits only the
// clusters the frustum and the packet bound leave.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
// (uvtrace_torch/_build.py). -fmad is OFF: the compiler contracts no multiply
// and add, so the generator's f32 results equal the plain PyTorch version's
// operation by operation (cosf/sinf/sqrtf and division are the IEEE-accurate
// versions, since --use_fast_math is not given). The dot products use explicit
// __fmaf_rn, one rounding per term, in row order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using uvt::BIG;
using uvt::KROWS;

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float HALF_PI_F = (float)(3.14159265358979323846 / 2.0);
constexpr float THREE_HALF_PI_F = (float)(3.0 * 3.14159265358979323846 / 2.0);

__device__ __forceinline__ uint32_t wang(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  return x ^ (x >> 15);
}

__device__ __forceinline__ float uniform(uint32_t ctr, uint32_t key0, uint32_t key1) {
  return (float)(wang(wang(ctr ^ key0) ^ key1) >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float snap(float v) { return fabsf(v) < 1e-6f ? 0.0f : v; }

constexpr float SBIG = 1e18f;  // half-line sentinel; |g| * SBIG stays finite
constexpr unsigned long long NONE = ~0ULL;

// One quantity's column of a staged tile [KROWS][4 * csz]: quantity q of
// triangle j at tile + q * csz + j, row k a stride of 4 * csz further.
struct TileCol {
  const float* col;
  int stride;
  __device__ __forceinline__ float operator()(int k) const { return col[k * stride]; }
};

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
// [n_clusters], 32 u64 for reductions, then the ray features [KROWS][packet],
// the feature tile [KROWS][4 * csz] and 32 f32 for reductions.
size_t smem_bytes(int packet, int n_clusters, int csz) {
  return sizeof(unsigned long long) * ((size_t)packet + n_clusters + 32) +
         sizeof(float) * ((size_t)KROWS * packet + (size_t)KROWS * 4 * csz + 32);
}

struct Smem {
  unsigned long long* best;  // [packet] (t, slot) keys
  unsigned long long* cand;  // [n_clusters] (entry, cid) keys
  unsigned long long* red64; // [32]
  float* rf;                 // [KROWS][packet]: row k of ray `lane` at rf[k * packet + lane]
  float* tile;               // [KROWS][4 * csz]
  float* red32;              // [32]
};

__device__ __forceinline__ Smem carve_smem(void* base, int packet, int n_clusters, int csz) {
  Smem s;
  s.best = reinterpret_cast<unsigned long long*>(base);
  s.cand = s.best + packet;
  s.red64 = s.cand + n_clusters;
  s.rf = reinterpret_cast<float*>(s.red64 + 32);
  s.tile = s.rf + KROWS * packet;
  s.red32 = s.tile + KROWS * 4 * csz;
  return s;
}

// Slab test of the frustum [o_lo, o_hi] x [d_lo, d_hi] against every
// cluster AABB (box6: [n_clusters][6] min.xyz, max.xyz), with the one-sided
// half-line rule for direction intervals that touch 0 (traverse_mxu.py:226-254).
// Writes cand[c] = (entry, c) for a cluster the frustum may hit, NONE
// otherwise.
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
    cand[c] = may_hit ? uvt::key_of(entry > 0.0f ? entry : 0.0f, (uint32_t)c) : NONE;
  }
}

// Near-first visits while entry <= packet bound; s.rf must hold the rays'
// features, s.best each ray's initial key (BIG, ~0) and s.cand the culled
// candidates. Returns the number of clusters visited.
__device__ __forceinline__ int visit_near_first(int packet, int n_clusters, int csz,
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
#pragma unroll
      for (int k = 0; k < KROWS; ++k) r[k] = s.rf[k * packet + lane];
      unsigned long long b = s.best[lane];
      for (int j = 0; j < csz; ++j) {
        float q4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) q4[q] = uvt::plucker_dot(TileCol{s.tile + q * csz + j, 4 * csz}, r);
        uvt::keep_hit(q4, slot0 + (uint32_t)j, b);
      }
      s.best[lane] = b;
      my_max = fmaxf(my_max, __uint_as_float((uint32_t)(b >> 32)));
    }
    t_ub = block_max_f32(my_max, s.red32);
    ++visits;
  }
  return visits;
}

__global__ void fused_trace_kernel(
    uint32_t key0, uint32_t key1, float lx, float ly, float lz, float llen,
    int packet, int gh, int gy, int gphi, int n_clusters, int csz,
    const float* __restrict__ box6, const float* __restrict__ feat10,
    float* __restrict__ t_out, int* __restrict__ slot_out, int* __restrict__ counts,
    float* __restrict__ orig_out, float* __restrict__ dir_out, int* __restrict__ visits_out) {
  extern __shared__ unsigned long long smem[];
  const Smem s = carve_smem(smem, packet, n_clusters, csz);
  float* rf = s.rf;

  const int pid = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // ---- stratum cell and its analytic bounds (uniform across the block) ----
  const float ihf = (float)(pid / (gy * gphi));
  const float iyf = (float)((pid / gphi) % gy);
  const float ipf = (float)(pid % gphi);
  const float ylo = -1.0f + 2.0f * iyf / (float)gy;
  const float yhi = -1.0f + 2.0f * (iyf + 1.0f) / (float)gy;
  const float y2a = ylo * ylo, y2b = yhi * yhi;
  const float y2min = (ylo <= 0.0f && yhi >= 0.0f) ? 0.0f : fminf(y2a, y2b);
  const float y2max = fmaxf(y2a, y2b);
  const float rmin = sqrtf(fmaxf(0.0f, 1.0f - y2max));
  const float rmax = sqrtf(fmaxf(0.0f, 1.0f - y2min));
  const float plo = TWO_PI * ipf / (float)gphi;
  const float phh = TWO_PI * (ipf + 1.0f) / (float)gphi;
  const float ca = cosf(plo), cb = cosf(phh), sa = sinf(plo), sb = sinf(phh);
  float c_hi = (plo <= 0.0f || phh >= TWO_PI) ? 1.0f : fmaxf(ca, cb);
  float c_lo = (plo <= PI_F && phh >= PI_F) ? -1.0f : fminf(ca, cb);
  float s_hi = (plo <= HALF_PI_F && phh >= HALF_PI_F) ? 1.0f : fmaxf(sa, sb);
  float s_lo = (plo <= THREE_HALF_PI_F && phh >= THREE_HALF_PI_F) ? -1.0f : fminf(sa, sb);
  c_lo = snap(c_lo);
  c_hi = snap(c_hi);
  s_lo = snap(s_lo);
  s_hi = snap(s_hi);

  // ---- 1. generate this thread's rays ------------------------------------
  for (int lane = tid; lane < packet; lane += nthr) {
    const uint32_t base = (uint32_t)lane + (uint32_t)pid * (uint32_t)(3 * packet);
    const float uh = uniform(base, key0, key1);
    const float uy = uniform(base + (uint32_t)packet, key0, key1);
    const float up = uniform(base + 2u * (uint32_t)packet, key0, key1);
    const float dy = -1.0f + 2.0f * (iyf + uy) / (float)gy;
    const float phi = TWO_PI * (ipf + up) / (float)gphi;
    const float r = sqrtf(fmaxf(0.0f, 1.0f - dy * dy));
    const float dx = r * fminf(fmaxf(cosf(phi), c_lo), c_hi);
    const float dz = r * fminf(fmaxf(sinf(phi), s_lo), s_hi);
    const float oy = ly + (ihf + uh) / (float)gh * llen;
    rf[0 * packet + lane] = dx;
    rf[1 * packet + lane] = dy;
    rf[2 * packet + lane] = dz;
    rf[3 * packet + lane] = oy * dz - lz * dy;  // m = o x d
    rf[4 * packet + lane] = lz * dx - lx * dz;
    rf[5 * packet + lane] = lx * dy - oy * dx;
    rf[6 * packet + lane] = lx;
    rf[7 * packet + lane] = oy;
    rf[8 * packet + lane] = lz;
    rf[9 * packet + lane] = 1.0f;
    s.best[lane] = uvt::key_of(BIG, 0xFFFFFFFFu);
    if (orig_out != nullptr) {
      const size_t ray = (size_t)pid * packet + lane;
      orig_out[3 * ray + 0] = lx;
      orig_out[3 * ray + 1] = oy;
      orig_out[3 * ray + 2] = lz;
      dir_out[3 * ray + 0] = dx;
      dir_out[3 * ray + 1] = dy;
      dir_out[3 * ray + 2] = dz;
    }
  }

  // ---- 2. the cell's analytic frustum vs every cluster AABB ---------------
  float o_lo[3], o_hi[3], d_lo[3], d_hi[3];
  {
    float p1 = rmin * c_lo, p2 = rmin * c_hi, p3 = rmax * c_lo, p4 = rmax * c_hi;
    d_lo[0] = fminf(fminf(p1, p2), fminf(p3, p4));
    d_hi[0] = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    p1 = rmin * s_lo; p2 = rmin * s_hi; p3 = rmax * s_lo; p4 = rmax * s_hi;
    d_lo[2] = fminf(fminf(p1, p2), fminf(p3, p4));
    d_hi[2] = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    d_lo[1] = ylo;
    d_hi[1] = yhi;
    o_lo[0] = o_hi[0] = lx;
    o_lo[2] = o_hi[2] = lz;
    o_lo[1] = ly + ihf / (float)gh * llen;
    o_hi[1] = ly + (ihf + 1.0f) / (float)gh * llen;
  }
  cull_clusters(o_lo, o_hi, d_lo, d_hi, box6, n_clusters, s.cand);

  // ---- 3. near-first visits, 4. outputs and the per-slot histogram -------
  const int visits = visit_near_first(packet, n_clusters, csz, feat10, s);
  // over threadIdx.x / blockDim.x: the same loop over tid / nthr compiled to
  // a kernel 5% slower on an H100 (scripts/torch_kernel_scale.py's b1_ms)
  const size_t ray0 = (size_t)pid * packet;
  for (int lane = threadIdx.x; lane < packet; lane += blockDim.x)
    uvt::write_hit(s.best[lane], ray0 + lane, t_out, slot_out, counts);
  if (tid == 0) visits_out[pid] = visits;
}

}  // namespace

extern "C" size_t fused_trace_smem_bytes(int packet, int n_clusters, int csz) {
  return smem_bytes(packet, n_clusters, csz);
}

// Launches one block per packet on `stream`. Returns cudaGetLastError() of the
// launch (0 on success); the caller raises on anything else.
extern "C" int fused_trace_launch(
    uint32_t key0, uint32_t key1, float lx, float ly, float lz, float llen,
    int packets, int packet, int gh, int gy, int gphi, int n_clusters, int csz,
    const float* box6, const float* feat10, float* t_out, int* slot_out, int* counts,
    float* orig_out, float* dir_out, int* visits_out, void* stream) {
  const int threads = packet % 256 == 0 ? 256 : 128;
  const size_t smem = smem_bytes(packet, n_clusters, csz);
  cudaError_t err = cudaFuncSetAttribute(fused_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_trace_kernel<<<packets, threads, smem, (cudaStream_t)stream>>>(
      key0, key1, lx, ly, lz, llen, packet, gh, gy, gphi, n_clusters, csz, box6, feat10,
      t_out, slot_out, counts, orig_out, dir_out, visits_out);
  return (int)cudaGetLastError();
}
