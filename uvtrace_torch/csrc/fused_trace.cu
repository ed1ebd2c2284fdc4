// Fused generate + trace + histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel uvtrace/ops/traverse_mxu.py:fused_trace_counts
// (body _fused_kernel + _trace). It computes what that kernel outputs, not how
// it is built: for each packet of P rays (one block of P / R threads per
// packet, each thread keeping its R rays, 2 or 4, from generation to
// write-out) it
//   1. generates the stratified rays with the counter-based WangHash x2 on the
//      key's two words, in the f32 operation order of the TPU kernel; a ray's
//      10 Plücker features and its best (t, slot) key stay in registers;
//   2. culls every cluster AABB against the packet frustum. The frustum is the
//      ANALYTIC stratum-cell bound of the TPU kernel (traverse_mxu.py:707-795)
//      with its one-sided half-line rule for direction intervals that touch 0
//      (:226-253); both are conservative by construction. Each surviving
//      cluster's (entry, id) key stays in shared memory;
//   3. visits the survivors near-first: the block takes the least key, stops
//      once its entry exceeds the packet bound (the max over the rays of their
//      best t, block-reduced after every visit), and tests the cluster's tile
//      from shared memory. The tile is the cluster's triangle-major features
//      (f32[C][10][4]: row k of a triangle is one float4 of its four
//      quantities), copied with cp.async into one of two buffers: the next
//      candidate is chosen and its copy started before the current tile is
//      tested, and dropped when the tightened bound ends the walk. Per
//      triangle a thread issues 10 128-bit shared loads (one address a warp, a
//      broadcast) and 40 R multiply-adds, the four dot products of each of its
//      rays, each in row order;
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
// What bounds it: the feature tiles (about 11 MB for the 525 clusters of the
// 45k-triangle test room) stay in the 50 MB L2, so a visit is one L2->shared
// copy of 20 KB, hidden behind the previous tile, and then 40 multiply-adds
// per ray and triangle: the kernel is instruction-bound in the dot-product
// loop. An SM issues one shared load a clock against four multiply-add warps,
// so the design feeds 4 R multiply-adds from every load (4 quantities x R
// rays), keeps the rays in registers instead of shared memory (a block needs
// 40 KB of tiles and 8 B a cluster, whatever its packet), and visits only the
// clusters the frustum and the packet bound leave. With many packets in
// flight the loop runs near the issue rate; a launch of 1024 packets ends with
// its longest packets (44 visits against a mean of 10.6 in the test room),
// which is why a packet gets as many threads as its registers allow and why
// the blocks take the packets heaviest first (packet_weight_kernel,
// packet_order_kernel: two small launches in front of the trace).
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

// The stratum cell of packet pid in the (gh, gy, gphi) grid of rod height,
// dir.y and azimuth, with its analytic bounds (traverse_mxu.py:716-752): the
// same for every ray of the packet.
struct StratumCell {
  float ihf, iyf, ipf;            // the cell's indices
  float ylo, yhi;                 // dir.y interval
  float rmin, rmax;               // interval of sqrt(1 - dir.y^2)
  float c_lo, c_hi, s_lo, s_hi;   // intervals of cos and sin of the azimuth: the sampled values are clipped to them
};

__device__ __forceinline__ StratumCell stratum_cell(int pid, int gh, int gy, int gphi) {
  StratumCell c;
  c.ihf = (float)(pid / (gy * gphi));
  c.iyf = (float)((pid / gphi) % gy);
  c.ipf = (float)(pid % gphi);
  c.ylo = -1.0f + 2.0f * c.iyf / (float)gy;
  c.yhi = -1.0f + 2.0f * (c.iyf + 1.0f) / (float)gy;
  const float y2a = c.ylo * c.ylo, y2b = c.yhi * c.yhi;
  const float y2min = (c.ylo <= 0.0f && c.yhi >= 0.0f) ? 0.0f : fminf(y2a, y2b);
  const float y2max = fmaxf(y2a, y2b);
  c.rmin = sqrtf(fmaxf(0.0f, 1.0f - y2max));
  c.rmax = sqrtf(fmaxf(0.0f, 1.0f - y2min));
  const float plo = TWO_PI * c.ipf / (float)gphi;
  const float phh = TWO_PI * (c.ipf + 1.0f) / (float)gphi;
  const float ca = cosf(plo), cb = cosf(phh), sa = sinf(plo), sb = sinf(phh);
  c.c_hi = snap((plo <= 0.0f || phh >= TWO_PI) ? 1.0f : fmaxf(ca, cb));
  c.c_lo = snap((plo <= PI_F && phh >= PI_F) ? -1.0f : fminf(ca, cb));
  c.s_hi = snap((plo <= HALF_PI_F && phh >= HALF_PI_F) ? 1.0f : fmaxf(sa, sb));
  c.s_lo = snap((plo <= THREE_HALF_PI_F && phh >= THREE_HALF_PI_F) ? -1.0f : fminf(sa, sb));
  return c;
}

// Ray `lane` of packet pid: its height oy on the rod (the origin is (lx, oy,
// lz)) and its direction d, from three hashed uniforms
// (traverse_mxu.py:679-705).
__device__ __forceinline__ void generate_ray(const StratumCell& c, uint32_t key0, uint32_t key1, int pid, int packet,
                                             int lane, int gh, int gy, int gphi, float ly, float llen, float& oy,
                                             float d[3]) {
  const uint32_t base = (uint32_t)lane + (uint32_t)pid * (uint32_t)(3 * packet);
  const float uh = uniform(base, key0, key1);
  const float uy = uniform(base + (uint32_t)packet, key0, key1);
  const float up = uniform(base + 2u * (uint32_t)packet, key0, key1);
  const float dy = -1.0f + 2.0f * (c.iyf + uy) / (float)gy;
  const float phi = TWO_PI * (c.ipf + up) / (float)gphi;
  const float rr = sqrtf(fmaxf(0.0f, 1.0f - dy * dy));
  d[0] = rr * fminf(fmaxf(cosf(phi), c.c_lo), c.c_hi);
  d[1] = dy;
  d[2] = rr * fminf(fmaxf(sinf(phi), c.s_lo), c.s_hi);
  oy = ly + (c.ihf + uh) / (float)gh * llen;
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

// Shared memory of one block: two tiles [csz][KROWS] of float4, the candidate
// keys [n_clusters], 32 u64 and 32 f32 for reductions.
size_t smem_bytes(int n_clusters, int csz) {
  return 2 * sizeof(float4) * (size_t)KROWS * csz + sizeof(unsigned long long) * ((size_t)n_clusters + 32) +
         sizeof(float) * 32;
}

struct Smem {
  float4* tile;              // [2][csz][KROWS]: row k of triangle j of buffer b at tile[(b * csz + j) * KROWS + k]
  unsigned long long* cand;  // [n_clusters] (entry, cid) keys
  unsigned long long* red64; // [32]
  float* red32;              // [32]
};

__device__ __forceinline__ Smem carve_smem(void* base, int n_clusters, int csz) {
  Smem s;
  s.tile = reinterpret_cast<float4*>(base);
  s.cand = reinterpret_cast<unsigned long long*>(s.tile + 2 * KROWS * csz);
  s.red64 = s.cand + n_clusters;
  s.red32 = reinterpret_cast<float*>(s.red64 + 32);
  return s;
}

// cp.async: 16 bytes from global to shared memory past the registers; a
// thread's copies complete in the order of their groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // until at most N of this thread's groups are in flight
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A packet's frustum: the intervals of its rays' origins and directions.
struct Frustum {
  float o_lo[3], o_hi[3], d_lo[3], d_hi[3];
};

// The analytic frustum of a stratum cell's rays from the rod at (lx, ly..ly +
// llen, lz): conservative by construction (traverse_mxu.py:707-795).
__device__ __forceinline__ Frustum packet_frustum(const StratumCell& cell, float lx, float ly, float lz, float llen,
                                                  int gh) {
  Frustum f;
  float p1 = cell.rmin * cell.c_lo, p2 = cell.rmin * cell.c_hi, p3 = cell.rmax * cell.c_lo, p4 = cell.rmax * cell.c_hi;
  f.d_lo[0] = fminf(fminf(p1, p2), fminf(p3, p4));
  f.d_hi[0] = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
  p1 = cell.rmin * cell.s_lo; p2 = cell.rmin * cell.s_hi; p3 = cell.rmax * cell.s_lo; p4 = cell.rmax * cell.s_hi;
  f.d_lo[2] = fminf(fminf(p1, p2), fminf(p3, p4));
  f.d_hi[2] = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
  f.d_lo[1] = cell.ylo;
  f.d_hi[1] = cell.yhi;
  f.o_lo[0] = f.o_hi[0] = lx;
  f.o_lo[2] = f.o_hi[2] = lz;
  f.o_lo[1] = ly + cell.ihf / (float)gh * llen;
  f.o_hi[1] = ly + (cell.ihf + 1.0f) / (float)gh * llen;
  return f;
}

// Slab test of a frustum against one cluster AABB (box: min.xyz, max.xyz), with
// the one-sided half-line rule for direction intervals that touch 0
// (traverse_mxu.py:226-254). True when the frustum may hit the box; entry is
// then its conservative entry distance, >= +0.
__device__ __forceinline__ bool frustum_may_hit(const Frustum& f, const float* __restrict__ box, float& entry) {
  float lo = -BIG, exit_ = BIG;
  for (int ax = 0; ax < 3; ++ax) {
    const bool spans = (f.d_lo[ax] < 0.0f && f.d_hi[ax] > 0.0f) || (f.d_lo[ax] == 0.0f && f.d_hi[ax] == 0.0f);
    const float i_lo = f.d_hi[ax] == 0.0f ? -SBIG : 1.0f / f.d_hi[ax];
    const float i_hi = f.d_lo[ax] == 0.0f ? SBIG : 1.0f / f.d_lo[ax];
    const float g_lo = box[ax] - f.o_hi[ax];
    const float g_hi = box[3 + ax] - f.o_lo[ax];
    const float p1 = g_lo * i_lo, p2 = g_lo * i_hi, p3 = g_hi * i_lo, p4 = g_hi * i_hi;
    const float s_lo_ax = spans ? -BIG : fminf(fminf(p1, p2), fminf(p3, p4));
    const float s_hi_ax = spans ? BIG : fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    lo = fmaxf(lo, s_lo_ax);
    exit_ = fminf(exit_, s_hi_ax);
  }
  entry = lo > 0.0f ? lo : 0.0f;  // never -0, whose bits would sort last
  return lo <= exit_ && exit_ > 0.0f;
}

// Writes cand[c] = (entry, c) for every cluster the frustum may hit, NONE
// otherwise (box6: [n_clusters][6]).
__device__ __forceinline__ void cull_clusters(const Frustum& f, const float* __restrict__ box6, int n_clusters,
                                              unsigned long long* cand) {
  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) {
    float entry;
    cand[c] = frustum_may_hit(f, box6 + 6 * c, entry) ? uvt::key_of(entry, (uint32_t)c) : NONE;
  }
}

// The least candidate key, taken off the list (NONE when it is empty). The
// thread that scans an entry is the one that removes it, so the next scan
// needs no barrier after this one.
__device__ __forceinline__ unsigned long long take_nearest(int n_clusters, const Smem& s) {
  unsigned long long m = NONE;
  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) m = s.cand[c] < m ? s.cand[c] : m;
  m = block_min_u64(m, s.red64);
  const int cid = (int)(m & 0xFFFFFFFFu);
  if (m != NONE && cid % (int)blockDim.x == (int)threadIdx.x) s.cand[cid] = NONE;
  return m;
}

// Starts the copy of candidate m's tile, its slots in use (nothing for NONE),
// as one cp.async group of this thread.
__device__ __forceinline__ void stage_tile(unsigned long long m, int csz, const float4* __restrict__ tri_feat,
                                           const int* __restrict__ tri_used, float4* tile) {
  if (m != NONE) {
    const uint32_t cid = (uint32_t)(m & 0xFFFFFFFFu);
    const float4* src = tri_feat + (size_t)cid * KROWS * csz;
    const int rows = KROWS * __ldg(tri_used + cid);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) cp_async16(tile + i, src + i);
  }
  cp_async_commit();
}

// Near-first visits while entry <= packet bound: r holds this thread's rays'
// features, best their keys, s.cand the culled candidates. A visit tests the
// cluster's slots in use: the all-zero triangles behind them (padding) have
// den = 0 and hit nothing. Returns the number of clusters visited.
template <int R>
__device__ __forceinline__ int visit_near_first(int n_clusters, int csz, const float4* __restrict__ tri_feat,
                                                const int* __restrict__ tri_used, const Smem& s,
                                                const float r[R][KROWS], unsigned long long best[R]) {
  float t_ub = BIG;
  int visits = 0;
  unsigned long long m = take_nearest(n_clusters, s);
  stage_tile(m, csz, tri_feat, tri_used, s.tile);
  while (m != NONE && __uint_as_float((uint32_t)(m >> 32)) <= t_ub) {
    // the next candidate's copy runs while this tile is tested
    const unsigned long long m_next = take_nearest(n_clusters, s);
    stage_tile(m_next, csz, tri_feat, tri_used, s.tile + ((visits + 1) & 1) * KROWS * csz);
    cp_async_wait<1>();
    __syncthreads();  // every thread's part of this tile has landed

    const float4* tile = s.tile + (visits & 1) * KROWS * csz;
    const uint32_t cid = (uint32_t)(m & 0xFFFFFFFFu);
    const uint32_t slot0 = cid * (uint32_t)csz;
    const int used = __ldg(tri_used + cid);
    for (int j = 0; j < used; ++j) {
      float q[R][4];
      uvt::plucker_rows<R>(tile + j * KROWS, r, q);
#pragma unroll
      for (int i = 0; i < R; ++i) uvt::keep_hit(q[i], slot0 + (uint32_t)j, best[i]);
    }
    float my_max = 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) my_max = fmaxf(my_max, __uint_as_float((uint32_t)(best[i] >> 32)));
    t_ub = block_max_f32(my_max, s.red32);  // its barriers also free this tile's buffer
    ++visits;
    m = m_next;
  }
  cp_async_wait<0>();
  return visits;
}

// The order in which a launch's blocks take its packets: the ones with the
// most work first. A launch ends with its longest packets (in the test room
// 31 to 106 visits against a mean of 10), so they should start first; the
// number of clusters a packet's frustum may hit says how long it will be
// (correlation with its visits 0.77-0.97 over the test room's route; ordering
// by it took a quarter off the route's launches on an H100, as much as
// ordering by the visits themselves). One block per packet counts them,
constexpr int ORDER_MAX_PACKETS = 1024;  // what one block sorts
constexpr int COUNT_THREADS = 128;

__global__ void __launch_bounds__(COUNT_THREADS) packet_weight_kernel(
    float lx, float ly, float lz, float llen, int gh, int gy, int gphi, int n_clusters,
    const float* __restrict__ box6, int* __restrict__ weight) {
  const Frustum f = packet_frustum(stratum_cell(blockIdx.x, gh, gy, gphi), lx, ly, lz, llen, gh);
  int n = 0;
  for (int c = threadIdx.x; c < n_clusters; c += COUNT_THREADS) {
    float entry;
    n += frustum_may_hit(f, box6 + 6 * c, entry) ? 1 : 0;
  }
  __shared__ int per_warp[COUNT_THREADS / 32];
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) per_warp[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < COUNT_THREADS / 32; ++w) n += per_warp[w];
    weight[blockIdx.x] = n;
  }
}

// and one block sorts the packets by that weight, heaviest first (ties: the
// lower packet), with a bitonic network over ORDER_MAX_PACKETS keys in shared
// memory: order[i] is the packet that block i of the launch traces.
__global__ void __launch_bounds__(ORDER_MAX_PACKETS) packet_order_kernel(int packets, const int* __restrict__ weight,
                                                                         int* __restrict__ order) {
  __shared__ unsigned long long keys[ORDER_MAX_PACKETS];
  const int i = threadIdx.x;
  // ascending sort of (~weight, packet): the heaviest first; padding sorts last
  keys[i] = i < packets ? ((unsigned long long)(~(uint32_t)weight[i]) << 32) | (uint32_t)i : NONE;
  __syncthreads();
  for (int k = 2; k <= ORDER_MAX_PACKETS; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = i ^ j;
      if (other > i) {
        const unsigned long long a = keys[i], b = keys[other];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[other] = a;
        }
      }
      __syncthreads();
    }
  }
  if (i < packets) order[i] = (int)(keys[i] & 0xFFFFFFFFu);
}

// A thread keeps R rays in registers, so a packet of P rays is a block of
// P / R threads; MAX_THREADS bounds the block and with it the registers a
// thread may take (128 at 512 threads, 64 at 1024).
template <int R, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS) fused_trace_kernel(
    uint32_t key0, uint32_t key1, float lx, float ly, float lz, float llen,
    int packet, int gh, int gy, int gphi, int n_clusters, int csz,
    const float* __restrict__ box6, const float4* __restrict__ tri_feat, const int* __restrict__ tri_used,
    float* __restrict__ t_out, int* __restrict__ slot_out, int* __restrict__ counts,
    float* __restrict__ orig_out, float* __restrict__ dir_out, int* __restrict__ visits_out,
    const int* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve_smem(smem, n_clusters, csz);

  const int pid = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;  // packet / R

  const StratumCell cell = stratum_cell(pid, gh, gy, gphi);

  // ---- 1. generate this thread's rays: lanes tid, tid + nthr, ... ----------
  float r[R][KROWS];
  unsigned long long best[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int lane = tid + i * nthr;
    float oy, d[3];
    generate_ray(cell, key0, key1, pid, packet, lane, gh, gy, gphi, ly, llen, oy, d);
    r[i][0] = d[0];
    r[i][1] = d[1];
    r[i][2] = d[2];
    r[i][3] = oy * d[2] - lz * d[1];  // m = o x d
    r[i][4] = lz * d[0] - lx * d[2];
    r[i][5] = lx * d[1] - oy * d[0];
    r[i][6] = lx;
    r[i][7] = oy;
    r[i][8] = lz;
    r[i][9] = 1.0f;
    best[i] = uvt::key_of(BIG, 0xFFFFFFFFu);
    if (orig_out != nullptr) {
      const size_t ray = (size_t)pid * packet + lane;
      orig_out[3 * ray + 0] = lx;
      orig_out[3 * ray + 1] = oy;
      orig_out[3 * ray + 2] = lz;
      dir_out[3 * ray + 0] = d[0];
      dir_out[3 * ray + 1] = d[1];
      dir_out[3 * ray + 2] = d[2];
    }
  }

  // ---- 2. the cell's analytic frustum vs every cluster AABB ---------------
  cull_clusters(packet_frustum(cell, lx, ly, lz, llen, gh), box6, n_clusters, s.cand);

  // ---- 3. near-first visits, 4. outputs and the per-slot histogram -------
  const int visits = visit_near_first<R>(n_clusters, csz, tri_feat, tri_used, s, r, best);
  const size_t ray0 = (size_t)pid * packet;
#pragma unroll
  for (int i = 0; i < R; ++i) uvt::write_hit(best[i], ray0 + tid + i * nthr, t_out, slot_out, counts);
  if (tid == 0) visits_out[pid] = visits;
}

template <int R, int MAX_THREADS>
int launch(int packets, size_t smem, cudaStream_t stream, uint32_t key0, uint32_t key1, float lx,
           float ly, float lz, float llen, int packet, int gh, int gy, int gphi, int n_clusters, int csz,
           const float* box6, const float4* tri_feat, const int* tri_used, float* t_out, int* slot_out,
           int* counts, float* orig_out, float* dir_out, int* visits_out, const int* order) {
  cudaError_t err = cudaFuncSetAttribute(fused_trace_kernel<R, MAX_THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_trace_kernel<R, MAX_THREADS><<<packets, packet / R, smem, stream>>>(
      key0, key1, lx, ly, lz, llen, packet, gh, gy, gphi, n_clusters, csz, box6, tri_feat, tri_used, t_out,
      slot_out, counts, orig_out, dir_out, visits_out, order);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t fused_trace_smem_bytes(int n_clusters, int csz) { return smem_bytes(n_clusters, csz); }

// Launches one block per packet on `stream`; packet is a multiple of 128 up to
// 4096. A thread keeps 2 rays up to 2048 rays a packet and 4 above: on an H100
// 2^20 rays of the test room at 1024 a packet took 4.3 ms with 2 rays a thread
// (512 threads), 4.45 ms with 4 and 5.05 ms with 8; the packets with the most
// visits end the launch, and more threads end them sooner. Returns
// cudaGetLastError() of the launch (0 on success); the caller raises on
// anything else. `order` is scratch of 2 * packets ints for the heavy-first
// order of the launch's packets; a launch of more than ORDER_MAX_PACKETS runs
// in packet order (its longest packets weigh less in it).
extern "C" int fused_trace_launch(
    uint32_t key0, uint32_t key1, float lx, float ly, float lz, float llen,
    int packets, int packet, int gh, int gy, int gphi, int n_clusters, int csz,
    const float* box6, const float* tri_feat, const int* tri_used, float* t_out, int* slot_out, int* counts,
    float* orig_out, float* dir_out, int* visits_out, int* order, void* stream) {
  if (packets > ORDER_MAX_PACKETS) {
    order = nullptr;
  } else {
    int* weight = order + packets;
    packet_weight_kernel<<<packets, COUNT_THREADS, 0, (cudaStream_t)stream>>>(lx, ly, lz, llen, gh, gy, gphi,
                                                                              n_clusters, box6, weight);
    packet_order_kernel<<<1, ORDER_MAX_PACKETS, 0, (cudaStream_t)stream>>>(packets, weight, order);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = smem_bytes(n_clusters, csz);
  const auto fn = packet <= 1024 ? &launch<2, 512> : packet <= 2048 ? &launch<2, 1024> : &launch<4, 1024>;
  return fn(packets, smem, (cudaStream_t)stream, key0, key1, lx, ly, lz, llen, packet, gh, gy, gphi,
            n_clusters, csz, box6, reinterpret_cast<const float4*>(tri_feat), tri_used, t_out, slot_out, counts,
            orig_out, dir_out, visits_out, order);
}
