// The differentiable layer's direct estimator on the card for Hopper (sm_90a):
// four kernels around the shadow-ray trace B2, each equal to its plain PyTorch
// version in uvtrace_torch/diff/direct.py (bit for bit where the plain version
// fixes the order; K10 within the f32 order of its sums).
//
//   shadow_sample_kernel (K8): one thread per shadow ray i = s M + m, S
//     samples of M targets. It derives the keys as rng.split does
//     (split(kw, 3)[0] split once more for the triangle draws, [1] for the
//     rod; `_points_direct` draws the rod from kw itself: threefry.cuh's
//     split_key), draws u, v (element i of the (S, T, 1) draws) and the rod
//     height (element s), folds u + v > 1 onto the lower triangle, and writes
//     the shadow ray from the rod point r = (x, base + u_rod length, z) to
//     q = (v0 + u e1) + v e2 (or to the given point): its unit direction
//     d / max(|d|, 1e-20), its unclamped length |d|, the geometry term
//     G = |d.n| / sqrt(max(d.d, 1e-12)) / (f32(4 pi) max(d.d, 1e-12)) and the
//     coherence key (octant * 512 + the rod point's cell mod 8 per axis, as
//     ops/bounce.coherence_key). Replaces uvtrace/diff/estimator.py:217-227
//     (`_sample_triangle_points`), the rod draw and G of :253-294
//     (`irradiance`) and :297-320 (`_points_direct`), and the sort key of the
//     mxu `extend`'s coherence sort (:99-140): XLA fusions, no pl.pallas_call.
//   pack_sorted_kernel (K7): the sorted batch B2 traces: ray j of the batch is
//     input ray perm[j] (its origin row perm[j] / group: S origins for S x M
//     shadow rays), the tail up to whole packets parked rays (origin 1e6,
//     direction (0, 1, 0)), and inverse[perm[j]] = j. Replaces the gathers
//     of `jax.lax.sort` carrying the rays (uvtrace/diff/estimator.py:99-140,
//     uvtrace/ops/bounce.py:120) and the padding concatenations.
//   visibility_reduce_kernel (K9): one thread per target m: for s = 0..S-1 in
//     order, ray i = s M + m reads its t through inverse[i], is visible when
//     t >= dist (1 - eps) - eps, and adds G vis; E = power (sum / S). Writes
//     E and the visibility bits the backward keeps. Replaces `_visibility`'s
//     comparison (:230-250) and `power * mean(g * vis)`.
//   direct_grad_kernel + direct_grad_final_kernel (K10): the backward of E
//     with respect to lamp x, lamp z, rod base, rod length and power, given
//     dL/dE: one thread per target recomputes each visible ray's d from the
//     key (K8's draws), takes the closed form
//       dG/dd = sign(d.n) n / (4 pi D sqrt(D)) - 3 G d / D  (D = max(d.d, 1e-12),
//       the second term only where d.d >= 1e-12, as autograd of the clamp),
//     dd/dr = -1, dr/dbase = (0, 1, 0), dr/dlength = (0, u_rod, 0), dE/dpower =
//     sum(G vis) / S; sums its rays, scales by dL/dE, and the block sums its
//     threads in a fixed tree; the final kernel sums the blocks' partials in
//     a fixed order (thread t takes blocks t, t + 256, ..., then a tree). No
//     float atomics: a step's gradients repeat bit for bit. Replaces the
//     backward XLA derives for the G x V estimator (jax.grad through
//     uvtrace/diff/estimator.py:253-320).
//
// Every f32 step of K8 and K9 is written with the _rn intrinsics in the plain
// version's operation order (dot products ((x0 y0 + x1 y1) + x2 y2) as
// ops/intersect.dot3; the division by S an IEEE division, as
// ops/generate._div), so nothing is contracted (the library is also built
// with -fmad=false); clamps propagate NaN as torch.clamp does; a float goes to
// int32 by truncation, saturating (torch's CUDA cast).
//
// What bounds them: bytes. K8 reads 48 B a triangle (or 24 B a point) and
// writes 24 B a ray; its 7 threefry blocks a ray (4 key splits, u, v, the rod
// height) and about 45 f32 steps take a fraction of the issue rate's time for
// those bytes. K7 moves 8 B of index, 24 B of ray and 4 B of inverse a ray;
// K9 reads 16 B a ray (t gathered) and writes 1 B a ray and 4 B a target;
// K10 reads 1 B a ray and 52 B a target and recomputes K8's work where a ray
// is visible. The plain versions spend a launch on every step (about 145 a
// waypoint, forward and backward); here a waypoint is K8, the sort, K7, B2,
// K9 forward and K10 backward. One thread per ray (K8, K7) or per target (K9,
// K10) in 256-thread blocks; rays as f32[n, 3] rows; intermediates in
// registers.
//
// Build: uvtrace_torch/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using uvt::Key;
using uvt::make_key;
using uvt::split_key;
using uvt::uniform_at;

constexpr int THREADS = 256;
constexpr float FOUR_PI_F = 0x1.921fb6p+3f;  // f32(4 pi)
constexpr float DIST_MIN = 0x1.79ca1p-67f;   // f32(1e-20): the direction's divisor floor
constexpr float DIST2_MIN = 0x1.197998p-40f; // f32(1e-12): G's squared-distance floor
constexpr float PARK = 1e6f;                 // a padding ray's origin

__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)), __fmul_rn(x2, y2));
}

// torch.clamp_min(x, lo) on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// The draws' keys: `irradiance` splits kw into 3 (keys[0] for the triangle
// points, split once more into the u and v keys; keys[1] for the rod), and
// `_points_direct` draws the rod from kw itself.
struct Keys {
  Key ku, kv, krod;
};

__device__ __forceinline__ Keys derive_keys(uint32_t k0, uint32_t k1, int points) {
  const Key kw = make_key(k0, k1);
  if (points) return {kw, kw, kw};
  const Key k_tri = split_key(kw, 0);
  return {split_key(k_tri, 0), split_key(k_tri, 1), split_key(kw, 1)};
}

// Ray i = s M + m: the rod's uniform u_rod, the rod point r and d = q - r,
// with q drawn on triangle m (v0 = a, e1 = b, e2 = c) or the given point a[m].
struct Ray {
  float u_rod, r0, r1, r2, d0, d1, d2;
};

__device__ __forceinline__ Ray ray_of(const Keys& keys, int points, int s, int m, int i, const float* __restrict__ xz,
                                      float base, float length, const float* __restrict__ a,
                                      const float* __restrict__ b, const float* __restrict__ c) {
  Ray ray;
  ray.u_rod = uniform_at(keys.krod, (uint32_t)s, 0.0f, 1.0f);
  ray.r0 = xz[0];
  ray.r1 = __fadd_rn(base, __fmul_rn(ray.u_rod, length));
  ray.r2 = xz[1];
  const size_t g = 3 * (size_t)m;
  float q0, q1, q2;
  if (points) {
    q0 = a[g];
    q1 = a[g + 1];
    q2 = a[g + 2];
  } else {
    float u = uniform_at(keys.ku, (uint32_t)i, 0.0f, 1.0f);
    float v = uniform_at(keys.kv, (uint32_t)i, 0.0f, 1.0f);
    if (__fadd_rn(u, v) > 1.0f) {  // fold onto the lower triangle
      u = __fsub_rn(1.0f, u);
      v = __fsub_rn(1.0f, v);
    }
    q0 = __fadd_rn(__fadd_rn(a[g], __fmul_rn(u, b[g])), __fmul_rn(v, c[g]));
    q1 = __fadd_rn(__fadd_rn(a[g + 1], __fmul_rn(u, b[g + 1])), __fmul_rn(v, c[g + 1]));
    q2 = __fadd_rn(__fadd_rn(a[g + 2], __fmul_rn(u, b[g + 2])), __fmul_rn(v, c[g + 2]));
  }
  ray.d0 = __fsub_rn(q0, ray.r0);
  ray.d1 = __fsub_rn(q1, ray.r1);
  ray.d2 = __fsub_rn(q2, ray.r2);
  return ray;
}

__global__ void __launch_bounds__(THREADS) shadow_sample_kernel(
    uint32_t k0, uint32_t k1, int points, int n_s, int m_count, const float* __restrict__ xz, float base,
    float length, const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ nrm, float* __restrict__ rod, float* __restrict__ dir, float* __restrict__ dist,
    float* __restrict__ g_out, int* __restrict__ key_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_s * m_count) return;
  const int s = i / m_count, m = i - s * m_count;
  const Keys keys = derive_keys(k0, k1, points);
  const Ray ray = ray_of(keys, points, s, m, i, xz, base, length, a, b, c);
  if (m == 0) {
    rod[3 * s] = ray.r0;
    rod[3 * s + 1] = ray.r1;
    rod[3 * s + 2] = ray.r2;
  }
  const float d2 = dot3(ray.d0, ray.d1, ray.d2, ray.d0, ray.d1, ray.d2);
  const float len = __fsqrt_rn(d2);
  const float den = clamp_min_nan(len, DIST_MIN);
  const float w0 = __fdiv_rn(ray.d0, den), w1 = __fdiv_rn(ray.d1, den), w2 = __fdiv_rn(ray.d2, den);
  const size_t o = 3 * (size_t)i, g = 3 * (size_t)m;
  dir[o] = w0;
  dir[o + 1] = w1;
  dir[o + 2] = w2;
  dist[i] = len;
  const float dd = clamp_min_nan(d2, DIST2_MIN);
  const float cos_q = __fdiv_rn(fabsf(dot3(ray.d0, ray.d1, ray.d2, nrm[g], nrm[g + 1], nrm[g + 2])), __fsqrt_rn(dd));
  g_out[i] = __fdiv_rn(cos_q, __fmul_rn(FOUR_PI_F, dd));
  // coherence_key at cell_meters 1: the direction's octant, the rod point's cell
  const int oct = (w0 >= 0.0f ? 4 : 0) + (w1 >= 0.0f ? 2 : 0) + (w2 >= 0.0f ? 1 : 0);
  int cell = ((int)floorf(ray.r0)) & 7;
  cell = cell * 8 + (((int)floorf(ray.r1)) & 7);
  cell = cell * 8 + (((int)floorf(ray.r2)) & 7);
  key_out[i] = oct * 512 + cell;
}

__global__ void __launch_bounds__(THREADS) pack_sorted_kernel(int r, int n_out, int group,
                                                              const int64_t* __restrict__ perm,
                                                              const float* __restrict__ orig,
                                                              const float* __restrict__ dir,
                                                              float* __restrict__ out_orig,
                                                              float* __restrict__ out_dir, int* __restrict__ inverse) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_out) return;
  const size_t o = 3 * (size_t)j;
  if (j >= r) {  // a parked padding ray
    out_orig[o] = out_orig[o + 1] = out_orig[o + 2] = PARK;
    out_dir[o] = out_dir[o + 2] = 0.0f;
    out_dir[o + 1] = 1.0f;
    return;
  }
  const int p = perm ? (int)perm[j] : j;
  const size_t src = 3 * (size_t)p, src_o = 3 * (size_t)(p / group);
  out_orig[o] = orig[src_o];
  out_orig[o + 1] = orig[src_o + 1];
  out_orig[o + 2] = orig[src_o + 2];
  out_dir[o] = dir[src];
  out_dir[o + 1] = dir[src + 1];
  out_dir[o + 2] = dir[src + 2];
  inverse[p] = j;
}

__global__ void __launch_bounds__(THREADS) visibility_reduce_kernel(
    int n_s, int m_count, float scale, float offset, float power, const float* __restrict__ t,
    const int* __restrict__ inverse, const float* __restrict__ dist, const float* __restrict__ g,
    float* __restrict__ e, uint8_t* __restrict__ vis) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= m_count) return;
  float acc = 0.0f;
  for (int s = 0; s < n_s; ++s) {
    const int i = s * m_count + m;
    const bool seen = t[inverse[i]] >= __fsub_rn(__fmul_rn(dist[i], scale), offset);
    vis[i] = seen;
    const float gv = __fmul_rn(g[i], seen ? 1.0f : 0.0f);
    acc = s ? __fadd_rn(acc, gv) : gv;
  }
  e[m] = __fmul_rn(power, __fdiv_rn(acc, (float)n_s));
}

constexpr int N_GRAD = 5;  // lamp x, lamp z, rod base, rod length, power

// The block's fixed-order tree over its threads' N_GRAD values.
__device__ __forceinline__ void block_sum(float (*sh)[THREADS], float* v) {
  for (int k = 0; k < N_GRAD; ++k) sh[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half)
      for (int k = 0; k < N_GRAD; ++k) sh[k][threadIdx.x] = __fadd_rn(sh[k][threadIdx.x], sh[k][threadIdx.x + half]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) direct_grad_kernel(
    uint32_t k0, uint32_t k1, int points, int n_s, int m_count, const float* __restrict__ xz, float base,
    float length, float power, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ nrm, const float* __restrict__ grad,
    const uint8_t* __restrict__ vis, float* __restrict__ partials) {
  __shared__ float sh[N_GRAD][THREADS];
  const int m = blockIdx.x * THREADS + threadIdx.x;
  float v[N_GRAD] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (m < m_count) {
    const Keys keys = derive_keys(k0, k1, points);
    const size_t g = 3 * (size_t)m;
    const float n0 = nrm[g], n1 = nrm[g + 1], n2 = nrm[g + 2];
    // sums over the visible rays of -dG/dd (x, y, z), -dG/dd_y u_rod and G
    float sx = 0.0f, sy = 0.0f, syu = 0.0f, sz = 0.0f, sg = 0.0f;
    for (int s = 0; s < n_s; ++s) {
      const int i = s * m_count + m;
      if (!vis[i]) continue;
      const Ray ray = ray_of(keys, points, s, m, i, xz, base, length, a, b, c);
      const float d2 = dot3(ray.d0, ray.d1, ray.d2, ray.d0, ray.d1, ray.d2);
      const float dd = clamp_min_nan(d2, DIST2_MIN);
      const float cn = dot3(ray.d0, ray.d1, ray.d2, n0, n1, n2);
      const float root = __fsqrt_rn(dd);
      const float gt = __fdiv_rn(__fdiv_rn(fabsf(cn), root), __fmul_rn(FOUR_PI_F, dd));
      const float sgn = cn > 0.0f ? 1.0f : (cn < 0.0f ? -1.0f : 0.0f);
      const float a_n = __fdiv_rn(sgn, __fmul_rn(__fmul_rn(FOUR_PI_F, dd), root));
      const float a_d = d2 >= DIST2_MIN ? __fdiv_rn(__fmul_rn(3.0f, gt), dd) : 0.0f;
      // dL/dr = -dG/dd: r moves opposite to d
      const float gx = __fsub_rn(__fmul_rn(a_d, ray.d0), __fmul_rn(a_n, n0));
      const float gy = __fsub_rn(__fmul_rn(a_d, ray.d1), __fmul_rn(a_n, n1));
      const float gz = __fsub_rn(__fmul_rn(a_d, ray.d2), __fmul_rn(a_n, n2));
      sx = __fadd_rn(sx, gx);
      sy = __fadd_rn(sy, gy);
      syu = __fadd_rn(syu, __fmul_rn(gy, ray.u_rod));
      sz = __fadd_rn(sz, gz);
      sg = __fadd_rn(sg, gt);
    }
    const float w = grad[m];
    const float wp = __fmul_rn(w, __fdiv_rn(power, (float)n_s));
    v[0] = __fmul_rn(wp, sx);
    v[1] = __fmul_rn(wp, sz);
    v[2] = __fmul_rn(wp, sy);
    v[3] = __fmul_rn(wp, syu);
    v[4] = __fmul_rn(w, __fdiv_rn(sg, (float)n_s));
  }
  block_sum(sh, v);
  if (threadIdx.x == 0)
    for (int k = 0; k < N_GRAD; ++k) partials[N_GRAD * blockIdx.x + k] = sh[k][0];
}

__global__ void __launch_bounds__(THREADS) direct_grad_final_kernel(int n_blocks, const float* __restrict__ partials,
                                                                    float* __restrict__ out) {
  __shared__ float sh[N_GRAD][THREADS];
  float v[N_GRAD] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int blk = threadIdx.x; blk < n_blocks; blk += THREADS)
    for (int k = 0; k < N_GRAD; ++k) v[k] = __fadd_rn(v[k], partials[N_GRAD * blk + k]);
  block_sum(sh, v);
  if (threadIdx.x < N_GRAD) out[threadIdx.x] = sh[threadIdx.x][0];
}

inline unsigned blocks(int n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// C entry points (uvtrace_torch/_build.py:load): launch on `stream`, return
// cudaGetLastError(). The wrappers (uvtrace_torch/diff/direct.py) allocate
// the outputs and check the sizes: 0 < S M < 2^31. `points` selects the given
// points (a = points, b = c = null) over the triangles (a, b, c = v0, e1, e2);
// a null `perm` packs the rays in their input order.
extern "C" int shadow_sample_launch(uint32_t k0, uint32_t k1, int points, int n_s, int m, const float* xz,
                                    float base, float length, const float* a, const float* b, const float* c,
                                    const float* nrm, float* rod, float* dir, float* dist, float* g, int* key,
                                    void* stream) {
  shadow_sample_kernel<<<blocks(n_s * m), THREADS, 0, (cudaStream_t)stream>>>(k0, k1, points, n_s, m, xz, base, length,
                                                                              a, b, c, nrm, rod, dir, dist, g, key);
  return (int)cudaGetLastError();
}

extern "C" int pack_sorted_launch(int r, int n_out, int group, const int64_t* perm, const float* orig,
                                  const float* dir, float* out_orig, float* out_dir, int* inverse, void* stream) {
  pack_sorted_kernel<<<blocks(n_out), THREADS, 0, (cudaStream_t)stream>>>(r, n_out, group, perm, orig, dir, out_orig,
                                                                           out_dir, inverse);
  return (int)cudaGetLastError();
}

extern "C" int visibility_reduce_launch(int n_s, int m, float scale, float offset, float power, const float* t,
                                        const int* inverse, const float* dist, const float* g, float* e,
                                        uint8_t* vis, void* stream) {
  visibility_reduce_kernel<<<blocks(m), THREADS, 0, (cudaStream_t)stream>>>(n_s, m, scale, offset, power, t, inverse,
                                                                            dist, g, e, vis);
  return (int)cudaGetLastError();
}

// Two launches on one stream: the blocks' partials (f32[blocks(m), 5]) and
// their fixed-order sum into out f32[5].
extern "C" int direct_grad_launch(uint32_t k0, uint32_t k1, int points, int n_s, int m, const float* xz, float base,
                                  float length, float power, const float* a, const float* b, const float* c,
                                  const float* nrm, const float* grad, const uint8_t* vis, float* partials,
                                  float* out, void* stream) {
  const unsigned n_blocks = blocks(m);
  direct_grad_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(k0, k1, points, n_s, m, xz, base, length, power,
                                                                     a, b, c, nrm, grad, vis, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  direct_grad_final_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>((int)n_blocks, partials, out);
  return (int)cudaGetLastError();
}
