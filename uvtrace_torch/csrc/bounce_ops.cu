// The differentiable layer's interreflection term on the card for Hopper
// (sm_90a): four kernels around the shadow-ray trace B2, each equal to its
// plain PyTorch version in uvtrace_torch/diff/bounce.py (bit for bit where the
// plain version fixes the order; K14 within the f32 order of its sums).
//
//   source_sample_kernel (K11): one thread per virtual point light m of M.
//     r = cdf[T-1] (1 - u_m) with u_m drawn from the choice key, the source
//     triangle the first index whose cumulative area reaches r (searchsorted,
//     left side, over the area CDF), u and v from the two keys split from the
//     point key with the fold onto the lower triangle, x_m = (v0 + u e1) +
//     v e2 and n_m its triangle's normal. Replaces
//     uvtrace/diff/estimator.py:404-413 (`jax.random.choice`, the draws and
//     the gathers of `_source_field`: XLA fusions, no pl.pallas_call).
//   transfer_rays_kernel (K12): one thread per receiver p of P, looping over
//     the B sources of a chunk (with fewer than 1024 receivers, as in the
//     64 x 64 source-to-source matrix, one thread per ray: the sources go over
//     the grid's y): ray i = b P + p from source b to receiver p,
//     its unit direction d / max(|d|, 1e-20) and unclamped length |d| (as
//     `shadow_rays`), the form factor without visibility
//       F = (|d.n_b| / sqrt(D)) (|d.n_p| / sqrt(D)) / (f32(pi) D),
//       D = max(d.d, 1e-12),
//     and the coherence key (octant * 512 + the source point's cell mod 8 per
//     axis, as ops/bounce.coherence_key). A receiver is drawn in the thread
//     from the receivers' key (the [S, T, 3] points of `bounce_irradiance`
//     never exist: element p = s T + t of the (S, T, 1) draws, on triangle
//     p mod T, K8's rule) or read as a given point (the dose image's, or the
//     sources themselves for the source-to-source matrix). Origins stay the
//     B source rows: K7 reads row i / P. Replaces :217-227, :230-250,
//     :425-430 and :466-480 (the [B, P, 3] temporaries, the distances, cosines
//     and the shadow rays: XLA fusions).
//   transfer_reduce_kernel (K13): visibility t[inverse[i]] >= dist (1 - eps)
//     - eps of each traced ray. Reduce mode, one thread per receiver:
//     part_p = sum_b s_b (F V) over the sources in order, added to the
//     chunks before (out = acc + part, chunk after chunk), and one visibility
//     byte a ray kept for the backward. Kept-visibility mode (t null): reduce
//     mode with V read from bytes an earlier traced reduce kept (a route's
//     transfer plan, diff/transfer.py), the same sum in the same order.
//     Matrix mode, one thread per ray: (F V) (1 - [b == p]), the M x M
//     source-to-source transfer. Replaces :431-443, :473-483 and :488 (the
//     comparison, the products and the chunk sums).
//   transfer_grad_kernel + transfer_grad_final_kernel (K14): the backward of
//     reduce mode with respect to the strengths, d s_b = sum_p g_p F_bp V_bp:
//     one thread per receiver redraws (or reads) its point, recomputes F of
//     its visible rays (K12's arithmetic; F is not kept: 4 B a ray against
//     the 1 B visibility), and the block sums each source's terms in a fixed
//     tree; the final kernel sums the blocks' partials in a fixed order. No
//     float atomics: a step's gradients repeat bit for bit. Replaces the
//     backward XLA derives for :480-483 (jax.grad).
//
// Every f32 step of K11-K13 is written with the _rn intrinsics in the plain
// version's operation order (dot products ((x0 y0 + x1 y1) + x2 y2) as
// ops/intersect.dot3), so nothing is contracted (the library is also built
// with -fmad=false); clamps propagate NaN as torch.clamp does.
//
// What bounds them: bytes. K12 writes 24 B a ray (direction, length, F, key)
// and reads a receiver's rows once per chunk; its two threefry draws and the
// key splits are a receiver's, not a ray's, and its ~50 f32 steps a ray take
// a fraction of the issue rate's time for those bytes. K13 reads 16 B a ray
// (t gathered through the inverse) and writes 1 B a ray and 4 B a receiver
// (kept-visibility mode reads 5 B a ray: F and its byte);
// K14 reads 1 B a ray and a receiver's rows and recomputes K12's F where a
// ray is visible. The eager ops they replace made about 60 launches a chunk
// and materialised [B, P, 3] f32 temporaries; autograd kept each chunk's
// [B, P] transfer for the backward.
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
constexpr int WARPS = THREADS / 32;
constexpr float PI_F = 0x1.921fb6p+1f;       // f32(pi)
constexpr float DIST_MIN = 0x1.79ca1p-67f;   // f32(1e-20): the direction's divisor floor
constexpr float DIST2_MIN = 0x1.197998p-40f; // f32(1e-12): the form factor's squared-distance floor

__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)), __fmul_rn(x2, y2));
}

// torch.clamp_min(x, lo) on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_min_nan(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// A point on triangle (a, b, c) = (v0, e1, e2) row g from the uniforms u, v
// folded onto the lower triangle: (v0 + u e1) + v e2.
__device__ __forceinline__ float3 triangle_point(float u, float v, const float* __restrict__ a,
                                                 const float* __restrict__ b, const float* __restrict__ c,
                                                 size_t g) {
  if (__fadd_rn(u, v) > 1.0f) {
    u = __fsub_rn(1.0f, u);
    v = __fsub_rn(1.0f, v);
  }
  return make_float3(__fadd_rn(__fadd_rn(a[g], __fmul_rn(u, b[g])), __fmul_rn(v, c[g])),
                     __fadd_rn(__fadd_rn(a[g + 1], __fmul_rn(u, b[g + 1])), __fmul_rn(v, c[g + 1])),
                     __fadd_rn(__fadd_rn(a[g + 2], __fmul_rn(u, b[g + 2])), __fmul_rn(v, c[g + 2])));
}

// Receiver p and its normal: drawn (element p of the (S, T, 1) draws of the
// keys split from the receivers' key, on triangle p mod T) or the given
// point a[p] with normal nrm[p].
struct Receiver {
  float3 q, n;
};

__device__ __forceinline__ Receiver receiver_of(uint32_t k0, uint32_t k1, int points, int p, int t_count,
                                                const float* __restrict__ a, const float* __restrict__ b,
                                                const float* __restrict__ c, const float* __restrict__ nrm) {
  if (points) {
    const size_t g = 3 * (size_t)p;
    return {make_float3(a[g], a[g + 1], a[g + 2]), make_float3(nrm[g], nrm[g + 1], nrm[g + 2])};
  }
  const Key key = make_key(k0, k1);
  const float u = uniform_at(split_key(key, 0), (uint32_t)p, 0.0f, 1.0f);
  const float v = uniform_at(split_key(key, 1), (uint32_t)p, 0.0f, 1.0f);
  const size_t g = 3 * (size_t)(p % t_count);
  return {triangle_point(u, v, a, b, c, g), make_float3(nrm[g], nrm[g + 1], nrm[g + 2])};
}

// The ray from source point x (normal n) to receiver r: d = q - x, the
// length |d| unclamped and the form factor without visibility.
struct Transfer {
  float d0, d1, d2, d2sum, len, f;
};

__device__ __forceinline__ Transfer transfer_of(const float* __restrict__ sx, const float* __restrict__ sn, int b,
                                                const Receiver& r) {
  Transfer tr;
  const size_t g = 3 * (size_t)b;
  tr.d0 = __fsub_rn(r.q.x, sx[g]);
  tr.d1 = __fsub_rn(r.q.y, sx[g + 1]);
  tr.d2 = __fsub_rn(r.q.z, sx[g + 2]);
  tr.d2sum = dot3(tr.d0, tr.d1, tr.d2, tr.d0, tr.d1, tr.d2);
  tr.len = __fsqrt_rn(tr.d2sum);
  const float dd = clamp_min_nan(tr.d2sum, DIST2_MIN);
  const float root = __fsqrt_rn(dd);
  const float cos_m = __fdiv_rn(fabsf(dot3(tr.d0, tr.d1, tr.d2, sn[g], sn[g + 1], sn[g + 2])), root);
  const float cos_p = __fdiv_rn(fabsf(dot3(tr.d0, tr.d1, tr.d2, r.n.x, r.n.y, r.n.z)), root);
  tr.f = __fdiv_rn(__fmul_rn(cos_m, cos_p), __fmul_rn(PI_F, dd));
  return tr;
}

__global__ void __launch_bounds__(THREADS) source_sample_kernel(
    uint32_t c0, uint32_t c1, uint32_t p0, uint32_t p1, int m_count, int t_count, const float* __restrict__ cdf,
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ nrm, int64_t* __restrict__ src, float* __restrict__ x, float* __restrict__ n) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= m_count) return;
  const float r = __fmul_rn(cdf[t_count - 1], __fsub_rn(1.0f, uniform_at(make_key(c0, c1), (uint32_t)m, 0.0f, 1.0f)));
  int lo = 0, hi = t_count;  // the first index whose cumulative area reaches r
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (cdf[mid] < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int s = lo < t_count ? lo : t_count - 1;  // r <= cdf[T-1]: lo < T, kept in bounds all the same
  const Key kp = make_key(p0, p1);
  const float u = uniform_at(split_key(kp, 0), (uint32_t)m, 0.0f, 1.0f);
  const float v = uniform_at(split_key(kp, 1), (uint32_t)m, 0.0f, 1.0f);
  const size_t g = 3 * (size_t)s, o = 3 * (size_t)m;
  const float3 q = triangle_point(u, v, a, b, c, g);
  src[m] = s;
  x[o] = q.x;
  x[o + 1] = q.y;
  x[o + 2] = q.z;
  n[o] = nrm[g];
  n[o + 1] = nrm[g + 1];
  n[o + 2] = nrm[g + 2];
}

// Sources [blockIdx.y per, (blockIdx.y + 1) per) of receiver p.
__global__ void __launch_bounds__(THREADS) transfer_rays_kernel(
    uint32_t k0, uint32_t k1, int points, int b_count, int p_count, int t_count, int per,
    const float* __restrict__ sx, const float* __restrict__ sn, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c, const float* __restrict__ nrm, float* __restrict__ dir,
    float* __restrict__ dist, float* __restrict__ f, int* __restrict__ key_out) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= p_count) return;
  const Receiver r = receiver_of(k0, k1, points, p, t_count, a, b, c, nrm);
  const int s_end = min(b_count, (int)(blockIdx.y + 1) * per);
  for (int s = blockIdx.y * per; s < s_end; ++s) {
    const Transfer tr = transfer_of(sx, sn, s, r);
    const float den = clamp_min_nan(tr.len, DIST_MIN);
    const float w0 = __fdiv_rn(tr.d0, den), w1 = __fdiv_rn(tr.d1, den), w2 = __fdiv_rn(tr.d2, den);
    const size_t i = (size_t)s * p_count + p, o = 3 * i, g = 3 * (size_t)s;
    dir[o] = w0;
    dir[o + 1] = w1;
    dir[o + 2] = w2;
    dist[i] = tr.len;
    f[i] = tr.f;
    // coherence_key at cell_meters 1: the direction's octant, the source point's cell
    const int oct = (w0 >= 0.0f ? 4 : 0) + (w1 >= 0.0f ? 2 : 0) + (w2 >= 0.0f ? 1 : 0);
    int cell = ((int)floorf(sx[g])) & 7;
    cell = cell * 8 + (((int)floorf(sx[g + 1])) & 7);
    cell = cell * 8 + (((int)floorf(sx[g + 2])) & 7);
    key_out[i] = oct * 512 + cell;
  }
}

// Reduce mode (strength != null): one thread per receiver p; with t null
// (kept-visibility mode) V is read from vis instead of traced. Matrix mode:
// one thread per ray, out[i] = (F V) (1 - [b == p]).
__global__ void __launch_bounds__(THREADS) transfer_reduce_kernel(
    int b_count, int p_count, float scale, float offset, const float* __restrict__ t,
    const int* __restrict__ inverse, const float* __restrict__ dist, const float* __restrict__ f,
    const float* __restrict__ strength, const float* acc, float* out, uint8_t* __restrict__ vis) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (!strength) {
    if (j >= b_count * p_count) return;
    const bool seen = t[inverse[j]] >= __fsub_rn(__fmul_rn(dist[j], scale), offset);
    const int s = j / p_count;
    out[j] = __fmul_rn(__fmul_rn(f[j], seen ? 1.0f : 0.0f), s == j - s * p_count ? 0.0f : 1.0f);
    return;
  }
  if (j >= p_count) return;
  float part = 0.0f;
  for (int s = 0; s < b_count; ++s) {
    const size_t i = (size_t)s * p_count + j;
    bool seen;
    if (t) {
      seen = t[inverse[i]] >= __fsub_rn(__fmul_rn(dist[i], scale), offset);
      vis[i] = seen;
    } else {
      seen = vis[i] != 0;
    }
    const float term = __fmul_rn(strength[s], __fmul_rn(f[i], seen ? 1.0f : 0.0f));
    part = s ? __fadd_rn(part, term) : term;
  }
  out[j] = acc ? __fadd_rn(acc[j], part) : part;
}

// The block's fixed-order sum of v over its threads (warp trees, then the
// warps' sums in order); thread 0 gets it. sh: WARPS floats.
__device__ __forceinline__ float block_sum(float* sh, float v) {
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    total = sh[0];
    for (int w = 1; w < WARPS; ++w) total = __fadd_rn(total, sh[w]);
  }
  __syncthreads();  // sh is free for the next sum
  return total;
}

__global__ void __launch_bounds__(THREADS) transfer_grad_kernel(
    uint32_t k0, uint32_t k1, int points, int b_count, int p_count, int t_count, const float* __restrict__ sx,
    const float* __restrict__ sn, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ nrm, const float* __restrict__ grad,
    const uint8_t* __restrict__ vis, float* __restrict__ partials) {
  __shared__ float sh[WARPS];
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool live = p < p_count;
  Receiver r{};
  float g = 0.0f;
  if (live) {
    r = receiver_of(k0, k1, points, p, t_count, a, b, c, nrm);
    g = grad[p];
  }
  for (int s = 0; s < b_count; ++s) {
    float v = 0.0f;
    if (live && vis[(size_t)s * p_count + p]) v = __fmul_rn(g, transfer_of(sx, sn, s, r).f);
    const float total = block_sum(sh, v);
    if (threadIdx.x == 0) partials[(size_t)blockIdx.x * b_count + s] = total;
  }
}

__global__ void __launch_bounds__(THREADS) transfer_grad_final_kernel(int n_blocks, int b_count,
                                                                      const float* __restrict__ partials,
                                                                      float* __restrict__ out) {
  __shared__ float sh[WARPS];
  for (int s = 0; s < b_count; ++s) {
    float v = 0.0f;
    for (int blk = threadIdx.x; blk < n_blocks; blk += THREADS) v = __fadd_rn(v, partials[(size_t)blk * b_count + s]);
    const float total = block_sum(sh, v);
    if (threadIdx.x == 0) out[s] = total;
  }
}

inline unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// C entry points (uvtrace_torch/_build.py:load): launch on `stream`, return
// cudaGetLastError(). The wrappers (uvtrace_torch/diff/bounce.py) allocate
// the outputs and check the sizes: 0 < B P < 2^31. `points` selects the given
// receivers (a = points, b = c = null, T unused) over the drawn ones (a, b, c
// = v0, e1, e2 of T triangles, P = S T).
extern "C" int source_sample_launch(uint32_t c0, uint32_t c1, uint32_t p0, uint32_t p1, int m, int t_count,
                                    const float* cdf, const float* a, const float* b, const float* c,
                                    const float* nrm, int64_t* src, float* x, float* n, void* stream) {
  source_sample_kernel<<<blocks(m), THREADS, 0, (cudaStream_t)stream>>>(c0, c1, p0, p1, m, t_count, cdf, a, b, c, nrm,
                                                                        src, x, n);
  return (int)cudaGetLastError();
}

extern "C" int transfer_rays_launch(uint32_t k0, uint32_t k1, int points, int b_count, int p_count, int t_count,
                                    const float* sx, const float* sn, const float* a, const float* b, const float* c,
                                    const float* nrm, float* dir, float* dist, float* f, int* key, void* stream) {
  // a thread takes every source of its receiver, or, with few receivers (the source-to-source matrix), one
  const int per = p_count >= 4 * THREADS && b_count > 0 ? b_count : 1;
  const dim3 grid(blocks(p_count), (unsigned)((b_count + per - 1) / per));
  transfer_rays_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(k0, k1, points, b_count, p_count, t_count, per, sx,
                                                                   sn, a, b, c, nrm, dir, dist, f, key);
  return (int)cudaGetLastError();
}

// strength null: matrix mode (out f32[B, P]); else reduce mode (out f32[P],
// acc null for the first chunk or the chunks' sum so far, which may be out),
// which writes vis, or with t null (inverse and dist unused) reads it.
extern "C" int transfer_reduce_launch(int b_count, int p_count, float scale, float offset, const float* t,
                                      const int* inverse, const float* dist, const float* f, const float* strength,
                                      const float* acc, float* out, uint8_t* vis, void* stream) {
  const long long n = strength ? (long long)p_count : (long long)b_count * p_count;
  transfer_reduce_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(b_count, p_count, scale, offset, t, inverse,
                                                                          dist, f, strength, acc, out, vis);
  return (int)cudaGetLastError();
}

// Two launches on one stream: the blocks' partials (f32[blocks(P), B]) and
// their fixed-order sum into out f32[B].
extern "C" int transfer_grad_launch(uint32_t k0, uint32_t k1, int points, int b_count, int p_count, int t_count,
                                    const float* sx, const float* sn, const float* a, const float* b, const float* c,
                                    const float* nrm, const float* grad, const uint8_t* vis, float* partials,
                                    float* out, void* stream) {
  const unsigned n_blocks = blocks(p_count);
  transfer_grad_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(k0, k1, points, b_count, p_count, t_count, sx,
                                                                       sn, a, b, c, nrm, grad, vis, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  transfer_grad_final_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>((int)n_blocks, b_count, partials, out);
  return (int)cudaGetLastError();
}
