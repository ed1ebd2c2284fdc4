// The launch layer's per-ray ops on the card for Hopper (sm_90a): three
// kernels, one thread per ray, each bit-equal to its plain PyTorch version.
//
//   bounce_step_kernel (K4): one Russian-roulette bounce step and the sort
//     key of the coherence sort, as uvtrace_torch/ops/bounce.py:
//     bounce_step_reference computes them (uvtrace/ops/bounce.py:24-84
//     `bounce_rays` with `cosine_hemisphere` and `orthonormal_basis`, and the
//     key of `coherence_sort` :111-121; XLA fusions inside the jitted launch
//     of uvtrace/sim/launch.py:226, no pl.pallas_call). Ray i gathers the
//     normal of its hit and orients it against the ray, draws its roulette
//     uniform, and if it survives (alive, a hit, u < rho) cosine-samples the
//     hemisphere in the Frisvad basis and starts at the hit point offset by
//     1e-3 n; a dead lane is parked at (1e6, (1, 0, 0)). The key is octant *
//     512 + origin cell (mod 8 per axis), 2^30 for a dead lane. The three
//     threefry keys (roulette; radius and azimuth, split from the direction
//     key) are split from the bounce key in the kernel, as rng.split does.
//   hit_histogram_kernel (K5): counts[ids[i]] += 1 in place for 0 <= ids[i]
//     < bins (and alive[i]), as ops/accumulate.py:hit_histogram_reference
//     (uvtrace/ops/accumulate.py:31-47, `counts_sort` and `counts_segment`,
//     which give the same counts). A miss does nothing.
//   texel_bin_kernel (K6): the texel binning of uvtrace/sim/launch.py:107-115
//     (`barycentrics` and `texel_ids` of uvtrace/ops/texel.py:68-100, then the
//     histogram) as ops/texel.py:texel_bin_reference: each alive hit's
//     barycentrics from the Gram system of its triangle, folded into the
//     lower half, its cell of the triangle's k x k grid, and one count into
//     the texel counts in place.
//
// Every f32 step is written with the _rn intrinsics in the plain version's
// operation order (each torch op rounds alone; the dot products over 3
// components are ((x0 y0 + x1 y1) + x2 y2), written so in the plain versions),
// so no multiply and add is contracted (the library is also built with
// -fmad=false). sqrt and division are the IEEE ones (torch's `-1.0 / x` is
// reciprocal(x) * -1, the same value), cosf and sinf the functions torch's
// CUDA kernels call, clamps propagate NaN as torch.clamp does, and a float
// goes to int32 with the conversion torch's CUDA cast uses (truncation,
// saturating, NaN -> 0).
//
// What bounds them: bytes. K4 reads 41 B a ray and the normal and
// reflectance of its hit, and writes 33 B; its operations (a threefry draw a
// hit, two more a survivor, the keys' four splits, about 60 f32 steps) take
// a third of the issue rate's time for those bytes. K5 reads 4-5 B an id and
// adds into the bins it touches; K6 reads 33 B a ray and 44 B of its
// triangle, and about 50 f32 steps a hit. The plain versions spend a launch
// on every step (about 40 a bounce step, 20 a texel binning), and the
// `index_add_` histogram they replace sent every miss to one overflow bin,
// so that nearly every lane of a late bounce segment added into one address.
// Here a miss adds nothing, and the lanes of a warp that add into one bin
// add together: one atomicAdd per distinct bin (__match_any_sync); integer
// adds are exact in any order. The design keeps every intermediate in
// registers, one thread per ray in 256-thread blocks, rays as f32[n, 3]
// rows (3 strided accesses a thread that the L2 merges into whole lines).
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
constexpr float TWO_PI_F = 0x1.921fb6p+2f;  // f32(2 pi), as generate.py's TWO_PI
constexpr float EPS = 0x1.0624dep-10f;      // f32(1e-3), bounce.py's _EPS
constexpr float DET_MIN = 0x1.79ca1p-67f;   // f32(1e-20), texel.py's determinant floor
constexpr float PARK = 1e6f;                // a dead lane's origin
constexpr int DEAD_KEY = 1 << 30;

__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)), __fmul_rn(x2, y2));
}

// torch.clamp(x, lo, hi) on the card: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// Adds 1 to counts[id] for every lane with `valid`; the lanes of the warp
// with one id add together, by one atomicAdd. Every lane of the warp calls it.
__device__ __forceinline__ void add_one(int* counts, int id, bool valid) {
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? id : -1);
  if (valid && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(counts + id, __popc(peers));
}

__global__ void __launch_bounds__(THREADS) bounce_step_kernel(
    uint32_t kb0, uint32_t kb1, int n, float cell_meters, const float* __restrict__ orig,
    const float* __restrict__ dir, const float* __restrict__ t_hit, const int* __restrict__ hit,
    const bool* __restrict__ alive, const float* __restrict__ normals, const float* __restrict__ reflectance,
    float* __restrict__ out_orig, float* __restrict__ out_dir, bool* __restrict__ out_alive,
    int* __restrict__ out_key) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t o = 3 * (size_t)i;
  const int h = hit[i];
  // the bounce key splits into the roulette key and the direction key
  // (bounce.py: k_rr, k_dir = split(key)), the direction key into the
  // radius and azimuth keys (cosine_hemisphere: k1, k2 = split(k_dir))
  const Key kb = make_key(kb0, kb1);
  bool live = alive[i] && h >= 0;
  if (live) live = uniform_at(split_key(kb, 0), (uint32_t)i, 0.0f, 1.0f) < reflectance[h];
  if (!live) {
    out_orig[o] = out_orig[o + 1] = out_orig[o + 2] = PARK;
    out_dir[o] = 1.0f;
    out_dir[o + 1] = out_dir[o + 2] = 0.0f;
    out_alive[i] = false;
    out_key[i] = DEAD_KEY;
    return;
  }
  const float d0 = dir[o], d1 = dir[o + 1], d2 = dir[o + 2];
  float n0 = normals[3 * (size_t)h], n1 = normals[3 * (size_t)h + 1], n2 = normals[3 * (size_t)h + 2];
  if (dot3(n0, n1, n2, d0, d1, d2) > 0.0f) {  // face the normal against the ray
    n0 = -n0;
    n1 = -n1;
    n2 = -n2;
  }
  const float t = t_hit[i];
  const float p0 = __fadd_rn(orig[o], __fmul_rn(t, d0));
  const float p1 = __fadd_rn(orig[o + 1], __fmul_rn(t, d1));
  const float p2 = __fadd_rn(orig[o + 2], __fmul_rn(t, d2));
  // cosine_hemisphere
  const Key k_dir = split_key(kb, 1);
  const float u1 = uniform_at(split_key(k_dir, 0), (uint32_t)i, 0.0f, 1.0f);
  const float u2 = uniform_at(split_key(k_dir, 1), (uint32_t)i, 0.0f, 1.0f);
  const float r = __fsqrt_rn(u1);
  const float phi = __fmul_rn(TWO_PI_F, u2);
  const float x = __fmul_rn(r, cosf(phi));
  const float y = __fmul_rn(r, sinf(phi));
  const float z = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, u1), 0.0f));
  // orthonormal_basis (Frisvad): s = +-1, so the products by s are exact
  const float s = n2 >= 0.0f ? 1.0f : -1.0f;
  const float a = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(s, n2)), -1.0f);
  const float b = __fmul_rn(__fmul_rn(n0, n1), a);
  const float t10 = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(s, __fmul_rn(n0, n0)), a));
  const float t11 = __fmul_rn(s, b);
  const float t12 = __fmul_rn(-s, n0);
  const float t20 = b;
  const float t21 = __fadd_rn(s, __fmul_rn(__fmul_rn(n1, n1), a));
  const float t22 = -n1;
  // x t1 + y t2 + z n, and the origin p + 1e-3 n
  const float nd0 = __fadd_rn(__fadd_rn(__fmul_rn(x, t10), __fmul_rn(y, t20)), __fmul_rn(z, n0));
  const float nd1 = __fadd_rn(__fadd_rn(__fmul_rn(x, t11), __fmul_rn(y, t21)), __fmul_rn(z, n1));
  const float nd2 = __fadd_rn(__fadd_rn(__fmul_rn(x, t12), __fmul_rn(y, t22)), __fmul_rn(z, n2));
  const float no0 = __fadd_rn(p0, __fmul_rn(EPS, n0));
  const float no1 = __fadd_rn(p1, __fmul_rn(EPS, n1));
  const float no2 = __fadd_rn(p2, __fmul_rn(EPS, n2));
  out_orig[o] = no0;
  out_orig[o + 1] = no1;
  out_orig[o + 2] = no2;
  out_dir[o] = nd0;
  out_dir[o + 1] = nd1;
  out_dir[o + 2] = nd2;
  out_alive[i] = true;
  // coherence_key: direction octant, then the origin's cell mod 8 per axis
  const int oct = (nd0 >= 0.0f ? 4 : 0) + (nd1 >= 0.0f ? 2 : 0) + (nd2 >= 0.0f ? 1 : 0);
  int cell = ((int)floorf(__fdiv_rn(no0, cell_meters))) & 7;
  cell = cell * 8 + (((int)floorf(__fdiv_rn(no1, cell_meters))) & 7);
  cell = cell * 8 + (((int)floorf(__fdiv_rn(no2, cell_meters))) & 7);
  out_key[i] = oct * 512 + cell;
}

__global__ void __launch_bounds__(THREADS) hit_histogram_kernel(int n, int bins, const int* __restrict__ ids,
                                                                const bool* __restrict__ alive,
                                                                int* __restrict__ counts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int id = -1;
  if (i < n && (alive == nullptr || alive[i])) id = ids[i];
  add_one(counts, id, (unsigned)id < (unsigned)bins);
}

__global__ void __launch_bounds__(THREADS) texel_bin_kernel(
    int n, int n_texels, const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ t_hit, const int* __restrict__ hit, const bool* __restrict__ alive,
    const float* __restrict__ v0, const float* __restrict__ e1, const float* __restrict__ e2,
    const int* __restrict__ base, const int* __restrict__ k, int* __restrict__ counts) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int slot = -1;
  const int h = i < n ? hit[i] : -1;
  if (h >= 0 && (alive == nullptr || alive[i])) {
    const size_t o = 3 * (size_t)i, g = 3 * (size_t)h;
    // barycentrics: p = o + t d, w = p - v0, the Gram system of (e1, e2)
    const float t = t_hit[i];
    const float w0 = __fsub_rn(__fadd_rn(orig[o], __fmul_rn(t, dir[o])), v0[g]);
    const float w1 = __fsub_rn(__fadd_rn(orig[o + 1], __fmul_rn(t, dir[o + 1])), v0[g + 1]);
    const float w2 = __fsub_rn(__fadd_rn(orig[o + 2], __fmul_rn(t, dir[o + 2])), v0[g + 2]);
    const float a0 = e1[g], a1 = e1[g + 1], a2 = e1[g + 2];
    const float b0 = e2[g], b1 = e2[g + 1], b2 = e2[g + 2];
    const float a = dot3(a0, a1, a2, a0, a1, a2);
    const float b = dot3(a0, a1, a2, b0, b1, b2);
    const float c = dot3(b0, b1, b2, b0, b1, b2);
    const float d1 = dot3(w0, w1, w2, a0, a1, a2);
    const float d2 = dot3(w0, w1, w2, b0, b1, b2);
    float det = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b));
    det = isnan(det) ? det : fmaxf(det, DET_MIN);  // torch.clamp_min keeps NaN
    const float u = __fdiv_rn(__fsub_rn(__fmul_rn(c, d1), __fmul_rn(b, d2)), det);
    const float v = __fdiv_rn(__fsub_rn(__fmul_rn(a, d2), __fmul_rn(b, d1)), det);
    // texel_ids: clamp, fold u + v > 1 onto the lower triangle, the cell
    const int ki = k[h];
    const float kf = (float)ki;
    float uu = clamp_nan(u, 0.0f, 1.0f), vv = clamp_nan(v, 0.0f, 1.0f);
    if (__fadd_rn(uu, vv) > 1.0f) {
      uu = __fsub_rn(1.0f, uu);
      vv = __fsub_rn(1.0f, vv);
    }
    const int ix = min((int)__fmul_rn(uu, kf), ki - 1);
    const int iy = min((int)__fmul_rn(vv, kf), ki - 1);
    slot = base[h] + iy * ki + ix;
  }
  add_one(counts, slot, (unsigned)slot < (unsigned)n_texels);
}

inline unsigned blocks(int n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// C entry points (uvtrace_torch/_build.py:load): launch on `stream`, return
// cudaGetLastError(). 0 < n < 2^31; the wrappers allocate the outputs; a null
// `alive` counts every lane.
extern "C" int bounce_step_launch(uint32_t kb0, uint32_t kb1, int n, float cell_meters, const float* orig,
                                  const float* dir, const float* t_hit, const int* hit, const bool* alive,
                                  const float* normals, const float* reflectance, float* out_orig, float* out_dir,
                                  bool* out_alive, int* out_key, void* stream) {
  bounce_step_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      kb0, kb1, n, cell_meters, orig, dir, t_hit, hit, alive, normals, reflectance, out_orig, out_dir, out_alive,
      out_key);
  return (int)cudaGetLastError();
}

extern "C" int hit_histogram_launch(int n, int bins, const int* ids, const bool* alive, int* counts, void* stream) {
  hit_histogram_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(n, bins, ids, alive, counts);
  return (int)cudaGetLastError();
}

extern "C" int texel_bin_launch(int n, int n_texels, const float* orig, const float* dir, const float* t_hit,
                                const int* hit, const bool* alive, const float* v0, const float* e1, const float* e2,
                                const int* base, const int* k, int* counts, void* stream) {
  texel_bin_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(n, n_texels, orig, dir, t_hit, hit, alive, v0,
                                                                     e1, e2, base, k, counts);
  return (int)cudaGetLastError();
}
