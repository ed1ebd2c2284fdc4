// The samplers on the card for Hopper (sm_90a): three kernels, one thread per
// element, each bit-equal to its plain PyTorch version.
//
//   threefry_uniform_kernel (K1): `jax.random.uniform` of an f32 shape, as
//     uvtrace_torch/ops/rng.py:uniform_reference computes it. Element i is
//     threefry-2x32 (20 rounds) of the counter (0, i) under the key (k0, k1,
//     k0 ^ k1 ^ 0x1BD11BDA), its two words xor-ed; the top 23 bits under the
//     exponent of 1.0, minus 1, times (maxval - minval), plus minval, clamped
//     below at minval. Replaces the XLA fusion of jax.random.uniform that
//     uvtrace/ops/generate.py:111-117, uvtrace/ops/bounce.py:39-40,74 and
//     uvtrace/diff/estimator.py draw inside their jitted launches (no
//     pl.pallas_call).
//   generate_stratified_kernel (K2): the packet-stratified sampler of
//     uvtrace_torch/ops/generate.py:generate_stratified_reference (uvtrace/ops/
//     generate.py:140-182): ray i lies in stratum cell i / packet of the
//     (gh, gy, gphi) grid, drawn from three K1 uniforms (keys split(key, 3))
//     computed inline, and is written as origin and direction f32[n, 3].
//   generate_reference_kernel (K3): the reference sampler of uvtrace_torch/
//     ops/generate.py:generate_reference_reference (uvtrace/ops/generate.py:
//     44-101, cl/generate.cl:8-40): photon start + i seeds WangHash of an f32
//     sum of its int32 thread id and the lamp, then draws its rod height,
//     dir.y and (x, z) disc candidates from its own xorshift32 stream, at most
//     `rounds` redraws while the candidate lies outside the unit disc.
//
// The threefry block function and the uniform draw are threefry.cuh's,
// shared with the bounce step (launch_ops.cu).
//
// The plain versions run threefry and xorshift as separate int64 tensor ops
// masked to 32 bits (about 170 launches a K1 draw, about 1,600 a K3 chunk);
// uint32_t wraps here the way the masks do. Every f32 step is written with
// the _rn intrinsics in the plain version's operation order, so no multiply
// and add is contracted (the library is also built with -fmad=false), and
// sqrtf, cosf, sinf and division are CUDA's IEEE versions (no fast math):
// sqrt and division correctly rounded, as the plain versions' are (K3's goes
// through f64), cosf and sinf the functions torch's CUDA kernels call.
//
// What bounds them: K1 by its operations, K2 by operations and bytes alike,
// K3 by its bytes. A K1 element is 70 32-bit integer operations (20 rounds
// of add, rotate and xor, a rotate being one funnel shift, and the key
// injections, most folded into three-input adds) and 4 f32 ones for 4 bytes
// written: at one warp instruction a scheduler and clock they take about
// 1.9 x the time of its bytes. K2 is three of those, the cell's divisions
// and 31 f32 operations for 24 bytes; K3 a WangHash and 2 + 2 x 1.27
// xorshift32 draws (the disc test accepts pi / 4) for 24 bytes. The design
// keeps every intermediate in registers, one thread per element in
// 256-thread blocks, and writes each output once; K2 and K3 write their
// rays as f32[n, 3] rows (3 strided stores a thread that the L2 merges into
// whole lines).
//
// Build: uvtrace_torch/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using uvt::make_key;
using uvt::uniform_at;

constexpr int THREADS = 256;
constexpr float TWO_PI_F = 6.28318530717958647692f;  // f32(2 pi), as generate.py's TWO_PI
constexpr float UINT32_TO_UNIT = 0x1p-32f;           // f32(2.3283064365387e-10), cl/tools.cl:4

__global__ void __launch_bounds__(THREADS) threefry_uniform_kernel(uint32_t k0, uint32_t k1, float lo, float scale,
                                                                   uint32_t n, float* __restrict__ out) {
  const uint32_t i = blockIdx.x * (uint32_t)THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = uniform_at(make_key(k0, k1), i, lo, scale);
}

__global__ void __launch_bounds__(THREADS) generate_stratified_kernel(
    uint32_t ku0, uint32_t ku1, uint32_t ky0, uint32_t ky1, uint32_t kp0, uint32_t kp1, uint32_t n, uint32_t packet,
    uint32_t gh, uint32_t gy, uint32_t gphi, float lx, float ly, float lz, float llen, float* __restrict__ orig,
    float* __restrict__ dir) {
  const uint32_t i = blockIdx.x * (uint32_t)THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t cell = i / packet;
  const float ih = (float)(cell / (gy * gphi));
  const float iy = (float)((cell / gphi) % gy);
  const float ip = (float)(cell % gphi);
  const float uh = uniform_at(make_key(ku0, ku1), i, 0.0f, 1.0f);
  const float uy = uniform_at(make_key(ky0, ky1), i, 0.0f, 1.0f);
  const float up = uniform_at(make_key(kp0, kp1), i, 0.0f, 1.0f);
  const float u_height = __fdiv_rn(__fadd_rn(ih, uh), (float)gh);
  const float oy = __fadd_rn(ly, __fmul_rn(u_height, llen));
  const float dy = __fadd_rn(-1.0f, __fdiv_rn(__fmul_rn(2.0f, __fadd_rn(iy, uy)), (float)gy));
  const float phi = __fdiv_rn(__fmul_rn(TWO_PI_F, __fadd_rn(ip, up)), (float)gphi);
  const float r = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(dy, dy)), 0.0f));
  const size_t o = 3 * (size_t)i;
  orig[o] = lx;
  orig[o + 1] = oy;
  orig[o + 2] = lz;
  dir[o] = __fmul_rn(r, cosf(phi));
  dir[o + 1] = dy;
  dir[o + 2] = __fmul_rn(r, sinf(phi));
}

__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s = s * 9u;
  s = s ^ (s >> 4);
  s = s * 0x27D4EB2Du;
  return s ^ (s >> 15);
}

// RandomFloat (cl/tools.cl:3-4): one xorshift32 step, its state as f32 / (2^32 - 1).
__device__ __forceinline__ float random_float(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return __fmul_rn(__uint2float_rn(s), UINT32_TO_UNIT);
}

// rng.py:f32_to_u32_sat: NaN -> 0, clamp to [0, f32(2^32)], truncate, cap at 2^32 - 1.
__device__ __forceinline__ uint32_t f32_to_u32_sat(float x) {
  if (isnan(x)) return 0u;
  const unsigned long long v = (unsigned long long)fminf(fmaxf(x, 0.0f), 4294967296.0f);
  return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
}

__global__ void __launch_bounds__(THREADS) generate_reference_kernel(
    uint32_t n, uint32_t start, float c13, float c7, float c11, float c_seed, float lx, float ly, float lz, float llen,
    int rounds, float* __restrict__ orig, float* __restrict__ dir) {
  const uint32_t i = blockIdx.x * (uint32_t)THREADS + threadIdx.x;
  if (i >= n) return;
  // rng.py:photon_seeds: i32(tid * 17 + 1) in f32, plus the lamp's and the
  // seed's terms left to right, in f32
  const int32_t tid17 = (int32_t)((start + i) * 17u + 1u);
  float acc = __int2float_rn(tid17);
  acc = __fadd_rn(acc, c13);
  acc = __fadd_rn(acc, c7);
  acc = __fadd_rn(acc, c11);
  acc = __fadd_rn(acc, c_seed);
  uint32_t s = wang_hash(f32_to_u32_sat(acc));
  const float u_height = random_float(s);
  const float u_y = random_float(s);
  const float dy = __fsub_rn(__fmul_rn(u_y, 2.0f), 1.0f);
  const float xz_len = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(dy, dy)), 0.0f));
  float dx = __fsub_rn(__fmul_rn(random_float(s), 2.0f), 1.0f);
  float dz = __fsub_rn(__fmul_rn(random_float(s), 2.0f), 1.0f);
  // generate.py's REJECTION_ROUNDS masked rounds: a lane that accepted keeps
  // its candidate, so the loop may stop at its first acceptance
  for (int r = 0; r < rounds && __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)) > 1.0f; ++r) {
    dx = __fsub_rn(__fmul_rn(random_float(s), 2.0f), 1.0f);
    dz = __fsub_rn(__fmul_rn(random_float(s), 2.0f), 1.0f);
  }
  const float inv = __fdiv_rn(xz_len, __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz))));
  const size_t o = 3 * (size_t)i;
  orig[o] = lx;
  orig[o + 1] = __fadd_rn(ly, __fmul_rn(u_height, llen));
  orig[o + 2] = lz;
  dir[o] = __fmul_rn(dx, inv);
  dir[o + 1] = dy;
  dir[o + 2] = __fmul_rn(dz, inv);
}

inline unsigned blocks(uint32_t n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// C entry points (uvtrace_torch/_build.py:load): launch on `stream`, return
// cudaGetLastError(). n > 0; the wrappers allocate the outputs.
extern "C" int threefry_uniform_launch(uint32_t k0, uint32_t k1, float lo, float scale, uint32_t n, float* out,
                                       void* stream) {
  threefry_uniform_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(k0, k1, lo, scale, n, out);
  return (int)cudaGetLastError();
}

extern "C" int generate_stratified_launch(uint32_t ku0, uint32_t ku1, uint32_t ky0, uint32_t ky1, uint32_t kp0,
                                          uint32_t kp1, uint32_t n, uint32_t packet, uint32_t gh, uint32_t gy,
                                          uint32_t gphi, float lx, float ly, float lz, float llen, float* orig,
                                          float* dir, void* stream) {
  generate_stratified_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      ku0, ku1, ky0, ky1, kp0, kp1, n, packet, gh, gy, gphi, lx, ly, lz, llen, orig, dir);
  return (int)cudaGetLastError();
}

extern "C" int generate_reference_launch(uint32_t n, uint32_t start, float c13, float c7, float c11, float c_seed,
                                         float lx, float ly, float lz, float llen, int rounds, float* orig, float* dir,
                                         void* stream) {
  generate_reference_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      n, start, c13, c7, c11, c_seed, lx, ly, lz, llen, rounds, orig, dir);
  return (int)cudaGetLastError();
}
