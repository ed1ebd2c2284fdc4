// Split trace (+ optional histogram) over rays in memory, for Hopper (sm_90a).
//
// Replaces the TPU kernel uvtrace/ops/traverse_mxu.py:_traverse_mxu_padded
// (:445, body _kernel + _trace), which `traverse_mxu_slots`,
// `traverse_mxu_counts` and `traverse_mxu` launch. It computes what that
// kernel outputs, not how it is built. One block traces one packet of P rays
// (P = 1024 for primaries and probes, 4096 for bounce segments):
//   1. reads the packet's origins and directions from device memory, and
//      block-reduces their per-axis min and max into the packet frustum, as
//      the TPU wrapper does before its launch (:471-480);
//   2-4. runs the shared trace body (trace_common.cuh): the conservative slab
//      test against every cluster AABB with the one-sided half-line rule, the
//      near-first visit while entry <= the packet bound, f32 Plücker dot
//      products with explicit __fmaf_rn in row order, the lexicographic
//      (t, slot) minimum per ray, and an integer atomicAdd per hit into the
//      per-slot counts when they are asked for.
// Slots are -1 and t is 1e30 on a miss, as the TPU wrapper returns (:535).
//
// What bounds it: as in the fused kernel, the 40 multiply-adds per ray and
// triangle of every visited cluster; the feature tiles stay in the 50 MB L2
// and are staged in shared memory one cluster at a time. Incoherent packets
// (bounce segments) are the expensive case: their frustum spans most of the
// room, and only the near-first early exit prunes. Shared memory is what
// limits the packet and the scene: 8 B per ray for the best key, 8 B per
// cluster for the candidate key and one 20 KB tile at C=128. The design
// therefore does not stage ray features in shared memory (40 B per ray would
// put P=4096 at 217 KB and cap the scene near 1,870 clusters); each thread
// reloads its rays' 24 bytes from L1/L2 per visit and recomputes m = o x d in
// registers, in the operation order of `ray_features`. At P=4096 a block
// needs 53,632 + 8 L bytes at C=128: about 22,000 clusters fit the 232,448-byte
// limit (the wrapper raises with the numbers beyond it).
// Parked dead lanes (origin 1e6, direction (1,0,0)) make an all-dead packet
// cull every cluster at once: its exit distance is negative on x.
//
// Build: see fused_trace.cu (-fmad=false; the cross product has no
// contraction, the dot products use __fmaf_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using uvt::BIG;
using uvt::KROWS;

size_t smem_bytes(int packet, int n_clusters, int csz) { return uvt::smem_bytes(packet, n_clusters, csz, 0); }

// Ray features (d, m = o x d, o, 1) of rays in device memory, f32[3] each.
struct GlobalRays {
  const float* o;
  const float* d;
  __device__ __forceinline__ void operator()(int lane, float r[KROWS]) const {
    const float ox = o[3 * lane + 0], oy = o[3 * lane + 1], oz = o[3 * lane + 2];
    const float dx = d[3 * lane + 0], dy = d[3 * lane + 1], dz = d[3 * lane + 2];
    r[0] = dx;
    r[1] = dy;
    r[2] = dz;
    r[3] = oy * dz - oz * dy;
    r[4] = oz * dx - ox * dz;
    r[5] = ox * dy - oy * dx;
    r[6] = ox;
    r[7] = oy;
    r[8] = oz;
    r[9] = 1.0f;
  }
};

__global__ void traverse_mxu_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, int packet, int n_clusters, int csz,
    const float* __restrict__ box6, const float* __restrict__ feat10,
    float* __restrict__ t_out, int* __restrict__ slot_out, int* __restrict__ counts,
    int* __restrict__ visits_out) {
  extern __shared__ unsigned long long smem[];
  const uvt::Smem s = uvt::carve_smem(smem, packet, n_clusters, csz, 0);
  const size_t ray0 = (size_t)blockIdx.x * packet;
  const GlobalRays rays{orig + 3 * ray0, dir + 3 * ray0};

  // ---- 1. the packet's frustum: per-axis min and max of o and d -----------
  // neg[k] holds -min for k < 6 (o.xyz, d.xyz) and max[k] the max, so that
  // one max-reduction serves both
  float neg[6], mx[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) neg[k] = mx[k] = -INFINITY;
  for (int lane = threadIdx.x; lane < packet; lane += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float o = rays.o[3 * lane + k], d = rays.d[3 * lane + k];
      neg[k] = fmaxf(neg[k], -o);
      mx[k] = fmaxf(mx[k], o);
      neg[3 + k] = fmaxf(neg[3 + k], -d);
      mx[3 + k] = fmaxf(mx[3 + k], d);
    }
    s.best[lane] = uvt::key_of(BIG, 0xFFFFFFFFu);
  }
  float o_lo[3], o_hi[3], d_lo[3], d_hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_lo[k] = -uvt::block_max_f32(neg[k], s.red32);
    o_hi[k] = uvt::block_max_f32(mx[k], s.red32);
    d_lo[k] = -uvt::block_max_f32(neg[3 + k], s.red32);
    d_hi[k] = uvt::block_max_f32(mx[3 + k], s.red32);
  }

  // ---- 2-4. cull, near-first visits, outputs and histogram ----------------
  uvt::cull_clusters(o_lo, o_hi, d_lo, d_hi, box6, n_clusters, s.cand);
  const int visits = uvt::visit_near_first(rays, packet, n_clusters, csz, feat10, s);
  uvt::write_hits(s.best, packet, ray0, t_out, slot_out, counts);
  if (threadIdx.x == 0) visits_out[blockIdx.x] = visits;
}

}  // namespace

extern "C" size_t traverse_mxu_smem_bytes(int packet, int n_clusters, int csz) {
  return smem_bytes(packet, n_clusters, csz);
}

// Launches one block per packet on `stream`; `counts` may be null (slots
// only). Returns cudaGetLastError() of the launch (0 on success); the caller
// raises on anything else.
extern "C" int traverse_mxu_launch(
    const float* orig, const float* dir, int packets, int packet, int n_clusters, int csz,
    const float* box6, const float* feat10, float* t_out, int* slot_out, int* counts,
    int* visits_out, void* stream) {
  const int threads = packet % 256 == 0 ? 256 : 128;
  const size_t smem = smem_bytes(packet, n_clusters, csz);
  cudaError_t err = cudaFuncSetAttribute(traverse_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  traverse_mxu_kernel<<<packets, threads, smem, (cudaStream_t)stream>>>(
      orig, dir, packet, n_clusters, csz, box6, feat10, t_out, slot_out, counts, visits_out);
  return (int)cudaGetLastError();
}
