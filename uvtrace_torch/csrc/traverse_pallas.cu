// Gen-1 packet DFS over a top tree of cluster AABBs, for Hopper (sm_90a).
//
// Replaces the TPU kernel uvtrace/ops/traverse_pallas.py:_traverse_pallas_padded
// (:242, body _kernel :164-238 and _mt_columns :101-161), which
// `traverse_pallas` launches. It computes what that kernel outputs, with its
// visit order and tie rules, not how it is built. One block of 256 threads
// traces one packet of 1024 consecutive rays; each thread holds R = 4 of them,
// ray lane = threadIdx.x + k * 256:
//   - one DFS per packet with one shared stack of STACK_DEPTH node ids, pushed
//     by thread 0; every decision is block-uniform, so each thread keeps the
//     same stack pointer and packet bound in registers;
//   - inner node: both children are slab-tested against every ray
//     (inv = 1 / (d == 0 ? 1e-30 : d), NaN-propagating min/max as jnp's);
//     a child is pushed when some ray hits it with tmin < packet bound and
//     tmin < its own best t (one warp vote, then one shared-memory pass); the
//     child with the larger least entry over its hitting rays goes first, so
//     the near one (ties: the left) is popped next;
//   - leaf: a column of 8 consecutive rays (one TPU lane: 8 consecutive lanes
//     of one warp here, read from one __ballot_sync) is active when one of its
//     rays enters the cluster's box before its best t. The cluster's 9 x 128
//     triangle rows (v0, e1, e2) are staged in shared memory and every ray of
//     an active column runs Möller–Trumbore against the 128 triangles, in
//     _mt_columns' formulas and operation order, taking the lowest lane on
//     equal t and keeping it on a strict `<` (the first visited cluster wins a
//     tie between clusters). The packet bound becomes the block max of best t.
// Outputs t (1e30 on a miss) and the original triangle id tri_idx_flat[slot]
// (-1 on a miss), and per packet (leaf visits, active columns) when asked.
//
// What bounds it: the ray-triangle tests of the active columns, 8 rays x 128
// triangles x about 40 f32 operations each, and the block-wide barriers of
// the walk (2 per inner node, 4 per leaf): incoherent packets pop up to the
// whole tree (1,049 nodes at testroomopt's 525 clusters). The node arrays are
// read from global memory at one address per block (broadcast through L1);
// shared memory holds the stack and one triangle tile, about 5.2 KB, so the
// scene's size is bounded by device memory only.
//
// Build: -fmad=false (see _build.py). No product is contracted into a
// multiply-add and divisions are IEEE, so t is bit-equal to the plain PyTorch
// version (uvtrace_torch/ops/traverse_pallas.py:traverse_pallas_reference).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PACKET = 1024;
constexpr int STACK_DEPTH = 128;
constexpr int TRI_ROWS = 16;
constexpr int LANES = 128;
constexpr float BIG = 1e30f;

// jnp.minimum / jnp.maximum: a NaN operand gives NaN (fminf would drop it)
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }

// Slab test of one node box against one ray (uvtrace/ops/traverse_pallas.py:172-181).
__device__ __forceinline__ void slab(const float* __restrict__ box, const float o[3], const float inv[3],
                                     float& tmin, bool& hit) {
  float lo = -BIG, hi = BIG;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t1 = (__ldg(box + ax) - o[ax]) * inv[ax];
    const float t2 = (__ldg(box + ax + 3) - o[ax]) * inv[ax];
    lo = jmax(lo, jmin(t1, t2));
    hi = jmin(hi, jmax(t1, t2));
  }
  tmin = lo;
  hit = hi >= lo && hi > 0.0f;
}

// 256 threads of 4 rays, at most 85 registers, three blocks per SM, so that
// one block's barrier wait is covered by the others: on iid rays of the test
// room 51.0 ms per 2^20 rays against 77.8 ms for 1024 threads of one ray
// (NVIDIA H100, PERF.md).
constexpr int R = 4;
constexpr int T = PACKET / R;

__global__ void __launch_bounds__(T, 3) traverse_pallas_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, const float* __restrict__ node_box,
    const int* __restrict__ node_meta, const float* __restrict__ tri, const int* __restrict__ tri_idx_flat,
    float* __restrict__ t_out, int* __restrict__ hit_out, int* __restrict__ stats) {
  constexpr int W = T / 32;
  __shared__ int stack[STACK_DEPTH];
  __shared__ float tile[9 * LANES];
  __shared__ float red_a[W], red_b[W];
  __shared__ int red_v[W];
  __shared__ int col_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray0 = (size_t)blockIdx.x * PACKET;
  float o[R][3], d[R][3], inv[R][3], tb[R];
  int sl[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t r = ray0 + tid + k * T;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[k][c] = orig[3 * r + c];
      d[k][c] = dir[3 * r + c];
      inv[k][c] = 1.0f / (d[k][c] == 0.0f ? 1e-30f : d[k][c]);
    }
    tb[k] = BIG;
    sl[k] = -1;
  }
  if (tid == 0) {
    stack[0] = 0;
    col_total = 0;
  }
  __syncthreads();

  int sp = 1, leaves = 0, my_cols = 0;
  float t_ub = BIG;
  while (sp > 0) {
    const int node = stack[--sp];
    const int meta0 = __ldg(node_meta + 2 * node);
    if (__ldg(node_meta + 2 * node + 1) == 1) {
      // ---- leaf: column flags, then Möller–Trumbore on the active columns
      ++leaves;
      bool col[R];
      bool any = false;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tmin;
        bool hit;
        slab(node_box + 8 * node, o[k], inv[k], tmin, hit);
        const unsigned vote = __ballot_sync(0xffffffffu, hit && tmin < tb[k]);
        col[k] = ((vote >> (lane & 24)) & 0xFFu) != 0;  // the 8 lanes of this ray's column
        any |= col[k];
        my_cols += (lane & 7) == 0 && col[k];
      }
      if (__syncthreads_or(any)) {
        const float* src = tri + (size_t)meta0 * TRI_ROWS * LANES;
        for (int i = tid; i < 9 * LANES; i += T) tile[i] = src[i];
        __syncthreads();
        float best[R];
        int arg[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          best[k] = INFINITY;
          arg[k] = 0;
        }
        for (int j = 0; j < LANES; ++j) {
          const float v0x = tile[0 * LANES + j], v0y = tile[1 * LANES + j], v0z = tile[2 * LANES + j];
          const float e1x = tile[3 * LANES + j], e1y = tile[4 * LANES + j], e1z = tile[5 * LANES + j];
          const float e2x = tile[6 * LANES + j], e2y = tile[7 * LANES + j], e2z = tile[8 * LANES + j];
#pragma unroll
          for (int k = 0; k < R; ++k) {
            if (!col[k]) continue;
            const float cdx = d[k][0], cdy = d[k][1], cdz = d[k][2];
            const float hx = cdy * e2z - cdz * e2y;
            const float hy = cdz * e2x - cdx * e2z;
            const float hz = cdx * e2y - cdy * e2x;
            const float a = e1x * hx + e1y * hy + e1z * hz;
            const float f = 1.0f / (a == 0.0f ? 1.0f : a);
            const float sx = o[k][0] - v0x, sy = o[k][1] - v0y, sz = o[k][2] - v0z;
            const float u = f * (sx * hx + sy * hy + sz * hz);
            const float qx = sy * e1z - sz * e1y;
            const float qy = sz * e1x - sx * e1z;
            const float qz = sx * e1y - sy * e1x;
            const float v = f * (cdx * qx + cdy * qy + cdz * qz);
            const float t = f * (e2x * qx + e2y * qy + e2z * qz);
            const bool valid = fabsf(a) >= 1e-5f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                               t > 1e-4f;
            const float tj = valid ? t : BIG;
            if (tj < best[k]) {  // min over lanes, the lowest lane on equal t
              best[k] = tj;
              arg[k] = j;
            }
          }
        }
        float mx = 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (col[k] && best[k] < tb[k]) {
            tb[k] = best[k];
            sl[k] = meta0 * LANES + arg[k];
          }
          mx = fmaxf(mx, tb[k]);
        }
        // the packet bound: block max of the best t
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane == 0) red_a[warp] = mx;
        __syncthreads();
        t_ub = red_a[0];
        for (int w = 1; w < W; ++w) t_ub = fmaxf(t_ub, red_a[w]);
      }
    } else {
      // ---- inner node: test both children, push the far one first
      const int c1 = meta0, c2 = meta0 + 1;
      bool v1 = false, v2 = false;
      float d1 = BIG, d2 = BIG;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tmin1, tmin2;
        bool m1, m2;
        slab(node_box + 8 * c1, o[k], inv[k], tmin1, m1);
        slab(node_box + 8 * c2, o[k], inv[k], tmin2, m2);
        v1 |= m1 && tmin1 < t_ub && tmin1 < tb[k];
        v2 |= m2 && tmin2 < t_ub && tmin2 < tb[k];
        d1 = fminf(d1, m1 ? tmin1 : BIG);  // a hitting ray's tmin is never NaN
        d2 = fminf(d2, m2 ? tmin2 : BIG);
      }
      const int votes = (__any_sync(0xffffffffu, v1) ? 1 : 0) | (__any_sync(0xffffffffu, v2) ? 2 : 0);
      for (int off = 16; off > 0; off >>= 1) {
        d1 = fminf(d1, __shfl_xor_sync(0xffffffffu, d1, off));
        d2 = fminf(d2, __shfl_xor_sync(0xffffffffu, d2, off));
      }
      if (lane == 0) {
        red_a[warp] = d1;
        red_b[warp] = d2;
        red_v[warp] = votes;
      }
      __syncthreads();
      int vv = red_v[0];
      d1 = red_a[0];
      d2 = red_b[0];
      for (int w = 1; w < W; ++w) {
        vv |= red_v[w];
        d1 = fminf(d1, red_a[w]);
        d2 = fminf(d2, red_b[w]);
      }
      const bool near_first = d1 <= d2;
      const int first = near_first ? c2 : c1, second = near_first ? c1 : c2;
      const bool v_first = (vv & (near_first ? 2 : 1)) != 0, v_second = (vv & (near_first ? 1 : 2)) != 0;
      if (tid == 0) {
        if (v_first) stack[sp] = first;
        if (v_second) stack[sp + (v_first ? 1 : 0)] = second;
      }
      sp += (v_first ? 1 : 0) + (v_second ? 1 : 0);
    }
    __syncthreads();  // the stack write is visible and the reduction slots are free
  }

#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t r = ray0 + tid + k * T;
    const bool miss = tb[k] >= BIG || sl[k] < 0;
    t_out[r] = tb[k];
    hit_out[r] = miss ? -1 : tri_idx_flat[sl[k]];
  }
  if (stats != nullptr) {
    atomicAdd(&col_total, my_cols);
    __syncthreads();
    if (tid == 0) {
      stats[2 * blockIdx.x] = leaves;
      stats[2 * blockIdx.x + 1] = col_total;
    }
  }
}

}  // namespace

// Launches one block per packet of 1024 rays on `stream`; `stats` may be
// null. Returns cudaGetLastError() of the launch (0 on success); the caller
// raises on anything else.
extern "C" int traverse_pallas_launch(const float* orig, const float* dir, int packets, const float* node_box,
                                      const int* node_meta, const float* tri, const int* tri_idx_flat,
                                      float* t_out, int* hit_out, int* stats, void* stream) {
  traverse_pallas_kernel<<<packets, T, 0, (cudaStream_t)stream>>>(orig, dir, node_box, node_meta, tri,
                                                                  tri_idx_flat, t_out, hit_out, stats);
  return (int)cudaGetLastError();
}
