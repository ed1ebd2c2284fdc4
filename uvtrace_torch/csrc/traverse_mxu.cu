// Split trace (+ optional histogram) over rays in memory, for Hopper (sm_90a):
// a per-ray near-first walk over a tree of two levels, a top tree of the
// scene's clusters whose leaves are the roots of sub-trees over each
// cluster's triangles.
//
// Replaces the TPU kernel uvtrace/ops/traverse_mxu.py:_traverse_mxu_padded
// (:445, body _kernel + _trace), which `traverse_mxu_slots`,
// `traverse_mxu_counts` and `traverse_mxu` launch. It computes what that
// kernel outputs, not how it is built. One thread traces one ray, over the
// whole launch, in blocks of THREADS:
//   - the ray's 10 Plücker features (d, m = o x d, o, 1), with the cross
//     product in the operation order of the plain version's `ray_features`,
//     and inv = 1 / (d == 0 ? 1e-30 : d); on a zero direction axis the slab
//     test culls by the origin alone (straight-down probes);
//   - its own stack of (node, lo) pairs, STACK_DEPTH deep (the wrapper raises
//     on a deeper tree). The tree (ops/traverse_mxu.py:walk_tree) is the top
//     tree over the cluster boxes, each of whose leaves is the root of a
//     binary tree over the cluster's real triangles with leaves of at most 4
//     (SUB_LEAF; padded slots lie in no leaf), all in one node array: an
//     inner node is (left child, -1), its right child next to it, a leaf
//     (first, count), a range of the triangles in leaf order. At an inner
//     node both children are slab-tested and each one the ray may hit at or
//     before its best t is pushed, the far one first, so that the near one is
//     popped next. A popped node is tested again against the best t, which
//     may have shrunk since the push;
//   - at a leaf, its triangles with the shared leaf arithmetic of
//     trace_common.cuh (`plucker_dot`, `keep_hit`), each keyed by its slot in
//     the cluster slot space (cid * C + j, stored beside it): four dot
//     products of 10 __fmaf_rn in row order, the hit rule, the lexicographic
//     (t, slot) minimum. The triangle-major features in leaf order
//     (f32[T][10][4]) make a triangle 160 contiguous bytes, 10 LDG.128 per
//     ray, and a leaf's triangles one run of them;
//   - t, slot and the per-slot histogram out with trace_common.cuh's
//     `write_hit`, and per packet the number of (ray, leaf) tests and of
//     (ray, triangle) tests its rays made (warp sums, then one atomicAdd
//     each); when the wrapper passes totals (tracing), each warp adds both
//     sums to them too.
// The visit rule is conservative. With lo = max(entry, 0) and exit of the f32
// slab test of the node's box grown by 2^-16 (1 + |o|_inf) on every side, a
// node is visited while
//     lo <= min(exit, best t * (1 + 2^-4)),
// never on a strict `<`: the (t, slot) rule needs an equal-t leaf visited,
// and the slab's (box - o) * inv and the Plücker t round differently (a
// triangle in its leaf's box face, as on every axis-aligned wall, can get a
// t a few ulps below the entry; a small triangle far from the origin can lose
// 1e-4 of its t to cancellation; a ray grazing a wall, |n . d| near the hit
// rule's 1e-5, can get a t a few percent short; only t is that far off, so the
// exit takes no relative slack). A looser rule only costs work. A node's box
// holds its children's and the slab test rounds monotonically, so a leaf the
// rule keeps at the ray's final t has every ancestor kept too. Each ray keeps
// its lexicographic minimum, which does not depend on visit order, so where
// the rule visits every leaf that holds a hit at or before the ray's best t,
// the walk returns the brute-force result of the plain version
// (uvtrace_torch/ops/traverse_mxu.py:closest_hits). The slack was sized on
// adversarial ray families (corners, edges, axis-parallel, on-face and
// grazing rays; tests/test_torch_split_walk.py), not proved: no fixed slack
// covers a ray at |n . d| near 1e-5 on a triangle metres wide.
// Parked dead lanes (origin 1e6, direction (1,0,0)) miss the root at once; a
// NaN ray misses without harming its neighbours (NaN-propagating min/max).
//
// What bounds it: the L1/L2 traffic of the triangles a ray tests, 160 B per
// ray and triangle, and of the boxes, 32 B per ray and box, with 40 f32
// multiply-adds per ray and triangle (the whole scene's features, 7.2 MB at
// 45k triangles, stay in the 50 MB L2). The design gives each ray its own
// bound, so a ray tests only the leaves in front of its own best hit, of at
// most 4 triangles each, and it needs no block barrier and no shared memory:
// the scene's size is bounded by device memory only.
//
// Build: see fused_trace.cu (-fmad=false; the cross product and the slab test
// have no contraction, the dot products use __fmaf_rn).

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using uvt::BIG;
using uvt::KROWS;

constexpr int THREADS = 128;
constexpr int STACK_DEPTH = 64;
constexpr float MARGIN = 1.52587890625e-5f;  // 2^-16: boxes grow by MARGIN (1 + |o|_inf)
constexpr float GROW = 1.0625f;              // 1 + 2^-4: the best t grows by this factor

// jnp.minimum / jnp.maximum: a NaN operand gives NaN (fminf would drop it)
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }

// Slab test of one node box (min.xyz, max.xyz, 2 pads: two float4), grown by
// `grow` on every side, against one ray: lo = max(entry, 0) and the exit
// distance. On an axis where d is 0 (flat[ax]) the ray is in the slab for
// every t when min <= o <= max, faces included, and for none otherwise:
// (max - o) * 1e30 would put a ray that lies in a box's face at exit 0.
__device__ __forceinline__ void slab(const float4* __restrict__ box, const float o[3], const float inv[3],
                                     const bool flat[3], float grow, float& lo, float& ex) {
  const float4 a = __ldg(box), b = __ldg(box + 1);
  const float mn[3] = {a.x - grow, a.y - grow, a.z - grow}, mx[3] = {a.w + grow, b.x + grow, b.y + grow};
  float entry = -BIG, exit_ = BIG;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t1 = (mn[ax] - o[ax]) * inv[ax];
    const float t2 = (mx[ax] - o[ax]) * inv[ax];
    const bool inside = mn[ax] <= o[ax] && o[ax] <= mx[ax];
    entry = jmax(entry, flat[ax] ? (inside ? -BIG : BIG) : jmin(t1, t2));
    exit_ = jmin(exit_, flat[ax] ? (inside ? BIG : -BIG) : jmax(t1, t2));
  }
  lo = jmax(entry, 0.0f);
  ex = exit_;
}

// Quantity q of a triangle of the triangle-major features, row k: one
// component of the row's float4 (the four quantities' loads of a row are one
// LDG.128).
struct TriCol {
  const float4* tri;
  int q;
  __device__ __forceinline__ float operator()(int k) const {
    const float4 f = __ldg(tri + k);
    return q == 0 ? f.x : q == 1 ? f.y : q == 2 ? f.z : f.w;
  }
};

__global__ void __launch_bounds__(THREADS) traverse_mxu_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, int n, int packet,
    const float4* __restrict__ node_box, const int2* __restrict__ node_meta,
    const float4* __restrict__ leaf_feat, const int* __restrict__ leaf_slot, float* __restrict__ t_out,
    int* __restrict__ slot_out, int* __restrict__ counts, int* __restrict__ tests_out,
    int* __restrict__ tri_tests_out, unsigned long long* __restrict__ totals) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int tests = 0, tri_tests = 0;
  if (i < n) {
    float o[3], inv[3], r[KROWS];
    bool flat[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = orig[3 * (size_t)i + c];
      const float d = dir[3 * (size_t)i + c];
      flat[c] = d == 0.0f;
      inv[c] = 1.0f / (flat[c] ? 1e-30f : d);
      r[c] = d;
      r[6 + c] = o[c];
    }
    r[3] = o[1] * r[2] - o[2] * r[1];  // m = o x d
    r[4] = o[2] * r[0] - o[0] * r[2];
    r[5] = o[0] * r[1] - o[1] * r[0];
    r[9] = 1.0f;
    const float grow = MARGIN * (1.0f + fmaxf(fmaxf(fabsf(o[0]), fabsf(o[1])), fabsf(o[2])));

    unsigned long long best = uvt::key_of(BIG, 0xFFFFFFFFu);
    int st_node[STACK_DEPTH];
    float st_lo[STACK_DEPTH];
    int sp = 0;
    float lo, ex;
    slab(node_box, o, inv, flat, grow, lo, ex);
    if (lo <= jmin(ex, BIG * GROW)) {
      st_node[0] = 0;
      st_lo[0] = lo;
      sp = 1;
    }
    while (true) {
      // walk inner nodes until this ray holds a leaf or its stack is empty;
      // the warp's rays then test their leaves together
      int first = 0, count = -1;
      while (count < 0 && sp > 0) {
        --sp;
        const float bt = __uint_as_float((uint32_t)(best >> 32));
        if (!(st_lo[sp] <= bt * GROW)) continue;  // pruned by a hit found since the push
        const int2 meta = __ldg(node_meta + st_node[sp]);
        if (meta.y >= 0) {
          first = meta.x;
          count = meta.y;
          break;
        }
        // inner node: push the children the ray may hit, the far one first
        const int c1 = meta.x, c2 = meta.x + 1;
        float lo1, ex1, lo2, ex2;
        slab(node_box + 2 * c1, o, inv, flat, grow, lo1, ex1);
        slab(node_box + 2 * c2, o, inv, flat, grow, lo2, ex2);
        const bool v1 = lo1 <= jmin(ex1, bt * GROW);
        const bool v2 = lo2 <= jmin(ex2, bt * GROW);
        const bool near1 = lo1 <= lo2;  // ties: the left child is near
        if (near1 ? v2 : v1) {
          st_node[sp] = near1 ? c2 : c1;
          st_lo[sp] = near1 ? lo2 : lo1;
          ++sp;
        }
        if (near1 ? v1 : v2) {
          st_node[sp] = near1 ? c1 : c2;
          st_lo[sp] = near1 ? lo1 : lo2;
          ++sp;
        }
      }
      if (count < 0) break;
      // leaf: its triangles, each keyed by its cluster slot
      ++tests;
      tri_tests += count;
      for (int j = first; j < first + count; ++j) {
        float q4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) q4[q] = uvt::plucker_dot(TriCol{leaf_feat + (size_t)j * KROWS, q}, r);
        uvt::keep_hit(q4, (uint32_t)__ldg(leaf_slot + j), best);
      }
    }

    uvt::write_hit(best, (size_t)i, t_out, slot_out, counts);
  }
  // the packet's (ray, leaf) and (ray, triangle) tests: a warp's 32 rays lie
  // in one packet
  tests = __reduce_add_sync(0xffffffffu, tests);
  tri_tests = __reduce_add_sync(0xffffffffu, tri_tests);
  if ((threadIdx.x & 31) == 0 && i < n) {
    atomicAdd(tests_out + i / packet, tests);
    atomicAdd(tri_tests_out + i / packet, tri_tests);
    if (totals != nullptr) {
      atomicAdd(totals, (unsigned long long)tests);
      atomicAdd(totals + 1, (unsigned long long)tri_tests);
    }
  }
}

}  // namespace

// Launches ceil(n / THREADS) blocks on `stream`; `counts` may be null (slots
// only), `tests_out` and `tri_tests_out` (one int per packet) must hold
// zeros, `totals` (two int64: every (ray, leaf) and (ray, triangle) test) may
// be null. Returns cudaGetLastError() of the launch (0 on success); the
// caller raises on anything else.
extern "C" int traverse_mxu_launch(
    const float* orig, const float* dir, int n, int packet, const float* node_box, const int* node_meta,
    const float* leaf_feat, const int* leaf_slot, float* t_out, int* slot_out, int* counts, int* tests_out,
    int* tri_tests_out, long long* totals, void* stream) {
  if (n == 0) return 0;
  traverse_mxu_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      orig, dir, n, packet, reinterpret_cast<const float4*>(node_box), reinterpret_cast<const int2*>(node_meta),
      reinterpret_cast<const float4*>(leaf_feat), leaf_slot, t_out, slot_out, counts, tests_out, tri_tests_out,
      reinterpret_cast<unsigned long long*>(totals));
  return (int)cudaGetLastError();
}
