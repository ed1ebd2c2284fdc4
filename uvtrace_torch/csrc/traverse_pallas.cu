// Gen-1 packet DFS over a top tree of cluster AABBs, for Hopper (sm_90a).
//
// Replaces the TPU kernel uvtrace/ops/traverse_pallas.py:_traverse_pallas_padded
// (:242, body _kernel :164-238 and _mt_columns :101-161), which
// `traverse_pallas` launches. It computes what that kernel outputs, with its
// visit order and tie rules, not how it is built. One block of 256 threads
// traces one packet of 1024 consecutive rays:
//   - the walk: one DFS per packet, every decision block-uniform, so each
//     thread keeps the same stack pointer and top of stack in registers;
//     thread 0 also writes the pushes to a shared stack of
//     STACK_DEPTH node ids, which is read only for an entry pushed at least
//     one barrier earlier. For the slab tests each thread owns R = 4 rays,
//     ray lane = threadIdx.x + k * 256, origin and 1 / direction in registers;
//   - inner node: both children (two float4 each) are slab-tested against
//     every ray (inv = 1 / (d == 0 ? 1e-30 : d), NaN-propagating min/max as
//     jnp's); a child is pushed when some ray hits it with tmin < its own best
//     t; the child with the larger least entry over
//     its hitting rays goes first, so the near one (ties: the left) is popped
//     next. One barrier: the warps' partial results go to one of two sets of
//     slots, which every warp reduces for itself;
//   - leaf: a column of 8 consecutive rays (one TPU lane: 8 consecutive lanes
//     of one warp here, read from one __ballot_sync) is active when one of its
//     rays enters the cluster's box before its best t. The warps append their
//     active columns to a shared list (one atomicAdd a warp), and after one
//     barrier the leaf's work is dealt out round-robin over the block's warps
//     in items of (active column, group of 32 triangles), or of a whole column
//     when the leaf has more than 128 such pairs. A warp's 32 lanes take the
//     group's 32 triangles (9 values in registers, from the cluster's slots in
//     use: the all-zero padding behind them hits nothing) and test them
//     against the column's 8 rays, read from the packet's copy in shared
//     memory. Every (ray, triangle) pair runs Möller–Trumbore in _mt_columns'
//     formulas and operation order; a ray's nearest t over the warp and the
//     lowest triangle among equal t come from two integer warp reductions (a
//     valid t is positive, so its bits order as unsigned integers) and go to
//     the item's slots in shared memory. After a second barrier each thread
//     gathers its own rays' results, the least (t, triangle) over its column's
//     items, and keeps it on a strict `<` against the ray's best t (the first
//     visited cluster wins a tie between clusters); best t and slot stay in
//     their owner's registers. The TPU kernel's packet bound, the max of best
//     t, is not computed: a ray's tmin < its best t implies tmin < the bound,
//     so the bound decides nothing.
// Outputs t (1e30 on a miss) and the original triangle id tri_idx_flat[slot]
// (-1 on a miss), and per packet (leaf visits, active columns) when asked.
//
// What bounds it: latency more than arithmetic. Incoherent packets pop up to
// the whole tree (1,049 nodes at testroomopt's 525 clusters, 298 leaves) and
// have few active columns a leaf (4.9 of 128 on iid rays of the test room);
// each pop is a chain of dependent loads, tests and one or two block barriers,
// and one packet alone takes milliseconds however idle the card is. The
// design shortens the chain (1 barrier per inner node, 1 per leaf and 1 more
// when a column is active; node boxes as float4; one-instruction NaN-keeping
// min/max) and spreads a leaf's ray-triangle tests, about 46 f32 operations
// each, over all 8 warps instead of leaving each column to the warp that owns
// its rays; four blocks an SM cover one another's waits. The node arrays and
// triangle tiles are read from global memory (one address per block for the
// nodes, coalesced rows for the tiles; L1 and L2 hold them); shared memory
// holds the packet's rays and the items' results, about 35 KB, so the scene's
// size is bounded by device memory only.
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
constexpr int LANES = 128;             // triangles of a cluster
constexpr int COLUMN = 8;              // rays of a column
constexpr int COLUMNS = PACKET / COLUMN;
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int R = 4;                   // rays a thread owns for the slab tests
constexpr int T = PACKET / R;          // threads of a block
constexpr int W = T / 32;              // warps of a block
constexpr int TPL = LANES / 32;        // triangles a lane holds at a leaf

// jnp.minimum / jnp.maximum: a NaN operand gives NaN (fminf would drop it), in
// one instruction each. Which zero comes out of (-0, +0) is left open: the
// slab test's results are only compared.
__device__ __forceinline__ float jmin(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}
__device__ __forceinline__ float jmax(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// A node's box: min.xyz, max.xyz from its two float4 (the last two floats pad).
struct Box {
  float mn[3], mx[3];
};

__device__ __forceinline__ Box load_box(const float4* __restrict__ node_box, int node) {
  const float4 a = __ldg(node_box + 2 * node), b = __ldg(node_box + 2 * node + 1);
  return Box{{a.x, a.y, a.z}, {a.w, b.x, b.y}};
}

// Slab test of one node box against one ray (uvtrace/ops/traverse_pallas.py:172-181).
__device__ __forceinline__ void slab(const Box& box, const float o[3], const float inv[3], float& tmin,
                                     bool& hit) {
  float lo = -BIG, hi = BIG;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t1 = (box.mn[ax] - o[ax]) * inv[ax];
    const float t2 = (box.mx[ax] - o[ax]) * inv[ax];
    lo = jmax(lo, jmin(t1, t2));
    hi = jmin(hi, jmax(t1, t2));
  }
  tmin = lo;
  hit = hi >= lo && hi > 0.0f;
}

// An integer key with the order of the floats (no NaN): a warp's least float
// is one __reduce_min_sync of the keys.
__device__ __forceinline__ int ordered_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_ordered_key(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

// Möller–Trumbore of one ray against one triangle in _mt_columns' formulas and
// operation order (uvtrace/ops/traverse_pallas.py:126-148): t, or BIG on a miss.
__device__ __forceinline__ float mt(float ox, float oy, float oz, float cdx, float cdy, float cdz, float v0x,
                                    float v0y, float v0z, float e1x, float e1y, float e1z, float e2x, float e2y,
                                    float e2z) {
  const float hx = cdy * e2z - cdz * e2y;
  const float hy = cdz * e2x - cdx * e2z;
  const float hz = cdx * e2y - cdy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (a == 0.0f ? 1.0f : a);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (cdx * qx + cdy * qy + cdz * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  const bool valid = fabsf(a) >= 1e-5f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-4f;
  return valid ? t : BIG;
}

// 256 threads and at most BLOCKS_PER_SM blocks' registers: see PERF.md for
// the timings that chose them.
constexpr int BLOCKS_PER_SM = 4;
// Work items of a leaf: a column's triangles go to `parts` warps, one group of
// 32 each, while the leaf has at most ITEMS (column, group) pairs; with more
// active columns than that a warp takes a whole column.
constexpr int ITEMS = COLUMNS;

__global__ void __launch_bounds__(T, BLOCKS_PER_SM) traverse_pallas_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir, const float4* __restrict__ node_box,
    const int2* __restrict__ node_meta, const float* __restrict__ tri, const int* __restrict__ tri_used,
    const int* __restrict__ tri_idx_flat, float* __restrict__ t_out, int* __restrict__ hit_out, int* __restrict__ stats) {
  __shared__ float ray_s[6][PACKET];  // ox, oy, oz, dx, dy, dz of every ray of the packet
  // a work item's result: for each of its column's 8 rays the nearest t over
  // the item's triangles and the lowest triangle that has it
  __shared__ float item_t[ITEMS][COLUMN];
  __shared__ int item_arg[ITEMS][COLUMN];
  __shared__ int stack[STACK_DEPTH];
  // the active columns of a leaf and each one's place in the list; a leaf
  // uses set (leaf number mod 3) and zeroes the next leaf's count before its
  // barrier, so that neither the next leaf's appends nor that zeroing meet a
  // leaf's reads with no barrier between
  __shared__ int col_list[3][COLUMNS];
  __shared__ unsigned char col_pos[3][COLUMNS];
  __shared__ int col_n[3];
  // the warps' partial results at an inner node (least entry of child 1 and
  // 2 as ordered keys, votes), in set (inner node number mod 2)
  __shared__ int red_d1[2][W], red_d2[2][W], red_v[2][W];
  __shared__ int col_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray0 = (size_t)blockIdx.x * PACKET;
  float o[R][3], inv[R][3], tb[R];
  int sl[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t r = ray0 + tid + k * T;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dc = dir[3 * r + c];
      o[k][c] = orig[3 * r + c];
      inv[k][c] = 1.0f / (dc == 0.0f ? 1e-30f : dc);
      ray_s[c][tid + k * T] = o[k][c];
      ray_s[3 + c][tid + k * T] = dc;
    }
    tb[k] = BIG;
    sl[k] = -1;
  }
  if (tid < 3) col_n[tid] = 0;
  if (tid == 0) {
    stack[0] = 0;
    col_total = 0;
  }
  __syncthreads();

  int sp = 1, leaves = 0, my_cols = 0;
  int top = 0;            // the node on top of the stack, when this pop's predecessor pushed it
  bool top_known = true;
  int set3 = 0, set2 = 0;
  while (sp > 0) {
    const int node = top_known ? top : stack[sp - 1];
    --sp;
    top_known = false;
    const int2 meta = __ldg(node_meta + node);
    if (meta.y == 1) {
      // ---- leaf: list the active columns, deal their triangles out, keep the hits
      ++leaves;
      const Box box = load_box(node_box, node);
      unsigned mask = 0;  // this warp's columns: bit 4k + g is rays 8g..8g+7 of its k-th 32 rays
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tmin;
        bool hit;
        slab(box, o[k], inv[k], tmin, hit);
        unsigned m = __ballot_sync(FULL, hit && tmin < tb[k]);
        m |= m >> 4;  // bit 8g: any of the 8 lanes of column g
        m |= m >> 2;
        m |= m >> 1;
        m &= 0x01010101u;
        mask |= ((m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xFu) << (4 * k);
      }
      if (mask != 0) {
        const int cnt = __popc(mask);
        int base = 0;
        if (lane == 0) {
          base = atomicAdd(&col_n[set3], cnt);
          my_cols += cnt;
        }
        base = __shfl_sync(FULL, base, 0);
        if (lane < 4 * R && ((mask >> lane) & 1u)) {
          const int column = (lane >> 2) * (T / COLUMN) + warp * 4 + (lane & 3);
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          col_list[set3][pos] = column;
          col_pos[set3][column] = (unsigned char)pos;
        }
      }
      const int next3 = set3 == 2 ? 0 : set3 + 1;
      if (tid == 0) col_n[next3] = 0;
      __syncthreads();
      const int n_cols = col_n[set3];
      if (n_cols > 0) {
        // the cluster's slots in use, in groups of 32: the all-zero triangles
        // behind them (padding) have a = 0 and hit nothing
        const int groups = max(1, (__ldg(tri_used + meta.x) + 31) >> 5);
        const int parts = n_cols * groups <= ITEMS ? groups : 1;
        const int n_items = n_cols * parts;
        const float* src = tri + (size_t)meta.x * TRI_ROWS * LANES + lane;
        for (int item = warp; item < n_items; item += W) {
          const int c = item / parts, part = item - c * parts;
          const int first_ray = col_list[set3][c] * COLUMN;
          // lane r < 8 gathers ray r's nearest t over the item's triangles and
          // the lowest triangle that has it
          float t_new = BIG;
          int arg_new = 0;
          for (int g = part; g < groups; g += parts) {
            float tv[9];  // v0, e1, e2 of triangle lane + 32 g
#pragma unroll
            for (int r = 0; r < 9; ++r) tv[r] = __ldg(src + r * LANES + 32 * g);
#pragma unroll
            for (int r = 0; r < COLUMN; ++r) {
              const int ray = first_ray + r;
              const float tj = mt(ray_s[0][ray], ray_s[1][ray], ray_s[2][ray], ray_s[3][ray], ray_s[4][ray],
                                  ray_s[5][ray], tv[0], tv[1], tv[2], tv[3], tv[4], tv[5], tv[6], tv[7], tv[8]);
              // over the warp: the nearest t (positive: its bits order as
              // unsigned), then the lowest lane that has it; a later group
              // (higher triangles) wins only on a strict `<`
              const unsigned bits = __float_as_uint(tj);
              const unsigned least = __reduce_min_sync(FULL, bits);
              const unsigned arg = __reduce_min_sync(FULL, bits == least ? (unsigned)lane : 32u);
              if (lane == r && __uint_as_float(least) < t_new) {
                t_new = __uint_as_float(least);
                arg_new = (int)arg + 32 * g;
              }
            }
          }
          if (lane < COLUMN) {
            item_t[item][lane] = t_new;
            item_arg[item][lane] = arg_new;
          }
        }
        __syncthreads();
        // each thread gathers its own rays' results: the least (t, triangle)
        // over its column's items, kept on a strict `<` against the best t
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if ((mask >> (4 * k + (lane >> 3))) & 1u) {
            const int item0 = col_pos[set3][k * (T / COLUMN) + warp * 4 + (lane >> 3)] * parts;
            float t_new = item_t[item0][lane & 7];
            int arg_new = item_arg[item0][lane & 7];
            for (int p = 1; p < parts; ++p) {
              const float tp = item_t[item0 + p][lane & 7];
              const int ap = item_arg[item0 + p][lane & 7];
              if (tp < t_new || (tp == t_new && ap < arg_new)) {
                t_new = tp;
                arg_new = ap;
              }
            }
            if (t_new < tb[k]) {
              tb[k] = t_new;
              sl[k] = meta.x * LANES + arg_new;
            }
          }
        }
      }
      set3 = next3;
    } else {
      // ---- inner node: test both children, push the far one first
      const int c1 = meta.x, c2 = meta.x + 1;
      const Box box1 = load_box(node_box, c1), box2 = load_box(node_box, c2);
      bool v1 = false, v2 = false;
      float d1 = BIG, d2 = BIG;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tmin1, tmin2;
        bool m1, m2;
        slab(box1, o[k], inv[k], tmin1, m1);
        slab(box2, o[k], inv[k], tmin2, m2);
        // tmin < best t implies tmin < the packet bound, the max of best t
        v1 |= m1 && tmin1 < tb[k];
        v2 |= m2 && tmin2 < tb[k];
        d1 = fminf(d1, m1 ? tmin1 : BIG);  // a hitting ray's tmin is never NaN
        d2 = fminf(d2, m2 ? tmin2 : BIG);
      }
      const int votes = (__any_sync(FULL, v1) ? 1 : 0) | (__any_sync(FULL, v2) ? 2 : 0);
      const int k1 = __reduce_min_sync(FULL, ordered_key(d1)), k2 = __reduce_min_sync(FULL, ordered_key(d2));
      if (lane == 0) {
        red_d1[set2][warp] = k1;
        red_d2[set2][warp] = k2;
        red_v[set2][warp] = votes;
      }
      __syncthreads();
      const bool slot = lane < W;
      d1 = from_ordered_key(__reduce_min_sync(FULL, slot ? red_d1[set2][lane] : 0x7fffffff));
      d2 = from_ordered_key(__reduce_min_sync(FULL, slot ? red_d2[set2][lane] : 0x7fffffff));
      const int vv = (int)__reduce_or_sync(FULL, slot ? (unsigned)red_v[set2][lane] : 0u);
      const bool near_first = d1 <= d2;
      const int first = near_first ? c2 : c1, second = near_first ? c1 : c2;
      const bool v_first = (vv & (near_first ? 2 : 1)) != 0, v_second = (vv & (near_first ? 1 : 2)) != 0;
      if (tid == 0) {
        if (v_first) stack[sp] = first;
        if (v_second) stack[sp + (v_first ? 1 : 0)] = second;
      }
      sp += (v_first ? 1 : 0) + (v_second ? 1 : 0);
      top = v_second ? second : first;
      top_known = v_first || v_second;
      set2 ^= 1;
    }
  }

#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t r = ray0 + tid + k * T;
    const bool miss = tb[k] >= BIG || sl[k] < 0;
    t_out[r] = tb[k];
    hit_out[r] = miss ? -1 : tri_idx_flat[sl[k]];
  }
  if (stats != nullptr) {
    if (lane == 0) atomicAdd(&col_total, my_cols);
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
                                      const int* node_meta, const float* tri, const int* tri_used,
                                      const int* tri_idx_flat, float* t_out, int* hit_out, int* stats,
                                      void* stream) {
  traverse_pallas_kernel<<<packets, T, 0, (cudaStream_t)stream>>>(
      orig, dir, reinterpret_cast<const float4*>(node_box), reinterpret_cast<const int2*>(node_meta), tri,
      tri_used, tri_idx_flat, t_out, hit_out, stats);
  return (int)cudaGetLastError();
}
