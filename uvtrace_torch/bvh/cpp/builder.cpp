// Native binned-SAH BVH / cluster builder.
//
// Role of the reference's C++ builder (bvh.cpp: binned SAH, SSE, OpenMP —
// adapted there from jbikker/bvh_article). This is a fresh implementation of
// the same algorithm family with the semantics of uvtrace/bvh/builder.py:
//   - 8-bin binned SAH over centroid extents, cost = Nl*Al + Nr*Ar,
//     split aborted when cost >= leaf cost (unless a leaf-size bound forces
//     a median split);
//   - children emitted contiguously (left, left+1);
//   - cluster mode: always split while count > bound, stop at <= bound.
// Parallelism: OpenMP tasks on subtrees below a size threshold.
//
// C ABI for ctypes; all buffers caller-allocated (node buffers sized 2T).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kBins = 8;
constexpr float kInf = 1e30f;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis_of(const V3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}
static inline float half_area(const V3 &lo, const V3 &hi) {
  float ex = std::max(hi.x - lo.x, 0.0f);
  float ey = std::max(hi.y - lo.y, 0.0f);
  float ez = std::max(hi.z - lo.z, 0.0f);
  return ex * ey + ey * ez + ez * ex;
}

struct Builder {
  const float *tris;  // [T][3][3]
  int t_count;
  int max_leaf;   // <=0: pure SAH termination
  bool cluster_mode;  // true: stop as soon as count <= max_leaf

  std::vector<V3> centroid, tmin, tmax;
  float *node_min;
  float *node_max;
  int32_t *left_first;
  int32_t *tri_count;
  int32_t *tri_idx;
  std::atomic<int32_t> next_node{0};

  int32_t emit(const V3 &lo, const V3 &hi, int32_t lf, int32_t tc) {
    return emit_at(next_node.fetch_add(1), lo, hi, lf, tc);
  }

  int32_t emit_at(int32_t id, const V3 &lo, const V3 &hi, int32_t lf, int32_t tc) {
    node_min[id * 3 + 0] = lo.x;
    node_min[id * 3 + 1] = lo.y;
    node_min[id * 3 + 2] = lo.z;
    node_max[id * 3 + 0] = hi.x;
    node_max[id * 3 + 1] = hi.y;
    node_max[id * 3 + 2] = hi.z;
    left_first[id] = lf;
    tri_count[id] = tc;
    return id;
  }

  void bounds_of(int32_t start, int32_t count, V3 &lo, V3 &hi, V3 &clo, V3 &chi) {
    lo = clo = {kInf, kInf, kInf};
    hi = chi = {-kInf, -kInf, -kInf};
    for (int32_t i = start; i < start + count; ++i) {
      int32_t t = tri_idx[i];
      lo = vmin(lo, tmin[t]);
      hi = vmax(hi, tmax[t]);
      clo = vmin(clo, centroid[t]);
      chi = vmax(chi, centroid[t]);
    }
  }

  // Best (axis, split bin) by SAH; returns cost (kInf if unsplittable).
  float best_split(int32_t start, int32_t count, const V3 &clo, const V3 &chi,
                   int &best_axis, int &best_pos) {
    float best_cost = kInf;
    best_axis = -1;
    best_pos = -1;
    for (int a = 0; a < 3; ++a) {
      float lo = axis_of(clo, a), hi = axis_of(chi, a);
      if (lo == hi) continue;
      float scale = kBins / (hi - lo);
      int cnt[kBins] = {0};
      V3 bmin[kBins], bmax[kBins];
      for (int b = 0; b < kBins; ++b) {
        bmin[b] = {kInf, kInf, kInf};
        bmax[b] = {-kInf, -kInf, -kInf};
      }
      for (int32_t i = start; i < start + count; ++i) {
        int32_t t = tri_idx[i];
        int b = std::min(kBins - 1,
                         (int)((axis_of(centroid[t], a) - lo) * scale));
        cnt[b]++;
        bmin[b] = vmin(bmin[b], tmin[t]);
        bmax[b] = vmax(bmax[b], tmax[t]);
      }
      // sweep the 7 planes
      float larea[kBins - 1], rarea[kBins - 1];
      int lcnt[kBins - 1], rcnt[kBins - 1];
      V3 lo3 = {kInf, kInf, kInf}, hi3 = {-kInf, -kInf, -kInf};
      int sum = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        sum += cnt[b];
        lcnt[b] = sum;
        lo3 = vmin(lo3, bmin[b]);
        hi3 = vmax(hi3, bmax[b]);
        larea[b] = half_area(lo3, hi3);
      }
      lo3 = {kInf, kInf, kInf};
      hi3 = {-kInf, -kInf, -kInf};
      sum = 0;
      for (int b = kBins - 1; b > 0; --b) {
        sum += cnt[b];
        rcnt[b - 1] = sum;
        lo3 = vmin(lo3, bmin[b]);
        hi3 = vmax(hi3, bmax[b]);
        rarea[b - 1] = half_area(lo3, hi3);
      }
      for (int b = 0; b < kBins - 1; ++b) {
        if (lcnt[b] == 0 || rcnt[b] == 0) continue;
        float cost = lcnt[b] * larea[b] + rcnt[b] * rarea[b];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_pos = b + 1;
        }
      }
    }
    return best_cost;
  }

  void subdivide(int32_t node, int32_t start, int32_t count, int depth) {
    V3 lo = {node_min[node * 3], node_min[node * 3 + 1], node_min[node * 3 + 2]};
    V3 hi = {node_max[node * 3], node_max[node * 3 + 1], node_max[node * 3 + 2]};
    V3 clo, chi, dummy_lo, dummy_hi;
    bounds_of(start, count, dummy_lo, dummy_hi, clo, chi);

    bool forced = max_leaf > 0 && count > max_leaf;
    bool stop_cluster = cluster_mode && count <= max_leaf;

    int axis = -1, pos = -1;
    float split_cost = kInf;
    if (!stop_cluster) split_cost = best_split(start, count, clo, chi, axis, pos);
    float leaf_cost = half_area(lo, hi) * count;
    bool use_sah = axis >= 0 && (cluster_mode ? true : split_cost < leaf_cost);
    if (cluster_mode && !forced) use_sah = false;  // reached the bound: leaf
    if (!use_sah && !forced) return;  // stays a leaf

    int32_t mid = start;
    if (use_sah) {
      float lo_a = axis_of(clo, axis);
      float scale = kBins / (axis_of(chi, axis) - lo_a);
      int32_t i = start, j = start + count - 1;
      while (i <= j) {
        int b = std::min(kBins - 1,
                         (int)((axis_of(centroid[tri_idx[i]], axis) - lo_a) * scale));
        if (b < pos)
          i++;
        else
          std::swap(tri_idx[i], tri_idx[j--]);
      }
      mid = i;
      if (mid == start || mid == start + count) use_sah = false;
    }
    if (!use_sah) {
      if (!forced) return;
      // median split on the widest centroid axis
      V3 ext = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
      int a = ext.x >= ext.y ? (ext.x >= ext.z ? 0 : 2) : (ext.y >= ext.z ? 1 : 2);
      mid = start + count / 2;
      std::nth_element(tri_idx + start, tri_idx + mid, tri_idx + start + count,
                       [&](int32_t ta, int32_t tb) {
                         return axis_of(centroid[ta], a) < axis_of(centroid[tb], a);
                       });
      if (mid == start || mid == start + count) return;
    }

    int32_t lcount = mid - start, rcount = count - lcount;
    V3 llo, lhi, rlo, rhi, c0, c1;
    bounds_of(start, lcount, llo, lhi, c0, c1);
    bounds_of(mid, rcount, rlo, rhi, c0, c1);
    // allocate BOTH ids in one atomic op: parallel tasks must not interleave
    // between the two children (right child == left child + 1 invariant)
    int32_t base = next_node.fetch_add(2);
    int32_t lchild = emit_at(base, llo, lhi, start, lcount);
    int32_t rchild = emit_at(base + 1, rlo, rhi, mid, rcount);
    left_first[node] = lchild;
    tri_count[node] = 0;

    bool parallel = depth < 5 && count > 4096;
    if (parallel) {
      Builder *self = this;
#pragma omp task firstprivate(self, lchild, start, lcount, depth)
      self->subdivide(lchild, start, lcount, depth + 1);
#pragma omp task firstprivate(self, rchild, mid, rcount, depth)
      self->subdivide(rchild, mid, rcount, depth + 1);
#pragma omp taskwait
    } else {
      subdivide(lchild, start, lcount, depth + 1);
      subdivide(rchild, mid, rcount, depth + 1);
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.
// tris: [t_count*9] floats; node buffers sized for 2*t_count nodes;
// mode: 0 = BVH (SAH termination, optional max_leaf bound),
//       1 = cluster (split while count > max_leaf).
int32_t uvtrace_build(const float *tris, int32_t t_count, int32_t max_leaf,
                      int32_t mode, float *node_min, float *node_max,
                      int32_t *left_first, int32_t *tri_count,
                      int32_t *tri_idx) {
  if (t_count <= 0) return -1;
  Builder b;
  b.tris = tris;
  b.t_count = t_count;
  b.max_leaf = max_leaf;
  b.cluster_mode = mode == 1;
  b.node_min = node_min;
  b.node_max = node_max;
  b.left_first = left_first;
  b.tri_count = tri_count;
  b.tri_idx = tri_idx;

  b.centroid.resize(t_count);
  b.tmin.resize(t_count);
  b.tmax.resize(t_count);
#pragma omp parallel for schedule(static)
  for (int32_t t = 0; t < t_count; ++t) {
    const float *p = tris + t * 9;
    V3 v0 = {p[0], p[1], p[2]}, v1 = {p[3], p[4], p[5]}, v2 = {p[6], p[7], p[8]};
    b.tmin[t] = vmin(vmin(v0, v1), v2);
    b.tmax[t] = vmax(vmax(v0, v1), v2);
    b.centroid[t] = {(v0.x + v1.x + v2.x) / 3.0f, (v0.y + v1.y + v2.y) / 3.0f,
                     (v0.z + v1.z + v2.z) / 3.0f};
    tri_idx[t] = t;
  }

  V3 lo = {kInf, kInf, kInf}, hi = {-kInf, -kInf, -kInf};
  for (int32_t t = 0; t < t_count; ++t) {
    lo = vmin(lo, b.tmin[t]);
    hi = vmax(hi, b.tmax[t]);
  }
  int32_t root = b.emit(lo, hi, 0, t_count);
#ifdef _OPENMP
#pragma omp parallel
#pragma omp single
#endif
  b.subdivide(root, 0, t_count, 0);
  return b.next_node.load();
}
}
