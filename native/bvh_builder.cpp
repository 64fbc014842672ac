// Native BVH builder: binned-SAH construction over triangle soups.
//
// Host-side native component of pathtracer (the analogue of the
// reference renderer's C++ host layer, pathtracer.cu:172-220 — scene
// preparation for the device). Emits the same *threaded* (skip-link) DFS
// layout as the NumPy builder in models/mesh.py, so the two are
// interchangeable behind pathtracer.native.bvh.build.
//
// Exposed as a C ABI for ctypes:
//   int bvh_build(const float* tri_min, const float* tri_max,
//                 const float* centroid, int n_tris, int leaf_size,
//                 int* order_out,            // [n_tris] triangle permutation
//                 float* node_min_out,       // [max_nodes*3]
//                 float* node_max_out,       // [max_nodes*3]
//                 int* node_skip_out,        // [max_nodes]
//                 int* node_start_out,       // [max_nodes]
//                 int* node_count_out,       // [max_nodes]
//                 int max_nodes);
// Returns the number of nodes written, or -1 on overflow.
//
// Build: make -C native   (produces libbvh.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Builder {
  const Vec3* tri_min;
  const Vec3* tri_max;
  const Vec3* centroid;
  int leaf_size;
  int max_nodes;

  std::vector<int> order;      // leaf-ordered triangle ids
  std::vector<Vec3> node_min;
  std::vector<Vec3> node_max;
  std::vector<int> node_skip;  // patched post-order: index after subtree
  std::vector<int> node_start;
  std::vector<int> node_count;
  bool overflow = false;

  static constexpr int kBins = 16;

  float surface(const Vec3& lo, const Vec3& hi) const {
    float dx = std::max(0.f, hi.x - lo.x);
    float dy = std::max(0.f, hi.y - lo.y);
    float dz = std::max(0.f, hi.z - lo.z);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }

  // Build the subtree over ids[lo, hi); returns nothing (DFS order append).
  void build(std::vector<int>& ids, int lo, int hi) {
    if (overflow) return;
    if ((int)node_min.size() >= max_nodes) {
      overflow = true;
      return;
    }
    int me = (int)node_min.size();
    Vec3 bb_lo = tri_min[ids[lo]];
    Vec3 bb_hi = tri_max[ids[lo]];
    Vec3 c_lo = centroid[ids[lo]];
    Vec3 c_hi = c_lo;
    for (int i = lo + 1; i < hi; ++i) {
      bb_lo = vmin(bb_lo, tri_min[ids[i]]);
      bb_hi = vmax(bb_hi, tri_max[ids[i]]);
      c_lo = vmin(c_lo, centroid[ids[i]]);
      c_hi = vmax(c_hi, centroid[ids[i]]);
    }
    node_min.push_back(bb_lo);
    node_max.push_back(bb_hi);
    node_skip.push_back(0);
    node_start.push_back(0);
    node_count.push_back(0);

    int n = hi - lo;
    bool make_leaf = n <= leaf_size;
    int best_axis = -1, best_bin = -1;
    if (!make_leaf) {
      // binned SAH over the centroid extent
      float best_cost = (float)n;  // leaf cost baseline (1 per tri)
      const float parent_sa = surface(bb_lo, bb_hi);
      for (int axis = 0; axis < 3; ++axis) {
        float cmin = axis == 0 ? c_lo.x : axis == 1 ? c_lo.y : c_lo.z;
        float cmax = axis == 0 ? c_hi.x : axis == 1 ? c_hi.y : c_hi.z;
        float extent = cmax - cmin;
        if (extent <= 1e-12f) continue;
        int bin_n[kBins] = {0};
        Vec3 bin_lo[kBins], bin_hi[kBins];
        for (int b = 0; b < kBins; ++b) {
          bin_lo[b] = {1e30f, 1e30f, 1e30f};
          bin_hi[b] = {-1e30f, -1e30f, -1e30f};
        }
        float inv = kBins / extent;
        for (int i = lo; i < hi; ++i) {
          const Vec3& c = centroid[ids[i]];
          float cv = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
          int b = std::min(kBins - 1, (int)((cv - cmin) * inv));
          bin_n[b]++;
          bin_lo[b] = vmin(bin_lo[b], tri_min[ids[i]]);
          bin_hi[b] = vmax(bin_hi[b], tri_max[ids[i]]);
        }
        // sweep: left-to-right prefix, right-to-left suffix
        float right_sa[kBins];
        Vec3 acc_lo = {1e30f, 1e30f, 1e30f}, acc_hi = {-1e30f, -1e30f, -1e30f};
        int right_cnt[kBins];
        int cnt = 0;
        for (int b = kBins - 1; b > 0; --b) {
          if (bin_n[b]) {
            acc_lo = vmin(acc_lo, bin_lo[b]);
            acc_hi = vmax(acc_hi, bin_hi[b]);
          }
          cnt += bin_n[b];
          right_sa[b] = bin_n[b] || cnt ? surface(acc_lo, acc_hi) : 0.f;
          right_cnt[b] = cnt;
        }
        acc_lo = {1e30f, 1e30f, 1e30f};
        acc_hi = {-1e30f, -1e30f, -1e30f};
        cnt = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          if (bin_n[b]) {
            acc_lo = vmin(acc_lo, bin_lo[b]);
            acc_hi = vmax(acc_hi, bin_hi[b]);
          }
          cnt += bin_n[b];
          if (cnt == 0 || right_cnt[b + 1] == 0) continue;
          float cost =
              0.125f + (surface(acc_lo, acc_hi) * cnt +
                        right_sa[b + 1] * right_cnt[b + 1]) /
                           parent_sa;
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_bin = b;
          }
        }
      }
      if (best_axis < 0) {
        // SAH says leaf, but cap leaf size: fall back to a median split
        if (n > 4 * leaf_size) {
          best_axis = 0;
          float ex = c_hi.x - c_lo.x, ey = c_hi.y - c_lo.y,
                ez = c_hi.z - c_lo.z;
          if (ey > ex && ey >= ez) best_axis = 1;
          else if (ez > ex && ez > ey) best_axis = 2;
          best_bin = -2;  // sentinel: median split
        } else {
          make_leaf = true;
        }
      }
    }

    if (make_leaf) {
      node_start[me] = (int)order.size();
      node_count[me] = n;
      for (int i = lo; i < hi; ++i) order.push_back(ids[i]);
      node_skip[me] = (int)node_min.size();
      return;
    }

    int mid;
    if (best_bin == -2) {
      mid = lo + n / 2;
      int axis = best_axis;
      std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                       [&](int a, int b) {
                         const Vec3& ca = centroid[a];
                         const Vec3& cb = centroid[b];
                         float va = axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z;
                         float vb = axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z;
                         return va < vb;
                       });
    } else {
      float cmin, extent;
      {
        float a = best_axis == 0   ? c_lo.x
                  : best_axis == 1 ? c_lo.y
                                   : c_lo.z;
        float b = best_axis == 0   ? c_hi.x
                  : best_axis == 1 ? c_hi.y
                                   : c_hi.z;
        cmin = a;
        extent = b - a;
      }
      float inv = kBins / extent;
      auto it = std::partition(
          ids.begin() + lo, ids.begin() + hi, [&](int tid) {
            const Vec3& c = centroid[tid];
            float cv = best_axis == 0 ? c.x : best_axis == 1 ? c.y : c.z;
            int b = std::min(kBins - 1, (int)((cv - cmin) * inv));
            return b <= best_bin;
          });
      mid = (int)(it - ids.begin());
      if (mid == lo || mid == hi) mid = lo + n / 2;  // degenerate partition
    }
    build(ids, lo, mid);
    build(ids, mid, hi);
    node_skip[me] = (int)node_min.size();
  }
};

}  // namespace

extern "C" {

int bvh_build(const float* tri_min, const float* tri_max,
              const float* centroid, int n_tris, int leaf_size,
              int* order_out, float* node_min_out, float* node_max_out,
              int* node_skip_out, int* node_start_out, int* node_count_out,
              int max_nodes) {
  Builder b;
  b.tri_min = reinterpret_cast<const Vec3*>(tri_min);
  b.tri_max = reinterpret_cast<const Vec3*>(tri_max);
  b.centroid = reinterpret_cast<const Vec3*>(centroid);
  b.leaf_size = leaf_size;
  b.max_nodes = max_nodes;
  b.order.reserve(n_tris);
  b.node_min.reserve(2 * n_tris / std::max(1, leaf_size) + 16);

  std::vector<int> ids(n_tris);
  for (int i = 0; i < n_tris; ++i) ids[i] = i;
  b.build(ids, 0, n_tris);
  if (b.overflow) return -1;

  int m = (int)b.node_min.size();
  std::memcpy(order_out, b.order.data(), sizeof(int) * n_tris);
  std::memcpy(node_min_out, b.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(node_max_out, b.node_max.data(), sizeof(float) * 3 * m);
  std::memcpy(node_skip_out, b.node_skip.data(), sizeof(int) * m);
  std::memcpy(node_start_out, b.node_start.data(), sizeof(int) * m);
  std::memcpy(node_count_out, b.node_count.data(), sizeof(int) * m);
  return m;
}

}  // extern "C"
