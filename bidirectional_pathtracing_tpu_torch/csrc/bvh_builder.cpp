// Native BVH builder: the host-side build of the port's BVH and cluster cut.
//
// A copy of bidirectional_pathtracing_tpu/ops/native/bvh_builder.cpp, built
// with g++ into a shared library with a plain C interface and loaded with
// ctypes (ops/native.py).  It runs on the host, not the card.
//
// Two split strategies behind one flattened pre-order + escape-link layout
// (stackless traversal, no recursion limits):
//
//   bvh_build      — the reference build algorithm (reference
//                    src/scene/bvh.cpp:51-129): spatial-midpoint split on
//                    the largest-extent centroid axis, leaf size capped.
//   bvh_build_sah  — binned surface-area-heuristic split (16 centroid bins
//                    per axis, all 3 axes, cost = SA(L)*nL + SA(R)*nR).
//
// One change from the JAX package's copy: every split here keeps the
// primitives' order (std::stable_partition, and a stable sort where the
// split falls back to the median), and the fallbacks take the axes of
// scene/bvh.py _build_numpy.  So this builder and the numpy one give the
// same tree bit for bit, prim_order included.  The JAX package's native
// builder partitions in place (std::partition, std::nth_element): its trees
// have the same nodes and boxes but may list a leaf's primitives in another
// order than its numpy builder does.
//
// C ABI, consumed from Python via ctypes (ops/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Frame {
  int64_t begin, end;
  int64_t node_id;
  int state;  // 0 = build, 1 = patch escape after subtree
};

inline double half_area(const double lo[3], const double hi[3]) {
  double dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
  if (dx < 0 || dy < 0 || dz < 0) return 0.0;  // empty box
  return dx * dy + dy * dz + dz * dx;
}

// The largest-extent centroid axis, the first of equal extents (np.argmax).
inline int widest_axis(const double cmin[3], const double cmax[3]) {
  int axis = 0;
  double best = -1;
  for (int a = 0; a < 3; a++) {
    if (cmax[a] - cmin[a] > best) { best = cmax[a] - cmin[a]; axis = a; }
  }
  return axis;
}

// Midpoint split on the widest axis; returns the split point and sets axis.
int64_t* split_midpoint(int64_t* first, int64_t* last, const double* cents[3],
                        const double cmin[3], const double cmax[3],
                        int* axis) {
  *axis = widest_axis(cmin, cmax);
  const double mid = (cmin[*axis] + cmax[*axis]) * 0.5;
  const double* c = cents[*axis];
  return std::stable_partition(first, last,
                               [&](int64_t p) { return c[p] < mid; });
}

// Median split of a one-sided partition: a stable sort by the centroid on
// `axis`, the lower half to the left (np.argsort(kind="stable")).
int64_t* split_median(int64_t* first, int64_t* last, const double* c) {
  std::stable_sort(first, last,
                   [&](int64_t a, int64_t b) { return c[a] < c[b]; });
  return first + (last - first) / 2;
}

// Shared builder; mode 0 = midpoint (reference parity), 1 = binned SAH.
int64_t build_impl(int mode, const double* lo, const double* hi, int64_t n,
                   int64_t max_leaf, float* bounds_lo, float* bounds_hi,
                   uint8_t* is_leaf, int32_t* prim_start, int32_t* prim_count,
                   int32_t* escape, int64_t* order) {
  if (n <= 0) return -1;
  std::vector<double> cx(n), cy(n), cz(n);
  for (int64_t i = 0; i < n; i++) {
    cx[i] = (lo[3 * i] + hi[3 * i]) * 0.5;
    cy[i] = (lo[3 * i + 1] + hi[3 * i + 1]) * 0.5;
    cz[i] = (lo[3 * i + 2] + hi[3 * i + 2]) * 0.5;
  }
  const double* cents[3] = {cx.data(), cy.data(), cz.data()};
  std::iota(order, order + n, 0);

  int64_t n_nodes = 0;
  std::vector<Frame> fs;
  fs.push_back({0, n, -1, 0});
  while (!fs.empty()) {
    Frame f = fs.back();
    fs.pop_back();
    if (f.state == 1) {  // post: patch escape
      escape[f.node_id] = (int32_t)n_nodes;
      continue;
    }
    int64_t id = n_nodes++;
    double blo[3] = {1e300, 1e300, 1e300}, bhi[3] = {-1e300, -1e300, -1e300};
    for (int64_t k = f.begin; k < f.end; k++) {
      int64_t p = order[k];
      for (int a = 0; a < 3; a++) {
        blo[a] = std::min(blo[a], lo[3 * p + a]);
        bhi[a] = std::max(bhi[a], hi[3 * p + a]);
      }
    }
    for (int a = 0; a < 3; a++) {
      bounds_lo[3 * id + a] = (float)blo[a];
      bounds_hi[3 * id + a] = (float)bhi[a];
    }
    fs.push_back({0, 0, id, 1});  // escape patch after subtree

    int64_t count = f.end - f.begin;
    if (count <= max_leaf) {
      is_leaf[id] = 1;
      prim_start[id] = (int32_t)f.begin;
      prim_count[id] = (int32_t)count;
      continue;
    }
    is_leaf[id] = 0;
    prim_start[id] = 0;
    prim_count[id] = 0;

    // centroid extent
    double cmin[3] = {1e300, 1e300, 1e300}, cmax[3] = {-1e300, -1e300, -1e300};
    for (int64_t k = f.begin; k < f.end; k++) {
      int64_t p = order[k];
      double c[3] = {cx[p], cy[p], cz[p]};
      for (int a = 0; a < 3; a++) {
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    int64_t* first = order + f.begin;
    int64_t* last = order + f.end;
    int64_t* split = nullptr;
    int axis = 0;

    if (mode == 1) {
      // --- binned SAH over all 3 axes --------------------------------
      constexpr int NB = 16;
      double best_cost = 1e300;
      int best_axis = -1, best_plane = -1;
      for (int ax = 0; ax < 3; ax++) {
        double ext = cmax[ax] - cmin[ax];
        if (ext < 1e-12) continue;
        int64_t cnt[NB] = {0};
        double binlo[NB][3], binhi[NB][3];
        for (int b = 0; b < NB; b++)
          for (int a = 0; a < 3; a++) {
            binlo[b][a] = 1e300;
            binhi[b][a] = -1e300;
          }
        double scale = NB / ext;
        const double* c = cents[ax];
        for (int64_t k = f.begin; k < f.end; k++) {
          int64_t p = order[k];
          int b = (int)((c[p] - cmin[ax]) * scale);
          if (b < 0) b = 0;
          if (b >= NB) b = NB - 1;
          cnt[b]++;
          for (int a = 0; a < 3; a++) {
            binlo[b][a] = std::min(binlo[b][a], lo[3 * p + a]);
            binhi[b][a] = std::max(binhi[b][a], hi[3 * p + a]);
          }
        }
        // suffix sweep: right-side SA/count for each plane
        double rlo[3] = {1e300, 1e300, 1e300}, rhi[3] = {-1e300, -1e300, -1e300};
        double rsa[NB];
        int64_t rcnt[NB];
        int64_t acc = 0;
        for (int b = NB - 1; b >= 1; b--) {
          acc += cnt[b];
          for (int a = 0; a < 3; a++) {
            rlo[a] = std::min(rlo[a], binlo[b][a]);
            rhi[a] = std::max(rhi[a], binhi[b][a]);
          }
          rcnt[b] = acc;
          rsa[b] = (acc > 0) ? half_area(rlo, rhi) : 0.0;
        }
        // prefix sweep, evaluate plane between bin b-1 and b
        double llo[3] = {1e300, 1e300, 1e300}, lhi[3] = {-1e300, -1e300, -1e300};
        int64_t lacc = 0;
        for (int b = 1; b < NB; b++) {
          lacc += cnt[b - 1];
          for (int a = 0; a < 3; a++) {
            llo[a] = std::min(llo[a], binlo[b - 1][a]);
            lhi[a] = std::max(lhi[a], binhi[b - 1][a]);
          }
          if (lacc == 0 || rcnt[b] == 0) continue;
          double cost = half_area(llo, lhi) * (double)lacc + rsa[b] * (double)rcnt[b];
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = ax;
            best_plane = b;
          }
        }
      }
      if (best_axis >= 0) {
        axis = best_axis;
        const double* c = cents[axis];
        double ext = cmax[axis] - cmin[axis];
        double plane = cmin[axis] + (double)best_plane * (ext / NB);
        split = std::stable_partition(first, last,
                                      [&](int64_t p) { return c[p] < plane; });
      } else {
        // no plane separates the centroids: the midpoint rule, as
        // _build_numpy's _split_sah does
        split = split_midpoint(first, last, cents, cmin, cmax, &axis);
      }
    } else {
      // --- reference midpoint split ----------------------------------
      split = split_midpoint(first, last, cents, cmin, cmax, &axis);
    }
    if (split == first || split == last) {
      // degenerate (all centroids on one side): median split on the axis
      // the split used
      split = split_median(first, last, cents[axis]);
    }
    int64_t m = split - order;
    // pre-order: left child next; push right AFTER left so left pops first
    fs.push_back({m, f.end, -1, 0});
    fs.push_back({f.begin, m, -1, 0});
  }
  return n_nodes;
}

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.
// Inputs: lo/hi [n,3] float64 primitive bounds.
// Outputs (caller-allocated, capacity 2n+2 nodes / n order entries):
//   bounds_lo/bounds_hi [cap,3] float32, is_leaf [cap] uint8,
//   prim_start/prim_count/escape [cap] int32, order [n] int64.
int64_t bvh_build(const double* lo, const double* hi, int64_t n,
                  int64_t max_leaf, float* bounds_lo, float* bounds_hi,
                  uint8_t* is_leaf, int32_t* prim_start, int32_t* prim_count,
                  int32_t* escape, int64_t* order) {
  return build_impl(0, lo, hi, n, max_leaf, bounds_lo, bounds_hi, is_leaf,
                    prim_start, prim_count, escape, order);
}

// Binned-SAH variant; identical contract.
int64_t bvh_build_sah(const double* lo, const double* hi, int64_t n,
                      int64_t max_leaf, float* bounds_lo, float* bounds_hi,
                      uint8_t* is_leaf, int32_t* prim_start,
                      int32_t* prim_count, int32_t* escape, int64_t* order) {
  return build_impl(1, lo, hi, n, max_leaf, bounds_lo, bounds_hi, is_leaf,
                    prim_start, prim_count, escape, order);
}

}  // extern "C"
