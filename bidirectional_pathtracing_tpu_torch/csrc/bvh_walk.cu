// Stackless BVH walk over escape links: closest hit and any hit, one thread
// per ray.
//
// This kernel is not the counterpart of a TPU kernel.  It replaces the
// `lax.while_loop` of bidirectional_pathtracing_tpu/ops/intersect.py
// `intersect_bvh` (:270-383): the JAX package's route for a large scene
// without cluster tables, one device program that loops on the chip.
// Eager PyTorch runs such a loop as about a hundred launches and a host
// sync for every node step (ops/intersect.py intersect_bvh, the plain
// version), and a ray of a 164k-triangle tree takes hundreds to thousands
// of steps, so the loop is a kernel of its own.
//
// What it computes, for every ray r:
//
//   * the walk of the flattened pre-order tree (scene/types.py BVHArrays):
//     at node i, the slab test of its box against [min_t, min(max_t,
//     best_t)]; on a crossed leaf, each of its prim_count primitives in
//     leaf order (prim_order[prim_start ...]); then node i + 1 into a
//     crossed inner node, else escape[i]; the walk ends at escape == N;
//   * a primitive is a triangle (global id < n_tris: Möller–Trumbore) or a
//     sphere (the quadratic with unit d, nearer in-window root first);
//     the window is [min_t, min(max_t, best_t)] and strict t < best_t, so
//     the first of equal t in walk order wins, as in the JAX walk;
//   * closest hit: t (1e30 on a miss), valid, the unit shading normal (the
//     triangle's vertex normals weighted by (1 - b1 - b2, b1, b2), or the
//     sphere's analytic normal at t), the material and the global prim id
//     (-1 and a zero normal on a miss), as ops/intersect.py Hit holds them;
//   * any hit: whether some primitive lies in the window; the walk stops at
//     the first one.
//
// Rounding: built with -fmad=false (ops/_build.py), every multiply and add
// rounds on its own, in the plain version's order (ops/intersect.py
// _slab3, _walk_prim, bvh_resolve), the dot products summed left to right;
// division and sqrt are IEEE (nvcc's defaults), and min / max propagate a
// NaN as torch.minimum / torch.maximum do.  So t, valid, prim, mat and the
// any hit equal the plain version's bit for bit.
//
// What bounds it on an H100: the walk is a chain of dependent loads (a
// node, then its leaf's primitives) whose count differs from ray to ray,
// so lanes of a warp idle while the longest walk of the warp finishes, and
// each step waits on a load from device memory or L2.  The tables of the
// 164k-triangle box (about 3 MB of nodes, 6 MB of triangles) stay in the
// 50 MB L2.  This first design is simple and right: one thread per ray,
// the node arrays as the BVH holds them (structure of arrays).  A 32-byte
// node, the nearer child first and a short stack are later work (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;   // INF_D of the renderer (finite sentinel)
constexpr int kBlock = 128;     // threads per block

struct Tables {
  // the tree
  const float* bounds_lo;    // [N, 3]
  const float* bounds_hi;    // [N, 3]
  const uint8_t* is_leaf;    // [N]
  const int32_t* prim_start; // [N]
  const int32_t* prim_count; // [N]
  const int32_t* escape;     // [N]
  const int32_t* prim_order; // [P]
  int n_nodes;
  // the geometry
  const float* tri_p;        // [T, 9] v0, v1, v2
  const float* tri_n;        // [T, 9] n0, n1, n2
  const int32_t* tri_mat;    // [T]
  int n_tris;
  const float* sph;          // [Q, 4] cx cy cz r
  const int32_t* sph_mat;    // [Q]
};

struct Rays {
  const float* o;            // [R, 3]
  const float* d;            // [R, 3]
  const float* min_t;        // [R]
  const float* max_t;        // [R]
  int n;
};

struct Out {
  float* t;                  // [R]
  uint8_t* valid;            // [R] (bool); any hit: the result
  float* n;                  // [R, 3]
  int32_t* mat;              // [R]
  int32_t* prim;             // [R]
};

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
bvh_walk_kernel(const Rays rays, const Tables tb, const Out out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= rays.n) return;
  const float ox = rays.o[3 * r + 0], oy = rays.o[3 * r + 1],
              oz = rays.o[3 * r + 2];
  const float dx = rays.d[3 * r + 0], dy = rays.d[3 * r + 1],
              dz = rays.d[3 * r + 2];
  const float lo = rays.min_t[r], hi = rays.max_t[r];
  const float ix = dx == 0.f ? kInf : 1.f / dx;
  const float iy = dy == 0.f ? kInf : 1.f / dy;
  const float iz = dz == 0.f ? kInf : 1.f / dz;

  float best_t = kInf, best_b1 = 0.f, best_b2 = 0.f;
  int best = -1;
  int ptr = 0;
  while (ptr < tb.n_nodes) {
    // slab test (ops/intersect.py _slab3)
    const float* bl = tb.bounds_lo + 3 * ptr;
    const float* bh = tb.bounds_hi + 3 * ptr;
    const float x0 = (bl[0] - ox) * ix, x1 = (bh[0] - ox) * ix;
    const float y0 = (bl[1] - oy) * iy, y1 = (bh[1] - oy) * iy;
    const float z0 = (bl[2] - oz) * iz, z1 = (bh[2] - oz) * iz;
    const float t_near = tmax(tmax(tmin(x0, x1), tmin(y0, y1)), tmin(z0, z1));
    const float t_far = tmin(tmin(tmax(x0, x1), tmax(y0, y1)), tmax(z0, z1));
    const bool box = t_far >= t_near && t_far >= lo &&
                     t_near <= tmin(hi, best_t);
    const bool leaf = tb.is_leaf[ptr] != 0;
    if (box && leaf) {
      const int start = tb.prim_start[ptr];
      const int count = tb.prim_count[ptr];
      for (int k = 0; k < count; ++k) {
        const int pid = tb.prim_order[start + k];
        const float lim = tmin(hi, best_t);
        float t;
        float b1 = 0.f, b2 = 0.f;
        bool ok;
        if (pid < tb.n_tris) {
          // Möller–Trumbore (ops/intersect.py _walk_prim)
          const float* v = tb.tri_p + 9 * pid;
          const float p0x = v[0], p0y = v[1], p0z = v[2];
          const float e1x = v[3] - p0x, e1y = v[4] - p0y, e1z = v[5] - p0z;
          const float e2x = v[6] - p0x, e2y = v[7] - p0y, e2z = v[8] - p0z;
          const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
          const float s1x = dy * e2z - dz * e2y;
          const float s1y = dz * e2x - dx * e2z;
          const float s1z = dx * e2y - dy * e2x;
          const float s2x = sy * e1z - sz * e1y;
          const float s2y = sz * e1x - sx * e1z;
          const float s2z = sx * e1y - sy * e1x;
          const float den = s1x * e1x + s1y * e1y + s1z * e1z;
          const float inv = den == 0.f ? 0.f : 1.f / den;
          t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
          b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
          b2 = (s2x * dx + s2y * dy + s2z * dz) * inv;
          ok = den != 0.f && t >= lo && t <= lim && b1 >= 0.f &&
               b2 >= 0.f && b1 + b2 <= 1.f;
        } else {
          // the sphere quadratic with unit d
          const float* c = tb.sph + 4 * (pid - tb.n_tris);
          const float ocx = ox - c[0], ocy = oy - c[1], ocz = oz - c[2];
          const float rr = c[3];
          const float b = 2.f * (ocx * dx + ocy * dy + ocz * dz);
          const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - rr * rr;
          const float delta = b * b - 4.f * cc;
          const float sq = sqrtf(tmax(delta, 0.f));
          const float t1 = (-b - sq) / 2.f;
          const float t2 = (-b + sq) / 2.f;
          const bool in1 = t1 >= lo && t1 <= lim;
          const bool in2 = t2 >= lo && t2 <= lim;
          t = in1 ? t1 : t2;
          ok = delta >= 0.f && (in1 || in2);
        }
        if (ok && t < best_t) {
          best_t = t;
          best = pid;
          best_b1 = b1;
          best_b2 = b2;
          if (kAny) break;
        }
      }
      if (kAny && best >= 0) break;
    }
    ptr = (box && !leaf) ? ptr + 1 : tb.escape[ptr];
  }

  if (kAny) {
    out.valid[r] = best >= 0;
    return;
  }
  // the winner's record (ops/intersect.py bvh_resolve)
  float nx = 0.f, ny = 0.f, nz = 0.f;
  int mat = -1;
  if (best >= 0 && best < tb.n_tris) {
    const float* n = tb.tri_n + 9 * best;
    const float w0 = (1.f - best_b1) - best_b2;
    nx = n[0] * w0 + n[3] * best_b1 + n[6] * best_b2;
    ny = n[1] * w0 + n[4] * best_b1 + n[7] * best_b2;
    nz = n[2] * w0 + n[5] * best_b1 + n[8] * best_b2;
    mat = tb.tri_mat[best];
  } else if (best >= 0) {
    const int q = best - tb.n_tris;
    const float* c = tb.sph + 4 * q;
    nx = (ox + best_t * dx) - c[0];
    ny = (oy + best_t * dy) - c[1];
    nz = (oz + best_t * dz) - c[2];
    mat = tb.sph_mat[q];
  }
  if (best >= 0) {
    const float len = tmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
    nx = nx / len;
    ny = ny / len;
    nz = nz / len;
  }
  out.t[r] = best_t;
  out.valid[r] = best_t < kInf;
  out.n[3 * r + 0] = nx;
  out.n[3 * r + 1] = ny;
  out.n[3 * r + 2] = nz;
  out.mat[r] = mat;
  out.prim[r] = best;
}

}  // namespace

extern "C" {

// Closest hit (any_hit == 0: t, valid, n, mat, prim) or any hit (valid
// only) of n_rays rays; launches on `stream` and returns the launch's
// cudaError_t (0 on success).  Every pointer is device memory; the table
// layouts are those of struct Tables above.
int bvh_walk(const float* o, const float* d, const float* min_t,
             const float* max_t, int n_rays, const float* bounds_lo,
             const float* bounds_hi, const uint8_t* is_leaf,
             const int32_t* prim_start, const int32_t* prim_count,
             const int32_t* escape, const int32_t* prim_order, int n_nodes,
             const float* tri_p, const float* tri_n, const int32_t* tri_mat,
             int n_tris, const float* sph, const int32_t* sph_mat,
             int any_hit, float* t_out, uint8_t* valid_out, float* n_out,
             int32_t* mat_out, int32_t* prim_out, cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  const Rays rays{o, d, min_t, max_t, n_rays};
  const Tables tb{bounds_lo, bounds_hi, is_leaf, prim_start, prim_count,
                  escape, prim_order, n_nodes, tri_p, tri_n, tri_mat,
                  n_tris, sph, sph_mat};
  const Out out{t_out, valid_out, n_out, mat_out, prim_out};
  const int blocks = (n_rays + kBlock - 1) / kBlock;
  if (any_hit) {
    bvh_walk_kernel<true><<<blocks, kBlock, 0, stream>>>(rays, tb, out);
  } else {
    bvh_walk_kernel<false><<<blocks, kBlock, 0, stream>>>(rays, tb, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
