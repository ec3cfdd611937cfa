// Two-level clustered ray / triangle closest hit and any hit.
//
// Replaces the TPU kernel bidirectional_pathtracing_tpu/ops/
// intersect_clustered.py `_clustered_kernel` (launched by
// `tri_closest_hit_clustered`).  It computes the same function over the
// same tables (scene/clusters.py, flat layout), not the TPU mechanics
// (survivor bitmask words in int32 scalars, the 32-slot DMA ring, prim ids
// in f32 mantissas, 16-row DMA padding are Mosaic workarounds):
//
//   * for each block b of 128 clusters, a slab test of the ray against the
//     block's merged AABB (block_b [NBpad, 8]); a miss skips 16,384
//     triangle slots at once;
//   * for each member cluster c < n_clusters of a surviving block, a slab
//     test against the cluster's AABB (cluster_b [8, c_pad], SoA rows
//     lo.xyz, hi.xyz), both tests against the window
//     [min_t, min(max_t, best_t at the start of the block)] as in the TPU
//     kernel (:172-198).  Padding clusters (c >= n_clusters) carry inverted
//     +-inf bounds that pass the test; they are skipped by index and never
//     read;
//   * Möller–Trumbore on the filled lanes of a surviving cluster, those
//     whose pad2global entry is >= 0, the slots the plain version scans
//     (tris [C, 9, 128]: row k holds coordinate k of v0, v1, v2; edges
//     e1 = v1 - v0, e2 = v2 - v0 computed here, as the TPU kernel does;
//     the TPU kernel runs all 128 lanes, but unfilled lanes hold zero
//     triangles that never hit), accepting t when
//     min_t <= t <= min(max_t, best_t) and moving
//     the winner only on strict t < best_t.  Clusters ascend, lanes ascend,
//     so the lowest padded slot wins on equal t, exactly as the TPU
//     kernel's cmin / hit_iota / closer (:122-128).
//   * out: t (1e30 on a miss) and the padded slot c * 128 + lane as int32
//     (-1 on a miss).  any_hit: a ray stops at its first accepted triangle
//     (the TPU kernel poisons its window, :129-136); t is then -1e30 and
//     only slot >= 0 is defined.
//
// The result of a ray depends on nothing but that ray and the tables: no
// grouping, no ray order (the optional sorted dispatch relies on it).
//
// Work split: one thread per ray, 128 rays per block, grid sized from R
// with a bounds check.  The loops over blocks, clusters and lanes are the
// same for every thread, so a warp whose rays pass the same cluster runs
// its Möller–Trumbore loop together, every lane reading the same triangle
// (a broadcast); lanes whose slab test failed sit it out.  That is the
// warp-level form of the TPU's tile union, without the ballot.  The sorted
// dispatch (ops/intersect.py SORTED) groups rays that cut the same
// clusters into the same warps.
//
// What bounds it on an H100: arithmetic and latency of dependent loads.
// Each ray-triangle pair costs about 30 flops and 36 bytes of reads, served
// from L1/L2 (the L=6 mesh box's tables are about 9 MB, inside the 50 MB
// L2); each cluster visit costs 6 bound reads and about 20 flops.  Making
// it fast (staging clusters in shared memory, a persistent ray queue) is
// later work.
//
// Rounding: built with -fmad=false, so every multiply and add rounds as the
// plain torch version's separate elementwise kernels do, with dot products
// summed left to right; slab tests use inv_d = d == 0 ? 1e30 : 1 / d with
// the finite sentinel, never inf, as the TPU kernel does (:79-81).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;     // INF_D of the renderer (finite sentinel)
constexpr int kThreads = 128;     // rays (threads) per CUDA block
constexpr int kLanes = 128;       // triangle slots per cluster (CLUSTER_SIZE)
constexpr int kPerBlock = 128;    // clusters per block (BLOCK_SIZE)

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// The TPU kernel's slab test (:175-180): per axis a = (lo - o) * inv_d,
// b = (hi - o) * inv_d, then tmin = max(tmin, min(a, b)) and
// tmax = min(tmax, max(a, b)) from (-1e30, 1e30).
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float min_t, float limit) {
  float tmin = -kInf, tmax = kInf;
  float a = (lx - r.ox) * r.ix, b = (hx - r.ox) * r.ix;
  tmin = fmaxf(tmin, fminf(a, b));
  tmax = fminf(tmax, fmaxf(a, b));
  a = (ly - r.oy) * r.iy;
  b = (hy - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(a, b));
  tmax = fminf(tmax, fmaxf(a, b));
  a = (lz - r.oz) * r.iz;
  b = (hz - r.oz) * r.iz;
  tmin = fmaxf(tmin, fminf(a, b));
  tmax = fminf(tmax, fmaxf(a, b));
  return tmax >= tmin && tmax >= min_t && tmin <= limit;
}

__device__ __forceinline__ float inv_dir(float d) {
  return d == 0.f ? kInf : 1.f / d;
}

__global__ void __launch_bounds__(kThreads)
clustered_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ min_t,
                     const float* __restrict__ max_t,
                     const float* __restrict__ block_b, int n_blocks,
                     const float* __restrict__ cluster_b, int c_pad,
                     const float* __restrict__ tris,
                     const int32_t* __restrict__ pad2global, int n_clusters,
                     int any_hit, float* __restrict__ t_out,
                     int32_t* __restrict__ slot_out, int n_rays) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  Ray ray;
  ray.ox = o[3 * r + 0];
  ray.oy = o[3 * r + 1];
  ray.oz = o[3 * r + 2];
  ray.dx = d[3 * r + 0];
  ray.dy = d[3 * r + 1];
  ray.dz = d[3 * r + 2];
  ray.ix = inv_dir(ray.dx);
  ray.iy = inv_dir(ray.dy);
  ray.iz = inv_dir(ray.dz);
  const float lo = min_t[r];
  const float hi = max_t[r];

  float best_t = kInf;
  int32_t best = -1;
  // hi < lo: no t satisfies lo <= t <= hi, so nothing can be accepted
  bool done = !(hi >= lo);
  for (int b = 0; b < n_blocks && !done; ++b) {
    const float limit = fminf(hi, best_t);
    const float* bb = block_b + 8 * b;
    if (!slab(ray, __ldg(bb + 0), __ldg(bb + 1), __ldg(bb + 2),
              __ldg(bb + 3), __ldg(bb + 4), __ldg(bb + 5), lo, limit)) {
      continue;
    }
    const int c_end = min((b + 1) * kPerBlock, n_clusters);
    for (int c = b * kPerBlock; c < c_end && !done; ++c) {
      if (!slab(ray, __ldg(cluster_b + c), __ldg(cluster_b + c_pad + c),
                __ldg(cluster_b + 2 * c_pad + c),
                __ldg(cluster_b + 3 * c_pad + c),
                __ldg(cluster_b + 4 * c_pad + c),
                __ldg(cluster_b + 5 * c_pad + c), lo, limit)) {
        continue;
      }
      const float* v = tris + static_cast<size_t>(c) * 9 * kLanes;
      const int32_t* filled = pad2global + static_cast<size_t>(c) * kLanes;
      for (int j = 0; j < kLanes; ++j) {
        if (__ldg(filled + j) < 0) continue;
        const float v0x = __ldg(v + 0 * kLanes + j);
        const float v0y = __ldg(v + 1 * kLanes + j);
        const float v0z = __ldg(v + 2 * kLanes + j);
        const float e1x = __ldg(v + 3 * kLanes + j) - v0x;
        const float e1y = __ldg(v + 4 * kLanes + j) - v0y;
        const float e1z = __ldg(v + 5 * kLanes + j) - v0z;
        const float e2x = __ldg(v + 6 * kLanes + j) - v0x;
        const float e2y = __ldg(v + 7 * kLanes + j) - v0y;
        const float e2z = __ldg(v + 8 * kLanes + j) - v0z;
        const float sx = ray.ox - v0x, sy = ray.oy - v0y, sz = ray.oz - v0z;
        // s1 = d x e2, s2 = s x e1
        const float s1x = ray.dy * e2z - ray.dz * e2y;
        const float s1y = ray.dz * e2x - ray.dx * e2z;
        const float s1z = ray.dx * e2y - ray.dy * e2x;
        const float s2x = sy * e1z - sz * e1y;
        const float s2y = sz * e1x - sx * e1z;
        const float s2z = sx * e1y - sy * e1x;
        const float denom = s1x * e1x + s1y * e1y + s1z * e1z;
        const float inv = denom == 0.f ? 0.f : 1.f / denom;
        const float t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
        const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
        const float b2 = (s2x * ray.dx + s2y * ray.dy + s2z * ray.dz) * inv;
        const bool ok = denom != 0.f && t >= lo && t <= fminf(hi, best_t) &&
                        b1 >= 0.f && b2 >= 0.f && b1 + b2 <= 1.f;
        if (!ok) continue;
        if (any_hit) {
          best_t = -kInf;
          best = c * kLanes + j;
          done = true;
          break;
        }
        if (t < best_t) {
          best_t = t;
          best = c * kLanes + j;
        }
      }
    }
  }
  t_out[r] = best_t;
  slot_out[r] = best;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All arrays are contiguous device
// memory: o, d [n_rays, 3]; min_t, max_t, t_out, slot_out [n_rays];
// block_b [>= n_blocks, 8]; cluster_b [8, c_pad]; tris [n_clusters, 9, 128];
// pad2global [n_clusters * 128] (global triangle id of a slot, -1 if
// empty).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int clustered_hit(const float* o, const float* d,
                             const float* min_t, const float* max_t,
                             const float* block_b, int n_blocks,
                             const float* cluster_b, int c_pad,
                             const float* tris, const int32_t* pad2global,
                             int n_clusters, int any_hit, float* t_out,
                             int32_t* slot_out, int n_rays, void* stream) {
  if (n_rays > 0) {
    const unsigned grid =
        static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
    clustered_hit_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        o, d, min_t, max_t, block_b, n_blocks, cluster_b, c_pad, tris,
        pad2global, n_clusters, any_hit, t_out, slot_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}
