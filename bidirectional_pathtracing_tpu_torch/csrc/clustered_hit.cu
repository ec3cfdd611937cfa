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
//   * for each member cluster c < n_clusters of a crossed block, a slab
//     test against the cluster's AABB (cluster_b [8, c_pad], SoA rows
//     lo.xyz, hi.xyz), both tests against the window
//     [min_t, min(max_t, best_t at the start of the block)] as in the TPU
//     kernel (:172-198).  Padding clusters (c >= n_clusters) carry inverted
//     +-inf bounds that pass the test; they are skipped by index and never
//     read;
//   * Möller–Trumbore on the filled slots of a crossed cluster, those whose
//     pad2global entry is >= 0 (tris [C, 9, 128]: row k holds coordinate k
//     of v0, v1, v2; edges e1 = v1 - v0, e2 = v2 - v0 formed here, as the
//     TPU kernel does), accepting t when min_t <= t <= min(max_t, best_t).
//     Per cluster the smallest accepted t wins, the lowest padded slot
//     among equal t, and it replaces the ray's best only on strict
//     t < best_t.  Clusters ascend, so the lowest padded slot wins on equal
//     t overall, exactly as the TPU kernel's cmin / hit_iota / closer
//     (:122-128);
//   * out: t (1e30 on a miss) and the padded slot c * 128 + lane as int32
//     (-1 on a miss).  any_hit: a ray stops at the first cluster where it
//     has an accepted triangle (the TPU kernel poisons its window,
//     :129-136); t is then -1e30 and only slot >= 0 is defined.
//
// The result of a ray depends on nothing but that ray and the tables: every
// slab test and every accepted t uses only that ray's window and its own
// running best_t, whichever lane computes it, so the optional sorted
// dispatch (ops/intersect.py SORTED) gives the same bits.
//
// What bounds it on an H100.  A ray's work is data dependent and small: on
// the level-6 mesh box an unoccluded shadow segment needs the 15 block
// tests, the member-cluster tests of the blocks it crosses and one or two
// clusters' Möller–Trumbore (about 8.5k flops, chip_smoke.py counts it);
// the tables (about 9 MB there) live in the 50 MB L2.  So the bound is FP32
// issue, with latency of L2 loads behind it.  With one thread per ray and
// the loops uniform over the warp, a warp ran a cluster's whole 128-slot
// loop whenever any of its 32 rays crossed it, and every lane slab-tested
// all 128 member clusters of every block any ray crossed: the lanes of
// incoherent rays idled on other rays' work (1.2 % of the bound).
//
// This design shares each ray's work across its warp.  A warp owns 32
// rays, one per lane, for the block tests; __ballot_sync gives the rays
// that cross a block.  For each of them in turn the warp broadcasts the ray
// with __shfl_sync and every lane slab-tests 4 member clusters (lane j:
// clusters j, j+32, j+64, j+96 of the block, bounds loaded once a block),
// keeping a 32-bit set of crossing rays per cluster in shared memory.  Then
// the clusters with a non-empty set, in ascending order: the warp loads the
// cluster's filled slots once, lane-strided into registers (lane j: slots
// j, j+32, j+64, j+96; v0, e1, e2 formed once), and for each ray of the set
// every lane tests its 4 triangles; two __reduce_min_sync steps pick the
// smallest t (as an order-preserving int), then the lowest slot among
// equal t, and the owning lane updates its ray.  Warp instructions per
// (ray, cluster) pair drop from about 7,700 (the whole loop, however few
// rays needed it) to about 300.  A slot group (32 slots) that is empty for
// the whole warp is skipped.  Rays that are done (dead windows, any-hit
// rays with a hit) leave every set; the warp stops once all are done.
// Block shape: 128 threads, at least 5 CUDA blocks per SM (96 registers,
// 2 KB of shared memory, 20 warps an SM), picked by timing other thread
// counts and occupancies on the card.
//
// No tensor cores: a TF32 product would change the numbers, and the
// results stay FP32-exact.
//
// Rounding: built with -fmad=false, so every multiply and add rounds as the
// plain torch version's separate elementwise kernels do, with dot products
// summed left to right and IEEE 1 / denom; slab tests use
// inv_d = d == 0 ? 1e30 : 1 / d with the finite sentinel, never inf, as the
// TPU kernel does (:79-81).  Each ray-triangle test is bitwise the one-
// thread-per-ray kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;     // INF_D of the renderer (finite sentinel)
constexpr int kThreads = 128;     // threads per CUDA block: 4 warps
constexpr int kMinBlocks = 5;     // CUDA blocks per SM: <= 102 registers
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;       // triangle slots per cluster (CLUSTER_SIZE)
constexpr int kPerBlock = 128;    // clusters per block (BLOCK_SIZE)
constexpr int kPerLane = 4;       // slots (and member clusters) per lane
constexpr unsigned kAll = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // "no accepted triangle" key and slot

static_assert(kLanes == 32 * kPerLane && kPerBlock == 32 * kPerLane,
              "a lane covers 4 slots of a cluster and 4 clusters of a block");

// The TPU kernel's slab test (:175-180): per axis a = (lo - o) * inv_d,
// b = (hi - o) * inv_d, then tmin = max(tmin, min(a, b)) and
// tmax = min(tmax, max(a, b)) from (-1e30, 1e30).
__device__ __forceinline__ bool slab(float ox, float oy, float oz, float ix,
                                     float iy, float iz, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float min_t, float limit) {
  float tmin = -kInf, tmax = kInf;
  float a = (lx - ox) * ix, b = (hx - ox) * ix;
  tmin = fmaxf(tmin, fminf(a, b));
  tmax = fminf(tmax, fmaxf(a, b));
  a = (ly - oy) * iy;
  b = (hy - oy) * iy;
  tmin = fmaxf(tmin, fminf(a, b));
  tmax = fminf(tmax, fmaxf(a, b));
  a = (lz - oz) * iz;
  b = (hz - oz) * iz;
  tmin = fmaxf(tmin, fminf(a, b));
  tmax = fminf(tmax, fmaxf(a, b));
  return tmax >= tmin && tmax >= min_t && tmin <= limit;
}

__device__ __forceinline__ float inv_dir(float d) {
  return d == 0.f ? kInf : 1.f / d;
}

// A staged triangle: v0 and the edges e1 = v1 - v0, e2 = v2 - v0.
struct Tri {
  float x, y, z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Möller–Trumbore of one ray against one staged triangle, in the plain
// version's order; returns whether t is accepted in [lo, lim].
__device__ __forceinline__ bool moller_trumbore(const Tri& v, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz, float lo,
                                                float lim, float& t_out) {
  const float sx = ox - v.x, sy = oy - v.y, sz = oz - v.z;
  // s1 = d x e2, s2 = s x e1
  const float s1x = dy * v.e2z - dz * v.e2y;
  const float s1y = dz * v.e2x - dx * v.e2z;
  const float s1z = dx * v.e2y - dy * v.e2x;
  const float s2x = sy * v.e1z - sz * v.e1y;
  const float s2y = sz * v.e1x - sx * v.e1z;
  const float s2z = sx * v.e1y - sy * v.e1x;
  const float denom = s1x * v.e1x + s1y * v.e1y + s1z * v.e1z;
  const float inv = denom == 0.f ? 0.f : 1.f / denom;
  const float t = (s2x * v.e2x + s2y * v.e2y + s2z * v.e2z) * inv;
  const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
  const float b2 = (s2x * dx + s2y * dy + s2z * dz) * inv;
  t_out = t;
  return denom != 0.f && t >= lo && t <= lim && b1 >= 0.f && b2 >= 0.f &&
         b1 + b2 <= 1.f;
}

// An int that orders like the float t (-0 as +0, so equal t give equal
// keys); never kNone for a finite t.
__device__ __forceinline__ int order_key(float t) {
  const int i = __float_as_int(t == 0.f ? 0.f : t);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
clustered_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ min_t,
                     const float* __restrict__ max_t,
                     const float* __restrict__ block_b, int n_blocks,
                     const float* __restrict__ cluster_b, int c_pad,
                     const float* __restrict__ tris,
                     const int32_t* __restrict__ pad2global, int n_clusters,
                     int any_hit, float* __restrict__ t_out,
                     int32_t* __restrict__ slot_out, int n_rays) {
  // per warp: the set of crossing rays of each member cluster of a block
  __shared__ unsigned crossing[kWarps][kPerBlock];
  unsigned* sets = crossing[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n_rays;

  // lane's own ray; lanes past the end get an empty window
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float lo = 0.f, hi = -1.f;
  if (in_range) {
    ox = o[3 * r + 0];
    oy = o[3 * r + 1];
    oz = o[3 * r + 2];
    dx = d[3 * r + 0];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    lo = min_t[r];
    hi = max_t[r];
  }
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float best_t = kInf;
  int32_t best = -1;
  // hi < lo: no t satisfies lo <= t <= hi, so nothing can be accepted
  unsigned done = __ballot_sync(kAll, !(hi >= lo));

  for (int b = 0; b < n_blocks && done != kAll; ++b) {
    // level 1: the block's AABB, each lane its own ray
    const float limit = fminf(hi, best_t);
    const float* bb = block_b + 8 * b;
    const bool mine = !((done >> lane) & 1u) &&
                      slab(ox, oy, oz, ix, iy, iz, __ldg(bb + 0),
                           __ldg(bb + 1), __ldg(bb + 2), __ldg(bb + 3),
                           __ldg(bb + 4), __ldg(bb + 5), lo, limit);
    unsigned rays = __ballot_sync(kAll, mine);
    if (rays == 0u) continue;

    // level 2: lane j slab-tests clusters j + 32 m of the block against
    // each crossing ray in turn
    const int c0 = b * kPerBlock;
    const int n_member = min(kPerBlock, n_clusters - c0);
    float box[kPerLane][6];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int c = c0 + lane + 32 * m;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        box[m][k] = lane + 32 * m < n_member
                        ? __ldg(cluster_b + k * c_pad + c) : 0.f;
      }
    }
    unsigned cross[kPerLane] = {0u, 0u, 0u, 0u};
    while (rays != 0u) {
      const int k = __ffs(rays) - 1;
      rays &= rays - 1u;
      const float kox = __shfl_sync(kAll, ox, k);
      const float koy = __shfl_sync(kAll, oy, k);
      const float koz = __shfl_sync(kAll, oz, k);
      const float kix = __shfl_sync(kAll, ix, k);
      const float kiy = __shfl_sync(kAll, iy, k);
      const float kiz = __shfl_sync(kAll, iz, k);
      const float klo = __shfl_sync(kAll, lo, k);
      const float klim = __shfl_sync(kAll, limit, k);
#pragma unroll
      for (int m = 0; m < kPerLane; ++m) {
        if (lane + 32 * m < n_member &&
            slab(kox, koy, koz, kix, kiy, kiz, box[m][0], box[m][1],
                 box[m][2], box[m][3], box[m][4], box[m][5], klo, klim)) {
          cross[m] |= 1u << k;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) sets[lane + 32 * m] = cross[m];
    __syncwarp();

    // level 3: the crossed clusters in ascending order
#pragma unroll 1
    for (int m = 0; m < kPerLane; ++m) {
      unsigned todo = __ballot_sync(kAll, sets[lane + 32 * m] != 0u);
      while (todo != 0u) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1u;
        unsigned set = sets[32 * m + j] & ~done;
        if (set == 0u) continue;
        const int c = c0 + 32 * m + j;

        // stage the cluster's filled slots, lane-strided, once per warp
        const float* v = tris + static_cast<size_t>(c) * 9 * kLanes;
        const int32_t* p2g = pad2global + static_cast<size_t>(c) * kLanes;
        Tri tri[kPerLane];
        unsigned filled[kPerLane];   // warp-wide: which lanes hold a slot
#pragma unroll
        for (int g = 0; g < kPerLane; ++g) {
          const int s = lane + 32 * g;
          filled[g] = __ballot_sync(kAll, __ldg(p2g + s) >= 0);
          if (filled[g] == 0u) continue;
          const float x = __ldg(v + 0 * kLanes + s);
          const float y = __ldg(v + 1 * kLanes + s);
          const float z = __ldg(v + 2 * kLanes + s);
          tri[g] = {x, y, z,
                    __ldg(v + 3 * kLanes + s) - x,
                    __ldg(v + 4 * kLanes + s) - y,
                    __ldg(v + 5 * kLanes + s) - z,
                    __ldg(v + 6 * kLanes + s) - x,
                    __ldg(v + 7 * kLanes + s) - y,
                    __ldg(v + 8 * kLanes + s) - z};
        }

        // every crossing ray against the staged slots, one ray at a time
        while (set != 0u) {
          const int k = __ffs(set) - 1;
          set &= set - 1u;
          const float kox = __shfl_sync(kAll, ox, k);
          const float koy = __shfl_sync(kAll, oy, k);
          const float koz = __shfl_sync(kAll, oz, k);
          const float kdx = __shfl_sync(kAll, dx, k);
          const float kdy = __shfl_sync(kAll, dy, k);
          const float kdz = __shfl_sync(kAll, dz, k);
          const float klo = __shfl_sync(kAll, lo, k);
          const float klim = __shfl_sync(kAll, fminf(hi, best_t), k);
          // the lane's best of its slots: smallest key, lowest slot
          int key = kNone, g_best = 0;
          float t_best = 0.f;
#pragma unroll
          for (int g = 0; g < kPerLane; ++g) {
            if (filled[g] == 0u) continue;
            float t;
            const bool ok = moller_trumbore(tri[g], kox, koy, koz, kdx, kdy,
                                            kdz, klo, klim, t) &&
                            ((filled[g] >> lane) & 1u);
            const int kg = ok ? order_key(t) : kNone;
            if (kg < key) {
              key = kg;
              t_best = t;
              g_best = g;
            }
          }
          const int key_min = __reduce_min_sync(kAll, key);
          if (key_min == kNone) continue;
          const int slot = c * kLanes + lane + 32 * g_best;
          const int slot_min =
              __reduce_min_sync(kAll, key == key_min ? slot : kNone);
          const float t_min = __shfl_sync(kAll, t_best, slot_min % 32);
          if (any_hit) {
            if (lane == k) {
              best_t = -kInf;
              best = slot_min;
            }
            done |= 1u << k;
          } else if (lane == k && t_min < best_t) {
            best_t = t_min;
            best = slot_min;
          }
        }
      }
    }
    __syncwarp();   // every lane has read sets before the next block
  }
  if (in_range) {
    t_out[r] = best_t;
    slot_out[r] = best;
  }
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
