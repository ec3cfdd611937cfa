// Brute-force ray / triangle-soup closest hit with an in-kernel sphere tail.
//
// Replaces the TPU kernel bidirectional_pathtracing_tpu/ops/intersect_pallas.py
// `_tri_kernel` (launched by `tri_closest_hit_pallas`).  It computes the same
// function, not the TPU block layout:
//
//   * for every ray, Möller–Trumbore against every triangle of a [T, 9] table
//     (v0, e1 = v1 - v0, e2 = v2 - v0; padded / invalid rows are zero, so
//     their denominator is 0 and they never hit), keeping the closest t in
//     the window min_t <= t <= min(max_t, best_t);
//   * then each sphere (cx, cy, cz, r, valid) of a [Q, 5] table, nearer
//     in-range root first (reference sphere.cpp:11-57);
//   * out: t (1e30 on a miss) and prim as int32: the triangle index, or
//     prim_base + q for sphere q, or -1.
//
// Tie rules (kept exactly): the lowest triangle index wins among equal t
// (ascending scan, strict <); spheres update only on strict <, so a triangle
// wins a tie with a sphere and the lower sphere index wins a sphere tie.
// denom == 0 never hits; a sphere with valid == 0 never hits.  Any hit is
// the same launch read as prim >= 0.
//
// Work split: one thread per ray, 128 rays per block, grid sized from R with
// a bounds check for the ragged last block.  The triangle table streams
// through shared memory in chunks of 256 triangles (9 KB): the whole table
// cannot stay resident the way VMEM held it on the TPU (at the 8,192-
// triangle cap [9, 8192] f32 is 288 KB, above the 227 KB a block may use).
// All threads of a warp read the same triangle, so every shared-memory load
// is a broadcast with no bank conflict.
//
// What bounds it on an H100: arithmetic.  Each ray-triangle pair costs about
// 30 flops and 36 bytes of shared-memory reads, and no device-memory traffic
// beyond the 32 bytes in and 8 bytes out per ray.  The design keeps the ray
// in registers for the whole scan and amortises one cooperative, coalesced
// load of each triangle chunk over 128 rays.
//
// Rounding: built with -fmad=false, so every multiply and add rounds as the
// plain torch version's separate elementwise kernels do, with the dot
// products summed in the same left-to-right order.  t then agrees with the
// plain version to within an ulp or two rather than to FMA-contraction noise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;     // INF_D of the renderer (finite sentinel)
constexpr int kBlock = 128;       // rays (threads) per block
constexpr int kStage = 256;       // triangles per shared-memory chunk
constexpr int kTriFloats = 9;
constexpr int kSphFloats = 5;

__global__ void __launch_bounds__(kBlock)
brute_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ min_t,
                 const float* __restrict__ max_t,
                 const float* __restrict__ tris, int n_tris,
                 const float* __restrict__ sph, int n_sph, int prim_base,
                 float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                 int n_rays) {
  __shared__ float s_tri[kStage * kTriFloats];

  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float lo = 0.f, hi = -1.f;
  if (live) {
    ox = o[3 * r + 0];
    oy = o[3 * r + 1];
    oz = o[3 * r + 2];
    dx = d[3 * r + 0];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    lo = min_t[r];
    hi = max_t[r];
  }

  float best_t = kInf;
  int32_t best_i = -1;

  for (int base = 0; base < n_tris; base += kStage) {
    const int n = min(kStage, n_tris - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < n * kTriFloats; k += kBlock) {
      s_tri[k] = tris[base * kTriFloats + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* v = s_tri + j * kTriFloats;
      const float e1x = v[3], e1y = v[4], e1z = v[5];
      const float e2x = v[6], e2y = v[7], e2z = v[8];
      const float sx = ox - v[0], sy = oy - v[1], sz = oz - v[2];
      // s1 = d x e2, s2 = s x e1
      const float s1x = dy * e2z - dz * e2y;
      const float s1y = dz * e2x - dx * e2z;
      const float s1z = dx * e2y - dy * e2x;
      const float s2x = sy * e1z - sz * e1y;
      const float s2y = sz * e1x - sx * e1z;
      const float s2z = sx * e1y - sy * e1x;
      const float denom = s1x * e1x + s1y * e1y + s1z * e1z;
      const float inv = denom == 0.f ? 0.f : 1.f / denom;
      const float t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
      const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
      const float b2 = (s2x * dx + s2y * dy + s2z * dz) * inv;
      const bool ok = denom != 0.f && t >= lo && t <= fminf(hi, best_t) &&
                      b1 >= 0.f && b2 >= 0.f && b1 + b2 <= 1.f;
      if (ok && t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  if (!live) return;

  // sphere tail: the table is tiny and read through the read-only cache
  const float a = dx * dx + dy * dy + dz * dz;
  for (int q = 0; q < n_sph; ++q) {
    const float* s = sph + q * kSphFloats;
    const float cx = __ldg(s + 0), cy = __ldg(s + 1), cz = __ldg(s + 2);
    const float rr = __ldg(s + 3), valid = __ldg(s + 4);
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float b = 2.f * (ocx * dx + ocy * dy + ocz * dz);
    const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - rr * rr;
    const float delta = b * b - 4.f * a * cc;
    const float sq = sqrtf(fmaxf(delta, 0.f));
    const float t1 = (-b - sq) / (2.f * a);
    const float t2 = (-b + sq) / (2.f * a);
    const float lim = fminf(hi, best_t);
    const bool in1 = t1 >= lo && t1 <= lim;
    const bool in2 = t2 >= lo && t2 <= lim;
    const float ts = in1 ? t1 : t2;
    const bool ok = valid > 0.f && delta >= 0.f && (in1 || in2);
    if (ok && ts < best_t) {
      best_t = ts;
      best_i = prim_base + q;
    }
  }
  t_out[r] = best_t;
  prim_out[r] = best_i;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All arrays are contiguous device
// memory: o, d [n_rays, 3]; min_t, max_t, t_out, prim_out [n_rays];
// tris [n_tris, 9]; sph [n_sph, 5].  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int brute_hit(const float* o, const float* d, const float* min_t,
                         const float* max_t, const float* tris, int n_tris,
                         const float* sph, int n_sph, int prim_base,
                         float* t_out, int32_t* prim_out, int n_rays,
                         void* stream) {
  if (n_rays > 0) {
    const unsigned grid = static_cast<unsigned>((n_rays + kBlock - 1) / kBlock);
    brute_hit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, min_t, max_t, tris, n_tris, sph, n_sph, prim_base, t_out,
        prim_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}
