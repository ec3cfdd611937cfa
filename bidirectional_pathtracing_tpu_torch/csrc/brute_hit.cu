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
// What bounds it on an H100: instruction issue (the shadow batch's 36 B a
// segment of device memory take about a third of its issue time).  A
// ray-triangle test is about 80 instructions in the built code
// (tools/kernel_sweep.py), 49 of them FP32 and about 15 the IEEE
// reciprocal's; built with -fmad=false (below), each multiply and add is an
// instruction of its own, so a kernel can reach at most about half of a
// bound that counts a fused multiply-add as two flops.  The design spends
// as little as it can beside that arithmetic:
//
//   * Tables of up to kParamTris triangles and kParamSph spheres (every
//     scene but a large soup: the Cornell box and the open env scene take
//     472 bytes) are a __grid_constant__ kernel parameter, copied by value
//     at the launch (two size classes), so a launch reads no table from
//     device memory.  Each block copies the table into shared memory once,
//     with one __syncthreads, and reads it from there: every thread of a
//     warp reads the same word (a broadcast).  Larger tables stream through
//     shared memory from device memory in chunks of 256 triangles (9 KB),
//     as the whole [8192, 9] table (288 KB) cannot stay resident.
//   * A thread holds kRPT = 2 rays, so each triangle read serves two tests.
//
// Measured on the card and dropped (PERF.md): 1 and 4 rays a thread,
// operands read straight from the constant bank instead of staged, and a
// warp-uniform early out after b1 (__any_sync): on the main path's rays
// some lane of a warp nearly always passes, so the vote costs more than it
// saves.
//
// Rounding: built with -fmad=false, so every multiply and add rounds as the
// plain torch version's separate elementwise kernels do, with the dot
// products summed in the same left-to-right order: the closest hit equals
// the plain version's bitwise.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kInf = 1e30f;     // INF_D of the renderer (finite sentinel)
constexpr int kBlock = 128;       // threads per block
constexpr int kStage = 256;       // triangles per shared-memory chunk
constexpr int kRPT = 2;           // rays a thread
constexpr int kTriFloats = 9;
constexpr int kSphFloats = 5;

// The largest parameter table: kernel parameters may take 32,764 bytes
// from CUDA 12.1 on (4,096 before), less the kernel's other arguments.
constexpr int kParamSph = 16;
#if CUDART_VERSION >= 12010
constexpr int kParamTris = 896;   // 896 x 36 + 16 x 20 = 32,576 bytes
#else
constexpr int kParamTris = 64;    // 64 x 36 + 16 x 20 = 2,624 bytes
#endif
// the two size classes a launch copies: the smaller that holds the table
constexpr int kSmallTris = 32;

template <int kTris>
struct ParamTables {
  float tri[kTris * kTriFloats];
  float sph[kParamSph * kSphFloats];
};

struct Rays {
  float ox[kRPT], oy[kRPT], oz[kRPT], dx[kRPT], dy[kRPT], dz[kRPT];
  float lo[kRPT], hi[kRPT], best_t[kRPT];
  int32_t best_i[kRPT];
};

// Ray k of this thread is base + k * kBlock (coalesced).  A ray past the
// end has d = 0 (denominator 0: no triangle) and an empty window.
__device__ __forceinline__ void load_rays(
    Rays& s, int base, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ min_t,
    const float* __restrict__ max_t, int n_rays) {
#pragma unroll
  for (int k = 0; k < kRPT; ++k) {
    const int r = base + k * kBlock;
    const bool live = r < n_rays;
    s.ox[k] = live ? o[3 * r + 0] : 0.f;
    s.oy[k] = live ? o[3 * r + 1] : 0.f;
    s.oz[k] = live ? o[3 * r + 2] : 0.f;
    s.dx[k] = live ? d[3 * r + 0] : 0.f;
    s.dy[k] = live ? d[3 * r + 1] : 0.f;
    s.dz[k] = live ? d[3 * r + 2] : 0.f;
    s.lo[k] = live ? min_t[r] : 0.f;
    s.hi[k] = live ? max_t[r] : -1.f;
    s.best_t[k] = kInf;
    s.best_i[k] = -1;
  }
}

// Möller–Trumbore of the thread's rays against triangle v (9 floats), index
// idx, in the plain version's order of operations.
__device__ __forceinline__ void test_tri(const float* __restrict__ v, int idx,
                                         Rays& s) {
  const float v0x = v[0], v0y = v[1], v0z = v[2];
  const float e1x = v[3], e1y = v[4], e1z = v[5];
  const float e2x = v[6], e2y = v[7], e2z = v[8];
#pragma unroll
  for (int k = 0; k < kRPT; ++k) {
    const float sx = s.ox[k] - v0x;
    const float sy = s.oy[k] - v0y;
    const float sz = s.oz[k] - v0z;
    // s1 = d x e2
    const float s1x = s.dy[k] * e2z - s.dz[k] * e2y;
    const float s1y = s.dz[k] * e2x - s.dx[k] * e2z;
    const float s1z = s.dx[k] * e2y - s.dy[k] * e2x;
    // s2 = s x e1
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float denom = s1x * e1x + s1y * e1y + s1z * e1z;
    const float inv = denom == 0.f ? 0.f : 1.f / denom;
    const float t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
    const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
    const float b2 = (s2x * s.dx[k] + s2y * s.dy[k] + s2z * s.dz[k]) * inv;
    const bool ok = denom != 0.f && t >= s.lo[k] &&
                    t <= fminf(s.hi[k], s.best_t[k]) && b1 >= 0.f &&
                    b2 >= 0.f && b1 + b2 <= 1.f;
    if (ok && t < s.best_t[k]) {
      s.best_t[k] = t;
      s.best_i[k] = idx;
    }
  }
}

__device__ __forceinline__ void sphere_tail(const float* __restrict__ sph,
                                            int n_sph, int prim_base,
                                            Rays& s) {
#pragma unroll
  for (int k = 0; k < kRPT; ++k) {
    const float ox = s.ox[k], oy = s.oy[k], oz = s.oz[k];
    const float dx = s.dx[k], dy = s.dy[k], dz = s.dz[k];
    const float a = dx * dx + dy * dy + dz * dz;
    for (int q = 0; q < n_sph; ++q) {
      const float* c = sph + q * kSphFloats;
      const float cx = c[0], cy = c[1], cz = c[2], rr = c[3], valid = c[4];
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float b = 2.f * (ocx * dx + ocy * dy + ocz * dz);
      const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - rr * rr;
      const float delta = b * b - 4.f * a * cc;
      const float sq = sqrtf(fmaxf(delta, 0.f));
      const float t1 = (-b - sq) / (2.f * a);
      const float t2 = (-b + sq) / (2.f * a);
      const float lim = fminf(s.hi[k], s.best_t[k]);
      const bool in1 = t1 >= s.lo[k] && t1 <= lim;
      const bool in2 = t2 >= s.lo[k] && t2 <= lim;
      const float ts = in1 ? t1 : t2;
      const bool ok = valid > 0.f && delta >= 0.f && (in1 || in2);
      if (ok && ts < s.best_t[k]) {
        s.best_t[k] = ts;
        s.best_i[k] = prim_base + q;
      }
    }
  }
}

__device__ __forceinline__ void store(const Rays& s, int base,
                                      float* __restrict__ t_out,
                                      int32_t* __restrict__ prim_out,
                                      int n_rays) {
#pragma unroll
  for (int k = 0; k < kRPT; ++k) {
    const int r = base + k * kBlock;
    if (r < n_rays) {
      t_out[r] = s.best_t[k];
      prim_out[r] = s.best_i[k];
    }
  }
}

// Tables from a kernel parameter, staged into shared memory once per block.
template <int kTris>
__global__ void __launch_bounds__(kBlock)
brute_hit_param_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ min_t,
                       const float* __restrict__ max_t, int n_tris, int n_sph,
                       int prim_base, float* __restrict__ t_out,
                       int32_t* __restrict__ prim_out, int n_rays,
                       const __grid_constant__ ParamTables<kTris> tables) {
  __shared__ float s_tab[kTris * kTriFloats + kParamSph * kSphFloats];
  for (int k = threadIdx.x; k < n_tris * kTriFloats; k += kBlock) {
    s_tab[k] = tables.tri[k];
  }
  for (int k = threadIdx.x; k < n_sph * kSphFloats; k += kBlock) {
    s_tab[kTris * kTriFloats + k] = tables.sph[k];
  }
  __syncthreads();
  const float* sph = s_tab + kTris * kTriFloats;
  const int base = blockIdx.x * kBlock * kRPT + threadIdx.x;
  Rays s;
  load_rays(s, base, o, d, min_t, max_t, n_rays);
  for (int j = 0; j < n_tris; ++j) {
    test_tri(s_tab + j * kTriFloats, j, s);
  }
  sphere_tail(sph, n_sph, prim_base, s);
  store(s, base, t_out, prim_out, n_rays);
}

// Tables from device memory, the triangles staged through shared memory.
__global__ void __launch_bounds__(kBlock)
brute_hit_smem_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ min_t,
                      const float* __restrict__ max_t,
                      const float* __restrict__ tris, int n_tris,
                      const float* __restrict__ sph, int n_sph, int prim_base,
                      float* __restrict__ t_out,
                      int32_t* __restrict__ prim_out, int n_rays) {
  __shared__ float s_tri[kStage * kTriFloats];
  const int base = blockIdx.x * kBlock * kRPT + threadIdx.x;
  Rays s;
  load_rays(s, base, o, d, min_t, max_t, n_rays);
  for (int first = 0; first < n_tris; first += kStage) {
    const int n = min(kStage, n_tris - first);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < n * kTriFloats; k += kBlock) {
      s_tri[k] = tris[first * kTriFloats + k];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      test_tri(s_tri + j * kTriFloats, first + j, s);
    }
  }
  sphere_tail(sph, n_sph, prim_base, s);
  store(s, base, t_out, prim_out, n_rays);
}

template <int kTris>
void launch_param(const float* o, const float* d, const float* min_t,
                  const float* max_t, const float* host_tables, int n_tris,
                  int n_sph, int prim_base, float* t_out, int32_t* prim_out,
                  int n_rays, cudaStream_t s) {
  ParamTables<kTris> tables;
  memcpy(tables.tri, host_tables, sizeof(float) * kTriFloats * n_tris);
  memcpy(tables.sph, host_tables + kTriFloats * n_tris,
         sizeof(float) * kSphFloats * n_sph);
  const int per_block = kBlock * kRPT;
  brute_hit_param_kernel<kTris>
      <<<(n_rays + per_block - 1) / per_block, kBlock, 0, s>>>(
          o, d, min_t, max_t, n_tris, n_sph, prim_base, t_out, prim_out,
          n_rays, tables);
}

}  // namespace

// The largest tables brute_hit takes as a kernel parameter.
extern "C" void brute_hit_param_caps(int* n_tris, int* n_sph) {
  *n_tris = kParamTris;
  *n_sph = kParamSph;
}

// Plain C entry point, loaded with ctypes.  All arrays but host_tables are
// contiguous device memory: o, d [n_rays, 3]; min_t, max_t, t_out, prim_out
// [n_rays]; tris [n_tris, 9]; sph [n_sph, 5].  host_tables is NULL, or a
// host copy of tris then sph (n_tris * 9 + n_sph * 5 floats) for tables
// within brute_hit_param_caps, passed to the kernel as a parameter.
// Launches on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a parameter table it does not take).
extern "C" int brute_hit(const float* o, const float* d, const float* min_t,
                         const float* max_t, const float* tris, int n_tris,
                         const float* sph, int n_sph, int prim_base,
                         const float* host_tables, float* t_out,
                         int32_t* prim_out, int n_rays, void* stream) {
  if (host_tables != nullptr && (n_tris > kParamTris || n_sph > kParamSph)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (host_tables != nullptr && n_tris <= kSmallTris) {
      launch_param<kSmallTris>(o, d, min_t, max_t, host_tables, n_tris, n_sph,
                               prim_base, t_out, prim_out, n_rays, s);
    } else if (host_tables != nullptr) {
      launch_param<kParamTris>(o, d, min_t, max_t, host_tables, n_tris, n_sph,
                               prim_base, t_out, prim_out, n_rays, s);
    } else {
      const int per_block = kBlock * kRPT;
      const int blocks = (n_rays + per_block - 1) / per_block;
      brute_hit_smem_kernel<<<blocks, kBlock, 0, s>>>(
          o, d, min_t, max_t, tris, n_tris, sph, n_sph, prim_base, t_out,
          prim_out, n_rays);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
