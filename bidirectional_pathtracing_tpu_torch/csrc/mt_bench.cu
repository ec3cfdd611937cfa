// K3: the per-cluster Möller–Trumbore microbenchmark, two forms.
//
// Replaces the TPU kernels tools/profiling/mxu_mt_bench.py `_vpu_kernel` and
// `_mxu_kernel` (launched by `run`).  Both time the clustered kernel's inner
// loop in isolation: `iters` cluster visits, visit i testing every ray
// against the 128 triangles of preloaded slot i % 8, with a running best t.
//
//   * mt_vpu_kernel: Möller–Trumbore on the vertex table tris [8, rows, 128]
//     (rows 0-2 v0, 3-5 v1, 6-8 v2; rows 9.. ignored);
//   * mt_linear_kernel: the same test with its four numerators (denominator,
//     t, b1, b2) as the dot product of a row of amat [8, 512, 16] with the
//     per-ray features z = [o, d, o x d, 1, 0 x 6], summed term by term in
//     ascending order, on the CUDA cores in FP32 (the MXU form of the TPU;
//     a tensor-core form would round differently).
//
// Per visit, for each ray: the per-element test is denom != 0, t >= min_t,
// b1 >= 0, b2 >= 0, b1 + b2 <= 1, and, unless `late`, t <= min(max_t,
// best_t); the lowest in-cluster index wins ties among equal minimum t.
// The cluster minimum then replaces best_t on a strict <, and with `late`
// only where it is also <= max_t.  Out [2, R]: best t (3e38 on a miss) and
// the in-cluster index as f32 (-1 on a miss).
//
// What bounds it on an H100: FP32 issue.  Each ray-triangle test is about
// 55 flops and one IEEE division on a ray held in registers; the data is a
// few MB, read once.  The design keeps each ray's state in registers for the
// whole visit loop (one thread per ray) and serves triangles from shared
// memory, where all threads of a warp read the same word (a broadcast):
// the vertex form stages all 8 slots once per block, with e1 = v1 - v0 and
// e2 = v2 - v0 formed there once (the same rounded values the per-test
// subtraction would give); the linear form's table (256 KB, above a
// block's 227 KB) is staged one 32 KB slot per visit.  -fmad=false and
// every sum in the plain version's order make the result bitwise equal to
// ops/mt_bench.py's plain versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;   // the benchmark's miss sentinel
constexpr int kTC = 128;          // triangles per cluster
constexpr int kSlots = 8;         // preloaded clusters, cycled over
constexpr int kBlock = 256;       // rays (threads) per block
constexpr int kFeat = 16;         // linear-form features per ray
constexpr int kRows = 4 * kTC;    // linear-form rows per slot

// One visit's epilogue: the cluster minimum against the running best.
template <bool kLate>
__device__ __forceinline__ void finish(float cmin, float cidx, float hi,
                                       float& bt, float& bi) {
  const bool closer = kLate ? (cmin < bt && cmin <= hi) : (cmin < bt);
  if (closer) {
    bt = cmin;
    bi = cidx;
  }
}

// The per-element test and the in-cluster scan (strict <: lowest index wins).
template <bool kLate>
__device__ __forceinline__ void accept(float denom, float t, float b1,
                                       float b2, float lo, float lim, int j,
                                       float& cmin, float& cidx) {
  bool ok = denom != 0.f && t >= lo && b1 >= 0.f && b2 >= 0.f &&
            b1 + b2 <= 1.f;
  if (!kLate) ok = ok && t <= lim;
  const float tm = ok ? t : kInf;
  if (tm < cmin) {
    cmin = tm;
    cidx = static_cast<float>(j);
  }
}

template <bool kLate>
__global__ void __launch_bounds__(kBlock)
mt_vpu_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
              int tri_rows, int iters, float* __restrict__ out, int n_rays) {
  // [slot][v0 xyz, e1 xyz, e2 xyz][triangle]
  __shared__ float s_tri[kSlots * 9 * kTC];
  for (int k = threadIdx.x; k < kSlots * 3 * kTC; k += kBlock) {
    const int slot = k / (3 * kTC), c = (k / kTC) % 3, j = k % kTC;
    const float* v = tris + slot * tri_rows * kTC + j;
    const float v0 = v[c * kTC], v1 = v[(3 + c) * kTC], v2 = v[(6 + c) * kTC];
    float* s = s_tri + slot * 9 * kTC + j;
    s[c * kTC] = v0;
    s[(3 + c) * kTC] = v1 - v0;
    s[(6 + c) * kTC] = v2 - v0;
  }
  __syncthreads();

  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = rays[0 * n_rays + r], oy = rays[1 * n_rays + r],
              oz = rays[2 * n_rays + r];
  const float dx = rays[3 * n_rays + r], dy = rays[4 * n_rays + r],
              dz = rays[5 * n_rays + r];
  const float lo = rays[6 * n_rays + r], hi = rays[7 * n_rays + r];

  float bt = kInf, bi = -1.f;
  for (int i = 0; i < iters; ++i) {
    const float* s = s_tri + (i % kSlots) * 9 * kTC;
    const float lim = fminf(hi, bt);
    float cmin = kInf, cidx = kInf;
    for (int j = 0; j < kTC; ++j) {
      const float e1x = s[3 * kTC + j], e1y = s[4 * kTC + j],
                  e1z = s[5 * kTC + j];
      const float e2x = s[6 * kTC + j], e2y = s[7 * kTC + j],
                  e2z = s[8 * kTC + j];
      const float sx = ox - s[j], sy = oy - s[kTC + j],
                  sz = oz - s[2 * kTC + j];
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
      accept<kLate>(denom, t, b1, b2, lo, lim, j, cmin, cidx);
    }
    finish<kLate>(cmin, cidx, hi, bt, bi);
  }
  out[r] = bt;
  out[n_rays + r] = bi;
}

// Row m of the staged slot against z: sum of the 16 products, in order.
__device__ __forceinline__ float row_dot(const float* __restrict__ a,
                                         const float (&z)[kFeat]) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kFeat / 4; ++q) {
    const float4 w = a4[q];
    const float p0 = w.x * z[4 * q + 0], p1 = w.y * z[4 * q + 1];
    const float p2 = w.z * z[4 * q + 2], p3 = w.w * z[4 * q + 3];
    acc = (q == 0) ? p0 : acc + p0;
    acc = acc + p1;
    acc = acc + p2;
    acc = acc + p3;
  }
  return acc;
}

template <bool kLate>
__global__ void __launch_bounds__(kBlock)
mt_linear_kernel(const float* __restrict__ rays,
                 const float* __restrict__ amat, int iters,
                 float* __restrict__ out, int n_rays) {
  __shared__ __align__(16) float s_a[kRows * kFeat];   // one slot, 32 KB

  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  float z[kFeat];
  float lo = 0.f, hi = -1.f;
  {
    float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
    if (live) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[k] = rays[k * n_rays + r];
        d[k] = rays[(3 + k) * n_rays + r];
      }
      lo = rays[6 * n_rays + r];
      hi = rays[7 * n_rays + r];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      z[k] = o[k];
      z[3 + k] = d[k];
      z[6 + k] = o[(k + 1) % 3] * d[(k + 2) % 3] -
                 o[(k + 2) % 3] * d[(k + 1) % 3];
    }
    z[9] = 1.f;
#pragma unroll
    for (int k = 10; k < kFeat; ++k) z[k] = 0.f;
  }

  float bt = kInf, bi = -1.f;
  for (int i = 0; i < iters; ++i) {
    const float4* src =
        reinterpret_cast<const float4*>(amat + (i % kSlots) * kRows * kFeat);
    __syncthreads();   // the previous visit no longer reads s_a
    for (int k = threadIdx.x; k < kRows * kFeat / 4; k += kBlock) {
      reinterpret_cast<float4*>(s_a)[k] = src[k];
    }
    __syncthreads();
    if (!live) continue;
    const float lim = fminf(hi, bt);
    float cmin = kInf, cidx = kInf;
    for (int j = 0; j < kTC; ++j) {
      const float denom = row_dot(s_a + (0 * kTC + j) * kFeat, z);
      const float t_num = row_dot(s_a + (1 * kTC + j) * kFeat, z);
      const float b1_num = row_dot(s_a + (2 * kTC + j) * kFeat, z);
      const float b2_num = row_dot(s_a + (3 * kTC + j) * kFeat, z);
      const float inv = denom == 0.f ? 0.f : 1.f / denom;
      accept<kLate>(denom, t_num * inv, b1_num * inv, b2_num * inv, lo, lim,
                    j, cmin, cidx);
    }
    finish<kLate>(cmin, cidx, hi, bt, bi);
  }
  if (!live) return;
  out[r] = bt;
  out[n_rays + r] = bi;
}

unsigned grid_for(int n_rays) {
  return static_cast<unsigned>((n_rays + kBlock - 1) / kBlock);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  All arrays are contiguous f32
// device memory: rays [8, n_rays] (o xyz, d xyz, min_t, max_t); tris
// [8, tri_rows, 128]; amat [8, 512, 16], 16-byte aligned; out [2, n_rays].
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mt_vpu(const float* rays, const float* tris, int tri_rows,
                      int iters, int late, float* out, int n_rays,
                      void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (late) {
      mt_vpu_kernel<true><<<grid_for(n_rays), kBlock, 0, s>>>(
          rays, tris, tri_rows, iters, out, n_rays);
    } else {
      mt_vpu_kernel<false><<<grid_for(n_rays), kBlock, 0, s>>>(
          rays, tris, tri_rows, iters, out, n_rays);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_linear(const float* rays, const float* amat, int iters,
                         int late, float* out, int n_rays, void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (late) {
      mt_linear_kernel<true><<<grid_for(n_rays), kBlock, 0, s>>>(
          rays, amat, iters, out, n_rays);
    } else {
      mt_linear_kernel<false><<<grid_for(n_rays), kBlock, 0, s>>>(
          rays, amat, iters, out, n_rays);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
