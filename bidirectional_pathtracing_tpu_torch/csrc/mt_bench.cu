// K3: the per-cluster Möller–Trumbore microbenchmark, two forms.
//
// Replaces the TPU kernels tools/profiling/mxu_mt_bench.py `_vpu_kernel` and
// `_mxu_kernel` (launched by `run`).  Both time the clustered kernel's inner
// loop in isolation: `iters` cluster visits, visit i testing every ray
// against the 128 triangles of preloaded slot i % 8, with a running best t.
//
// Per visit, for each ray: the per-element test is denom != 0, t >= min_t,
// b1 >= 0, b2 >= 0, b1 + b2 <= 1, and, unless `late`, t <= min(max_t,
// best_t); the lowest in-cluster index wins ties among equal minimum t.
// The cluster minimum then replaces best_t on a strict <, and with `late`
// only where it is also <= max_t.  Out [2, R]: best t (3e38 on a miss) and
// the in-cluster index as f32 (-1 on a miss).
//
// mt_vpu_kernel: Möller–Trumbore on the vertex table tris [8, rows, 128]
// (rows 0-2 v0, 3-5 v1, 6-8 v2; rows 9.. ignored).  Bound on an H100 by
// issue: a test is about 78 instructions in the built code
// (tools/kernel_sweep.py), 48 of them FP32 and about 15 the IEEE
// reciprocal's, and -fmad=false (bitwise equal to the plain version)
// issues each multiply and add on its own, so at most about half of a
// bound that counts a fused multiply-add as two flops is reachable.
// The design cuts what comes on top of that arithmetic: all 8 slots are
// staged once per block in shared memory as [slot][v0 xyz, e1 xyz, e2 xyz]
// [triangle] (e1 = v1 - v0, e2 = v2 - v0 formed once, the same rounded
// values the per-test subtraction gives), and a thread reads the next four
// triangles of each row in one 16-byte load, a broadcast.  One ray a
// thread.  Measured on the card and dropped (PERF.md): two rays a thread
// (twice the unrolled body) and a warp-uniform early out after b1 (on
// these rays some lane of a warp nearly always passes).
//
// mt_linear_kernel: the same test with its four numerators (denominator,
// t, b1, b2) as the product of amat [8, 512, 16] with the per-ray features
// z = [o, d, o x d, 1, 0 x 6] (the TPU's MXU form), on the tensor cores:
// mma.sync.aligned.m16n8k8 in TF32 with FP32 accumulators for features
// 0-7, m16n8k4 for 8-11 (10-15 are zero; 10 and 11 ride along).  TF32 keeps 10 mantissa bits,
// and t's numerator n.o - n.v0 cancels, so each product is taken three
// times, a_lo z_hi + a_hi z_lo + a_hi z_hi (x_hi = tf32(x), x_lo =
// tf32(x - x_hi)), which keeps the numerators near FP32 accuracy; the
// winner then differs from the FP32 form's only on near ties and grazes
// (ops/mt_bench.py linear_gate).  The host permutes amat's rows so that one
// 16-row tile holds 8 triangles' denominators and t numerators and the
// next their b1 and b2 numerators, splits it into hi and lo, and lays it
// out in A-fragment order (ops/mt_bench.py mma_table, 64 KB a slot); z is
// split once per ray in the kernel.  A lane then holds all four numerators
// of triangle 8q + g for two ray columns, and the division (rcp.approx,
// within one ulp: this form is held to a tolerance, not bitwise), tests
// and running minimum stay in registers; once per visit the 8 lanes of a
// ray column reduce (smallest t, then lowest index) with shuffles.  Each
// visit's slot is staged into shared memory with cp.async, double
// buffered, so the next slot lands while this one is tested.  The product
// over the 10 nonzero features is 4.3e10 flops for 65,536 rays x 64 visits
// (0.087 ms at the 495 TFLOP/s TF32 peak; the three-product form over 12
// features issues 3.6 times that), and the FP32 epilogue holds the kernel
// well above it (22 of its 31 instructions a test), so wgmma's larger
// tiles would buy nothing yet.  Measured on the card and dropped
// (PERF.md): one ray tile a warp, the IEEE reciprocal, and features 8-15
// through m16n8k8 with the zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;   // the benchmark's miss sentinel
constexpr int kTC = 128;          // triangles per cluster
constexpr int kSlots = 8;         // preloaded clusters, cycled over
constexpr int kBlock = 256;       // mt_vpu threads per block
constexpr int kQuad = 4;          // mt_vpu triangles per row read
constexpr unsigned kAll = 0xffffffffu;
constexpr int kNT = 2;            // mt_linear: 8-ray tiles a warp holds

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
  __shared__ __align__(16) float s_tri[kSlots * 9 * kTC];
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

  // a ray past the end has d = 0, so its denominator is 0 and it never
  // passes
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  const float ox = live ? rays[0 * n_rays + r] : 0.f;
  const float oy = live ? rays[1 * n_rays + r] : 0.f;
  const float oz = live ? rays[2 * n_rays + r] : 0.f;
  const float dx = live ? rays[3 * n_rays + r] : 0.f;
  const float dy = live ? rays[4 * n_rays + r] : 0.f;
  const float dz = live ? rays[5 * n_rays + r] : 0.f;
  const float lo = live ? rays[6 * n_rays + r] : 0.f;
  const float hi = live ? rays[7 * n_rays + r] : -1.f;
  float bt = kInf, bi = -1.f;

  for (int i = 0; i < iters; ++i) {
    const float* s = s_tri + (i % kSlots) * 9 * kTC;
    const float lim = fminf(hi, bt);
    float cmin = kInf, cidx = kInf;
#pragma unroll 4   // measured: 1 and 2 slower
    for (int j = 0; j < kTC; j += kQuad) {
      // each row's kQuad triangles in one 16-byte load
      float row[9][kQuad];
#pragma unroll
      for (int c = 0; c < 9; ++c) {
#pragma unroll
        for (int u = 0; u < kQuad; ++u) row[c][u] = s[c * kTC + j + u];
      }
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        const float v0x = row[0][u], v0y = row[1][u], v0z = row[2][u];
        const float e1x = row[3][u], e1y = row[4][u], e1z = row[5][u];
        const float e2x = row[6][u], e2y = row[7][u], e2z = row[8][u];
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
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
        accept<kLate>(denom, t, b1, b2, lo, lim, j + u, cmin, cidx);
      }
    }
    finish<kLate>(cmin, cidx, hi, bt, bi);
  }
  if (live) {
    out[r] = bt;
    out[n_rays + r] = bi;
  }
}

// --- the tensor-core form ---------------------------------------------------

constexpr int kLinWarps = 16;                    // warps per block
constexpr int kLinThreads = 32 * kLinWarps;
constexpr int kFragF4 = 16 * 2 * 2 * 2 * 32;     // float4s per slot (64 KB)
constexpr int kLinSmem = 2 * kFragF4 * 16;       // two slots, 128 KB

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a (16x8, A-fragment registers) x b (8x8, B-fragment registers)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)), "r"(b0),
        "r"(b1));
}

// c += a (16x4: registers a.x, a.y) x b (4x8, one B-fragment register)
__device__ __forceinline__ void mma_tf32_k4(float (&c)[4], const float4& a,
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(b0));
}

// 1 / x within one ulp (rcp.approx.f32, subnormals kept); 0 for x == 0
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return x == 0.f ? 0.f : r;
}

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Feature f of z = [o, d, o x d, 1, 0 x 6] (ops/mt_bench.py _features);
// all zero for a ray past the end, so its denominators are 0.
__device__ __forceinline__ float feature(int f, bool live, const float (&o)[3],
                                         const float (&d)[3]) {
  const float c0 = o[1] * d[2] - o[2] * d[1];
  const float c1 = o[2] * d[0] - o[0] * d[2];
  const float c2 = o[0] * d[1] - o[1] * d[0];
  float z = 0.f;
  z = f == 0 ? o[0] : z;
  z = f == 1 ? o[1] : z;
  z = f == 2 ? o[2] : z;
  z = f == 3 ? d[0] : z;
  z = f == 4 ? d[1] : z;
  z = f == 5 ? d[2] : z;
  z = f == 6 ? c0 : z;
  z = f == 7 ? c1 : z;
  z = f == 8 ? c2 : z;
  z = f == 9 ? 1.f : z;
  return live ? z : 0.f;
}

// A warp holds kNT tiles of 8 rays.  Lane l = 4 g + c is column g of each
// tile for the B fragments (its features) and columns 2c, 2c + 1 for the
// accumulators (its tests and results).  Features 8-11 go through
// m16n8k4 (12-15 are zero; 10 and 11 are too, and are multiplied).
template <bool kLate>
__global__ void __launch_bounds__(kLinThreads, 1)
mt_linear_kernel(const float* __restrict__ rays,
                 const float4* __restrict__ table, int iters,
                 float* __restrict__ out, int n_rays) {
  extern __shared__ float4 s_frag[];   // [2][kFragF4]
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int ray0 = (blockIdx.x * kLinWarps + (threadIdx.x >> 5)) * 8 * kNT;

  if (iters > 0) {
    for (int k = threadIdx.x; k < kFragF4; k += kLinThreads) {
      cp_async16(s_frag + k, table + k);
    }
  }
  cp_async_commit();

  // B fragments, hi and lo: register 2 kk + h is feature 8 kk + 4 h + c
  // (features 12-15, register 3, are zero and not held)
  uint32_t bh[kNT][3], bl[kNT][3];
  float lo[kNT][2], hi[kNT][2], bt[kNT][2], bi[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int r = ray0 + 8 * n + g;
    const bool live = r < n_rays;
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = live ? rays[k * n_rays + r] : 0.f;
      d[k] = live ? rays[(3 + k) * n_rays + r] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float z = feature(8 * (k >> 1) + 4 * (k & 1) + c, live, o, d);
      bh[n][k] = to_tf32(z);
      bl[n][k] = to_tf32(z - __uint_as_float(bh[n][k]));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rc = ray0 + 8 * n + 2 * c + j;
      const bool lc = rc < n_rays;
      lo[n][j] = lc ? rays[6 * n_rays + rc] : 0.f;
      hi[n][j] = lc ? rays[7 * n_rays + rc] : -1.f;
      bt[n][j] = kInf;
      bi[n][j] = -1.f;
    }
  }

  for (int i = 0; i < iters; ++i) {
    if (i + 1 < iters) {   // the next visit's slot into the other buffer
      const float4* src = table + ((i + 1) % kSlots) * kFragF4;
      float4* dst = s_frag + ((i + 1) & 1) * kFragF4;
      for (int k = threadIdx.x; k < kFragF4; k += kLinThreads) {
        cp_async16(dst + k, src + k);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();   // this visit's slot has landed
    __syncthreads();
    const float4* f = s_frag + (i & 1) * kFragF4 + lane;
    float lim[kNT][2], cmin[kNT][2], cidx[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        lim[n][j] = fminf(hi[n][j], bt[n][j]);
        cmin[n][j] = kInf;
        cidx[n][j] = kInf;
      }
    }
#pragma unroll 4   // measured: 1 and 2 slower, full no faster
    for (int q = 0; q < 16; ++q) {
      float acc[2][kNT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // [kk][hi, lo][lane] of tile (q, m)
        const float4* fm = f + (2 * q + m) * 128;
        const float4 ah0 = fm[0], al0 = fm[32], ah1 = fm[64], al1 = fm[96];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float (&a)[4] = acc[m][n];
          a[0] = a[1] = a[2] = a[3] = 0.f;
          // small terms first: a_lo z_hi, a_hi z_lo, then a_hi z_hi
          mma_tf32(a, al0, bh[n][0], bh[n][1]);
          mma_tf32_k4(a, al1, bh[n][2]);
          mma_tf32(a, ah0, bl[n][0], bl[n][1]);
          mma_tf32_k4(a, ah1, bl[n][2]);
          mma_tf32(a, ah0, bh[n][0], bh[n][1]);
          mma_tf32_k4(a, ah1, bh[n][2]);
        }
      }
      // tile 0 rows (g, g + 8): denominator and t numerator of triangle
      // 8 q + g; tile 1: its b1 and b2 numerators; column 2 c + j
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float denom = acc[0][n][j];
          const float inv = rcp_approx(denom);
          accept<kLate>(denom, acc[0][n][2 + j] * inv, acc[1][n][j] * inv,
                        acc[1][n][2 + j] * inv, lo[n][j], lim[n][j], 8 * q + g,
                        cmin[n][j], cidx[n][j]);
        }
      }
    }
    // the column's 8 lanes (same c): smallest t, then the lowest index
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float ot = __shfl_xor_sync(kAll, cmin[n][j], off);
          const float oi = __shfl_xor_sync(kAll, cidx[n][j], off);
          if (ot < cmin[n][j] || (ot == cmin[n][j] && oi < cidx[n][j])) {
            cmin[n][j] = ot;
            cidx[n][j] = oi;
          }
        }
        finish<kLate>(cmin[n][j], cidx[n][j], hi[n][j], bt[n][j], bi[n][j]);
      }
    }
    __syncthreads();   // the next visit's copy overwrites this buffer
  }
  cp_async_wait<0>();
  if (g != 0) return;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ray0 + 8 * n + 2 * c + j;
      if (r < n_rays) {
        out[r] = bt[n][j];
        out[n_rays + r] = bi[n][j];
      }
    }
  }
}

template <bool kLate>
void launch_vpu(const float* rays, const float* tris, int tri_rows, int iters,
                float* out, int n_rays, cudaStream_t s) {
  mt_vpu_kernel<kLate><<<(n_rays + kBlock - 1) / kBlock, kBlock, 0, s>>>(
      rays, tris, tri_rows, iters, out, n_rays);
}

template <bool kLate>
void launch_linear(const float* rays, const float* table, int iters,
                   float* out, int n_rays, cudaStream_t s) {
  // once per `late`; should it fail, the launch below fails too
  static const cudaError_t attr = cudaFuncSetAttribute(
      mt_linear_kernel<kLate>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLinSmem);
  (void)attr;
  const int per_block = kLinWarps * 8 * kNT;
  mt_linear_kernel<kLate>
      <<<(n_rays + per_block - 1) / per_block, kLinThreads, kLinSmem, s>>>(
          rays, reinterpret_cast<const float4*>(table), iters, out, n_rays);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  All arrays are contiguous f32
// device memory: rays [8, n_rays] (o xyz, d xyz, min_t, max_t); tris
// [8, tri_rows, 128]; table [8, 16, 2, 2, 2, 32, 4] (ops/mt_bench.py
// mma_table), 16-byte aligned; out [2, n_rays].  Each launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int mt_vpu(const float* rays, const float* tris, int tri_rows,
                      int iters, int late, float* out, int n_rays,
                      void* stream) {
  if (n_rays > 0) {
    (late ? launch_vpu<true> : launch_vpu<false>)(
        rays, tris, tri_rows, iters, out, n_rays,
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_linear(const float* rays, const float* table, int iters,
                         int late, float* out, int n_rays, void* stream) {
  if (n_rays > 0) {
    (late ? launch_linear<true> : launch_linear<false>)(
        rays, table, iters, out, n_rays, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
