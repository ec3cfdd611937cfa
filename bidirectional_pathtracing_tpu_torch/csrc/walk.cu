// One step of a BDPT subpath random walk, one thread a lane: what follows
// the step's closest hit.
//
// Replaces the op chain of models/bdpt.py _prepare_subpath for one step
// (about 500 elementwise kernels a step, with every material kind's branch
// evaluated on every lane).  It computes the same function:
//
//   * the step's uniforms: rng.uniform(rng.fold(keys, site + step), (3,)),
//     the pcg2d words of core/rng.py in uint32;
//   * the hit point, the geometry term and the recurrences
//     p_i = p_{i-1} * pdf_{i-1} * G and
//     alpha_i = alpha_{i-1} * (|cos(prev_n, d)| / pdf_{i-1}) * f_{i-1};
//   * the BSDF sample at the hit (ops/bsdf.py sample) for the lane's own
//     material kind only, in the hit's shading frame, with the microfacet
//     f's arguments swapped on the adjoint (light and env emission) walks,
//     and its direction in world space;
//   * the vertex in slot step + 2 of the Subpath tensors (slots 0 and 1
//     too at step 0), the step's direction and miss bit, and the next
//     step's ray: origin, direction and the window [EPS_F, INF_D], or
//     [EPS_F, -1] on a dead lane, which the hit kernels never hit.
//
// The Subpath and step tensors are stored slot by slot, [nv + 1, S, ...]
// and [nv - 1, S, ...] (models/bdpt.py hands on their [S, nv + 1, ...]
// views), so that a step's writes, and each launch of connect.cu, are
// coalesced across lanes: stored lane by lane, a step's writes touch
// every sector of the arrays and took 4.5 times as long.
//
// The lane's state between steps is the vertex it stands on (slot
// step + 1), the sample drawn there (pdf and f, [S] and [S, 3]) and the
// ray, which steps write and read in turns of two buffers so that no
// launch reads what it writes.  Step 0 reads the walk's start instead: the
// ray it was given, v1's normal, alpha and area pdf, and its directional
// pdf.  A material id outside the table is clipped into it, as
// bsdf_ops.sample's gather clips it (a miss's -1 samples material 0, whose
// values a dead lane carries but nothing reads).
//
// Each operation is the op chain's in float32, in its order, with
// csrc/shading.cuh's helpers and rules (shared with connect.cu); the libm
// calls are torch's: sqrtf, sinf, cosf, atanf, log1pf, expf, erff, acosf,
// tanf, powf (** 5).
//
// It replaces no TPU kernel: the JAX package leaves a walk step's shading
// to XLA, which fuses the jitted pass's elementwise ops.
//
// What bounds it on an H100: bytes, 212 a lane a step (289 at step 0): the
// lane's key, hit, ray and state read, its vertex, step, sample and next
// ray written; 37 MB a step at 172,800 lanes, 11 us at 3.35 TB/s.  Its
// operations, a few hundred FP32 a lane and a handful of libm calls, are
// far below.  On an H100 at 700 W a step takes about 18 us, 63-65 % of the
// bytes bound (chip_smoke.py phase 17).  One thread a lane, nothing
// shared; lanes of different materials diverge only inside the sampler's
// switch.
//
// Compiled by nvcc this is the kernel and its C entry point `walk_launch`;
// compiled as C++ by a host compiler (g++ -x c++) it is the same lane
// function in a loop, `walk_host`, which the CPU tests build.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define LDG(p) __ldg(p)
#else
#define HD inline
#define LDG(p) (*(p))
#endif

// The kernel's arguments (ops/walk.py Args mirrors them field for field):
// pointers into device memory (host memory for walk_host), then the sizes
// and flags.  Layout: contiguous, bool as bytes, [S] or [S, 3] unless said.
struct Args {
  const int64_t* keys;      // [S, 2] pcg2d words
  const float* hit_t;       // the step's closest hit
  const uint8_t* hit_valid;
  const float* hit_n;
  const int32_t* hit_mat;
  const float* o;           // the step's ray
  const float* d;
  const float* v1_n;        // step 0: the walk's start
  const float* v1_alpha;
  const float* v1_p;
  const float* dir_pdf;
  const float* mats;        // [M, kMatStride]
  float* pdf;               // the lane's sample, read and written
  float* f;
  float* next_o;            // the next step's ray
  float* next_d;
  float* next_min_t;
  float* next_max_t;
  float* pos;               // the Subpath, [nv + 1, S, ...]
  float* n;
  float* alpha;
  float* p;
  int32_t* mat;
  uint8_t* valid;
  float* step_d;            // [nv - 1, S, 3]
  uint8_t* step_miss;       // [nv - 1, S]
  int32_t n_lanes, nv, step, site, adjoint, n_mats;
};

namespace {

constexpr int kBlock = 128;       // threads a block
constexpr float kInfD = 1e30f;    // INF_D

#include "shading.cuh"

// --- core/rng.py ------------------------------------------------------------

constexpr uint32_t kPcgMul = 1664525u, kPcgInc = 1013904223u;

HD void pcg2d(uint32_t& v0, uint32_t& v1) {
  v0 = v0 * kPcgMul + kPcgInc;
  v1 = v1 * kPcgMul + kPcgInc;
  v0 += v1 * kPcgMul;
  v1 += v0 * kPcgMul;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v0 += v1 * kPcgMul;
  v1 += v0 * kPcgMul;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
}

// uniform(fold(key, site), (3,)): three floats in [0, 1)
HD void uniform3(uint32_t k0, uint32_t k1, uint32_t site, float u[3]) {
  uint32_t f0 = k0 ^ (site * 0x9E3779B9u), f1 = k1 + site;
  pcg2d(f0, f1);
  for (uint32_t j = 0; j < 3; ++j) {
    uint32_t v0 = f0 + j * 0x632BE59Bu, v1 = f1 ^ j;
    pcg2d(v0, v1);
    const uint32_t bits = v0 ^ (v1 << 16);
    u[j] = (float)(bits >> 8) * (1.0f / 16777216.0f);
  }
}

// --- ops/bsdf.py sample -----------------------------------------------------

struct Sample {
  V3 wi, f;
  float pdf;
};

// core/math.py refract_local: (wi, ok), ok false on total internal
// reflection
HD bool refract(V3 wo, float ior, V3* wi) {
  const bool enter = wo.z > 0.0f;
  const float eta = enter ? 1.0f / ior : ior;
  const float z_sq = 1.0f - (eta * eta) * (1.0f - wo.z * wo.z);
  const float z = (enter ? -1.0f : 1.0f) * sqrtf(clamp_min(z_sq, 0.0f));
  *wi = v3(-eta * wo.x, -eta * wo.y, z);
  return z_sq >= 0.0f;
}

HD V3 over_cos(V3 c, V3 w) { return vdiv(c, clamp_min(fabsf(w.z), 1e-12f)); }

// the lane's own kind of bsdf_ops.sample; pdf before its final clamp
HD Sample sample_bsdf(const float* mats, int n_mats, int mid, V3 wo,
                      const float u[3], bool adjoint) {
  const int m = mid < 0 ? 0 : (mid > n_mats - 1 ? n_mats - 1 : mid);
  const float* row = mats + m * kMatStride;
  const V3 wi_ref = v3(-wo.x, -wo.y, wo.z);
  switch ((int)LDG(row)) {
    case kMirror:
      return Sample{wi_ref, over_cos(row3(row + kMatReflectance), wi_ref),
                    1.0f};
    case kRefraction:
    case kGlass: {
      const float ior = LDG(row + kMatIor);
      V3 wi_refr;
      const bool ok = refract(wo, ior, &wi_refr);
      const float eta_wo = wo.z > 0.0f ? 1.0f / ior : ior;
      const float eta2 = eta_wo * eta_wo;
      const V3 trans = row3(row + kMatTransmittance);
      if ((int)LDG(row) == kRefraction) {
        if (!ok) return Sample{wi_ref, vsplat(0.0f), 1.0f};
        return Sample{wi_refr, vdiv(over_cos(trans, wi_refr), eta2), 1.0f};
      }
      // Schlick's R with eta from the wo side
      const float q = (1.0f - eta_wo) / (1.0f + eta_wo);
      const float r0 = q * q;
      const float r = r0 + (1.0f - r0) * powf(1.0f - fabsf(wi_refr.z), 5.0f);
      const bool reflect = !ok || u[2] < r;
      const float r_eff = ok ? r : 1.0f;
      const V3 refl = row3(row + kMatReflectance);
      if (reflect) {
        const V3 f = ok ? over_cos(vscale(refl, r_eff), wi_ref)
                        : over_cos(refl, wi_ref);
        return Sample{wi_ref, f, ok ? r_eff : 1.0f};
      }
      return Sample{wi_refr,
                    vdiv(over_cos(vscale(trans, 1.0f - r_eff), wi_refr), eta2),
                    1.0f - r_eff};
    }
    case kMicrofacet: {
      const float alpha = LDG(row + kMatRoughness);
      const float theta_h =
          atanf(sqrtf(clamp_min((-alpha * alpha) * log1pf(-u[0]), 0.0f)));
      const float phi_h = kTwoPi * u[1];
      const float sin_t = sinf(theta_h);
      const V3 h = v3(sin_t * cosf(phi_h), sin_t * sinf(phi_h), cosf(theta_h));
      const V3 wi = unit(vsub(vscale(h, 2.0f * dot(wo, h)), wo));
      const bool ok = wo.z > kEps && wi.z > kEps;
      if (!ok) return Sample{v3(0.0f, 0.0f, 1.0f), vsplat(0.0f), 1.0f};
      const float pdf = clamp_min(microfacet_pdf(alpha, wo, wi), 1e-12f);
      // the adjoint BSDF swaps the microfacet f's arguments
      const V3 f =
          adjoint ? microfacet_f(row, wi, wo) : microfacet_f(row, wo, wi);
      return Sample{wi, f, pdf};
    }
    default: {
      // samplers.cosine_hemisphere; f is the diffuse one, 0 for emission
      const float r = sqrtf(u[0]);
      const float theta = kTwoPi * u[1];
      const float z = sqrtf(clamp_min(1.0f - u[0], 0.0f));
      const V3 wi = v3(r * cosf(theta), r * sinf(theta), z);
      const bool diffuse = (int)LDG(row) == kDiffuse;
      const V3 f = (diffuse && wo.z >= 0.0f && wi.z >= 0.0f)
                       ? vscale(row3(row + kMatAlbedo), kInvPi)
                       : vsplat(0.0f);
      return Sample{wi, f, z * kInvPi};
    }
  }
}

// --- one lane ---------------------------------------------------------------

HD void put3(float* base, int k, V3 v) {
  base[3 * k + 0] = v.x;
  base[3 * k + 1] = v.y;
  base[3 * k + 2] = v.z;
}

HD V3 get3(const float* base, int k) {
  return v3(base[3 * k + 0], base[3 * k + 1], base[3 * k + 2]);
}

HD void walk_lane(const Args& a, int s) {
  const int i = a.step;
  const int at = i * a.n_lanes + s;  // slot i, or step i, of the lane
  const int lanes = a.n_lanes;
  const V3 o = get3(a.o, s), d = get3(a.d, s);
  // the vertex the lane stands on and the sample it drew there
  V3 prev_n, alpha_prev, prev_f;
  float p_prev, prev_pdf;
  bool alive;
  if (i == 0) {
    prev_n = get3(a.v1_n, s);
    alpha_prev = get3(a.v1_alpha, s);
    p_prev = a.v1_p[s];
    prev_pdf = clamp_min(a.dir_pdf[s], 1e-12f);
    prev_f = vsplat(1.0f);
    alive = true;
    put3(a.pos, s, vsplat(0.0f));
    put3(a.n, s, vsplat(0.0f));
    put3(a.alpha, s, vsplat(0.0f));
    a.p[s] = 0.0f;
    a.mat[s] = -1;
    a.valid[s] = 0;
    put3(a.pos, lanes + s, o);
    put3(a.n, lanes + s, prev_n);
    put3(a.alpha, lanes + s, alpha_prev);
    a.p[lanes + s] = p_prev;
    a.mat[lanes + s] = -1;
    a.valid[lanes + s] = 1;
  } else {
    const int k = at + lanes;        // slot i + 1
    prev_n = get3(a.n, k);
    alpha_prev = get3(a.alpha, k);
    p_prev = a.p[k];
    prev_pdf = a.pdf[s];
    prev_f = get3(a.f, s);
    alive = a.valid[k] != 0;
  }

  float u[3];
  uniform3((uint32_t)a.keys[2 * s], (uint32_t)a.keys[2 * s + 1],
           (uint32_t)(a.site + i), u);

  const float t = LDG(a.hit_t + s);
  const bool hit = LDG(a.hit_valid + s) != 0;
  const V3 hn = row3(a.hit_n + 3 * s);
  const int hmat = LDG(a.hit_mat + s);
  const bool miss = alive && !hit;
  alive = alive && hit;
  const V3 hit_p = vadd(o, vscale(d, t));

  const float cos_prev = fabsf(dot(prev_n, d));
  const float g = (cos_prev * fabsf(dot(hn, d))) / clamp_min(t * t, 1e-12f);
  const float p_i = (p_prev * prev_pdf) * g;
  const V3 alpha_i = vmul(vscale(alpha_prev, cos_prev / prev_pdf), prev_f);

  const Frame fr = coord_space(hn);
  const Sample bs = sample_bsdf(a.mats, a.n_mats, hmat, to_local(fr, vneg(d)),
                                u, a.adjoint != 0);
  const V3 wi_w = normalize(to_world(fr, bs.wi));

  const int k = at + 2 * lanes;      // slot i + 2
  put3(a.pos, k, hit_p);
  put3(a.n, k, hn);
  put3(a.alpha, k, alpha_i);
  a.p[k] = p_i;
  a.mat[k] = hmat;
  a.valid[k] = alive ? 1 : 0;
  put3(a.step_d, at, d);
  a.step_miss[at] = miss ? 1 : 0;

  a.pdf[s] = clamp_min(bs.pdf, 1e-12f);
  put3(a.f, s, bs.f);
  put3(a.next_o, s, hit_p);
  put3(a.next_d, s, wi_w);
  a.next_min_t[s] = kEps;
  a.next_max_t[s] = alive ? kInfD : -1.0f;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kBlock) walk_kernel(
    const __grid_constant__ Args a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < a.n_lanes) walk_lane(a, s);
}
#endif

}  // namespace

extern "C" {

#ifdef __CUDACC__
// Launches the kernel on `stream`; returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for a step outside 0..nv - 2).
int walk_launch(const Args* args, void* stream) {
  if (args->step < 0 || args->step > args->nv - 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->n_lanes > 0) {
    const int blocks = (args->n_lanes + kBlock - 1) / kBlock;
    walk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
#else
// The same lanes on the host, in order; returns 0, or 1 for a step outside
// 0..nv - 2.
int walk_host(const Args* args) {
  if (args->step < 0 || args->step > args->nv - 2) return 1;
  for (int s = 0; s < args->n_lanes; ++s) walk_lane(*args, s);
  return 0;
}
#endif

}  // extern "C"
