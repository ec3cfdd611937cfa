// The BDPT connections of one pass: every (i_eye, i_light) combo's estimate
// and its table-form MIS weight, one thread a lane.
//
// Replaces the op chain of models/bdpt.py sample_pass between its pass marks
// 1 and 2 (_mis_tables, then _estimate_radiance and _mis_weight for each
// combo), which runs each combo as about a thousand elementwise kernels
// with every material kind's branch evaluated on every lane.  It computes
// the same function:
//
//   * the lane's MIS tables (_mis_tables): A, B, the delta masks as
//     Dbar = 0 / 1 and the suffix sums W of both subpaths;
//   * the combos in the op chain's order, i_eye 1..nv outer and i_light
//     0..nv inner (0 only without a light subpath): f_eye and f_light
//     through eval_f, the geometry term, the shadow batch's blocked bit,
//     the t=0 emission through the lights' contain_point / sample_pdf, the
//     t=1 fresh light sample, the camera splat of i_eye = 1, the weight's
//     junction factors and _finish_weight;
//   * eye_L, read and written in place: the env families' radiance comes
//     in, each i_eye >= 2 combo's radiance is added in combo order; the
//     i_eye = 1, i_light >= 1 combos write their clamped flat pixel ids and
//     their values times inv_ns_aa, [nv, S] and [nv, S, 3], in the order
//     the op chain hands them to _splat.
//
// Only the lane's own material kind and light kind are evaluated (a
// switch), each in the op chain's float32 operations and order: the same
// libm calls (expf, erff, acosf, tanf, powf where torch's pow takes an
// exponent other than 2), IEEE division and square root, and no fused
// multiply-add; csrc/shading.cuh, which walk.cu shares, holds the vector,
// frame and material helpers and the rules they follow.
//
// Layout (all contiguous; bool as bytes): the Subpath tensors of both walks
// slot by slot, [nv + 1, S, ...] (ops/connect.py launch_args transposes the
// Subpaths, which walk.cu writes so already), the light walk's dir_pdf [S];
// the fresh samples stacked [nv, S, ...]; the shadow batch's blocked mask
// [nv * nv, S] in the op chain's segment order; the scene's tables
// (ops/connect.py): materials
// [M, kMatStride] (ops/bsdf.py rows), lights [L, kLightStride], the camera
// [14]: c2w row by row, the position, tan(hfov / 2) and tan(vfov / 2).
//
// It replaces no TPU kernel: the JAX package leaves the connections to XLA,
// which fuses the jitted pass's elementwise ops; on the card the op chain
// ran them as about 42,500 kernels of 2.4 us each.
//
// What bounds it on an H100: bytes by the roofline, 1,056 a lane read and
// written against about 8,500 FP32 operations a lane executed on the
// Cornell box (380 of them square roots and libm calls; 24,000 if no combo
// ended early); in practice the latency of each lane's dependent chains of
// IEEE divisions and square roots, and divergence between lanes of
// different materials and path lengths.  The design
// keeps a lane's work in one thread: its tables in per-thread arrays,
// vertices read from device memory through the read-only path as each
// combo needs them, and a combo whose contribution is masked (an invalid
// pair, a blocked segment, a contribution under EPS_F) ends before its
// BSDFs and weight, whose value the mask would discard.  The block size
// does not change its time (64 to 512 threads measured alike).
//
// nv is a runtime argument up to kMaxV; deeper passes take the op chain
// (ops/connect.py route).
//
// Compiled by nvcc this is the kernel and its C entry point
// `connect_launch`; compiled as C++ by a host compiler (g++ -x c++) it is
// the same lane function in a loop, `connect_host`, which the CPU tests
// build.

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

// The kernel's arguments (ops/connect.py Args mirrors them field for
// field): pointers into device memory (host memory for connect_host), then
// the sizes and flags.
struct Args {
  const float* e_pos;
  const float* e_n;
  const float* e_alpha;
  const int32_t* e_mat;
  const uint8_t* e_valid;
  const float* l_pos;
  const float* l_n;
  const float* l_alpha;
  const float* l_p;
  const int32_t* l_mat;
  const uint8_t* l_valid;
  const float* l_dir_pdf;
  const float* f_pos;
  const float* f_n;
  const float* f_alpha;
  const float* f_p;
  const float* f_dir_pdf;
  const uint8_t* f_valid;
  const uint8_t* blocked;
  const float* mats;
  const float* lights;
  const float* cam;
  const float* inv_ns_aa;
  float* eye_l;
  int64_t* splat_flat;
  float* splat_val;
  int32_t n_lanes, nv, width, height, n_mats, n_lights;
  int32_t has_light, consistent_camera, t1_reference;
};

namespace {

constexpr int kMaxV = 8;          // real vertices a subpath at most
constexpr int kBlock = 128;       // threads a block
// table rows (ops/connect.py _scene_tables): a light is kind, radiance,
// position, direction, area and a pad; a material is csrc/shading.cuh's row
constexpr int kLightStride = 12;

// scene/types.py light kinds
constexpr int kArea = 0, kPoint = 1;

constexpr float kQuarterInvPi = (float)(0.25 / 3.14159265358979323846);

#include "shading.cuh"

// models/bdpt.py _seg: unit direction a -> b and distance
struct Seg {
  V3 d;
  float dist;
};

HD Seg seg(V3 a, V3 b) {
  const V3 d = vsub(b, a);
  const float dist = sqrtf(clamp_min(dot(d, d), 1e-20f));
  return Seg{vdiv(d, dist), dist};
}

// models/bdpt.py _geom
HD float geom(V3 wi, V3 na, V3 nb, float dist) {
  return fabsf(dot(wi, na) * dot(wi, nb)) / clamp_min(dist * dist, 1e-12f);
}

// models/bdpt.py _mis_pdf_local
HD float mis_pdf_local(const float* mats, int n_mats, int mid, V3 wo_w,
                       V3 wi_w, V3 n) {
  const Frame f = coord_space(n);
  return mis_pdf(mats, n_mats, mid, to_local(f, wo_w), to_local(f, wi_w));
}

// --- lights (ops/lights.py) -------------------------------------------------

struct Light {
  int kind;
  V3 radiance, position, direction;
  float area;
};

HD Light light_row(const float* lights, int li) {
  const float* r = lights + li * kLightStride;
  return Light{(int)LDG(r), row3(r + 1), row3(r + 4), row3(r + 7),
               LDG(r + 10)};
}

HD bool contain_point(const Light& l, V3 p) {
  const V3 d = normalize(vsub(l.position, p));
  const bool on_plane = fabsf(dot(d, l.direction)) < kEps;
  const bool near = vnorm(vsub(p, l.position)) < kEps;
  return l.kind == kArea ? on_plane : (l.kind == kPoint && near);
}

struct LightPdf {
  V3 rad;
  float point_pdf, dir_pdf;
};

// sample_pdf: wi points toward the light
HD LightPdf light_sample_pdf(const Light& l, V3 p, V3 wi) {
  const bool contains = contain_point(l, p);
  const Frame f = coord_space(l.direction);
  const float dir_pdf_a = cosine_pdf(to_local(f, vneg(wi)));
  const float point_pdf = l.kind == kArea ? 1.0f / clamp_min(l.area, 1e-12f)
                          : l.kind == kPoint ? 1.0f
                                             : 0.0f;
  const float dir_pdf = l.kind == kArea    ? dir_pdf_a
                        : l.kind == kPoint ? kQuarterInvPi
                                           : 0.0f;
  const V3 rad = l.kind == kArea ? vsel(dir_pdf_a > 0.0f, l.radiance,
                                        vsplat(0.0f))
                                 : l.radiance;
  return LightPdf{vsel(contains, rad, vsplat(0.0f)),
                  contains ? point_pdf : 0.0f, contains ? dir_pdf : 0.0f};
}

// --- the camera (ops/camera_ops.py sample_ray_pdf) --------------------------

struct CamSample {
  float we, dir_pdf, px, py;
  V3 normal;  // -wi
  bool in_frame;
};

HD CamSample camera_sample(const float* cam, V3 p, int width, int height) {
  const V3 pos = row3(cam + 9);
  V3 wi = vsub(pos, p);
  const float dist = vnorm(wi);
  wi = vdiv(wi, clamp_min(dist, 1e-20f));
  const V3 nw = vneg(wi);
  float wc[3];
  for (int r = 0; r < 3; ++r) {
    wc[r] = rsum3(LDG(cam + r) * nw.x, LDG(cam + 3 + r) * nw.y,
                  LDG(cam + 6 + r) * nw.z);
  }
  const float cos_t = wc[2] * -1.0f;
  const float th = LDG(cam + 12), tv = LDG(cam + 13);
  const float area = (4.0f * th) * tv;
  const float cc = clamp_min(cos_t, 1e-12f);
  const float denom = area / powf(cc, 4.0f);
  CamSample c;
  c.we = cos_t > 0.0f ? 1.0f / denom : 0.0f;
  c.dir_pdf = (dist * dist) / cc;
  c.px = ((wc[0] / cc / th + 1.0f) * 0.5f) * (float)width;
  c.py = ((wc[1] / cc / tv + 1.0f) * 0.5f) * (float)height;
  c.in_frame = cos_t > 0.0f && c.px > -1.0f && c.py > -1.0f &&
               c.px < (float)width && c.py < (float)height;
  c.normal = nw;
  return c;
}

// float -> int32 as a CUDA cast: toward zero, saturating, NaN to 0
HD int32_t to_i32(float x) {
  if (is_nan(x)) return 0;
  if (x >= 2147483648.0f) return INT32_MAX;
  if (x <= -2147483648.0f) return INT32_MIN;
  return (int32_t)x;
}

// --- one lane ---------------------------------------------------------------



struct Vert {
  V3 pos, n, alpha;
  float p, dir_pdf;
  int mat;
  bool valid;
};

struct Lane {
  const Args& a;
  int s;
  // vertex i of the lane in the slot-major Subpath tensors
  HD int at(int i) const { return i * a.n_lanes + s; }
  HD V3 pos(const float* base, int i) const { return row3(base + 3 * at(i)); }
  HD V3 epos(int i) const { return pos(a.e_pos, i); }
  HD V3 en(int i) const { return pos(a.e_n, i); }
  HD int emat(int i) const { return LDG(a.e_mat + at(i)); }
  HD V3 lpos(int i) const { return pos(a.l_pos, i); }
  HD V3 ln(int i) const { return pos(a.l_n, i); }
  HD int lmat(int i) const { return LDG(a.l_mat + at(i)); }

  HD Vert eye(int i) const {
    return Vert{epos(i), en(i), pos(a.e_alpha, i), 0.0f, 0.0f, emat(i),
                LDG(a.e_valid + at(i)) != 0};
  }
  HD Vert light(int i) const {
    return Vert{lpos(i), ln(i), pos(a.l_alpha, i), LDG(a.l_p + at(i)), 0.0f,
                lmat(i), LDG(a.l_valid + at(i)) != 0};
  }
  // the t=1 fresh light sample of eye vertex ie
  HD Vert fresh(int ie) const {
    const int k = (ie - 1) * a.n_lanes + s;
    return Vert{row3(a.f_pos + 3 * k), row3(a.f_n + 3 * k),
                row3(a.f_alpha + 3 * k), LDG(a.f_p + k),
                LDG(a.f_dir_pdf + k), -1, LDG(a.f_valid + k) != 0};
  }

  // _pg: p * G of sampling cur from prev, arrived at prev from prev2
  HD float pg(V3 prev_pos, V3 prev_n, int prev_mat, V3 prev2_pos,
              V3 cur_pos, V3 cur_n) const {
    const Seg wi = seg(prev_pos, cur_pos);
    const Seg wo = seg(prev_pos, prev2_pos);
    const float p =
        mis_pdf_local(a.mats, a.n_mats, prev_mat, wo.d, wi.d, prev_n);
    return p * geom(wi.d, prev_n, cur_n, wi.dist);
  }

  // _junction_pg
  HD float junction_pg(const Vert& prev, V3 prev2_pos, V3 cur_pos, V3 cur_n,
                       bool use_dir_pdf) const {
    const Seg wi = seg(prev.pos, cur_pos);
    float p;
    if (use_dir_pdf) {
      p = prev.dir_pdf;
    } else {
      const Seg wo = seg(prev.pos, prev2_pos);
      p = mis_pdf_local(a.mats, a.n_mats, prev.mat, wo.d, wi.d, prev.n);
    }
    return p * geom(wi.d, prev.n, cur_n, wi.dist);
  }

  HD bool delta(int mid) const { return is_delta(a.mats, a.n_mats, mid); }
};

struct Tables {
  // index i of the op chain's dicts; W needs lo + 1 = 3 at nv = 1
  float Ae[kMaxV + 2], Be[kMaxV + 2], De[kMaxV + 2], We[kMaxV + 2];
  float Al[kMaxV + 2], Bl[kMaxV + 2], Dl[kMaxV + 2], Wl[kMaxV + 2];
};

// _mis_tables; De / Dl hold dbar: 0 where the step is delta, else 1
HD void mis_tables(const Lane& L, Tables& t) {
  const Args& a = L.a;
  const int nv = a.nv;
  for (int i = 2; i <= nv; ++i) {
    if (i + 2 <= nv) {
      t.Ae[i] = L.pg(L.epos(i + 1), L.en(i + 1), L.emat(i + 1),
                     L.epos(i + 2), L.epos(i), L.en(i));
    }
    if (i == 2 && a.consistent_camera) {
      const CamSample ci = camera_sample(a.cam, L.epos(2), 1, 1);
      const Seg wi = seg(L.epos(1), L.epos(2));
      const float g = fabsf(dot(wi.d, L.en(2))) /
                      clamp_min(wi.dist * wi.dist, 1e-12f);
      t.Be[i] = ci.dir_pdf * g;
    } else if (i == 2) {
      t.Be[i] = 1.0f;
    } else {
      t.Be[i] = L.pg(L.epos(i - 1), L.en(i - 1), L.emat(i - 1),
                     L.epos(i - 2), L.epos(i), L.en(i));
    }
    t.De[i] = (L.delta(L.emat(i)) || L.delta(L.emat(i - 1))) ? 0.0f : 1.0f;
  }
  if (a.has_light) {
    for (int i = 1; i <= nv; ++i) {
      if (i + 2 <= nv) {
        t.Al[i] = L.pg(L.lpos(i + 1), L.ln(i + 1), L.lmat(i + 1),
                       L.lpos(i + 2), L.lpos(i), L.ln(i));
      }
      if (i == 1) {
        t.Bl[i] = LDG(a.l_p + L.at(1));
      } else if (i == 2) {
        const Seg wi = seg(L.lpos(1), L.lpos(2));
        t.Bl[i] = LDG(a.l_dir_pdf + L.s) *
                  geom(wi.d, L.ln(1), L.ln(2), wi.dist);
      } else {
        t.Bl[i] = L.pg(L.lpos(i - 1), L.ln(i - 1), L.lmat(i - 1),
                       L.lpos(i - 2), L.lpos(i), L.ln(i));
      }
      t.Dl[i] = (L.delta(L.lmat(i)) || L.delta(L.lmat(i - 1))) ? 0.0f : 1.0f;
    }
  }
  // W[k + 1] = a[k - 1]^2 (W[k] + Dbar[k - 1]), a[j] = A[j] / max(B[j], eps)
  t.We[2] = t.We[3] = 0.0f;
  for (int k = 3; k < nv; ++k) {
    const float ak = t.Ae[k - 1] / clamp_min(t.Be[k - 1], 1e-20f);
    t.We[k + 1] = (ak * ak) * (t.We[k] + t.De[k - 1]);
  }
  t.Wl[1] = t.Wl[2] = 0.0f;
  if (a.has_light) {
    for (int k = 2; k < nv; ++k) {
      const float ak = t.Al[k - 1] / clamp_min(t.Bl[k - 1], 1e-20f);
      t.Wl[k + 1] = (ak * ak) * (t.Wl[k] + t.Dl[k - 1]);
    }
  }
}

HD float finish_weight(float w_inv, bool zero_unless_found, bool found) {
  float w = 1.0f / w_inv;
  if (zero_unless_found && !found) w = 0.0f;
  return finite(w) ? w : 0.0f;
}

// The t = 0 combo (i_light = 0, i_eye >= 2): the eye vertex on a light.
HD V3 combo_on_light(const Lane& L, const Tables& t, int ie) {
  const Args& a = L.a;
  const Vert ve = L.eye(ie);
  // an invalid vertex masks the contribution to 0: ill is +0 (below)
  if (!ve.valid) return vsplat(0.0f);
  const V3 prev_pos = L.epos(ie - 1);
  // _eye_on_light_pdfs: the first light that contains the point
  const V3 wi = seg(prev_pos, ve.pos).d;
  bool found = false;
  int li_found = -1;
  float point_pdf = 0.0f;
  V3 rad = vsplat(0.0f);
  for (int li = 0; li < a.n_lights; ++li) {
    const Light l = light_row(a.lights, li);
    const bool contains = contain_point(l, ve.pos);
    if (contains && !found) {
      const LightPdf lp = light_sample_pdf(l, ve.pos, wi);
      point_pdf = lp.point_pdf;
      rad = lp.rad;
      li_found = li;
    }
    found = found || contains;
  }
  const V3 emit = emission(a.mats, a.n_mats, ve.mat);
  const bool emit_big = vnorm(emit) > kEps;
  const V3 c = emit_big ? vsel(found, rad, vsplat(0.0f)) : emit;
  const V3 contrib = vmul(ve.alpha, c);
  // where(big, contrib * w, 0) is +0 whatever the weight
  if (!(vnorm(contrib) > kEps)) return vsplat(0.0f);

  // _mis_weight, eye side only
  float w_inv = 1.0f;
  const float nomj = found ? point_pdf : NAN;
  const float r_e = nomj / clamp_min(t.Be[ie], 1e-20f);
  w_inv = w_inv + (t.De[ie] * r_e) * r_e;
  if (ie >= 3) {
    const int i = ie - 1;
    const Seg wi2 = seg(ve.pos, L.epos(i));
    float dir_pdf = 0.0f;
    if (li_found >= 0) {
      const Light l = light_row(a.lights, li_found);
      dir_pdf = light_sample_pdf(l, ve.pos, vneg(wi2.d)).dir_pdf;
    }
    const float nom2 = dir_pdf * geom(wi2.d, ve.n, L.en(i), wi2.dist);
    const float c_e = (r_e * nom2) / clamp_min(t.Be[i], 1e-20f);
    w_inv = w_inv + (c_e * c_e) * (t.De[i] + t.We[ie]);
  }
  const float w = finish_weight(w_inv, true, found);
  return keep_finite(vscale(contrib, w));
}

// A combo with i_light >= 1; for i_eye = 1 also the splat's pixel.
// Where the pair is invalid or its segment blocked, the contribution is 0
// (or NaN from an infinite alpha times 0), `big` is false and ill is +0,
// so neither the BSDFs nor the weight are evaluated.
HD V3 combo_connect(const Lane& L, const Tables& t, int ie, int il,
                    int64_t* flat, bool* in_frame) {
  const Args& a = L.a;
  const Vert vl = il == 1 ? L.fresh(ie) : L.light(il);
  Vert ve;
  if (ie == 1) {
    // the light vertex connects to the camera: the eye sample
    const CamSample ci = camera_sample(a.cam, vl.pos, a.width, a.height);
    ve = Vert{row3(a.cam + 9), ci.normal, vsplat(ci.we), 1.0f, ci.dir_pdf,
              -1, true};
    const int32_t px = to_i32(ci.px), py = to_i32(ci.py);
    const int32_t f = (int32_t)((uint32_t)py * (uint32_t)a.width +
                                (uint32_t)px);
    const int32_t hi = a.height * a.width - 1;
    *flat = f < 0 ? 0 : (f > hi ? hi : f);
    *in_frame = ci.in_frame;
  } else {
    ve = L.eye(ie);
  }
  const bool blocked =
      LDG(a.blocked + ((ie - 1) * a.nv + (il - 1)) * a.n_lanes + L.s) != 0;
  if (!(ve.valid && vl.valid) || blocked) return vsplat(0.0f);
  V3 f_eye = vsplat(1.0f);
  if (ie > 1) {
    const Frame fe = coord_space(ve.n);
    const V3 eye_ray = seg(ve.pos, L.epos(ie - 1)).d;
    const V3 conn_e = seg(ve.pos, vl.pos).d;
    f_eye = eval_f(a.mats, a.n_mats, ve.mat, to_local(fe, eye_ray),
                   to_local(fe, conn_e));
  }
  V3 f_light = vsplat(1.0f);
  if (il > 1) {
    const Frame fl = coord_space(vl.n);
    const V3 light_ray = seg(vl.pos, L.lpos(il - 1)).d;
    const V3 conn_l = seg(vl.pos, ve.pos).d;
    f_light = eval_f(a.mats, a.n_mats, vl.mat, to_local(fl, conn_l),
                     to_local(fl, light_ray));
  }
  const Seg conn = seg(ve.pos, vl.pos);
  const float g = fabsf(dot(vl.n, conn.d) * dot(ve.n, conn.d)) /
                  clamp_min(conn.dist * conn.dist, 1e-12f);
  const V3 c = vmul(vscale(f_eye, g), f_light);
  const V3 contrib = vmul(vmul(ve.alpha, vl.alpha), c);
  if (!(vnorm(contrib) > kEps)) return vsplat(0.0f);

  // _mis_weight: the junction factors of both sides
  float w_inv = 1.0f;
  if (ie >= 2) {
    const float nomj = L.junction_pg(vl, L.lpos(il - 1), ve.pos, ve.n,
                                     il == 1);
    const float r_e = nomj / clamp_min(t.Be[ie], 1e-20f);
    w_inv = w_inv + (t.De[ie] * r_e) * r_e;
    if (ie >= 3) {
      const int i = ie - 1;
      const float nom2 =
          L.pg(ve.pos, ve.n, ve.mat, vl.pos, L.epos(i), L.en(i));
      const float c_e = (r_e * nom2) / clamp_min(t.Be[i], 1e-20f);
      w_inv = w_inv + (c_e * c_e) * (t.De[i] + t.We[ie]);
    }
  }
  V3 cur_pos, cur_n;
  float denj;
  if (il == 1 && !a.t1_reference) {
    cur_pos = vl.pos;
    cur_n = vl.n;
    denj = vl.p;
  } else {
    cur_pos = L.lpos(il);
    cur_n = L.ln(il);
    denj = t.Bl[il];
  }
  const float nomj =
      L.junction_pg(ve, L.epos(ie - 1), cur_pos, cur_n, ie <= 1);
  const float r_l = nomj / clamp_min(denj, 1e-20f);
  w_inv = w_inv + (t.Dl[il] * r_l) * r_l;
  if (il >= 2) {
    const int i = il - 1;
    const float nom2 = L.pg(L.lpos(il), L.ln(il), L.lmat(il), ve.pos,
                            L.lpos(i), L.ln(i));
    const float c_l = (r_l * nom2) / clamp_min(t.Bl[i], 1e-20f);
    w_inv = w_inv + (c_l * c_l) * (t.Dl[i] + t.Wl[il]);
  }
  const float w = finish_weight(w_inv, false, false);
  return keep_finite(vscale(contrib, w));
}

HD void connect_lane(const Args& a, int s) {
  const Lane L{a, s};
  Tables t;
  mis_tables(L, t);
  V3 eye_l = row3(a.eye_l + 3 * s);
  const float inv_ns_aa = LDG(a.inv_ns_aa);
  const int n_il = a.has_light ? a.nv : 0;
  for (int ie = 1; ie <= a.nv; ++ie) {
    for (int il = 0; il <= n_il; ++il) {
      if (il == 0) {
        if (ie >= 2) eye_l = vadd(eye_l, combo_on_light(L, t, ie));
        continue;
      }
      int64_t flat = 0;
      bool in_frame = false;
      const V3 ill = combo_connect(L, t, ie, il, &flat, &in_frame);
      if (ie >= 2) {
        eye_l = vadd(eye_l, ill);
      } else {
        const int k = (il - 1) * a.n_lanes + s;
        const V3 v = vsel(in_frame, vscale(ill, inv_ns_aa), vsplat(0.0f));
        a.splat_flat[k] = flat;
        a.splat_val[3 * k + 0] = v.x;
        a.splat_val[3 * k + 1] = v.y;
        a.splat_val[3 * k + 2] = v.z;
      }
    }
  }
  a.eye_l[3 * s + 0] = eye_l.x;
  a.eye_l[3 * s + 1] = eye_l.y;
  a.eye_l[3 * s + 2] = eye_l.z;
}

#ifdef __CUDACC__
__global__ void connect_kernel(const __grid_constant__ Args a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < a.n_lanes) connect_lane(a, s);
}
#endif

}  // namespace

extern "C" {

int connect_max_vertices() { return kMaxV; }

#ifdef __CUDACC__
// Launches the kernel on `stream`; returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for nv outside 1..kMaxV).
int connect_launch(const Args* args, void* stream) {
  if (args->nv < 1 || args->nv > kMaxV) return (int)cudaErrorInvalidValue;
  if (args->n_lanes > 0) {
    const int blocks = (args->n_lanes + kBlock - 1) / kBlock;
    connect_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
#else
// The same lanes on the host, in order; returns 0, or 1 for nv outside
// 1..kMaxV.
int connect_host(const Args* args) {
  if (args->nv < 1 || args->nv > kMaxV) return 1;
  for (int s = 0; s < args->n_lanes; ++s) connect_lane(*args, s);
  return 0;
}
#endif

}  // extern "C"
