// Device helpers shared by the BDPT kernels (connect.cu, walk.cu): float32
// vectors, the shading frame and the material table, each in the op chain's
// float32 operations and order (models/bdpt.py, core/math.py, ops/bsdf.py).
//
// The kernels are built with -fmad=false, as ATen's separate elementwise
// kernels round each product.  Where ATen rewrites an operation, these do
// too: x / c for a Python float c is x * (1 / c); 1.0 / x and x ** 2 are
// 1.0f / x and x * x.  A sum over a last dimension of 3 follows ATen's
// reduction (two threads a row: (x0 + x2) + x1), a sum over the
// second-to-last (to_local) runs in order.
//
// Include inside the including file's anonymous namespace, after defining
// HD (the function qualifiers) and LDG (a read-only load).

// table rows (ops/bsdf.py rows): kind, albedo, emission, ior, roughness,
// eta, k, reflectance, transmittance and pads
constexpr int kMatStride = 24;
constexpr int kMatAlbedo = 1, kMatEmission = 4, kMatIor = 7,
              kMatRoughness = 8, kMatEta = 9, kMatK = 12,
              kMatReflectance = 15, kMatTransmittance = 18;

// scene/types.py kinds
constexpr int kDiffuse = 0, kEmission = 1, kMirror = 2, kRefraction = 3,
              kGlass = 4, kMicrofacet = 5;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 1.0f / kPi;                       // x / PI in ATen
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);  // 2.0 * PI
constexpr float kEps = 1e-5f;                              // EPS_F
constexpr float kCosLo = (float)(-1.0 + 1e-5);
constexpr float kCosHi = (float)(1.0 - 1e-5);

struct V3 {
  float x, y, z;
};

HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
HD V3 vsplat(float a) { return V3{a, a, a}; }
HD V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
HD V3 vsub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
HD V3 vmul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
HD V3 vscale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
HD V3 vdiv(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
HD V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
HD V3 vsel(bool c, V3 a, V3 b) { return c ? a : b; }

// torch.sum over a last dimension of 3, and over dim -2 (to_local)
HD float rsum3(float a, float b, float c) { return (a + c) + b; }
HD float csum3(float a, float b, float c) { return (a + b) + c; }

HD float dot(V3 a, V3 b) { return rsum3(a.x * b.x, a.y * b.y, a.z * b.z); }
// torch.linalg.vector_norm
HD float vnorm(V3 a) { return sqrtf(rsum3(a.x * a.x, a.y * a.y, a.z * a.z)); }
HD bool is_nan(float x) { return x != x; }
// torch.clamp_min / torch.clamp: NaN propagates
HD float clamp_min(float x, float lo) { return is_nan(x) ? x : fmaxf(x, lo); }
HD float clamp(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}
HD bool finite(float x) { return x - x == 0.0f; }
HD V3 keep_finite(V3 a) {
  return v3(finite(a.x) ? a.x : 0.0f, finite(a.y) ? a.y : 0.0f,
            finite(a.z) ? a.z : 0.0f);
}

HD V3 row3(const float* p) { return v3(LDG(p), LDG(p + 1), LDG(p + 2)); }

// core/math.py normalize
HD V3 normalize(V3 v) {
  const float n = sqrtf(clamp_min(dot(v, v), 0.0f));
  return vdiv(v, clamp_min(n, 1e-20f));
}
HD V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// core/math.py make_coord_space: columns x, y, z = normalize(n)
struct Frame {
  V3 x, y, z;
};

HD Frame coord_space(V3 n) {
  const V3 z = normalize(n);
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  const bool pick_x = (ax <= ay) && (ax <= az);
  const bool pick_y = !pick_x && (ay <= az);
  const V3 h = v3(pick_x ? 1.0f : n.x, pick_y ? 1.0f : n.y,
                  !(pick_x || pick_y) ? 1.0f : n.z);
  const V3 y = normalize(cross(h, z));
  const V3 x = normalize(cross(z, y));
  return Frame{x, y, z};
}

HD V3 to_local(const Frame& f, V3 v) {
  return v3(csum3(f.x.x * v.x, f.x.y * v.y, f.x.z * v.z),
            csum3(f.y.x * v.x, f.y.y * v.y, f.y.z * v.z),
            csum3(f.z.x * v.x, f.z.y * v.y, f.z.z * v.z));
}

// core/math.py to_world: row r of the frame times v, summed over the last dim
HD V3 to_world(const Frame& f, V3 v) {
  return v3(rsum3(f.x.x * v.x, f.y.x * v.y, f.z.x * v.z),
            rsum3(f.x.y * v.x, f.y.y * v.y, f.z.y * v.z),
            rsum3(f.x.z * v.x, f.y.z * v.y, f.z.z * v.z));
}

// --- materials (ops/bsdf.py) ------------------------------------------------

struct Mat {
  const float* row;  // nullptr for mid < 0
  int kind;
};

// the row of a material id as eval_f and mis_pdf see it: kind -1 for
// mid < 0 (their results are masked there), ids past the table clipped
HD Mat material(const float* mats, int n_mats, int mid) {
  if (mid < 0) return Mat{nullptr, -1};
  const int m = mid < n_mats - 1 ? mid : n_mats - 1;
  const float* row = mats + m * kMatStride;
  return Mat{row, (int)LDG(row)};
}

HD bool is_delta(const float* mats, int n_mats, int mid) {
  const Mat m = material(mats, n_mats, mid);
  return m.kind == kMirror || m.kind == kRefraction || m.kind == kGlass;
}

HD V3 emission(const float* mats, int n_mats, int mid) {
  const Mat m = material(mats, n_mats, mid);
  return m.kind == kEmission ? row3(m.row + kMatEmission) : vsplat(0.0f);
}

HD float beckmann_d(V3 h, float alpha) {
  const float cos_t = clamp(h.z, kCosLo, kCosHi);
  const float cos2 = cos_t * cos_t;
  const float tan2 = (1.0f - cos2) / cos2;
  return expf(-tan2 / (alpha * alpha)) /
         ((((kPi * alpha) * alpha) * cos2) * cos2);
}

HD float smith_lambda(V3 w, float alpha) {
  const float cos_t = clamp(w.z, kCosLo, kCosHi);
  const float theta = acosf(cos_t);
  const float a = 1.0f / (alpha * tanf(theta));
  return 0.5f * ((erff(a) - 1.0f) + expf(-a * a) / (a * kPi));
}

HD V3 unit(V3 v) { return vdiv(v, clamp_min(vnorm(v), 1e-20f)); }

HD float conductor_fresnel(float cos_t, float eta, float k) {
  const float e2k2 = eta * eta + k * k;
  const float c2 = cos_t * cos_t;
  const float t2 = (2.0f * eta) * cos_t;
  const float rs = ((e2k2 - t2) + c2) / ((e2k2 + t2) + c2);
  const float rp = ((e2k2 * c2 - t2) + 1.0f) / ((e2k2 * c2 + t2) + 1.0f);
  return (rs + rp) * 0.5f;
}

HD V3 microfacet_f(const float* row, V3 wo, V3 wi) {
  const bool good = wo.z > kEps && wi.z > kEps;
  if (!good) return vsplat(0.0f);
  const V3 h = unit(vadd(wo, wi));
  const float alpha = LDG(row + kMatRoughness);
  const float inv =
      1.0f / ((smith_lambda(wi, alpha) + 1.0f) + smith_lambda(wo, alpha));
  const float d = beckmann_d(h, alpha);
  const float den = (4.0f * wo.z) * wi.z;
  const float cos_t = fabsf(wi.z);
  const V3 eta = row3(row + kMatEta), k = row3(row + kMatK);
  return v3(((conductor_fresnel(cos_t, eta.x, k.x) * inv) * d) / den,
            ((conductor_fresnel(cos_t, eta.y, k.y) * inv) * d) / den,
            ((conductor_fresnel(cos_t, eta.z, k.z) * inv) * d) / den);
}

HD float microfacet_pdf(float alpha, V3 wo, V3 wi) {
  const bool good = wo.z > kEps && wi.z > kEps;
  if (!good) return 0.0f;
  const V3 h = unit(vadd(wo, wi));
  const float pdf_h = beckmann_d(h, alpha) * fabsf(h.z);
  const float denom = 4.0f * fabsf(dot(wi, h));
  return pdf_h / clamp_min(denom, 1e-12f);
}

// ops/bsdf.py eval_f: the lane's own kind only
HD V3 eval_f(const float* mats, int n_mats, int mid, V3 wo, V3 wi) {
  const Mat m = material(mats, n_mats, mid);
  switch (m.kind) {
    case kDiffuse:
      return (wo.z >= 0.0f && wi.z >= 0.0f)
                 ? vscale(row3(m.row + kMatAlbedo), kInvPi)
                 : vsplat(0.0f);
    case kMicrofacet:
      return microfacet_f(m.row, wo, wi);
    default:
      return vsplat(0.0f);
  }
}

HD float cosine_pdf(V3 v) { return v.z > 0.0f ? v.z * kInvPi : 0.0f; }

// ops/bsdf.py mis_pdf: sample_pdf under an empty wo, the NDF pdf for
// microfacets
HD float mis_pdf(const float* mats, int n_mats, int mid, V3 wo, V3 wi) {
  const Mat m = material(mats, n_mats, mid);
  switch (m.kind) {
    case -1:
      return 0.0f;
    case kMirror:
    case kRefraction:
      return 1.0f;
    case kGlass: {
      const float ior = LDG(m.row + kMatIor);
      const bool enter = wi.z > 0.0f;
      const float eta = enter ? 1.0f / ior : ior;
      const float z_sq = 1.0f - (eta * eta) * (1.0f - wi.z * wi.z);
      const bool ok = z_sq >= 0.0f;
      const float z = (enter ? -1.0f : 1.0f) * sqrtf(clamp_min(z_sq, 0.0f));
      const float q = (1.0f - ior) / (ior + 1.0f);
      const float r0 = q * q;
      const float r = r0 + (1.0f - r0) * powf(1.0f - fabsf(z), 5.0f);
      return ok ? (wi.z > 0.0f ? r : 1.0f - r) : 1.0f;
    }
    case kMicrofacet:
      return microfacet_pdf(LDG(m.row + kMatRoughness), wo, wi);
    default:
      return cosine_pdf(wi);
  }
}
