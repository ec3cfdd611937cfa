"""Vectorized BSDF table: eval / sample / pdf / emission for a wavefront
(PyTorch port of bidirectional_pathtracing_tpu/ops/bsdf.py).

Masked select over material kinds replaces the reference's virtual-dispatch
BSDF hierarchy (src/pathtracer/bsdf.{h,cpp}, advanced_bsdf.cpp): every
branch is computed for all lanes, then selected by the per-lane kind.  All
directions are in the local shading frame (+z = shading normal).

Semantics per kind (reference citations):
  DIFFUSE    f = albedo/pi one-sided (bsdf.cpp:52-61), cosine sampling
             (bsdf.cpp:66-77), pdf z/pi (bsdf.cpp:80-85)
  EMISSION   f = 0, cosine sampling, get_emission = radiance
             (bsdf.cpp:99-118)
  MIRROR     delta reflect, pdf coefficient 1, f = R/|cos| scaling
             (advanced_bsdf.cpp:17-35)
  REFRACTION Snell delta, f = T/|cos|/eta^2, TIR returns black
             (advanced_bsdf.cpp:163-184)
  GLASS      Schlick coin flip between reflect/refract, f carries the
             R / (1-R) factors, pdf coefficients R / 1-R
             (advanced_bsdf.cpp:202-259)
  MICROFACET Beckmann NDF + conductor Fresnel + Smith shadowing, NDF
             importance sampling (advanced_bsdf.cpp:48-141), with the NDF
             pdf that the reference leaves unimplemented.

Sampled directions and pdfs are detached (the detached-sampling estimator
of the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bidirectional_pathtracing_tpu_torch.core.math import (
    PI, const, reflect_local, refract_local)
from bidirectional_pathtracing_tpu_torch.core import samplers
from bidirectional_pathtracing_tpu_torch.scene.types import (
    Materials,
    MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS, MAT_MICROFACET, MAT_MIRROR,
    MAT_REFRACTION,
)


class BSDFSample(NamedTuple):
    wi: torch.Tensor        # [S,3] local
    f: torch.Tensor         # [S,3] BSDF value (with delta scalings folded in)
    pdf: torch.Tensor       # [S]   solid-angle pdf (delta: discrete coefficient)
    is_delta: torch.Tensor  # bool [S]


def gather(materials: Materials, mid) -> Materials:
    """Per-lane material params; mid: int32 [S] (clipped to range)."""
    m = torch.clamp(mid, 0, materials.count - 1).long()
    return Materials(*(a[m] for a in materials))


def rows(materials: Materials) -> torch.Tensor:
    """The material table [M, 24] float32 in csrc/shading.cuh's row layout
    (the BDPT kernels' table): kind, albedo, emission, ior, roughness, eta,
    k, reflectance, transmittance and three pads, made on the table's
    device by torch ops (no host copy, so a CUDA graph records it)."""
    m = materials

    def col(x):
        return x.to(torch.float32)[:, None]

    return torch.cat([col(m.kind), m.albedo, m.emission, col(m.ior),
                      col(m.roughness), m.eta, m.k, m.reflectance,
                      m.transmittance,
                      torch.zeros((m.count, 3), dtype=torch.float32,
                                  device=m.kind.device)], dim=1)


def is_delta(materials: Materials, mid):
    kind = materials.kind[torch.clamp(mid, 0, materials.count - 1).long()]
    return ((kind == MAT_MIRROR) | (kind == MAT_REFRACTION)
            | (kind == MAT_GLASS)) & (mid >= 0)


def emission(materials: Materials, mid):
    """get_emission(); zero for non-emission kinds and invalid mids."""
    m = gather(materials, mid)
    e = torch.where((m.kind == MAT_EMISSION)[..., None], m.emission, 0.0)
    return torch.where((mid >= 0)[..., None], e, 0.0)


def _abs_cos(w):
    return torch.abs(w[..., 2])


def _unit(v):
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-20)


# --- Microfacet helpers (advanced_bsdf.cpp:48-141) -------------------------

def _beckmann_d(h, alpha):
    cos_t = torch.clamp(h[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    cos2 = cos_t * cos_t
    tan2 = (1.0 - cos2) / cos2
    return torch.exp(-tan2 / (alpha * alpha)) / (PI * alpha * alpha * cos2 * cos2)


def _smith_lambda(w, alpha):
    cos_t = torch.clamp(w[..., 2], -1.0 + 1e-5, 1.0 - 1e-5)
    theta = torch.acos(cos_t)
    a = 1.0 / (alpha * torch.tan(theta))
    return 0.5 * (torch.erf(a) - 1.0 + torch.exp(-a * a) / (a * PI))


def _conductor_fresnel(wi, eta, k):
    cos_t = _abs_cos(wi)[..., None]
    e2k2 = eta * eta + k * k
    c2 = cos_t * cos_t
    rs = (e2k2 - 2 * eta * cos_t + c2) / (e2k2 + 2 * eta * cos_t + c2)
    rp = (e2k2 * c2 - 2 * eta * cos_t + 1) / (e2k2 * c2 + 2 * eta * cos_t + 1)
    return (rs + rp) / 2


def _microfacet_f(m, wo, wi):
    h = _unit(wo + wi)
    alpha = m.roughness
    val = (_conductor_fresnel(wi, m.eta, m.k)
           * (1.0 / (1.0 + _smith_lambda(wi, alpha)
                     + _smith_lambda(wo, alpha)))[..., None]
           * _beckmann_d(h, alpha)[..., None]
           / (4.0 * wo[..., 2:3] * wi[..., 2:3]))
    good = (wo[..., 2] > 1e-5) & (wi[..., 2] > 1e-5)
    return torch.where(good[..., None], val, 0.0)


def _microfacet_pdf(alpha, wo, wi):
    """NDF pdf of wi given wo: p(h)/(4 |wi.h|) with Beckmann p(h)=D(h)|cos h|."""
    h = _unit(wo + wi)
    pdf_h = _beckmann_d(h, alpha) * torch.abs(h[..., 2])
    denom = 4.0 * torch.abs(torch.sum(wi * h, dim=-1))
    pdf = pdf_h / torch.clamp_min(denom, 1e-12)
    good = (wo[..., 2] > 1e-5) & (wi[..., 2] > 1e-5)
    return torch.where(good, pdf, 0.0)


def _schlick(m, wo_side_z, cos_refract):
    """R per Schlick (advanced_bsdf.cpp:219-224); eta from the wo side."""
    eta = torch.where(wo_side_z > 0, 1.0 / m.ior, m.ior)
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    r = r0 + (1.0 - r0) * (1.0 - cos_refract) ** 5
    return r, eta


# --- public API -------------------------------------------------------------

def eval_f(materials: Materials, mid, wo, wi):
    """BSDF::f for non-delta kinds; deltas and invalid lanes return 0."""
    m = gather(materials, mid)
    # diffuse (one-sided: both z >= 0, bsdf.cpp:56-58)
    f_diff = torch.where(
        ((wo[..., 2] >= 0) & (wi[..., 2] >= 0))[..., None],
        m.albedo / PI, 0.0)
    f_micro = _microfacet_f(m, wo, wi)
    f = torch.where((m.kind == MAT_DIFFUSE)[..., None], f_diff, 0.0)
    f = torch.where((m.kind == MAT_MICROFACET)[..., None], f_micro, f)
    return torch.where((mid >= 0)[..., None], f, 0.0)


def sample(materials: Materials, mid, wo, u, adjoint: bool = False) -> BSDFSample:
    """BSDF::sample_f for a wavefront.

    u: uniforms [S,3] — u[...,0:2] drive direction sampling, u[...,2] the
    glass reflect/refract coin flip (coin_flip(R), advanced_bsdf.cpp:225).
    adjoint: set for LIGHT-subpath walks; the microfacet f swaps its
    arguments (Veach 5.2 adjoint BSDF), see the JAX package's docstring.
    """
    m = gather(materials, mid)
    u2 = u[..., 0:2]

    # cosine-weighted candidate (diffuse + emission; bsdf.cpp:66-77)
    wi_cos, pdf_cos = samplers.cosine_hemisphere(u2)

    # mirror reflect (advanced_bsdf.cpp:21-29)
    wi_ref = reflect_local(wo)
    f_mirror = m.reflectance / torch.clamp_min(_abs_cos(wi_ref), 1e-12)[..., None]

    # refraction (advanced_bsdf.cpp:167-178)
    wi_refr, refr_ok = refract_local(wo, m.ior)
    eta_wo = torch.where(wo[..., 2] > 0, 1.0 / m.ior, m.ior)
    f_refr = (m.transmittance
              / torch.clamp_min(_abs_cos(wi_refr), 1e-12)[..., None]
              / (eta_wo * eta_wo)[..., None])
    f_refr = torch.where(refr_ok[..., None], f_refr, 0.0)

    # glass (advanced_bsdf.cpp:202-236)
    r_schlick, _ = _schlick(m, wo[..., 2], _abs_cos(wi_refr))
    choose_reflect = (~refr_ok) | (u[..., 2] < r_schlick)
    r_eff = torch.where(refr_ok, r_schlick, 1.0)
    wi_glass = torch.where(choose_reflect[..., None], wi_ref, wi_refr)
    f_glass_ref = r_eff[..., None] * m.reflectance / torch.clamp_min(
        _abs_cos(wi_ref), 1e-12)[..., None]
    # TIR: pdf 1, plain reflectance/|cos| (advanced_bsdf.cpp:213-218)
    f_glass_ref = torch.where(refr_ok[..., None], f_glass_ref,
                              m.reflectance / torch.clamp_min(
                                  _abs_cos(wi_ref), 1e-12)[..., None])
    f_glass_refr = ((1.0 - r_eff)[..., None] * m.transmittance
                    / torch.clamp_min(_abs_cos(wi_refr), 1e-12)[..., None]
                    / (eta_wo * eta_wo)[..., None])
    f_glass = torch.where(choose_reflect[..., None], f_glass_ref, f_glass_refr)
    pdf_glass = torch.where(choose_reflect,
                            torch.where(refr_ok, r_eff, 1.0), 1.0 - r_eff)

    # microfacet NDF sampling (advanced_bsdf.cpp:94-141)
    alpha = m.roughness
    theta_h = torch.atan(torch.sqrt(torch.clamp_min(
        -alpha * alpha * torch.log1p(-u2[..., 0]), 0.0)))
    phi_h = 2.0 * PI * u2[..., 1]
    h = torch.stack([torch.sin(theta_h) * torch.cos(phi_h),
                     torch.sin(theta_h) * torch.sin(phi_h),
                     torch.cos(theta_h)], dim=-1)
    wi_mf = 2.0 * torch.sum(wo * h, dim=-1)[..., None] * h - wo
    wi_mf = _unit(wi_mf)
    mf_ok = (wo[..., 2] > 1e-5) & (wi_mf[..., 2] > 1e-5)
    pdf_mf = _microfacet_pdf(alpha, wo, wi_mf)
    z_axis = const((0.0, 0.0, 1.0), wo.dtype, wo.device)
    wi_mf = torch.where(mf_ok[..., None], wi_mf, z_axis)
    pdf_mf = torch.where(mf_ok, torch.clamp_min(pdf_mf, 1e-12), 1.0)
    f_mf_val = (_microfacet_f(m, wi_mf, wo) if adjoint
                else _microfacet_f(m, wo, wi_mf))
    f_mf = torch.where(mf_ok[..., None], f_mf_val, 0.0)

    kind = m.kind
    wi = wi_cos
    wi = torch.where((kind == MAT_MIRROR)[..., None], wi_ref, wi)
    wi = torch.where((kind == MAT_REFRACTION)[..., None],
                     torch.where(refr_ok[..., None], wi_refr, wi_ref), wi)
    wi = torch.where((kind == MAT_GLASS)[..., None], wi_glass, wi)
    wi = torch.where((kind == MAT_MICROFACET)[..., None], wi_mf, wi)

    f_diff = torch.where(
        ((wo[..., 2] >= 0) & (wi_cos[..., 2] >= 0))[..., None],
        m.albedo / PI, 0.0)
    f = torch.where((kind == MAT_DIFFUSE)[..., None], f_diff, 0.0)
    f = torch.where((kind == MAT_MIRROR)[..., None], f_mirror, f)
    f = torch.where((kind == MAT_REFRACTION)[..., None],
                    torch.where(refr_ok[..., None], f_refr, 0.0), f)
    f = torch.where((kind == MAT_GLASS)[..., None], f_glass, f)
    f = torch.where((kind == MAT_MICROFACET)[..., None], f_mf, f)

    pdf = pdf_cos
    pdf = torch.where(kind == MAT_MIRROR, 1.0, pdf)
    pdf = torch.where(kind == MAT_REFRACTION, 1.0, pdf)
    pdf = torch.where(kind == MAT_GLASS, pdf_glass, pdf)
    pdf = torch.where(kind == MAT_MICROFACET, pdf_mf, pdf)
    pdf = torch.clamp_min(pdf, 1e-12)

    delta = ((kind == MAT_MIRROR) | (kind == MAT_REFRACTION)
             | (kind == MAT_GLASS))
    return BSDFSample(wi=wi.detach(), f=f, pdf=pdf.detach(),
                      is_delta=delta & (mid >= 0))


def sample_pdf(materials: Materials, mid, wo, wi):
    """BSDF::sample_pdf — the MIS pdf contract (bsdf.h:71-110).

    DIFFUSE/EMISSION: cosine pdf of wi.  MIRROR/REFRACTION: 1.
    GLASS: Schlick R for wi.z>0 else 1-R with the reference's eta convention
    under an empty wo (eta = ior; advanced_bsdf.cpp:239-259).
    MICROFACET: the cosine-hemisphere pdf of |wi| as a wo-independent proxy;
    BDPT MIS prices microfacet edges with mis_pdf instead.
    """
    m = gather(materials, mid)
    kind = m.kind
    pdf = samplers.cosine_hemisphere_pdf(wi)
    pdf = torch.where(kind == MAT_MIRROR, 1.0, pdf)
    pdf = torch.where(kind == MAT_REFRACTION, 1.0, pdf)

    # glass: refract wi (treated as the incoming dir, advanced_bsdf.cpp:239-253)
    wo_refr, refr_ok = refract_local(wi, m.ior)
    eta = m.ior  # reference quirk: wo is empty => wo.z>0 false => eta=ior
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    r = r0 + (1.0 - r0) * (1.0 - _abs_cos(wo_refr)) ** 5
    glass_pdf = torch.where(refr_ok, torch.where(wi[..., 2] > 0, r, 1.0 - r),
                            1.0)
    pdf = torch.where(kind == MAT_GLASS, glass_pdf, pdf)

    pdf = torch.where(kind == MAT_MICROFACET,
                      samplers.cosine_hemisphere_pdf(torch.abs(wi)), pdf)
    return torch.where(mid >= 0, pdf, 0.0)


def mis_pdf(materials: Materials, mid, wo, wi):
    """MIS edge pdf with the TRUE arrival direction wo: sample_pdf for every
    reference kind, the Beckmann NDF pdf for MICROFACET (zero outside the
    sampler's support wo.z>0, wi.z>0)."""
    m = gather(materials, mid)
    kind = m.kind
    pdf = sample_pdf(materials, mid, torch.zeros_like(wi), wi)
    pdf = torch.where(kind == MAT_MICROFACET,
                      _microfacet_pdf(m.roughness, wo, wi), pdf)
    return torch.where(mid >= 0, pdf, 0.0)
