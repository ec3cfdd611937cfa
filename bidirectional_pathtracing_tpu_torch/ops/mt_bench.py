"""K3, the per-cluster Möller–Trumbore microbenchmark: the hand-written CUDA
kernels csrc/mt_bench.cu, their plain torch versions, and the benchmark's
inputs.

Port of tools/profiling/mxu_mt_bench.py (`_vpu_kernel`, `_mxu_kernel`,
`amat_from_tris`, the data of `run`).  It times the clustered kernel's inner
loop in isolation: `iters` cluster visits, visit i testing every ray
against the TC = 128 triangles of slot i % NSLOT of a preloaded table.

  - mt_vpu(rays [8,R], tris [8, 9 or 16, 128], iters, late): Möller–Trumbore
    on the vertex rows (0-2 v0, 3-5 v1, 6-8 v2);
  - mt_linear(rays [8,R], amat [8,512,16], iters, late): the same test with
    its numerators as the product of each amat row with the per-ray
    features z = [o, d, o x d, 1, 0 x 6] (the TPU's MXU form), on the
    card's tensor cores in TF32, three products a_hi z_hi + a_hi z_lo +
    a_lo z_hi (x_hi = tf32(x), x_lo = tf32(x - x_hi)), which keep the
    numerators near FP32 accuracy, and a reciprocal within one ulp;
  - rays rows: o xyz, d xyz, min_t, max_t.  Out [2,R] f32: best t (INF =
    3.0e38 on a miss, not the renderer's 1e30) and the in-cluster index of
    the winner as f32 (-1 on a miss).

late=False tests t <= min(max_t, best_t) per element; late=True moves the
limit to the reduced cluster minimum (cmin < best_t and cmin <= max_t).
Both give the same closest hit.  Inside a visit the lowest in-cluster index
wins ties among equal minimum t; across visits a strict < keeps the earlier
one.

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises; there is no fallback.  mt_vpu.launches and
mt_linear.launches count kernel launches.  mt_vpu_plain sums every dot
product term by term in the kernel's order, so with nvcc's -fmad=false
(ops/_build.py) kernel and plain version agree bitwise.  The tensor cores
sum in an unspecified order, so mt_linear is held against the plain FP32
version mt_linear_plain by linear_gate, a stated tolerance;
mt_linear_tf32_plain emulates its arithmetic on any device.

mt_linear's table is made on the host, once per amat: the rows permuted
(MMA_ROWS) so that one 16-row tile holds the denominators and t numerators
of 8 triangles and the next their b1 and b2 numerators, then split into
TF32 hi and lo parts and laid out in mma.sync's A-fragment order
(mma_table).

Not ported: the TPU tool's `chunk` variants (vpu-chunk16 / vpu-chunk32 and
the chunked mxu-late).  They split a cluster into [chunk, R] pieces so the
live set fits the TPU's vector registers, and give the same result as the
unchunked late form.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.ops._memo import last_of

TC = 128       # triangles per cluster
NSLOT = 8      # preloaded clusters cycled over
INF = 3.0e38   # the benchmark's miss sentinel
N_FEAT = 16    # linear-form features per ray
FLOPS_PER_TEST = 55   # the JAX tool's MT-equivalent count per ray-triangle

_KERNEL = "mt_bench"


def amat_from_tris(tris: np.ndarray) -> np.ndarray:
    """tris [NSLOT, 16, TC] -> A [NSLOT, 4*TC, 16] linear-form matrices
    (copy of tools/profiling/mxu_mt_bench.py:148-164).  Rows 0..TC-1 give
    the denominator, then t, b1 and b2 numerators, against z."""
    v0 = tris[:, 0:3, :].transpose(0, 2, 1)   # [S, TC, 3]
    v1 = tris[:, 3:6, :].transpose(0, 2, 1)
    v2 = tris[:, 6:9, :].transpose(0, 2, 1)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    a = np.zeros((tris.shape[0], 4, tris.shape[2], 16), np.float32)
    a[:, 0, :, 3:6] = -n                                   # denom = -n.d
    a[:, 1, :, 0:3] = n                                    # t_num = n.o - n.v0
    a[:, 1, :, 9] = -np.sum(n * v0, -1)
    a[:, 2, :, 6:9] = e2                                   # b1 = e2.c - (e2xv0).d
    a[:, 2, :, 3:6] = -np.cross(e2, v0)
    a[:, 3, :, 6:9] = -e1                                  # b2 = -e1.c - (v0xe1).d
    a[:, 3, :, 3:6] = -np.cross(v0, e1)
    return a.reshape(tris.shape[0], 4 * tris.shape[2], 16)


def make_inputs(r: int, seed: int = 0):
    """(rays [8,r], tris [NSLOT,16,TC], amat [NSLOT,4*TC,16]) as f32 numpy,
    drawn exactly as the TPU tool's `run` draws them (:168-177)."""
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1, 1, (NSLOT, 16, TC)).astype(np.float32)
    tris[:, 9:, :] = 0
    rays = np.zeros((8, r), np.float32)
    rays[0:3] = rng.uniform(-2, 2, (3, r))
    dd = rng.normal(size=(3, r))
    rays[3:6] = dd / np.linalg.norm(dd, axis=0)
    rays[6] = 1e-4
    rays[7] = 1e9
    return rays, tris, amat_from_tris(tris)


def _visit(bt, bi, t, b1, b2, denom, min_t, max_t, late):
    """One visit's per-element test, in-cluster scan and epilogue on
    [TC, R] tensors; returns the new (best t, best index)."""
    ok = ((denom != 0) & (t >= min_t[None, :])
          & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
    if not late:
        ok = ok & (t <= torch.minimum(max_t, bt)[None, :])
    tm = torch.where(ok, t, INF)
    kmin = tm.amin(dim=0)
    iota = torch.arange(t.shape[0], device=t.device,
                        dtype=torch.float32)[:, None]
    kidx = torch.where(tm <= kmin[None, :], iota, INF).amin(dim=0)
    closer = kmin < bt
    if late:
        closer = closer & (kmin <= max_t)
    return torch.where(closer, kmin, bt), torch.where(closer, kidx, bi)


def _inv(denom):
    return torch.where(denom == 0, 0.0,
                       1.0 / torch.where(denom == 0, 1.0, denom))


def mt_vpu_plain(rays, tris, iters: int, late: bool = False):
    """The plain torch version of mt_vpu, whole [TC, R] planes per visit,
    every product and sum in the kernel's order."""
    o = [rays[k] for k in range(3)]
    d = [rays[3 + k] for k in range(3)]
    min_t, max_t = rays[6], rays[7]
    r = rays.shape[1]
    bt = torch.full((r,), INF, dtype=torch.float32, device=rays.device)
    bi = torch.full((r,), -1.0, dtype=torch.float32, device=rays.device)
    for i in range(iters):
        v = tris[i % NSLOT]
        e1 = [(v[3 + k] - v[k])[:, None] for k in range(3)]
        e2 = [(v[6 + k] - v[k])[:, None] for k in range(3)]
        s = [o[k][None, :] - v[k][:, None] for k in range(3)]
        s1 = [d[(k + 1) % 3][None, :] * e2[(k + 2) % 3]
              - d[(k + 2) % 3][None, :] * e2[(k + 1) % 3] for k in range(3)]
        s2 = [s[(k + 1) % 3] * e1[(k + 2) % 3]
              - s[(k + 2) % 3] * e1[(k + 1) % 3] for k in range(3)]
        denom = s1[0] * e1[0] + s1[1] * e1[1] + s1[2] * e1[2]
        inv = _inv(denom)
        t = (s2[0] * e2[0] + s2[1] * e2[1] + s2[2] * e2[2]) * inv
        b1 = (s1[0] * s[0] + s1[1] * s[1] + s1[2] * s[2]) * inv
        b2 = (s2[0] * d[0][None, :] + s2[1] * d[1][None, :]
              + s2[2] * d[2][None, :]) * inv
        bt, bi = _visit(bt, bi, t, b1, b2, denom, min_t, max_t, late)
    return torch.stack([bt, bi])


def _features(rays):
    """z [16, R]: o, d, o x d, 1, then six zeros (_mxu_kernel :104-108)."""
    o = [rays[k] for k in range(3)]
    d = [rays[3 + k] for k in range(3)]
    c = [o[(k + 1) % 3] * d[(k + 2) % 3] - o[(k + 2) % 3] * d[(k + 1) % 3]
         for k in range(3)]
    one = torch.ones_like(rays[0])
    zero = torch.zeros_like(rays[0])
    return torch.stack(o + d + c + [one] + [zero] * 6)


def mt_linear_plain(rays, amat, iters: int, late: bool = False,
                    reverse: bool = False):
    """The plain FP32 version of mt_linear, the reference its tensor-core
    kernel is held to (linear_gate): each row's 16 products summed left to
    right (right to left with reverse=True), an IEEE reciprocal.  It
    computes in the inputs' dtype."""
    z = _features(rays)
    min_t, max_t = rays[6], rays[7]
    r = rays.shape[1]
    bt = torch.full((r,), INF, dtype=rays.dtype, device=rays.device)
    bi = torch.full((r,), -1.0, dtype=rays.dtype, device=rays.device)
    order = range(N_FEAT)[::-1] if reverse else range(N_FEAT)
    for i in range(iters):
        a = amat[i % NSLOT]
        out = a[:, order[0], None] * z[order[0]][None, :]
        for q in order[1:]:
            out = out + a[:, q, None] * z[q][None, :]
        denom, t_num, b1_num, b2_num = out.view(4, TC, r).unbind(0)
        inv = _inv(denom)
        bt, bi = _visit(bt, bi, t_num * inv, b1_num * inv, b2_num * inv,
                        denom, min_t, max_t, late)
    return torch.stack([bt, bi])


# --- the tensor-core form's table and arithmetic ----------------------------

def tf32_split(x: torch.Tensor):
    """(hi, lo) f32: hi = x rounded to TF32 (10 mantissa bits, to nearest,
    ties away from zero: PTX cvt.rna.tf32.f32), lo = the same rounding of
    x - hi (exact).  hi + lo is x to within 2^-22 relative."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _mma_rows() -> torch.Tensor:
    """MMA_ROWS [4*TC]: row p of the permuted table is amat row
    MMA_ROWS[p].  p = 32 q + 16 m + 8 h + g holds numerator 2 m + h
    (denominator, t, b1, b2) of triangle 8 q + g."""
    p = torch.arange(4 * TC)
    q, m, h, g = p // 32, p // 16 % 2, p // 8 % 2, p % 8
    return (2 * m + h) * TC + 8 * q + g


MMA_ROWS = _mma_rows()


def mma_table(amat: torch.Tensor) -> torch.Tensor:
    """[NSLOT, 16, 2, 2, 2, 32, 4] f32: amat's rows permuted by MMA_ROWS,
    split by tf32_split, in mma.sync m16n8k8's A-fragment order: [slot,
    group q of 8 triangles, tile m, k-step kk, hi / lo, lane, register].
    Lane l = 4 g + c holds rows (g, g + 8) x columns (8 kk + c, 8 kk + c
    + 4) of tile (q, m), as registers (g, 8kk+c), (g+8, 8kk+c),
    (g, 8kk+c+4), (g+8, 8kk+c+4)."""
    tiles = amat[:, MMA_ROWS.to(amat.device)].reshape(NSLOT, 16, 2, 16,
                                                       N_FEAT)
    lane = torch.arange(32, device=amat.device)[:, None]
    reg = torch.arange(4, device=amat.device)[None, :]
    row = lane // 4 + 8 * (reg % 2)                       # [32, 4]
    col = lane % 4 + 4 * (reg // 2)                       # [32, 4]
    frag = torch.stack([tiles[:, :, :, row, 8 * kk + col] for kk in (0, 1)],
                       dim=3)                    # [S, 16, 2, 2, 32, 4]
    return torch.stack(tf32_split(frag), dim=4).contiguous()


def mt_linear_tf32_plain(rays, amat, iters: int, late: bool = False,
                         products: int = 3):
    """The tensor-core form's arithmetic in plain torch: z and amat split
    by tf32_split, each row's numerator the FP32 sum of the products
    a_lo z_hi, a_hi z_lo, a_hi z_hi (each exact in FP32: 11 by 11 bits),
    small terms first, feature by feature (the tensor cores' own order is
    unspecified).  products=1 keeps only a_hi z_hi: a single TF32 pass."""
    z_hi, z_lo = tf32_split(_features(rays))
    a_hi, a_lo = tf32_split(amat)
    pairs = (((a_lo, z_hi), (a_hi, z_lo)) if products == 3 else ()) + (
        (a_hi, z_hi),)
    min_t, max_t = rays[6], rays[7]
    r = rays.shape[1]
    bt = torch.full((r,), INF, dtype=torch.float32, device=rays.device)
    bi = torch.full((r,), -1.0, dtype=torch.float32, device=rays.device)
    for i in range(iters):
        out = torch.zeros((4 * TC, r), dtype=torch.float32, device=rays.device)
        for a, z in pairs:
            for q in range(N_FEAT):
                out = out + a[i % NSLOT][:, q, None] * z[q][None, :]
        denom, t_num, b1_num, b2_num = out.view(4, TC, r).unbind(0)
        inv = _inv(denom)
        bt, bi = _visit(bt, bi, t_num * inv, b1_num * inv, b2_num * inv,
                        denom, min_t, max_t, late)
    return torch.stack([bt, bi])


# --- the tensor-core form's gate ---------------------------------------------

GATE_AGREE = 0.999   # least share of rays whose winner equals the FP32 one's
GATE_RTOL = 1e-5
# Forward-error allowance of a numerator, in units of 2^-24 times the sum of
# its 16 terms' magnitudes: the tensor-core form adds 48 products (16 from
# each of three products; each split product within 3 units of a z), the
# FP32 form 16, each addition within one unit, doubled for an accumulator
# that truncates: 2 (48 + 3 + 16) <= 128.
GATE_ULPS = 128


def _fp32_candidates(rays, amat, idx, slots):
    """The FP32 test of triangle idx[n] of each slot in `slots` for the n
    rays of rays [8, n], summed as mt_linear_plain sums it: dict of
    [len(slots), n] tensors t, b1, b2 and their forward-error bounds e_t,
    e_b1, e_b2 (inf where the denominator's sign is not certain)."""
    z = _features(rays).t()                                     # [n, 16]
    rows = torch.stack([idx + k * TC for k in range(4)])        # [4, n]
    prod = amat[slots][:, rows] * z[None, None]                 # [S,4,n,16]
    num = prod[..., 0]
    for q in range(1, N_FEAT):
        num = num + prod[..., q]
    mag = prod.abs().sum(-1)
    den = num[:, 0]
    inv = _inv(den)
    t, b1, b2 = num[:, 1] * inv, num[:, 2] * inv, num[:, 3] * inv
    eps = GATE_ULPS * 2.0 ** -24
    ad = den.abs()
    sure = ad > eps * mag[:, 0]
    out = {"t": t, "b1": b1, "b2": b2}
    for key, val, k in (("e_t", t, 1), ("e_b1", b1, 2), ("e_b2", b2, 3)):
        e = eps * (mag[:, k] + val.abs() * mag[:, 0]) / ad
        out[key] = torch.where(sure, e, torch.inf)
    return out


def _pick(cand, target):
    """Each ray's candidate from the slot whose FP32 t is nearest target."""
    gap = (cand["t"] - target[None]).abs()
    s = torch.where(torch.isfinite(gap), gap, torch.inf).argmin(0)
    return {k: v.gather(0, s[None])[0] for k, v in cand.items()}


def _borderline(c, lo, hi):
    """Candidates passing the FP32 test within its error bounds but not
    clear of them: rounding can decide whether they are hits."""
    s = c["b1"] + c["b2"]
    e_s = c["e_b1"] + c["e_b2"]
    loose = ((c["b1"] >= -c["e_b1"]) & (c["b2"] >= -c["e_b2"])
             & (s <= 1 + e_s) & (c["t"] >= lo - c["e_t"])
             & (c["t"] <= hi + c["e_t"]))
    tight = ((c["b1"] >= c["e_b1"]) & (c["b2"] >= c["e_b2"])
             & (s <= 1 - e_s) & (c["t"] >= lo + c["e_t"])
             & (c["t"] <= hi - c["e_t"]))
    return loose & ~tight


def linear_gate(got, ref, rays, amat, iters: int) -> dict:
    """Hold the tensor-core form's out [2, R] (got) against the plain FP32
    version's (ref) on the same rays and amat:

      - a miss is exactly (INF, -1);
      - the winner's index equals ref's on at least GATE_AGREE of rays;
      - where both pick the same triangle, |t - t_ref| is within GATE_RTOL
        of t_ref or, where that triangle's quotient is ill-conditioned,
        within its forward-error bound (GATE_ULPS);
      - every ray where the indices differ is a flip rounding explains:
        got's t matches its triangle's FP32 t within those tolerances, and
        either both triangles' FP32 t are within them of each other (a
        near tie), or the triangle in front is one whose hit test lies
        within its bounds of an edge (a graze), or one side missed and the
        other's triangle is such a graze.

    Returns the counts, with "ok" True where every condition holds."""
    r = ref.shape[1]
    lo, hi = rays[6], rays[7]
    g_t, g_i, r_t, r_i = got[0], got[1], ref[0], ref[1]
    slots = list(range(min(iters, NSLOT)))
    rec = {"rays": r, "hits": int((r_i >= 0).sum())}
    miss_ok = bool(((g_i < 0) == (g_t == INF)).all()
                   and (g_i[g_i < 0] == -1).all())
    same = g_i == r_i
    rec["same_index"] = float(same.float().mean()) if r else 1.0

    def tol(c, t_ref):
        return torch.maximum(GATE_RTOL * t_ref.abs(), c["e_t"])

    both = same & (r_i >= 0)
    n_beyond, worst, t_rel = 0, 0.0, 0.0
    if bool(both.any()):
        sel = torch.nonzero(both).reshape(-1)
        c = _pick(_fp32_candidates(rays[:, sel], amat, r_i[sel].long(),
                                   slots), r_t[sel])
        dt = (g_t[sel] - r_t[sel]).abs()
        t_rel = float((dt / r_t[sel].abs()).max())
        n_beyond = int((dt > GATE_RTOL * r_t[sel].abs()).sum())
        worst = float((dt / tol(c, r_t[sel])).max())
    rec.update(t_max_rel=t_rel, t_beyond_rtol=n_beyond,
               t_worst_over_tol=worst)

    diff = torch.nonzero(~same).reshape(-1)
    kinds = {"near_tie": 0, "graze": 0, "unexplained": 0}
    if len(diff):
        rs = rays[:, diff]
        k_hit, p_hit = g_i[diff] >= 0, r_i[diff] >= 0
        ck = _pick(_fp32_candidates(rs, amat, g_i[diff].clamp(min=0).long(),
                                    slots), g_t[diff])
        cp = _pick(_fp32_candidates(rs, amat, r_i[diff].clamp(min=0).long(),
                                    slots), r_t[diff])
        consistent = (g_t[diff] - ck["t"]).abs() <= tol(ck, ck["t"])
        near = ((ck["t"] - cp["t"]).abs()
                <= torch.maximum(GATE_RTOL * cp["t"].abs(),
                                 ck["e_t"] + cp["e_t"]))
        bk, bp = (_borderline(c, lo[diff], hi[diff]) for c in (ck, cp))
        graze = torch.where(
            k_hit & p_hit,
            (bk & (ck["t"] < cp["t"])) | (bp & (cp["t"] < ck["t"])),
            torch.where(k_hit, bk, bp))
        tie = k_hit & p_hit & near
        ok = torch.where(k_hit, consistent, True) & (tie | graze)
        kinds = {"near_tie": int((ok & tie).sum()),
                 "graze": int((ok & ~tie).sum()),
                 "unexplained": int((~ok).sum())}
    rec.update(differ=len(diff), **kinds)
    rec["ok"] = (miss_ok and rec["same_index"] >= GATE_AGREE
                 and worst <= 1.0 and kinds["unexplained"] == 0)
    return rec


def rtol_witness(rays, amat, iters: int) -> dict:
    """How far evaluations of the linear form that differ only in rounding
    lie apart: mt_linear_plain against the same sums right to left in FP32
    ("fp32_reversed") and against all of it in float64 ("float64"), on the
    same rays and amat.  For each, the rays whose winner differs and the
    hits with the same winner whose t differs by more than GATE_RTOL."""
    ref = mt_linear_plain(rays, amat, iters)
    hits = ref[1] >= 0
    out = {"hits": int(hits.sum())}
    for name, other in (
            ("fp32_reversed", mt_linear_plain(rays, amat, iters,
                                              reverse=True)),
            ("float64", mt_linear_plain(rays.double(), amat.double(),
                                        iters).float())):
        same = other[1] == ref[1]
        both = same & hits
        dt = (other[0] - ref[0]).abs()[both]
        out[name] = {"differ": int((~same).sum()),
                     "t_beyond_rtol": int((dt > GATE_RTOL
                                           * ref[0][both].abs()).sum())}
    return out


# --- the wrappers -------------------------------------------------------------

def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _lib():
    """The loaded library with both entry points' ctypes signatures:
    mt_vpu(rays, tris, tri_rows, iters, late, out, n_rays, stream) and
    mt_linear(rays, table, iters, late, out, n_rays, stream), each ->
    cudaError_t."""
    lib = _build.load(_KERNEL)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mt_vpu.argtypes = [vp, vp, i32, i32, i32, vp, i32, vp]
    lib.mt_linear.argtypes = [vp, vp, i32, i32, vp, i32, vp]
    lib.mt_vpu.restype = lib.mt_linear.restype = ctypes.c_int
    return lib


# mt_linear's table, made once per amat (same tensor, unmodified)
_mma_table_of = last_of(lambda amat: (amat,), mma_table)


def _check(rays, table, shape_ok, what, iters):
    if rays.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"rays and {what} must be float32, got {rays.dtype}"
                        f" / {table.dtype}")
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be [8, R], got {tuple(rays.shape)}")
    if not shape_ok(tuple(table.shape)):
        raise ValueError(f"unexpected {what} shape {tuple(table.shape)}")
    if table.device != rays.device:
        raise ValueError(f"{what} is on {table.device}, rays on "
                         f"{rays.device}")
    if not 0 <= iters < 2 ** 31 or rays.shape[1] >= 2 ** 31 // 8:
        raise ValueError(f"iters {iters} or {rays.shape[1]} rays out of the "
                         "kernel's int32 range")


def _run(fn, rays, args, iters, late):
    rays = rays.contiguous()
    r = rays.shape[1]
    out = torch.empty((2, r), dtype=torch.float32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = fn(_ptr(rays), *args, int(iters), int(bool(late)), _ptr(out),
                 r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def mt_vpu(rays, tris, iters: int, late: bool = False):
    """Best (t, index) [2, R] over `iters` visits of the vertex table: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(rays, tris, lambda s: len(s) == 3 and s[0] == NSLOT
           and s[1] >= 9 and s[2] == TC, "tris", iters)
    if rays.device.type == "cpu":
        return mt_vpu_plain(rays, tris, iters, late)
    if not rays.is_cuda:
        raise NotImplementedError(f"no K3 kernel for {rays.device}")
    tris = tris.contiguous()
    out = _run(_lib().mt_vpu, rays, (_ptr(tris), tris.shape[1]), iters, late)
    mt_vpu.launches += 1
    return out


def mt_linear(rays, amat, iters: int, late: bool = False):
    """Best (t, index) [2, R] over `iters` visits of the linear-form table:
    the CUDA kernel (tensor cores, held by linear_gate) for CUDA tensors,
    the plain FP32 version for CPU tensors."""
    _check(rays, amat, lambda s: s == (NSLOT, 4 * TC, N_FEAT), "amat", iters)
    if rays.device.type == "cpu":
        return mt_linear_plain(rays, amat, iters, late)
    if not rays.is_cuda:
        raise NotImplementedError(f"no K3 kernel for {rays.device}")
    out = _run(_lib().mt_linear, rays, (_ptr(_mma_table_of(amat)),), iters,
               late)
    mt_linear.launches += 1
    return out


mt_vpu.launches = 0
mt_linear.launches = 0
