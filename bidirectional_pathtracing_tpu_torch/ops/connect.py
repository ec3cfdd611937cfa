"""The BDPT connections of a pass as one hand-written CUDA kernel,
csrc/connect.cu: the MIS tables, every (i_eye, i_light) combo's estimate
and its weight, one thread a lane.

models/bdpt.py sample_pass asks route(scene, nv, device) which way its
connections go:

  - "kernel": the pass runs on CUDA, its subpaths have at most
    MAX_VERTICES real vertices, and nothing needs a gradient (grad mode is
    off, or no scene tensor requires grad): scene/types.py takes_kernels,
    which ops/walk.py route asks too;
  - "chain" otherwise: sample_pass's op chain (_mis_tables,
    _estimate_radiance, _mis_weight), the kernel's CPU twin, and the only
    path autograd sees through.

connect() launches the kernel once on the current stream, so a CUDA graph
of the pass captures it; connect.launches counts its launches, and
utils/step_graph.py adds a captured pass's launch again at each replay,
as it does the hit kernels'.  The depth cap is checked by route() and by
the C entry point, which returns an error for nv outside 1..kMaxV.  It
takes what the op chain's estimates take, unchanged: the two Subpaths,
the t=1 fresh light samples, the one shadow batch's blocked mask, and
the scene's material, light and camera tables, packed on the device with
torch ops (no host copy, so a capture records them too).  It adds the
combos' radiance into eye_L in place and returns the camera splats of
the i_eye = 1 combos in the op chain's order, for _splat.
"""

from __future__ import annotations

import ctypes

import torch

from bidirectional_pathtracing_tpu_torch.ops import _build, bsdf
from bidirectional_pathtracing_tpu_torch.ops import camera_ops
from bidirectional_pathtracing_tpu_torch.scene.types import takes_kernels

_KERNEL = "connect"
MAX_VERTICES = 8      # csrc/connect.cu kMaxV: max_ray_depth 7

# csrc/connect.cu Args, field for field
_POINTERS = ("e_pos", "e_n", "e_alpha", "e_mat", "e_valid",
             "l_pos", "l_n", "l_alpha", "l_p", "l_mat", "l_valid",
             "l_dir_pdf", "f_pos", "f_n", "f_alpha", "f_p", "f_dir_pdf",
             "f_valid", "blocked", "mats", "lights", "cam", "inv_ns_aa",
             "eye_l", "splat_flat", "splat_val")
_INTS = ("n_lanes", "nv", "width", "height", "n_mats", "n_lights",
         "has_light", "consistent_camera", "t1_reference")
_FRESH = ("pos", "n", "alpha", "p", "dir_pdf", "valid")


class Args(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int32) for k in _INTS])


def route(scene, nv: int, device) -> str:
    """"kernel" or "chain": how a pass's connections run on `device` with
    nv real vertices a subpath."""
    if nv > MAX_VERTICES or not takes_kernels(scene, device):
        return "chain"
    return "kernel"


def _scene_tables(scene):
    """(materials [M, 24], lights [L, 12], camera [14]) float32 on the
    scene's device, in csrc/connect.cu's row layouts: ops/bsdf.py rows;
    kind, radiance, position, direction, area, a pad; c2w row by row, the
    position and the tangents of the half fields of view as camera_ops
    computes them."""
    li, cam = scene.lights, scene.camera

    def col(x):
        return x.to(torch.float32)[:, None]

    lights = torch.cat([col(li.kind), li.radiance, li.position,
                        li.direction, col(li.area),
                        torch.zeros_like(col(li.area))], dim=1)
    camera = torch.cat([cam.c2w.reshape(9), cam.pos,
                        camera_ops._tan_half(cam.hfov).reshape(1),
                        camera_ops._tan_half(cam.vfov).reshape(1)])
    return (bsdf.rows(scene.materials),
            lights.to(torch.float32).contiguous(),
            camera.to(torch.float32).contiguous())


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


def launch_args(scene, eye, light, fresh, blocked, eye_L, width: int,
                height: int, consistent_camera: bool, t1_reference: bool,
                inv_ns_aa):
    """(Args, the tensors it points into, (flat, values)): the kernel's
    arguments over contiguous copies or views of the inputs, the Subpath
    tensors slot by slot ([nv + 1, S, ...]: a view of the walk kernel's,
    ops/walk.py, a copy of the op chain's), and the splat outputs it writes
    (None without a light subpath).  The returned tensors must outlive the
    launch."""
    s, nv = eye.pos.shape[0], eye.pos.shape[1] - 1
    dev = eye.pos.device
    if eye_L.dtype != torch.float32 or eye_L.shape != (s, 3) \
            or not eye_L.is_contiguous():
        raise ValueError("eye_L must be a contiguous float32 [S, 3] tensor")
    mats, lights, cam = _scene_tables(scene)
    if not isinstance(inv_ns_aa, torch.Tensor):
        inv_ns_aa = torch.full((), inv_ns_aa, dtype=torch.float32,
                               device=dev)

    def slots(x):      # [S, nv + 1, ...] -> [nv + 1, S, ...]
        return x.transpose(0, 1)

    t = {"e_pos": slots(eye.pos), "e_n": slots(eye.n),
         "e_alpha": slots(eye.alpha), "e_mat": slots(eye.mat),
         "e_valid": slots(eye.valid), "mats": mats, "lights": lights,
         "cam": cam, "inv_ns_aa": inv_ns_aa, "eye_l": eye_L}
    splats = None
    if light is not None:
        t.update(l_pos=slots(light.pos), l_n=slots(light.n),
                 l_alpha=slots(light.alpha), l_p=slots(light.p),
                 l_mat=slots(light.mat), l_valid=slots(light.valid),
                 l_dir_pdf=light.dir_pdf, blocked=blocked)
        for k in _FRESH:
            t["f_" + k] = torch.stack([fresh[i][k] for i in range(1, nv + 1)])
        splats = (torch.empty((nv, s), dtype=torch.int64, device=dev),
                  torch.empty((nv, s, 3), dtype=torch.float32, device=dev))
        t["splat_flat"], t["splat_val"] = splats
    for k, x in t.items():
        if x.requires_grad:
            raise RuntimeError(f"connect: {k} requires grad, but the kernel "
                               "has no backward: route() sends passes that "
                               "need a gradient to the op chain")
        if x.device != dev:
            raise ValueError(f"{k} is on {x.device}, the subpaths on {dev}")
        t[k] = x if k == "eye_l" else x.contiguous()
    args = Args(**{k: _ptr(t.get(k)) for k in _POINTERS},
                n_lanes=s, nv=nv, width=width, height=height,
                n_mats=mats.shape[0], n_lights=lights.shape[0],
                has_light=int(light is not None),
                consistent_camera=int(consistent_camera),
                t1_reference=int(t1_reference))
    return args, t, splats


def _kernel():
    """The C entry point, built on first use: (args, stream) ->
    cudaError_t."""
    if _kernel.fn is None:
        lib = _build.load(_KERNEL)
        if lib.connect_max_vertices() != MAX_VERTICES:
            raise RuntimeError("csrc/connect.cu kMaxV is not MAX_VERTICES")
        fn = lib.connect_launch
        fn.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel.fn = fn
    return _kernel.fn


_kernel.fn = None


def connect(scene, eye, light, fresh, blocked, eye_L, width: int,
            height: int, cfg, inv_ns_aa):
    """The connections of one pass on the card: adds every i_eye >= 2
    combo's radiance into eye_L [S, 3] (in place) and returns the i_eye = 1
    combos' splats (flat pixel ids [nv * S] int64, values [nv * S, 3]), or
    None without a light subpath.

    eye, light: the walks' Subpaths (light None without lights); fresh:
    the t=1 fresh light samples by eye index (models/bdpt.py
    _fresh_light_point); blocked: the shadow batch's [nv * nv, S] mask in
    the op chain's segment order; inv_ns_aa: the splat factor, a float or
    a 0-d device tensor (read at each replay of a graph)."""
    # `keep` holds the tensors the arguments point into past the launch
    args, keep, splats = launch_args(
        scene, eye, light, fresh, blocked, eye_L, width, height,
        cfg.bdpt_consistent_camera, cfg.bdpt_reference_t1_mis, inv_ns_aa)
    dev = eye.pos.device
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"connect kernel launch failed: CUDA error {err}")
    connect.launches += 1
    if splats is None:
        return None
    flat, vals = splats
    return flat.reshape(-1), vals.reshape(-1, 3)


connect.launches = 0
