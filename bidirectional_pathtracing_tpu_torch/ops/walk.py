"""One step of a BDPT subpath walk as one hand-written CUDA kernel,
csrc/walk.cu: after the step's closest hit, the step's uniforms, the
geometry term, the p and alpha recurrences and the BSDF sample of the
lane's own material, written straight into the subpath, one thread a lane.

models/bdpt.py _prepare_subpath asks route(scene, device) which way its
steps go:

  - "kernel": the walk runs on CUDA and nothing needs a gradient
    (scene/types.py takes_kernels, the rule ops/connect.py route applies
    too); the eye, light and env emission walks all take it;
  - "chain" otherwise: _prepare_subpath's op chain, the kernel's CPU twin,
    and the only path autograd sees through.

buffers() allocates what a walk writes: the Subpath tensors slot by slot
[nv + 1, S, ...], the steps' directions and miss bits [nv - 1, S, ...],
the lane's sample (pdf, f) and two sets of rays (o, d, min_t, max_t) that
the steps fill in turns.  Slot by slot, a step's writes are coalesced
across lanes (csrc/walk.cu); models/bdpt.py hands on [S, nv + 1, ...]
views, and ops/connect.py reads the storage as it is.

step() launches the kernel once on the current stream, so a CUDA graph of
the pass captures it; step.launches counts its launches, and
utils/step_graph.py adds a captured pass's launches again at each replay,
as it does the hit kernels'.  It takes the hit of the step's
closest-hit launch, the ray it was launched with and, at step 0, the
walk's start, and returns the next step's ray.
"""

from __future__ import annotations

import ctypes

import torch

from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.scene.types import takes_kernels

_KERNEL = "walk"

# csrc/walk.cu Args, field for field
_POINTERS = ("keys", "hit_t", "hit_valid", "hit_n", "hit_mat", "o", "d",
             "v1_n", "v1_alpha", "v1_p", "dir_pdf", "mats", "pdf", "f",
             "next_o", "next_d", "next_min_t", "next_max_t", "pos", "n",
             "alpha", "p", "mat", "valid", "step_d", "step_miss")
_INTS = ("n_lanes", "nv", "step", "site", "adjoint", "n_mats")
# what the kernel writes, by the shapes buffers() gives them
_OUT = ("pdf", "f", "pos", "n", "alpha", "p", "mat", "valid", "step_d",
        "step_miss")


class Args(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int32) for k in _INTS])


def route(scene, device) -> str:
    """"kernel" or "chain": how a walk's steps run on `device`."""
    return "kernel" if takes_kernels(scene, device) else "chain"


def buffers(s: int, nv: int, device) -> dict:
    """The tensors a walk of s lanes and nv real vertices writes, empty:
    the Subpath's slot by slot (pos, n, alpha [nv + 1, S, 3]; p [nv + 1,
    S]; mat int32, valid bool), the steps' (step_d [nv - 1, S, 3],
    step_miss bool), the lane's sample (pdf [S], f [S, 3]) and the rays,
    rays[j] = (o, d, min_t, max_t), which step i writes into rays[i % 2]."""
    f32 = dict(dtype=torch.float32, device=device)

    def ray():
        return (torch.empty((s, 3), **f32), torch.empty((s, 3), **f32),
                torch.empty((s,), **f32), torch.empty((s,), **f32))

    return {"pos": torch.empty((nv + 1, s, 3), **f32),
            "n": torch.empty((nv + 1, s, 3), **f32),
            "alpha": torch.empty((nv + 1, s, 3), **f32),
            "p": torch.empty((nv + 1, s), **f32),
            "mat": torch.empty((nv + 1, s), dtype=torch.int32,
                               device=device),
            "valid": torch.empty((nv + 1, s), dtype=torch.bool,
                                 device=device),
            "step_d": torch.empty((nv - 1, s, 3), **f32),
            "step_miss": torch.empty((nv - 1, s), dtype=torch.bool,
                                     device=device),
            "pdf": torch.empty((s,), **f32),
            "f": torch.empty((s, 3), **f32),
            "rays": (ray(), ray())}


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def launch_args(mats, hit, buf: dict, i: int, o, d, start: dict, keys,
                site: int, adjoint: bool):
    """(Args, the tensors it points into): the kernel's arguments for step
    i of a walk over contiguous copies or views of the inputs.  mats: the
    scene's ops/bsdf.py rows; hit: the step's closest hit (ops/intersect.py
    Hit); buf: buffers(); o, d: the ray the hit was launched with; start:
    the walk's v1 normal "n", alpha "alpha", area pdf "p" and directional
    pdf "dir_pdf", read at step 0.  The returned tensors must outlive the
    launch."""
    s, nv = buf["pos"].shape[1], buf["pos"].shape[0] - 1
    if not 0 <= i <= nv - 2:
        raise ValueError(f"step {i} of a walk with {nv} vertices")
    nxt = buf["rays"][i % 2]
    t = {"keys": keys, "hit_t": hit.t, "hit_valid": hit.valid,
         "hit_n": hit.n, "hit_mat": hit.mat, "o": o, "d": d,
         "v1_n": start["n"], "v1_alpha": start["alpha"], "v1_p": start["p"],
         "dir_pdf": start["dir_pdf"], "mats": mats,
         "next_o": nxt[0], "next_d": nxt[1], "next_min_t": nxt[2],
         "next_max_t": nxt[3], **{k: buf[k] for k in _OUT}}
    want = {"keys": (torch.int64, (s, 2)), "hit_t": (torch.float32, (s,)),
            "hit_valid": (torch.bool, (s,)),
            "hit_n": (torch.float32, (s, 3)),
            "hit_mat": (torch.int32, (s,)), "o": (torch.float32, (s, 3)),
            "d": (torch.float32, (s, 3)), "v1_n": (torch.float32, (s, 3)),
            "v1_alpha": (torch.float32, (s, 3)),
            "v1_p": (torch.float32, (s,)), "dir_pdf": (torch.float32, (s,))}
    dev = buf["pos"].device
    for k, x in t.items():
        if x.requires_grad:
            raise RuntimeError(f"walk: {k} requires grad, but the kernel has "
                               "no backward: route() sends walks that need "
                               "a gradient to the op chain")
        if x.device != dev:
            raise ValueError(f"{k} is on {x.device}, the walk on {dev}")
        if k in want and (x.dtype, tuple(x.shape)) != want[k]:
            raise ValueError(f"{k} is {x.dtype} {tuple(x.shape)}, the walk "
                             f"takes {want[k][0]} {want[k][1]}")
        if k in _OUT and not x.is_contiguous():
            raise ValueError(f"{k} must be contiguous: the kernel writes it")
        t[k] = x.contiguous()
    args = Args(**{k: _ptr(t[k]) for k in _POINTERS}, n_lanes=s, nv=nv,
                step=i, site=site, adjoint=int(adjoint),
                n_mats=mats.shape[0])
    return args, t


def _kernel():
    """The C entry point, built on first use: (args, stream) ->
    cudaError_t."""
    if _kernel.fn is None:
        fn = _build.load(_KERNEL).walk_launch
        fn.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel.fn = fn
    return _kernel.fn


_kernel.fn = None


def step(mats, hit, buf: dict, i: int, o, d, start: dict, keys, site: int,
         adjoint: bool):
    """Step i of a walk on the card (launch_args's arguments): writes
    vertex slot i + 2 (slots 0 and 1 too at step 0), the step's direction
    and miss bit and the lane's sample, and returns the next step's ray
    (o, d, min_t, max_t), buf["rays"][i % 2]."""
    # `keep` holds the tensors the arguments point into past the launch
    args, keep = launch_args(mats, hit, buf, i, o, d, start, keys, site,
                             adjoint)
    dev = buf["pos"].device
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
    step.launches += 1
    return buf["rays"][i % 2]


step.launches = 0
