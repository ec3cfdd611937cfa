"""One render pass as a CUDA graph: the port's counterpart of the JAX
package's compiled render step.

The JAX package compiles a render chunk into one XLA program and
dispatches it once: `@jax.jit` on `_pt_step`, `_pt_step_chunk`,
`_bdpt_step` and `_bdpt_step_chunk` (its utils/render.py:91-169), the
passes of a chunk as a `lax.scan` with the pass key fold_in(key, base + i)
a traced value, and utils/aot.py `get_step` resolving the compiled step.
Here one pass of BDPT (models/bdpt.py sample_pass) or of the PT
(models/pathtracer.py sample_camera_rays + trace_radiance) is captured
once into a CUDA graph and replayed for every pass of a chunk:

  - The pass reads static buffers: the pass key, [2] int64 (rng.lane_keys
    reads it on the device), the pixel ids, BDPT's splat factor 1/spp and
    eye factor (float32 scalars: 1/spp, or 1 for parallel/render.py's
    ranks), and the PT's `active` mask.  It adds into static sums with the
    eager loop's arithmetic, in its order: eye += eye_i * eye factor
    (index_add_ at the pixel ids in cell mode), light += light_i, rays +=
    rays_i for BDPT; acc += where(active, L, 0), the luminance moments s1
    and s2, rays for the PT.  A float32 scalar tensor multiplies as the
    Python float it holds does, so the factors change no bit.
  - Pass.run(keys, pix, start, active, inv_spp, eye_scale) sets those
    inputs and the starting sums; then, for each row of the chunk's
    [chunk, 2] keys (rng.pass_keys: one upload a chunk), copies the row
    into the key buffer and replays, all on the current stream; and
    returns copies of the sums.
  - capture_cuda captures as PyTorch asks: warm-up passes on a side stream
    (they build the kernels, ops/_build.py, K1's host tables, the
    constants of core/math.py const and the allocator's blocks; run()
    overwrites what they add), then torch.cuda.graph capture in
    "thread_local" mode, so that another thread's CUDA calls (the viewer's
    HTTP threads, viewer.py) cannot break it, then instantiation.
    capture_s times all three; pool_bytes is the device memory that the
    graph's private pool reserved; nodes is the graph's node count.
  - Launch accounting: the kernel wrappers count their launches in
    Python (brute_hit.launches, clustered_hit.launches,
    bvh_walk.launches, connect.launches, and walk.step.launches under
    "walk"), which a replay does not run.
    The counts added during the capture are the pass's launches, added
    again on each replay; the counts as they were before the warm-up are
    restored after the capture.  So every count means what it means for
    the eager pass.  Each capture adds one to utils/tracing.py
    COUNTS[CAPTURES].
  - The cache holds at most CACHE_SIZE captured passes, keyed on the scene
    object and the static arguments, as the JAX package keys
    static_argnames; the config enters as static_cfg(cfg), without the
    fields the captured pass does not read (spp and the seed, which enter
    as buffers, the driver's and the output's; JAX utils/render.py
    _trace_cfg), so one capture serves every spp and seed.  The graph
    holds the addresses of every buffer it reads, so each cached pass
    holds them: the scene, strongly (a scene tensor modified in place
    captures anew), and the tables that the kernels' wrappers build from
    it outside the graph's pool and keep only for the last scene seen
    (ops/_memo.py: the walk kernel's, and K1's above its parameter cap),
    collected over the warm-up and capture.  The oldest pass is evicted
    first, its graph, pool and tables released.
  - No fallback: a capture or replay that fails raises.

route() says by rule which chunks are captured: none on the CPU; none
under disabled() (the port's jax.disable_jit(), the only way to the eager
pass on the card); none through an intersector other than DISPATCH (PLAIN
and SORTED wait on the host; a caller's own intersector may keep the rays
it is given); none where a scene tensor requires grad (the gradient path,
utils/gradcheck.py, calls sample_pass itself).  Every other chunk on the
card is replayed.  run_chunk is the chunk drivers' entry point
(utils/render.py, parallel/render.py).

GradStep is the counterpart of the JAX package's jitted training step
(examples/inverse_rendering.py:140-148 and :214-221: the forward, its
jax.value_and_grad and optax.adam's update in one dispatch): a loss over
static input buffers, its gradient by torch.autograd.grad in the
parameter leaves and an optional in-place update, captured into one CUDA
graph by capture_cuda and replayed for every step.  The warm-up step
applies an update that the capture only records, so the parameters and
the update's state are restored after the capture: the first replay is
the first step.  It holds the tables its capture read and counts the
capture's kernel launches on each replay, as a Pass does; grad_route() runs
it eagerly on the CPU and under disabled().  A step marks its start and
the ends of its loss, its gradient and its update on the device's step
ring (utils/tracing.py mark).

Under the profiler (utils/tracing.py) each replay of a Pass or GradStep
is a "step_graph.launch" span and each GradStep.run a "grad_step.run"
unit.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.core.math import const
from bidirectional_pathtracing_tpu_torch.models import bdpt
from bidirectional_pathtracing_tpu_torch.models import pathtracer as pt
from bidirectional_pathtracing_tpu_torch.ops import (
    _memo, connect, intersect_brute, intersect_bvh, intersect_clustered,
    walk)
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    DISPATCH, Intersector)
from bidirectional_pathtracing_tpu_torch.scene.types import (
    Scene, needs_grad, tensors)
from bidirectional_pathtracing_tpu_torch.utils import tracing

CACHE_SIZE = 2        # captured passes kept (each with its own pool)
WARMUP_PASSES = 1     # eager passes on a side stream before a capture
LUMINANCE = (0.2126, 0.7152, 0.0722)
# the kernels' wrappers, each counting its launches in `.launches`
KERNELS = {"brute_hit": intersect_brute.brute_hit,
           "clustered_hit": intersect_clustered.clustered_hit,
           "bvh_walk": intersect_bvh.bvh_walk,
           "connect": connect.connect,
           "walk": walk.step}

_disabled = 0
_cache: OrderedDict = OrderedDict()


@contextlib.contextmanager
def disabled():
    """Run every chunk eagerly, on the card too, as jax.disable_jit() runs
    the JAX step op by op."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def route(scene: Scene, pix, isect: Intersector = DISPATCH) -> str:
    """"graph" or "eager": how a chunk over the pixel ids pix runs."""
    if not pix.is_cuda or _disabled or isect is not DISPATCH:
        return "eager"
    if needs_grad(scene):
        return "eager"
    return "graph"


# --- launch accounting -----------------------------------------------------

def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    return {k: f.launches for k, f in KERNELS.items()}


def launches_since(before: dict) -> dict:
    """Each kernel's launches since launch_counts() returned `before`."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def _set_counts(counts: dict):
    for k, f in KERNELS.items():
        f.launches = counts[k]


def _add_counts(delta: dict):
    for k, f in KERNELS.items():
        f.launches += delta.get(k, 0)


# --- the pass over static buffers ------------------------------------------

class _Buffers:
    """The static inputs of one pass and the sums it adds into."""

    def __init__(self, integrator: str, cfg: RenderConfig, width: int,
                 height: int, pix):
        dev = pix.device
        n = pix.shape[0]
        self.key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.pix = torch.zeros_like(pix)
        self.active = None
        self.inv_spp = torch.ones((), device=dev)
        self.eye_scale = torch.ones((), device=dev)
        if integrator == "bdpt":
            rows = width * height if cfg.cell else n
            self.sums = {
                "eye": torch.zeros((rows, 3), device=dev),
                "light": torch.zeros((width * height, 3), device=dev),
                "rays": torch.zeros((), dtype=torch.int64, device=dev)}
        else:
            self.active = torch.ones((n,), dtype=torch.bool, device=dev)
            self.sums = {
                "acc": torch.zeros((n, 3), device=dev),
                "s1": torch.zeros((n,), device=dev),
                "s2": torch.zeros((n,), device=dev),
                "rays": torch.zeros((), dtype=torch.int64, device=dev)}


def _bdpt_body(scene, cfg, width, height, isect, b: _Buffers):
    eye_i, light_i, st = bdpt.sample_pass(
        scene, b.key, width, height, b.pix, cfg, return_stats=True,
        inv_ns_aa=b.inv_spp, isect=isect)
    if cfg.cell:        # the cell's ids are unique: a deterministic scatter
        b.sums["eye"].index_add_(0, b.pix, eye_i * b.eye_scale)
    else:
        b.sums["eye"].add_(eye_i * b.eye_scale)
    b.sums["light"].add_(light_i)   # splats already carry 1/ns_aa
    b.sums["rays"].add_(st["rays"])


def _pt_body(scene, cfg, width, height, isect, b: _Buffers):
    keys = rng.lane_keys(b.key, b.pix)
    o, d = pt.sample_camera_rays(scene, keys, width, height, b.pix, cfg)
    L, st = pt.trace_radiance(scene, o, d, keys, cfg, return_stats=True,
                              isect=isect)
    lum = torch.sum(L * const(LUMINANCE, L.dtype, L.device), dim=-1)
    act = b.active
    b.sums["acc"].add_(torch.where(act[:, None], L, 0.0))
    b.sums["s1"].add_(torch.where(act, lum, 0.0))
    b.sums["s2"].add_(torch.where(act, lum * lum, 0.0))
    b.sums["rays"].add_(st["rays"])


class Pass:
    """One pass over static buffers, run eagerly (replay runs the pass) or
    replayed from its captured CUDA graph, with what its capture cost."""

    def __init__(self, bufs: _Buffers, replay: Callable[[], None],
                 launches: Optional[dict] = None, graph=None,
                 scene: Optional[Scene] = None, versions=None,
                 capture_s: Optional[float] = None,
                 pool_bytes: Optional[int] = None,
                 nodes: Optional[int] = None, tables: tuple = ()):
        self.bufs = bufs
        self._replay = replay
        self.launches = launches or {}
        self.graph = graph
        self.scene = scene
        self.tables = tables     # the wrappers' tables that the graph reads
        self.versions = versions
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.nodes = nodes

    def replay(self):
        if self._replay is None:
            raise RuntimeError("this pass was evicted and released")
        with tracing.span("step_graph.launch"):
            self._replay()
            _add_counts(self.launches)

    def run(self, keys, pix, start: Optional[dict] = None, active=None,
            inv_spp: float = 1.0,
            eye_scale: Optional[float] = None) -> dict:
        """The passes of the [n, 2] int64 keys over the pixel ids pix,
        added to `start` (a dict of starting sums; zeros where absent),
        BDPT's splats scaled by inv_spp and its eye radiance by eye_scale
        (inv_spp where None), the PT's lanes masked by `active` (all lanes
        where None): copies of the sums."""
        b = self.bufs
        b.pix.copy_(pix)
        b.inv_spp.fill_(inv_spp)
        b.eye_scale.fill_(inv_spp if eye_scale is None else eye_scale)
        if b.active is not None:
            if active is None:
                b.active.fill_(True)
            else:
                b.active.copy_(active)
        for name, s in b.sums.items():
            if start is not None and name in start:
                s.copy_(start[name])
            else:
                s.zero_()
        for i in range(keys.shape[0]):
            b.key.copy_(keys[i])
            self.replay()
        return {name: s.clone() for name, s in b.sums.items()}

    def release(self):
        """Drops the graph, its pool and what it reads."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._replay = self.scene = None
        self.tables = ()


def _body(scene, cfg, width, height, isect, integrator, b):
    if integrator == "bdpt":
        return lambda: _bdpt_body(scene, cfg, width, height, isect, b)
    if integrator == "pt":
        return lambda: _pt_body(scene, cfg, width, height, isect, b)
    raise ValueError(f"unknown integrator {integrator!r}")


def static_cfg(cfg: RenderConfig) -> RenderConfig:
    """cfg with the fields that the captured pass does not read set to
    fixed values (JAX utils/render.py _trace_cfg): spp (1/spp is an input
    buffer), the seed (it enters through the keys), the driver's
    chunking, adaptive sampling and output fields."""
    return dataclasses.replace(
        cfg, spp=1, seed=0, output="", save_rate_image=False,
        save_eye_light_images=False, samples_per_chunk=0,
        samples_per_batch=32, max_tolerance=0.05, adaptive_sampling=False,
        envmap_path="")


def eager_pass(scene: Scene, cfg: RenderConfig, width: int, height: int,
               pix, isect: Intersector = DISPATCH,
               integrator: Optional[str] = None) -> Pass:
    """The pass over fresh static buffers, run eagerly (integrator:
    cfg.integrator unless given)."""
    integrator = integrator or cfg.integrator
    cfg = static_cfg(cfg)
    b = _Buffers(integrator, cfg, width, height, pix)
    return Pass(b, _body(scene, cfg, width, height, isect, integrator, b))


# --- capture ----------------------------------------------------------------

class Captured(NamedTuple):
    """What a capturer returns: the replay, the kernel launches it makes,
    the graph and what the capture cost."""

    replay: Callable[[], None]
    launches: dict
    graph: object = None
    capture_s: float = 0.0
    pool_bytes: int = 0
    nodes: Optional[int] = None


def _count_nodes(graph) -> int:
    """The node count of a graph captured with keep_graph=True."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return int(n.value)


def capture_cuda(body: Callable[[], None], device) -> Captured:
    """WARMUP_PASSES calls of body on a side stream, then one captured into
    a CUDA graph and instantiated.  The device's mark rings
    (utils/tracing.py ring) are made before the warm-up."""
    t0 = time.perf_counter()
    tracing.ring(device)
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                body()
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
        launches = launches_since(before)
        nodes = _count_nodes(graph)
        graph.instantiate()
        torch.cuda.synchronize(device)
        pool = torch.cuda.memory_reserved(device) - reserved
    return Captured(graph.replay, launches, graph,
                    time.perf_counter() - t0, pool, nodes)


# --- the cache --------------------------------------------------------------

def _evict(key):
    p = _cache.pop(key)
    cuda = p.bufs.key.is_cuda
    p.release()
    if cuda:
        torch.cuda.empty_cache()


def clear():
    """Evicts every captured pass."""
    while _cache:
        _evict(next(iter(_cache)))


def cached() -> list:
    """The cached passes, oldest first."""
    return list(_cache.values())


def graphed_pass(scene: Scene, cfg: RenderConfig, width: int, height: int,
                 pix, isect: Intersector = DISPATCH,
                 integrator: Optional[str] = None, capture=None) -> Pass:
    """The captured pass of these arguments (integrator: cfg.integrator
    unless given) from the cache, or captured now by `capture`
    (capture_cuda unless given), the oldest cached pass evicted first when
    the cache is full.  The pixel ids' values, spp and the seed are inputs
    of run(), not of the capture."""
    integrator = integrator or cfg.integrator
    cfg = static_cfg(cfg)
    key = (id(scene), cfg, width, height, integrator,
           tuple(pix.shape), pix.dtype, str(pix.device), isect)
    versions = tuple(t._version for t in tensors(scene))
    p = _cache.get(key)
    if p is not None and p.versions == versions:
        _cache.move_to_end(key)
        return p
    if p is not None:
        _evict(key)
    while len(_cache) >= CACHE_SIZE:
        _evict(next(iter(_cache)))
    b = _Buffers(integrator, cfg, width, height, pix)
    b.pix.copy_(pix)                # the warm-up renders these pixels
    body = _body(scene, cfg, width, height, isect, integrator, b)
    counts = launch_counts()
    try:
        with _memo.holding() as tables:
            cap = (capture or capture_cuda)(body, pix.device)
    finally:
        _set_counts(counts)
    tracing.count(tracing.CAPTURES)
    p = Pass(b, cap.replay, cap.launches, cap.graph, scene, versions,
             cap.capture_s, cap.pool_bytes, cap.nodes,
             tuple(tables.values()))
    _cache[key] = p
    return p


def grad_route(params) -> str:
    """"graph" or "eager": how a GradStep over the parameter leaves params
    runs (eager on the CPU and under disabled())."""
    if _disabled or not all(p.is_cuda for p in params):
        return "eager"
    return "graph"


class GradStep:
    """One training step over static buffers: loss_fn(*params, *inputs),
    its gradient in params and update(grads), run eagerly or replayed from
    the CUDA graph that the first run() captures (capture_cuda).

    params: leaf tensors that require grad, read in place by every step.
    inputs: tensors of the shapes and dtypes of run()'s arguments (the
    pass key, a [2] int64 tensor, core/rng.py pass_keys; a target image).
    update(grads), if given, changes params and the tensors of `state` (a
    nested tuple such as the Adam state) in place; it runs under no_grad.
    The graph owns every tensor a step writes: the gradients come from
    torch.autograd.grad inside it, the loss (and, with no update, the
    gradients) are copied into buffers made here, and params and state are
    the caller's, made before the capture.  route: grad_route(params)
    when the step is made."""

    def __init__(self, loss_fn: Callable, params, inputs,
                 update: Optional[Callable] = None, state=()):
        self.loss_fn = loss_fn
        self.params = tuple(params)
        self.inputs = tuple(torch.empty_like(x) for x in inputs)
        self.update = update
        self.state = tuple(tensors(state))
        self.loss = torch.zeros((), device=self.params[0].device)
        self.grads = (() if update is not None else
                      tuple(torch.zeros_like(p) for p in self.params))
        self.route = grad_route(self.params)
        self._replay = self._body if self.route == "eager" else None
        self.launches: dict = {}
        self.graph = None
        self.tables: tuple = ()
        self.capture_s = self.pool_bytes = self.nodes = None

    def _body(self):
        dev = self.loss.device
        tracing.mark(tracing.STEP, 0, dev)
        with torch.enable_grad():
            loss = self.loss_fn(*self.params, *self.inputs)
            tracing.mark(tracing.STEP, 1, dev)
            grads = torch.autograd.grad(loss, self.params)
        tracing.mark(tracing.STEP, 2, dev)
        with torch.no_grad():
            self.loss.copy_(loss)
            for buf, g in zip(self.grads, grads):
                buf.copy_(g)
            if self.update is not None:
                self.update(grads)
        tracing.mark(tracing.STEP, 3, dev)

    def _capture(self):
        written = self.params + self.state
        with torch.no_grad():
            saved = [t.clone() for t in written]
        counts = launch_counts()
        try:
            with _memo.holding() as tables:
                cap = capture_cuda(self._body, self.params[0].device)
        finally:
            _set_counts(counts)
            with torch.no_grad():   # undo the warm-up step's update
                for t, s in zip(written, saved):
                    t.copy_(s)
        tracing.count(tracing.CAPTURES)
        self._replay, self.launches, self.graph = (cap.replay, cap.launches,
                                                   cap.graph)
        self.capture_s, self.pool_bytes, self.nodes = (
            cap.capture_s, cap.pool_bytes, cap.nodes)
        self.tables = tuple(tables.values())

    def replay(self):
        """One step on the inputs already in the buffers (the first call
        on the graph route captures)."""
        if self._replay is None:
            if self.route != "graph":
                raise RuntimeError("this step was released")
            self._capture()
        with tracing.span("step_graph.launch"):
            self._replay()
            _add_counts(self.launches)

    @tracing.spanned("grad_step.run")
    def run(self, *inputs):
        """One step on these inputs: the loss as a 0-d device tensor, and
        with no update (loss, gradients), copies of the step's buffers."""
        for buf, x in zip(self.inputs, inputs, strict=True):
            buf.copy_(x)
        self.replay()
        if self.update is not None:
            return self.loss.clone()
        return self.loss.clone(), tuple(g.clone() for g in self.grads)

    def release(self):
        """Drops the graph, its pool and the tables it reads."""
        if self.graph is not None:
            self.graph.reset()
            torch.cuda.empty_cache()
        self.graph = None
        self.tables = ()
        self.route = "released"
        self._replay = None


def run_chunk(scene: Scene, cfg: RenderConfig, width: int, height: int,
              pix, keys, isect: Intersector = DISPATCH,
              integrator: Optional[str] = None, start: Optional[dict] = None,
              active=None, eye_scale: Optional[float] = None) -> dict:
    """The passes of the [n, 2] keys, replayed or eager by route(), at
    cfg.spp: a dict of the sums (Pass.run)."""
    if route(scene, pix, isect) == "graph":
        p = graphed_pass(scene, cfg, width, height, pix, isect, integrator)
    else:
        p = eager_pass(scene, cfg, width, height, pix, isect, integrator)
    return p.run(keys, pix, start, active, 1.0 / cfg.spp, eye_scale)
