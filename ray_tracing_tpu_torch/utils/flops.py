"""FLOP accounting of the estimator, and the card's measured peaks.

Counterpart of ``ray_tracing_tpu/utils/flops.py``. The megakernels are FP32
work outside the tensor cores (intersection and shading arithmetic, no
matrix products), so the roofline that matters is the FP32 FMA rate, not the
tensor cores' headline rate, which only matrix products reach.

Instruments, all reported by the port's bench (``ray_tracing_tpu_torch/bench.py``):

* the census: ``physics_cost_per_pixel``, ``fetch_vjp_cost_per_pixel`` and
  ``replay_vjp_cost_per_pixel`` count the float operations of the plain
  PyTorch estimator (``kernels/megakernel.py::tile_physics``) per
  pixel-sample, by walking the aten operations it dispatches (a
  ``TorchDispatchMode``) at the prices of the JAX package's jaxpr census: a
  counted number, not a hand estimate. Transcendentals are also reported
  apart, as there. The plain estimator runs every lane through every
  bounce in lockstep, and the census prices all of it; the CUDA kernels
  skip the lanes whose path has ended, so the census is far more than the
  work they execute and a census rate over a peak is no utilization;
* ``prng_flops_per_pixel``: the float work of turning random bits into
  uniforms and directions, counted by formula (the draws are inputs of the
  census);
* ``measured_vpu_peak``: the FP32 FMA rate the card reaches, timed through
  the CUDA kernel ``kernels/csrc/peak_fma.cu`` (K6). The bench reports
  the census rate as a share of this measured peak;
* ``measured_mxu_peak``: the bf16 tensor-core rate of a chain of
  ``torch.matmul`` products. No kernel of the port runs on tensor cores; the
  number says what that ceiling is.
"""

from __future__ import annotations

import collections
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.kernels.peak import peak_fma
from ray_tracing_tpu_torch.ops.intersect import _single_emissive_index
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE
from ray_tracing_tpu_torch.utils.timing import materialize, timed_marginal

# ---------------------------------------------------------------------------
# Census of the aten operations the plain estimator dispatches
# ---------------------------------------------------------------------------
#
# Prices of the JAX package's census (its XLA-style per-op prices): one per
# output element for arithmetic, comparisons and bit logic; two for a select;
# one plus one transcendental for a square root and the other transcendental
# functions; an integer power costs its multiplications; a reduction costs
# its input's size; a matrix product 2*M*N*K. Views, copies, casts,
# concatenations, gathers, scatters and indexing cost nothing. Where an aten
# op and a JAX primitive differ in kind, the price follows what the op
# computes: a clamp with both bounds is a max and a min (2), with one bound
# a max or a min (1), as jnp.clip's lowering prices them.

_FLOPS_1 = {
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "maximum", "minimum",
    "fmax", "fmin", "clamp_min", "clamp_max", "neg", "abs", "sign", "sgn", "floor",
    "ceil", "round", "trunc", "reciprocal", "square", "eq", "ne", "lt", "le", "gt",
    "ge", "isfinite", "isinf", "isnan", "nextafter", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or", "logical_xor",
    "logical_not",
}
_SELECTS = {"where"}
_TRANSC = {
    "sqrt", "rsqrt", "exp", "exp2", "log", "log2", "log1p", "expm1", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "sigmoid",
    "erf", "erfc", "erfinv",
}
_REDUCES = {
    "sum", "prod", "amax", "amin", "any", "all", "argmax", "argmin", "cumsum",
    "cumprod", "mean", "max", "min",
}
_MATMUL = {"mm", "bmm", "addmm", "dot", "mv"}


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (tuple, list)):
        return next((t.numel() for t in x if isinstance(t, torch.Tensor)), 0)
    return 0


def _int_pow_mults(y: int) -> int:
    """Multiplications of x**y by repeated squaring (XLA's integer_pow)."""
    y = abs(int(y))
    return max(y.bit_length() + bin(y).count("1") - 2, 1) if y > 1 else 1


def op_cost(func, args, kwargs, out) -> tuple[str, float, float]:
    """(name, flops, transcendentals) of one aten call at the census's
    prices."""
    name = func.overloadpacket.__name__.rstrip("_")
    overload = func._overloadname
    n_out = _numel(out)
    if name in ("max", "min") and overload == "other":
        return name, float(n_out), 0.0  # elementwise, not a reduction
    if name in _FLOPS_1:
        return name, float(n_out), 0.0
    if name in _SELECTS:
        return name, 2.0 * n_out, 0.0
    if name == "clamp":
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        return name, float(n_out * ((lo is not None) + (hi is not None))), 0.0
    if name == "pow":
        y = args[1] if len(args) > 1 else None
        if overload == "Tensor_Scalar" and float(y) == int(y):
            return name, float(_int_pow_mults(int(y)) * n_out), 0.0
        return name, float(n_out), float(n_out)
    if name in _TRANSC:
        return name, float(n_out), float(n_out)
    if name in _REDUCES:
        return name, float(_numel(args[0])), 0.0
    if name in _MATMUL:
        a = args[1] if name == "addmm" else args[0]
        return name, 2.0 * n_out * a.shape[-1], 0.0
    return name, 0.0, 0.0


class FlopCensus(TorchDispatchMode):
    """Counts, while active, the float operations of every aten call at
    op_cost's prices: totals and a histogram by op name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, f, t = op_cost(func, args, kwargs, out)
        if f:
            self.flops += f
            self.transcendentals += t
            self.by_op[name] += f
        return out

    def per_pixel(self, pixels: int) -> dict:
        return {"flops_per_px": self.flops / pixels,
                "transcendentals_per_px": self.transcendentals / pixels,
                "ops": {k: v / pixels for k, v in sorted(self.by_op.items())}}


class _FixedDraws:
    """Draw provider with constant planes, so that the census counts only the
    physics (draw generation is counted by prng_flops_per_pixel)."""

    def __init__(self, ns: int, shape):
        def vec(s):
            return Vec3(torch.zeros(s), torch.zeros(s), torch.ones(s))

        self._shadow = vec((ns, *shape))
        self._dir = vec(shape)
        self._branch = torch.full(shape, 0.5)

    def shadow(self, b):
        return self._shadow

    def direction(self, b):
        return self._dir

    def branch(self, b):
        return self._branch


def _tile_uv(tile):
    """Screen coordinates of a (th, tw) tile, the JAX census's formula; the
    caller counts their arithmetic, as the JAX census does."""
    th, tw = tile
    xs = torch.arange(tw, dtype=torch.float32).broadcast_to(tile)
    ys = torch.arange(th, dtype=torch.float32)[:, None].broadcast_to(tile)
    return 1.0 - xs / (tw - 1), 1.0 - ys / (th - 1)


def _topology(scene):
    """(obj_type, light_index, emissive, rows on the CPU) of a port Scene."""
    return (tuple(scene.obj_type), int(scene.light_index),
            getattr(scene, "emissive", None), scene.packed_rows().detach().cpu())


@functools.lru_cache(maxsize=16)
def _physics_cost_cached(obj_type, light_index, emissive, config, tile):
    n = len(obj_type)
    draws = _FixedDraws(config.shadow_samples if light_index >= 0 else 0, tile)
    rows = torch.zeros((n, 16))
    cam = torch.zeros((16,))
    with torch.no_grad(), FlopCensus() as census:
        u, v = _tile_uv(tile)
        view = mk.SceneView(rows, obj_type, light_index, emissive)
        mk.tile_physics(view, cam, u, v, draws, config, tile)
    return census.per_pixel(tile[0] * tile[1])


def physics_cost_per_pixel(scene, config: RenderConfig, tile=(8, 128)) -> dict:
    """Counted cost of one pixel-sample of tile_physics for this scene's
    topology: {"flops_per_px", "transcendentals_per_px", "ops": the flops per
    pixel by aten op}. Cached by topology, as the JAX census is."""
    obj_type, light_index, emissive, _ = _topology(scene)
    cost = _physics_cost_cached(obj_type, light_index, emissive, config, tuple(tile))
    return {**cost, "ops": dict(cost["ops"])}


def fetch_vjp_cost_per_pixel(scene, config: RenderConfig, tile=(8, 128)) -> dict:
    """Counted cost of the fetch backward's differentiable part: the replay
    of tile_physics over a FetchReplayTracer (from winner indices recorded
    on this scene) and its VJP by autograd, against all-one cotangents:
    what the fetch backward kernel (K3) executes. The recording forward is
    not counted (the indices are the forward kernel's residuals). The port
    fetches a winner's row by indexing, so this count holds no matrix
    products: it is the JAX count less fetch_mxu_flops_per_pixel."""
    obj_type, li, emissive, rows = _topology(scene)
    ns = config.shadow_samples if li >= 0 else 0
    draws = _FixedDraws(ns, tile)
    u, v = _tile_uv(tile)
    cam = torch.zeros((16,))
    view = mk.SceneView(rows, obj_type, li, emissive)
    recorder = mk.IndexRecordingTracer(view)
    with torch.no_grad():
        mk.tile_physics(view, cam, u, v, draws, config, tile, tracer=recorder)

    rows = rows.clone().requires_grad_(True)
    cam = cam.clone().requires_grad_(True)
    with torch.enable_grad(), FlopCensus() as census:
        tracer = mk.FetchReplayTracer(recorder.objs, rows, obj_type, li, emissive=emissive)
        planes = torch.stack(mk.tile_physics(None, cam, u, v, draws, config, tile, tracer=tracer))
        torch.autograd.grad(planes, [rows, cam], torch.ones_like(planes), allow_unused=True)
    return census.per_pixel(tile[0] * tile[1])


def replay_vjp_cost_per_pixel(scene, config: RenderConfig, tile=(8, 128)) -> dict:
    """Counted cost of the replay backward's differentiable part: the replay
    of tile_physics over a ReplayTracer (records of a RecordingTracer pass
    on this scene) and its VJP with respect to the records, the camera pack
    and the light's geometry, against all-one cotangents: what the replay
    backward kernel (K4) executes after its recording pass. The recording
    pass costs physics_cost_per_pixel on top; routing the record gradients
    to rows (route_record_grads, an index_add_) costs no float operation
    here and is counted by routing_mxu_flops_per_pixel in the JAX
    package's matrix form."""
    obj_type, li, emissive, rows = _topology(scene)
    has_light = li >= 0
    ns = config.shadow_samples if has_light else 0
    draws = _FixedDraws(ns, tile)
    u, v = _tile_uv(tile)
    view = mk.SceneView(rows, obj_type, li, emissive)
    recorder = mk.RecordingTracer(view)
    with torch.no_grad():
        mk.tile_physics(view, torch.zeros((16,)), u, v, draws, config, tile, tracer=recorder)

    leaves, records = [], []
    for rec in recorder.records:
        lv = [t.clone().requires_grad_(True) for t in mk._record_planes(rec)[1]]
        leaves += lv
        records.append(mk._with_planes(rec, lv))
    cam = torch.zeros((16,), requires_grad=True)
    light = [rows[li, k].clone().requires_grad_(True) for k in range(6)] if has_light else []
    geom = (Vec3(*light[0:3]), Vec3(*light[3:6])) if has_light else None
    with torch.enable_grad(), FlopCensus() as census:
        tracer = mk.ReplayTracer(records, has_light, geom,
                                 has_light and obj_type[li] == OBJ_SPHERE)
        planes = torch.stack(mk.tile_physics(None, cam, u, v, draws, config, tile, tracer=tracer))
        torch.autograd.grad(planes, leaves + [cam] + light, torch.ones_like(planes),
                            allow_unused=True)
    return census.per_pixel(tile[0] * tile[1])


def prng_flops_per_pixel(config: RenderConfig, has_light: bool) -> float:
    """Float work of the draws per pixel-sample, by formula (the JAX
    package's): per uniform plane a shift, a cast and a scale (3); per random
    direction (cube-biased) 3 uniforms (9), 3 fused multiply-adds (6) and a
    normalize (dot 5, reciprocal square root 1, scale 3); per bounce one
    direction and one branch uniform, plus shadow_samples directions when
    the scene has a light. The port's Philox rounds are integer work and
    count 0, as every integer operation does in the census."""
    per_dir = 9 + 6 + 9
    per_branch = 3
    ns = config.shadow_samples if has_light else 0
    return config.bounces * ((1 + ns) * per_dir + per_branch)


def routing_mxu_flops_per_pixel(scene, config: RenderConfig) -> float:
    """The JAX cost model of the replay backward's routing: one-hot matrix
    products (N,P)x(16,P) per record, 2*N*16 flops per pixel, times 6
    passes for precision=HIGHEST. The port routes by index (index_add_ in
    the plain version, shared-memory sums in the kernels) and runs no
    one-hot product; the formula is kept so that the two packages' models
    can be compared."""
    n = scene.num_objects
    ns = config.shadow_samples if scene.has_light else 0
    n_records = config.bounces * (1 + ns)
    return n_records * 2.0 * n * 16 * 6


def fetch_mxu_flops_per_pixel(scene, config: RenderConfig, passes: int = 1) -> float:
    """The JAX cost model of the fetch backward's one-hot matrix products per
    pixel: a primary fetch (N,P)x(16,P) per bounce, and per shadow sample the
    3 emission columns from one row when the single-light occlusion path
    applies, else from all N. The port fetches a winner's row by index and
    runs no one-hot product, so its fetch census equals the JAX census less
    this count (passes=1, XLA's price of a dot at any precision)."""
    n = scene.num_objects
    b = config.bounces
    mxu = b * 2.0 * n * 16
    if scene.has_light:
        rows = 1 if _single_emissive_index(scene) is not None else n
        mxu += b * config.shadow_samples * 2.0 * rows * 3
    return mxu * passes


def rays_per_sample(width: int, height: int, config: RenderConfig) -> int:
    """The bench's ray accounting: bounces x (1 + shadow_samples) traces per
    pixel-sample. A cost model, not a trace count: scenes without a light
    (scene_2) cast no shadow rays, which is why the census counts flops,
    not rays."""
    return width * height * config.bounces * (1 + config.shadow_samples)


# ---------------------------------------------------------------------------
# Measured peaks
# ---------------------------------------------------------------------------

_PEAK_TILE = (8, 128)  # rows of 128 elements per grid step, as in the JAX kernel


def measured_vpu_peak(grid: int = 512, iters: int = 16384, device=None) -> dict:
    """FP32 FLOP/s of FMA chains on the card, through the CUDA kernel K6
    (kernels/peak.py::peak_fma) on a (grid*8, 128) input.

    Per-call time is utils/timing.py::timed_marginal's window difference
    (distinct inputs, one host read per window); per-ITERATION time is the
    difference between an `iters` and a `2*iters` launch, which cancels the
    launch's own overhead and the sum that consumes its output.

    Returns {"flops_per_s", "ratio", "seconds"}: ratio is the second
    difference (t(4N)-t(2N)) / (t(2N)-t(N)), which must be about 2 when
    doubling the iterations doubles the marginal time. A ratio far from 2
    means the timing did not see the work: the result must not be trusted,
    and the caller gates on it. "seconds" are the three per-call times.

    The kernel runs on the card only: device must be a CUDA device
    (device=None means the card); there is no plain-version timing."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the FMA peak is measured on the card, not on {device}")
    th, tw = _PEAK_TILE
    rows = torch.arange(grid * th, dtype=torch.int32, device=device).to(torch.float32)
    base = (rows[:, None] * 1e-6 + 0.25).expand(grid * th, tw).contiguous()

    def make_args(i):
        a = base * (1.0 + 1e-6 * i)
        torch.cuda.synchronize(device)
        return (a,)

    def build(n_iters):
        return lambda a: peak_fma(a, n_iters).sum()

    runs = [build(m * iters) for m in (1, 2, 4)]
    for q, r in enumerate(runs):
        materialize(r(*make_args(-1 - q)))  # built, loaded, warm
    t_1, t_2, t_4 = (timed_marginal(r, make_args, repeats=3) for r in runs)

    elems = grid * th * tw
    marginal_flops = 2.0 * 8 * elems * iters  # (2N - N) iterations
    return {
        "flops_per_s": marginal_flops / max(t_2 - t_1, 1e-12),
        "ratio": (t_4 - t_2) / max(t_2 - t_1, 1e-12),
        "seconds": [t_1, t_2, t_4],
    }


def measured_mxu_peak(n: int = 4096, iters: int = 64, device=None) -> dict:
    """bf16 FLOP/s of the tensor cores: a chain x <- x @ a of torch.matmul
    products of (n, n) bf16 matrices (fp32 accumulation inside, bf16
    result), data-dependent so that nothing folds. Same double-marginal
    method and second-difference `ratio` as measured_vpu_peak. At n=4096
    one product is 137 GFLOP, about 0.2 ms, so the chains of 64/128/256
    products are long against the host's launches. The scale of `a` keeps
    the chain inside bf16's range; the tensor cores' speed does not depend
    on the values. Returns {"flops_per_s", "ratio", "seconds"}. Card only."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the tensor-core peak is measured on the card, not on {device}")
    gen = torch.Generator(device=device).manual_seed(7)
    a = (torch.randn((n, n), generator=gen, device=device) / (2.2 * n ** 0.5)).to(torch.bfloat16)
    x_base = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)

    def make_args(i):
        x = x_base * (1.0 + 1e-3 * (i % 7))
        torch.cuda.synchronize(device)
        return (x, a)

    def build(n_iters):
        def run(x, a):
            for _ in range(n_iters):
                x = torch.matmul(x, a)
            return x.float().sum()
        return run

    runs = [build(m * iters) for m in (1, 2, 4)]
    for q, r in enumerate(runs):
        materialize(r(*make_args(-1 - q)))
    t_1, t_2, t_4 = (timed_marginal(r, make_args, repeats=3) for r in runs)

    marginal_flops = 2.0 * n ** 3 * iters
    return {
        "flops_per_s": marginal_flops / max(t_2 - t_1, 1e-12),
        "ratio": (t_4 - t_2) / max(t_2 - t_1, 1e-12),
        "seconds": [t_1, t_2, t_4],
    }
