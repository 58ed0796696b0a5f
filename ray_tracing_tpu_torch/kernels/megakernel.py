"""The megakernels of the port: their plain PyTorch versions, the wrappers
of the CUDA kernels, the autograd boundary and the renderer built on them.

Counterpart of ``ray_tracing_tpu/kernels/megakernel.py``. Where each piece of
that file went:

    JAX package (kernels/megakernel.py)        here
    ------------------------------------------ ---------------------------
    SceneView                     :121-189     SceneView
    _uniform, StreamingDraws      :197-243     ops/sampling.py (PhiloxDraws:
                                               same shadow/direction/branch
                                               contract, slots not a stream)
    camera_rays_from_pack         :290-305     camera_rays_from_pack
    DirectTracer                  :308-324     DirectTracer
    RecordingTracer               :327-344     RecordingTracer
    IndexRecordingTracer          :347-368     IndexRecordingTracer
    FetchReplayTracer             :370-413     FetchReplayTracer
    ReplayTracer                  :416-445     ReplayTracer
    tile_physics                  :448-541     tile_physics
    _tile_uv                      :544-563     _tile_uv
    _seed_tile                    :566-571     none (draws are keyed by
                                               pixel and slot)
    _fwd_kernel                   :579-616     csrc/megakernel_fwd.cu and
                                               run_tiles_plain
    _bwd_kernel ("direct")        :625-676     csrc/megakernel_bwd_retrace.cu
                                               (TracedWinners) and
                                               run_bwd_direct_plain
    _route_record_grads[_chunked] :696-815     route_record_grads (index_add_;
                                               the one-hot matmul and its
                                               chunks are TPU VMEM tactics)
    _bwd_kernel_replay            :818-913     csrc/megakernel_bwd_retrace.cu
                                               (RecordedWinners) and
                                               run_bwd_replay_plain
    _bwd_kernel_fetch             :916-981     csrc/megakernel_bwd.cu and
                                               run_bwd_plain
    effective_bwd_mode            :1006-1045   effective_bwd_mode
    _record_layout                :1057-1075   record_layout
    _run_fwd                      :1078-1111   _launch_fwd
    _run_bwd                      :1114-1191   backward_kernel, _launch_bwd,
                                               run_bwd
    _make_core                    :1194-1232   TilesFunction
    _camera_pack                  :1240-1255   render/camera.py camera_pack
    render_tiles_pallas           :1258-1316   render_tiles_cuda
    render_image_pallas           :1319-1492   render_image_cuda, render_frame

Order of the winner-index planes (record_layout), as in the JAX package: for
each bounce one primary plane, then, when next-event estimation runs, one
plane per shadow sample: plane ``b*(1+ns)`` is bounce b's closest hit, plane
``b*(1+ns)+1+s`` its shadow sample s; -1 is a miss. Without a light (or with
``shadow_samples == 0``) there are ``bounces`` planes. Dead lanes: the
primary entry of a bounce the path did not enter alive is -1, and every
shadow entry of a bounce whose primary entry is -1 (the bounce where the path
left the scene and every bounce after it) is -1 too (``dead_lane_rule``);
those shadow rays would start from a point no path uses, and no backward
reads them. Rejected shadow samples of live bounces keep their traced
winners, as the JAX package's recorder has them.

``tile_physics`` + ``_tile_uv`` + ``PhiloxDraws`` are the plain version of
the forward CUDA kernel. The plain versions of the three backward kernels
are ``tile_physics`` differentiated by autograd over three tracers:

    "fetch"  (K3)  FetchReplayTracer on the forward's index planes
                   (run_bwd_plain)
    "replay" (K4)  RecordingTracer pass, then ReplayTracer on its parameter
                   planes, routed by route_record_grads (run_bwd_replay_plain)
    "direct" (K5)  DirectTracer on the scene table itself
                   (run_bwd_direct_plain)

The wrappers (``run_tiles``, ``run_bwd``) take a plain version only for
tensors that lie on the CPU; on CUDA tensors they launch the kernel or raise.

Gradients: ``render_image_cuda`` of a scene or camera whose leaves require
grad is differentiable end to end. ``TilesFunction`` is the boundary: in
"fetch" its forward is the recording kernel and its backward replays each
path from the recorded winner indices; in "replay" and "direct" its forward
is the plain forward kernel, it keeps no index planes, and its backward
traces the paths again. ``backward_kernel`` says which kernel runs. Which
object a ray hits and every other comparison are detached, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels import build
from ray_tracing_tpu_torch.ops.cubemap import (
    SPARSE_BLOCK,
    CubemapData,
    constant_sky,
    gather_texels,
    sample_cubemap,
    sparse_sky_lookup,
    texel_flat_index,
    unpack_texels,
)
from ray_tracing_tpu_torch.ops.intersect import (
    UNROLL_LIMIT,
    TraceRecord,
    _single_emissive_index,
    trace,
    trace_record,
    trace_replay,
    trace_replay_fetch,
    trace_shadow,
    trace_shadow_record,
    trace_shadow_replay,
    trace_shadow_replay_fetch,
)
from ray_tracing_tpu_torch.ops.sampling import PhiloxDraws, global_pixel_index
from ray_tracing_tpu_torch.ops.vec import Vec3, div_scalar, fresnel_schlick
from ray_tracing_tpu_torch.render.camera import Camera, camera_pack, pixel_grid
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, SCENE_COLS, Scene, light_origin_from
from ray_tracing_tpu_torch.utils.profiling import span

PLANE_NAMES = ("r", "g", "b", "sx", "sy", "sz", "cr", "cg", "cb", "miss")
KERNEL_LIBRARY = "megakernel_fwd"
BWD_KERNEL_LIBRARY = "megakernel_bwd"
RETRACE_KERNEL_LIBRARY = "megakernel_bwd_retrace"

# The backward kernels: (library, C entry point), by backward_kernel's name.
BWD_KERNELS = {
    "fetch": (BWD_KERNEL_LIBRARY, "rt_megakernel_bwd"),
    "replay": (RETRACE_KERNEL_LIBRARY, "rt_megakernel_bwd_replay"),
    "direct": (RETRACE_KERNEL_LIBRARY, "rt_megakernel_bwd_direct"),
}

# How often each kernel was launched: one count per kernel (the forward's two
# template instantiations count apart), raised where the launch happens and
# nowhere else. run_tiles and run_bwd open a span "kernel.<key>" around each
# call, so that a trace groups a kernel by the span that launched it.
launch_counts = {"megakernel_fwd": 0, "megakernel_fwd_record": 0,
                 **{"megakernel_bwd_" + k: 0 for k in BWD_KERNELS}}

# Device memory the winner-index planes of one differentiated frame may take
# (spp * n_rec * H * W * 4 bytes are alive until backward()): two fifths of
# an 80 GB card. A module constant so that tests can shrink it.
FETCH_RECORD_BUDGET_BYTES = 32e9


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class SceneView:
    """Scene accessors over a packed (N,16) table, with the static topology
    carried alongside: what trace()/trace_shadow() read, from the very rows
    the CUDA kernel reads."""

    def __init__(self, rows, obj_type, light_index, emissive=None):
        self._r = rows
        self.obj_type = tuple(obj_type)
        self.light_index = light_index
        self.emissive = emissive

    @property
    def num_objects(self):
        return len(self.obj_type)

    @property
    def has_light(self):
        return self.light_index >= 0

    def is_sphere(self, i):
        return self.obj_type[i] == OBJ_SPHERE

    def center(self, i):
        return Vec3(self._r[i, 0], self._r[i, 1], self._r[i, 2])

    def radius(self, i):
        return self._r[i, 3]

    def box_lo(self, i):
        return self.center(i)

    def box_hi(self, i):
        r = self._r
        return Vec3(r[i, 0] + r[i, 3], r[i, 1] + r[i, 4], r[i, 2] + r[i, 5])

    def size_of(self, i):
        return Vec3(self._r[i, 3], self._r[i, 4], self._r[i, 5])

    def albedo_of(self, i):
        return Vec3(self._r[i, 6], self._r[i, 7], self._r[i, 8])

    def roughness_of(self, i):
        return self._r[i, 9]

    def reflectance_of(self, i):
        return self._r[i, 10]

    def metallic_of(self, i):
        return self._r[i, 11]

    def emission_of(self, i):
        return Vec3(self._r[i, 12], self._r[i, 13], self._r[i, 14])

    def origin_of(self, i):
        return light_origin_from(self.center(i), self.size_of(i), self.is_sphere(i))

    def packed_rows(self):
        return self._r


# ---------------------------------------------------------------------------
# Tile physics: the estimator in plain PyTorch
# ---------------------------------------------------------------------------


def camera_rays_from_pack(cam, u, v, shape):
    """cam: the 16-float camera pack -> (ro, rd) for screen (u, v)."""
    ub = Vec3(cam[3], cam[4], cam[5])
    vb = Vec3(cam[6], cam[7], cam[8])
    w = Vec3(cam[9], cam[10], cam[11])
    cu = (u - 0.5) * cam[12]
    cv = (v - 0.5) * cam[13]
    rd = Vec3(
        cu * ub.x + cv * vb.x - w.x,
        cu * ub.y + cv * vb.y - w.y,
        cu * ub.z + cv * vb.z - w.z,
    )
    ro = Vec3(cam[0], cam[1], cam[2]).broadcast_to(shape)
    return ro, rd


class DirectTracer:
    """Closest hit against the live scene. tile_physics goes through a
    tracer so that a recorder can stand in."""

    def __init__(self, scene):
        self.scene = scene
        self.has_light = scene.has_light

    def trace(self, ro, rd):
        return trace(self.scene, ro, rd)

    def trace_shadow(self, ro, rd):
        return trace_shadow(self.scene, ro, rd)

    def light_origin(self):
        return self.scene.origin_of(self.scene.light_index)


class IndexRecordingTracer(DirectTracer):
    """Appends each trace call's winner-index plane, in call order, to
    `objs`: per bounce the primary (H,W) plane, then the (ns,H,W) shadow
    volume."""

    def __init__(self, scene):
        super().__init__(scene)
        self.objs = []

    def trace(self, ro, rd):
        h = trace(self.scene, ro, rd)
        self.objs.append(h.obj)
        return h

    def trace_shadow(self, ro, rd):
        out, rec = trace_shadow_record(self.scene, ro, rd)
        self.objs.append(rec.obj)
        return out


class RecordingTracer(DirectTracer):
    """Pass 1 of the "replay" backward: the closest-hit trace against the
    scene, keeping each call's TraceRecord / ShadowRecord in call order in
    `records`."""

    def __init__(self, scene):
        super().__init__(scene)
        self.records = []

    def trace(self, ro, rd):
        h, rec = trace_record(self.scene, ro, rd)
        self.records.append(rec)
        return h

    def trace_shadow(self, ro, rd):
        out, rec = trace_shadow_record(self.scene, ro, rd)
        self.records.append(rec)
        return out


class FetchReplayTracer:
    """The backward pass's tracer: no loop over the objects. Pops the
    recorded winner-index planes in tile_physics's call order and rebuilds
    each Hit from the winner's row of the DIFFERENTIABLE scene table `rows`
    (ops/intersect.py::trace_replay_fetch), so autograd routes every
    cotangent to that row."""

    def __init__(self, objs, rows, obj_type, light_index, emissive=None):
        self._objs = list(objs)
        self._i = 0
        self._rows = rows
        self._obj_type = obj_type
        self._light_index = light_index
        self.has_light = light_index >= 0
        self.emissive = emissive
        # The single-light occlusion trace records only {that light, -1};
        # trace_shadow_record keys on the same helper. Not light_index:
        # a hand-made `emissive` need not agree with it.
        self._shadow_li = _single_emissive_index(self)

    def _next(self):
        o = self._objs[self._i]
        self._i += 1
        return o

    def trace(self, ro, rd):
        return trace_replay_fetch(self._rows, self._next(), ro, rd)

    def trace_shadow(self, ro, rd):
        del ro, rd  # occlusion is detached; the emission comes from the fetch
        return trace_shadow_replay_fetch(self._rows, self._next(),
                                         light_index=self._shadow_li)

    def light_origin(self):
        li = self._light_index
        r = self._rows
        return light_origin_from(
            Vec3(r[li, 0], r[li, 1], r[li, 2]),
            Vec3(r[li, 3], r[li, 4], r[li, 5]),
            self._obj_type[li] == OBJ_SPHERE,
        )


class ReplayTracer:
    """Pass 2 of the "replay" backward: no loop over the objects. Pops the
    records in tile_physics's call order and rebuilds each hit from them
    (trace_replay, trace_shadow_replay). The light's geometry comes in as
    explicit leaves (p0, p1) so that its origin stays differentiable."""

    def __init__(self, records, has_light, light_geom=None, light_is_sphere=False):
        self._records = list(records)
        self._i = 0
        self.has_light = has_light
        self._light_geom = light_geom
        self._light_is_sphere = light_is_sphere

    def _next(self):
        rec = self._records[self._i]
        self._i += 1
        return rec

    def trace(self, ro, rd):
        return trace_replay(self._next(), ro, rd)

    def trace_shadow(self, ro, rd):
        del ro, rd  # occlusion is detached; the emission is the record's leaf
        return trace_shadow_replay(self._next())

    def light_origin(self):
        p0, p1 = self._light_geom
        return light_origin_from(p0, p1, self._light_is_sphere)


def tile_physics(scene, cam, u, v, draws, config: RenderConfig, shape,
                 tracer=None):
    """The whole per-pixel estimator over one tile. Returns 10 planes:
    (r, g, b, sky_x, sky_y, sky_z, skc_r, skc_g, skc_b, miss_f32).

    `draws` provides shadow(b) [Vec3 of (ns, *shape), asked for only when
    the tracer has a light], direction(b) [Vec3 of shape] and branch(b)
    [uniforms of shape]."""
    if tracer is None:
        tracer = DirectTracer(scene)
    dev = u.device
    ro, rd = camera_rays_from_pack(cam, u, v, shape)

    zero3 = Vec3.zeros(shape, device=dev)
    contrib = Vec3.full(shape, 1.0, device=dev)
    result = zero3
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    sky_dir = Vec3.full(shape, 1.0, device=dev)
    sky_contrib = zero3
    died_miss = torch.zeros(shape, dtype=torch.bool, device=dev)

    has_light = tracer.has_light
    if has_light:
        light_origin = tracer.light_origin()

    for b in range(config.bounces):
        d = rd.normalize()
        h = tracer.trace(ro, rd)

        # miss: remember direction + throughput for the deferred sky lookup
        miss_now = alive & ~h.hit
        sky_dir = Vec3.where(miss_now, d, sky_dir)
        sky_contrib = Vec3.where(miss_now, contrib, sky_contrib)
        died_miss = died_miss | miss_now
        active = alive & h.hit

        # next-event light sampling
        if has_light:
            rand_dirs = draws.shadow(b)  # Vec3 of (ns, *shape)
            accept = rand_dirs.dot(h.normal) > 0
            to_light = light_origin - h.point
            sample_dir = (rand_dirs * config.shadow_spread + to_light).normalize()
            sample_ro = h.point + sample_dir * config.hit_offset
            hit2, emit2 = tracer.trace_shadow(sample_ro, sample_dir)
            take = accept & hit2
            shadow_sum = Vec3(
                torch.where(take, emit2.x, 0.0).sum(dim=0),
                torch.where(take, emit2.y, 0.0).sum(dim=0),
                torch.where(take, emit2.z, 0.0).sum(dim=0),
            )
            num = accept.to(torch.float32).sum(dim=0)
            # the mean divides by the number ACCEPTED, not by the hits
            sampled_light = shadow_sum * (1.0 / torch.clamp(num, min=1.0))
        else:
            sampled_light = zero3

        # Fresnel with the RAW incoming direction
        NoV = torch.clamp(h.normal.dot(-rd), 0.0, 1.0)
        f0_d = 0.16 * h.reflectance * h.reflectance
        one_minus_m = 1.0 - h.metallic
        f0 = Vec3(
            f0_d * one_minus_m + h.albedo.x * h.metallic,
            f0_d * one_minus_m + h.albedo.y * h.metallic,
            f0_d * one_minus_m + h.albedo.z * h.metallic,
        )
        F = fresnel_schlick(NoV, f0)

        rand_dir = draws.direction(b)
        rand_dir = Vec3.where(rand_dir.dot(h.normal) < 0, -rand_dir, rand_dir)

        # emission with the throughput from BEFORE the branch
        result = result + Vec3.where(active, h.emission * contrib, zero3)

        u_branch = draws.branch(b)
        specular = (h.metallic > 0.001) | (u_branch <= F.avg())
        reflect_dir = rd.reflect(h.normal)
        out_spec = (rand_dir * h.roughness + reflect_dir).normalize()
        out_dir = Vec3.where(specular, out_spec, rand_dir)
        contrib_new = Vec3.where(specular, contrib, contrib * h.albedo * one_minus_m)

        light_on = active & ~sampled_light.is_zero()
        result = result + Vec3.where(
            light_on, sampled_light * contrib_new * config.light_sample_weight, zero3
        )
        contrib_new = Vec3.where(
            light_on, contrib_new * (1.0 - config.light_sample_weight), contrib_new
        )

        ro = Vec3.where(active, h.point + out_dir * config.hit_offset, ro)
        rd = Vec3.where(active, out_dir, rd)
        contrib = Vec3.where(active, contrib_new, contrib)
        alive = active

    return (
        result.x, result.y, result.z,
        sky_dir.x, sky_dir.y, sky_dir.z,
        sky_contrib.x, sky_contrib.y, sky_contrib.z,
        died_miss.to(torch.float32),
    )


def _tile_uv(width, height, norm_height, row0, device):
    """(u, v) of every pixel of a `height`-row slice whose first row is
    global row `row0` of a `norm_height`-tall frame: pixel_grid's formula,
    u = 1 - x/max(W-1,1), v = 1 - (y+row0)/max(norm_height-1,1) in float32."""
    u, v = pixel_grid(width, height, row0, norm_height, device=device)
    return u.contiguous(), v.contiguous()


def record_layout(config: RenderConfig, has_light: bool) -> int:
    """Number of winner-index planes of one sample; their order is in the
    module docstring. Contract of their entries: an entry holds the winner
    of its trace call (-1: nothing hit), except on dead lanes. The primary
    entry of a bounce the path did not enter alive is -1; each shadow entry
    of a bounce whose primary entry is -1 is -1 as well (dead_lane_rule),
    whatever its ray would hit. The recording kernel stops tracing where the
    path dies and writes these entries directly."""
    ns = config.shadow_samples if has_light else 0
    return config.bounces * (1 + ns)


def dead_lane_rule(records, ns: int):
    """The (n_rec,H,W) index planes with the dead-lane contract of
    record_layout applied: every shadow entry of a bounce whose primary
    entry is -1 becomes -1. Depends on the primary planes only, so any
    holder of the records can apply it; returns a new tensor."""
    if ns == 0:
        return records
    per_bounce = records.reshape(-1, 1 + ns, *records.shape[1:])
    dead = per_bounce[:, :1] < 0
    shadow = torch.where(dead, torch.full_like(per_bounce[:, 1:], -1), per_bounce[:, 1:])
    return torch.cat([per_bounce[:, :1], shadow], dim=1).reshape(records.shape)


# ---------------------------------------------------------------------------
# One sample over the frame: the kernel's wrapper and its plain version
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileJob:
    """What one frame's launches share: the packed scene, the camera pack,
    the static topology and the geometry of the frame."""

    rows: torch.Tensor       # (N,16) float32
    cam_pack: torch.Tensor   # (16,) float32
    obj_type: tuple
    light_index: int         # -1 when next-event estimation is off
    emissive: tuple | None
    config: RenderConfig
    width: int
    height: int
    norm_height: int

    @property
    def ns(self) -> int:
        return self.config.shadow_samples if self.light_index >= 0 else 0

    @property
    def single_emissive(self) -> int:
        li = _single_emissive_index(self)
        return -1 if li is None else li

    @property
    def n_spheres(self) -> int:
        """Objects of the sphere kind: how the kernels' trace table splits
        the scene (csrc/rt_device.cuh, TraceTable)."""
        return sum(t == OBJ_SPHERE for t in self.obj_type)


def make_tile_job(scene: Scene, camera: Camera, width: int, height: int,
                  config: RenderConfig = DEFAULT_CONFIG,
                  norm_height: int | None = None,
                  aspect: float | None = None) -> TileJob:
    if norm_height is None:
        norm_height = height
    if aspect is None:
        aspect = width / norm_height
    if camera.device != scene.device:
        raise ValueError(f"scene on {scene.device} but camera on {camera.device}")
    # shadow_samples == 0 is next-event estimation off: the no-light path
    light_index = scene.light_index if config.shadow_samples > 0 else -1
    return TileJob(
        rows=scene.packed_rows(),
        cam_pack=camera_pack(camera, aspect, config),
        obj_type=scene.obj_type,
        light_index=light_index,
        emissive=getattr(scene, "emissive", None),
        config=config,
        width=width,
        height=height,
        norm_height=norm_height,
    )


def _wrap_i32(x: int) -> int:
    """Python int -> the int32 it wraps to."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _sample_inputs(job: TileJob, seed: int, row0: int):
    """(u, v, draws) of one sample over the job's frame: the screen
    coordinates, jitter included, and the draw provider. The forward and the
    backward plain versions both start here, so they see the same numbers."""
    cfg = job.config
    dev = job.rows.device
    u, v = _tile_uv(job.width, job.height, job.norm_height, row0, dev)
    gpix = global_pixel_index(job.width, job.height, row0, device=dev)
    draws = PhiloxDraws(_wrap_i32(seed), gpix, cfg, job.ns)
    if cfg.pixel_jitter:
        ju, jv = draws.jitter()
        u = u + div_scalar(ju - 0.5, float(max(job.width - 1, 1)))
        v = v + div_scalar(jv - 0.5, float(max(job.norm_height - 1, 1)))
    return u, v, draws


def run_tiles_plain(job: TileJob, seed: int, row0: int = 0, record: bool = False):
    """The plain PyTorch version of the forward CUDA kernel, on whatever
    device the job's tensors lie: (planes (10,H,W) float32, records
    (n_rec,H,W) int32 or None). The records are the tracer's with the
    dead-lane rule applied (dead_lane_rule), as the kernel writes them."""
    shape = (job.height, job.width)
    u, v, draws = _sample_inputs(job, seed, row0)
    view = SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tracer = IndexRecordingTracer(view) if record else DirectTracer(view)
    outs = tile_physics(view, job.cam_pack, u, v, draws, job.config, shape, tracer=tracer)
    planes = torch.stack(outs)
    if not record:
        return planes, None
    recs = torch.cat([o.reshape(-1, *shape) for o in tracer.objs]).to(torch.int32)
    return planes, dead_lane_rule(recs, job.ns)


def _load(library: str, function: str, argtypes):
    lib = build.load_library(library)
    fn = getattr(lib, function)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


_SCALAR_ARGS = [ctypes.c_int] * 13 + [ctypes.c_float] * 4 + [ctypes.c_void_p]


def _kernel_function():
    return _load(KERNEL_LIBRARY, "rt_megakernel_fwd", [ctypes.c_void_p] * 4 + _SCALAR_ARGS)


def _bwd_kernel_function(kernel: str):
    """The loaded C entry point of a backward kernel (BWD_KERNELS); all
    three take the same arguments."""
    library, entry = BWD_KERNELS[kernel]
    return _load(library, entry, [ctypes.c_void_p] * 7 + _SCALAR_ARGS)


def _check_tensor(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_job(job: TileJob):
    dev = job.rows.device
    _check_tensor("scene rows", job.rows, (len(job.obj_type), SCENE_COLS), torch.float32, dev)
    _check_tensor("camera pack", job.cam_pack, (16,), torch.float32, dev)
    if job.width < 1 or job.height < 1:
        raise ValueError(f"empty frame {job.width}x{job.height}")


def _scalar_args(job: TileJob, seed: int, row0: int):
    """The arguments every kernel takes after its pointers (Params of
    csrc/rt_device.cuh, then the stream)."""
    cfg = job.config
    return (
        len(job.obj_type), job.n_spheres, job.width, job.height, job.norm_height, int(row0),
        _wrap_i32(seed),
        job.light_index, job.single_emissive, cfg.bounces, job.ns,
        int(cfg.cube_biased_sampling), int(cfg.pixel_jitter),
        cfg.shadow_spread, cfg.light_sample_weight,
        1.0 - cfg.light_sample_weight, cfg.hit_offset,
        torch.cuda.current_stream(job.rows.device).cuda_stream,
    )


def _raise_on(err: int, lib, what: str):
    if err != 0:
        text = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {text} (cudaError {err})")


def _launch_fwd(job: TileJob, seed: int, row0: int, record: bool):
    """Launch the forward CUDA kernel on PyTorch's current stream. Does not
    synchronise; raises when the launch is refused."""
    _check_job(job)
    dev = job.rows.device
    lib, fn = _kernel_function()
    with torch.cuda.device(dev):
        planes = torch.empty((10, job.height, job.width), dtype=torch.float32, device=dev)
        recs = None
        if record:
            n_rec = record_layout(job.config, job.light_index >= 0)
            recs = torch.empty((n_rec, job.height, job.width), dtype=torch.int32, device=dev)
        err = fn(
            job.rows.data_ptr(), job.cam_pack.data_ptr(), planes.data_ptr(),
            recs.data_ptr() if record else None, *_scalar_args(job, seed, row0),
        )
    _raise_on(err, lib, "megakernel_fwd")
    launch_counts["megakernel_fwd_record" if record else "megakernel_fwd"] += 1
    return planes, recs


LAUNCH_INFO_FIELDS = ("registers", "stack_bytes", "static_smem_bytes", "dynamic_smem_bytes",
                      "saved_states", "blocks_per_sm", "threads_per_block")


def launch_info(kernel: str, job: TileJob) -> dict:
    """What one launch of `kernel` ("fwd", "fwd_record" or a BWD_KERNELS
    name) takes at the job's scene size and kinds and depth, as the CUDA runtime
    reports it for the built library (LAUNCH_INFO_FIELDS: registers and
    stack per thread, shared memory per block, entry states the backward
    keeps in shared memory, blocks per SM), and the warps resident per SM
    that follow. Needs the card."""
    info = (ctypes.c_int * len(LAUNCH_INFO_FIELDS))()
    if kernel in ("fwd", "fwd_record"):
        lib = build.load_library(KERNEL_LIBRARY)
        fn = lib.rt_megakernel_fwd_info
        args = (len(job.obj_type), job.n_spheres, int(kernel == "fwd_record"))
    else:
        library, entry = BWD_KERNELS[kernel]
        lib = build.load_library(library)
        fn = getattr(lib, entry + "_info")
        args = (len(job.obj_type), job.n_spheres, job.config.bounces)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(job.rows.device):
        err = fn(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{kernel} launch info: cudaError {err}")
    out = dict(zip(LAUNCH_INFO_FIELDS, info))
    out["warps_per_sm"] = out["blocks_per_sm"] * out["threads_per_block"] // 32
    return out


def run_tiles(job: TileJob, seed: int, row0: int = 0, record: bool = False):
    """One sample per pixel: the CUDA kernel for a job on the card, the
    plain version for a job on the CPU. Nothing else decides between them."""
    with span("kernel.megakernel_fwd_record" if record else "kernel.megakernel_fwd"):
        if job.rows.device.type == "cuda":
            return _launch_fwd(job, seed, row0, record)
        if job.rows.device.type != "cpu":
            raise ValueError(f"unsupported device {job.rows.device}")
        return run_tiles_plain(job, seed, row0, record)


# ---------------------------------------------------------------------------
# The backward of one sample: the kernel's wrapper and its plain version
# ---------------------------------------------------------------------------


def split_records(records, bounces: int, ns: int) -> list:
    """(n_rec,H,W) index planes -> the per-call list a FetchReplayTracer
    pops: per bounce the (H,W) primary plane, then the (ns,H,W) shadow
    volume when next-event estimation runs."""
    objs, i = [], 0
    for _ in range(bounces):
        objs.append(records[i])
        i += 1
        if ns:
            objs.append(records[i:i + ns])
            i += ns
    return objs


def replay_planes(job: TileJob, rows, cam_pack, u, v, draws, records):
    """tile_physics over a FetchReplayTracer: the (10,H,W) planes of one
    sample as a function of `rows` (N,16) and `cam_pack` (16,), which
    autograd can differentiate. The planes equal the forward's bit for bit:
    the fetch is an exact gather."""
    tracer = FetchReplayTracer(
        split_records(records, job.config.bounces, job.ns), rows,
        job.obj_type, job.light_index, job.emissive)
    outs = tile_physics(None, cam_pack, u, v, draws, job.config,
                        (job.height, job.width), tracer=tracer)
    return torch.stack(outs)


def _vjp(outputs, inputs, cotangents):
    """autograd.grad of `outputs` against `cotangents`, a zero tensor for an
    input that nothing differentiable reached."""
    grads = torch.autograd.grad(outputs, inputs, grad_outputs=cotangents, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


def replay_vjp(job: TileJob, u, v, draws, records, cotangents):
    """The fetch backward kernel's math in plain PyTorch: replay_planes on
    the job's (detached) scene rows and camera pack, differentiated by
    autograd against the (10,H,W) `cotangents`. Returns (planes (10,H,W),
    g_rows (N,16), g_cam (16,))."""
    rows = job.rows.detach().requires_grad_(True)
    cam = job.cam_pack.detach().requires_grad_(True)
    with torch.enable_grad():
        planes = replay_planes(job, rows, cam, u, v, draws, records)
    g_rows, g_cam = _vjp(planes, [rows, cam], cotangents)
    return planes.detach(), g_rows, g_cam


def run_bwd_plain(job: TileJob, seed: int, row0: int, records, cotangents):
    """The plain PyTorch version of the fetch backward CUDA kernel (K3):
    regenerates the draws of (seed, pixel, slot) and the jitter, replays the
    paths from `records` and returns (g_rows (N,16), g_cam (16,))."""
    u, v, draws = _sample_inputs(job, seed, row0)
    _, g_rows, g_cam = replay_vjp(job, u, v, draws, records, cotangents)
    return g_rows, g_cam


def _record_planes(rec):
    """(first column, planes in column order) of a record's differentiable
    planes: the 15 of a TraceRecord from column 0, the 3 emission planes of
    a ShadowRecord from column 12."""
    if isinstance(rec, TraceRecord):
        return 0, [rec.p0.x, rec.p0.y, rec.p0.z, rec.p1.x, rec.p1.y, rec.p1.z,
                   rec.albedo.x, rec.albedo.y, rec.albedo.z,
                   rec.roughness, rec.reflectance, rec.metallic,
                   rec.emission.x, rec.emission.y, rec.emission.z]
    return 12, [rec.emission.x, rec.emission.y, rec.emission.z]


def _with_planes(rec, planes):
    """The record with its differentiable planes replaced (_record_planes'
    order)."""
    if isinstance(rec, TraceRecord):
        p = planes
        return dataclasses.replace(
            rec, p0=Vec3(*p[0:3]), p1=Vec3(*p[3:6]), albedo=Vec3(*p[6:9]),
            roughness=p[9], reflectance=p[10], metallic=p[11], emission=Vec3(*p[12:15]))
    return dataclasses.replace(rec, emission=Vec3(*planes))


def route_record_grads(n: int, records, g_records):
    """(N,16) row gradients from the cotangents of the records' planes:

        G[i, c] = sum over records r, pixels p with r.obj[p] == i of g_r[c][p]

    `g_records` are records of the same kinds whose planes hold the
    cotangents (None: zero). A miss (-1) routes nowhere; a shadow record
    routes its emission only. One index_add_ per record."""
    dev = records[0].obj.device
    G = torch.zeros((n, SCENE_COLS), dtype=torch.float32, device=dev)
    for rec, g in zip(records, g_records):
        first, planes = _record_planes(g)
        idx = rec.obj.reshape(-1)
        keep = idx >= 0
        zero = torch.zeros(idx.shape, dtype=torch.float32, device=dev)
        vals = torch.stack([zero if t is None else t.reshape(-1) for t in planes], dim=1)
        G[:, first:first + len(planes)].index_add_(0, idx[keep].long(), vals[keep])
    return G


def record_replay_vjp(job: TileJob, u, v, draws, cotangents):
    """The "replay" backward kernel's math in plain PyTorch, as the JAX
    package's _bwd_kernel_replay computes it: pass 1 traces the paths
    against the scene with a RecordingTracer (no graph); pass 2 runs
    tile_physics over a ReplayTracer whose record planes, camera pack and
    light geometry are leaves, and autograd takes its VJP against the
    (10,H,W) `cotangents`; the record cotangents are routed to (N,16) rows
    (route_record_grads) and the light's origin gradient is added to its
    row. Returns (planes (10,H,W), g_rows (N,16), g_cam (16,), g_light (6,):
    the light-origin part of g_rows, zero while occlusion is detached)."""
    cfg = job.config
    shape = (job.height, job.width)
    view = SceneView(job.rows.detach(), job.obj_type, job.light_index, job.emissive)
    recorder = RecordingTracer(view)
    with torch.no_grad():
        tile_physics(view, job.cam_pack.detach(), u, v, draws, cfg, shape, tracer=recorder)

    leaves, records = [], []
    for rec in recorder.records:
        _, planes = _record_planes(rec)
        lv = [t.detach().clone().requires_grad_(True) for t in planes]
        leaves.append(lv)
        records.append(_with_planes(rec, lv))
    cam = job.cam_pack.detach().requires_grad_(True)
    li = job.light_index
    has_light = li >= 0
    light, geom = [], None
    if has_light:
        light = [job.rows[li, k].detach().clone().requires_grad_(True) for k in range(6)]
        geom = (Vec3(*light[0:3]), Vec3(*light[3:6]))
    with torch.enable_grad():
        tracer = ReplayTracer(records, has_light, geom,
                              has_light and job.obj_type[li] == OBJ_SPHERE)
        planes = torch.stack(tile_physics(None, cam, u, v, draws, cfg, shape, tracer=tracer))

    flat = [t for lv in leaves for t in lv]
    grads = _vjp(planes, flat + [cam] + light, cotangents)
    g_records, k = [], 0
    for rec, lv in zip(recorder.records, leaves):
        g_records.append(_with_planes(rec, grads[k:k + len(lv)]))
        k += len(lv)
    g_cam = grads[k]
    g_rows = route_record_grads(len(job.obj_type), recorder.records, g_records)
    g_light = torch.stack(grads[k + 1:]) if has_light else torch.zeros(6, device=g_rows.device)
    if has_light:
        g_rows[li, 0:6] += g_light
    return planes.detach(), g_rows, g_cam, g_light


def direct_vjp(job: TileJob, u, v, draws, cotangents):
    """The "direct" backward kernel's math in plain PyTorch, as the JAX
    package's _bwd_kernel computes it: autograd straight through
    tile_physics and the closest-hit trace over the scene table. Returns
    (planes (10,H,W), g_rows (N,16), g_cam (16,))."""
    rows = job.rows.detach().requires_grad_(True)
    cam = job.cam_pack.detach().requires_grad_(True)
    with torch.enable_grad():
        view = SceneView(rows, job.obj_type, job.light_index, job.emissive)
        planes = torch.stack(tile_physics(view, cam, u, v, draws, job.config,
                                          (job.height, job.width)))
    g_rows, g_cam = _vjp(planes, [rows, cam], cotangents)
    return planes.detach(), g_rows, g_cam


def run_bwd_replay_plain(job: TileJob, seed: int, row0: int, cotangents):
    """The plain PyTorch version of the "replay" backward CUDA kernel (K4):
    (g_rows (N,16), g_cam (16,)) of one sample, the draws regenerated from
    (seed, pixel, slot) as the forward drew them."""
    u, v, draws = _sample_inputs(job, seed, row0)
    _, g_rows, g_cam, _ = record_replay_vjp(job, u, v, draws, cotangents)
    return g_rows, g_cam


def run_bwd_direct_plain(job: TileJob, seed: int, row0: int, cotangents):
    """The plain PyTorch version of the "direct" backward CUDA kernel (K5):
    (g_rows (N,16), g_cam (16,)) of one sample."""
    u, v, draws = _sample_inputs(job, seed, row0)
    _, g_rows, g_cam = direct_vjp(job, u, v, draws, cotangents)
    return g_rows, g_cam


def backward_kernel(job: TileJob) -> str:
    """The backward kernel run_bwd runs for `job`, picked as the JAX
    package's _run_bwd picks it: "fetch" (K3) in fetch mode; "direct" (K5)
    in direct mode up to UNROLL_LIMIT objects; "replay" (K4) otherwise,
    direct mode above the limit included (effective_bwd_mode still says
    "direct" there, as the JAX function does)."""
    mode = job.config.bwd_mode
    if mode == "fetch":
        return "fetch"
    if mode == "direct" and len(job.obj_type) <= UNROLL_LIMIT:
        return "direct"
    return "replay"


def _launch_bwd(kernel: str, job: TileJob, seed: int, row0: int, records, cotangents,
                want_primal: bool = False):
    """Launch the backward CUDA kernel `kernel` ("fetch", "replay" or
    "direct") on PyTorch's current stream: (g_rows (N,16), g_cam (16,)), and
    with `want_primal` also the ten planes its forward walk arrives at (a
    check that forward and backward walk the same paths). `records` are the
    fetch kernel's index planes and None for the other two. Does not
    synchronise; raises when the launch is refused."""
    _check_job(job)
    dev = job.rows.device
    frame = (job.height, job.width)
    if kernel == "fetch":
        n_rec = record_layout(job.config, job.light_index >= 0)
        _check_tensor("records", records, (n_rec, *frame), torch.int32, dev)
    elif records is not None:
        raise ValueError(f"the {kernel} backward takes no index planes")
    if not isinstance(cotangents, torch.Tensor) or tuple(cotangents.shape) != (10, *frame):
        raise ValueError(f"cotangents must be a (10, {job.height}, {job.width}) tensor")
    # autograd may hand over expanded or strided cotangents
    cotangents = cotangents.contiguous()
    _check_tensor("cotangents", cotangents, (10, *frame), torch.float32, dev)
    lib, fn = _bwd_kernel_function(kernel)
    with torch.cuda.device(dev):
        # the kernel adds into these with atomics
        g_rows = torch.zeros((len(job.obj_type), SCENE_COLS), dtype=torch.float32, device=dev)
        g_cam = torch.zeros((16,), dtype=torch.float32, device=dev)
        primal = torch.empty((10, *frame), dtype=torch.float32, device=dev) if want_primal else None
        err = fn(
            job.rows.data_ptr(), job.cam_pack.data_ptr(), cotangents.data_ptr(),
            records.data_ptr() if records is not None else None,
            g_rows.data_ptr(), g_cam.data_ptr(),
            primal.data_ptr() if want_primal else None, *_scalar_args(job, seed, row0),
        )
    name = "megakernel_bwd_" + kernel
    _raise_on(err, lib, name)
    launch_counts[name] += 1
    return (g_rows, g_cam, primal) if want_primal else (g_rows, g_cam)


def run_bwd(job: TileJob, seed: int, row0: int, records, cotangents):
    """Gradients of one sample with respect to the scene rows and the camera
    pack, through backward_kernel(job): its CUDA kernel for a job on the
    card, its plain version for a job on the CPU. Nothing else decides
    between them. `records`: the fetch kernel's index planes, else None."""
    kernel = backward_kernel(job)
    with span("kernel.megakernel_bwd_" + kernel):
        if job.rows.device.type == "cuda":
            return _launch_bwd(kernel, job, seed, row0, records, cotangents)
        if job.rows.device.type != "cpu":
            raise ValueError(f"unsupported device {job.rows.device}")
        if kernel == "fetch":
            return run_bwd_plain(job, seed, row0, records, cotangents)
        plain = run_bwd_replay_plain if kernel == "replay" else run_bwd_direct_plain
        return plain(job, seed, row0, cotangents)


def effective_bwd_mode(scene: Scene, config: RenderConfig, width: int,
                       height: int, spp: int) -> str:
    """The backward mode render_image_cuda will EXECUTE under grad.

    bwd_mode="fetch" keeps one int32 winner-index plane per trace call per
    sample alive until backward(); past FETCH_RECORD_BUDGET_BYTES the mode
    becomes "replay", which keeps none. Any other configured mode is
    returned as it is, as the JAX function returns it ("direct" above
    UNROLL_LIMIT objects runs the replay kernel: backward_kernel names the
    kernel). Exposed so that a caller can log the mode it ran."""
    if config.bwd_mode != "fetch":
        return config.bwd_mode
    has_light = scene.has_light and config.shadow_samples > 0
    n_rec = record_layout(config, has_light)
    if spp * n_rec * height * width * 4 > FETCH_RECORD_BUDGET_BYTES:
        return "replay"
    return "fetch"


class TilesFunction(torch.autograd.Function):
    """One sample's ten planes as a differentiable function of the packed
    scene rows and the camera pack. The job's static part, the integer seed
    and row0 are not tensors (a seed of 2^24 or more stays exact).

    forward: the recording launch when an input requires grad and the
    backward is "fetch", saving the winner-index planes; else the
    non-recording launch, which saves no index planes ("replay" and "direct"
    keep the rows, the camera pack, the seed and row0 only). backward:
    run_bwd."""

    @staticmethod
    def forward(ctx, rows, cam_pack, job, seed, row0):
        needs_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        job = dataclasses.replace(job, rows=rows.detach(), cam_pack=cam_pack.detach())
        record = needs_grad and backward_kernel(job) == "fetch"
        planes, records = run_tiles(job, seed, row0, record=record)
        if needs_grad:
            ctx.save_for_backward(job.rows, job.cam_pack, records)
            ctx.job = dataclasses.replace(job, rows=None, cam_pack=None)
            ctx.seed, ctx.row0 = seed, row0
        return planes

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_planes):
        rows, cam_pack, records = ctx.saved_tensors
        job = dataclasses.replace(ctx.job, rows=rows, cam_pack=cam_pack)
        g_rows, g_cam = run_bwd(job, ctx.seed, ctx.row0, records, g_planes)
        return g_rows, g_cam, None, None, None


def run_tiles_grad(job: TileJob, seed: int, row0: int = 0):
    """(planes, None) like run_tiles, through the autograd boundary."""
    return TilesFunction.apply(job.rows, job.cam_pack, job, seed, row0), None


def render_tiles_cuda(scene: Scene, camera: Camera, width: int, height: int,
                      seed: int, config: RenderConfig = DEFAULT_CONFIG,
                      row0: int = 0, norm_height: int | None = None,
                      aspect: float | None = None, record: bool = False,
                      device=None):
    """One sample per pixel over the (height, width) frame through the CUDA
    kernel. Returns a dict of (H,W) float32 planes named PLANE_NAMES,
    differentiable with respect to the scene's and the camera's leaves;
    with record=True also "records", the (n_rec,H,W) int32 winner-index
    planes (and then the planes carry no graph).

    row0/norm_height render a row SLICE of a norm_height-tall frame whose
    rows start at global row row0; aspect overrides the frustum's aspect
    ratio. device=None means the card; only device="cpu" runs the plain
    version."""
    device = resolve_device(device)
    job = make_tile_job(scene.to(device), camera.to(device), width, height,
                        config, norm_height, aspect)
    if record:
        with torch.no_grad():
            planes, recs = run_tiles(job, seed, row0, record=True)
        return {**dict(zip(PLANE_NAMES, planes)), "records": recs}
    planes, _ = run_tiles_grad(job, seed, row0)
    return dict(zip(PLANE_NAMES, planes))


# ---------------------------------------------------------------------------
# Full render: samples, sky lookup, compose
# ---------------------------------------------------------------------------


def sample_seeds(seed: int, spp: int) -> list[int]:
    """Per-sample seeds in wrapping int32: `seed` itself for one sample,
    seed*7919 + i otherwise."""
    if spp == 1:
        return [_wrap_i32(seed)]
    return [_wrap_i32(seed * 7919 + i) for i in range(spp)]


def compose_sky(planes, sky: Vec3) -> Vec3:
    """clip(rgb + sky*throughput*miss, 0, 1): one sample's final colour from
    its ten planes and the sky radiance of its miss directions."""
    r, g, b, _, _, _, cr, cg, cb, miss = planes
    rgb = Vec3(r, g, b) + sky * Vec3(cr, cg, cb) * miss
    return rgb.clip(0.0, 1.0)


def sky_lookup(planes, cubemap: CubemapData, config: RenderConfig, pixels: int) -> Vec3:
    """The sky radiance of one sample's miss directions (sample_cubemap),
    in a span "sky_lookup" that counts the texels gathered for its
    `pixels` pixels."""
    bilinear = config.env_filter == "bilinear"
    # the bilinear filter reads four texels a pixel, but one of a 1x1 cubemap
    per_pixel = 4 if bilinear and cubemap.h * cubemap.w > 1 else 1
    with span("sky_lookup", texels=pixels * per_pixel):
        return sample_cubemap(cubemap, Vec3(planes[3], planes[4], planes[5]),
                              bilinear=bilinear)


def compose(planes, cubemap: CubemapData, config: RenderConfig) -> Vec3:
    """Sky lookup on the miss directions, then compose_sky."""
    sky = sky_lookup(planes, cubemap, config, planes[3].numel())
    with span("compose"):
        return compose_sky(planes, sky)


def sky_cache_capable(config: RenderConfig, cubemap: CubemapData) -> bool:
    """Whether a render can keep a sky cache: the nearest-texel lookup of a
    packed cubemap larger than 1x1."""
    return (config.env_filter == "nearest" and cubemap.packed is not None
            and cubemap.h * cubemap.w > 1)


def _miss_texel_index(cubemap: CubemapData, planes):
    """(flat texel index of the miss direction, miss flag) of one sample's
    planes; integers, outside autograd's graph."""
    with torch.no_grad():
        flat = texel_flat_index(cubemap, Vec3(planes[3], planes[4], planes[5]))
        return flat, planes[9] > 0.5


def _soft_silhouettes(job: TileJob, rgb: Vec3, cubemap: CubemapData, row0: int) -> Vec3:
    """render/integrator.py::soft_silhouette_composite over the job's frame,
    with fresh unjittered primary rays from the camera pack."""
    # imported here: render/integrator.py builds its renderer on this module
    from ray_tracing_tpu_torch.render.integrator import soft_silhouette_composite

    shape = (job.height, job.width)
    u, v = _tile_uv(job.width, job.height, job.norm_height, row0, job.rows.device)
    ro0, rd0 = camera_rays_from_pack(job.cam_pack, u, v, shape)
    view = SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    return soft_silhouette_composite(view, ro0, rd0, rgb, job.config, cubemap)


def frame_sample_seeds(seed: int, spp: int, first_sample: int = 0,
                       frame_spp: int | None = None) -> list[int]:
    """The seeds of samples first_sample .. first_sample + spp - 1 of a
    frame of `frame_spp` samples (default: spp) seeded `seed`: a slice of
    sample_seeds(seed, frame_spp). A share of a sharded frame's samples thus
    takes the very seeds that the one-device frame gives them."""
    frame_spp = spp if frame_spp is None else frame_spp
    if first_sample < 0 or first_sample + spp > frame_spp:
        raise ValueError(f"samples {first_sample}..{first_sample + spp - 1} of a "
                         f"{frame_spp}-sample frame")
    return sample_seeds(seed, frame_spp)[first_sample:first_sample + spp]


def render_frame(job: TileJob, tiles_fn, seed: int, spp: int,
                 cubemap: CubemapData, row0: int = 0, sky_cached: bool = False,
                 sky_cache=None, first_sample: int = 0, frame_spp: int | None = None):
    """((H, W, 3) image, sky cache): `spp` samples through `tiles_fn`, each
    composed with its sky and clipped BEFORE the average; the samples are
    first_sample .. of a frame of `frame_spp` (frame_sample_seeds). With
    soft_silhouette_temp > 0 the average is then blended with the soft
    primary visibility; the blend is affine in the colour and the same for
    every sample, so blending the average equals averaging the blended
    samples.

    `sky_cached` keeps a sky cache (flat, packed, miss) where
    sky_cache_capable holds and spp > 1 or a cache is given, as the JAX
    package's render_image_pallas does: sample 0's miss texels become the
    cache, or a threaded `sky_cache` of an earlier call of the same frame
    shape is taken as it is. With config.sky_sparse_gather off every sample
    gathers its texels in full (no host read). With it on, sample 0 gathers
    block-compacted and every other sample only the pixels whose texel index
    differs from the cache's (sparse_sky_lookup: one host read per sample).
    Either way the image is the full lookup's bit for bit: reuse is keyed on
    equal texel indices. The cache returned is None where none was kept; a
    threaded cache comes back as it was given.

    Each sample opens a span "sky_lookup" (texel index, gather and unpack;
    `texels` counts the texels gathered: every pixel's in a full gather, the
    fresh blocks' in a sparse one) and a span "compose" (compose_sky and the
    running sum); the frame ends in a span "average"."""
    if spp < 1:
        raise ValueError("spp must be at least 1")
    cfg = job.config
    seeds = frame_sample_seeds(seed, spp, first_sample, frame_spp)
    use_cache = (sky_cached and sky_cache_capable(cfg, cubemap)
                 and (spp > 1 or sky_cache is not None))
    sparse = use_cache and cfg.sky_sparse_gather
    pixels = job.height * job.width
    # the sparse lookup counts its texels itself (ops/cubemap.py)
    gathered = {} if sparse else {"texels": pixels}
    total, cache = None, None
    if use_cache:
        budget = max(int(pixels * cfg.sky_sparse_budget_frac) // SPARSE_BLOCK, 256)
        if sky_cache is None:
            planes, _ = tiles_fn(job, seeds[0], row0)
            with span("sky_lookup", **gathered):
                flat0, miss0 = _miss_texel_index(cubemap, planes)
                packed0 = (sparse_sky_lookup(cubemap, flat0, miss0, budget=budget) if sparse
                           else gather_texels(cubemap, flat0, miss0))
                sky = unpack_texels(packed0)
            with span("compose"):
                total = compose_sky(planes, sky)
            seeds = seeds[1:]
        else:
            flat0, packed0, miss0 = sky_cache
            if tuple(flat0.shape) != (job.height, job.width):
                raise ValueError(f"a sky cache of shape {tuple(flat0.shape)} for a "
                                 f"{job.height}x{job.width} frame")
        cache = (flat0, packed0, miss0)
    for s in seeds:
        planes, _ = tiles_fn(job, s, row0)
        if sparse:
            with span("sky_lookup"):
                flat, miss = _miss_texel_index(cubemap, planes)
                sky = unpack_texels(sparse_sky_lookup(cubemap, flat, miss, flat0, packed0,
                                                      miss0, budget))
        else:
            sky = sky_lookup(planes, cubemap, cfg, pixels)
        with span("compose"):
            rgb = compose_sky(planes, sky)
            total = rgb if total is None else total + rgb
    with span("average"):
        if spp > 1:
            total = total * (1.0 / spp)
        if cfg.soft_silhouette_temp > 0:
            total = _soft_silhouettes(job, total, cubemap, row0)
        return total.to_array(), cache


def render_image_cuda(scene: Scene, camera: Camera, width: int, height: int,
                      seed: int = 0, spp: int = 1,
                      config: RenderConfig = DEFAULT_CONFIG,
                      cubemap: CubemapData | None = None, row0: int = 0,
                      norm_height: int | None = None,
                      aspect: float | None = None, sky_cache=None,
                      return_sky_cache: bool = False, first_sample: int = 0,
                      frame_spp: int | None = None, device=None):
    """Full render through the CUDA megakernel plus the sky lookup in
    PyTorch: (height, width, 3) float32 in [0, 1] on the device.

    Takes the statistics of render_image (render/integrator.py) and the
    very same random numbers. Differentiable end to end: when a leaf of
    `scene` or `camera` requires grad, backward() runs a backward kernel per
    sample (effective_bwd_mode says which mode, backward_kernel which
    kernel); in "fetch" each sample's forward is the recording kernel.
    row0/norm_height/aspect as in render_tiles_cuda. first_sample and
    frame_spp make the `spp` samples a share of a larger frame's
    (frame_sample_seeds): parallel/render.py hands each mesh cell its own.

    sky_cache / return_sky_cache thread the sky cache across calls
    (render_frame): with return_sky_cache=True the result is (img, cache).
    With config.sky_sparse_gather on, that cache fed to the next call of the
    same frame shape makes every sample of it sparse; off (the default),
    every sample gathers its texels in full and the cache is only passed
    through. Exact for any cache state (a stale cache from another camera
    only lowers the hit rate), but only valid for the cubemap it was
    gathered from. cache is None where no cache can be kept (constant or
    bilinear sky, float cubemap, one sample without a cache). device=None
    means the card and raises without one; device="cpu" runs the plain
    versions."""
    device = resolve_device(device)
    with span("render_image", pixels=width * height, samples=spp):
        with span("tile_job"):
            if cubemap is None:
                cubemap = constant_sky(device=device)
            mode = effective_bwd_mode(scene, config, width, height, spp)
            if mode != config.bwd_mode:
                config = config.replace(bwd_mode=mode)
            job = make_tile_job(scene.to(device), camera.to(device), width, height,
                                config, norm_height, aspect)
            cubemap = cubemap.to(device)
        img, cache = render_frame(job, run_tiles_grad, seed, spp, cubemap, row0,
                                  sky_cached=True, sky_cache=sky_cache,
                                  first_sample=first_sample, frame_spp=frame_spp)
    return (img, cache) if return_sky_cache else img
