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
``shadow_samples == 0``) there are ``bounces`` planes. Their integer type is
the narrowest that holds the scene's object indices (``record_dtype``: int8
up to 127 objects, int16 above), on the card and in the plain version
alike; the entries are the same at any width. Dead lanes: the
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

The wrappers (``run_tiles``, ``run_bwd``, ``sky_compose``) take a plain
version only for tensors that lie on the CPU; on CUDA tensors they launch the
kernel or raise.

Each sample's sky lookup (nearest texel or bilinear), compose and running sum
is one launch of ``csrc/sky_compose.cu`` (``sky_compose``; plain version
``sky_compose_plain``), which the JAX package leaves to XLA inside
render_image_pallas; under grad ``SkyComposeFunction`` keeps four int32 planes
a pixel (five for a float sky larger than 1x1 at the nearest texel, seven
for the bilinear filter) and its adjoint kernel writes the sample's (10,H,W)
cotangent, the bilinear filter's direction cotangent included.

Where soft_silhouette_temp > 0, a frame on the card is blended with the soft
primary visibility by one launch of the same library (``soft_silhouettes``;
plain version ``soft_silhouettes_plain``), which the JAX package leaves to
XLA; under grad ``SoftSilhouetteFunction`` keeps the frame's colour and its
adjoint kernel recomputes the composite. The CPU, a sky that requires grad
and the plain reference keep render/integrator.py::soft_silhouette_composite.

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
    CubemapData,
    bilinear_adjoint,
    bilinear_terms,
    constant_sky,
    face_uv,
    sample_cubemap,
    texel_flat_index,
    unpack_texels,
)
from ray_tracing_tpu_torch.ops.intersect import (
    BIG,
    HIT_THRESHOLD,
    UNROLL_LIMIT,
    TraceRecord,
    _single_emissive_index,
    intersect_cube,
    intersect_sphere,
    ray_inverses,
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
from ray_tracing_tpu_torch.ops.vec import NORMALIZE_EPS, Vec3, div_scalar, fresnel_schlick
from ray_tracing_tpu_torch.render.camera import Camera, camera_pack, pixel_grid
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, SCENE_COLS, Scene, light_origin_from
from ray_tracing_tpu_torch.utils.profiling import recording, span

PLANE_NAMES = ("r", "g", "b", "sx", "sy", "sz", "cr", "cg", "cb", "miss")
KERNEL_LIBRARY = "megakernel_fwd"
BWD_KERNEL_LIBRARY = "megakernel_bwd"
RETRACE_KERNEL_LIBRARY = "megakernel_bwd_retrace"
SKY_COMPOSE_LIBRARY = "sky_compose"

# The backward kernels: (library, C entry point), by backward_kernel's name.
BWD_KERNELS = {
    "fetch": (BWD_KERNEL_LIBRARY, "rt_megakernel_bwd"),
    "replay": (RETRACE_KERNEL_LIBRARY, "rt_megakernel_bwd_replay"),
    "direct": (RETRACE_KERNEL_LIBRARY, "rt_megakernel_bwd_direct"),
}

# How often each kernel was launched: one count per kernel (the forward's two
# template instantiations count apart, and so do the sky compose's nearest
# and bilinear arms), raised where the launch happens and nowhere else.
# run_tiles and run_bwd open a span "kernel.<key>" around each call, so that
# a trace groups a kernel by the span that launched it; the sky compose
# (either arm) runs in render_frame's span "compose", its adjoint (either
# arm) in "kernel.sky_compose_adjoint"; the soft silhouettes' composite in
# "soft_silhouettes", its adjoint in "kernel.soft_silhouettes_adjoint".
launch_counts = {"megakernel_fwd": 0, "megakernel_fwd_record": 0,
                 **{"megakernel_bwd_" + k: 0 for k in BWD_KERNELS},
                 "sky_compose": 0, "sky_compose_adjoint": 0,
                 "sky_compose_bilinear": 0, "sky_compose_bilinear_adjoint": 0,
                 "soft_silhouettes": 0, "soft_silhouettes_adjoint": 0}

# Device memory the winner-index planes of one differentiated frame may take
# (spp * n_rec * H * W entries of record_dtype(N), 1 or 2 bytes each, are
# alive until backward()): two fifths of an 80 GB card. A module constant so
# that tests can shrink it.
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
        # PyTorch gathers with int64 indices, not with record_dtype's int8 or
        # int16: one widened plane at a time, alive while its call replays
        o = self._objs[self._i].long()
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
    module docstring, their type record_dtype's. Contract of their entries:
    an entry holds the winner of its trace call (-1: nothing hit), except on
    dead lanes. The primary
    entry of a bounce the path did not enter alive is -1; each shadow entry
    of a bounce whose primary entry is -1 is -1 as well (dead_lane_rule),
    whatever its ray would hit. The recording kernel stops tracing where the
    path dies and writes these entries directly."""
    ns = config.shadow_samples if has_light else 0
    return config.bounces * (1 + ns)


def record_dtype(n_objects: int) -> torch.dtype:
    """The integer type of the winner-index planes of a scene of `n_objects`
    objects: the narrowest whose range holds the count, and so every index
    in [-1, n_objects - 1]. int8 up to 127 objects, int16 up to 32767; int32
    beyond, which only the plain version takes (the kernels stage the scene
    in shared memory and hold far fewer objects)."""
    if n_objects <= 127:
        return torch.int8
    if n_objects <= 32767:
        return torch.int16
    return torch.int32


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
    (n_rec,H,W) of record_dtype(N), or None). The records are the tracer's
    with the dead-lane rule applied (dead_lane_rule), as the kernel writes
    them."""
    shape = (job.height, job.width)
    u, v, draws = _sample_inputs(job, seed, row0)
    view = SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tracer = IndexRecordingTracer(view) if record else DirectTracer(view)
    outs = tile_physics(view, job.cam_pack, u, v, draws, job.config, shape, tracer=tracer)
    planes = torch.stack(outs)
    if not record:
        return planes, None
    recs = torch.cat([o.reshape(-1, *shape) for o in tracer.objs])
    return planes, dead_lane_rule(recs.to(record_dtype(len(job.obj_type))), job.ns)


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
    """The forward kernel's C entry: four pointers, the bytes an index of
    the planes takes, the scalars."""
    return _load(KERNEL_LIBRARY, "rt_megakernel_fwd",
                 [ctypes.c_void_p] * 4 + [ctypes.c_int] + _SCALAR_ARGS)


def _bwd_kernel_function(kernel: str):
    """The loaded C entry point of a backward kernel (BWD_KERNELS): seven
    pointers and the scalars; "fetch" takes the bytes an index of its planes
    takes after its fourth pointer, the index planes."""
    library, entry = BWD_KERNELS[kernel]
    width = [ctypes.c_int] if kernel == "fetch" else []
    return _load(library, entry,
                 [ctypes.c_void_p] * 4 + width + [ctypes.c_void_p] * 3 + _SCALAR_ARGS)


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


def _kernel_index_dtype(job: TileJob) -> torch.dtype:
    """record_dtype of the job's scene, refused where the kernels have no
    instantiation (past 32767 objects, which their shared-memory tables
    could not stage anyway)."""
    dtype = record_dtype(len(job.obj_type))
    if dtype == torch.int32:
        raise ValueError(f"{len(job.obj_type)} objects: the kernels take int8 or int16 "
                         "index planes, up to 32767 objects")
    return dtype


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
            recs = torch.empty((n_rec, job.height, job.width), dtype=_kernel_index_dtype(job),
                               device=dev)
        err = fn(
            job.rows.data_ptr(), job.cam_pack.data_ptr(), planes.data_ptr(),
            recs.data_ptr() if record else None, recs.element_size() if record else 0,
            *_scalar_args(job, seed, row0),
        )
    _raise_on(err, lib, "megakernel_fwd")
    launch_counts["megakernel_fwd_record" if record else "megakernel_fwd"] += 1
    return planes, recs


LAUNCH_INFO_FIELDS = ("registers", "stack_bytes", "static_smem_bytes", "dynamic_smem_bytes",
                      "saved_states", "blocks_per_sm", "threads_per_block")


def launch_info(kernel: str, job: TileJob) -> dict:
    """What one launch of `kernel` ("fwd", "fwd_record" or a BWD_KERNELS
    name) takes at the job's scene size and kinds and depth (and, for the
    recording forward and "fetch", at record_dtype's width), as the CUDA runtime
    reports it for the built library (LAUNCH_INFO_FIELDS: registers and
    stack per thread, shared memory per block, entry states the backward
    keeps in shared memory, blocks per SM), and the warps resident per SM
    that follow. Needs the card."""
    info = (ctypes.c_int * len(LAUNCH_INFO_FIELDS))()
    if kernel in ("fwd", "fwd_record"):
        lib = build.load_library(KERNEL_LIBRARY)
        fn = lib.rt_megakernel_fwd_info
        record = _kernel_index_dtype(job).itemsize if kernel == "fwd_record" else 0
        args = (len(job.obj_type), job.n_spheres, record)
    else:
        library, entry = BWD_KERNELS[kernel]
        lib = build.load_library(library)
        fn = getattr(lib, entry + "_info")
        args = (len(job.obj_type), job.n_spheres, job.config.bounces)
        if kernel == "fetch":
            args += (_kernel_index_dtype(job).itemsize,)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(job.rows.device):
        err = fn(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{kernel} launch info: cudaError {err}")
    out = dict(zip(LAUNCH_INFO_FIELDS, info))
    out["warps_per_sm"] = out["blocks_per_sm"] * out["threads_per_block"] // 32
    return out


def record_bytes(job: TileJob) -> int:
    """Bytes of one sample's winner-index planes over the job's frame."""
    n_rec = record_layout(job.config, job.light_index >= 0)
    return n_rec * job.height * job.width * record_dtype(len(job.obj_type)).itemsize


def fwd_span_counts(job: TileJob, record: bool) -> dict:
    """What a forward launch's span counts: its `pixels`, the scene's
    `objects`, the `shadow_samples` a bounce (0 with next-event estimation
    off), `occlusion` (1 where the shadow rays take the sole emitter's
    occlusion trace, 0 for the full scan or none) and, for the recording
    launch, `index_bytes`, the bytes of index planes it writes
    (record_bytes). single_emissive walks every object, so run_tiles asks
    for these only while spans are kept."""
    counts = {"pixels": job.width * job.height, "objects": len(job.obj_type),
              "shadow_samples": job.ns,
              "occlusion": int(job.ns > 0 and job.single_emissive >= 0)}
    if record:
        counts["index_bytes"] = record_bytes(job)
    return counts


def run_tiles(job: TileJob, seed: int, row0: int = 0, record: bool = False):
    """One sample per pixel: the CUDA kernel for a job on the card, the
    plain version for a job on the CPU. Nothing else decides between them.
    The launch's span counts fwd_span_counts."""
    counts = fwd_span_counts(job, record) if recording() else {}
    with span("kernel.megakernel_fwd_record" if record else "kernel.megakernel_fwd", **counts):
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
    rec_args = (None,)
    if kernel == "fetch":
        n_rec = record_layout(job.config, job.light_index >= 0)
        _check_tensor("records", records, (n_rec, *frame), _kernel_index_dtype(job), dev)
        rec_args = (records.data_ptr(), records.element_size())
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
            job.rows.data_ptr(), job.cam_pack.data_ptr(), cotangents.data_ptr(), *rec_args,
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

    bwd_mode="fetch" keeps one winner-index plane (record_dtype: 1 or 2
    bytes an entry) per trace call per sample alive until backward(); past
    FETCH_RECORD_BUDGET_BYTES the mode becomes "replay", which keeps none.
    Any other configured mode is returned as it is, as the JAX function
    returns it ("direct" above UNROLL_LIMIT objects runs the replay kernel:
    backward_kernel names the kernel). Exposed so that a caller can log the
    mode it ran."""
    if config.bwd_mode != "fetch":
        return config.bwd_mode
    has_light = scene.has_light and config.shadow_samples > 0
    n_rec = record_layout(config, has_light)
    itemsize = record_dtype(scene.num_objects).itemsize
    if spp * n_rec * height * width * itemsize > FETCH_RECORD_BUDGET_BYTES:
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
    with record=True also "records", the (n_rec,H,W) winner-index planes of
    record_dtype(N) (and then the planes carry no graph).

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


# ---------------------------------------------------------------------------
# One sample's sky lookup, compose and running sum: the kernels' wrappers,
# their plain version and the autograd boundary
# ---------------------------------------------------------------------------

# The int32 word the compose keeps a pixel under grad (csrc/sky_compose.cu):
# bits 0-23 the texel of a packed sky or the face of a 1x1 float sky, bits
# 24-29 each channel's clip code (SKY_CLIP_*), bit 30 the miss flag.
SKY_TEXEL_MASK = 0xFFFFFF
SKY_CLIP_SHIFT = 24
SKY_MISS_BIT = 1 << 30
SKY_CLIP_FULL, SKY_CLIP_HALF = 2, 1  # 0: the clip passes no cotangent


def _sky_requires_grad(cubemap: CubemapData) -> bool:
    return any(t is not None and t.requires_grad for t in (cubemap.r, cubemap.g, cubemap.b))


def fused_sky_compose(cubemap: CubemapData) -> bool:
    """Whether render_frame composes each sample through sky_compose: either
    filter, of a sky that no gradient asks for. A float sky whose planes
    require grad (sky_compose takes the sky as a constant) keeps sky_lookup
    and compose_sky."""
    return not _sky_requires_grad(cubemap)


def _bilinear_arm(bilinear: bool, cubemap: CubemapData) -> bool:
    """Whether the bilinear filter reads more than one texel: a 1x1 sky
    reads its face's texel under either filter."""
    return bilinear and cubemap.h * cubemap.w > 1


def sky_state_planes(cubemap: CubemapData, bilinear: bool = False) -> int:
    """int32 planes a pixel that sky_compose keeps for the backward: the word
    and the three throughput planes; for the bilinear filter on a sky larger
    than 1x1 the miss direction as well (seven), else for a float sky larger
    than 1x1 the flat texel index (five)."""
    if _bilinear_arm(bilinear, cubemap):
        return 7
    return 5 if cubemap.packed is None and cubemap.h * cubemap.w > 1 else 4


def _clip_code(x):
    """SKY_CLIP_FULL inside (0, 1) and on NaN, SKY_CLIP_HALF exactly on 0 or
    1, 0 outside: how min(max(x, 0), 1) passes a cotangent in autograd."""
    out = torch.where((x == 0) | (x == 1), SKY_CLIP_HALF, SKY_CLIP_FULL)
    return torch.where((x < 0) | (x > 1), 0, out).to(torch.int32)


def sky_compose_plain(planes, total, cubemap: CubemapData, keep_state: bool = False,
                      bilinear: bool = False):
    """The plain PyTorch version of the forward CUDA kernel: one sample's
    sky lookup (the nearest texel, or with `bilinear` the bilinear filter),
    compose_sky, and the running sum. `planes` (10,H,W) from tile_physics
    (the miss plane holds 0 or 1), `total` the (H,W,3) running sum or None
    for the first sample. Returns (total + rgb, state): `state` the
    (sky_state_planes,H,W) int32 planes the adjoint reads (with keep_state,
    else None). Bit for bit what sample_cubemap and compose_sky compute."""
    d = Vec3(planes[3], planes[4], planes[5])
    miss = planes[9]
    if _bilinear_arm(bilinear, cubemap):
        sky = bilinear_terms(cubemap, d)[0]
        low = torch.zeros(miss.shape, dtype=torch.int32, device=miss.device)
        rest = list(planes[3:6].view(torch.int32))
    else:
        if cubemap.h * cubemap.w == 1:
            k = face_uv(d)[0]
        else:
            k = texel_flat_index(cubemap, d)
        if cubemap.packed is not None:
            low = cubemap.packed[k.long()]
            sky = unpack_texels(low)
        else:
            kl = k.long()
            sky = Vec3(cubemap.r[kl], cubemap.g[kl], cubemap.b[kl])
            low = k if cubemap.h * cubemap.w == 1 else torch.zeros_like(k)
        rest = [k] if sky_state_planes(cubemap) == 5 else []
    c = Vec3(planes[6], planes[7], planes[8])
    x = Vec3(planes[0], planes[1], planes[2]) + sky * c * miss
    rgb = x.clip(0.0, 1.0).to_array()
    out = rgb if total is None else total + rgb
    state = None
    if keep_state:
        word = low | torch.where(miss > 0.5, SKY_MISS_BIT, 0).to(torch.int32)
        for ch, xc in enumerate((x.x, x.y, x.z)):
            word = word | (_clip_code(xc) << (SKY_CLIP_SHIFT + 2 * ch))
        state = torch.stack([word, *(p.view(torch.int32) for p in planes[6:9]), *rest])
    return out, state


def _state_sky(state, cubemap: CubemapData, bilinear: bool = False) -> Vec3:
    """The sky radiance a compose used, from its saved state."""
    if _bilinear_arm(bilinear, cubemap):
        return bilinear_terms(cubemap, _state_direction(state))[0]
    word = state[0]
    if cubemap.packed is not None:
        return unpack_texels(word & SKY_TEXEL_MASK)
    k = (word & SKY_TEXEL_MASK) if cubemap.h * cubemap.w == 1 else state[4]
    k = k.long()
    return Vec3(cubemap.r[k], cubemap.g[k], cubemap.b[k])


def _state_direction(state) -> Vec3:
    """The miss direction a bilinear compose kept (state planes 4-6)."""
    d = state[4:7].view(torch.float32)
    return Vec3(d[0], d[1], d[2])


def sky_compose_adjoint_plain(g_total, state, cubemap: CubemapData, bilinear: bool = False):
    """The plain PyTorch version of the adjoint CUDA kernel: the (10,H,W)
    cotangent of one sample's planes from the running sum's (H,W,3)
    cotangent and the state sky_compose_plain kept. The clip passes all,
    half or none of each channel's cotangent as autograd does; the
    direction planes get 0 at the nearest texel and, with `bilinear`, the
    filter's cotangent (ops/cubemap.py::bilinear_adjoint) of each channel's
    (g * w) * miss * c."""
    word = state[0]
    sky = _state_sky(state, cubemap, bilinear)
    miss = ((word & SKY_MISS_BIT) != 0).to(torch.float32)
    zero = torch.zeros_like(miss)
    g_x, g_c, terms, g_sky = [], [], [], []
    for ch, s in enumerate((sky.x, sky.y, sky.z)):
        g = g_total[..., ch]
        code = (word >> (SKY_CLIP_SHIFT + 2 * ch)) & 3
        gx = torch.where(code == SKY_CLIP_FULL, g, torch.where(code == SKY_CLIP_HALF, g * 0.5, zero))
        c = state[1 + ch].view(torch.float32)
        g_x.append(gx)
        g_c.append(gx * miss * s)
        terms.append(gx * (s * c))
        g_sky.append(gx * miss * c)
    g_miss = terms[0] + terms[1] + terms[2]
    if _bilinear_arm(bilinear, cubemap):
        g_d = bilinear_adjoint(cubemap, _state_direction(state), Vec3(*g_sky))
        g_dir = [g_d.x, g_d.y, g_d.z]
    else:
        g_dir = [zero, zero, zero]
    return torch.stack([*g_x, *g_dir, *g_c, g_miss])


def _sky_pointers(cubemap: CubemapData, dev):
    """(packed, r, g, b, h, w) of the kernels' C arguments, after checking
    the storage."""
    size = 6 * cubemap.h * cubemap.w
    if cubemap.packed is not None:
        _check_tensor("packed sky", cubemap.packed, (size,), torch.int32, dev)
        return cubemap.packed.data_ptr(), None, None, None, cubemap.h, cubemap.w
    for name, t in (("sky r", cubemap.r), ("sky g", cubemap.g), ("sky b", cubemap.b)):
        _check_tensor(name, t, (size,), torch.float32, dev)
    return (None, cubemap.r.data_ptr(), cubemap.g.data_ptr(), cubemap.b.data_ptr(),
            cubemap.h, cubemap.w)


def _launch_sky_compose(planes, total, cubemap: CubemapData, keep_state: bool,
                        bilinear: bool = False):
    """Launch the forward CUDA kernel on PyTorch's current stream: the
    arguments and results of sky_compose_plain. Without keep_state the sum
    is added into `total` in place. Does not synchronise; raises when the
    launch is refused."""
    dev = planes.device
    frame = tuple(planes.shape[1:])
    _check_tensor("planes", planes, (10, *frame), torch.float32, dev)
    if total is not None:
        _check_tensor("running sum", total, (*frame, 3), torch.float32, dev)
    arm = _bilinear_arm(bilinear, cubemap)
    sky = _sky_pointers(cubemap, dev)
    lib, fn = _load(SKY_COMPOSE_LIBRARY, "rt_sky_compose",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    with torch.cuda.device(dev):
        out = total if total is not None and not keep_state else torch.empty(
            (*frame, 3), dtype=torch.float32, device=dev)
        state = (torch.empty((sky_state_planes(cubemap, bilinear), *frame), dtype=torch.int32,
                             device=dev) if keep_state else None)
        err = fn(planes.data_ptr(), None if total is None else total.data_ptr(), out.data_ptr(),
                 *sky, planes[0].numel(), int(arm), None if state is None else state.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "sky_compose")
    launch_counts["sky_compose_bilinear" if arm else "sky_compose"] += 1
    return out, state


def _launch_sky_compose_adjoint(g_total, state, cubemap: CubemapData, bilinear: bool = False):
    """Launch the adjoint CUDA kernel on PyTorch's current stream: the
    (10,H,W) cotangent of sky_compose_adjoint_plain. Does not synchronise;
    raises when the launch is refused."""
    dev = state.device
    frame = tuple(state.shape[1:])
    _check_tensor("state", state, (sky_state_planes(cubemap, bilinear), *frame), torch.int32,
                  dev)
    # autograd may hand over an expanded or strided cotangent
    g_total = g_total.contiguous()
    _check_tensor("running sum's cotangent", g_total, (*frame, 3), torch.float32, dev)
    sky = _sky_pointers(cubemap, dev)
    arm = _bilinear_arm(bilinear, cubemap)
    lib, fn = _load(SKY_COMPOSE_LIBRARY, "rt_sky_compose_adjoint",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    with torch.cuda.device(dev):
        g_planes = torch.empty((10, *frame), dtype=torch.float32, device=dev)
        err = fn(g_total.data_ptr(), state.data_ptr(), *sky, state[0].numel(), int(arm),
                 g_planes.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "sky_compose_adjoint")
    launch_counts["sky_compose_bilinear_adjoint" if arm else "sky_compose_adjoint"] += 1
    return g_planes


def _sky_compose_forward(planes, total, cubemap: CubemapData, keep_state: bool,
                         bilinear: bool):
    """The forward CUDA kernel for planes on the card, its plain version for
    planes on the CPU. Nothing else decides between them."""
    if planes.device.type == "cuda":
        return _launch_sky_compose(planes, total, cubemap, keep_state, bilinear)
    if planes.device.type != "cpu":
        raise ValueError(f"unsupported device {planes.device}")
    out, state = sky_compose_plain(planes, total, cubemap, keep_state, bilinear)
    if total is not None and not keep_state:
        out = total.copy_(out)
    return out, state


class SkyComposeFunction(torch.autograd.Function):
    """One sample's sky lookup, compose and running sum as a differentiable
    function of its (10,H,W) planes and the (H,W,3) running sum before it
    (None for the first sample). The sky is constant.

    forward: the forward kernel (sky_compose_plain on the CPU), keeping the
    sample's compact state (sky_state_planes planes a pixel) and no view of
    the planes. backward: the adjoint kernel (sky_compose_adjoint_plain
    on the CPU) writes the planes' cotangent, with `bilinear` the miss
    direction's too; the running sum's passes through."""

    @staticmethod
    def forward(ctx, planes, total, cubemap, bilinear):
        out, state = _sky_compose_forward(
            planes.detach(), None if total is None else total.detach(), cubemap,
            keep_state=True, bilinear=bilinear)
        ctx.save_for_backward(state)
        ctx.cubemap, ctx.bilinear = cubemap, bilinear
        ctx.chained = total is not None
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_total):
        (state,) = ctx.saved_tensors
        with span("kernel.sky_compose_adjoint"):
            if state.device.type == "cuda":
                g_planes = _launch_sky_compose_adjoint(g_total, state, ctx.cubemap, ctx.bilinear)
            else:
                g_planes = sky_compose_adjoint_plain(g_total, state, ctx.cubemap, ctx.bilinear)
        return g_planes, (g_total if ctx.chained else None), None, None


def sky_compose(planes, total, cubemap: CubemapData, bilinear: bool = False):
    """total + rgb: one sample's sky lookup (nearest texel, or with
    `bilinear` the bilinear filter), compose_sky and running sum
    (sky_compose_plain says what each argument is). Through
    SkyComposeFunction where the planes or the sum require grad; otherwise
    the forward alone, adding into `total` in place."""
    if torch.is_grad_enabled() and (planes.requires_grad
                                    or (total is not None and total.requires_grad)):
        return SkyComposeFunction.apply(planes, total, cubemap, bilinear)
    return _sky_compose_forward(planes, total, cubemap, keep_state=False, bilinear=bilinear)[0]


def _miss_texel_index(cubemap: CubemapData, planes):
    """(flat texel index of the miss direction, miss flag) of one sample's
    planes; integers, outside autograd's graph."""
    with torch.no_grad():
        flat = texel_flat_index(cubemap, Vec3(planes[3], planes[4], planes[5]))
        return flat, planes[9] > 0.5


def _soft_silhouettes(job: TileJob, rgb, cubemap: CubemapData, row0: int,
                      plain: bool = False):
    """The job's frame `rgb` ((H,W,3) or a Vec3) blended with the soft
    primary visibility, with fresh unjittered primary rays from the camera
    pack, in a span "soft_silhouettes" that counts the scene's `objects` and
    the frame's `pixels`: through soft_silhouettes (one launch of the
    kernel, and under grad one of its adjoint) where fused_soft_silhouettes
    holds and `plain` is off, else render/integrator.py::
    soft_silhouette_composite (a Vec3)."""
    # imported here: render/integrator.py builds its renderer on this module
    from ray_tracing_tpu_torch.render.integrator import soft_silhouette_composite

    shape = (job.height, job.width)
    view = SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    with span("soft_silhouettes", objects=view.num_objects, pixels=job.height * job.width):
        if not plain and fused_soft_silhouettes(job, cubemap):
            total = rgb.to_array() if isinstance(rgb, Vec3) else rgb
            return soft_silhouettes(job, total.contiguous(), cubemap, row0)
        if not isinstance(rgb, Vec3):
            rgb = Vec3(*rgb.unbind(-1))
        u, v = _tile_uv(job.width, job.height, job.norm_height, row0, job.rows.device)
        ro0, rd0 = camera_rays_from_pack(job.cam_pack, u, v, shape)
        return soft_silhouette_composite(view, ro0, rd0, rgb, job.config, cubemap)


# ---------------------------------------------------------------------------
# The soft silhouettes: the kernels' wrappers, their plain version and the
# autograd boundary
# ---------------------------------------------------------------------------


def fused_soft_silhouettes(job: TileJob, cubemap: CubemapData) -> bool:
    """Whether _soft_silhouettes takes the kernels (csrc/sky_compose.cu): a
    frame on the card, of a sky that no gradient asks for (the kernels take
    the sky as a constant). The CPU and a sky that requires grad keep
    render/integrator.py::soft_silhouette_composite; so does the plain
    reference render_image, whose render_frame passes plain_sky."""
    return job.rows.device.type == "cuda" and not _sky_requires_grad(cubemap)


@dataclasses.dataclass(frozen=True)
class SoftPixels:
    """Per pixel what the composite out = result * alpha + bg * (1 - alpha)
    of the soft silhouettes takes, as the kernels find it: the unjittered
    primary ray (ro, the unnormalised rd, d = normalize(rd); cu, cv its
    screen offsets), the hard hit; `geo` the object whose coverage alpha is
    (the winner where it covers, the best outside coverage on a miss; -1:
    alpha is a constant); `mat` the object whose albedo and emission make
    the proxy x = emission + albedo * sky0 (the runner-up of a hit, the
    best outside coverage of a miss; -1: none, zeros); `proxy` whether bg is
    clip(x) (else the sky); the sky `s` at d before its clip, sky0 after
    it, and bg."""

    u: torch.Tensor
    v: torch.Tensor
    cu: torch.Tensor
    cv: torch.Tensor
    ro: Vec3
    rd: Vec3
    d: Vec3
    hit: torch.Tensor
    proxy: torch.Tensor
    geo: torch.Tensor
    mat: torch.Tensor
    alpha: torch.Tensor
    s: Vec3
    sky0: Vec3
    x: Vec3
    bg: Vec3


def _sphere_cover(ro: Vec3, d: Vec3, center: Vec3, r, temp: float):
    """(coverage, along) of a sphere, as the composite computes them: the
    sigmoid of the perpendicular-distance margin over temp * radius, and the
    centre's distance along the ray."""
    oc = center - ro
    along = oc.dot(d)
    d_perp = torch.sqrt(torch.clamp(oc.norm2() - along * along, min=1e-12))
    return torch.sigmoid((r - d_perp) / (temp * torch.clamp(r, min=1e-6))), along


def _slab_cover(ro: Vec3, d: Vec3, lo: Vec3, hi: Vec3, temp: float) -> dict:
    """A box's coverage (render/integrator.py::_soft_slab_coverage, in its
    operations) and the steps its adjoint reads: per axis the slab quotients
    ta, tb over `safe` (1 on an axis-parallel ray: `zero`) and tmin, tmax
    after the parallel rays' selects; near, far and their first pairs, the
    margin before and after its clamp, the mean extent, q, z and the
    coverage `a`."""
    slabs = []
    for lo_c, hi_c, ro_c, d_c in ((lo.x, hi.x, ro.x, d.x), (lo.y, hi.y, ro.y, d.y),
                                  (lo.z, hi.z, ro.z, d.z)):
        zero = d_c == 0.0
        safe = torch.where(zero, torch.ones_like(d_c), d_c)
        ta = (lo_c - ro_c) / safe
        tb = (hi_c - ro_c) / safe
        inside = (ro_c > lo_c) & (ro_c < hi_c)
        tmin = torch.where(zero, torch.where(inside, -BIG, BIG), torch.minimum(ta, tb))
        tmax = torch.where(zero, torch.where(inside, BIG, -BIG), torch.maximum(ta, tb))
        slabs.append({"zero": zero, "safe": safe, "ta": ta, "tb": tb, "tmin": tmin,
                      "tmax": tmax})
    c = {"slabs": slabs}
    c["near1"] = torch.maximum(slabs[0]["tmin"], slabs[1]["tmin"])
    c["near"] = torch.maximum(c["near1"], slabs[2]["tmin"])
    c["far1"] = torch.minimum(slabs[0]["tmax"], slabs[1]["tmax"])
    c["far"] = torch.minimum(c["far1"], slabs[2]["tmax"])
    c["m0"] = c["far"] - torch.clamp(c["near"], min=0.0)
    c["size3"] = (hi.x - lo.x + hi.y - lo.y + hi.z - lo.z) / 3.0
    c["q"] = temp * torch.clamp(c["size3"], min=1e-6)
    c["m1"] = torch.maximum(c["m0"], -60.0 * c["q"])
    c["m"] = torch.minimum(c["m1"], 60.0 * c["q"])
    c["z"] = c["m"] / c["q"]
    c["a"] = torch.sigmoid(c["z"])
    return c


def soft_pixels(job: TileJob, cubemap: CubemapData, row0: int = 0) -> SoftPixels:
    """The SoftPixels of the job's frame (rows row0 .. of a norm_height-tall
    frame): the plain version of what both kernels find per pixel, with the
    composite's operations, so that its alpha and bg are the composite's bit
    for bit. Its loop keeps the objects' indices where the composite's
    selects keep their values."""
    cfg = job.config
    temp = cfg.soft_silhouette_temp
    shape = (job.height, job.width)
    dev = job.rows.device
    view = SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    u, v = _tile_uv(job.width, job.height, job.norm_height, row0, dev)
    cam = job.cam_pack
    ro, rd = camera_rays_from_pack(cam, u, v, shape)
    d = rd.normalize()
    a = d.dot(d)
    inv2a = 0.5 / a
    inv = ray_inverses(d)
    h0 = trace(view, ro, rd)
    hit = h0.hit
    alpha = torch.where(hit, 1.0, 0.0)
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    none = torch.full(shape, -1, dtype=torch.int64, device=dev)
    geo, second, best = none, none, none
    t2 = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    a_out = zeros
    for i in range(view.num_objects):
        winner = (h0.obj == i) & hit
        if view.is_sphere(i):
            a_i, along = _sphere_cover(ro, d, view.center(i), view.radius(i), temp)
            front = along > 0
            t_i = intersect_sphere(ro, d, a, view.center(i), view.radius(i), inv2a=inv2a)
        else:
            a_i = _slab_cover(ro, d, view.box_lo(i), view.box_hi(i), temp)["a"]
            front = torch.ones_like(hit)
            t_i, _ = intersect_cube(ro, d, view.box_lo(i), view.box_hi(i), inv=inv)
        take = winner & front
        alpha = torch.where(take, a_i, alpha)
        geo = torch.where(take, i, geo)
        cover = torch.where(front, a_i, 0.0)
        better = ~hit & (cover > a_out)
        a_out = torch.where(better, cover, a_out)
        best = torch.where(better, i, best)
        tt = torch.where(winner, BIG, t_i)
        w2 = tt < t2
        t2 = torch.where(w2, tt, t2)
        second = torch.where(w2, i, second)
    miss = ~hit
    has2 = t2 < HIT_THRESHOLD
    alpha = torch.where(miss, 1.0 - a_out, alpha)
    geo = torch.where(miss, best, geo)
    mat = torch.where(miss, best, torch.where(has2, second, -1))
    proxy = miss | has2
    s = sample_cubemap(cubemap, d, bilinear=cfg.env_filter == "bilinear")
    sky0 = s.clip(0.0, 1.0)
    alb, emis = _mat_rows(job.rows, mat, 6), _mat_rows(job.rows, mat, 12)
    x = emis + alb * sky0
    bg = Vec3.where(proxy, x.clip(0.0, 1.0), sky0)
    cu = (u - 0.5) * cam[12]
    cv = (v - 0.5) * cam[13]
    return SoftPixels(u, v, cu, cv, ro, rd, d, hit, proxy, geo, mat, alpha, s, sky0, x, bg)


def _mat_rows(rows, obj, col: int) -> Vec3:
    """Columns col .. col + 2 of each pixel's object `obj`, 0 where it is -1."""
    some = obj >= 0
    k = obj.clamp(min=0)
    return Vec3(*(torch.where(some, rows[k, col + c], 0.0) for c in range(3)))


def soft_silhouettes_plain(job: TileJob, result, cubemap: CubemapData, row0: int = 0):
    """The plain PyTorch version of the forward kernel: the (H,W,3) colour
    `result` of the job's frame blended with the soft primary visibility,
    result * alpha + bg * (1 - alpha) (soft_pixels); what
    render/integrator.py::soft_silhouette_composite gives, bit for bit."""
    p = soft_pixels(job, cubemap, row0)
    return (Vec3(*result.unbind(-1)) * p.alpha + p.bg * (1.0 - p.alpha)).to_array()


def _clip_pass(x, g):
    """The cotangent min(max(x, 0), 1) passes: all, half exactly on 0 or 1,
    none outside (_clip_code)."""
    code = _clip_code(x)
    return torch.where(code == SKY_CLIP_FULL, g, torch.where(code == SKY_CLIP_HALF, g * 0.5, 0.0))


def _min_adjoint(a, b, g):
    """torch.minimum's backward: the cotangent to the smaller input, half of
    it to each on a tie."""
    half = g * 0.5
    return (torch.where(a == b, half, torch.where(a < b, g, 0.0)),
            torch.where(a == b, half, torch.where(b < a, g, 0.0)))


def _max_adjoint(a, b, g):
    """torch.maximum's backward, as _min_adjoint."""
    half = g * 0.5
    return (torch.where(a == b, half, torch.where(a > b, g, 0.0)),
            torch.where(a == b, half, torch.where(b > a, g, 0.0)))


def _sphere_cover_adjoint(r16, ro: Vec3, d: Vec3, temp: float, ga):
    """From ga, the cotangent of each pixel's sphere coverage (the sphere's
    row r16, (H,W,16)): (cotangents of row columns 0-3, of d, of ro), in
    autograd's steps through _sphere_cover."""
    oc = Vec3(r16[..., 0], r16[..., 1], r16[..., 2]) - ro
    along = oc.dot(d)
    pd2 = oc.dot(oc) - along * along
    d_perp = torch.sqrt(torch.clamp(pd2, min=1e-12))
    r = r16[..., 3]
    den = torch.clamp(r, min=1e-6) * temp
    z = (r - d_perp) / den
    a = torch.sigmoid(z)
    gz = (ga * (1.0 - a)) * a
    g_num = gz / den
    g_r = torch.where(r >= 1e-6, g_num + (-gz * (z / den)) * temp, g_num)
    g_pd2 = torch.where(pd2 >= 1e-12, -g_num / (2.0 * d_perp), 0.0)
    g_along = (-g_pd2 * along) * 2.0
    g_oc = d * g_along + oc * (2.0 * g_pd2)
    return [g_oc.x, g_oc.y, g_oc.z, g_r], oc * g_along, -g_oc


def _slab_cover_adjoint(r16, ro: Vec3, d: Vec3, temp: float, ga):
    """The same for each pixel's box: cotangents of row columns 0-5 (origin,
    size; hi = origin + size), of d and of ro, through _slab_cover."""
    lo = Vec3(r16[..., 0], r16[..., 1], r16[..., 2])
    hi = Vec3(r16[..., 0] + r16[..., 3], r16[..., 1] + r16[..., 4], r16[..., 2] + r16[..., 5])
    c = _slab_cover(ro, d, lo, hi, temp)
    gz = (ga * (1.0 - c["a"])) * c["a"]
    g_m = gz / c["q"]
    g_q = -gz * (c["z"] / c["q"])
    g_m1, g_hi = _min_adjoint(c["m1"], c["q"] * 60.0, g_m)
    g_m0, g_lo = _max_adjoint(c["m0"], c["q"] * -60.0, g_m1)
    g_q = g_q + (g_hi * 60.0 + g_lo * -60.0)
    g_size = torch.where(c["size3"] >= 1e-6, (g_q * temp) * (1.0 / 3.0), 0.0)
    g_near = torch.where(c["near"] >= 0, -g_m0, 0.0)
    sl = c["slabs"]
    g_far1, g_tmax2 = _min_adjoint(c["far1"], sl[2]["tmax"], g_m0)
    g_tmax0, g_tmax1 = _min_adjoint(sl[0]["tmax"], sl[1]["tmax"], g_far1)
    g_near1, g_tmin2 = _max_adjoint(c["near1"], sl[2]["tmin"], g_near)
    g_tmin0, g_tmin1 = _max_adjoint(sl[0]["tmin"], sl[1]["tmin"], g_near1)
    g_row = [None] * 6
    g_o, g_dc = [], []
    for k, (g_n, g_x) in enumerate(((g_tmin0, g_tmax0), (g_tmin1, g_tmax1),
                                    (g_tmin2, g_tmax2))):
        s = sl[k]
        ga1, gb1 = _min_adjoint(s["ta"], s["tb"], g_n)
        ga2, gb2 = _max_adjoint(s["ta"], s["tb"], g_x)
        g_ta, g_tb = ga1 + ga2, gb1 + gb2
        live = ~s["zero"]
        g_lo_k = torch.where(live, -g_size + g_ta / s["safe"], -g_size)
        g_hi_k = torch.where(live, g_size + g_tb / s["safe"], g_size)
        g_o.append(torch.where(live, -(g_ta / s["safe"]) - g_tb / s["safe"], 0.0))
        g_dc.append(torch.where(live, -g_ta * (s["ta"] / s["safe"])
                                + -g_tb * (s["tb"] / s["safe"]), 0.0))
        g_row[k] = g_lo_k + g_hi_k
        g_row[3 + k] = g_hi_k
    return g_row, Vec3(*g_dc), Vec3(*g_o)


def _soft_adjoint_terms(job: TileJob, g_out, result, cubemap: CubemapData, row0: int):
    """Per pixel what soft_silhouettes_adjoint_plain sums: (the colour's
    cotangent, the pixels' `geo` and their (H,W,6) cotangents of its row
    columns 0-5 (-1 where alpha is a constant), the pixels' `mat` and their
    (H,W,6) cotangents of its albedo and emission (-1 where bg is the sky or
    no object's proxy), their (H,W,16) cotangents of the camera pack)."""
    temp = job.config.soft_silhouette_temp
    p = soft_pixels(job, cubemap, row0)
    rows = job.rows
    g = g_out.unbind(-1)
    res = result.unbind(-1)
    bg, x, sky0 = (p.bg.x, p.bg.y, p.bg.z), (p.x.x, p.x.y, p.x.z), (p.sky0.x, p.sky0.y, p.sky0.z)
    g_result = g_out * p.alpha[..., None]
    g_alpha = (g[0] * res[0] + g[1] * res[1] + g[2] * res[2]) \
        - (g[0] * bg[0] + g[1] * bg[1] + g[2] * bg[2])
    keep = 1.0 - p.alpha
    alb = _mat_rows(rows, p.mat, 6)
    some = p.mat >= 0
    g_alb, g_emis, g_sky0 = [], [], []
    for ch, a_c in enumerate((alb.x, alb.y, alb.z)):
        g_bg = g[ch] * keep
        gx = _clip_pass(x[ch], g_bg)
        g_alb.append(gx * sky0[ch])
        g_emis.append(gx)
        g_sky0.append(torch.where(p.proxy, torch.where(some, gx * a_c, 0.0), g_bg))
    has_geo = p.geo >= 0
    r16 = rows[p.geo.clamp(min=0)]
    g_cov = torch.where(p.hit, g_alpha, -g_alpha)
    sph_row, sph_d, sph_ro = _sphere_cover_adjoint(r16, p.ro, p.d, temp, g_cov)
    box_row, box_d, box_ro = _slab_cover_adjoint(r16, p.ro, p.d, temp, g_cov)
    is_sph = r16[..., 15] == OBJ_SPHERE
    zero = torch.zeros_like(p.alpha)
    zero3 = Vec3(zero, zero, zero)
    g_geo = [torch.where(has_geo, torch.where(is_sph, sph_row[k] if k < 4 else zero, box_row[k]),
                         zero) for k in range(6)]
    sph, box = has_geo & is_sph, has_geo & ~is_sph
    g_d = Vec3.where(sph, sph_d, Vec3.where(box, box_d, zero3))
    g_ro = Vec3.where(sph, sph_ro, Vec3.where(box, box_ro, zero3))
    if _bilinear_arm(job.config.env_filter == "bilinear", cubemap):
        s = (p.s.x, p.s.y, p.s.z)
        g_s = Vec3(*(_clip_pass(s[ch], g_sky0[ch]) for ch in range(3)))
        g_d = g_d + bilinear_adjoint(cubemap, p.d, g_s)
    n = torch.sqrt(p.rd.dot(p.rd))
    inv = 1.0 / n
    g_n = -g_d.dot(p.rd) * (inv * inv)
    g_rd = Vec3.where(n < NORMALIZE_EPS, g_d, g_d * inv + p.rd * (2.0 * (g_n / (2.0 * n))))
    cam = job.cam_pack
    ub, vb = Vec3(cam[3], cam[4], cam[5]), Vec3(cam[6], cam[7], cam[8])
    g_cam = torch.stack([
        g_ro.x, g_ro.y, g_ro.z, p.cu * g_rd.x, p.cu * g_rd.y, p.cu * g_rd.z,
        p.cv * g_rd.x, p.cv * g_rd.y, p.cv * g_rd.z, -g_rd.x, -g_rd.y, -g_rd.z,
        g_rd.dot(ub) * (p.u - 0.5), g_rd.dot(vb) * (p.v - 0.5), zero, zero], dim=-1)
    mat = torch.where(some & p.proxy, p.mat, -1)
    return (g_result, torch.where(has_geo, p.geo, -1), torch.stack(g_geo, dim=-1), mat,
            torch.stack([*g_alb, *g_emis], dim=-1), g_cam)


def _sum_adjoint_terms(rows, terms, magnitude: bool = False):
    """(rows' cotangent (N,16), camera's (16,)) summed from
    _soft_adjoint_terms over the pixels; with `magnitude` the sums of the
    terms' magnitudes."""
    _, geo, g_geo, mat, g_mat, g_cam = terms
    if magnitude:
        g_geo, g_mat, g_cam = g_geo.abs(), g_mat.abs(), g_cam.abs()
    g_rows = torch.zeros_like(rows)
    on = (geo >= 0).reshape(-1)
    g_rows[:, 0:6].index_put_((geo.reshape(-1)[on],), g_geo.reshape(-1, 6)[on], accumulate=True)
    on = (mat >= 0).reshape(-1)
    flat = g_mat.reshape(-1, 6)[on]
    g_rows[:, 6:9].index_put_((mat.reshape(-1)[on],), flat[:, :3], accumulate=True)
    g_rows[:, 12:15].index_put_((mat.reshape(-1)[on],), flat[:, 3:], accumulate=True)
    return g_rows, g_cam.reshape(-1, 16).sum(dim=0)


def soft_silhouettes_adjoint_plain(job: TileJob, g_out, result, cubemap: CubemapData,
                                   row0: int = 0):
    """The plain PyTorch version of the adjoint kernel, written out by hand:
    from the (H,W,3) cotangent g_out of soft_silhouettes_plain's result,
    (the cotangent of `result`, of the scene rows (N,16), of the camera pack
    (16,)). The composite is found again (soft_pixels); alpha's cotangent
    goes through the coverage of `geo` to its row's centre and radius or
    origin and size, and to d and ro; bg's through the proxy's clip to the
    albedo and emission of `mat` and to the sky, whose bilinear lookup takes
    it to d (ops/cubemap.py::bilinear_adjoint); d's through normalize and
    the primary ray to the camera pack. Each step is autograd's over the
    composite; the sums over pixels come in another order."""
    terms = _soft_adjoint_terms(job, g_out, result, cubemap, row0)
    return (terms[0], *_sum_adjoint_terms(job.rows, terms))


def soft_silhouettes_adjoint_scale(job: TileJob, g_out, result, cubemap: CubemapData,
                                   row0: int = 0):
    """(rows (N,16), camera (16,)): the sums over the pixels of the
    magnitudes of the terms the adjoint adds into each cotangent, the
    yardstick for a sum of the same terms in another order."""
    return _sum_adjoint_terms(job.rows, _soft_adjoint_terms(job, g_out, result, cubemap, row0),
                              magnitude=True)


def _soft_args(job: TileJob, cubemap: CubemapData, row0: int):
    """The C arguments of the kernels after their tensors and before their
    outputs: the sky, its arm, the objects, the frame and the temperature."""
    _check_job(job)
    sky = _sky_pointers(cubemap, job.rows.device)
    arm = _bilinear_arm(job.config.env_filter == "bilinear", cubemap)
    return (*sky, int(arm), len(job.obj_type), job.width, job.height, job.norm_height,
            int(row0), float(job.config.soft_silhouette_temp))


_SOFT_ARGS = [ctypes.c_int] * 8 + [ctypes.c_float]


def _launch_soft_silhouettes(job: TileJob, result, cubemap: CubemapData, row0: int = 0):
    """Launch the forward kernel on PyTorch's current stream: the (H,W,3)
    result of soft_silhouettes_plain. Does not synchronise; raises when the
    launch is refused."""
    dev = job.rows.device
    frame = (job.height, job.width)
    _check_tensor("colour", result, (*frame, 3), torch.float32, dev)
    args = _soft_args(job, cubemap, row0)
    lib, fn = _load(SKY_COMPOSE_LIBRARY, "rt_soft_silhouettes",
                    [ctypes.c_void_p] * 7 + _SOFT_ARGS + [ctypes.c_void_p] * 2)
    with torch.cuda.device(dev):
        out = torch.empty((*frame, 3), dtype=torch.float32, device=dev)
        err = fn(result.data_ptr(), job.rows.data_ptr(), job.cam_pack.data_ptr(), *args,
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "soft_silhouettes")
    launch_counts["soft_silhouettes"] += 1
    return out


def _launch_soft_silhouettes_adjoint(job: TileJob, g_out, result, cubemap: CubemapData,
                                     row0: int = 0, rows_grad: bool = True,
                                     cam_grad: bool = True):
    """Launch the adjoint kernel on PyTorch's current stream: the cotangents
    of soft_silhouettes_adjoint_plain, None for the rows without `rows_grad`
    and for the camera without `cam_grad` (the kernel then writes none).
    Does not synchronise; raises when the launch is refused."""
    dev = job.rows.device
    frame = (job.height, job.width)
    _check_tensor("colour", result, (*frame, 3), torch.float32, dev)
    # autograd may hand over an expanded or strided cotangent
    g_out = g_out.contiguous()
    _check_tensor("composite's cotangent", g_out, (*frame, 3), torch.float32, dev)
    args = _soft_args(job, cubemap, row0)
    lib, fn = _load(SKY_COMPOSE_LIBRARY, "rt_soft_silhouettes_adjoint",
                    [ctypes.c_void_p] * 8 + _SOFT_ARGS + [ctypes.c_void_p] * 4)
    with torch.cuda.device(dev):
        g_result = torch.empty((*frame, 3), dtype=torch.float32, device=dev)
        g_rows = torch.zeros_like(job.rows) if rows_grad else None
        g_cam = torch.zeros_like(job.cam_pack) if cam_grad else None
        err = fn(g_out.data_ptr(), result.data_ptr(), job.rows.data_ptr(),
                 job.cam_pack.data_ptr(), *args, g_result.data_ptr(),
                 None if g_rows is None else g_rows.data_ptr(),
                 None if g_cam is None else g_cam.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "soft_silhouettes_adjoint")
    launch_counts["soft_silhouettes_adjoint"] += 1
    return g_result, g_rows, g_cam


class SoftSilhouetteFunction(torch.autograd.Function):
    """The soft silhouettes' composite of a frame as a differentiable
    function of its (H,W,3) colour, the scene rows and the camera pack. The
    sky is constant.

    forward: the forward kernel (soft_silhouettes_plain on the CPU), keeping
    the colour and no graph. backward: the adjoint kernel
    (soft_silhouettes_adjoint_plain on the CPU) finds the composite again
    and writes the cotangents of the colour and of those of the rows and
    the camera that require grad."""

    @staticmethod
    def forward(ctx, result, rows, cam_pack, job, cubemap, row0):
        job = dataclasses.replace(job, rows=rows.detach(), cam_pack=cam_pack.detach())
        if rows.device.type == "cuda":
            out = _launch_soft_silhouettes(job, result.detach(), cubemap, row0)
        else:
            out = soft_silhouettes_plain(job, result.detach(), cubemap, row0)
        ctx.save_for_backward(result, rows, cam_pack)
        ctx.job = dataclasses.replace(job, rows=None, cam_pack=None)
        ctx.cubemap, ctx.row0 = cubemap, row0
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        result, rows, cam_pack = ctx.saved_tensors
        want_rows, want_cam = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        job = dataclasses.replace(ctx.job, rows=rows.detach(), cam_pack=cam_pack.detach())
        with span("kernel.soft_silhouettes_adjoint"):
            if rows.device.type == "cuda":
                g_result, g_rows, g_cam = _launch_soft_silhouettes_adjoint(
                    job, g_out, result.detach(), ctx.cubemap, ctx.row0, want_rows, want_cam)
            else:
                g_result, g_rows, g_cam = soft_silhouettes_adjoint_plain(
                    job, g_out, result.detach(), ctx.cubemap, ctx.row0)
        return (g_result if ctx.needs_input_grad[0] else None,
                g_rows if want_rows else None, g_cam if want_cam else None, None, None, None)


def soft_silhouettes(job: TileJob, result, cubemap: CubemapData, row0: int = 0):
    """The (H,W,3) colour `result` of the job's frame (rows row0 .. of a
    norm_height-tall frame) blended with the soft primary visibility:
    through SoftSilhouetteFunction where the colour, the scene rows or the
    camera pack require grad, else the forward alone (the kernel on the
    card, soft_silhouettes_plain on the CPU)."""
    if torch.is_grad_enabled() and (result.requires_grad or job.rows.requires_grad
                                    or job.cam_pack.requires_grad):
        return SoftSilhouetteFunction.apply(result, job.rows, job.cam_pack, job, cubemap, row0)
    if job.rows.device.type == "cuda":
        return _launch_soft_silhouettes(job, result, cubemap, row0)
    return soft_silhouettes_plain(job, result, cubemap, row0)


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
                 cubemap: CubemapData, row0: int = 0, first_sample: int = 0,
                 frame_spp: int | None = None, plain_sky: bool = False):
    """(H, W, 3) image: `spp` samples through `tiles_fn`, each composed with
    its sky and clipped BEFORE the average; the samples are first_sample ..
    of a frame of `frame_spp` (frame_sample_seeds). With
    soft_silhouette_temp > 0 the average is then blended with the soft
    primary visibility; the blend is affine in the colour and the same for
    every sample, so blending the average equals averaging the blended
    samples.

    Each sample takes one of two sky steps. Where fused_sky_compose holds
    and `plain_sky` is off, its sky lookup, compose and running sum are one
    sky_compose in a span "compose" that counts the `texels` gathered (one
    a pixel; four for the bilinear filter on a sky larger than 1x1).
    Otherwise it opens a span "sky_lookup" (sky_lookup, which counts its
    `texels` alike) and a span "compose" (compose_sky and the running sum).
    The caller picks the sky step as it picks `tiles_fn`: the plain
    reference render_image passes plain_sky=True, so that its frame holds
    the kernel to the plain lookup on any device. The frame ends in a span
    "average"."""
    if spp < 1:
        raise ValueError("spp must be at least 1")
    cfg = job.config
    fused = not plain_sky and fused_sky_compose(cubemap)
    bilinear = cfg.env_filter == "bilinear"
    pixels = job.height * job.width
    total = None
    for s in frame_sample_seeds(seed, spp, first_sample, frame_spp):
        planes, _ = tiles_fn(job, s, row0)
        if fused:
            with span("compose", texels=pixels * (4 if _bilinear_arm(bilinear, cubemap) else 1)):
                total = sky_compose(planes, total, cubemap, bilinear=bilinear)
        else:
            sky = sky_lookup(planes, cubemap, cfg, pixels)
            with span("compose"):
                rgb = compose_sky(planes, sky)
                total = rgb if total is None else total + rgb
    with span("average"):
        if spp > 1:
            total = total * (1.0 / spp)
        if cfg.soft_silhouette_temp > 0:
            total = _soft_silhouettes(job, total, cubemap, row0, plain=plain_sky)
        return total.to_array() if isinstance(total, Vec3) else total


def render_image_cuda(scene: Scene, camera: Camera, width: int, height: int,
                      seed: int = 0, spp: int = 1,
                      config: RenderConfig = DEFAULT_CONFIG,
                      cubemap: CubemapData | None = None, row0: int = 0,
                      norm_height: int | None = None,
                      aspect: float | None = None, first_sample: int = 0,
                      frame_spp: int | None = None, device=None):
    """Full render through the CUDA megakernel and, per sample, the sky
    compose kernel (sky_compose, at the nearest texel or bilinear; the plain
    lookup for a sky that requires grad): (height, width, 3) float32 in
    [0, 1] on the device.

    Takes the statistics of render_image (render/integrator.py) and the
    very same random numbers. Differentiable end to end: when a leaf of
    `scene` or `camera` requires grad, backward() runs a backward kernel per
    sample (effective_bwd_mode says which mode, backward_kernel which
    kernel); in "fetch" each sample's forward is the recording kernel, and
    each sample keeps its winner-index planes until backward(): n_rec*H*W
    entries of record_dtype(N), one byte each up to 127 objects, two above.
    row0/norm_height/aspect as in render_tiles_cuda. first_sample and
    frame_spp make the `spp` samples a share of a larger frame's
    (frame_sample_seeds): parallel/render.py hands each mesh cell its own.
    device=None means the card and raises without one; device="cpu" runs
    the plain versions."""
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
        return render_frame(job, run_tiles_grad, seed, spp, cubemap, row0,
                            first_sample=first_sample, frame_spp=frame_spp)
