"""The forward megakernel of the port: its plain PyTorch version, the wrapper
of the CUDA kernel, and the renderer built on it.

Counterpart of ``ray_tracing_tpu/kernels/megakernel.py`` (forward half).
Where each piece of that file went:

    JAX package (kernels/megakernel.py)        here
    ------------------------------------------ ---------------------------
    SceneView                     :121-189     SceneView
    _uniform, StreamingDraws      :197-243     ops/sampling.py (PhiloxDraws:
                                               same shadow/direction/branch
                                               contract, slots not a stream)
    camera_rays_from_pack         :290-305     camera_rays_from_pack
    DirectTracer                  :308-324     DirectTracer
    IndexRecordingTracer          :347-368     IndexRecordingTracer
    tile_physics                  :448-541     tile_physics
    _tile_uv                      :544-563     _tile_uv
    _seed_tile                    :566-571     none (draws are keyed by
                                               pixel and slot)
    _fwd_kernel                   :579-616     csrc/megakernel_fwd.cu and
                                               run_tiles_plain
    _record_layout                :1057-1075   record_layout
    _run_fwd                      :1078-1111   _launch_fwd
    _camera_pack                  :1240-1255   render/camera.py camera_pack
    render_tiles_pallas           :1258-1316   render_tiles_cuda
    render_image_pallas           :1319-1492   render_image_cuda

Order of the winner-index planes (record_layout), as in the JAX package: for
each bounce one primary plane, then, when next-event estimation runs, one
plane per shadow sample: plane ``b*(1+ns)`` is bounce b's closest hit, plane
``b*(1+ns)+1+s`` its shadow sample s; -1 is a miss. Without a light (or with
``shadow_samples == 0``) there are ``bounces`` planes.

``tile_physics`` + ``_tile_uv`` + ``PhiloxDraws`` are the plain version of
the CUDA kernel. ``render_tiles_cuda`` takes the plain version only for
tensors that lie on the CPU; on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels import build
from ray_tracing_tpu_torch.ops.cubemap import CubemapData, constant_sky, sample_cubemap
from ray_tracing_tpu_torch.ops.intersect import (
    _single_emissive_index,
    trace,
    trace_shadow,
    trace_shadow_record,
)
from ray_tracing_tpu_torch.ops.sampling import PhiloxDraws, global_pixel_index
from ray_tracing_tpu_torch.ops.vec import Vec3, div_scalar, fresnel_schlick
from ray_tracing_tpu_torch.render.camera import Camera, camera_pack, pixel_grid
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, SCENE_COLS, Scene, light_origin_from

PLANE_NAMES = ("r", "g", "b", "sx", "sy", "sz", "cr", "cg", "cb", "miss")
KERNEL_LIBRARY = "megakernel_fwd"

# How often each kernel was launched: one count per template instantiation,
# raised where the launch happens and nowhere else.
launch_counts = {"megakernel_fwd": 0, "megakernel_fwd_record": 0}


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
        r = self._r
        return light_origin_from(
            self.center(i), Vec3(r[i, 3], r[i, 4], r[i, 5]), self.is_sphere(i)
        )

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
        hit, emiss, obj = trace_shadow_record(self.scene, ro, rd)
        self.objs.append(obj)
        return hit, emiss


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
    module docstring."""
    ns = config.shadow_samples if has_light else 0
    return config.bounces * (1 + ns)


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


def make_tile_job(scene: Scene, camera: Camera, width: int, height: int,
                  config: RenderConfig = DEFAULT_CONFIG,
                  norm_height: int | None = None,
                  aspect: float | None = None) -> TileJob:
    if config.soft_silhouette_temp != 0:
        raise NotImplementedError(
            "soft_silhouette_temp is not part of the port yet; leave it at 0"
        )
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


def run_tiles_plain(job: TileJob, seed: int, row0: int = 0, record: bool = False):
    """The plain PyTorch version of the CUDA kernel, on whatever device the
    job's tensors lie: (planes (10,H,W) float32, records (n_rec,H,W) int32
    or None)."""
    cfg = job.config
    dev = job.rows.device
    shape = (job.height, job.width)
    u, v = _tile_uv(job.width, job.height, job.norm_height, row0, dev)
    gpix = global_pixel_index(job.width, job.height, row0, device=dev)
    draws = PhiloxDraws(_wrap_i32(seed), gpix, cfg, job.ns)
    if cfg.pixel_jitter:
        ju, jv = draws.jitter()
        u = u + div_scalar(ju - 0.5, float(max(job.width - 1, 1)))
        v = v + div_scalar(jv - 0.5, float(max(job.norm_height - 1, 1)))
    view = SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tracer = IndexRecordingTracer(view) if record else DirectTracer(view)
    outs = tile_physics(view, job.cam_pack, u, v, draws, cfg, shape, tracer=tracer)
    planes = torch.stack(outs)
    if not record:
        return planes, None
    recs = [o.reshape(-1, *shape) for o in tracer.objs]
    return planes, torch.cat(recs).to(torch.int32)


def _kernel_function():
    lib = build.load_library(KERNEL_LIBRARY)
    fn = lib.rt_megakernel_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_float] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.rt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


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


def _launch_fwd(job: TileJob, seed: int, row0: int, record: bool):
    """Launch the CUDA kernel on PyTorch's current stream. Does not
    synchronise; raises when the launch is refused."""
    cfg = job.config
    dev = job.rows.device
    n = len(job.obj_type)
    _check_tensor("scene rows", job.rows, (n, SCENE_COLS), torch.float32, dev)
    _check_tensor("camera pack", job.cam_pack, (16,), torch.float32, dev)
    if job.width < 1 or job.height < 1:
        raise ValueError(f"empty frame {job.width}x{job.height}")
    lib, fn = _kernel_function()
    with torch.cuda.device(dev):
        planes = torch.empty((10, job.height, job.width), dtype=torch.float32, device=dev)
        recs = None
        if record:
            n_rec = record_layout(cfg, job.light_index >= 0)
            recs = torch.empty((n_rec, job.height, job.width), dtype=torch.int32, device=dev)
        err = fn(
            job.rows.data_ptr(), job.cam_pack.data_ptr(), planes.data_ptr(),
            recs.data_ptr() if record else None,
            n, job.width, job.height, job.norm_height, int(row0), _wrap_i32(seed),
            job.light_index, job.single_emissive, cfg.bounces, job.ns,
            int(cfg.cube_biased_sampling), int(cfg.pixel_jitter),
            cfg.shadow_spread, cfg.light_sample_weight,
            1.0 - cfg.light_sample_weight, cfg.hit_offset,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        text = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"megakernel_fwd launch failed: {text} (cudaError {err})")
    launch_counts["megakernel_fwd_record" if record else "megakernel_fwd"] += 1
    return planes, recs


def run_tiles(job: TileJob, seed: int, row0: int = 0, record: bool = False):
    """One sample per pixel: the CUDA kernel for a job on the card, the
    plain version for a job on the CPU. Nothing else decides between them."""
    if job.rows.device.type == "cuda":
        return _launch_fwd(job, seed, row0, record)
    if job.rows.device.type != "cpu":
        raise ValueError(f"unsupported device {job.rows.device}")
    return run_tiles_plain(job, seed, row0, record)


def render_tiles_cuda(scene: Scene, camera: Camera, width: int, height: int,
                      seed: int, config: RenderConfig = DEFAULT_CONFIG,
                      row0: int = 0, norm_height: int | None = None,
                      aspect: float | None = None, record: bool = False,
                      device=None):
    """One sample per pixel over the (height, width) frame through the CUDA
    kernel. Returns a dict of (H,W) float32 planes named PLANE_NAMES; with
    record=True also "records", the (n_rec,H,W) int32 winner-index planes.

    row0/norm_height render a row SLICE of a norm_height-tall frame whose
    rows start at global row row0; aspect overrides the frustum's aspect
    ratio. device=None means the card; only device="cpu" runs the plain
    version."""
    device = resolve_device(device)
    job = make_tile_job(scene.to(device), camera.to(device), width, height,
                        config, norm_height, aspect)
    planes, recs = run_tiles(job, seed, row0, record)
    out = dict(zip(PLANE_NAMES, planes))
    if record:
        out["records"] = recs
    return out


# ---------------------------------------------------------------------------
# Full render: samples, sky lookup, compose
# ---------------------------------------------------------------------------


def sample_seeds(seed: int, spp: int) -> list[int]:
    """Per-sample seeds in wrapping int32: `seed` itself for one sample,
    seed*7919 + i otherwise."""
    if spp == 1:
        return [_wrap_i32(seed)]
    return [_wrap_i32(seed * 7919 + i) for i in range(spp)]


def compose(planes, cubemap: CubemapData, config: RenderConfig) -> Vec3:
    """Sky lookup on the miss directions, then clip(rgb + sky*throughput*
    miss, 0, 1): one sample's final colour."""
    r, g, b, sx, sy, sz, cr, cg, cb, miss = planes
    sky = sample_cubemap(cubemap, Vec3(sx, sy, sz),
                         bilinear=config.env_filter == "bilinear")
    rgb = Vec3(r, g, b) + sky * Vec3(cr, cg, cb) * miss
    return rgb.clip(0.0, 1.0)


def render_frame(job: TileJob, tiles_fn, seed: int, spp: int,
                 cubemap: CubemapData, row0: int = 0):
    """(H, W, 3) image: `spp` samples through `tiles_fn`, each composed with
    its sky and clipped BEFORE the average."""
    if spp < 1:
        raise ValueError("spp must be at least 1")
    total = None
    for s in sample_seeds(seed, spp):
        planes, _ = tiles_fn(job, s, row0)
        rgb = compose(planes, cubemap, job.config)
        total = rgb if total is None else total + rgb
    if spp > 1:
        total = total * (1.0 / spp)
    return total.to_array()


def render_image_cuda(scene: Scene, camera: Camera, width: int, height: int,
                      seed: int = 0, spp: int = 1,
                      config: RenderConfig = DEFAULT_CONFIG,
                      cubemap: CubemapData | None = None, row0: int = 0,
                      norm_height: int | None = None,
                      aspect: float | None = None, device=None):
    """Full render through the CUDA megakernel plus the sky lookup in
    PyTorch: (height, width, 3) float32 in [0, 1] on the device.

    Takes the statistics of render_image (render/integrator.py) and the
    very same random numbers. row0/norm_height/aspect as in
    render_tiles_cuda. device=None means the card and raises without one;
    device="cpu" runs the plain version."""
    device = resolve_device(device)
    if cubemap is None:
        cubemap = constant_sky(device=device)
    job = make_tile_job(scene.to(device), camera.to(device), width, height,
                        config, norm_height, aspect)
    return render_frame(job, run_tiles, seed, spp, cubemap.to(device), row0)
