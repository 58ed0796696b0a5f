"""The plain PyTorch renderer: the same pipeline as the CUDA path, through
the plain estimator.

Counterpart of ``ray_tracing_tpu/render/integrator.py::render_image``. One
estimator serves both of the port's renderers: ``render_image`` here and
``render_image_cuda`` (kernels/megakernel.py) share the packed scene, the
random numbers, the sky lookup and the compose step, and differ only in
whether a sample's ten planes come from ``tile_physics`` in PyTorch or from
the CUDA kernel. This is the CPU path (``--device cpu`` of the CLI) and what
the kernel is held against.

``soft_silhouette_composite`` (training only; ``config.soft_silhouette_temp``)
lives here too, as in the JAX package: plain PyTorch outside any kernel,
shared by both renderers through ``render_frame``.
"""

from __future__ import annotations

import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels.megakernel import (
    make_tile_job,
    render_frame,
    run_tiles_plain,
)
from ray_tracing_tpu_torch.ops.cubemap import CubemapData, constant_sky, sample_cubemap
from ray_tracing_tpu_torch.ops.intersect import (
    BIG,
    HIT_THRESHOLD,
    intersect_cube,
    intersect_sphere,
    ray_inverses,
    trace,
)
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.types import Scene


def render_image(scene: Scene, camera: Camera, width: int, height: int,
                 seed: int = 0, spp: int = 1,
                 config: RenderConfig = DEFAULT_CONFIG,
                 cubemap: CubemapData | None = None, row0: int = 0,
                 norm_height: int | None = None, aspect: float | None = None,
                 device=None):
    """Render a (height, width, 3) float32 frame in [0, 1], averaging `spp`
    samples, with plain PyTorch ops on `device`. Same arguments and, seed
    for seed, the same random numbers as render_image_cuda. device=None
    means the card and raises without one; device="cpu" is the CPU path."""
    device = resolve_device(device)
    if cubemap is None:
        cubemap = constant_sky(device=device)
    job = make_tile_job(scene.to(device), camera.to(device), width, height,
                        config, norm_height, aspect)
    return render_frame(job, run_tiles_plain, seed, spp, cubemap.to(device), row0)[0]


def _soft_slab_coverage(ro: Vec3, d: Vec3, lo: Vec3, hi: Vec3, temp: float):
    """Smooth coverage of an axis-aligned box along a ray: the sigmoid of
    the slab overlap margin (far - near, negative on a miss) over the box's
    mean extent. Axis-parallel rays take a select with finite partials, for
    the reason ops/intersect.py::ray_inverses gives."""

    def axis(lo_c, hi_c, ro_c, d_c):
        zero = d_c == 0.0
        safe = torch.where(zero, torch.ones_like(d_c), d_c)
        ta = (lo_c - ro_c) / safe
        tb = (hi_c - ro_c) / safe
        tmin = torch.minimum(ta, tb)
        tmax = torch.maximum(ta, tb)
        inside = (ro_c > lo_c) & (ro_c < hi_c)
        tmin = torch.where(zero, torch.where(inside, -BIG, BIG), tmin)
        tmax = torch.where(zero, torch.where(inside, BIG, -BIG), tmax)
        return tmin, tmax

    nx, xx = axis(lo.x, hi.x, ro.x, d.x)
    ny, xy = axis(lo.y, hi.y, ro.y, d.y)
    nz, xz = axis(lo.z, hi.z, ro.z, d.z)
    near = torch.maximum(torch.maximum(nx, ny), nz)
    far = torch.minimum(torch.minimum(xx, xy), xz)
    # the part behind the camera is no coverage
    margin = far - torch.clamp(near, min=0.0)
    size = torch.clamp((hi.x - lo.x + hi.y - lo.y + hi.z - lo.z) / 3.0, min=1e-6)
    # Deep-miss lanes carry +-BIG sentinels: far - near overflows to -inf and
    # the derivative of margin / q with respect to the size would be
    # 0 * inf = NaN. Clamp the MARGIN before the division (clamping the
    # quotient would leave the division's infinite partial in the graph):
    # sigmoid(+-60) is 0 or 1 in float32 and the clamp's derivative zeroes
    # those lanes, which is the right silhouette gradient for them anyway.
    q = temp * size
    margin = torch.minimum(torch.maximum(margin, -60.0 * q), 60.0 * q)
    return torch.sigmoid(margin / q)


def soft_silhouette_composite(scene, ro0: Vec3, rd0: Vec3, result: Vec3,
                              config: RenderConfig, cubemap: CubemapData) -> Vec3:
    """Soft primary visibility (training only): blend the traced radiance
    with what the primary ray would see WITHOUT its winner, the runner-up's
    local proxy radiance (emission + albedo-tinted sky) when there is one,
    else the sky. The winner's coverage is smooth for both kinds: a sphere's
    is the sigmoid of its perpendicular-distance margin, a cube's that of
    its slab-overlap margin. This supplies the silhouette gradient that
    detached decisions drop, object-over-object edges included. One loop
    over the objects serves every scene size. `scene` gives the accessors of
    Scene or of SceneView."""
    d0 = rd0.normalize()
    a = d0.dot(d0)
    inv2a = 0.5 / a
    inv = ray_inverses(d0)
    h0 = trace(scene, ro0, rd0)
    shape = tuple(h0.t.shape)
    dev = h0.t.device
    temp = config.soft_silhouette_temp

    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    zero3 = Vec3(zeros, zeros, zeros)
    alpha = torch.where(h0.hit, 1.0, 0.0)
    # nearest NON-winner hit along the primary ray: the surface revealed
    # when the winner's silhouette recedes
    t2 = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    alb2, emis2 = zero3, zero3
    # best OUTSIDE coverage for the pixels that miss (two-sided silhouette:
    # a pixel just outside the hard edge blends the near object's proxy in
    # with its sub-0.5 coverage, so the composite is continuous across the
    # edge and the geometry gets gradients from both sides of it)
    a_out = zeros
    alb_o, emis_o = zero3, zero3

    for i in range(scene.num_objects):
        winner = (h0.obj == i) & h0.hit
        if scene.is_sphere(i):
            oc = scene.center(i) - ro0
            along = oc.dot(d0)
            d_perp = torch.sqrt(torch.clamp(oc.norm2() - along * along, min=1e-12))
            r = scene.radius(i)
            a_i = torch.sigmoid((r - d_perp) / (temp * torch.clamp(r, min=1e-6)))
            alpha = torch.where(winner & (along > 0), a_i, alpha)
            cover = torch.where(along > 0, a_i, 0.0)
            t_i = intersect_sphere(ro0, d0, a, scene.center(i), r, inv2a=inv2a)
        else:
            a_i = _soft_slab_coverage(ro0, d0, scene.box_lo(i), scene.box_hi(i), temp)
            alpha = torch.where(winner, a_i, alpha)
            cover = a_i
            t_i, _ = intersect_cube(ro0, d0, scene.box_lo(i), scene.box_hi(i), inv=inv)

        better = (~h0.hit) & (cover > a_out)
        a_out = torch.where(better, cover, a_out)
        alb_o = Vec3.where(better, scene.albedo_of(i), alb_o)
        emis_o = Vec3.where(better, scene.emission_of(i), emis_o)

        tt = torch.where(winner, BIG, t_i)
        w2 = tt < t2
        t2 = torch.where(w2, tt, t2)
        alb2 = Vec3.where(w2, scene.albedo_of(i), alb2)
        emis2 = Vec3.where(w2, scene.emission_of(i), emis2)

    sky0 = sample_cubemap(cubemap, d0, bilinear=config.env_filter == "bilinear").clip(0.0, 1.0)
    has2 = t2 < HIT_THRESHOLD
    # a cheap local proxy for the runner-up's radiance: at a training-only
    # smoothing boundary the gradient's DIRECTION is what matters
    bg = Vec3.where(has2, (emis2 + alb2 * sky0).clip(0.0, 1.0), sky0)
    # two-sided edge: a pixel that misses keeps its traced radiance (the sky)
    # with weight 1 - a_out and takes the best-coverage object's proxy with
    # a_out, mirroring the blend inside the edge
    miss = ~h0.hit
    alpha = torch.where(miss, 1.0 - a_out, alpha)
    bg = Vec3.where(miss, (emis_o + alb_o * sky0).clip(0.0, 1.0), bg)
    return result * alpha + bg * (1.0 - alpha)
