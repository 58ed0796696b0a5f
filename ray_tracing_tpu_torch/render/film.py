"""Film: the device-resident accumulation buffer of progressive refinement.

Counterpart of ``ray_tracing_tpu/render/film.py``. The reference keeps a
mutex-guarded accumulation buffer that its workers add to
(src/main.c:66-89, 380-482) and zeroes when the camera moves
(invalidate_accumulation, src/main.c:115-124). Here a Film is an immutable
value: each pass returns a new one, and invalidation starts again from
``Film.zero``.

Progressive refinement follows ``--init-scale`` (src/main.c:274-322,
350-354, 401-407): a pass at scale s renders the (W/s, H/s) grid the
reference's render_column would (the same u/v formulas, the full frame's
aspect), replicates each sample into an s x s block and accumulates it with
weight spp/s^2; after each pass the scale halves down to 1, and full-res
passes keep accumulating.

Two passes: ``render_pass`` through the plain estimator
(render/integrator.py::render_image) and ``render_pass_cuda`` through the
CUDA megakernel (kernels/megakernel.py::render_image_cuda, kernel K1). Seed
for seed they take the same samples, so their films agree bit for bit where
K1 agrees with its plain version.

Seeds. A pass seeded c takes the samples c*7919 + i (wrapping int32) for
i < spp, whatever its spp is, and ``pass_seed(seed, n)`` = seed*1000003 + n
gives pass n of a session its seed. Passes whose seeds differ by less than
2^32/7919 (542,000 passes) therefore never share a sample seed: a repeated
sample would stop the film converging and show no other symptom.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels.megakernel import _wrap_i32, render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import CubemapData
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.camera import Camera, pixel_grid
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.types import Scene


@dataclasses.dataclass(frozen=True)
class Film:
    """Accumulated radiance (the sum of weighted samples) and the total
    weight, on one device."""

    accum: Vec3            # (H, W) float32 planes
    weight: torch.Tensor   # () float32, the same for every pixel

    @staticmethod
    def zero(width: int, height: int, device=None) -> "Film":
        """An empty film; device=None means the card."""
        device = resolve_device(device)
        return Film(accum=Vec3.zeros((height, width), device=device),
                    weight=torch.zeros((), dtype=torch.float32, device=device))

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]

    @property
    def device(self) -> torch.device:
        return self.weight.device

    def resolve(self) -> torch.Tensor:
        """The weighted mean, (H, W, 3): accum * (1 / max(weight, 1e-4)), in
        that order, as the JAX package computes it; zeros before any sample
        has landed (the reference waits for weight > 1e-4 instead,
        src/main.c:461-464)."""
        w = torch.clamp(self.weight, min=1e-4)
        return (self.accum * (1.0 / w)).to_array()


def lowres_size(width: int, height: int, scale: int) -> tuple[int, int]:
    """(lw, lh): the frame's dimensions floor-divided by the scale, at
    least 1."""
    return max(width // scale, 1), max(height // scale, 1)


def lowres_grid(width: int, height: int, scale: int, device=None):
    """(uu, vv, lw, lh): the u/v render_column evaluates at scale s
    (src/main.c:284-296), u = 1 - x/(lw-1), v = 1 - y/(lh-1), which is the
    pixel grid of an lw x lh frame. device=None means the card."""
    lw, lh = lowres_size(width, height, scale)
    uu, vv = pixel_grid(lw, lh, device=device)
    return uu, vv, lw, lh


def upsample_replicate(img: Vec3, scale: int, width: int, height: int) -> Vec3:
    """Replicate each low-res sample into an s x s block (src/main.c:
    298-310); the rows and columns past the last whole block repeat the
    edge (the reference leaves them black, an artifact)."""
    if scale == 1:
        return img
    lh, lw = img.shape
    dev = img.x.device
    rows = torch.clamp(torch.arange(height, device=dev) // scale, max=lh - 1)
    cols = torch.clamp(torch.arange(width, device=dev) // scale, max=lw - 1)
    return Vec3(*(c.index_select(0, rows).index_select(1, cols)
                  for c in (img.x, img.y, img.z)))


def pass_seed(seed: int, pass_index: int) -> int:
    """The seed of pass `pass_index` of a session started from `seed`:
    seed*1000003 + pass_index in wrapping int32 (the mix of
    diff/inverse.py::step_seed)."""
    return _wrap_i32(seed * 1000003 + pass_index)


def _render_seed(seed: int, spp: int) -> int:
    """What the renderer is handed so that a pass seeded `seed` takes the
    samples seed*7919 + i: render_frame derives exactly those for spp > 1
    and takes a single sample's seed as it is given."""
    return _wrap_i32(seed * 7919) if spp == 1 else seed


def _accumulate(film: Film, img: torch.Tensor, scale: int, spp: int) -> Film:
    """The film plus a pass's (lh, lw, 3) image, replicated to the film and
    weighted spp / scale^2 (src/main.c:278, 394-396)."""
    full = upsample_replicate(Vec3(img[..., 0], img[..., 1], img[..., 2]), scale,
                              film.width, film.height)
    w = spp / (scale * scale)
    return Film(accum=film.accum + full * w, weight=film.weight + w)


def render_pass(scene: Scene, camera: Camera, film: Film, seed: int, scale: int = 1,
                config: RenderConfig = DEFAULT_CONFIG, cubemap: CubemapData | None = None,
                spp: int = 1, device=None) -> Film:
    """One progressive pass through the plain estimator: render_image of
    the lw x lh grid with the full frame's aspect (src/main.c:281), spp
    samples seeded as the module says, replicated to the film and added
    with weight spp/scale^2. device=None means the card; the film lies
    there."""
    device = resolve_device(device)
    lw, lh = lowres_size(film.width, film.height, scale)
    img = render_image(scene, camera, lw, lh, _render_seed(seed, spp), spp=spp,
                       config=config, cubemap=cubemap, aspect=film.width / film.height,
                       device=device)
    return _accumulate(film, img, scale, spp)


def render_pass_cuda(scene: Scene, camera: Camera, film: Film, seed: int, scale: int = 1,
                     config: RenderConfig = DEFAULT_CONFIG,
                     cubemap: CubemapData | None = None, spp: int = 1, device=None):
    """render_pass through the CUDA megakernel (render_image_cuda, K1):
    the same samples, one launch per sample and one sky compose each.
    device=None means the card, where the film lies; on the CPU
    render_image_cuda runs its plain versions."""
    device = resolve_device(device)
    lw, lh = lowres_size(film.width, film.height, scale)
    img = render_image_cuda(scene, camera, lw, lh, _render_seed(seed, spp), spp=spp,
                            config=config, cubemap=cubemap, aspect=film.width / film.height,
                            device=device)
    return _accumulate(film, img, scale, spp)


def progressive_scales(config: RenderConfig = DEFAULT_CONFIG) -> list[int]:
    """The scale schedule of a session: init_scale, /2, ..., 1
    (src/main.c:350-354, 401-403)."""
    s = config.init_scale
    out = []
    while s >= 1:
        out.append(s)
        s //= 2
    return out


def render_progressive(scene: Scene, camera: Camera, width: int, height: int, seed: int,
                       num_full_passes: int = 1, config: RenderConfig = DEFAULT_CONFIG,
                       cubemap: CubemapData | None = None, device=None) -> Film:
    """The whole pyramid, then full-res passes up to `num_full_passes` at
    scale 1, one sample each, through the plain pass; pass n is seeded
    pass_seed(seed, n)."""
    film = Film.zero(width, height, device=device)
    scales = progressive_scales(config) + [1] * max(num_full_passes - 1, 0)
    for n, s in enumerate(scales):
        film = render_pass(scene, camera, film, pass_seed(seed, n), s, config, cubemap,
                           device=film.device)
    return film
