"""The plain PyTorch renderer: the same pipeline as the CUDA path, through
the plain estimator.

Counterpart of ``ray_tracing_tpu/render/integrator.py::render_image``. One
estimator serves both of the port's renderers: ``render_image`` here and
``render_image_cuda`` (kernels/megakernel.py) share the packed scene, the
random numbers, the sky lookup and the compose step, and differ only in
whether a sample's ten planes come from ``tile_physics`` in PyTorch or from
the CUDA kernel. This is the CPU path (``--device cpu`` of the CLI) and what
the kernel is held against.
"""

from __future__ import annotations

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels.megakernel import (
    make_tile_job,
    render_frame,
    run_tiles_plain,
)
from ray_tracing_tpu_torch.ops.cubemap import CubemapData, constant_sky
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
    return render_frame(job, run_tiles_plain, seed, spp, cubemap.to(device), row0)
