"""Entry point of the port's flagship forward step.

    python -m ray_tracing_tpu_torch.entry

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py`` (the
JAX package's). ``entry(device=None)`` returns ``(fn, args)``: ``fn(*args)``
renders one sample of scene_2 at 1920x1080 with default physics and the
2048^2 packed synthetic checker cubemap through ``render_image_cuda`` on the
card (the bench's workload; the reference's JPEG skybox is not in the
repository). ``entry(device="cpu")`` asks for the JAX function's CPU
fallback instead: the plain PyTorch renderer at 640x480 under a constant
sky. The port never takes it on its own. The JAX file's
``dryrun_multichip`` has no counterpart yet (ROADMAP.md module 12).
"""

from __future__ import annotations

import sys

import torch

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import checker_sky, constant_sky
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import SCENE_2_TEXT

SKY_SIZE = 2048


def entry(device=None):
    """(fn, args): fn(scene, camera, seed) -> the (H, W, 3) frame. device=None
    means the card; device="cpu" is the 640x480 constant-sky plain render."""
    device = resolve_device(device)
    config = RenderConfig()
    scene = parse_scene_string(SCENE_2_TEXT, device=device)
    camera = Camera.default(device)
    if device.type == "cpu":
        cubemap = constant_sky((0.6, 0.7, 0.9), device=device)

        def fn(scene, camera, seed):
            return render_image(scene, camera, 640, 480, seed, spp=1, config=config,
                                cubemap=cubemap, device=device)

        return fn, (scene, camera, 0)

    cubemap = checker_sky(SKY_SIZE, device=device)

    def fn(scene, camera, seed):
        return render_image_cuda(scene, camera, 1920, 1080, seed, spp=1, config=config,
                                 cubemap=cubemap, device=device)

    return fn, (scene, camera, 0)


def main() -> int:
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry OK:", tuple(out.shape), float(out.mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
