"""Entry points of the port's flagship forward step and of its sharded
train step.

    python -m ray_tracing_tpu_torch.entry
    python -m ray_tracing_tpu_torch.entry dryrun 8

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py`` (the
JAX package's). ``entry(device=None)`` returns ``(fn, args)``: ``fn(*args)``
renders one sample of scene_2 at 1920x1080 with default physics and the
2048^2 packed synthetic checker cubemap through ``render_image_cuda`` on the
card (the bench's workload; the reference's JPEG skybox is not in the
repository). ``entry(device="cpu")`` asks for the JAX function's CPU
fallback instead: the plain PyTorch renderer at 640x480 under a constant
sky. The port never takes it on its own.

``dryrun_multichip(n, device=None)`` is the counterpart of the JAX file's:
one sharded forward and one full sharded train step (render, loss, backward,
the gradients summed over the cells, Adam) on an n-cell mesh of virtual
cells on one device (the card, unless device="cpu"), with default physics,
a packed 64^2 checker cubemap and the port's lit room in place of the
reference's scene_0.
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


def dryrun_multichip(n_devices: int, device=None) -> float:
    """One sharded forward and one full sharded train step over an
    n-cell (tile x sample) mesh of virtual cells on `device`; returns the
    step's loss. Raises when a value is not finite."""
    import dataclasses

    from ray_tracing_tpu_torch.diff.inverse import extract_params, make_train_step
    from ray_tracing_tpu_torch.parallel.mesh import make_mesh
    from ray_tracing_tpu_torch.parallel.render import render_image_sharded
    from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT

    device = resolve_device(device)
    # 2-D mesh: data-parallel pixel tiles x sample-parallel samples
    num_samples = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    num_tiles = n_devices // num_samples
    mesh = make_mesh(num_tiles, num_samples, devices=[device] * n_devices)

    # default physics (10 bounces, 3 jittered shadow rays, nearest-texel sky)
    # on the lit room, so next-event estimation and the shadow trace run
    # under sharding as they run on one device, against a packed cubemap:
    # every miss computes a texel index and gathers it
    config = RenderConfig()
    cubemap = checker_sky(64, device=device)
    width, height = 48, 8 * num_tiles
    spp = 2 * num_samples
    scene = parse_scene_string(ROOM_TEXT, device=device)
    camera = Camera.default(device)

    with torch.no_grad():  # the target: a sharded forward (the inference path)
        target = render_image_sharded(scene, camera, width, height, 1, mesh, spp=spp,
                                      config=config, cubemap=cubemap)
    if tuple(target.shape) != (height, width, 3):
        raise RuntimeError(f"sharded frame of shape {tuple(target.shape)}")

    # one full optimisation step: forward, backward, the cells' gradients
    # summed, Adam
    perturbed = dataclasses.replace(scene, p0=scene.p0 + 0.1)
    params = {"scene": {f: v.detach().clone().requires_grad_(True) for f, v in
                        extract_params(perturbed, ("p0", "p1", "albedo")).items()},
              "camera": {}}
    optimizer = torch.optim.Adam(list(params["scene"].values()), lr=1e-2)
    step = make_train_step(perturbed, camera, optimizer, width, height, spp=spp, config=config,
                           cubemap=cubemap, device=device, mesh=mesh)
    loss = float(step(params, target, 2))
    if not (loss >= 0.0 and loss == loss and loss != float("inf")):
        raise RuntimeError(f"dryrun loss {loss}")
    for name, leaf in params["scene"].items():
        if not torch.isfinite(leaf).all():
            raise RuntimeError(f"dryrun: {name} is not finite after the step")
    print(f"dryrun_multichip OK: mesh={mesh.shape}, loss={loss:.6f}")
    return loss


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["dryrun"]:
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8)
        return 0
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry OK:", tuple(out.shape), float(out.mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
