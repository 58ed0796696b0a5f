"""Inverse-rendering demo: recover scene parameters from a target image.

    python -m ray_tracing_tpu_torch.apps.invert --scene scene.txt \\
        --fields p0,albedo --steps 150 --width 96 --height 64 \\
        --checkpoint-dir ckpt

Counterpart of ``ray_tracing_tpu/apps/invert.py``. The scene is rendered as
the ground truth (or ``--target`` names an image to fit), the chosen fields
are perturbed, and Adam pulls them back through the differentiable
renderer over a mesh of cells (parallel/); the loss and the per-field errors
are printed on stderr. ``--mesh TxS`` sets the mesh; by default it is every
local card, with a sample axis of 2 when their count is even (one cell with
``--device cpu``), and the height and spp are rounded to it as the JAX app
rounds them. ``--checkpoint-dir`` saves the fit and resumes it;
``--multiscale`` runs the coarse-to-fine schedule (the JAX app ignores
``--checkpoint-dir`` there; this one refuses the pair). On the card the
forward of every sample is the recording CUDA kernel and the gradient comes
from the backward CUDA kernel; ``--device cpu`` runs their plain PyTorch
versions. Nothing falls back on its own: without a card, and without
``--device cpu``, the command fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="raytrace-invert-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True, help="scene DSL file")
    p.add_argument("--fields", default="p0", help="comma list of Scene fields to recover")
    p.add_argument("--target", default=None, help="target image (default: a self-render)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--perturb", type=float, default=0.25, help="initial parameter offset")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="save the final render as a PNG")
    p.add_argument("--soft-temp", type=float, default=0.08,
                   help="soft-silhouette temperature (0 = hard visibility)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the fit here and resume from it")
    p.add_argument("--multiscale", action="store_true",
                   help="coarse-to-fine schedule (recommended for geometry)")
    p.add_argument("--mesh", default=None,
                   help="TxS cells over the local devices (default: every card, "
                        "2 samples when their count is even)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the hand-written kernels; cpu: plain PyTorch ops")
    return p


def load_target(path, width: int, height: int, device):
    """A target image as (height, width, 3) float32 in [0, 1] on `device`:
    decoded, resized with PIL when its size differs, and flipped by rows:
    PNGs are written flipped for display (io/image.py::save_png), and
    without the flip back the fit would chase a mirrored target."""
    import numpy as np
    import torch

    from ray_tracing_tpu_torch.io.image import load_image

    target = np.asarray(load_image(path), np.float32) / 255.0
    if target.shape[:2] != (height, width):
        from PIL import Image

        target = np.asarray(Image.fromarray((target * 255).astype(np.uint8)).resize(
            (width, height)), np.float32) / 255.0
    return torch.from_numpy(target[::-1].copy()).to(device)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.multiscale and args.checkpoint_dir:
        parser.error("--checkpoint-dir does not apply to --multiscale")

    import torch

    from ray_tracing_tpu_torch.config import RenderConfig
    from ray_tracing_tpu_torch.device import resolve_device
    from ray_tracing_tpu_torch.diff.inverse import extract_params, fit, fit_multiscale
    from ray_tracing_tpu_torch.io.image import save_png
    from ray_tracing_tpu_torch.ops.cubemap import gradient_sky
    from ray_tracing_tpu_torch.parallel.mesh import SAMPLE_AXIS, TILE_AXIS, parse_mesh
    from ray_tracing_tpu_torch.parallel.render import render_image_sharded
    from ray_tracing_tpu_torch.render.camera import Camera
    from ray_tracing_tpu_torch.scene.parser import SceneParseError, parse_scene_file

    device = resolve_device(None if args.device == "cuda" else args.device)
    fields = tuple(args.fields.split(","))
    config = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                          soft_silhouette_temp=args.soft_temp)
    # a sky that varies with direction gives geometry and camera gradients
    # something to hold on to
    cubemap = gradient_sky(device=device)
    camera = Camera.default(device)
    try:
        scene = parse_scene_file(args.scene, device=device)
    except (OSError, SceneParseError) as e:
        print(f"Couldn't parse scene: {e}", file=sys.stderr)
        return 1
    extract_params(scene, fields)  # rejects an unknown field before any render

    mesh = parse_mesh(args.mesh, device)
    tiles, samples = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    height = (args.height // tiles) * tiles or tiles  # rows divide over the tiles
    spp = max(args.spp // samples, 1) * samples

    def render(s, seed):
        with torch.no_grad():
            return render_image_sharded(s, camera, args.width, height, seed, mesh, spp=spp,
                                        config=config, cubemap=cubemap)

    if args.target:
        target = load_target(args.target, args.width, height, device)
    else:
        target = render(scene, args.seed + 99)

    # perturb the chosen fields, from a seeded generator on the host
    gen = torch.Generator().manual_seed(args.seed)
    perturbed = scene
    for f in fields:
        v = getattr(scene, f)
        noise = args.perturb * torch.randn(v.shape, generator=gen)
        perturbed = dataclasses.replace(perturbed, **{f: v + noise.to(device)})

    print(f"device={device} mesh={mesh.shape} fields={fields} steps={args.steps}",
          file=sys.stderr)

    def cb(i, loss, params):
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {loss:.6f}", file=sys.stderr)

    if args.multiscale:
        third = args.steps // 3
        recovered, _, losses = fit_multiscale(
            perturbed, camera, target, scene_fields=fields,
            schedule=((4, third), (2, third), (1, third)), lr=args.lr, spp=spp,
            config=config, cubemap=cubemap, seed=args.seed + 1000, callback=cb, mesh=mesh,
        )
    else:
        recovered, _, losses = fit(
            perturbed, camera, target, scene_fields=fields, steps=args.steps, lr=args.lr,
            width=args.width, height=height, spp=spp, config=config, cubemap=cubemap,
            seed=args.seed + 1000, callback=cb, mesh=mesh,
            checkpoint_dir=args.checkpoint_dir,
        )

    if losses:
        print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}", file=sys.stderr)
    for f in fields:
        true = getattr(scene, f)
        e0 = float((getattr(perturbed, f) - true).abs().mean())
        e1 = float((getattr(recovered, f) - true).abs().mean())
        print(f"{f}: |err| {e0:.4f} -> {e1:.4f} ({'improved' if e1 < e0 else 'NOT improved'})",
              file=sys.stderr)

    if args.out:
        save_png(render(recovered, 7), args.out)
        print(f"Wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
