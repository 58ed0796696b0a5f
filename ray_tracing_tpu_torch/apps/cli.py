"""Command line of the port: offline rendering to a PNG.

    python -m ray_tracing_tpu_torch --scene scene.txt --output out.png

Counterpart of ``ray_tracing_tpu/apps/cli.py``, offline mode. The render
runs on the card through the CUDA megakernel; ``--device cpu`` runs the
plain PyTorch estimator on the CPU. Nothing falls back on its own: without a
card, and without ``--device cpu``, the command fails.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytrace-torch",
        description="Path tracer on PyTorch/CUDA (offline render to PNG)",
    )
    p.add_argument("--scene", required=True, help="scene DSL file")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    p.add_argument("--spp", type=int, default=16, help="samples per pixel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="render.png", help="PNG file to write")
    p.add_argument("--no-skybox", action="store_true",
                   help="constant sky instead of the checkerboard cubemap")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the hand-written megakernel; cpu: plain PyTorch ops")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    # Heavy imports after argument parsing (fast --help).
    from ray_tracing_tpu_torch.config import RenderConfig
    from ray_tracing_tpu_torch.device import resolve_device
    from ray_tracing_tpu_torch.io.image import save_png
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    from ray_tracing_tpu_torch.ops.cubemap import checker_sky, constant_sky
    from ray_tracing_tpu_torch.render.camera import Camera
    from ray_tracing_tpu_torch.render.integrator import render_image
    from ray_tracing_tpu_torch.scene.parser import SceneParseError, parse_scene_file

    print("Started", file=sys.stderr)
    device = resolve_device(None if args.device == "cuda" else args.device)
    try:
        scene = parse_scene_file(args.scene, device=device)
    except (OSError, SceneParseError) as e:
        print(f"Couldn't parse scene: {e}", file=sys.stderr)
        return 1
    print("Scene parsed", file=sys.stderr)

    if args.no_skybox:
        cubemap = constant_sky((0.6, 0.7, 0.9), device=device)
    else:
        print("No skybox images ship with the package; using a synthetic "
              "checkerboard cubemap", file=sys.stderr)
        cubemap = checker_sky(2048, device=device)
    print("Cubemap loaded", file=sys.stderr)

    render = render_image_cuda if device.type == "cuda" else render_image
    img = render(
        scene, Camera.default(device), args.width, args.height, args.seed,
        spp=args.spp, config=RenderConfig(), cubemap=cubemap, device=device,
    )
    save_png(img, args.output)
    print(f"Wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
