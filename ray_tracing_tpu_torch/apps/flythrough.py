"""Camera fly-through renderer: an orbit rendered offline to numbered PNGs.

    python -m ray_tracing_tpu_torch.apps.flythrough --scene scene.txt \\
        --frames 24 --width 640 --height 480 --spp 8 --out-dir fly

Counterpart of ``ray_tracing_tpu/apps/flythrough.py``: the batch analogue of
the interactive viewer, and with ``--sharded`` the "camera fly-through,
tiles + samples sharded" workload, each frame over a mesh of cells
(parallel/; ``--mesh TxS``, default every local card). Frame i is seeded i
and written to ``frame_NNNN.png``; stderr gets the rays/s of a sliding
window. On the card every sample is one launch of the forward kernel (K1);
``--device cpu`` runs its plain PyTorch version. Without --assets (a
directory holding skybox/<face>.jpg) the sky is the synthetic 2048^2
checkerboard cubemap, as in the command line.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys


def orbit_camera(base, t: float, radius: float = 8.66, height: float = 5.0,
                 look_at=(1.5, 1.0, 1.5)):
    """`base` moved onto the orbit of `radius` around `look_at` at angle t
    (radians), `height` above the ground, looking at `look_at`."""
    import torch

    pos = torch.tensor(
        [look_at[0] + radius * math.cos(t), height, look_at[2] + radius * math.sin(t)],
        dtype=torch.float32)
    front = torch.tensor(
        [look_at[0] - float(pos[0]), look_at[1] - height, look_at[2] - float(pos[2])],
        dtype=torch.float32)
    front = front / torch.linalg.norm(front)
    return dataclasses.replace(base, pos=pos.to(base.device), front=front.to(base.device))


def build_parser():
    p = argparse.ArgumentParser(prog="raytrace-fly-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--out-dir", default="fly_frames")
    p.add_argument("--sharded", action="store_true", help="render over the mesh")
    p.add_argument("--mesh", default=None,
                   help="TxS cells of --sharded (default: every local card)")
    p.add_argument("--assets", default=None,
                   help="skybox root (skybox/right.jpg, ...); default: a checkerboard sky")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the hand-written megakernel; cpu: plain PyTorch ops")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ray_tracing_tpu_torch.apps.cli import load_sky
    from ray_tracing_tpu_torch.device import resolve_device
    from ray_tracing_tpu_torch.io.image import save_png
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    from ray_tracing_tpu_torch.render.camera import Camera
    from ray_tracing_tpu_torch.scene.parser import SceneParseError, parse_scene_file
    from ray_tracing_tpu_torch.utils.profiling import RateMeter, rays_per_frame

    device = resolve_device(None if args.device == "cuda" else args.device)
    try:
        scene = parse_scene_file(args.scene, device=device)
    except (OSError, SceneParseError) as e:
        print(f"Couldn't parse scene: {e}", file=sys.stderr)
        return 1
    cubemap = load_sky(False, args.assets, device)
    base = Camera.default(device)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.sharded:
        from ray_tracing_tpu_torch.parallel.mesh import make_mesh, parse_mesh
        from ray_tracing_tpu_torch.parallel.render import render_image_sharded

        # default: every local card on the tile axis, as the JAX app's make_mesh()
        mesh = (parse_mesh(args.mesh, device) if args.mesh
                else make_mesh(devices=[device] if device.type == "cpu" else None))
        print(f"mesh={mesh.shape}", file=sys.stderr)

        def render(cam, seed):
            return render_image_sharded(scene, cam, args.width, args.height, seed, mesh,
                                        spp=args.spp, cubemap=cubemap)
    else:
        def render(cam, seed):
            return render_image_cuda(scene, cam, args.width, args.height, seed, spp=args.spp,
                                     cubemap=cubemap, device=device)

    meter = RateMeter()
    for i in range(args.frames):
        cam = orbit_camera(base, 2 * math.pi * i / args.frames)
        with torch.no_grad():
            img = render(cam, i).cpu()  # waits for the frame
        meter.add(rays_per_frame(args.width, args.height, args.spp))
        save_png(img, os.path.join(args.out_dir, f"frame_{i:04d}.png"))
        print(f"frame {i + 1}/{args.frames}  {meter.format()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
