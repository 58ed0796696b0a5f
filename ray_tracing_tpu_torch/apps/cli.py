"""Command line of the port: an offline render to a PNG, or the interactive
terminal viewer.

    python -m ray_tracing_tpu_torch --scene scene.txt --output out.png
    python -m ray_tracing_tpu_torch --scene scene.txt --interactive

Counterpart of ``ray_tracing_tpu/apps/cli.py``. The reference's flags keep
their meaning: --scene, --init-scale {1,2,4,8,16} (where the progressive
pyramid starts) and --threads: the reference's worker threads became device
sharding, and --threads caps the tile axis of the offline render's mesh
(parallel/) at min(threads, cards, 32), the largest tile count that divides
the height; with one card it caps nothing. --passes is accepted as the JAX
package accepts it; neither reads it yet.

The render runs on the card through the CUDA megakernel (K1); ``--device
cpu`` runs the plain PyTorch estimator on the CPU. Nothing falls back on
its own: without a card, and without ``--device cpu``, the command fails.
Without --assets (a directory holding skybox/<face>.jpg) the sky is a
synthetic 2048^2 checkerboard cubemap; --no-skybox makes it constant.
"""

from __future__ import annotations

import argparse
import sys

# Samples of a full-res pass of the viewer and the server. More than one
# per pass spreads a pass's fixed costs (the TileJob, the resolve and the
# frame's copy) over its samples; the pyramid's passes take one.
FULL_RES_SPP = 4


def build_parser():
    p = argparse.ArgumentParser(
        prog="raytrace-torch",
        description="Path tracer on PyTorch/CUDA (offline render or terminal viewer)",
    )
    p.add_argument("--scene", required=True, help="scene DSL file")
    p.add_argument("--threads", type=int, default=None,
                   help="caps the tile axis of the offline render's mesh (reference: "
                        "worker threads, <= 32)")
    p.add_argument("--init-scale", type=int, default=8, choices=[1, 2, 4, 8, 16])
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    p.add_argument("--spp", type=int, default=16, help="samples per pixel (offline mode)")
    p.add_argument("--passes", type=int, default=4,
                   help="full-res passes (interactive; accepted, not read yet)")
    p.add_argument("--output", default=None, help="render to this PNG and exit")
    p.add_argument("--interactive", action="store_true", help="terminal viewer")
    p.add_argument("--no-skybox", action="store_true", help="constant sky")
    p.add_argument("--assets", default=None,
                   help="skybox root (skybox/right.jpg, ...); default: a checkerboard sky")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the hand-written megakernel; cpu: plain PyTorch ops")
    return p


def load_sky(no_skybox: bool, assets, device):
    """The sky of the command line and the server: constant with
    no_skybox, the skybox under `assets` when it is given and loads, the
    checkerboard cubemap otherwise."""
    from ray_tracing_tpu_torch.io.image import load_cubemap
    from ray_tracing_tpu_torch.ops.cubemap import checker_sky, constant_sky

    if no_skybox:
        return constant_sky((0.6, 0.7, 0.9), device=device)
    if assets is not None:
        try:
            return load_cubemap(assets, device=device)
        except OSError as e:
            print(f"Couldn't load cubemap ({e}); using the checkerboard sky",
                  file=sys.stderr)
    return checker_sky(2048, device=device)


def make_cuda_render_fn(config, cubemap, device=None):
    """The pass of the viewer and the server, through render_pass_cuda (K1
    on the card): render_fn(scene, camera, film, seed, scale) -> (film,
    spp). Pyramid passes take one sample, full-res passes FULL_RES_SPP.
    device=None means the card; on "cpu" the passes run the kernel's plain
    version."""
    from ray_tracing_tpu_torch.device import resolve_device
    from ray_tracing_tpu_torch.render.film import render_pass_cuda

    device = resolve_device(device)
    cubemap = cubemap.to(device)

    def render_fn(scene, camera, film, seed, scale):
        spp = 1 if scale != 1 else FULL_RES_SPP
        return render_pass_cuda(scene, camera, film, seed, scale, config, cubemap, spp=spp,
                                device=device), spp

    return render_fn


def main(argv=None):
    args = build_parser().parse_args(argv)

    # Heavy imports after argument parsing (fast --help).
    import torch

    from ray_tracing_tpu_torch.config import RenderConfig
    from ray_tracing_tpu_torch.device import resolve_device
    from ray_tracing_tpu_torch.io.image import save_png
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
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

    cubemap = load_sky(args.no_skybox, args.assets, device)
    print("Cubemap loaded", file=sys.stderr)
    config = RenderConfig(init_scale=args.init_scale)
    camera = Camera.default(device)

    # --threads caps the tile axis of the mesh (the reference caps its
    # worker threads at 32, src/main.c:46,632-633): the rows are sharded
    # over min(threads, cards, 32) cards
    n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
    cap = max(min(args.threads or n_avail, 32, n_avail), 1)
    n_tiles = max(t for t in range(1, cap + 1) if args.height % t == 0)

    if args.output or not args.interactive:
        # offline render (the reference has none: screenshots only)
        if n_tiles > 1:
            from ray_tracing_tpu_torch.parallel.mesh import local_devices, make_mesh
            from ray_tracing_tpu_torch.parallel.render import render_image_sharded

            mesh = make_mesh(n_tiles, 1, devices=local_devices()[:n_tiles])
            print(f"Sharding rows over {n_tiles} devices", file=sys.stderr)
            with torch.no_grad():
                img = render_image_sharded(scene, camera, args.width, args.height, args.seed,
                                           mesh, spp=args.spp, config=config, cubemap=cubemap)
        else:
            render = render_image_cuda if device.type == "cuda" else render_image
            img = render(scene, camera, args.width, args.height, args.seed, spp=args.spp,
                         config=config, cubemap=cubemap, device=device)
        out = args.output or "render.png"
        save_png(img, out)
        print(f"Wrote {out}", file=sys.stderr)
        return 0

    from ray_tracing_tpu_torch.apps.viewer import Viewer, run_interactive

    # terminal cells, at most 192 x 108 pixels; run_interactive fits the
    # render to the terminal every frame, as the reference reallocates its
    # buffers on a window resize (src/main.c:416-448)
    viewer = Viewer(scene, camera, min(args.width, 192), min(args.height, 108), config,
                    make_cuda_render_fn(config, cubemap, device))
    print("Workers started (device render loop)", file=sys.stderr)
    run_interactive(viewer, auto_resize=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
