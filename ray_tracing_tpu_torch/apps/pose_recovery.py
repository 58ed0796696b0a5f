"""Recover the camera pose behind a screenshot by gradient descent.

    python -m ray_tracing_tpu_torch.apps.pose_recovery --scene scene.txt \\
        --target screenshot.png --init-pos 0,0.35,6 --init-front 0,0,-1

Counterpart of ``ray_tracing_tpu/apps/pose_recovery.py``. The target is a
PNG written flipped, as the reference's writer and io/image.py::save_png
write them. The stages:

1. ``coarse_pose_search`` (diff/inverse.py) ranks a few hundred candidate
   poses at a 64x48 thumbnail (skipped with ``--no-search``);
2. a tournament: ``--refine-steps`` of Adam on ("pos", "front") from the
   manual guess and from each of the search's top candidates; the lowest
   final loss wins;
3. ``fit`` from the winner, ``--steps`` steps;
4. a fine-tune at a fifth of the learning rate and 4x the samples (the
   main fit plateaus on its gradient noise);
5. the check: the pixel correlation with the target of a 32-sample render
   with jittered pixels, at the start pose and at the recovered one.

``--out`` renders the recovered pose to a PNG (1280x960 at 128 samples on
the card, 640x480 at 32 on the CPU). On the card every render and step runs
the CUDA kernels (K1 for the search and the checks, K2 and K3 for the
fits); ``--device cpu`` runs their plain PyTorch versions. Without
--assets the sky is the synthetic checkerboard cubemap.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="raytrace-pose-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True)
    p.add_argument("--target", required=True,
                   help="screenshot PNG (flipped on save, like the reference writer)")
    p.add_argument("--init-pos", default="0,0.35,6")
    p.add_argument("--init-front", default="0,0,-1")
    p.add_argument("--no-search", action="store_true",
                   help="skip the coarse pose search (single-start Adam from "
                        "--init-pos/--init-front only)")
    p.add_argument("--refine-steps", type=int, default=40,
                   help="Adam steps per candidate of the tournament")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--lr", type=float, default=6e-3)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--assets", default=None,
                   help="skybox root (skybox/right.jpg, ...); default: a checkerboard sky")
    p.add_argument("--out", default=None, help="render the recovered pose to PNG")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the hand-written kernels; cpu: plain PyTorch ops")
    return p


def correlation(a, b) -> float:
    """Pearson correlation of two images' pixels."""
    import numpy as np

    return float(np.corrcoef(np.asarray(a).ravel(), np.asarray(b).ravel())[0, 1])


def main(argv=None):
    args = build_parser().parse_args(argv)

    import time

    import numpy as np
    import torch
    from PIL import Image

    from ray_tracing_tpu_torch.apps.cli import load_sky
    from ray_tracing_tpu_torch.config import RenderConfig
    from ray_tracing_tpu_torch.device import resolve_device
    from ray_tracing_tpu_torch.diff import inverse
    from ray_tracing_tpu_torch.io.image import save_png
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    from ray_tracing_tpu_torch.render.camera import Camera
    from ray_tracing_tpu_torch.scene.parser import SceneParseError, parse_scene_file

    device = resolve_device(None if args.device == "cuda" else args.device)
    W, H = args.width, args.height
    tgt = np.asarray(Image.open(args.target).convert("RGB").resize((W, H)), np.float32) / 255.0
    tgt = tgt[::-1].copy()  # the reference PNG writer flips rows on save (src/main.c:672)
    target = torch.from_numpy(tgt).to(device)

    try:
        scene = parse_scene_file(args.scene, device=device)
    except (OSError, SceneParseError) as e:
        print(f"Couldn't parse scene: {e}", file=sys.stderr)
        return 1
    cubemap = load_sky(False, args.assets, device)
    cfg = RenderConfig(env_filter="bilinear", bounces=3, shadow_samples=1)

    def vec(text):
        return torch.tensor([float(x) for x in text.split(",")], dtype=torch.float32,
                            device=device)

    start = dataclasses.replace(Camera.default(device), pos=vec(args.init_pos),
                                front=vec(args.init_front))

    def pose_fit(cam, steps, lr, spp, callback=None):
        _, rec, losses = inverse.fit(scene, cam, target, scene_fields=(),
                                     camera_fields=("pos", "front"), steps=steps, lr=lr,
                                     spp=spp, config=cfg, cubemap=cubemap, callback=callback,
                                     device=device)
        return rec, losses

    def cb(i, loss, params):
        if i % 20 == 0:
            print(f"step {i:4d}  loss {loss:.5f}", file=sys.stderr)

    def check(cam):
        # The target is a converged accumulation, antialiased by its resize:
        # jittered sub-pixel samples keep point-sampled edges from
        # dominating the comparison.
        with torch.no_grad():
            img = render_image_cuda(scene, cam, W, H, 11, spp=32,
                                    config=cfg.replace(pixel_jitter=True), cubemap=cubemap,
                                    device=device)
        return correlation(img.cpu(), tgt)

    corr0 = check(start)
    t0 = time.perf_counter()
    starts = [start]
    if not args.no_search:
        # global init: a thumbnail brute force over poses, then a short Adam
        # on each survivor; the manual guess stays in the tournament
        cands, scores = inverse.coarse_pose_search(scene, tgt, base_camera=start, config=cfg,
                                                   cubemap=cubemap, device=device)
        print(f"coarse search: top MSEs {[round(s, 4) for s in scores]}", file=sys.stderr)
        starts += [dataclasses.replace(start, pos=torch.from_numpy(p).to(device),
                                       front=torch.from_numpy(f).to(device))
                   for p, f in cands]
    t1 = time.perf_counter()

    if len(starts) > 1:
        refined = []
        for k, st in enumerate(starts):
            rc, ls = pose_fit(st, args.refine_steps, args.lr, args.spp)
            print(f"candidate {k}: refine loss {ls[-1]:.5f}", file=sys.stderr)
            refined.append((ls[-1], rc))
        start = min(refined, key=lambda x: x[0])[1]

    rec, losses = pose_fit(start, args.steps, args.lr, args.spp, cb)
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}", file=sys.stderr)
    # fine-tune: the main fit plateaus on its spp-args.spp gradient noise
    # (late losses oscillate); a short low-rate pass at 4x spp settles it
    rec, losses = pose_fit(rec, max(args.steps // 2, 20), args.lr / 5, args.spp * 4, cb)
    t2 = time.perf_counter()
    print(f"fine-tune loss -> {losses[-1]:.5f}", file=sys.stderr)
    print("pos:", rec.pos.cpu().numpy().round(4).tolist(), file=sys.stderr)
    print("front:", rec.front.cpu().numpy().round(4).tolist(), file=sys.stderr)
    print(f"search {t1 - t0:.3f} s, refinement {t2 - t1:.3f} s", file=sys.stderr)
    print(f"correlation vs target: {corr0:.3f} -> {check(rec):.3f}", file=sys.stderr)

    if args.out:
        big = (1280, 960, 128) if device.type == "cuda" else (640, 480, 32)
        with torch.no_grad():
            img = render_image_cuda(scene, rec, big[0], big[1], 7, spp=big[2],
                                    cubemap=cubemap, device=device)
        save_png(img, args.out)
        print(f"Wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
