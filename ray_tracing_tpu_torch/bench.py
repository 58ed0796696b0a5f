"""Benchmark of the port: Mrays/s forward+backward of scene_2 on the card.

    python -m ray_tracing_tpu_torch.bench

Counterpart of the repository's ``bench.py`` (which measures the JAX
package), without its TPU probe. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline"}.

The workload is the reference's: scene_2 at 1920x1080, full physics (10
bounces, 3 shadow rays), forward and backward through the CUDA megakernels
with gradients with respect to every scene parameter, in the backward mode
that effective_bwd_mode picks (fetch), 8 samples per call; the forward alone
at 32 samples. The sky is a 2048^2 packed synthetic checker cubemap: the
reference's JPEG skybox is not part of the repository, and the metric string
says so. Inside the metric string, beside the headline:

  * steady-state training fwd+bwd: the same call fed a sky cache threaded
    from an earlier call (render_image_cuda's sky_cache), as a training loop
    at a fixed camera would. The sky lookup is the default's full gather
    (sky_sparse_gather off), which only passes the cache through;
  * fwd-only, and constant-sky fwd (no texel gather);
  * the census rate: the float operations that the census of the plain
    estimator counts (utils/flops.py, at the JAX package's prices) per
    second, and its share of the FP32 FMA peak that the CUDA kernel K6
    measures on this card. The census prices every lane of every bounce, as
    the plain estimator runs them in lockstep; the kernels skip the work of
    lanes whose path has ended, so this share is no utilization of the card;
  * the tensor cores' measured bf16 peak, on which no work of the port runs;
  * the fingerprint: per-launch dispatch floor and one .item()'s latency.

Ray accounting is the reference's cost model: every pixel-sample counts
bounces x (1 + shadow_samples) traces. vs_baseline divides by 290.6
Mrays/s: the C reference renderer's trace_ray measured single-threaded on a
CPU (about 9.08 Mrays/s on scene_2) times its 32 threads, an optimistic CPU
ceiling and no GPU's or TPU's number.

Times are utils/timing.py::timed_per_sample: the marginal time per call
between windows of distinct seeds, each closed by one read on the host.

Without a card the command fails. ``--device cpu`` (with --width/--height)
runs the plain PyTorch path for tests; it measures no peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ray_tracing_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.diff.inverse import SCENE_PARAM_FIELDS
from ray_tracing_tpu_torch.kernels.megakernel import effective_bwd_mode, render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import checker_sky, constant_sky
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import SCENE_2_TEXT
from ray_tracing_tpu_torch.utils import flops
from ray_tracing_tpu_torch.utils.profiling import traces_per_sample
from ray_tracing_tpu_torch.utils.timing import environment_fingerprint, timed_per_sample

REF_CPU_MRAYS_32T = 290.6  # see the module docstring

WIDTH, HEIGHT = 1920, 1080
SPP_FWD = 32
SPP_BWD = 8
SKY_SIZE = 2048
CONST_SKY = (0.6, 0.7, 0.9)
# The peaks' self-check: doubling the iterations must double the marginal
# time. A noise spike can trip it once; it is tried this often.
PEAK_TRIES = 3
PEAK_RATIO = (1.6, 2.5)


def frame_sum_fn(camera, width, height, spp, config, cubemap, sky_cache=None):
    """f(scene, seed) -> the sum of a rendered frame (one value to read)."""
    def f(scene, seed):
        return render_image_cuda(scene, camera, width, height, seed, spp=spp, config=config,
                                 cubemap=cubemap, sky_cache=sky_cache,
                                 device=scene.device).sum()
    return f


def frame_grad_fn(camera, width, height, spp, config, cubemap, sky_cache=None):
    """f(scene, seed) -> the gradients of a frame's sum with respect to
    every scene parameter (SCENE_PARAM_FIELDS)."""
    def f(scene, seed):
        leaves = {n: getattr(scene, n).detach().requires_grad_() for n in SCENE_PARAM_FIELDS}
        img = render_image_cuda(dataclasses.replace(scene, **leaves), camera, width, height,
                                seed, spp=spp, config=config, cubemap=cubemap,
                                sky_cache=sky_cache, device=scene.device)
        return torch.autograd.grad(img.sum(), list(leaves.values()))
    return f


def checked_peak(measure, device) -> dict:
    """measure(device=device) until its ratio passes the self-check, at most
    PEAK_TRIES times; raises when it never does (the number would not be
    trustworthy)."""
    for _ in range(PEAK_TRIES):
        pk = measure(device=device)
        if PEAK_RATIO[0] <= pk["ratio"] <= PEAK_RATIO[1]:
            return pk
    raise RuntimeError(f"{measure.__name__}: the iteration-doubling self-check failed "
                       f"{PEAK_TRIES} times (last ratio {pk['ratio']:.3f})")


def flops_per_pixel(scene, config, bwd_mode) -> dict:
    """Counted float operations of a forward sample (the estimator and its
    draws) and of a forward+backward sample in `bwd_mode`: fetch's forward
    runs once (its backward starts from the recorded indices), the other
    modes' backward traces the paths a second time."""
    fwd = (flops.physics_cost_per_pixel(scene, config)["flops_per_px"]
           + flops.prng_flops_per_pixel(config, scene.has_light))
    if bwd_mode == "fetch":
        bwd, passes = flops.fetch_vjp_cost_per_pixel(scene, config)["flops_per_px"], 1
    else:
        bwd, passes = flops.replay_vjp_cost_per_pixel(scene, config)["flops_per_px"], 2
    return {"fwd": fwd, "fwd_bwd": passes * fwd + bwd}


def run(device=None, width: int = WIDTH, height: int = HEIGHT,
        config: RenderConfig = DEFAULT_CONFIG, spp_fwd: int = SPP_FWD,
        spp_bwd: int = SPP_BWD, sky_size: int = SKY_SIZE) -> dict:
    """The measurements; returns {"line": the bench's JSON object, and the
    numbers behind it}. device=None means the card; the keyword arguments
    other than device exist for tests at a small size."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    scene = parse_scene_string(SCENE_2_TEXT, device=device)
    camera = Camera.default(device)
    sky = checker_sky(sky_size, device=device)
    const = constant_sky(CONST_SKY, device=device)
    bwd_mode = effective_bwd_mode(scene, config, width, height, spp_bwd)
    rays = width * height * traces_per_sample(config)  # per sample

    def mrays(seconds_per_sample):
        return rays / seconds_per_sample / 1e6

    args = (camera, width, height)
    t_bwd = timed_per_sample(frame_grad_fn(*args, spp_bwd, config, sky), scene, n=spp_bwd)
    t_fwd = timed_per_sample(frame_sum_fn(*args, spp_fwd, config, sky), scene, n=spp_fwd)
    # steady-state training: a cache threaded from an earlier call at this
    # camera makes every sample's sky lookup sparse (exact whatever its state)
    _, cache = render_image_cuda(scene, camera, width, height, 0, spp=2, config=config,
                                 cubemap=sky, return_sky_cache=True, device=device)
    t_bwd_ss = timed_per_sample(frame_grad_fn(*args, spp_bwd, config, sky, cache), scene,
                                n=spp_bwd)
    t_const = timed_per_sample(frame_sum_fn(*args, spp_fwd, config, const), scene, n=spp_fwd)

    counted = flops_per_pixel(scene, config, bwd_mode)
    px = width * height
    out = {"bwd_mode": bwd_mode, "seconds_per_sample": {
               "fwd_bwd": t_bwd, "fwd": t_fwd, "fwd_bwd_steady": t_bwd_ss, "const_fwd": t_const},
           "census_flops_per_px": counted,
           "census_tflops": {"const_fwd": counted["fwd"] * px / t_const / 1e12,
                             "fwd_bwd": counted["fwd_bwd"] * px / t_bwd / 1e12}}
    if on_card:
        vpu = checked_peak(flops.measured_vpu_peak, device)
        mxu = checked_peak(flops.measured_mxu_peak, device)
        peak = vpu["flops_per_s"] / 1e12
        out.update(fma_peak=vpu, bf16_peak=mxu,
                   census_share_of_fma_peak={k: v / peak
                                             for k, v in out["census_tflops"].items()})
        share = out["census_share_of_fma_peak"]
        roof = ("; FP32 FMA peak %.6g TFLOP/s measured (K6, ratio %.4g); census (lockstep, every"
                " lane of every bounce, not the kernels' work, so no utilization) const-sky fwd"
                " %.6g TFLOP/s = %.4g%% of that peak, fwd+bwd %.6g TFLOP/s = %.4g%%; tensor"
                " cores: bf16 peak %.6g TFLOP/s measured (ratio %.4g), the port routes no work"
                " through them"
                % (peak, vpu["ratio"], out["census_tflops"]["const_fwd"],
                   100 * share["const_fwd"], out["census_tflops"]["fwd_bwd"],
                   100 * share["fwd_bwd"], mxu["flops_per_s"] / 1e12, mxu["ratio"]))
        where = torch.cuda.get_device_name(device)
    else:
        roof = "; no peak: the FMA peak kernel runs on the card only"
        where = "device cpu, plain PyTorch path"
    fp = environment_fingerprint(device)
    out["fingerprint"] = fp
    sky_bwd = mrays(t_bwd)
    metric = ("Mrays/s fwd+bwd scene_2 %dx%d + %d^2 synthetic checker skybox (bwd_mode=%s;"
              " sky lookup %s; steady-state training fwd+bwd %.6g; fwd-only %.6g; const-sky"
              " fwd %.6g%s; env: dispatch %.4g ms/call, item %.4g ms; %s)"
              % (width, height, sky_size, bwd_mode,
                 "sparse" if config.sky_sparse_gather else "full gather", mrays(t_bwd_ss),
                 mrays(t_fwd), mrays(t_const), roof, fp["dispatch_ms_per_call"], fp["item_ms"],
                 where))
    out["line"] = {"metric": metric, "value": sky_bwd, "unit": "Mrays/s",
                   "vs_baseline": sky_bwd / REF_CPU_MRAYS_32T}
    return out


def build_parser():
    p = argparse.ArgumentParser(prog="python -m ray_tracing_tpu_torch.bench",
                                description="Mrays/s fwd+bwd of scene_2 on the card")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: the plain PyTorch path, for tests (no peak)")
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--height", type=int, default=HEIGHT)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    res = run(None if args.device == "cuda" else args.device, args.width, args.height)
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
