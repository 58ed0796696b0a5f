#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA megakernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, renders the main path
(scene_2 and a lit room at 1920x1080, default physics, a 2048^2 packed
cubemap) through the entry points a user would call, runs the command line,
and times the kernel. Every phase prints one JSON line; any phase that fails
raises and the run exits non-zero. Needs one CUDA device and nvcc; imports
nothing of JAX. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from ray_tracing_tpu_torch.apps.cli import main as cli_main
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.io.image import png_size
from ray_tracing_tpu_torch.kernels import build
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops.cubemap import checker_sky
from ray_tracing_tpu_torch.ops.sampling import PhiloxDraws, global_pixel_index
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, Scene

WIDTH, HEIGHT = 1920, 1080
SMALL_W, SMALL_H = 256, 144
SPP = 8
SKY_SIZE = 2048

# Published peaks of one H100 SXM: fp32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Agreement of the kernel with its plain version (same seed, same card).
ATOL = 1e-4
SHARE = 0.995
MEAN_TOL = 1e-3

# Float operations (add, sub, mul, div, sqrt each count 1; comparisons,
# selects and the integer work of the generator count 0), counted by hand
# from csrc/megakernel_fwd.cu:
F_RAY = 19          # make_ray: normalize 10, d.d 5, 0.5/a 1, three reciprocals
F_SPHERE = 25       # intersect_sphere
F_CUBE = 15         # intersect_cube: hi 3, two slab triples 12
F_OCC_SPHERE = 20   # occlude_sphere
F_FINISH = 19       # hit point 6 + sphere normal 13 (a cube's normal is selects)
F_SHADE = 114       # normalize(rd), Fresnel, bounce direction, emission,
                    # branch, reflect, specular direction, throughput, next origin
F_LIGHT_BLEND = 19  # to_light 3, mean 4, light blend 12
F_ACCEPT = 5        # per shadow sample of an active lane: rand . normal
F_SHADOW_RAY = 41   # per shadow ray cast: direction 19, ray 22
F_SHADOW_SUM = 4    # per accepted sample of an active lane


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return {"kind": name, "smi": smi}


def phase_build() -> None:
    info = build.build_library(mk.KERNEL_LIBRARY, verbose=True)
    kernels = {}
    current = None
    for line in info["log"].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = "record" if "ILb1E" in m.group(1) else "plain"
            kernels[current] = {"symbol": m.group(1)}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            kernels[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and current:
            kernels[current].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    if set(kernels) != {"plain", "record"}:
        raise RuntimeError(f"expected two instantiations in the ptxas log:\n{info['log']}")
    mk._kernel_function()  # loads the library just built
    emit("build", seconds=round(info["seconds"], 2), flags=" ".join(build.NVCC_FLAGS),
         kernels=kernels)


def make_scenes(device) -> dict[str, Scene]:
    return {
        "scene_2": parse_scene_string(SCENE_2_TEXT, device=device),
        "room": parse_scene_string(ROOM_TEXT, device=device),
        "sixty_two_lights": Scene.from_objects(
            random_objects(60, seed=1, lights=(7, 20)), device=device),
    }


class WorkCounter(mk.DirectTracer):
    """A tracer that counts, per bounce, the lanes alive at its start, the
    lanes that then hit an object (active) and the shadow samples that
    active lanes accept: the work an input needs, for the roofline bound."""

    def __init__(self, scene, draws):
        super().__init__(scene)
        self.draws = draws
        self.live = None
        self.alive, self.active, self.shadow_rays = [], [], []

    def trace(self, ro, rd):
        h = super().trace(ro, rd)
        live = torch.ones_like(h.hit) if self.live is None else self.live
        self.alive.append(int(live.sum()))
        self.live = live & h.hit
        self.active.append(int(self.live.sum()))
        self.normal = h.normal
        return h

    def trace_shadow(self, ro, rd):
        accept = self.draws.shadow(len(self.alive) - 1).dot(self.normal) > 0
        self.shadow_rays.append(int((accept & self.live).sum()))
        return super().trace_shadow(ro, rd)


def count_work(job, seed: int) -> dict:
    """One plain sample of `job` (no jitter, first row 0) through a
    WorkCounter."""
    dev = job.rows.device
    u, v = mk._tile_uv(job.width, job.height, job.norm_height, 0, dev)
    gpix = global_pixel_index(job.width, job.height, 0, device=dev)
    draws = PhiloxDraws(seed, gpix, job.config, job.ns)
    view = mk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    counter = WorkCounter(view, draws)
    mk.tile_physics(view, job.cam_pack, u, v, draws, job.config,
                    (job.height, job.width), tracer=counter)
    return {"alive": counter.alive, "active": counter.active,
            "shadow_rays": counter.shadow_rays}


def agreement(planes, recs, want_p, want_r) -> dict:
    """Shares and errors of one kernel result against the plain version's;
    raises when they miss the bar. recs/want_r may be None."""
    if not torch.isfinite(planes).all():
        raise RuntimeError("kernel wrote a non-finite value")
    err = (planes - want_p).abs()
    share = float((err <= ATOL).all(dim=0).float().mean())
    mean_off = float((planes.mean(dim=(1, 2)) - want_p.mean(dim=(1, 2))).abs().max())
    res = {"share_within_atol": share, "max_abs_err": float(err.max()),
           "max_mean_off": mean_off}
    if recs is not None:
        res["share_indices_equal"] = float((recs == want_r).all(dim=0).float().mean())
        if res["share_indices_equal"] < SHARE:
            raise RuntimeError(f"index planes disagree: {res}")
    if share < SHARE or mean_off > MEAN_TOL:
        raise RuntimeError(f"kernel disagrees with its plain version: {res}")
    return res


def compare(job, seed: int, row0: int = 0) -> dict:
    """Both kernel instantiations against the plain version from one seed."""
    want_p, want_r = mk.run_tiles_plain(job, seed, row0, record=True)
    out = {}
    for record in (False, True):
        planes, recs = mk.run_tiles(job, seed, row0, record=record)
        torch.cuda.synchronize()
        out["record" if record else "plain"] = agreement(
            planes, recs, want_p, want_r if record else None)
    return out


def phase_kernel_vs_plain(scenes, camera) -> dict:
    """Returns, for scene_2 and the room at the main path's shape, the
    comparison and the work counts of the plain run."""
    results = []
    for name, scene in scenes.items():
        for jitter in (False, True):
            cfg = RenderConfig(pixel_jitter=jitter)
            job = mk.make_tile_job(scene, camera, SMALL_W, SMALL_H, cfg)
            results.append({"scene": name, "jitter": jitter, "size": [SMALL_W, SMALL_H],
                            **compare(job, seed=11 + jitter)})
    # a row slice: rows 48..95 of the 144-row frame
    job = mk.make_tile_job(scenes["room"], camera, SMALL_W, 48, RenderConfig(),
                           norm_height=SMALL_H)
    results.append({"scene": "room", "row0": 48, "size": [SMALL_W, 48],
                    **compare(job, seed=13, row0=48)})
    full, _ = mk.run_tiles(mk.make_tile_job(scenes["room"], camera, SMALL_W, SMALL_H,
                                            RenderConfig()), seed=13)
    part, _ = mk.run_tiles(job, seed=13, row0=48)
    if not part.equal(full[:, 48:96]):
        raise RuntimeError("a row-slice launch differs from the same rows of the full frame")
    # the largest scene the parser admits: 1024 rows, 64 KB of dynamic
    # shared memory per block (needs the opt-in above 48 KB)
    big = Scene.from_objects(random_objects(1024, seed=2, lights=(7,)), device=camera.device)
    job = mk.make_tile_job(big, camera, 64, 36, RenderConfig(bounces=2, shadow_samples=1))
    results.append({"scene": "1024_objects", "jitter": False, "size": [64, 36],
                    **compare(job, seed=19)})
    # the shapes the main path gives the kernel
    at_full = {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
        res = compare(job, seed=17)
        results.append({"scene": name, "jitter": False, "size": [WIDTH, HEIGHT], **res})
        at_full[name] = {"compare": res, "stats": count_work(job, seed=17)}
    emit("kernel_vs_plain", atol=ATOL, min_share=SHARE, mean_tol=MEAN_TOL, results=results)
    return at_full


def phase_main_path(scenes, camera, sky) -> dict:
    cfg = RenderConfig()
    mk.reset_launch_counts()
    out = {}
    for name in ("scene_2", "room"):
        before = mk.launch_counts["megakernel_fwd"]
        torch.cuda.reset_peak_memory_stats()
        img = mk.render_image_cuda(scenes[name], camera, WIDTH, HEIGHT, seed=1, spp=SPP,
                                   config=cfg, cubemap=sky)
        torch.cuda.synchronize()
        rose = mk.launch_counts["megakernel_fwd"] - before
        if rose != SPP:
            raise RuntimeError(f"{name}: launch counter rose by {rose}, expected {SPP}")
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or img.dtype != torch.float32:
            raise RuntimeError(f"{name}: wrong image {tuple(img.shape)} {img.dtype}")
        if not torch.isfinite(img).all() or float(img.min()) < 0 or float(img.max()) > 1:
            raise RuntimeError(f"{name}: image is not finite in [0,1]")
        # the training-side entry: one recorded sample at full width
        tiles = mk.render_tiles_cuda(scenes[name], camera, WIDTH, HEIGHT, seed=1,
                                     config=cfg, record=True)
        torch.cuda.synchronize()
        recs = tiles["records"]
        n_rec = mk.record_layout(cfg, scenes[name].has_light)
        if tuple(recs.shape) != (n_rec, HEIGHT, WIDTH) or int(recs.min()) < -1 \
                or int(recs.max()) >= scenes[name].num_objects:
            raise RuntimeError(f"{name}: bad index planes {tuple(recs.shape)}")
        out[name] = {"image": img, "mean": float(img.mean()), "tiles": tiles,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    counts = dict(mk.launch_counts)  # read right after the main path
    for k, v in counts.items():
        if v < 1:
            raise RuntimeError(f"kernel {k} was not launched on the main path")

    report = {}
    for name in ("scene_2", "room"):
        plain = render_image(scenes[name], camera, WIDTH, HEIGHT, seed=1, spp=SPP,
                             config=cfg, cubemap=sky)
        torch.cuda.synchronize()
        img = out[name]["image"]
        off = abs(float(plain.mean()) - out[name]["mean"])
        if off > 0.01:
            raise RuntimeError(f"{name}: image mean {out[name]['mean']} vs plain {float(plain.mean())}")
        share = float(((img - plain).abs() <= ATOL).all(dim=-1).float().mean())
        if share < SHARE:
            raise RuntimeError(f"{name}: only {share} of the image's pixels equal the plain render")
        # the recorded sample of the public wrapper against the plain version
        tiles = out[name]["tiles"]
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, cfg)
        want_p, want_r = mk.run_tiles_plain(job, 1, record=True)
        recorded = agreement(torch.stack([tiles[k] for k in mk.PLANE_NAMES]),
                             tiles["records"], want_p, want_r)
        report[name] = {"mean": out[name]["mean"], "plain_mean": float(plain.mean()),
                        "share_pixels_equal_plain": share,
                        "recorded_sample_vs_plain": recorded,
                        "max_memory_allocated": out[name]["peak_bytes"]}
    emit("main_path", size=[WIDTH, HEIGHT], spp=SPP, sky=[SKY_SIZE, SKY_SIZE],
         launches=counts, scenes=report)
    return counts


def phase_cli() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        scene_file = os.path.join(tmp, "scene_2.txt")
        out = os.path.join(tmp, "out.png")
        with open(scene_file, "w") as f:
            f.write(SCENE_2_TEXT)
        t0 = time.perf_counter()
        rc = cli_main(["--scene", scene_file, "--width", str(WIDTH), "--height", str(HEIGHT),
                       "--spp", "4", "--output", out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"command line returned {rc}")
        size = png_size(out)
        if size != (WIDTH, HEIGHT, 8, 2):
            raise RuntimeError(f"PNG header says {size}")
        emit("cli", seconds=round(seconds, 3), png=list(size), bytes=os.path.getsize(out))


def time_launches(fn, n: int, warmup: int = 3) -> float:
    """Median milliseconds of fn(i) over n launches, by CUDA events."""
    for i in range(warmup):
        fn(1000 + i)
    torch.cuda.synchronize()
    pairs = []
    for i in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)  # a distinct seed per launch
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def time_frames(scene, camera, sky, cfg, n: int) -> float:
    """Median milliseconds on the host's clock of one whole frame of SPP
    samples through render_image_cuda, from the call to the end of the
    device's work."""
    times = []
    for i in range(n + 1):  # the first frame warms up and is dropped
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk.render_image_cuda(scene, camera, WIDTH, HEIGHT, seed=100 + i, spp=SPP,
                             config=cfg, cubemap=sky)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_timing(scenes, camera, sky) -> dict:
    cfg = RenderConfig()
    out = {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, cfg)
        out[name] = {
            "kernel_ms": time_launches(lambda s: mk.run_tiles(job, s), 30),
            "kernel_record_ms": time_launches(lambda s: mk.run_tiles(job, s, record=True), 20),
            "plain_ms": time_launches(lambda s: mk.run_tiles_plain(job, s), 3, warmup=1),
            "plain_record_ms": time_launches(
                lambda s: mk.run_tiles_plain(job, s, record=True), 3, warmup=1),
        }
        planes, _ = mk.run_tiles(job, 5)
        out[name]["sky_compose_ms"] = time_launches(
            lambda s: mk.compose(planes, sky, cfg), 20)
        out[name]["frame_ms"] = time_frames(scenes[name], camera, sky, cfg, 7)
    emit("timing", size=[WIDTH, HEIGHT], spp_per_frame=SPP,
         unit="ms per sample, median (frame_ms: per frame of spp_per_frame samples)", **out)
    return out


def bound(scene: Scene, stats: dict, record: bool, cfg: RenderConfig) -> dict:
    """Least time the card could take for one sample of this input: bytes
    (scene and camera read once, every plane written once) over the memory
    rate against float operations over the fp32 peak.

    The operation count takes what the outputs need on this input, per
    bounce, from the lanes the plain version found alive, active and
    shadow-sampling: a closest-hit trace for every alive lane, shading for
    every active lane, a shadow ray for every accepted sample of an active
    lane. A dead lane needs nothing: it died on a miss, its ray is as it
    was, so its next primary index is -1 again without arithmetic. The
    recorded shadow indices, though, are the winners of rays that every
    lane casts for every sample, accepted or not, so with `record` and a
    light each of them is needed."""
    n = scene.num_objects
    n_sph = sum(t == OBJ_SPHERE for t in scene.obj_type)
    n_cube = n - n_sph
    pixels = WIDTH * HEIGHT
    has_light = scene.has_light and cfg.shadow_samples > 0
    ns = cfg.shadow_samples if has_light else 0
    f_trace = F_RAY + n_sph * F_SPHERE + n_cube * F_CUBE + F_FINISH
    single = sum(bool(e) for e in (scene.emissive or ())) == 1
    if single:
        li = scene.light_index
        light_sph = scene.obj_type[li] == OBJ_SPHERE
        f_shadow = (F_RAY + (F_SPHERE if light_sph else F_CUBE) + 1
                    + (n_sph - light_sph) * F_OCC_SPHERE
                    + (n_cube - (not light_sph)) * F_CUBE)
    else:
        f_shadow = F_RAY + n_sph * F_SPHERE + n_cube * F_CUBE
    flops = 0
    for b in range(cfg.bounces):
        alive, active = stats["alive"][b], stats["active"][b]
        flops += alive * f_trace + active * F_SHADE
        if has_light:
            rays = ns * pixels if record else stats["shadow_rays"][b]
            flops += active * (F_LIGHT_BLEND + ns * F_ACCEPT)
            flops += rays * (F_SHADOW_RAY + f_shadow)
            flops += stats["shadow_rays"][b] * F_SHADOW_SUM
    n_rec = mk.record_layout(cfg, scene.has_light) if record else 0
    nbytes = n * 16 * 4 + 16 * 4 + (10 + n_rec) * pixels * 4
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def phase_kernels(scenes, at_full, counts, timing) -> None:
    cfg = RenderConfig()
    rows = []
    for kname, record, replaces in (
        ("megakernel_fwd", False,
         "ray_tracing_tpu/kernels/megakernel.py:1100 (_run_fwd, record=False; K1)"),
        ("megakernel_fwd_record", True,
         "ray_tracing_tpu/kernels/megakernel.py:1100 (_run_fwd, record=True; K2)"),
    ):
        key = "record" if record else "plain"
        per_scene = {}
        for name in ("scene_2", "room"):
            b = bound(scenes[name], at_full[name]["stats"], record, cfg)
            cmp_ = at_full[name]["compare"][key]
            per_scene[name] = {
                "ms": timing[name]["kernel_record_ms" if record else "kernel_ms"],
                "plain_ms": timing[name]["plain_record_ms" if record else "plain_ms"],
                "max_abs_err": cmp_["max_abs_err"],
                "max_share_off": 1.0 - cmp_["share_within_atol"],
                **b,
            }
        lead = per_scene["scene_2"]  # the main path's first workload
        rows.append({
            "name": kname, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/megakernel_fwd.cu",
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": max(p["max_abs_err"] for p in per_scene.values()),
            "max_share_off": max(p["max_share_off"] for p in per_scene.values()),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a path tracer
            "shape": [WIDTH, HEIGHT], "scene": "scene_2", "per_scene": per_scene,
        })
    print(json.dumps({"kernels": rows}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    scenes = make_scenes(device)
    camera = Camera.default(device)
    sky = checker_sky(SKY_SIZE, device=device)
    at_full = phase_kernel_vs_plain(scenes, camera)
    counts = phase_main_path(scenes, camera, sky)
    phase_cli()
    timing = phase_timing(scenes, camera, sky)
    torch.cuda.synchronize()
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    phase_kernels(scenes, at_full, counts, timing)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
