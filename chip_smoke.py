#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels (the forward megakernel; the three backward kernels
"fetch", "replay" and "direct"; the FMA peak kernel and the gather probe) from
the sources in this checkout, holds each against its plain PyTorch version on
the card, renders the serving path (scene_2 and a lit room at 1920x1080,
default physics, a 2048^2 packed cubemap) through the entry points a user
would call, runs the command line, then drives the training path at the same
size (the gradient of a frame's sum, five steps of `fit` in fetch and in
direct mode, a 100-sample gradient past the fetch budget, which runs
"replay", the invert app), the measurement path (the port's bench, whose JSON
line it prints on a line of its own, and the gather probe with the sparse sky
cache on and off) and times the kernels. Every phase prints one JSON line
with the seconds it took (about two minutes in all on an H100, the kernels'
build included); any phase that fails raises and the run exits non-zero.
Needs one CUDA device and nvcc; imports nothing of JAX. The last line of
standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from ray_tracing_tpu_torch import bench
from ray_tracing_tpu_torch.apps.cli import main as cli_main
from ray_tracing_tpu_torch.apps.invert import main as invert_main
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff.inverse import SCENE_PARAM_FIELDS, fit
from ray_tracing_tpu_torch.io.image import png_size
from ray_tracing_tpu_torch.kernels import build, peak
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops.cubemap import checker_sky
from ray_tracing_tpu_torch.ops.sampling import PhiloxDraws, global_pixel_index
from ray_tracing_tpu_torch.render.camera import Camera, rotate
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, Scene
from ray_tracing_tpu_torch.utils import flops, gather_probe
from ray_tracing_tpu_torch.utils.timing import device_seconds

WIDTH, HEIGHT = 1920, 1080
SMALL_W, SMALL_H = 256, 144
SPP = 8
SKY_SIZE = 2048

# Published peaks of one H100 SXM: fp32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Agreement of the forward kernel with its plain version (same seed, same card).
ATOL = 1e-4
SHARE = 0.995
MEAN_TOL = 1e-3

# Agreement of the backward kernel with its plain version (same records, same
# cotangents): per entry |kernel - plain| <= rtol * |plain| + atol * max|plain
# of that column| for the scene rows, and the same with the largest entry of
# the pack for the camera. The kernel sums with float atomics in an order that
# changes from run to run, the plain version with PyTorch's reductions.
BWD_ROWS_RTOL, BWD_ROWS_ATOL = 2e-3, 2e-4
BWD_CAM_RTOL, BWD_CAM_ATOL = 2e-2, 5e-4
# The plain backward runs over row slices of the frame and adds their
# gradients: smaller slices keep its autograd graph small and its float32
# sums short (more slices do not make it slower: it is bound by bytes).
TRAIN_SLICES = 4
FIT_STEPS = 5
# Samples of the gradient whose index planes would pass the fetch budget
# (kernels/megakernel.py::FETCH_RECORD_BUDGET_BYTES) on the room: 40 planes
# of 8.3 MB per sample, so 97 samples or more run "replay".
OVER_BUDGET_SPP = 100
# The backward kernels by backward_kernel's name: launch counter and plain
# version of the two that keep no index planes.
BWD_COUNTER = {k: "megakernel_bwd_" + k for k in mk.BWD_KERNELS}
RETRACE_PLAIN = {"replay": mk.run_bwd_replay_plain, "direct": mk.run_bwd_direct_plain}

# K6 against its plain version: inputs just below 0.25, where x <- x*x + a
# has an attracting fixed point, so values stay finite and the difference
# between the kernel's fused multiply-add (one rounding) and PyTorch's
# product then sum (two) stays small, yet the contraction (0.97-0.99 per
# step near the fixed point) is slow enough that after 64 and 128 steps the
# result still depends on the trip count and on every chain's start. Two
# negative controls must fail the same tolerance: the plain recurrence at
# the other trip count, and with every chain started at a (no 0.01*k
# offsets). The bench's own inputs (a >= 0.25) run off to inf.
PEAK_CHECK_A = (0.2498, 0.24999)
PEAK_CHECK_ITERS = (64, 128)
PEAK_RTOL = 1e-5
# The shape and iterations measured_vpu_peak gives K6 on the bench path.
PEAK_GRID, PEAK_ITERS = 512, 16384
# A stale sky cache comes from the camera turned by this much (yaw, pitch).
STALE_TURN = (400.0, 120.0)
# The sparse sky lookup, which is off by default.
SPARSE_SKY = RenderConfig(sky_sparse_gather=True)

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
# and from csrc/megakernel_bwd.cu, per bounce a path is alive in and hits:
F_ADJ_COMMON = 50   # exit state 6, emission 9, hit point 8, normalize(rd) 27
F_ADJ_LIGHT = 27    # light blend
F_ADJ_BRANCH = 57   # the specular branch (the diffuse one is 21)
F_ADJ_SPHERE = 113  # a sphere hit: normal 33 and root 80
F_ADJ_CUBE = 12     # a box hit: the face's one slab quotient
F_ADJ_ROUTE = 15    # the sum over pixels itself, one add per row entry
F_ADJ_MISS = 27     # a path that leaves: normalize(rd) for the sky direction
F_ADJ_CAMERA = 30   # camera ray


_last_emit = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line per phase; phase_seconds is the host's time since the
    line before it, so the lines say where the script's time goes."""
    global _last_emit
    torch.cuda.synchronize()
    now = time.perf_counter()
    print(json.dumps({"phase": phase, "phase_seconds": round(now - _last_emit, 2), **kw}),
          flush=True)
    _last_emit = now


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return {"kind": name, "smi": smi}


# Winner source of a backward kernel's instantiation -> its name in the report.
_WINNERS = {"FetchWinners": "bwd_fetch", "RecordedWinners": "bwd_replay",
            "TracedWinners": "bwd_direct"}


def _ptxas_report(log: str) -> dict:
    """ptxas -v per kernel: registers, stack frame (local memory), spills."""
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            if "fwd_kernel" in sym:
                current = "fwd_b1" if "ILb1E" in sym else "fwd_b0"
            elif "peak_fma_kernel" in sym or "gather_kernel" in sym:
                current = "peak_fma" if "peak_fma" in sym else "gather_probe"
            else:
                current = next((v for k, v in _WINNERS.items() if k in sym), sym)
            kernels[current] = {"symbol": sym}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            kernels[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and current:
            kernels[current].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    return kernels


def sass_counts(library_path: str, opcodes=("FFMA", "FMUL", "FADD")) -> dict:
    """How many instructions of each opcode the library's SASS holds
    (cuobjdump -sass, beside nvcc)."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library_path], capture_output=True, text=True,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def phase_build() -> None:
    """The five libraries, one nvcc each, started together."""
    names = (mk.KERNEL_LIBRARY, mk.BWD_KERNEL_LIBRARY, mk.RETRACE_KERNEL_LIBRARY,
             peak.LIBRARY, gather_probe.LIBRARY)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        infos = list(pool.map(lambda n: build.build_library(n, verbose=True), names))
    wall = time.perf_counter() - t0
    kernels = {}
    for info in infos:
        kernels.update(_ptxas_report(info["log"]))
    # fwd_b0: plain forward, fwd_b1: recording; bwd_*: the backward kernel of
    # each winner source; the FMA peak (K6) and the gather (P1)
    if set(kernels) != {"fwd_b0", "fwd_b1", "bwd_fetch", "bwd_replay", "bwd_direct",
                        "peak_fma", "gather_probe"}:
        raise RuntimeError("expected seven kernels in the ptxas logs:\n"
                           + "\n".join(i["log"] for i in infos))
    # K6 must be fused multiply-adds although every library is built with
    # --fmad=false: the unrolled body alone holds 64 x 8 of them
    kernels["peak_fma"]["sass"] = sass_counts(infos[names.index(peak.LIBRARY)]["path"])
    if kernels["peak_fma"]["sass"]["FFMA"] < peak.UNROLL * peak.CHAINS:
        raise RuntimeError(f"the FMA peak kernel's SASS: {kernels['peak_fma']['sass']}")
    mk._kernel_function()  # load the libraries just built
    for kernel in mk.BWD_KERNELS:
        mk._bwd_kernel_function(kernel)
    peak._function()
    gather_probe._function()
    emit("build", seconds=round(wall, 2),
         seconds_each={n: round(i["seconds"], 2) for n, i in zip(names, infos)},
         flags=" ".join(build.NVCC_FLAGS), kernels=kernels)


def make_scenes(device) -> dict[str, Scene]:
    return {
        "scene_2": parse_scene_string(SCENE_2_TEXT, device=device),
        "room": parse_scene_string(ROOM_TEXT, device=device),
        "sixty_two_lights": Scene.from_objects(
            random_objects(60, seed=1, lights=(7, 20)), device=device),
    }


class WorkCounter(mk.DirectTracer):
    """A tracer that counts, per bounce, the lanes alive at its start, the
    lanes that then hit an object (active), those of them that hit a sphere,
    and the shadow samples that active lanes accept: the work an input
    needs, for the roofline bound."""

    def __init__(self, scene, draws):
        super().__init__(scene)
        self.draws = draws
        self.live = None
        self.alive, self.active, self.active_spheres, self.shadow_rays = [], [], [], []
        self.is_sphere = torch.tensor([t == OBJ_SPHERE for t in scene.obj_type],
                                      device=scene.packed_rows().device)

    def trace(self, ro, rd):
        h = super().trace(ro, rd)
        live = torch.ones_like(h.hit) if self.live is None else self.live
        self.alive.append(int(live.sum()))
        self.live = live & h.hit
        self.active.append(int(self.live.sum()))
        self.active_spheres.append(int((self.live & self.is_sphere[h.obj.clamp(min=0)]).sum()))
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
            "active_spheres": counter.active_spheres, "shadow_rays": counter.shadow_rays}


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


def random_cotangents(job, seed: int = 5):
    gen = torch.Generator(device=job.rows.device).manual_seed(seed)
    return torch.rand((10, job.height, job.width), generator=gen, device=job.rows.device) * 2 - 1


def plain_backward(scene, camera, cfg, width, height, seed, records, cot, slices: int = 1,
                   row0: int = 0, norm_height: int | None = None):
    """The plain version of the backward kernel over the frame, in `slices`
    row slices whose gradients are added (the frame's gradient is the sum
    over its pixels; at 1920x1080 one autograd graph of the whole frame
    would keep thousands of 8 MB intermediates). Returns (replayed planes,
    g_rows, g_cam)."""
    norm_height = norm_height or height
    h = height // slices
    if h * slices != height:
        raise ValueError(f"{height} rows do not split into {slices} slices")
    planes, g_rows, g_cam = [], 0, 0
    for k in range(slices):
        job = mk.make_tile_job(scene, camera, width, h, cfg, norm_height=norm_height,
                               aspect=width / norm_height)
        rows = slice(k * h, (k + 1) * h)
        u, v, draws = mk._sample_inputs(job, seed, row0 + k * h)
        p, r, c = mk.replay_vjp(job, u, v, draws, records[:, rows].contiguous(),
                                cot[:, rows].contiguous())
        planes.append(p)
        g_rows, g_cam = g_rows + r, g_cam + c
    return torch.cat(planes, dim=1), g_rows, g_cam


def gradient_agreement(got, want, rtol, atol, scale) -> dict:
    """|got - want| <= rtol * |want| + atol * scale per entry; raises when an
    entry is outside. `scale` broadcasts against the tensors."""
    if not torch.isfinite(got).all() or not torch.isfinite(want).all():
        raise RuntimeError("a gradient is not finite")
    err = (got - want).abs()
    allowed = rtol * want.abs() + atol * scale
    res = {"max_abs_err": float(err.max()),
           "worst_err_over_allowed": float((err / allowed.clamp(min=1e-30)).max()),
           "max_rel_err": float((err / (want.abs() + 1e-3 * scale).clamp(min=1e-30)).max())}
    if not bool((err <= allowed).all()):
        raise RuntimeError(f"backward kernel disagrees with its plain version: {res}")
    return res


def bwd_agreement(first, again, want) -> dict:
    """Two launches of a backward kernel, each (g_rows, g_cam), against its
    plain version's (g_rows, g_cam) under the BWD_* criterion; raises when an
    entry is outside. Also the spread between the two launches (float
    atomics add in another order each time) and the largest gradient."""
    (g_rows, g_cam), (again_rows, again_cam), (want_rows, want_cam) = first, again, want
    col_scale = want_rows.abs().amax(dim=0, keepdim=True)
    res = {"rows": gradient_agreement(g_rows, want_rows, BWD_ROWS_RTOL, BWD_ROWS_ATOL, col_scale),
           "camera": gradient_agreement(g_cam, want_cam, BWD_CAM_RTOL, BWD_CAM_ATOL,
                                        want_cam.abs().max())}
    gradient_agreement(again_rows, want_rows, BWD_ROWS_RTOL, BWD_ROWS_ATOL, col_scale)
    res["run_to_run_max_abs"] = float(torch.maximum((g_rows - again_rows).abs().max(),
                                                    (g_cam - again_cam).abs().max()))
    res["largest_gradient"] = float(want_rows.abs().max())
    return res


def compare_bwd(scene, camera, cfg, width, height, seed, row0=0, norm_height=None,
                slices=1) -> dict:
    """The recording forward's index planes, then the backward kernel (twice,
    once through the instantiation that also writes its replayed planes)
    against its plain version on the same records and seeded random
    cotangents."""
    job = mk.make_tile_job(scene, camera, width, height, cfg, norm_height=norm_height)
    planes, records = mk.run_tiles(job, seed, row0, record=True)
    cot = random_cotangents(job)
    g_rows, g_cam, primal = mk._launch_bwd("fetch", job, seed, row0, records, cot,
                                           want_primal=True)
    again_rows, again_cam = mk.run_bwd(job, seed, row0, records, cot)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_planes, want_rows, want_cam = plain_backward(
        scene, camera, cfg, width, height, seed, records, cot, slices, row0, norm_height)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    res = bwd_agreement((g_rows, g_cam), (again_rows, again_cam), (want_rows, want_cam))
    # exactly zero: the type-tag column, the unused pack entries, and the
    # rows of objects that no index plane names
    named = torch.zeros(scene.num_objects, dtype=torch.bool, device=records.device)
    named[records[records >= 0].unique().long()] = True
    if g_rows[:, 15].abs().max() != 0 or g_cam[14:].abs().max() != 0 \
            or g_rows[~named].abs().sum() != 0:
        raise RuntimeError("the backward kernel wrote where nothing can have a gradient")
    res["rows_no_pixel_hit"] = int((~named).sum())
    # forward and backward walk the same paths: the replayed planes are the
    # recording forward's, bit for bit, in the kernel and in the plain version
    res["kernel_primal_equal"] = bool(primal.equal(planes))
    res["plain_primal_equal"] = bool(plain_planes.equal(planes))
    res["plain_ms"] = plain_ms
    return res


def phase_bwd_kernel_vs_plain(scenes, camera) -> tuple[list, dict]:
    results = []
    many_lights = dataclasses.replace(scenes["sixty_two_lights"], emissive=None)
    cases = {"scene_2": scenes["scene_2"], "room": scenes["room"],
             "sixty_two_lights_full_scan": many_lights}
    for name, scene in cases.items():
        for jitter in (False, True):
            cfg = RenderConfig(pixel_jitter=jitter)
            results.append({"scene": name, "jitter": jitter, "size": [SMALL_W, SMALL_H],
                            **compare_bwd(scene, camera, cfg, SMALL_W, SMALL_H, seed=21 + jitter)})
    # more bounces than the kernel keeps entry states for (SAVED_BOUNCES = 16)
    results.append({"scene": "room", "bounces": 20, "size": [SMALL_W, SMALL_H],
                    **compare_bwd(scenes["room"], camera, RenderConfig(bounces=20),
                                  SMALL_W, SMALL_H, seed=23)})
    # a row slice: rows 48..95 of the 144-row frame
    results.append({"scene": "room", "row0": 48, "size": [SMALL_W, 48],
                    **compare_bwd(scenes["room"], camera, RenderConfig(), SMALL_W, 48, seed=24,
                                  row0=48, norm_height=SMALL_H)})
    # 1024 rows: 128 KB of dynamic shared memory per block
    big = Scene.from_objects(random_objects(1024, seed=2, lights=(7,)), device=camera.device)
    results.append({"scene": "1024_objects", "size": [64, 36],
                    **compare_bwd(big, camera, RenderConfig(bounces=2, shadow_samples=1),
                                  64, 36, seed=25)})
    # the shapes the training path gives the kernel
    at_full = {}
    for name in ("scene_2", "room"):
        res = compare_bwd(scenes[name], camera, RenderConfig(), WIDTH, HEIGHT, seed=17,
                          slices=TRAIN_SLICES)
        results.append({"scene": name, "size": [WIDTH, HEIGHT], "plain_slices": TRAIN_SLICES, **res})
        at_full[name] = res
    emit("bwd_kernel_vs_plain",
         criterion="|kernel - plain| <= rtol*|plain| + atol*max|plain of that column|",
         rows=[BWD_ROWS_RTOL, BWD_ROWS_ATOL], camera=[BWD_CAM_RTOL, BWD_CAM_ATOL],
         results=[{k: v for k, v in r.items() if not k.endswith("primal_equal")} for r in results])
    return results, at_full


def compare_retrace(mode: str, scene, camera, cfg, width, height, seed, row0=0,
                    norm_height=None) -> dict:
    """The backward kernel that `mode` ("replay" or "direct") runs against
    its plain version on seeded random cotangents: once through the public
    dispatch run_bwd (the launch counter says which kernel ran), once through
    the launch that also writes the planes its forward walk arrives at,
    which must be the plain forward kernel's (K1) bit for bit."""
    job = mk.make_tile_job(scene, camera, width, height, cfg.replace(bwd_mode=mode),
                           norm_height=norm_height)
    kernel = mk.backward_kernel(job)
    planes, _ = mk.run_tiles(job, seed, row0)
    cot = random_cotangents(job)
    before = dict(mk.launch_counts)
    g_rows, g_cam = mk.run_bwd(job, seed, row0, None, cot)
    rose = {k: mk.launch_counts[k] - before[k] for k in before}
    if rose != {k: int(k == BWD_COUNTER[kernel]) for k in before}:
        raise RuntimeError(f"bwd_mode={mode}: run_bwd launched {rose}")
    again_rows, again_cam, primal = mk._launch_bwd(kernel, job, seed, row0, None, cot,
                                                   want_primal=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_rows, want_cam = RETRACE_PLAIN[kernel](job, seed, row0, cot)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = {"kernel": kernel, **bwd_agreement((g_rows, g_cam), (again_rows, again_cam),
                                             (want_rows, want_cam))}
    if g_rows[:, 15].abs().max() != 0 or g_cam[14:].abs().max() != 0:
        raise RuntimeError(f"the {kernel} kernel wrote where nothing can have a gradient")
    res["rows_without_gradient"] = int((g_rows.abs().sum(dim=1) == 0).sum())
    res["kernel_primal_equal"] = bool(primal.equal(planes))
    res["plain_ms"] = plain_ms
    return res


def phase_bwd_modes_vs_plain(scenes, camera) -> list:
    """K4 ("replay") and K5 ("direct") against their plain versions at the
    small shape, under the criterion K3 is held to."""
    results = []
    for name in ("scene_2", "room"):
        for jitter in (False, True):
            for mode in ("replay", "direct"):
                results.append({"scene": name, "jitter": jitter, "size": [SMALL_W, SMALL_H],
                                **compare_retrace(mode, scenes[name], camera,
                                                  RenderConfig(pixel_jitter=jitter),
                                                  SMALL_W, SMALL_H, seed=31 + jitter)})
    for mode in ("replay", "direct"):
        # more bounces than either kernel keeps entry states for (16) and K4
        # keeps winners for (64 trace calls)
        results.append({"scene": "room", "bounces": 20, "size": [SMALL_W, SMALL_H],
                        **compare_retrace(mode, scenes["room"], camera, RenderConfig(bounces=20),
                                          SMALL_W, SMALL_H, seed=33)})
        # a row slice: rows 48..95 of the 144-row frame
        results.append({"scene": "room", "row0": 48, "size": [SMALL_W, 48],
                        **compare_retrace(mode, scenes["room"], camera, RenderConfig(), SMALL_W,
                                          48, seed=34, row0=48, norm_height=SMALL_H)})
    # 60 objects, two lights (full shadow scan): "direct" runs K4
    results.append({"scene": "sixty_two_lights", "bwd_mode": "direct", "size": [SMALL_W, SMALL_H],
                    **compare_retrace("direct", scenes["sixty_two_lights"], camera, RenderConfig(),
                                      SMALL_W, SMALL_H, seed=35)})
    if results[-1]["kernel"] != "replay":
        raise RuntimeError("bwd_mode='direct' at 60 objects did not run the replay kernel")
    # 1024 rows: 128 KB of dynamic shared memory per block, K4's trace loop
    # over all of them
    big = Scene.from_objects(random_objects(1024, seed=2, lights=(7,)), device=camera.device)
    results.append({"scene": "1024_objects", "size": [64, 36],
                    **compare_retrace("replay", big, camera,
                                      RenderConfig(bounces=2, shadow_samples=1), 64, 36, seed=36)})
    emit("bwd_modes_vs_plain",
         criterion="|kernel - plain| <= rtol*|plain| + atol*max|plain of that column|",
         rows=[BWD_ROWS_RTOL, BWD_ROWS_ATOL], camera=[BWD_CAM_RTOL, BWD_CAM_ATOL],
         results=[{k: v for k, v in r.items() if k != "kernel_primal_equal"} for r in results])
    return results


def phase_bwd_modes_full_size(scenes, camera) -> tuple[list, dict]:
    """At the training path's shape, default physics, one seed: K3 on K2's
    index planes, K4 and K5 from the scene alone compute the same gradient.
    K4 and K5 are held against K3 (itself held against its plain version at
    this shape in bwd_kernel_vs_plain) under the same criterion, and their
    forward walks against K1's planes."""
    results, worst = [], {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
        planes, records = mk.run_tiles(job, 17, record=True)
        cot = random_cotangents(job)
        ref_rows, ref_cam = mk._launch_bwd("fetch", job, 17, 0, records, cot)
        col_scale = ref_rows.abs().amax(dim=0, keepdim=True)
        for kernel in ("replay", "direct"):
            g_rows, g_cam, primal = mk._launch_bwd(kernel, job, 17, 0, None, cot,
                                                   want_primal=True)
            torch.cuda.synchronize()
            res = {"scene": name, "size": [WIDTH, HEIGHT], "kernel": kernel, "against": "fetch",
                   "rows": gradient_agreement(g_rows, ref_rows, BWD_ROWS_RTOL, BWD_ROWS_ATOL,
                                              col_scale),
                   "camera": gradient_agreement(g_cam, ref_cam, BWD_CAM_RTOL, BWD_CAM_ATOL,
                                                ref_cam.abs().max()),
                   "kernel_primal_equal": bool(primal.equal(planes))}
            results.append(res)
            worst[(name, kernel)] = max(res["rows"]["max_abs_err"], res["camera"]["max_abs_err"])
    emit("bwd_modes_full_size", criterion="as bwd_kernel_vs_plain, the fetch kernel as reference",
         results=[{k: v for k, v in r.items() if k != "kernel_primal_equal"} for r in results])
    return results, worst


def phase_stream_identity(fetch_results, retrace_results) -> None:
    """Every backward kernel regenerates the forward's draws and walks its
    paths: the fetch kernel's replayed primal, and its plain version's,
    equal the recording forward's ten planes bit for bit over every frame
    compared above; the replay and direct kernels' forward walks equal the
    plain forward kernel's planes bit for bit."""
    rows = []
    for r in fetch_results:
        rows.append({"scene": r["scene"], "size": r["size"], "walk": "fetch",
                     "equal": r["kernel_primal_equal"]})
        rows.append({"scene": r["scene"], "size": r["size"], "walk": "fetch plain",
                     "equal": r["plain_primal_equal"]})
    rows += [{"scene": r["scene"], "size": r["size"], "walk": r["kernel"],
              "equal": r["kernel_primal_equal"]} for r in retrace_results]
    if not all(r["equal"] for r in rows):
        raise RuntimeError(f"a backward walk left the forward's paths: {rows}")
    emit("stream_identity", frames=len(rows), all_bit_equal=True, results=rows)


def phase_peak_and_gather_vs_plain(scenes, camera, sky) -> dict:
    """K6 against its plain recurrence at the bench's shape, P1 against
    torch.take bit for bit at the probe's shape and at the sky's (the main
    path's texel indices into the 2048^2 cubemap), and their times."""
    dev = camera.device
    shape = (PEAK_GRID * 8, 128)
    gen = torch.Generator(device=dev).manual_seed(3)
    lo, hi = PEAK_CHECK_A
    a = lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def rel_err(got, want):
        return float(((got - want).abs() / want.abs()).max())

    plain = {}
    for iters in PEAK_CHECK_ITERS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain[iters] = peak.peak_fma_plain(a, iters)
        torch.cuda.synchronize()
        plain[iters, "ms"] = (time.perf_counter() - t0) * 1e3
    peak_res = []
    for iters in PEAK_CHECK_ITERS:
        got, want = peak.peak_fma(a, iters), plain[iters]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"peak_fma at {iters} iterations is not finite")
        # the negative controls: what a kernel with the other trip count, or
        # without the chains' offsets, would have returned
        x = a.clone()
        for _ in range(iters):
            x = x * x + a
        no_offsets = x * peak.CHAINS
        other = next(n for n in PEAK_CHECK_ITERS if n != iters)
        res = {"iters": iters, "max_abs_err": float((got - want).abs().max()),
               "max_rel_err": rel_err(got, want), "plain_ms": plain[iters, "ms"],
               "ms": device_seconds(lambda i: peak.peak_fma(a, iters), 5) * 1e3,
               "control_rel_err": {f"plain_at_{other}_iters": rel_err(got, plain[other]),
                                   "plain_without_offsets": rel_err(got, no_offsets)}}
        if res["max_rel_err"] > PEAK_RTOL:
            raise RuntimeError(f"peak_fma disagrees with its plain version: {res}")
        if min(res["control_rel_err"].values()) <= PEAK_RTOL:
            raise RuntimeError(f"the K6 check cannot tell a wrong kernel from a right one: {res}")
        peak_res.append(res)
    # the kernel at the bench's shape and iterations, on the bench's inputs
    rows = torch.arange(shape[0], dtype=torch.int32, device=dev).to(torch.float32)
    base = (rows[:, None] * 1e-6 + 0.25).expand(shape).contiguous()
    peak.peak_fma(base, PEAK_ITERS)
    main_ms = device_seconds(lambda i: peak.peak_fma(base, PEAK_ITERS), 5) * 1e3

    gather_res = []
    table, idx = gather_probe.probe_inputs(dev)
    cases = [("probe", table, idx)]
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
        planes, _ = mk.run_tiles(job, 17)
        flat, _ = mk._miss_texel_index(sky, planes)
        cases.append((name + "_sky", sky.packed, flat))
    for name, tbl, ix in cases:
        equal = bool(torch.equal(gather_probe.gather(tbl, ix), gather_probe.gather_plain(tbl, ix)))
        if not equal:
            raise RuntimeError(f"gather ({name}) differs from torch.take")
        gather_res.append({"case": name, "table_entries": tbl.numel(),
                           "indices": list(ix.shape), "bit_equal": equal})
    emit("peak_and_gather_vs_plain",
         peak={"criterion": "|kernel - plain| <= rtol * |plain|", "rtol": PEAK_RTOL,
               "input": "uniform [%g, %g]" % PEAK_CHECK_A, "shape": list(shape),
               "results": peak_res,
               "ms_at_bench_shape": main_ms, "bench_iters": PEAK_ITERS},
         gather={"criterion": "bit-equal to torch.take", "results": gather_res})
    return {"peak": peak_res, "peak_ms": main_ms}


def phase_bench_path(scenes, camera, sky) -> dict:
    """The port's bench (python -m ray_tracing_tpu_torch.bench) at its full
    size, its JSON line printed on a line of its own; every launch counter
    set to 0 before it and read after it. Then the sky cache's exactness on
    the bench's frame, with the sparse lookup off (the default) and on: 8
    samples of scene_2 with the cache seeded by sample 0, with a threaded
    cache and with a stale one from a turned camera, each equal bit for bit
    to the frame of the plain render_image's sky lookup, which keeps no
    cache."""
    mk.reset_launch_counts()
    peak.reset_launch_counts()
    gather_probe.reset_launch_counts()
    res = bench.run()
    torch.cuda.synchronize()
    print(json.dumps(res["line"]), flush=True)
    counts = {**mk.launch_counts, **peak.launch_counts, **gather_probe.launch_counts}
    for k in ("megakernel_fwd", "megakernel_fwd_record", "megakernel_bwd_fetch", "peak_fma"):
        if counts[k] < 1:
            raise RuntimeError(f"kernel {k} was not launched on the bench path")
    vpu = res["fma_peak"]
    if res["bwd_mode"] != "fetch" or not res["line"]["value"] > 0:
        raise RuntimeError(f"bench: bwd_mode {res['bwd_mode']}, value {res['line']['value']}")
    if not bench.PEAK_RATIO[0] <= vpu["ratio"] <= bench.PEAK_RATIO[1]:
        raise RuntimeError(f"bench: the FMA peak's self-check ratio is {vpu['ratio']}")
    if vpu["flops_per_s"] > 1.05 * PEAK_FLOPS:
        raise RuntimeError(f"bench: an FMA peak of {vpu['flops_per_s']:.4g} FLOP/s is above "
                           f"1.05 x the published {PEAK_FLOPS:.4g}: the timing is wrong")

    scene = scenes["scene_2"]
    turned = rotate(camera, *STALE_TURN, RenderConfig())
    equal = {}
    for lookup, cfg in (("full", RenderConfig()), ("sparse", SPARSE_SKY)):
        # the uncached frame: the kernel's samples, each through compose's
        # full lookup (render_frame keeping no sky cache)
        job = mk.make_tile_job(scene, camera, WIDTH, HEIGHT, cfg)
        dense, _ = mk.render_frame(job, mk.run_tiles_grad, 5, SPP, sky)
        seeded, cache = mk.render_image_cuda(scene, camera, WIDTH, HEIGHT, 5, spp=SPP,
                                             config=cfg, cubemap=sky, return_sky_cache=True)
        threaded = mk.render_image_cuda(scene, camera, WIDTH, HEIGHT, 5, spp=SPP, config=cfg,
                                        cubemap=sky, sky_cache=cache)
        _, stale = mk.render_image_cuda(scene, turned, WIDTH, HEIGHT, 6, spp=2, config=cfg,
                                        cubemap=sky, return_sky_cache=True)
        with_stale = mk.render_image_cuda(scene, camera, WIDTH, HEIGHT, 5, spp=SPP, config=cfg,
                                          cubemap=sky, sky_cache=stale)
        equal[lookup] = {"seeded": bool(seeded.equal(dense)),
                         "threaded": bool(threaded.equal(dense)),
                         "stale": bool(with_stale.equal(dense))}
    if not all(all(e.values()) for e in equal.values()):
        raise RuntimeError(f"the sky cache changed the frame: {equal}")
    emit("bench_path", line=res["line"], bwd_mode=res["bwd_mode"],
         seconds_per_sample=res["seconds_per_sample"],
         census_flops_per_px=res["census_flops_per_px"], census_tflops=res["census_tflops"],
         census_share_of_fma_peak=res["census_share_of_fma_peak"], fma_peak=vpu,
         bf16_peak=res["bf16_peak"], fingerprint=res["fingerprint"], launches=counts,
         cached_frames_equal_uncached=equal, spp=SPP)
    return {"counts": counts, "fma_peak": vpu}


def time_host(fn, n: int) -> float:
    """Median milliseconds of fn(i) on the host's clock, each call up to the
    end of its device work (for work that synchronises inside)."""
    fn(-1)
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_sky_gather(scenes, camera, sky) -> dict:
    """Module 8's question on the card. The gather probe (P1) through its own
    entry point, launch counter set to 0 before and read after; then, at the
    main path's shape, what a sample's sky lookup costs through the full
    gather and through the sparse cache, the P1 kernel and PyTorch's
    indexing on the real texel indices, and whole 8-spp frames with the
    sparse path on and off (in the order on, off, off, on)."""
    gather_probe.reset_launch_counts()
    probe = gather_probe.run()
    torch.cuda.synchronize()
    print(gather_probe.report(probe), flush=True)
    launches = dict(gather_probe.launch_counts)
    if not probe["correct"] or launches["gather_probe"] < 1:
        raise RuntimeError(f"gather probe: correct={probe['correct']}, launches {launches}")
    # the plain version as written (its int64 cast included), for the kernels line
    table, idx = gather_probe.probe_inputs(camera.device)
    probe["plain_ms"] = device_seconds(lambda i: gather_probe.gather_plain(table, idx), 8) * 1e3

    cfg = RenderConfig()
    per_scene = {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, cfg)
        p0, _ = mk.run_tiles(job, 4)
        p1, _ = mk.run_tiles(job, 5)
        flat0, miss0 = mk._miss_texel_index(sky, p0)
        flat1, miss1 = mk._miss_texel_index(sky, p1)
        packed0 = mk.sparse_sky_lookup(sky, flat0, miss0)
        fresh = miss1 & ~(miss0 & (flat1 == flat0))
        blocks = fresh.reshape(-1, mk.SPARSE_BLOCK).any(dim=1)
        r = {"miss_share": float(miss1.float().mean()),
             "fresh_pixel_share": float(fresh.float().mean()),
             "fresh_block_share": float(blocks.float().mean()),
             "full_lookup_compose_ms": time_host(lambda i: mk.compose(p1, sky, cfg), 10),
             "sparse_lookup_compose_ms": time_host(lambda i: mk.compose_sky(
                 p1, mk.unpack_texels(mk.sparse_sky_lookup(sky, flat1, miss1, flat0, packed0,
                                                           miss0))), 10),
             "gather_kernel_ms": device_seconds(lambda i: gather_probe.gather(sky.packed, flat1),
                                                8) * 1e3,
             "torch_index_ms": device_seconds(lambda i: sky.packed[flat1], 8) * 1e3}
        frames = {}
        for sparse in (True, False, False, True):
            frames.setdefault(sparse, []).append(time_frames(
                scenes[name], camera, sky, SPARSE_SKY if sparse else cfg, 5))
        r["frame_ms_sparse"] = frames[True]
        r["frame_ms_full"] = frames[False]
        per_scene[name] = r
    emit("sky_gather", probe=probe, launches=launches, size=[WIDTH, HEIGHT], spp=SPP,
         sky=[SKY_SIZE, SKY_SIZE], unit="ms (frame_ms_*: per 8-spp frame, two medians each)",
         **per_scene)
    return {"probe": probe, "launches": launches}


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
    for k in ("megakernel_fwd", "megakernel_fwd_record"):
        if counts[k] < 1:
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


def with_leaves(scene, camera):
    """(scene, camera, leaves) with every optimisable tensor a fresh leaf."""
    s = {n: getattr(scene, n).detach().clone().requires_grad_() for n in SCENE_PARAM_FIELDS}
    c = {n: getattr(camera, n).detach().clone().requires_grad_() for n in ("pos", "front", "up")}
    leaves = {**s, **{"camera." + n: t for n, t in c.items()}}
    return dataclasses.replace(scene, **s), dataclasses.replace(camera, **c), leaves


def frame_gradient(scene, camera, sky, cfg, seed: int = 1, spp: int = SPP) -> dict:
    """backward() of the sum of a WIDTHxHEIGHT frame of `spp` samples through
    the kernels: the gradient of every leaf."""
    scene_l, cam_l, leaves = with_leaves(scene, camera)
    img = mk.render_image_cuda(scene_l, cam_l, WIDTH, HEIGHT, seed=seed, spp=spp, config=cfg,
                               cubemap=sky)
    img.sum().backward()
    return {n: t.grad for n, t in leaves.items()}


def plain_replay_tiles(job, seed: int, row0: int = 0):
    """One sample's planes through the plain versions of both kernels, with
    autograd's own graph back to the job's rows and camera pack: the plain
    recording forward for the winner indices, then the plain fetch replay
    (what run_bwd_plain differentiates)."""
    with torch.no_grad():
        _, records = mk.run_tiles_plain(job, seed, row0, record=True)
    u, v, draws = mk._sample_inputs(job, seed, row0)
    return mk.replay_planes(job, job.rows, job.cam_pack, u, v, draws, records), None


def frame_gradient_plain(scene, camera, sky, cfg, seed: int = 1, spp: int = SPP) -> dict:
    """The same gradient through the plain versions of both kernels, slice by
    slice."""
    scene_l, cam_l, leaves = with_leaves(scene, camera)
    h = HEIGHT // TRAIN_SLICES
    for k in range(TRAIN_SLICES):
        job = mk.make_tile_job(scene_l, cam_l, WIDTH, h, cfg, norm_height=HEIGHT)
        img, _ = mk.render_frame(job, plain_replay_tiles, seed, spp, sky, row0=k * h)
        img.sum().backward()  # adds into the leaves' gradients
    return {n: t.grad for n, t in leaves.items()}


def phase_train_path(scenes, camera, sky) -> tuple[dict, dict]:
    cfg = RenderConfig()
    mk.reset_launch_counts()
    report = {}

    # (a) the gradient of a frame's sum with respect to every leaf
    grads = {}
    for name in ("scene_2", "room"):
        before = dict(mk.launch_counts)
        torch.cuda.reset_peak_memory_stats()
        grads[name] = frame_gradient(scenes[name], camera, sky, cfg)
        torch.cuda.synchronize()
        rose = {k: mk.launch_counts[k] - before[k] for k in before}
        if rose != {**dict.fromkeys(before, 0), "megakernel_fwd_record": SPP,
                    "megakernel_bwd_fetch": SPP}:
            raise RuntimeError(f"{name}: launch counters rose by {rose}")
        for leaf, g in grads[name].items():
            if g is None or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: gradient of {leaf} is missing or not finite")
        report[name] = {"max_memory_allocated": torch.cuda.max_memory_allocated(),
                        "albedo_grad_abs_sum": float(grads[name]["albedo"].abs().sum())}

    # (b) five steps of fit on the room, albedo and position perturbed, in
    # the default mode and in "direct"
    fit_cfg = RenderConfig(env_filter="bilinear", soft_silhouette_temp=0.08)
    room = scenes["room"]
    with torch.no_grad():
        target = mk.render_image_cuda(room, camera, WIDTH, HEIGHT, seed=99, spp=SPP,
                                      config=fit_cfg, cubemap=sky)
    gen = torch.Generator().manual_seed(0)
    noise_a = 0.2 * torch.randn(room.albedo.shape, generator=gen)
    noise_p = 0.05 * torch.randn(room.p0.shape, generator=gen)
    start = dataclasses.replace(
        room, albedo=(room.albedo + noise_a.to(room.device)).clamp(0.05, 1.0),
        p0=room.p0 + noise_p.to(room.device))
    report["fit"] = run_fit(start, camera, target, sky, fit_cfg)
    before = dict(mk.launch_counts)
    report["fit_direct"] = run_fit(start, camera, target, sky, fit_cfg.replace(bwd_mode="direct"))
    rose = {k: mk.launch_counts[k] - before[k] for k in before}
    if rose["megakernel_bwd_direct"] != FIT_STEPS * SPP or rose["megakernel_fwd_record"] \
            or rose["megakernel_bwd_fetch"] or rose["megakernel_bwd_replay"]:
        raise RuntimeError(f"fit in direct mode launched {rose}")
    report["fit_direct"]["launches"] = rose

    # (d) a gradient whose index planes would pass the fetch budget: the
    # default configuration runs "replay", the forward keeps nothing
    cfg_budget = RenderConfig()
    mode = mk.effective_bwd_mode(room, cfg_budget, WIDTH, HEIGHT, OVER_BUDGET_SPP)
    if mode != "replay":
        raise RuntimeError(f"{OVER_BUDGET_SPP} samples: effective_bwd_mode says {mode}")
    before = dict(mk.launch_counts)
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    room_l, cam_l, leaves = with_leaves(room, camera)
    img = mk.render_image_cuda(room_l, cam_l, WIDTH, HEIGHT, seed=1, spp=OVER_BUDGET_SPP,
                               config=cfg_budget, cubemap=sky)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img.sum().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {n: t.grad for n, t in leaves.items()}
    rose = {k: mk.launch_counts[k] - before[k] for k in before}
    want = {k: 0 for k in before}
    want.update(megakernel_fwd=OVER_BUDGET_SPP, megakernel_bwd_replay=OVER_BUDGET_SPP)
    if rose != want:
        raise RuntimeError(f"the over-budget gradient launched {rose}")
    for leaf, g in grads.items():
        if g is None or not torch.isfinite(g).all():
            raise RuntimeError(f"over-budget gradient of {leaf} is missing or not finite")
    report["over_budget"] = {
        "scene": "room", "spp": OVER_BUDGET_SPP, "effective_bwd_mode": mode, "launches": rose,
        "seconds": t2 - t0, "forward_seconds": t1 - t0, "backward_seconds": t2 - t1,
        # cudaMalloc failures the caching allocator met and retried after
        # freeing its cache (each one synchronises)
        "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_reserved": torch.cuda.memory_reserved(),
        "fetch_index_plane_bytes": OVER_BUDGET_SPP * mk.record_layout(cfg_budget, True)
                                   * WIDTH * HEIGHT * 4,
        "albedo_grad_abs_sum": float(grads["albedo"].abs().sum())}

    # (c) the invert app at its default size
    with tempfile.TemporaryDirectory() as tmp:
        scene_file = os.path.join(tmp, "scene_2.txt")
        with open(scene_file, "w") as f:
            f.write(SCENE_2_TEXT)
        t0 = time.perf_counter()
        rc = invert_main(["--scene", scene_file])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"invert returned {rc}")
        report["invert"] = {"seconds": round(time.perf_counter() - t0, 3)}

    counts = dict(mk.launch_counts)  # read right after the training path
    for k in ("megakernel_fwd", "megakernel_fwd_record", *BWD_COUNTER.values()):
        if counts[k] < 1:
            raise RuntimeError(f"kernel {k} was not launched on the training path")

    # (a) held against the plain versions, slice by slice, one sample deep:
    # the plain backward takes seconds per sample, and a frame of SPP samples
    # is the mean of SPP such frames (the kernel itself is held against its
    # plain version at this shape in bwd_kernel_vs_plain)
    for name in ("scene_2", "room"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one_sample = frame_gradient(scenes[name], camera, sky, cfg, spp=1)
        plain = frame_gradient_plain(scenes[name], camera, sky, cfg, spp=1)
        torch.cuda.synchronize()
        worst = {}
        for leaf, g in one_sample.items():
            cam = leaf.startswith("camera.")
            rtol, atol = (BWD_CAM_RTOL, BWD_CAM_ATOL) if cam else (BWD_ROWS_RTOL, BWD_ROWS_ATOL)
            scale = plain[leaf].abs().max()
            worst[leaf] = gradient_agreement(g, plain[leaf], rtol, atol, scale)["worst_err_over_allowed"]
        report[name]["worst_err_over_allowed_by_leaf"] = worst
        report[name]["plain_seconds"] = round(time.perf_counter() - t0, 2)
        report[name]["plain_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit("train_path", size=[WIDTH, HEIGHT], spp=SPP, sky=[SKY_SIZE, SKY_SIZE], launches=counts,
         plain_slices=TRAIN_SLICES, plain_spp=1, **report)
    return counts, report


def run_fit(start, camera, target, sky, cfg) -> dict:
    """FIT_STEPS steps of fit on albedo and p0 from `start`; raises when a
    loss is not finite, the loss did not fall or a leaf did not move."""
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    # the callback reads each loss, which waits for the step: a step's time
    # is then the distance between two stamps
    fitted, _, losses = fit(start, camera, target, scene_fields=("albedo", "p0"),
                            steps=FIT_STEPS, lr=2e-2, spp=SPP, config=cfg, cubemap=sky, seed=3,
                            callback=lambda i, loss, params: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    if len(losses) != FIT_STEPS or not all(l == l and abs(l) != float("inf") for l in losses):
        raise RuntimeError(f"fit ({cfg.bwd_mode}): losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"fit ({cfg.bwd_mode}): the loss did not fall: {losses}")
    moved = {f: float((getattr(fitted, f) - getattr(start, f)).abs().max()) for f in ("albedo", "p0")}
    if not all(m > 0 for m in moved.values()):
        raise RuntimeError(f"fit ({cfg.bwd_mode}): a trained leaf did not move: {moved}")
    return {"bwd_mode": cfg.bwd_mode, "losses": losses, "moved_max_abs": moved,
            "first_step_ms": step_ms[0],  # takes in every kernel's first use
            "ms_per_step": statistics.median(step_ms[1:]),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


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


def time_bwd(job, n: int, warmup: int = 3) -> tuple[float, float]:
    """Median milliseconds of one backward launch over n launches with
    distinct seeds, each on the index planes of its own forward: with random
    cotangents, and with all-zero cotangents (every contribution is then
    zero and no atomic add is made: what is left is the replay, the adjoint
    and the shuffles)."""
    recs = [mk.run_tiles(job, s, record=True)[1] for s in range(n + warmup)]
    cot = random_cotangents(job)
    return tuple(
        time_launches(lambda s: mk.run_bwd(job, s % len(recs), 0, recs[s % len(recs)], c),
                      n, warmup)
        for c in (cot, torch.zeros_like(cot)))


def time_retrace(job, kernel: str, n: int, warmup: int = 3) -> tuple[float, float]:
    """time_bwd for the replay or the direct kernel, which need no forward
    before them."""
    cot = random_cotangents(job)
    return tuple(
        time_launches(lambda s: mk._launch_bwd(kernel, job, s, 0, None, c), n, warmup)
        for c in (cot, torch.zeros_like(cot)))


def time_fwd_bwd(scene, camera, sky, cfg, n: int) -> float:
    """Median milliseconds per sample on the host's clock of a whole
    differentiated frame (render, sum, backward) of SPP samples, up to the
    end of the device's work."""
    times = []
    for i in range(n + 1):  # the first frame warms up and is dropped
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame_gradient(scene, camera, sky, cfg, seed=200 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / SPP)
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
        out[name]["bwd_kernel_ms"], out[name]["bwd_kernel_zero_cotangents_ms"] = time_bwd(job, 20)
        for kernel in ("replay", "direct"):
            out[name][f"bwd_{kernel}_ms"], out[name][f"bwd_{kernel}_zero_cotangents_ms"] = \
                time_retrace(job, kernel, 20)
        planes, _ = mk.run_tiles(job, 5)
        out[name]["sky_compose_ms"] = time_launches(
            lambda s: mk.compose(planes, sky, cfg), 20)
        out[name]["frame_ms"] = time_frames(scenes[name], camera, sky, cfg, 7)
        out[name]["fwd_bwd_ms_per_sample"] = time_fwd_bwd(scenes[name], camera, sky, cfg, 3)
        for mode in ("replay", "direct"):
            out[name][f"fwd_bwd_{mode}_ms_per_sample"] = time_fwd_bwd(
                scenes[name], camera, sky, cfg.replace(bwd_mode=mode), 3)
        # the plain versions of K4 and K5 at the shape they are compared at
        small = mk.make_tile_job(scenes[name], camera, SMALL_W, SMALL_H, cfg)
        for kernel in ("replay", "direct"):
            out[name][f"bwd_{kernel}_small_ms"] = time_retrace(small, kernel, 10)[0]
            cot = random_cotangents(small)
            out[name][f"bwd_{kernel}_small_plain_ms"] = time_launches(
                lambda s: RETRACE_PLAIN[kernel](small, s, 0, cot), 1, warmup=1)
    emit("timing", size=[WIDTH, HEIGHT], spp_per_frame=SPP, small_size=[SMALL_W, SMALL_H],
         unit="ms per sample, median (frame_ms: per frame of spp_per_frame samples)", **out)
    return out


def phase_large_scene(camera) -> None:
    """The fetch (K3) and the replay (K4) backward on the largest scene the
    parser admits, at the training path's shape and default physics, beside
    the forward kernel (K1): medians of 3 launches each, distinct seeds."""
    big = Scene.from_objects(random_objects(1024, seed=2, lights=(7,)), device=camera.device)
    job = mk.make_tile_job(big, camera, WIDTH, HEIGHT, RenderConfig())
    cot = random_cotangents(job)
    recs = [mk.run_tiles(job, s, record=True)[1] for s in range(3)]
    out = {"k1_ms": time_launches(lambda s: mk.run_tiles(job, s), 3, warmup=0),
           "k3_ms": time_launches(lambda s: mk._launch_bwd("fetch", job, s % 3, 0, recs[s % 3], cot),
                                  3, warmup=0),
           "k4_ms": time_launches(lambda s: mk._launch_bwd("replay", job, s, 0, None, cot),
                                  3, warmup=0)}
    k2_ms = time_launches(lambda s: mk.run_tiles(job, s, record=True), 1, warmup=0)
    emit("large_scene", objects=big.num_objects, size=[WIDTH, HEIGHT], launches_each=3,
         unit="ms per sample, median", k2_ms_one_launch=k2_ms,
         fetch_fwd_bwd_ms=k2_ms + out["k3_ms"], replay_fwd_bwd_ms=out["k1_ms"] + out["k4_ms"], **out)


def trace_flops(scene: Scene) -> tuple[int, int]:
    """Float operations of one closest-hit trace (the loop over every object
    and the hit) and of one shadow trace (occlusion-only with one light, the
    full scan otherwise), from csrc/rt_device.cuh."""
    n_sph = sum(t == OBJ_SPHERE for t in scene.obj_type)
    n_cube = scene.num_objects - n_sph
    f_trace = F_RAY + n_sph * F_SPHERE + n_cube * F_CUBE + F_FINISH
    if sum(bool(e) for e in (scene.emissive or ())) == 1:
        light_sph = scene.obj_type[scene.light_index] == OBJ_SPHERE
        f_shadow = (F_RAY + (F_SPHERE if light_sph else F_CUBE) + 1
                    + (n_sph - light_sph) * F_OCC_SPHERE
                    + (n_cube - (not light_sph)) * F_CUBE)
    else:
        f_shadow = F_RAY + n_sph * F_SPHERE + n_cube * F_CUBE
    return f_trace, f_shadow


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
    pixels = WIDTH * HEIGHT
    has_light = scene.has_light and cfg.shadow_samples > 0
    ns = cfg.shadow_samples if has_light else 0
    f_trace, f_shadow = trace_flops(scene)
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


def trace_work(scene: Scene, stats: dict, cfg: RenderConfig) -> int:
    """Float operations of one pass of tracing over this input: the
    closest-hit trace of every alive lane, and the shadow ray and shadow
    trace of every accepted sample of an active lane."""
    f_trace, f_shadow = trace_flops(scene)
    has_light = scene.has_light and cfg.shadow_samples > 0
    return sum(stats["alive"][b] * f_trace
               + (stats["shadow_rays"][b] * (F_SHADOW_RAY + f_shadow) if has_light else 0)
               for b in range(cfg.bounces))


def bound_bwd(scene: Scene, stats: dict, cfg: RenderConfig, retrace: bool = False) -> dict:
    """Least time the card could take for one backward sample of this input:
    from the recorded index planes (the fetch kernel), or, with `retrace`,
    from the scene alone (the replay and the direct kernel, which compute the
    same gradient and so share one bound).

    Bytes, what this input's gradients need and no more: the scene and the
    camera read and both gradients written once; the three radiance
    cotangents of every pixel whose path hits anything (a path that leaves at
    once adds nothing to the radiance); the six sky cotangents of every pixel
    whose path leaves the scene; from the index planes, one primary index per
    bounce a path is alive in (the one that says it left included) and one
    shadow index per accepted sample of an active lane. The tenth cotangent
    plane has nowhere to go and a dead lane's indices are never needed.

    Operations: for every bounce a path is alive in and hits something, its
    shading plus the adjoint and the sum into the row; for the bounce a path
    leaves at, the sky direction's adjoint; the camera ray per pixel. The
    branch is counted as specular on every hit (the diffuse adjoint is
    shorter), so the operation count is an upper estimate. The hits
    themselves: from an index, the replay of that one hit (its ray, the
    winner's intersection and the hit point); with `retrace`, one pass of
    tracing (trace_work) instead, and no index is read."""
    n = scene.num_objects
    pixels = WIDTH * HEIGHT
    has_light = scene.has_light and cfg.shadow_samples > 0
    ns = cfg.shadow_samples if has_light else 0
    per_live = F_SHADE + F_ADJ_COMMON + F_ADJ_BRANCH + F_ADJ_ROUTE
    if has_light:
        per_live += F_LIGHT_BLEND + ns * F_ACCEPT + F_ADJ_LIGHT
    flops = pixels * F_ADJ_CAMERA
    nbytes = 2 * (n * 16 * 4 + 16 * 4) + 3 * 4 * stats["active"][0]
    for b in range(cfg.bounces):
        alive, active = stats["alive"][b], stats["active"][b]
        spheres = stats["active_spheres"][b]
        leaving = alive - active
        flops += active * per_live + spheres * F_ADJ_SPHERE + (active - spheres) * F_ADJ_CUBE
        flops += leaving * F_ADJ_MISS
        nbytes += 6 * 4 * leaving
        if has_light:
            flops += stats["shadow_rays"][b] * (F_SHADOW_SUM + 3)
        if not retrace:
            # 6: the hit point; a sphere's normal is the rest of F_FINISH
            flops += (spheres * (F_RAY + F_SPHERE + F_FINISH)
                      + (active - spheres) * (F_RAY + 6 + F_CUBE) + leaving * F_RAY)
            nbytes += 4 * alive + (4 * stats["shadow_rays"][b] if has_light else 0)
    if retrace:
        flops += trace_work(scene, stats, cfg)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            # what the kernel's interface moves if every plane is read in full
            "bytes_all_planes": 2 * (n * 16 * 4 + 16 * 4)
                                + (10 + (0 if retrace else mk.record_layout(cfg, scene.has_light)))
                                * pixels * 4}


def peak_bound() -> dict:
    """Least time of one K6 launch on the bench path: per element 8 chain
    starts, 8 x iters fused multiply-adds (2 operations each) and 7 adds at
    the FP32 peak, against 4 bytes read and 4 written per element."""
    elems = PEAK_GRID * 8 * 128
    flops = elems * (peak.CHAINS + 2 * peak.CHAINS * PEAK_ITERS + peak.CHAINS - 1)
    nbytes = 2 * 4 * elems
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def phase_kernels(scenes, at_full, bwd_at_full, retrace, retrace_full, counts, train_counts,
                  timing, checks, bench_res, sky_res) -> None:
    cfg = RenderConfig()
    rows = []
    # the census of the plain estimator (utils/flops.py, every lane of every
    # bounce at the JAX census's prices) beside the hand counts of the bounds
    # (the lanes this input needs): per pixel, forward (estimator and draws),
    # the fetch VJP, and the replay kernel's recording pass plus its VJP
    census = {}
    for name in ("scene_2", "room"):
        fwd = (flops.physics_cost_per_pixel(scenes[name], cfg)["flops_per_px"]
               + flops.prng_flops_per_pixel(cfg, scenes[name].has_light))
        census[name] = {
            "fwd": fwd,
            "fetch": flops.fetch_vjp_cost_per_pixel(scenes[name], cfg)["flops_per_px"],
            "retrace": fwd + flops.replay_vjp_cost_per_pixel(scenes[name], cfg)["flops_per_px"]}
    pixels = WIDTH * HEIGHT
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
                "hand_flops_per_px": b["flops"] / pixels,
                "census_flops_per_px": census[name]["fwd"],
            }
        lead = per_scene["scene_2"]  # the main path's first workload
        rows.append({
            "name": kname, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/megakernel_fwd.cu",
            "replaces": replaces,
            # the serving path for the forward, the training path for the
            # recording forward, whose planes the backward consumes
            "launches": train_counts[kname] if record else counts[kname],
            "launches_by_path": {"serving": counts[kname], "training": train_counts[kname]},
            "max_abs_err": max(p["max_abs_err"] for p in per_scene.values()),
            "max_share_off": max(p["max_share_off"] for p in per_scene.values()),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a path tracer
            "shape": [WIDTH, HEIGHT], "scene": "scene_2", "per_scene": per_scene,
        })
    per_scene = {}
    for name in ("scene_2", "room"):
        cmp_ = bwd_at_full[name]
        per_scene[name] = {
            "ms": timing[name]["bwd_kernel_ms"],
            "zero_cotangents_ms": timing[name]["bwd_kernel_zero_cotangents_ms"],
            "plain_ms": cmp_["plain_ms"],
            "max_abs_err": max(cmp_["rows"]["max_abs_err"], cmp_["camera"]["max_abs_err"]),
            "max_rel_err": cmp_["rows"]["max_rel_err"],
            "largest_gradient": cmp_["largest_gradient"],
            **bound_bwd(scenes[name], at_full[name]["stats"], cfg),
            "census_flops_per_px": census[name]["fetch"],
        }
        per_scene[name]["hand_flops_per_px"] = per_scene[name]["flops"] / pixels
    lead = per_scene["scene_2"]
    rows.append({
        "name": "megakernel_bwd_fetch", "route": "cuda",
        "source": "ray_tracing_tpu_torch/kernels/csrc/megakernel_bwd.cu",
        "replaces": "ray_tracing_tpu/kernels/megakernel.py:1140 (_run_bwd, fetch arm; "
                    "_bwd_kernel_fetch :916; K3)",
        "launches": train_counts["megakernel_bwd_fetch"],
        "launches_by_path": {"serving": counts["megakernel_bwd_fetch"],
                             "training": train_counts["megakernel_bwd_fetch"]},
        "max_abs_err": max(p["max_abs_err"] for p in per_scene.values()),
        "max_rel_err": max(p["max_rel_err"] for p in per_scene.values()),
        "ms": lead["ms"], "plain_ms": lead["plain_ms"],
        "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a path tracer's adjoint
        "shape": [WIDTH, HEIGHT], "scene": "scene_2", "per_scene": per_scene,
    })
    for kernel, replaces in (
        ("replay", "ray_tracing_tpu/kernels/megakernel.py:1176 (_run_bwd, replay arm; "
                   "_bwd_kernel_replay :818; K4)"),
        ("direct", "ray_tracing_tpu/kernels/megakernel.py:1176 (_run_bwd, direct arm; "
                   "_bwd_kernel :625; K5)"),
    ):
        name = BWD_COUNTER[kernel]
        small = [r for r in retrace if r["kernel"] == kernel]
        per_scene = {}
        for sc in ("scene_2", "room"):
            b = bound_bwd(scenes[sc], at_full[sc]["stats"], cfg, retrace=True)
            per_scene[sc] = {
                "ms": timing[sc][f"bwd_{kernel}_ms"],
                "zero_cotangents_ms": timing[sc][f"bwd_{kernel}_zero_cotangents_ms"],
                "small_ms": timing[sc][f"bwd_{kernel}_small_ms"],
                "plain_ms": timing[sc][f"bwd_{kernel}_small_plain_ms"],
                "max_abs_err_vs_fetch_kernel": retrace_full[(sc, kernel)],
                **b,
                "hand_flops_per_px": b["flops"] / pixels,
                "census_flops_per_px": census[sc]["retrace"],
            }
            if kernel == "direct":
                # not the bound: the direct kernel traces every live bounce a
                # second time in its reverse sweep instead of keeping winners
                per_scene[sc]["flops_as_run"] = b["flops"] + trace_work(
                    scenes[sc], at_full[sc]["stats"], cfg)
        lead = per_scene["scene_2"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/megakernel_bwd_retrace.cu",
            "replaces": replaces,
            "launches": train_counts[name],
            "launches_by_path": {"serving": counts[name], "training": train_counts[name]},
            # against its plain version, every small case of bwd_modes_vs_plain
            "max_abs_err": max(max(r["rows"]["max_abs_err"], r["camera"]["max_abs_err"])
                               for r in small),
            "max_rel_err": max(r["rows"]["max_rel_err"] for r in small),
            "ms": lead["ms"],
            # the plain version runs at the comparison shape only: at 1920x1080
            # its autograd graph through the trace would not fit the card
            "plain_ms": lead["plain_ms"], "plain_shape": [SMALL_W, SMALL_H],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a path tracer's adjoint
            "shape": [WIDTH, HEIGHT], "scene": "scene_2", "per_scene": per_scene,
        })
    b = peak_bound()
    plain_at = checks["peak"][-1]  # the plain version runs 128 iterations, not the bench's
    rows.append({
        "name": "peak_fma", "route": "cuda",
        "source": "ray_tracing_tpu_torch/kernels/csrc/peak_fma.cu",
        "replaces": "ray_tracing_tpu/utils/flops.py:316 (measured_vpu_peak; _peak_kernel :256; K6)",
        "launches": bench_res["counts"]["peak_fma"],
        "max_abs_err": max(r["max_abs_err"] for r in checks["peak"]),
        "max_rel_err": max(r["max_rel_err"] for r in checks["peak"]),
        "ms": checks["peak_ms"], "plain_ms": plain_at["plain_ms"],
        "plain_iters": plain_at["iters"], "ms_at_plain_iters": plain_at["ms"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "flops": b["flops"],
        "library_ms": None,  # no PyTorch call computes an FMA chain in one launch
        "shape": [PEAK_GRID * 8, 128], "iters": PEAK_ITERS,
        "measured_fp32_flops_per_s": bench_res["fma_peak"]["flops_per_s"],
    })
    probe = sky_res["probe"]
    rows.append({
        "name": "gather_probe", "route": "cuda",
        "source": "ray_tracing_tpu_torch/kernels/csrc/gather_probe.cu",
        "replaces": "benchmarks/vmem_gather_probe.py:38 (run; kernel :31; P1)",
        "launches": sky_res["launches"]["gather_probe"],
        "max_abs_err": 0,  # integers, bit-equal to torch.take (phase peak_and_gather_vs_plain)
        "ms": probe["kernel_ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": "bytes",
        "library_ms": probe["library_ms"],  # table[idx] on the same int32 indices
        "shape": [gather_probe.TABLE, gather_probe.N_IDX],
        "ns_per_idx": probe["kernel_ns_per_idx"], "library_ns_per_idx": probe["library_ns_per_idx"],
        "take_int64_ms": probe["take_int64_ms"],  # torch.take, which reads int64 indices
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
    bwd_results, bwd_at_full = phase_bwd_kernel_vs_plain(scenes, camera)
    retrace = phase_bwd_modes_vs_plain(scenes, camera)
    retrace_full_results, retrace_full = phase_bwd_modes_full_size(scenes, camera)
    phase_stream_identity(bwd_results, retrace + retrace_full_results)
    checks = phase_peak_and_gather_vs_plain(scenes, camera, sky)
    counts = phase_main_path(scenes, camera, sky)
    phase_cli()
    train_counts, _ = phase_train_path(scenes, camera, sky)
    bench_res = phase_bench_path(scenes, camera, sky)
    sky_res = phase_sky_gather(scenes, camera, sky)
    timing = phase_timing(scenes, camera, sky)
    phase_large_scene(camera)
    torch.cuda.synchronize()
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    phase_kernels(scenes, at_full, bwd_at_full, retrace, retrace_full, counts, train_counts,
                  timing, checks, bench_res, sky_res)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
