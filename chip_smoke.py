#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels (the forward megakernel; the three backward kernels
"fetch", "replay" and "direct"; the FMA peak kernel, the gather probe, and a
sample's sky compose and its adjoint) from the sources in this checkout,
holds each against its plain PyTorch version on
the card, renders the serving path (scene_2 and a lit room at 1920x1080,
default physics, a 2048^2 packed cubemap) through the entry points a user
would call, runs the command line, then the interactive frame path (the
native layer built with the host's C++ compiler: its parser and PNG writer;
a skybox decoded and read back from its memo; progressive films through K1
against the plain pass; films at the reference's 1280x960 timed pass by
pass; the HTTP render service on the room, in-process; the terminal viewer
under a pseudo-terminal), then drives the training path at 1920x1080 (the
gradient of a frame's sum, five steps of `fit` in fetch and in direct mode,
a 100-sample gradient past the fetch budget, which runs "replay", the
invert app), the sharded paths of parallel/ (a frame and a train step on
meshes of virtual cells of the card against the one-device ones, two
processes on the card through gloo, fit's checkpoints and resume, the
invert app's coarse-to-fine schedule and resume, the pose recovery and the
sharded fly-through, entry.dryrun_multichip), the measurement path (the
port's bench, whose JSON line it prints on a line of its own, and the
gather probe, on its own indices and on the sky's) and times the kernels.
Every phase prints one JSON line with the seconds it took (three to four
minutes in all on an H100, the kernels' build included); any phase that
fails raises and the run exits non-zero.
Needs one CUDA device, nvcc and a C++ compiler; imports nothing of JAX.
The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

    python3 chip_smoke.py --times [CHECKOUT ...]

builds only the forward, backward and gather libraries and prints one JSON
line of K1-K5 and P1 times (kernel_times), for comparing versions of the
kernels; given
checkouts (directories holding another version of the package), it times
each of them in the order given, one process each, and prints one JSON line
of all the turns (kernel_times_in_turns): `--times variants/parent . .
variants/parent` times the parent and this checkout in turns on one card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import sky_work
from portbench.reference.pathtracer import V as RefV
from ray_tracing_tpu_torch import bench, native
from ray_tracing_tpu_torch.apps.cli import FULL_RES_SPP, make_cuda_render_fn
from ray_tracing_tpu_torch.apps.cli import main as cli_main
from ray_tracing_tpu_torch.apps.flythrough import main as fly_main
from ray_tracing_tpu_torch.apps.invert import main as invert_main
from ray_tracing_tpu_torch.apps.pose_recovery import main as pose_main
from ray_tracing_tpu_torch.apps.serve import RenderService, make_handler, resolve_u8
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff.checkpoint import latest_step
from ray_tracing_tpu_torch.diff.inverse import SCENE_PARAM_FIELDS, fit, make_train_step, scene_bounds
from ray_tracing_tpu_torch.entry import dryrun_multichip
from ray_tracing_tpu_torch.io.image import (
    SKYBOX_FILES,
    load_cubemap,
    load_image,
    png_size,
    read_png,
    save_png,
    skybox_cache_dir,
    to_uint8,
)
from ray_tracing_tpu_torch.kernels import build, peak
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops.cubemap import (
    CubemapData,
    bilinear_adjoint_scale,
    checker_sky,
    constant_sky,
    gradient_sky,
)
from ray_tracing_tpu_torch.ops.sampling import PhiloxDraws, global_pixel_index
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.parallel.distributed import global_mesh, initialize, local_tile_range
from ray_tracing_tpu_torch.parallel.mesh import make_mesh
from ray_tracing_tpu_torch.parallel.render import render_image_sharded
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.film import (
    Film,
    lowres_size,
    pass_seed,
    progressive_scales,
    render_pass,
)
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.native import parse_objects_native
from ray_tracing_tpu_torch.scene.parser import parse_objects, parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import (
    POSE_SEARCH_TEXT,
    ROOM_TEXT,
    SCENE_2_TEXT,
    random_objects,
)
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, Scene
from ray_tracing_tpu_torch.utils import flops, gather_probe, profiling
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
# (kernels/megakernel.py::FETCH_RECORD_BUDGET_BYTES) on the room: 40 int8
# planes of 2.07 MB per sample, so 386 samples or more run "replay" (97 at
# four bytes an index).
OVER_BUDGET_SPP = 386
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
# The gather (P1) against torch.take at ragged lengths (n mod 4 = 1, 3, 3)
# and on views of the probe's indices at storage offsets of 1-3 and 5
# indices, past a 16-byte boundary.
GATHER_RAGGED = (1, 7, 8 * 1021 + 3)
GATHER_OFFSETS = (1, 2, 3, 5)
# Windows of the gather's times in gather_times, of which the median counts.
GATHER_WINDOWS = 5

# Float operations (add, sub, mul, div, sqrt each count 1; comparisons,
# selects and the integer work of the generator count 0), counted by hand
# from csrc/megakernel_fwd.cu and csrc/rt_device.cuh. A sphere's
# radius*radius and a box's lo + size are an object's, not a ray's: the
# trace table computes them once per block, and no test counts them.
F_RAY = 19          # make_ray: normalize 10, d.d 5, 0.5/a 1, three reciprocals
F_SPHERE = 24       # sphere_t
F_CUBE = 12         # box_t: two slab triples
F_OCC_SPHERE = 19   # sphere_occludes
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
    # the SM clock the issue-rate floor assumes: the card's highest
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         max_sm_clock_mhz=float(clock), sms=sms, torch=torch.__version__, cuda=torch.version.cuda)
    return {"kind": name, "smi": smi, "max_sm_clock_mhz": float(clock), "sms": sms}


# Winner source of a backward kernel's instantiation -> its name in the report
# (K3 at int8 index planes; at int16 it is "bwd_fetch_i16").
_WINNERS = {"FetchWinnersIsE": "bwd_fetch_i16", "FetchWinners": "bwd_fetch",
            "RecordedWinners": "bwd_replay", "TracedWinners": "bwd_direct"}


def _ptxas_report(log: str) -> dict:
    """ptxas -v per kernel: registers, stack frame (local memory), spills. A
    function the kernels call (not inlined) has a frame of its own, kept
    under "callees"; the local memory a launch takes, callees' frames
    included, is launch_info's."""
    kernels, current, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            if "fwd_kernel" in sym:
                # K2 stores int8 planes (a `signed char*`), or int16 (`short*`)
                current = ("fwd_b0" if "ILb1E" not in sym
                           else "fwd_b1_i16" if "PsN2rt6Params" in sym else "fwd_b1")
            elif "peak_fma_kernel" in sym:
                current = "peak_fma"
            elif "gather_staged_kernel" in sym:
                current = "gather_probe_staged"
            elif "gather_kernel" in sym:
                current = "gather_probe"
            elif "sky_compose_bilinear_adjoint_kernel" in sym:
                current = "sky_compose_bilinear_adjoint"
            elif "sky_compose_bilinear_kernel" in sym:
                current = "sky_compose_bilinear"
            elif "sky_compose_adjoint_kernel" in sym:
                current = "sky_compose_adjoint"
            elif "sky_compose_kernel" in sym:
                current = "sky_compose"
            elif "soft_silhouettes_adjoint_kernel" in sym:
                current = "soft_silhouettes_adjoint"
            elif "soft_silhouettes_kernel" in sym:
                current = "soft_silhouettes"
            else:
                current = next((v for k, v in _WINNERS.items() if k in sym), sym)
            kernels[current] = {"symbol": sym}
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            frame = dict(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
            if props in (None, kernels[current]["symbol"]):
                kernels[current].update(frame)
            else:
                kernels.setdefault("callees", {})[props] = frame
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and current and props in (None, kernels[current]["symbol"]):
            kernels[current].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    return kernels


def library_sass(library_path: str) -> str:
    """The library's SASS (cuobjdump -sass, beside nvcc)."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", library_path], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(library_path: str, opcodes=("FFMA", "FMUL", "FADD")) -> dict:
    """How many instructions of each opcode the library's SASS holds."""
    sass = library_sass(library_path)
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def sass_function(sass: str, symbol_part: str) -> list[tuple[int, str]]:
    """(address, instruction) of the first kernel whose symbol contains
    `symbol_part`; a label's address is that of the instruction after it,
    and a branch to it names the address as `(.L_x_N)`, rewritten here to
    `@0x...`."""
    lines, inside, labels, pending = [], False, {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = symbol_part in line
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            lines.append((addr, m.group(2)))
    return [(a, re.sub(r"`\((\.L_x_\d+)\)", lambda m: "@" + hex(labels.get(m.group(1), -1)), t))
            for a, t in lines]


def innermost_loops(instrs) -> list[list[str]]:
    """The bodies of the innermost loops: a backward branch closes a loop
    from its target to itself; innermost when no other loop lies inside."""
    edges = []
    for addr, text in instrs:
        m = re.search(r"\bBRA\b.*?(?:@|\b)(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            edges.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in edges
             if not any((c, d) != (a, b) and a <= c and d <= b for c, d in edges)]
    return [[t for addr, t in instrs if a <= addr <= b] for a, b in sorted(set(inner))]


def trace_loops(sass: str, symbol_part: str) -> list[dict]:
    """The object loops of the trace in one kernel's SASS: the innermost
    loops that load 16-byte entries from shared memory (the trace table of
    csrc/rt_device.cuh) and store nothing there. Each is
    classed by its opcodes: the closest-hit sphere test takes a square root
    (MUFU.RSQ); the occluder sphere test none, and multiplies at least 5
    times per shared load (one load per sphere); a box test multiplies 6
    times per two loads (its two table entries). Per loop: instructions,
    shared loads (all, 16-byte) and bytes loaded, objects per pass, and per
    object the instructions and the shared loads."""
    out = []
    for body in innermost_loops(sass_function(sass, symbol_part)):
        loads = [t for t in body if re.match(r"(@!?U?P\w+\s+)?LDS(\.\w+)*\s", t)]
        width = [16 if ".128" in t else 8 if ".64" in t else 4 for t in loads]
        if 16 not in width or any(re.match(r"(@!?U?P\w+\s+)?STS", t) for t in body):
            continue
        fmul = sum(bool(re.search(r"\bFMUL\b", t)) for t in body)
        lds = len(loads)
        if any("MUFU.RSQ" in t for t in body):
            kind, objects = "sphere", lds
        elif fmul >= 5 * lds:
            kind, objects = "sphere_occluder", lds
        else:
            kind, objects = "box", lds / 2
        out.append({"instructions": len(body), "lds": lds, "lds128": width.count(16),
                    "lds_bytes": sum(width), "fmul": fmul, "kind": kind, "objects": objects,
                    "per_object": len(body) / objects, "lds_per_object": lds / objects})
    return out


def per_object_test(loops) -> dict:
    """The fewest SASS instructions per object test of each kind over a
    kernel's trace loops (one loop per kind and trace call site; the fewest
    is what a floor may count), and the most shared loads per object of any
    of them."""
    out = {}
    for loop in loops:
        kind = loop["kind"]
        out[kind] = min(out.get(kind, float("inf")), loop["per_object"])
        out["lds_per_object"] = max(out.get("lds_per_object", 0), loop["lds_per_object"])
    return out


def build_libraries(names) -> tuple[list, dict, float]:
    """One nvcc per library, started together: (build infos, ptxas report
    per kernel, wall seconds)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        infos = list(pool.map(lambda n: build.build_library(n, verbose=True), names))
    wall = time.perf_counter() - t0
    kernels = {}
    for info in infos:
        kernels.update(_ptxas_report(info["log"]))
    return infos, kernels, wall


# The kernels whose trace loops the report reads in the SASS: ptxas' name ->
# (library, a part of the kernel's symbol).
_TRACE_KERNELS = {"fwd_b0": (mk.KERNEL_LIBRARY, "fwd_kernelILb0E"),
                  "bwd_replay": (mk.RETRACE_KERNEL_LIBRARY, "RecordedWinners")}


def add_trace_loops(kernels: dict, paths: dict) -> None:
    """Adds to ptxas' report of K1 and K4 their trace loops (trace_loops)
    and the instructions per object test (per_object_test); `paths`: the
    built library of each name."""
    for kname, (library, symbol) in _TRACE_KERNELS.items():
        loops = trace_loops(library_sass(paths[library]), symbol)
        kernels[kname]["trace_loops"] = loops
        kernels[kname]["sass_per_object_test"] = per_object_test(loops)


def phase_build() -> dict:
    """The six libraries, one nvcc each, started together. Returns ptxas'
    report per kernel."""
    names = (mk.KERNEL_LIBRARY, mk.BWD_KERNEL_LIBRARY, mk.RETRACE_KERNEL_LIBRARY,
             peak.LIBRARY, gather_probe.LIBRARY, mk.SKY_COMPOSE_LIBRARY)
    infos, kernels, wall = build_libraries(names)
    # fwd_b0: plain forward, fwd_b1: recording (int8 index planes; fwd_b1_i16
    # int16); bwd_*: the backward kernel of each winner source (bwd_fetch_i16:
    # K3 on int16 planes); the FMA peak (K6), the gather (P1: a small table
    # staged in shared memory, or read through L1 and L2), and a sample's sky
    # compose and its adjoint, at the nearest texel and bilinear, and the
    # soft silhouettes' composite and its adjoint
    if set(kernels) - {"callees"} != {"fwd_b0", "fwd_b1", "fwd_b1_i16", "bwd_fetch",
                                      "bwd_fetch_i16", "bwd_replay",
                                      "bwd_direct", "peak_fma", "gather_probe",
                                      "gather_probe_staged", "sky_compose",
                                      "sky_compose_adjoint", "sky_compose_bilinear",
                                      "sky_compose_bilinear_adjoint", "soft_silhouettes",
                                      "soft_silhouettes_adjoint"}:
        raise RuntimeError("expected sixteen kernels in the ptxas logs:\n"
                           + "\n".join(i["log"] for i in infos))
    # K6 must be fused multiply-adds although every library is built with
    # --fmad=false: the unrolled body alone holds 64 x 8 of them
    kernels["peak_fma"]["sass"] = sass_counts(infos[names.index(peak.LIBRARY)]["path"])
    if kernels["peak_fma"]["sass"]["FFMA"] < peak.UNROLL * peak.CHAINS:
        raise RuntimeError(f"the FMA peak kernel's SASS: {kernels['peak_fma']['sass']}")
    add_trace_loops(kernels, {n: i["path"] for n, i in zip(names, infos)})
    mk._kernel_function()  # load the libraries just built
    for kernel in mk.BWD_KERNELS:
        mk._bwd_kernel_function(kernel)
    peak._function()
    gather_probe._function()
    build.load_library(mk.SKY_COMPOSE_LIBRARY)
    emit("build", seconds=round(wall, 2),
         seconds_each={n: round(i["seconds"], 2) for n, i in zip(names, infos)},
         flags=" ".join(build.NVCC_FLAGS), kernels=kernels)
    return kernels


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
        self.shadow_taken = []
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
        hit, emission = super().trace_shadow(ro, rd)
        self.shadow_taken.append(int((accept & self.live & hit).sum()))
        return hit, emission


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
            "active_spheres": counter.active_spheres, "shadow_rays": counter.shadow_rays,
            "shadow_taken": counter.shadow_taken}


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
    # more bounces than the kernel keeps entry states for (SAVED_STATES = 10
    # in csrc/rt_backward.cuh): the deeper ones are walked to again
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
    # direct's limit (UNROLL_LIMIT = 48 objects, one emitter): K5's launch
    # shape at its largest tables
    limit = Scene.from_objects(random_objects(mk.UNROLL_LIMIT, seed=4, lights=(7,)),
                               device=camera.device)
    results.append({"scene": "48_objects", "size": [SMALL_W, SMALL_H],
                    **compare_retrace("direct", limit, camera, RenderConfig(), SMALL_W, SMALL_H,
                                      seed=37)})
    if results[-1]["kernel"] != "direct":
        raise RuntimeError("bwd_mode='direct' at 48 objects did not run the direct kernel")
    for mode in ("replay", "direct"):
        # more bounces than either kernel keeps entry states for (10 slots;
        # K5's 75 KB share of an SM holds 6 slots of two bounces)
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


# More shadow samples per bounce than the backward kernels keep as bits of a
# 32-bit mask: the samples past it are drawn and tested again where the
# routing needs them (csrc/rt_backward.cuh, MASK_BITS).
MANY_SHADOW_SAMPLES = 33
# The plain fetch backward at that count runs over more row slices: 33
# shadow samples per bounce make its autograd graph about ten times that of
# the default three.
MANY_SAMPLES_SLICES = 12


def phase_many_shadow_samples(scenes, camera) -> tuple[list, list]:
    """The backward kernels at MANY_SHADOW_SAMPLES per bounce, as the JAX
    package takes any count: on the room at 1920x1080, default bounces, K3
    against its plain version on K2's index planes, and K4 and K5 against K3;
    at the comparison shape K3, K4 and K5 against their plain versions, with
    the room's single emitter and with a full shadow scan of two lights.
    Returns (K3's results, K4's and K5's) for stream_identity."""
    cfg = RenderConfig(shadow_samples=MANY_SHADOW_SAMPLES)
    room = scenes["room"]
    two_lights = dataclasses.replace(
        Scene.from_objects(random_objects(12, seed=3, lights=(2, 5)), device=camera.device),
        emissive=None)
    fetch, retrace = [], []
    small = RenderConfig(bounces=3, shadow_samples=MANY_SHADOW_SAMPLES)
    for name, scene in (("room", room), ("two_lights_full_scan", two_lights)):
        fetch.append({"scene": name, "size": [SMALL_W, SMALL_H],
                      **compare_bwd(scene, camera, small, SMALL_W, SMALL_H, seed=41)})
        for mode in ("replay", "direct"):
            retrace.append({"scene": name, "size": [SMALL_W, SMALL_H],
                            **compare_retrace(mode, scene, camera, small, SMALL_W, SMALL_H,
                                              seed=42)})
    fetch.append({"scene": "room", "size": [WIDTH, HEIGHT], "plain_slices": MANY_SAMPLES_SLICES,
                  **compare_bwd(room, camera, cfg, WIDTH, HEIGHT, seed=43,
                                slices=MANY_SAMPLES_SLICES)})
    job = mk.make_tile_job(room, camera, WIDTH, HEIGHT, cfg)
    planes, records = mk.run_tiles(job, 43, record=True)
    cot = random_cotangents(job)
    ref_rows, ref_cam = mk._launch_bwd("fetch", job, 43, 0, records, cot)
    col_scale = ref_rows.abs().amax(dim=0, keepdim=True)
    for kernel in ("replay", "direct"):
        g_rows, g_cam, primal = mk._launch_bwd(kernel, job, 43, 0, None, cot, want_primal=True)
        torch.cuda.synchronize()
        retrace.append({
            "scene": "room", "size": [WIDTH, HEIGHT], "kernel": kernel, "against": "fetch",
            "rows": gradient_agreement(g_rows, ref_rows, BWD_ROWS_RTOL, BWD_ROWS_ATOL, col_scale),
            "camera": gradient_agreement(g_cam, ref_cam, BWD_CAM_RTOL, BWD_CAM_ATOL,
                                         ref_cam.abs().max()),
            "kernel_primal_equal": bool(primal.equal(planes))})
    emit("many_shadow_samples", shadow_samples=MANY_SHADOW_SAMPLES,
         criterion="as bwd_kernel_vs_plain; at full size K4 and K5 against K3",
         results=[{k: v for k, v in r.items() if not k.endswith("primal_equal")}
                  for r in fetch + retrace])
    return fetch, retrace


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


def sky_compose_bound(cubemap, planes) -> dict:
    """Least time of one sample's sky compose into a running sum (no grad)
    and of its adjoint on a packed sky: every plane read and written once
    (the forward: 40 bytes of planes, 12 of the sum in and 12 out a pixel;
    the adjoint: 12 of cotangent and 16 of state in, 40 out) and, in the
    forward, each distinct 32-byte sector of the table that the sample's
    texels lie in once, at the memory rate."""
    pixels = planes[0].numel()
    flat, _ = mk._miss_texel_index(cubemap, planes)
    table = 32 * torch.unique(flat.reshape(-1) // 8).numel()
    fwd, adj = 64 * pixels + table, 68 * pixels
    return {"bound_ms": fwd / PEAK_BYTES * 1e3, "bytes": fwd,
            "adjoint_bound_ms": adj / PEAK_BYTES * 1e3, "adjoint_bytes": adj, "bound_by": "bytes"}


def bilinear_sky_compose_bound(cubemap, planes) -> dict:
    """The bound of the bilinear arms under grad (portbench/sky_work.py:
    every plane byte once, each distinct 32-byte sector of the sky's
    storage that the four texels of the sample's pixels lie in once) on one
    sample added into a running sum, as the timed launches run."""
    pixels = planes[0].numel()
    with torch.no_grad():
        n = sky_work.sectors(cubemap.w, RefV(planes[3], planes[4], planes[5]),
                             planes=1 if cubemap.packed is not None else 3)
    fwd, adj = sky_work.forward(pixels, n, sum_in=1.0), sky_work.adjoint(pixels, n)
    return {"bound_ms": fwd["bound_s"] * 1e3, "bytes": fwd["bytes"],
            "adjoint_bound_ms": adj["bound_s"] * 1e3, "adjoint_bytes": adj["bytes"],
            "bound_by": fwd["bound_by"]}


def bilinear_vs_plain(planes, prev, g, cm) -> dict:
    """The bilinear arms on one sample against their plain twin (sum, state,
    cotangent bit for bit), the plain lookup and compose (sum bit for bit)
    and autograd through it: the radiance and throughput planes bit for bit,
    the miss plane within 1e-6 of its terms' magnitudes, the direction
    planes within 2e-6 of bilinear_adjoint_scale
    (tests/test_torch_sky_compose.py says why). Raises on a difference."""
    cfg = RenderConfig(env_filter="bilinear")
    got, state = mk._launch_sky_compose(planes, prev, cm, True, bilinear=True)
    g_planes = mk._launch_sky_compose_adjoint(g, state, cm, bilinear=True)
    want, w_state = mk.sky_compose_plain(planes, prev, cm, keep_state=True, bilinear=True)
    w_g = mk.sky_compose_adjoint_plain(g, w_state, cm, bilinear=True)
    p = planes.clone().requires_grad_(True)
    lookup = prev + mk.compose(p, cm, cfg).to_array()
    (a_g,) = torch.autograd.grad(lookup, [p], g)
    s_ = mk._state_sky(state, cm, bilinear=True)
    miss_scale = sum((g_planes[ch] * (c * planes[6 + ch])).abs()
                     for ch, c in enumerate((s_.x, s_.y, s_.z)))
    g_sky = Vec3(*(g_planes[ch] * planes[9] * planes[6 + ch] for ch in range(3)))
    dir_scale = bilinear_adjoint_scale(cm, Vec3(planes[3], planes[4], planes[5]), g_sky)
    miss_off = (g_planes[9] - a_g[9]).abs()
    dir_off = (g_planes[3:6] - a_g[3:6]).abs()
    equal = {"sum_vs_plain": torch.equal(got, want),
             "sum_vs_lookup": torch.equal(got, lookup.detach()),
             "state": torch.equal(state, w_state),
             "cotangent_vs_plain": torch.equal(g_planes, w_g),
             "cotangent_vs_autograd": torch.equal(g_planes[:3], a_g[:3])
                                      and torch.equal(g_planes[6:9], a_g[6:9])}
    res = {"sum_max_abs_err": float((got - lookup.detach()).abs().max()),
           "cotangent_max_abs_err": float((g_planes - a_g).abs().max()),
           "miss_cotangent_err_over_terms": float((miss_off / miss_scale.clamp_min(1e-30)).max()),
           "direction_cotangent_err_over_terms": float((dir_off / dir_scale.clamp_min(1e-30)).max()),
           "direction_share_equal_to_autograd": float((dir_off == 0).float().mean()),
           "direction_cotangent_max_abs": float(a_g[3:6].abs().max())}
    if (not all(equal.values()) or not bool((miss_off <= 1e-6 * miss_scale).all())
            or not bool((dir_off <= 2e-6 * dir_scale).all())):
        raise RuntimeError(f"bilinear sky compose: {equal}, {res}")
    return res


def phase_sky_compose_vs_plain(scenes, camera, sky) -> dict:
    """The sky compose kernels (csrc/sky_compose.cu) on one sample of
    scene_2 and of the room at full size, added into a running sum, with the
    checker sky and a 1x1 float sky, against their plain version
    (sky_compose_plain, sky_compose_adjoint_plain) and against the plain
    lookup and compose they replace (compose) and autograd through it: the
    sum, the saved state and the cotangent bit for bit against the plain
    version; against autograd the cotangent of the radiance and throughput
    planes bit for bit and the miss plane's within 1e-6 of the sum of the
    magnitudes of the three channels' terms it adds, in another order
    (tests/test_torch_sky_compose.py says why). Then their times on the
    checker sky (no grad, in place; under grad, with the state; the
    adjoint) beside the plain lookup and compose and the bound. The bilinear
    arms likewise (bilinear_vs_plain) on the checker sky and on invert's
    32x32 float gradient sky, timed on the latter under grad with their
    bound. Returns the numbers per scene."""
    cfg = RenderConfig()
    grad_sky = gradient_sky(device=camera.device)
    bil_cfg = RenderConfig(env_filter="bilinear")
    dev = camera.device
    skies = {"checker": sky, "constant": constant_sky((0.3, 0.5, 0.7), device=dev)}
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, cfg)
        planes, _ = mk.run_tiles(job, 21)
        prev = torch.rand((HEIGHT, WIDTH, 3), generator=gen, device=dev)
        g = torch.randn((HEIGHT, WIDTH, 3), generator=gen, device=dev)
        res = {}
        for sky_name, cm in skies.items():
            got, state = mk._launch_sky_compose(planes, prev, cm, True)
            g_planes = mk._launch_sky_compose_adjoint(g, state, cm)
            want, w_state = mk.sky_compose_plain(planes, prev, cm, keep_state=True)
            w_g = mk.sky_compose_adjoint_plain(g, w_state, cm)
            p = planes.clone().requires_grad_(True)
            lookup = prev + mk.compose(p, cm, cfg).to_array()
            (a_g,) = torch.autograd.grad(lookup, [p], g)
            s_ = mk._state_sky(state, cm)
            scale = sum((g_planes[ch] * (c * planes[6 + ch])).abs()
                        for ch, c in enumerate((s_.x, s_.y, s_.z)))
            off = (g_planes[9] - a_g[9]).abs()
            err = float((off / scale.clamp_min(1e-30)).max())
            equal = {"sum_vs_plain": torch.equal(got, want),
                     "sum_vs_lookup": torch.equal(got, lookup.detach()),
                     "state": torch.equal(state, w_state),
                     "cotangent_vs_plain": torch.equal(g_planes, w_g),
                     "cotangent_vs_autograd": torch.equal(g_planes[:9], a_g[:9])}
            if not all(equal.values()) or not bool((off <= 1e-6 * scale).all()):
                raise RuntimeError(f"sky compose on {name}, {sky_name} sky: {equal}, miss "
                                   f"cotangent off by {err:.3g} of its terms' magnitudes")
            res[sky_name] = {"miss_cotangent_err_over_terms": err,
                             "miss_cotangent_max_rel_err": float(
                                 (off / a_g[9].abs().clamp_min(1e-30)).max())}
        acc = prev.clone()
        _, state = mk._launch_sky_compose(planes, prev, sky, True)
        res.update(
            kernel_ms=time_launches(lambda i: mk._launch_sky_compose(planes, acc, sky, False), 50),
            state_ms=time_launches(lambda i: mk._launch_sky_compose(planes, prev, sky, True), 50),
            adjoint_ms=time_launches(lambda i: mk._launch_sky_compose_adjoint(g, state, sky), 50),
            plain_ms=time_launches(lambda i: prev + mk.compose(planes, sky, cfg).to_array(), 20),
            **sky_compose_bound(sky, planes))
        bil = {n: bilinear_vs_plain(planes, prev, g, cm)
               for n, cm in (("checker", sky), ("gradient", grad_sky))}
        _, state = mk._launch_sky_compose(planes, prev, grad_sky, True, bilinear=True)
        bil.update(
            kernel_ms=time_launches(lambda i: mk._launch_sky_compose(
                planes, acc, grad_sky, False, bilinear=True), 50),
            state_ms=time_launches(lambda i: mk._launch_sky_compose(
                planes, prev, grad_sky, True, bilinear=True), 50),
            adjoint_ms=time_launches(lambda i: mk._launch_sky_compose_adjoint(
                g, state, grad_sky, bilinear=True), 50),
            plain_ms=time_launches(
                lambda i: prev + mk.compose(planes, grad_sky, bil_cfg).to_array(), 20),
            **bilinear_sky_compose_bound(grad_sky, planes))
        res["bilinear"] = bil
        out[name] = res
    emit("sky_compose_vs_plain", size=[WIDTH, HEIGHT], all_bit_equal=True,
         unit="ms per sample, median", **out)
    return out


# Float operations of the soft silhouettes, counted by hand from
# csrc/sky_compose.cu as F_* above: per pixel the camera ray and F_RAY, per
# object its t, per covering test a sphere's or a box's coverage (the
# winner's on a hit, every object's on a miss), the sky and the blend.
F_SOFT_RAY = 21           # u, v 5, cu, cv 4, rd 12 (make_ray's are F_RAY)
F_SOFT_SPHERE_COVER = 22  # oc 3, along 5, |oc|^2 - along^2 7, sqrt 1, margin, scale, quotient 3, sigmoid 3
F_SOFT_BOX_COVER = 37     # hi 3, slabs 12, near and far 4, margin 2, extent 7, q 3, clamp 2, z 1, sigmoid 3
F_SOFT_SKY = 51           # the bilinear lookup (csrc/sky_compose.cu's count)
F_SOFT_BLEND = 17         # proxy 6, 1 - alpha 2, blend 9
# the adjoint: the forward again, then per pixel about this many of its own
F_SOFT_ADJ = 180          # alpha 11, proxy 12, a coverage's adjoint 60-90, the sky's 100, normalize 20, camera 20
# Agreement of the adjoint kernel with its plain twin: tests/test_torch_soft_silhouettes.py's
SOFT_ADJ_RTOL, SOFT_ADJ_ATOL = 1e-5, 1e-6


def soft_silhouettes_bound(job, pixels_hit: int, adjoint: bool = False) -> dict:
    """Least time of one composite of the job's frame (the adjoint's with
    `adjoint`): the (H,W,3) colour read and the frame written once (the
    adjoint: the cotangent and the colour read, the colour's cotangent
    written) at the memory rate, against the operations above at the FP32
    rate."""
    pixels = job.width * job.height
    n, n_sph = len(job.obj_type), job.n_spheres
    cover = (n_sph * F_SOFT_SPHERE_COVER + (n - n_sph) * F_SOFT_BOX_COVER) / max(n, 1)
    per_px = (F_SOFT_RAY + F_RAY + n_sph * F_SPHERE + (n - n_sph) * F_CUBE + F_SOFT_SKY
              + F_SOFT_BLEND)
    ops = pixels * per_px + pixels_hit * cover + (pixels - pixels_hit) * n * cover
    nbytes = 24 * pixels
    if adjoint:
        ops += pixels * F_SOFT_ADJ
        nbytes = 36 * pixels
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bytes": nbytes, "flops": ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "flops"}


def soft_vs_plain(job, result, g, cubemap) -> dict:
    """The soft silhouettes' kernels on one frame against their plain twin
    (soft_silhouettes_plain: the frame bit for bit; the adjoint's colour
    cotangent bit for bit, the rows' and camera's within SOFT_ADJ_RTOL of
    their terms' magnitudes and SOFT_ADJ_ATOL of the largest entry) and the
    frame against the plain composite (soft_silhouette_composite) bit for
    bit. Raises on a difference."""
    from ray_tracing_tpu_torch.render.integrator import soft_silhouette_composite

    out = mk._launch_soft_silhouettes(job, result, cubemap)
    g_res, g_rows, g_cam = mk._launch_soft_silhouettes_adjoint(job, g, result, cubemap)
    twin = mk.soft_silhouettes_plain(job, result, cubemap)
    w_res, w_rows, w_cam = mk.soft_silhouettes_adjoint_plain(job, g, result, cubemap)
    s_rows, s_cam = mk.soft_silhouettes_adjoint_scale(job, g, result, cubemap)
    view = mk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    u, v = mk._tile_uv(job.width, job.height, job.norm_height, 0, job.rows.device)
    ro, rd = mk.camera_rays_from_pack(job.cam_pack, u, v, (job.height, job.width))
    plain = soft_silhouette_composite(view, ro, rd, Vec3(*result.unbind(-1)), job.config,
                                      cubemap).to_array()
    errs = {}
    within = True
    for name, got, want, scale in (("rows", g_rows, w_rows, s_rows), ("camera", g_cam, w_cam, s_cam)):
        off = (got - want).abs()
        allowed = SOFT_ADJ_RTOL * scale + SOFT_ADJ_ATOL * want.abs().max()
        within = within and bool((off <= allowed).all())
        errs[name] = {"max_abs_err": float(off.max()), "largest": float(want.abs().max()),
                      "worst_err_over_allowed": float((off / allowed.clamp_min(1e-30)).max())}
    equal = {"frame_vs_plain": torch.equal(out, twin), "frame_vs_composite": torch.equal(out, plain),
             "colour_cotangent_vs_plain": torch.equal(g_res, w_res)}
    if not all(equal.values()) or not within:
        raise RuntimeError(f"soft silhouettes: {equal}, {errs}, frame off by "
                           f"{float((out - twin).abs().max())}")
    return {"frame_max_abs_err": float((out - twin).abs().max()),
            "adjoint_max_abs_err": max(e["max_abs_err"] for e in errs.values()), **errs}


def phase_soft_silhouettes_vs_plain(scenes, camera, sky) -> dict:
    """The soft silhouettes' kernels (csrc/sky_compose.cu) on one frame of
    scene_2 and of the room (boxes) at full size, with invert's bilinear
    32x32 gradient sky and with the checker sky at the nearest texel,
    against their plain twin and the plain composite (soft_vs_plain); then,
    on invert's sky, the times of the composite and of its adjoint beside
    the plain composite and autograd through it, the bound, and ptxas'
    registers and spills. Returns the numbers per scene."""
    from ray_tracing_tpu_torch.render.integrator import soft_silhouette_composite

    dev = camera.device
    grad_sky = gradient_sky(device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for name in ("scene_2", "room"):
        cfg = RenderConfig(env_filter="bilinear", soft_silhouette_temp=0.08)
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, cfg)
        result = torch.rand((HEIGHT, WIDTH, 3), generator=gen, device=dev)
        g = torch.randn((HEIGHT, WIDTH, 3), generator=gen, device=dev)
        res = {"gradient": soft_vs_plain(job, result, g, grad_sky),
               "checker_nearest": soft_vs_plain(dataclasses.replace(
                   job, config=cfg.replace(env_filter="nearest")), result, g, sky)}
        hits = int(mk.soft_pixels(job, grad_sky).hit.sum())
        rows = job.rows.clone().requires_grad_(True)
        cam = job.cam_pack.clone().requires_grad_(True)
        res_g = result.clone().requires_grad_(True)

        def plain_composite():
            view = mk.SceneView(rows, job.obj_type, job.light_index, job.emissive)
            u, v = mk._tile_uv(WIDTH, HEIGHT, HEIGHT, 0, dev)
            ro, rd = mk.camera_rays_from_pack(cam, u, v, (HEIGHT, WIDTH))
            return soft_silhouette_composite(view, ro, rd, Vec3(*res_g.unbind(-1)), cfg,
                                             grad_sky).to_array()

        with torch.no_grad():
            res["plain_ms"] = time_launches(lambda i: plain_composite(), 10)
        res["plain_with_autograd_ms"] = time_launches(
            lambda i: torch.autograd.grad(plain_composite(), [res_g, rows, cam], g), 5)
        res["kernel_ms"] = time_launches(lambda i: mk._launch_soft_silhouettes(job, result,
                                                                               grad_sky), 50)
        res["adjoint_ms"] = time_launches(lambda i: mk._launch_soft_silhouettes_adjoint(
            job, g, result, grad_sky), 50)
        res["pixels_hit"] = hits
        res["bound"] = soft_silhouettes_bound(job, hits)
        res["adjoint_bound"] = soft_silhouettes_bound(job, hits, adjoint=True)
        out[name] = res
    emit("soft_silhouettes_vs_plain", size=[WIDTH, HEIGHT], all_bit_equal=True,
         unit="ms per frame, median", **out)
    return out


def phase_peak_and_gather_vs_plain(scenes, camera, sky) -> dict:
    """K6 against its plain recurrence at the bench's shape, P1 against
    torch.take bit for bit at the probe's shape, at ragged lengths, on views
    at a storage offset and at the sky's (the main path's texel indices into
    the 2048^2 cubemap), and their times."""
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
    # ragged lengths, views at a storage offset and a 2-D view at a row
    # offset: the kernel's scalar head and tail
    flat_idx = idx.reshape(-1)
    for n in GATHER_RAGGED:
        cases.append((f"ragged_{n}", table, flat_idx[:n]))
    for off in GATHER_OFFSETS:
        cases.append((f"offset_{off}", table, flat_idx[off:off + GATHER_RAGGED[-1]]))
    cases.append(("rows_from_1", table, idx[1:]))
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
        planes, _ = mk.run_tiles(job, 17)
        flat, _ = mk._miss_texel_index(sky, planes)
        cases.append((name + "_sky", sky.packed, flat))
        cases.append((name + "_sky_offset_3", sky.packed, flat.reshape(-1)[3:]))
    for name, tbl, ix in cases:
        equal = bool(torch.equal(gather_probe.gather(tbl, ix), gather_probe.gather_plain(tbl, ix)))
        if not equal:
            raise RuntimeError(f"gather ({name}) differs from torch.take")
        gather_res.append({"case": name, "table_entries": tbl.numel(),
                           "indices": list(ix.shape), "storage_offset": ix.storage_offset(),
                           "bit_equal": equal})
    emit("peak_and_gather_vs_plain",
         peak={"criterion": "|kernel - plain| <= rtol * |plain|", "rtol": PEAK_RTOL,
               "input": "uniform [%g, %g]" % PEAK_CHECK_A, "shape": list(shape),
               "results": peak_res,
               "ms_at_bench_shape": main_ms, "bench_iters": PEAK_ITERS},
         gather={"criterion": "bit-equal to torch.take", "results": gather_res})
    return {"peak": peak_res, "peak_ms": main_ms}


def plain_lookup_frame(job, seed: int, spp: int, sky):
    """A frame of the forward kernel's samples, each through the plain sky
    lookup and compose (compose: sample_cubemap, compose_sky), summed in
    sample order and averaged as render_frame does: the frame that the sky
    compose kernel (csrc/sky_compose.cu) must equal bit for bit."""
    with torch.no_grad():
        total = None
        for s in mk.frame_sample_seeds(seed, spp):
            rgb = mk.compose(mk.run_tiles(job, s)[0], sky, job.config).to_array()
            total = rgb if total is None else total + rgb
        return total * (1.0 / spp) if spp > 1 else total


def phase_bench_path(scenes, camera, sky) -> dict:
    """The port's bench (python -m ray_tracing_tpu_torch.bench) at its full
    size, its JSON line printed on a line of its own; every launch counter
    set to 0 before it and read after it (the sky compose kernel among
    them). Then the bench's frame, 8 samples of scene_2 through the sky
    compose kernel, against the frame of the plain lookup and compose
    (plain_lookup_frame), bit for bit."""
    mk.reset_launch_counts()
    peak.reset_launch_counts()
    gather_probe.reset_launch_counts()
    res = bench.run()
    torch.cuda.synchronize()
    print(json.dumps(res["line"]), flush=True)
    counts = {**mk.launch_counts, **peak.launch_counts, **gather_probe.launch_counts}
    for k in ("megakernel_fwd", "megakernel_fwd_record", "megakernel_bwd_fetch", "peak_fma",
              "sky_compose", "sky_compose_adjoint"):
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

    scene, cfg = scenes["scene_2"], RenderConfig()
    job = mk.make_tile_job(scene, camera, WIDTH, HEIGHT, cfg)
    frame = mk.render_image_cuda(scene, camera, WIDTH, HEIGHT, 5, spp=SPP, config=cfg,
                                 cubemap=sky)
    if not frame.equal(plain_lookup_frame(job, 5, SPP, sky)):
        raise RuntimeError("the bench's frame differs from the plain lookup and compose")
    emit("bench_path", line=res["line"], bwd_mode=res["bwd_mode"],
         seconds_per_sample=res["seconds_per_sample"],
         census_flops_per_px=res["census_flops_per_px"], census_tflops=res["census_tflops"],
         census_share_of_fma_peak=res["census_share_of_fma_peak"], fma_peak=vpu,
         bf16_peak=res["bf16_peak"], fingerprint=res["fingerprint"], launches=counts,
         frame_equals_plain_lookup=True, spp=SPP)
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
    main path's shape, what a sample's plain sky lookup and compose cost,
    the P1 kernel and PyTorch's indexing on the real texel indices, and
    whole 8-spp frames (two medians)."""
    gather_probe.reset_launch_counts()
    probe = gather_probe.run()
    torch.cuda.synchronize()
    print(gather_probe.report(probe), flush=True)
    launches = dict(gather_probe.launch_counts)
    if not probe["correct"] or launches["gather_probe"] < 1:
        raise RuntimeError(f"gather probe: correct={probe['correct']}, launches {launches}")
    # the probe's shape and the sky's indices, each with table[idx] and its bound
    cases = gather_times(scenes, camera)
    # the plain version as written (its int64 cast included), for the kernels line
    table, idx = gather_probe.probe_inputs(camera.device)
    probe["plain_ms"] = device_seconds(lambda i: gather_probe.gather_plain(table, idx), 8) * 1e3

    cfg = RenderConfig()
    per_scene = {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, cfg)
        p1, _ = mk.run_tiles(job, 5)
        flat1, miss1 = mk._miss_texel_index(sky, p1)
        per_scene[name] = {
            "miss_share": float(miss1.float().mean()),
            "full_lookup_compose_ms": time_host(lambda i: mk.compose(p1, sky, cfg), 10),
            "gather_kernel_ms": device_seconds(lambda i: gather_probe.gather(sky.packed, flat1),
                                               8) * 1e3,
            "torch_index_ms": device_seconds(lambda i: sky.packed[flat1], 8) * 1e3,
            "frame_ms": [time_frames(scenes[name], camera, sky, cfg, 5) for _ in range(2)]}
    emit("sky_gather", probe=probe, launches=launches, size=[WIDTH, HEIGHT], spp=SPP,
         sky=[SKY_SIZE, SKY_SIZE], unit="ms (frame_ms: per 8-spp frame, two medians)",
         gather_cases=cases, **per_scene)
    return {"probe": probe, "launches": launches, "cases": cases}


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
        # the training-side entry: one recorded sample at full width, under
        # a profiler so that its span keeps the bytes of index planes written
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            tiles = mk.render_tiles_cuda(scenes[name], camera, WIDTH, HEIGHT, seed=1,
                                         config=cfg, record=True)
            torch.cuda.synchronize()
        counted = [c["index_bytes"] for n, *_, c in profiling.recorded()
                   if n == "kernel.megakernel_fwd_record"]
        profiling.clear()
        recs = tiles["records"]
        n_rec = mk.record_layout(cfg, scenes[name].has_light)
        if tuple(recs.shape) != (n_rec, HEIGHT, WIDTH) or int(recs.min()) < -1 \
                or int(recs.max()) >= scenes[name].num_objects:
            raise RuntimeError(f"{name}: bad index planes {tuple(recs.shape)}")
        dtype = mk.record_dtype(scenes[name].num_objects)
        if recs.dtype != dtype or counted != [recs.numel() * dtype.itemsize]:
            raise RuntimeError(f"{name}: index planes of {recs.dtype}, expected {dtype}; "
                               f"the span counted {counted} bytes")
        out[name] = {"image": img, "mean": float(img.mean()), "tiles": tiles,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "index_dtype": str(recs.dtype), "index_bytes": counted[0]}
    counts = dict(mk.launch_counts)  # read right after the main path
    for k in ("megakernel_fwd", "megakernel_fwd_record"):
        if counts[k] < 1:
            raise RuntimeError(f"kernel {k} was not launched on the main path")

    report = {}
    for name in ("scene_2", "room"):
        before = dict(mk.launch_counts)
        plain = render_image(scenes[name], camera, WIDTH, HEIGHT, seed=1, spp=SPP,
                             config=cfg, cubemap=sky)
        torch.cuda.synchronize()
        if mk.launch_counts != before:
            raise RuntimeError(f"{name}: the plain render launched a kernel: "
                               f"{ {k: v - before[k] for k, v in mk.launch_counts.items()} }")
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
                        "index_dtype": out[name]["index_dtype"],
                        "index_bytes": out[name]["index_bytes"],
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


# ---------------------------------------------------------------------------
# The interactive frame path: native layer, skybox loading, the film, the
# server and the terminal viewer
# ---------------------------------------------------------------------------

FILM_W, FILM_H = 1280, 960          # the reference's window
SMALL_FILM = (320, 240)             # film_vs_plain
FILM_FULL_PASSES = 16               # full-res passes timed per session
VIEWER_W, VIEWER_H = 192, 108       # the viewer's cap (apps/cli.py)
CUBE_FACE = 1024                    # cubemap_load: six faces of this size
FILM_ATOL = 1e-6
HEALTH_KEYS = {"status", "passes", "film_weight", "rays_per_second", "uptime_s", "device",
               "resolution", "event_to_frame_ms"}


def object_rows(specs):
    """(kinds, (N, 16) float32): parsed objects as a Scene stores them."""
    return [o.kind for o in specs], np.array(
        [[*o.p0, *o.p1, *o.albedo, o.roughness, o.reflectance, o.metallic,
          *o.emission_color, o.emission_power] for o in specs], np.float32)


def phase_native() -> None:
    """The port's rt_native, built from this checkout's source: its parser
    against the Python parser, its PNG writer through read_png."""
    t0 = time.perf_counter()
    lib = native.lib()
    build_s = time.perf_counter() - t0
    if lib is None:
        raise RuntimeError(f"rt_native did not build from {native.SOURCE}")
    objects = {}
    for name, text in (("scene_2", SCENE_2_TEXT), ("room", ROOM_TEXT)):
        got, want = object_rows(parse_objects_native(text)), object_rows(parse_objects(text))
        if got[0] != want[0] or not np.array_equal(got[1], want[1]):
            raise RuntimeError(f"{name}: the native parser's objects differ from Python's")
        objects[name] = len(got[0])
    frame = np.random.default_rng(8).integers(0, 256, (FILM_H, FILM_W, 3), dtype=np.uint8)
    png_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flip in (0, 1):
            path = os.path.join(tmp, f"frame_{flip}.png")
            t = time.perf_counter()
            rc = lib.rt_write_png(path.encode(), FILM_W, FILM_H,
                                  frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flip)
            png_ms[flip] = (time.perf_counter() - t) * 1e3
            if rc != 0 or not np.array_equal(read_png(path), frame[::-1] if flip else frame):
                raise RuntimeError(f"rt_write_png (flip={flip}) rc {rc}: read back differs")
    emit("native", library=str(native.LIB_PATH), build_s=round(build_s, 3), objects=objects,
         png=[FILM_W, FILM_H], png_write_ms=png_ms[0], png_write_flipped_ms=png_ms[1])


def phase_cubemap_load(device) -> None:
    """load_cubemap on six procedural JPEG faces: a decode, then the memo;
    the texels on the card against CubemapData.from_faces of the decoded
    faces."""
    from PIL import Image

    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:CUBE_FACE, 0:CUBE_FACE]
    with tempfile.TemporaryDirectory() as tmp:
        for face, rel in SKYBOX_FILES.items():
            noise = rng.integers(0, 24, (CUBE_FACE, CUBE_FACE))
            arr = np.stack([(xx // 4 + 40 * face + noise) % 256, (yy // 4 + noise) % 256,
                            np.full_like(xx, 60 + 30 * face)], -1).astype(np.uint8)
            os.makedirs(os.path.join(tmp, os.path.dirname(rel)), exist_ok=True)
            Image.fromarray(arr).save(os.path.join(tmp, rel), quality=92)
        loads, times = [], []
        for _ in range(2):  # the decode, then the memo
            t = time.perf_counter()
            loads.append(load_cubemap(tmp, device=device))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        faces = np.stack([load_image(os.path.join(tmp, SKYBOX_FILES[f])) for f in range(6)])
        want = CubemapData.from_faces(faces, device=device)
        for cm in loads:
            if (cm.h, cm.w) != (CUBE_FACE, CUBE_FACE) or cm.packed.device != want.packed.device \
                    or not torch.equal(cm.packed, want.packed):
                raise RuntimeError("load_cubemap's texels differ from from_faces of the faces")
        memo = sorted(skybox_cache_dir().glob("*.npz"), key=os.path.getmtime)[-1]
        memo_bytes = memo.stat().st_size
        memo.unlink()
    emit("cubemap_load", faces=[6, CUBE_FACE, CUBE_FACE], decode_ms=times[0],
         memo_ms=times[1], memo_bytes=memo_bytes)


def film_session(render_fn, scene, camera, width, height, seed, full_passes, device, cfg):
    """One viewer session from an invalidation: the pyramid, then
    `full_passes` more full-res passes, each followed by the display
    frame's resolve to uint8 and its copy to the host (the one
    synchronisation of a pass). Returns (film, per-pass records)."""
    film, records = Film.zero(width, height, device=device), []
    t_start = time.perf_counter()
    for n, scale in enumerate(progressive_scales(cfg) + [1] * full_passes):
        t0 = time.perf_counter()
        film, spp = render_fn(scene, camera, film, pass_seed(seed, n), scale)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        resolve_u8(film).cpu()
        t2 = time.perf_counter()
        records.append({"scale": scale, "spp": spp, "pass_ms": (t1 - t0) * 1e3,
                        "resolve_copy_ms": (t2 - t1) * 1e3,
                        "since_invalidation_ms": (t2 - t_start) * 1e3})
    return film, records


def phase_film_vs_plain(scenes, camera, sky) -> dict:
    """The whole pyramid and two more full-res passes at 320x240 through
    make_cuda_render_fn (K1 and the sky compose) and through the plain
    render_pass on the card with the same seeds: the films within 1e-6,
    and K1 launched once per sample."""
    cfg = RenderConfig(init_scale=8)
    render_fn = make_cuda_render_fn(cfg, sky, camera.device)
    out = {}
    for name in ("scene_2", "room"):
        mk.reset_launch_counts()
        cuda, records = film_session(render_fn, scenes[name], camera, *SMALL_FILM, 41, 2,
                                     camera.device, cfg)
        launches = mk.launch_counts["megakernel_fwd"]
        plain = Film.zero(*SMALL_FILM, device=camera.device)
        for n, r in enumerate(records):
            plain = render_pass(scenes[name], camera, plain, pass_seed(41, n), r["scale"],
                                cfg, sky, spp=r["spp"], device=camera.device)
        err = float((cuda.resolve() - plain.resolve()).abs().max())
        samples = sum(r["spp"] for r in records)
        if err > FILM_ATOL or launches != samples or not torch.equal(cuda.weight, plain.weight):
            raise RuntimeError(f"{name}: film vs plain max |err| {err}, K1 launches {launches} "
                               f"for {samples} samples, weights {float(cuda.weight)} / "
                               f"{float(plain.weight)}")
        out[name] = {"max_abs_err": err, "launches": launches, "samples": samples,
                     "weight": float(cuda.weight), "passes": len(records)}
    emit("film_vs_plain", size=list(SMALL_FILM), atol=FILM_ATOL, scenes=out)
    return out


def phase_film_path(scenes, camera, sky) -> dict:
    """The film at the reference's 1280x960 with the 2048^2 sky: a warm-up
    session, then one timed session per scene, K1's launch count set to 0
    just before and read just after; then, per scale, K1 alone (CUDA events)
    and the host's TileJob build, the per-pass costs the pass's time
    includes."""
    cfg = RenderConfig(init_scale=8)
    device = camera.device
    render_fn = make_cuda_render_fn(cfg, sky, device)
    for name in ("scene_2", "room"):
        film_session(render_fn, scenes[name], camera, FILM_W, FILM_H, 7, 2, device, cfg)
    mk.reset_launch_counts()
    sessions = {}
    for name in ("scene_2", "room"):
        film, records = film_session(render_fn, scenes[name], camera, FILM_W, FILM_H, 8,
                                     FILM_FULL_PASSES, device, cfg)
        sessions[name] = (film, records)
    counts = dict(mk.launch_counts)  # read right after the film path
    report = {}
    for name, (film, records) in sessions.items():
        want_w = sum(r["spp"] / r["scale"] ** 2 for r in records)
        if float(film.weight) != want_w or not torch.isfinite(film.resolve()).all():
            raise RuntimeError(f"{name}: film weight {float(film.weight)}, expected {want_w}")
        per_scale = {}
        for scale in progressive_scales(cfg):
            rs = [r for r in records if r["scale"] == scale]
            lw, lh = lowres_size(FILM_W, FILM_H, scale)
            job = mk.make_tile_job(scenes[name], camera, lw, lh, cfg, aspect=FILM_W / FILM_H)
            per_scale[scale] = {
                "size": [lw, lh], "spp": rs[0]["spp"],
                "pass_ms": statistics.median(r["pass_ms"] for r in rs),
                "resolve_copy_ms": statistics.median(r["resolve_copy_ms"] for r in rs),
                "k1_ms_per_sample": device_seconds(lambda i: mk.run_tiles(job, i), 20) * 1e3,
                "tile_job_ms": time_host(lambda i: mk.make_tile_job(
                    scenes[name], camera, lw, lh, cfg, aspect=FILM_W / FILM_H), 20),
            }
        first_full = next(r for r in records if r["scale"] == 1)
        report[name] = {"per_scale": per_scale, "weight": float(film.weight),
                        "passes": len(records),
                        "invalidation_to_first_full_ms": first_full["since_invalidation_ms"],
                        "session_ms": records[-1]["since_invalidation_ms"]}
    samples = sum(r["spp"] for _, rs in sessions.values() for r in rs)
    if counts["megakernel_fwd"] != samples:
        raise RuntimeError(f"K1 launched {counts['megakernel_fwd']} times on the film path "
                           f"for {samples} samples")
    emit("film_path", size=[FILM_W, FILM_H], sky=[SKY_SIZE, SKY_SIZE],
         full_res_spp=FULL_RES_SPP, launches=counts, scenes=report,
         unit="ms on the host's clock up to a synchronise (medians); k1 by CUDA events")
    return counts


def _http(url, body=None, timeout=30):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _wait_for(cond, seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def phase_serve_path(scenes, sky) -> None:
    """RenderService on the room at 1280x960 on the card, its HTTP server
    in-process on 127.0.0.1:0: /healthz, five moves through POST /key and
    their event-to-frame latencies, passes per second and rays/s, then,
    stopped, /frame.png against the film and a checkpoint round trip."""
    import threading
    from http.server import ThreadingHTTPServer

    device = scenes["room"].device
    svc = RenderService(scenes["room"], FILM_W, FILM_H, RenderConfig(), sky, device)
    thread = threading.Thread(target=svc.run, daemon=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread.start()
    http_thread.start()
    try:
        if not _wait_for(lambda: svc.passes_done > 0, 120):
            raise RuntimeError("the service rendered no pass in 120 s")
        status, body = _http(base + "/healthz")
        health = json.loads(body)
        if status != 200 or set(health) != HEALTH_KEYS or health["resolution"] != [FILM_W,
                                                                                   FILM_H]:
            raise RuntimeError(f"/healthz {status}: {health}")
        for _ in range(5):
            n = len(svc.latencies_ms)
            pos = svc.camera.pos.clone()
            if _http(base + "/key", b"w")[0] != 200:
                raise RuntimeError("POST /key refused")
            if not _wait_for(lambda: len(svc.latencies_ms) > n, 30) \
                    or torch.equal(svc.camera.pos, pos):
                raise RuntimeError("a POST /key w did not move the camera and publish a frame")
        lat = list(svc.latencies_ms)[-5:]
        _wait_for(lambda: svc.pass_i > len(svc.scales) + 4, 30)  # into the full-res passes
        p0, t0 = svc.passes_done, time.perf_counter()
        time.sleep(2.0)
        rate = (svc.passes_done - p0) / (time.perf_counter() - t0)
        stats = svc.stats()
    finally:
        svc.running = False
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("the render thread did not stop")
    try:
        status, png = _http(base + "/frame.png")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "frame.png")
            with open(path, "wb") as f:
                f.write(png)
            frame = read_png(path)
            want = to_uint8(svc.film.resolve())[::-1]
            if status != 200 or frame.shape != (FILM_H, FILM_W, 3) \
                    or not np.array_equal(frame, want):
                raise RuntimeError(f"/frame.png {status} {frame.shape} differs from the film")
            svc.film_checkpoint = os.path.join(tmp, "film")
            svc._save_film_state()
            again = RenderService(scenes["room"], FILM_W, FILM_H, RenderConfig(), sky, device,
                                  film_checkpoint=svc.film_checkpoint)
            same_cam = all(torch.equal(getattr(again.camera, f), getattr(svc.camera, f))
                           for f in ("pos", "front", "up", "yaw", "pitch"))
            if not (torch.equal(again.film.weight, svc.film.weight) and same_cam
                    and torch.equal(again.film.resolve(), svc.film.resolve())):
                raise RuntimeError("the film checkpoint did not round-trip")
    finally:
        httpd.shutdown()
        httpd.server_close()
        http_thread.join(timeout=30)
    emit("serve_path", size=[FILM_W, FILM_H], scene="room", healthz=health,
         event_to_frame_ms={"median": statistics.median(lat), "max": max(lat), "all": lat},
         passes_per_second=rate, rays_per_second=stats["rays_per_second"],
         passes=stats["passes"], film_weight=stats["film_weight"])


def phase_viewer_path() -> None:
    """`python -m ray_tracing_tpu_torch --interactive` on a pseudo-terminal
    of 56 x 192 cells (a 192x108 render, the viewer's cap) with the room:
    frames per second over a quiet window (draws counted as they arrive),
    then w, space and q; requires 24-bit half-block cells, the screenshot
    and exit code 0."""
    import fcntl
    import pty
    import select
    import struct
    import termios

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        scene_file = os.path.join(tmp, "room.txt")
        with open(scene_file, "w") as f:
            f.write(ROOM_TEXT)
        master, slave = pty.openpty()
        # two pixel rows per cell and two lines for the HUD: the viewer's
        # fit_terminal then renders VIEWER_W x VIEWER_H
        fcntl.ioctl(slave, termios.TIOCSWINSZ,
                    struct.pack("HHHH", VIEWER_H // 2 + 2, VIEWER_W, 0, 0))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        err_path = os.path.join(tmp, "stderr.txt")
        with open(err_path, "wb") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tracing_tpu_torch", "--scene", scene_file,
                 "--interactive", "--width", str(VIEWER_W), "--height", str(VIEWER_H)],
                stdin=slave, stdout=slave, stderr=err, cwd=tmp, env=env)
        os.close(slave)
        out = bytearray()
        end = time.perf_counter() + 150

        def pump(until, seconds):
            stop = min(end, time.perf_counter() + seconds)
            while time.perf_counter() < stop and proc.poll() is None and not until():
                if select.select([master], [], [], 0.05)[0]:
                    try:
                        out.extend(os.read(master, 1 << 20))
                    except OSError:
                        return

        def stderr_has(text):
            with open(err_path, "rb") as f:
                return text in f.read()

        try:
            pump(lambda: out.count(b"\x1b[H") >= 3, 120)  # started, warm
            if proc.poll() is not None:
                with open(err_path, "r", errors="replace") as f:
                    raise RuntimeError(f"the viewer exited early ({proc.returncode}):\n"
                                       f"{f.read()[-2000:]}")
            n0, t0 = out.count(b"\x1b[H"), time.perf_counter()
            pump(lambda: False, 3.0)
            fps = (out.count(b"\x1b[H") - n0) / (time.perf_counter() - t0)
            for key, done in ((b"w", None), (b" ", b"Took screenshot!")):
                n = out.count(b"\x1b[H")
                os.write(master, key)
                pump(lambda: (out.count(b"\x1b[H") >= n + 2
                              and (done is None or stderr_has(done))), 30)
            os.write(master, b"q")
            rc = proc.wait(timeout=max(end - time.perf_counter(), 5))
            pump(lambda: False, 0.2)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            os.close(master)
        with open(err_path, "r", errors="replace") as f:
            err_text = f.read()
        shot = os.path.join(tmp, "screenshot_0.png")
        size = png_size(shot) if os.path.exists(shot) else None
        if rc != 0 or b"\x1b[38;2;" not in out or "▀".encode() not in out \
                or "Took screenshot!" not in err_text or size != (VIEWER_W, VIEWER_H, 8, 2):
            raise RuntimeError(f"viewer: rc {rc}, screenshot {size}, stderr:\n{err_text[-2000:]}")
    emit("viewer_path", size=[VIEWER_W, VIEWER_H], scene="room", frames_per_second=fps,
         frames=out.count(b"\x1b[H"), stdout_bytes=len(out))


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
    """The same gradient through the plain versions of both kernels and the
    plain sky lookup and compose, slice by slice."""
    scene_l, cam_l, leaves = with_leaves(scene, camera)
    h = HEIGHT // TRAIN_SLICES
    for k in range(TRAIN_SLICES):
        job = mk.make_tile_job(scene_l, cam_l, WIDTH, h, cfg, norm_height=HEIGHT)
        img = mk.render_frame(job, plain_replay_tiles, seed, spp, sky, row0=k * h,
                              plain_sky=True)
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
                    "megakernel_bwd_fetch": SPP, "sky_compose": SPP,
                    "sky_compose_adjoint": SPP}:
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
    below = mk.effective_bwd_mode(room, cfg_budget, WIDTH, HEIGHT, OVER_BUDGET_SPP - 1)
    if (mode, below) != ("replay", "fetch"):
        raise RuntimeError(f"{OVER_BUDGET_SPP} samples: effective_bwd_mode says {mode}, "
                           f"{OVER_BUDGET_SPP - 1}: {below}")
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
    want.update(megakernel_fwd=OVER_BUDGET_SPP, megakernel_bwd_replay=OVER_BUDGET_SPP,
                sky_compose=OVER_BUDGET_SPP, sky_compose_adjoint=OVER_BUDGET_SPP)
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
                                   * WIDTH * HEIGHT * mk.record_dtype(room.num_objects).itemsize,
        "albedo_grad_abs_sum": float(grads["albedo"].abs().sum())}

    # (c) the invert app at its defaults (96x64, 4 samples, 100 steps on p0,
    # the bilinear gradient sky, soft silhouettes): the loss falls, p0's
    # error shrinks, and each sample takes one bilinear sky compose and,
    # under grad, one bilinear adjoint (the target's 4 samples have none);
    # each frame one soft-silhouette composite and, under grad, one adjoint
    with tempfile.TemporaryDirectory() as tmp:
        scene_file = os.path.join(tmp, "scene_2.txt")
        with open(scene_file, "w") as f:
            f.write(SCENE_2_TEXT)
        before = dict(mk.launch_counts)
        secs, err = run_app(invert_main, ["--scene", scene_file])
        rose = {k: mk.launch_counts[k] - before[k] for k in before}
        loss = re.search(r"loss: ([-\d.e]+) -> ([-\d.e]+)", err)
        p0 = re.search(r"p0: \|err\| ([\d.]+) -> ([\d.]+) \((\w+)", err)
        if (rose["sky_compose_bilinear_adjoint"] != INVERT_STEPS * INVERT_SPP
                or rose["sky_compose_bilinear"] != (INVERT_STEPS + 1) * INVERT_SPP
                or rose["sky_compose"] or rose["sky_compose_adjoint"]
                or rose["soft_silhouettes"] != INVERT_STEPS + 1
                or rose["soft_silhouettes_adjoint"] != INVERT_STEPS
                or not loss or not float(loss.group(2)) < float(loss.group(1))
                or not p0 or p0.group(3) != "improved"):
            raise RuntimeError(f"invert at its defaults: launches {rose}: {err[-1500:]}")
        report["invert"] = {"seconds": round(secs, 3), "launches": rose,
                            "loss": [float(loss.group(1)), float(loss.group(2))],
                            "p0_abs_err": [float(p0.group(1)), float(p0.group(2))]}

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


# ---------------------------------------------------------------------------
# The sharded paths (parallel/): mesh, sharded render and train step, two
# processes, fit's checkpoints, the fit and fly-through apps, the dry run
# ---------------------------------------------------------------------------

# A sharded frame renders the one-device frame's samples and changes only the
# order of the sums: it must equal render_image_cuda's within this.
SHARD_ATOL = 1e-6
# The sharded step's loss against the one-device step's (relative), and its
# gradient's norm against theirs (|ratio - 1|): a sample axis of size S must
# not scale the gradient (the JAX package's step returns S times it).
SHARD_LOSS_RTOL = 1e-6
NORM_RATIO_TOL = 1e-3
# The sharded steps train albedo and p0 under fit's configuration: the
# bilinear sky and the soft silhouettes give p0 a gradient (with the default
# nearest sky and hard edges it has none)
SHARD_CFG = RenderConfig(env_filter="bilinear", soft_silhouette_temp=0.08)
# the invert app's defaults (apps/invert.py)
INVERT_STEPS, INVERT_SPP = 100, 4
RESUME_STEPS, RESUME_EVERY = 10, 5
RESUME_SPP = 2
# a resumed fit's losses against an uninterrupted fit's: within this share
# of each loss, or four times the spread of two uninterrupted fits (the
# backward kernels sum with float atomics), whichever is larger
RESUME_RTOL = 1e-4
FLY_FRAMES = 24
TWO_PROCESS_TIMEOUT = 300


def read_counts() -> dict:
    torch.cuda.synchronize()
    return dict(mk.launch_counts)


def require_launches(counts: dict, names, path: str) -> None:
    for k in names:
        if counts[k] < 1:
            raise RuntimeError(f"kernel {k} was not launched on the {path} path")


def phase_sharded_render(scenes, camera, sky) -> dict:
    """Both scenes at 1920x1080, 8 spp, on a 4x2 mesh of virtual cells of
    the card, against render_image_cuda of the same seed."""
    cfg = RenderConfig()
    device = camera.device
    mesh = make_mesh(4, 2, devices=[device] * 8)
    n_tiles = mesh.shape["tile"]
    report = {}
    with torch.no_grad():
        one = {n: mk.render_image_cuda(scenes[n], camera, WIDTH, HEIGHT, seed=3, spp=SPP,
                                       config=cfg, cubemap=sky) for n in ("scene_2", "room")}
        mk.reset_launch_counts()
        got = {n: render_image_sharded(scenes[n], camera, WIDTH, HEIGHT, 3, mesh, spp=SPP,
                                       config=cfg, cubemap=sky) for n in ("scene_2", "room")}
        counts = read_counts()
        want = {**dict.fromkeys(counts, 0), "megakernel_fwd": 2 * n_tiles * SPP,
                "sky_compose": 2 * n_tiles * SPP}
        if counts != want:
            raise RuntimeError(f"the sharded frames launched {counts}, expected {want}")
        for n in ("scene_2", "room"):
            err = float((got[n] - one[n]).abs().max())
            if tuple(got[n].shape) != (HEIGHT, WIDTH, 3) or not err <= SHARD_ATOL:
                raise RuntimeError(f"{n}: sharded frame {tuple(got[n].shape)} differs from the "
                                   f"one-device frame by {err}")
            report[n] = {
                "max_abs_err": err, "mean": float(got[n].mean()),
                "sharded_ms": time_host(lambda i, n=n: render_image_sharded(
                    scenes[n], camera, WIDTH, HEIGHT, 3, mesh, spp=SPP, config=cfg,
                    cubemap=sky), 5),
                "one_device_ms": time_host(lambda i, n=n: mk.render_image_cuda(
                    scenes[n], camera, WIDTH, HEIGHT, seed=3, spp=SPP, config=cfg,
                    cubemap=sky), 5)}
    emit("sharded_render", size=[WIDTH, HEIGHT], spp=SPP, mesh=mesh.shape, launches=counts,
         atol=SHARD_ATOL, scenes=report)
    return counts


def perturbed_room(room):
    gen = torch.Generator().manual_seed(0)
    noise_a = 0.2 * torch.randn(room.albedo.shape, generator=gen)
    noise_p = 0.05 * torch.randn(room.p0.shape, generator=gen)
    return dataclasses.replace(
        room, albedo=(room.albedo + noise_a.to(room.device)).clamp(0.05, 1.0),
        p0=room.p0 + noise_p.to(room.device))


def sharded_step(start, camera, sky, target, mesh, seed: int, spp: int = SPP, times: int = 0):
    """One make_train_step over `mesh` (SHARD_CFG) with the leaves albedo and
    p0 and a zero learning rate: (loss, {leaf: gradient}, launches, [ms of `times`
    more steps])."""
    leaves = {f: getattr(start, f).detach().clone().requires_grad_() for f in ("albedo", "p0")}
    opt = torch.optim.SGD(list(leaves.values()), lr=0.0)
    step = make_train_step(start, camera, opt, WIDTH, HEIGHT, spp=spp, config=SHARD_CFG,
                           cubemap=sky, device=camera.device, mesh=mesh)
    params = {"scene": leaves, "camera": {}}
    before = read_counts()
    loss = float(step(params, target, seed))
    counts = {k: v - before[k] for k, v in read_counts().items()}
    grads = {f: x.grad.detach().clone() for f, x in leaves.items()}
    ms = []
    for _ in range(times):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, target, seed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return loss, grads, counts, ms


def compare_steps(one, sharded, what: str) -> dict:
    """The sharded step's loss and gradient against the one-device step's;
    raises outside SHARD_LOSS_RTOL, gradient_agreement's backward tolerance
    (BWD_ROWS_*) or NORM_RATIO_TOL."""
    (l0, g0), (l1, g1) = one, sharded
    if not abs(l1 - l0) <= SHARD_LOSS_RTOL * abs(l0):
        raise RuntimeError(f"{what}: loss {l1} against the one-device step's {l0}")
    norm0 = float(torch.sqrt(sum((g ** 2).sum() for g in g0.values())))
    norm1 = float(torch.sqrt(sum((g ** 2).sum() for g in g1.values())))
    ratio = norm1 / norm0
    if not abs(ratio - 1.0) <= NORM_RATIO_TOL:
        raise RuntimeError(f"{what}: gradient norm {ratio} times the one-device gradient's")
    if not all(float(g.abs().max()) > 0 for g in g0.values()):
        raise RuntimeError(f"{what}: a leaf has no gradient to compare")
    worst = {f: gradient_agreement(g1[f], g0[f], BWD_ROWS_RTOL, BWD_ROWS_ATOL,
                                   g0[f].abs().max())["worst_err_over_allowed"] for f in g0}
    return {"loss": l1, "one_device_loss": l0, "loss_rel_err": abs(l1 - l0) / abs(l0),
            "grad_norm_ratio": ratio, "worst_err_over_allowed_by_leaf": worst}


def phase_sharded_train(scenes, camera, sky) -> dict:
    """One make_train_step on the room at 1920x1080, 8 spp: mesh (2, 2) of
    virtual cells against mesh None, the same seed."""
    room = scenes["room"]
    with torch.no_grad():
        target = mk.render_image_cuda(room, camera, WIDTH, HEIGHT, seed=99, spp=SPP,
                                      config=SHARD_CFG, cubemap=sky)
    start = perturbed_room(room)
    mesh = make_mesh(2, 2, devices=[camera.device] * 4)
    l0, g0, c0, ms0 = sharded_step(start, camera, sky, target, None, 5, times=3)
    l1, g1, c1, ms1 = sharded_step(start, camera, sky, target, mesh, 5, times=3)
    for counts, tiles, cells in ((c0, 1, 1), (c1, mesh.shape["tile"],
                                             mesh.shape["tile"] * mesh.shape["sample"])):
        # each cell composites its rows and samples with the soft silhouettes
        want = {**dict.fromkeys(counts, 0), "megakernel_fwd_record": tiles * SPP,
                "megakernel_bwd_fetch": tiles * SPP, "sky_compose_bilinear": tiles * SPP,
                "sky_compose_bilinear_adjoint": tiles * SPP, "soft_silhouettes": cells,
                "soft_silhouettes_adjoint": cells}
        if counts != want:
            raise RuntimeError(f"a train step over {tiles} tiles launched {counts}")
    report = compare_steps((l0, g0), (l1, g1), "sharded_train")
    emit("sharded_train", size=[WIDTH, HEIGHT], spp=SPP, mesh=mesh.shape, launches=c1,
         one_device_launches=c0, step_ms=statistics.median(ms1),
         one_device_step_ms=statistics.median(ms0), **report)
    return c1


def two_process_child(rank: int, store: str, device: str) -> int:
    """One of phase two_process's processes (chip_smoke.py --two-process-child
    RANK STORE DEVICE): gloo over a file:// store, both on DEVICE; prints one
    JSON line."""
    device = torch.device(device)
    initialize(f"file://{store}", world_size=2, rank=rank, backend="gloo", device=device)
    room = parse_scene_string(ROOM_TEXT, device=device)
    camera = Camera.default(device)
    sky = checker_sky(SKY_SIZE, device=device)
    with torch.no_grad():
        one = mk.render_image_cuda(room, camera, WIDTH, HEIGHT, seed=3, spp=SPP, cubemap=sky)
        target = mk.render_image_cuda(room, camera, WIDTH, HEIGHT, seed=99, spp=SPP,
                                      config=SHARD_CFG, cubemap=sky)
    start = perturbed_room(room)
    l0, g0, _, ms0 = sharded_step(start, camera, sky, target, None, 5, times=2)
    out = {"rank": rank}
    mk.reset_launch_counts()
    # 2x2: each process owns a tile; 1x2: one tile whose samples span both
    for cells in (2, 1):
        mesh = global_mesh(num_samples=2, devices=[device] * cells)
        lo, hi = local_tile_range(mesh, HEIGHT)
        with torch.no_grad():
            img = render_image_sharded(room, camera, WIDTH, HEIGHT, 3, mesh, spp=SPP,
                                       cubemap=sky)
            rows = (lo, hi) if cells == 2 else (0, HEIGHT)
            err = float((img - one[rows[0]:rows[1]]).abs().max())
            frame_ms = time_host(lambda i: render_image_sharded(
                room, camera, WIDTH, HEIGHT, 3, mesh, spp=SPP, cubemap=sky), 3)
        l1, g1, _, ms1 = sharded_step(start, camera, sky, target, mesh, 5, times=2)
        out[f"{mesh.shape['tile']}x{mesh.shape['sample']}"] = {
            "tile_range": [lo, hi], "rows": list(rows), "frame_max_abs_err": err,
            "frame_ms": frame_ms, "step_ms": statistics.median(ms1),
            **compare_steps((l0, g0), (l1, g1), f"two_process rank {rank}")}
    out["one_device_step_ms"] = statistics.median(ms0)
    out["launches"] = read_counts()
    print("TWO-PROCESS " + json.dumps(out), flush=True)
    return 0


def phase_two_process(device) -> dict:
    """Two processes on the one card, initialize(backend="gloo") through a
    file:// store, global_mesh(num_samples=2): each checks its frame, its
    rows and a train step against its own one-process computation. NCCL over
    several cards cannot run on one card and is not measured here."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--two-process-child", str(r), store, str(device)],
                                  cwd=here,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TWO_PROCESS_TIMEOUT))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    res = {}
    for p, (out, err) in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("TWO-PROCESS ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"a two-process child exited {p.returncode}: {err[-3000:]}")
        r = json.loads(lines[-1][len("TWO-PROCESS "):])
        res[r["rank"]] = r
    for rank, r in res.items():
        want_rows = [0, HEIGHT // 2] if rank == 0 else [HEIGHT // 2, HEIGHT]
        if r["2x2"]["tile_range"] != want_rows or r["1x2"]["tile_range"] != (
                [0, HEIGHT] if rank == 0 else [0, 0]):
            raise RuntimeError(f"rank {rank}: local_tile_range gave {r}")
        for shape in ("2x2", "1x2"):
            if not r[shape]["frame_max_abs_err"] <= SHARD_ATOL:
                raise RuntimeError(f"rank {rank} {shape}: frame off by {r[shape]}")
    counts = {k: res[0]["launches"][k] + res[1]["launches"][k] for k in res[0]["launches"]}
    require_launches(counts, ("megakernel_fwd", "megakernel_fwd_record", "megakernel_bwd_fetch"),
                     "two-process")
    emit("two_process", size=[WIDTH, HEIGHT], spp=SPP, backend="gloo", launches=counts,
         nccl="not measured: one card", ranks=res)
    return counts


def phase_fit_resume(scenes, camera, sky) -> dict:
    """fit on the room at 1920x1080 with checkpoint_dir: RESUME_STEPS steps
    with a checkpoint every RESUME_EVERY, then asked for twice as many,
    against two uninterrupted runs of that many (default physics)."""
    room = scenes["room"]
    with torch.no_grad():
        target = mk.render_image_cuda(room, camera, WIDTH, HEIGHT, seed=99, spp=SPP, cubemap=sky)
    start = perturbed_room(room)
    kw = dict(scene_fields=("albedo", "p0"), lr=2e-2, spp=RESUME_SPP, cubemap=sky, seed=3)
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    whole = [fit(start, camera, target, steps=2 * RESUME_STEPS, **kw)[2] for _ in range(2)]
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        _, _, first = fit(start, camera, target, steps=RESUME_STEPS, checkpoint_dir=d,
                          checkpoint_every=RESUME_EVERY, **kw)
        steps_saved = latest_step(d)
        _, _, resumed = fit(start, camera, target, steps=2 * RESUME_STEPS, checkpoint_dir=d,
                            checkpoint_every=RESUME_EVERY, **kw)
        steps_after = latest_step(d)
    counts = read_counts()
    spread = max(abs(a - b) for a, b in zip(*whole))
    err = [abs(a - b) for a, b in zip(resumed, whole[0])]
    allowed = [max(RESUME_RTOL * abs(b), 4 * spread) for b in whole[0]]
    if resumed[:RESUME_STEPS] != first or steps_saved != RESUME_STEPS \
            or steps_after != 2 * RESUME_STEPS or len(resumed) != 2 * RESUME_STEPS:
        raise RuntimeError(f"resume: {first} then {resumed}, checkpoints {steps_saved}, "
                           f"{steps_after}")
    if not all(e <= a for e, a in zip(err, allowed)):
        raise RuntimeError(f"resumed losses {resumed} against uninterrupted {whole[0]}")
    require_launches(counts, ("megakernel_fwd_record", "megakernel_bwd_fetch"), "fit_resume")
    emit("fit_resume", size=[WIDTH, HEIGHT], spp=RESUME_SPP, launches=counts,
         losses_first=first, losses_resumed=resumed, losses_uninterrupted=whole,
         spread_of_two_uninterrupted=spread, max_err_resumed=max(err),
         ms_per_step=(t1 - t0) * 1e3 / (4 * RESUME_STEPS))
    return counts


def run_app(main_fn, argv) -> tuple[float, str]:
    """(seconds, stderr) of one app invocation; raises on a non-zero code.
    The app's stderr is captured and returned."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{main_fn.__module__} returned {rc}: {buf.getvalue()[-2000:]}")
    return time.perf_counter() - t0, buf.getvalue()


def phase_apps_fit(scenes, device) -> dict:
    """invert --multiscale and invert --checkpoint-dir (resumed) on the room
    at 1920x1080; pose_recovery at its defaults on the four-object scene
    against a target rendered from a known pose; flythrough --sharded on a
    4x2 mesh of virtual cells, FLY_FRAMES frames at 1920x1080, 8 spp."""
    report = {}
    mk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        room_file = os.path.join(tmp, "room.txt")
        with open(room_file, "w") as f:
            f.write(ROOM_TEXT)
        on = ["--device", device.type]
        big = ["--scene", room_file, "--width", str(WIDTH), "--height", str(HEIGHT),
               "--fields", "albedo", *on]
        secs, err = run_app(invert_main, big + ["--steps", "6", "--multiscale"])
        report["invert_multiscale"] = {"seconds": secs, "steps": 6,
                                       "log": [ln for ln in err.splitlines()
                                               if ln.startswith(("step", "loss", "albedo"))]}
        ck = os.path.join(tmp, "ck")
        s1, _ = run_app(invert_main, big + ["--steps", "4", "--checkpoint-dir", ck])
        s2, err = run_app(invert_main, big + ["--steps", "8", "--checkpoint-dir", ck])
        if latest_step(ck) != 8 or "step     0" in err or "step     7" not in err:
            raise RuntimeError(f"invert --checkpoint-dir did not resume at step 4: {err[-1500:]}")
        report["invert_checkpoint"] = {"seconds": [s1, s2], "steps": [4, 8]}

        # pose recovery against a self-rendered target written flipped, as
        # the reference's screenshots are
        pose_file = os.path.join(tmp, "pose.txt")
        with open(pose_file, "w") as f:
            f.write(POSE_SEARCH_TEXT)
        scene = parse_scene_string(POSE_SEARCH_TEXT, device=device)
        center, half_diag = scene_bounds(scene)
        gdir = np.array([0.55, 0.35, 0.76])
        gpos = center + gdir / np.linalg.norm(gdir) * (1.25 * half_diag)
        true = dataclasses.replace(Camera.default(device),
                                   pos=torch.tensor(gpos, dtype=torch.float32, device=device),
                                   front=torch.tensor(center - gpos, dtype=torch.float32,
                                                      device=device))
        with torch.no_grad():
            target = mk.render_image_cuda(
                scene, true, 160, 120, 5, spp=64, cubemap=checker_sky(SKY_SIZE, device=device),
                config=RenderConfig(env_filter="bilinear", bounces=3, shadow_samples=1,
                                    pixel_jitter=True))
        save_png(target, os.path.join(tmp, "target.png"))
        secs, err = run_app(pose_main, ["--scene", pose_file, "--target",
                                        os.path.join(tmp, "target.png"),
                                        "--out", os.path.join(tmp, "pose.png"), *on])
        m = re.search(r"correlation vs target: ([-\d.]+) -> ([-\d.]+)", err)
        t = re.search(r"search ([\d.]+) s, refinement ([\d.]+) s", err)
        pos = json.loads(re.search(r"pos: (\[.*\])", err).group(1))
        front = json.loads(re.search(r"front: (\[.*\])", err).group(1))
        corr0, corr1 = float(m.group(1)), float(m.group(2))
        if not corr1 > corr0:
            raise RuntimeError(f"pose_recovery: correlation {corr0} -> {corr1}: {err[-2000:]}")
        f_true = (center - gpos) / np.linalg.norm(center - gpos)
        f_rec = np.asarray(front) / np.linalg.norm(front)
        report["pose_recovery"] = {
            "seconds": secs, "search_seconds": float(t.group(1)),
            "refinement_seconds": float(t.group(2)), "correlation": [corr0, corr1],
            "pos_error": float(np.linalg.norm(np.asarray(pos) - gpos)),
            "front_error_degrees": float(np.degrees(np.arccos(np.clip(f_rec @ f_true, -1, 1)))),
            "size": [160, 120], "out_png": png_size(os.path.join(tmp, "pose.png"))[:2]}

        fly = os.path.join(tmp, "fly")
        secs, err = run_app(fly_main, ["--scene", room_file, "--frames", str(FLY_FRAMES),
                                       "--width", str(WIDTH), "--height", str(HEIGHT),
                                       "--spp", str(SPP), "--out-dir", fly, "--sharded",
                                       "--mesh", "4x2", *on])
        frames = sorted(os.listdir(fly))
        if len(frames) != FLY_FRAMES or png_size(os.path.join(fly, frames[-1]))[:2] != (
                WIDTH, HEIGHT):
            raise RuntimeError(f"flythrough wrote {frames}")
        report["flythrough"] = {"frames": FLY_FRAMES, "seconds": secs,
                                "frames_per_second": FLY_FRAMES / secs, "mesh": "4x2",
                                "last_line": err.strip().splitlines()[-1]}
    counts = read_counts()
    require_launches(counts, ("megakernel_fwd", "megakernel_fwd_record", "megakernel_bwd_fetch"),
                     "apps")
    emit("apps_fit", launches=counts, **report)
    return counts


def phase_dryrun(device) -> dict:
    mk.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = dryrun_multichip(8, device=device)
    counts = read_counts()
    require_launches(counts, ("megakernel_fwd", "megakernel_fwd_record", "megakernel_bwd_fetch"),
                     "dryrun")
    emit("dryrun", cells=8, loss=loss, line=buf.getvalue().strip(), launches=counts)
    return counts


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
    cotangents, and with all-zero cotangents. The control does not isolate
    the routing: with zero cotangents every value routed is zero, so no
    shared or global atomic add is made and the shadow samples' routing is
    skipped, but the walk, the sweep's evaluation, the adjoint and the
    warp's reductions by key all run. The difference is the cost of the
    adds themselves and of the shadow routing."""
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


# ptxas' name of each megakernel -> its name in launch_info
_LAUNCH_NAMES = {"fwd_b0": "fwd", "fwd_b1": "fwd_record", "bwd_fetch": "fetch",
                 "bwd_replay": "replay", "bwd_direct": "direct"}


def kernel_resources(ptxas: dict, scenes, camera) -> dict:
    """Per megakernel: ptxas' registers, stack and spills, and per scene
    what a launch at 1920x1080 takes (mk.launch_info: shared memory per
    block, entry states kept, blocks and warps resident per SM)."""
    out = {}
    for kname, launch in _LAUNCH_NAMES.items():
        out[kname] = {k: ptxas[kname][k] for k in ("registers", "stack", "spill_stores",
                                                   "spill_loads")}
        for name in ("scene_2", "room"):
            job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
            out[kname][name] = mk.launch_info(launch, job)
    # the int16 instantiations of K2 and K3: ptxas' report (no scene here
    # has 128 objects; phase large_scene launches them)
    for kname in ("fwd_b1_i16", "bwd_fetch_i16"):
        out[kname] = {k: ptxas[kname][k] for k in ("registers", "stack", "spill_stores",
                                                   "spill_loads")}
    return out


def phase_timing(scenes, camera, sky, ptxas) -> dict:
    cfg = RenderConfig()
    out = {"resources": kernel_resources(ptxas, scenes, camera)}
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
    if recs[0].dtype != torch.int16:  # past 127 objects: K2 and K3 at two bytes an index
        raise RuntimeError(f"{big.num_objects} objects: index planes of {recs[0].dtype}")
    out = {"k1_ms": time_launches(lambda s: mk.run_tiles(job, s), 3, warmup=0),
           "k3_ms": time_launches(lambda s: mk._launch_bwd("fetch", job, s % 3, 0, recs[s % 3], cot),
                                  3, warmup=0),
           "k4_ms": time_launches(lambda s: mk._launch_bwd("replay", job, s, 0, None, cot),
                                  3, warmup=0)}
    k2_ms = time_launches(lambda s: mk.run_tiles(job, s, record=True), 1, warmup=0)
    emit("large_scene", objects=big.num_objects, size=[WIDTH, HEIGHT], launches_each=3,
         index_dtype=str(recs[0].dtype),
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
    was, so its next primary index is -1 again without arithmetic, and its
    shadow indices are -1 by the index planes' dead-lane rule
    (kernels/megakernel.py, record_layout). With `record` and a light the
    recorded shadow indices of a live bounce are the winners of every
    sample, accepted or not, so each active lane casts all `ns` of its
    shadow rays."""
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
            rays = ns * active if record else stats["shadow_rays"][b]
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


def issue_floor(scene: Scene, stats: dict, tests: dict, device: dict,
                cfg: RenderConfig) -> dict:
    """Least time the card's schedulers could take to issue one sample's
    object tests (the trace loops alone, as compiled): per test the SASS
    instructions of its kind (per_object_test), a warp issuing one
    instruction for 32 lanes, 4 schedulers per SM each issuing one per clock
    at the highest SM clock. The tests this input needs: every object for
    every alive lane's closest-hit ray; per shadow ray cast (an accepted
    sample of an active lane) with a single emitter the light's test, and
    every other object only for the rays that reach the light (a blocked ray
    stops at its first occluder, counted as none), with several lights every
    object. Without FMA contraction (--fmad=false) float work issues at
    half the FFMA rate: this floor, not the fp32 peak, is what the loops can
    reach. It is not the bound: the bound counts what the outputs need."""
    if not {"sphere", "sphere_occluder", "box"} <= set(tests):
        return {"issue_floor_ms": None, "tests_found": sorted(tests)}
    n_sph = sum(t == OBJ_SPHERE for t in scene.obj_type)
    n_box = scene.num_objects - n_sph
    closest = n_sph * tests["sphere"] + n_box * tests["box"]
    lanes = sum(stats["alive"]) * closest
    has_light = scene.has_light and cfg.shadow_samples > 0
    if has_light:
        rays, reached = sum(stats["shadow_rays"]), sum(stats["shadow_taken"])
        if sum(bool(e) for e in (scene.emissive or ())) == 1:
            light_sph = scene.obj_type[scene.light_index] == OBJ_SPHERE
            lanes += rays * (tests["sphere"] if light_sph else tests["box"])
            lanes += reached * ((n_sph - light_sph) * tests["sphere_occluder"]
                                + (n_box - (not light_sph)) * tests["box"])
        else:
            lanes += rays * closest
    warp_instructions = lanes / 32
    rate = device["sms"] * 4 * device["max_sm_clock_mhz"] * 1e6
    return {"issue_floor_ms": warp_instructions / rate * 1e3,
            "warp_instructions": warp_instructions, "issue_per_s": rate}


def resource_fields(res: dict) -> dict:
    """The kernels line's resource keys of one megakernel: registers, stack
    frame, spills and local memory per thread, and per scene shared memory
    per block and resident warps per SM."""
    return {"registers": res["registers"], "stack_bytes": res["stack"],
            "spill_bytes": res["spill_stores"] + res["spill_loads"],
            # local memory a thread takes, the frames of called functions included
            "local_bytes": res["room"]["stack_bytes"],
            "smem_bytes_per_block": {n: res[n]["static_smem_bytes"] + res[n]["dynamic_smem_bytes"]
                                     for n in ("scene_2", "room")},
            "warps_per_sm": {n: res[n]["warps_per_sm"] for n in ("scene_2", "room")}}


def trace_fields(kname: str, ptxas: dict, scenes, at_full, dev: dict, cfg) -> dict:
    """The kernels line's trace keys of K1 or K4: the SASS instructions per
    object test and the loops they come from, and per scene the issue-rate
    floor of its object tests (issue_floor; K4's walk traces what K1
    traces, its sweep nothing on these scenes)."""
    tests = ptxas[kname]["sass_per_object_test"]
    return {"sass_per_object_test": tests, "trace_loops": ptxas[kname]["trace_loops"],
            "issue_floor": {n: issue_floor(scenes[n], at_full[n]["stats"], tests, dev, cfg)
                            for n in ("scene_2", "room")}}


def phase_kernels(scenes, at_full, bwd_at_full, retrace, retrace_full, counts, train_counts,
                  film_counts, timing, checks, bench_res, sky_res, ptxas, dev,
                  sharded_counts, sky_compose, soft) -> None:
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
        res = timing["resources"]["fwd_b1" if record else "fwd_b0"]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/megakernel_fwd.cu",
            **resource_fields(res),
            **({} if record else trace_fields("fwd_b0", ptxas, scenes, at_full, dev, cfg)),
            "replaces": replaces,
            # the serving path for the forward, the training path for the
            # recording forward, whose planes the backward consumes
            "launches": train_counts[kname] if record else counts[kname],
            "launches_by_path": {"serving": counts[kname], "training": train_counts[kname],
                                 "film": film_counts[kname]},
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
        **resource_fields(timing["resources"]["bwd_fetch"]),
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
        lead = per_scene["scene_2"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/megakernel_bwd_retrace.cu",
            **resource_fields(timing["resources"]["bwd_" + kernel]),
            **(trace_fields("bwd_replay", ptxas, scenes, at_full, dev, cfg)
               if kernel == "replay" else {}),
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
        # the probe's shape and the sky's indices (gather_times; the sky's
        # bound counts each distinct 32-byte sector of the table once)
        "per_case": sky_res["cases"],
    })
    for kname, ms, bound_key, err_key in (
            ("sky_compose", "kernel_ms", "bound_ms", "sum_max_abs_err"),
            ("sky_compose_adjoint", "adjoint_ms", "adjoint_bound_ms", "cotangent_max_abs_err")):
        lead = sky_compose["scene_2"]
        # the bilinear arms: timed under grad (the state written), the
        # train step's case, on invert's 32x32 float sky
        arm = {k: dict(r["bilinear"], kernel_ms=r["bilinear"]["state_ms"])
               for k, r in sky_compose.items()}
        bil_name = kname.replace("sky_compose", "sky_compose_bilinear")
        rows.append({
            "name": bil_name, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/sky_compose.cu",
            "registers": ptxas[bil_name]["registers"],
            "replaces": "none: the bilinear sky lookup and compose that XLA fuses inside "
                        "ray_tracing_tpu/kernels/megakernel.py::render_image_pallas",
            # the invert app and the fits of the training path launch them
            "launches": train_counts[bil_name],
            "launches_by_path": {"serving": counts[bil_name], "training": train_counts[bil_name]},
            # against the plain lookup and autograd through it, both skies
            # (bilinear_vs_plain): the sum bit-equal, the cotangent off in
            # the miss and direction planes within their tolerances
            "max_abs_err": max(r["bilinear"][n][err_key] for r in sky_compose.values()
                               for n in ("checker", "gradient")),
            "ms": arm["scene_2"][ms], "plain_ms": arm["scene_2"]["plain_ms"],
            "bound_ms": arm["scene_2"][bound_key], "bound_by": "bytes",
            "library_ms": None,
            "shape": [WIDTH, HEIGHT], "scene": "scene_2", "sky": "gradient_sky 32x32, float",
            "per_scene": {n: {"ms": r[ms], "bound_ms": r[bound_key], "plain_ms": r["plain_ms"]}
                          for n, r in arm.items()},
        })
        rows.append({
            "name": kname, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/sky_compose.cu",
            "registers": ptxas[kname]["registers"],
            "replaces": "none: the sky lookup and compose that XLA fuses inside "
                        "ray_tracing_tpu/kernels/megakernel.py::render_image_pallas",
            "launches": counts[kname] if kname == "sky_compose" else train_counts[kname],
            "launches_by_path": {"serving": counts[kname], "training": train_counts[kname]},
            "max_abs_err": 0,  # bit-equal (phase sky_compose_vs_plain; the miss cotangent 1e-6 rel)
            "ms": lead[ms], "plain_ms": lead["plain_ms"],
            "bound_ms": lead[bound_key], "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call looks a cubemap up
            "shape": [WIDTH, HEIGHT], "scene": "scene_2",
            "per_scene": {n: {"ms": r[ms], "bound_ms": r[bound_key], "plain_ms": r["plain_ms"]}
                          for n, r in sky_compose.items()},
        })
    for kname, ms, bound_key, err_key in (
            ("soft_silhouettes", "kernel_ms", "bound", "frame_max_abs_err"),
            ("soft_silhouettes_adjoint", "adjoint_ms", "adjoint_bound", "adjoint_max_abs_err")):
        lead = soft["scene_2"]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "ray_tracing_tpu_torch/kernels/csrc/sky_compose.cu",
            "registers": ptxas[kname]["registers"],
            "spill_bytes": ptxas[kname].get("spill_stores", 0) + ptxas[kname].get("spill_loads", 0),
            "replaces": "none: the soft silhouettes' composite that XLA fuses inside "
                        "ray_tracing_tpu/kernels/megakernel.py::render_image_pallas",
            "launches": train_counts[kname],
            "launches_by_path": {"serving": counts[kname], "training": train_counts[kname]},
            # against the plain twin: the frame bit for bit, the adjoint's
            # sums within their terms' rounding (soft_vs_plain)
            "max_abs_err": max(r[sky][err_key] for r in soft.values()
                               for sky in ("gradient", "checker_nearest")),
            "ms": lead[ms], "plain_ms": lead["plain_ms" if kname == "soft_silhouettes"
                                             else "plain_with_autograd_ms"],
            "bound_ms": lead[bound_key]["bound_ms"], "bound_by": lead[bound_key]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the composite
            "shape": [WIDTH, HEIGHT], "scene": "scene_2", "sky": "gradient_sky 32x32, float",
            "per_scene": {n: {"ms": r[ms], "bound_ms": r[bound_key]["bound_ms"],
                              "objects": len(scenes[n].obj_type)} for n, r in soft.items()},
        })
    for row in rows:  # the share of the least time the card could take
        row["bound_share"] = row["bound_ms"] / row["ms"]
        # the launches of each sharded path, each counted from 0 just
        # before its phase
        for path, c in sharded_counts.items():
            if row["name"] in c:
                row.setdefault("launches_by_path", {})[path] = c[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)


def gather_bound(planes) -> dict:
    """Least time of one gather of each index plane, averaged over the
    planes: every index read and every result written once, and each
    distinct 32-byte sector of the table that the plane reads once, at the
    memory rate."""
    nbytes = statistics.mean(8 * q.numel() + 32 * torch.unique(q.reshape(-1) // 8).numel()
                             for q in planes)
    return {"bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes", "bytes": nbytes}


def gather_times(scenes, camera) -> dict:
    """P1 through gather_probe.gather, which every version of the package
    has: at the probe's shape over its R distinct index planes (as
    gather_probe.run times it), and on the sky's texel indices of scene_2
    and of the room (R samples at 1920x1080 with distinct seeds, into the
    packed 2048^2 cubemap: 100 MB, past the L2), beside table[idx] on the
    same indices and each case's bound (gather_bound). Milliseconds per
    call by CUDA events over 2R calls, the median of GATHER_WINDOWS such
    windows (one window lasts some 0.1-0.5 ms)."""
    sky = checker_sky(SKY_SIZE, device=camera.device)
    table, idx = gather_probe.probe_inputs(camera.device)
    cases = {"probe": (table, [idx ^ (r & 0x3FF) for r in range(gather_probe.R)])}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
        cases[name + "_sky"] = (sky.packed, [
            mk._miss_texel_index(sky, mk.run_tiles(job, 17 + r)[0])[0]
            for r in range(gather_probe.R)])
    out = {}
    for name, (tbl, planes) in cases.items():
        n = len(planes)
        for q in planes:  # warm: the library loaded, every plane touched once
            gather_probe.gather(tbl, q)
            tbl[q]
        out[name] = {
            "ms": statistics.median(
                device_seconds(lambda i: gather_probe.gather(tbl, planes[i % n]), 2 * n)
                for _ in range(GATHER_WINDOWS)) * 1e3,
            "library_ms": statistics.median(
                device_seconds(lambda i: tbl[planes[i % n]], 2 * n)
                for _ in range(GATHER_WINDOWS)) * 1e3,
            "indices": list(planes[0].shape), "table_entries": tbl.numel(),
            **gather_bound(planes)}
    return out


def kernel_times() -> int:
    """`python3 chip_smoke.py --times`: builds the forward, backward and
    gather libraries of the package first on the import path and prints one
    JSON line: ptxas' report with K1's and K4's trace loops, launch_info of
    each megakernel on the room, the median times of K1-K5 (and K3, K4, K5
    with all-zero cotangents) at 1920x1080 on scene_2 and the room, default
    physics, 20 launches each, and P1's times (gather_times). It calls only
    functions that every version of the package with `launch_info` has, so
    that another checkout's kernels can be timed with this script
    (kernel_times_in_turns)."""
    dev = phase_device()
    names = (mk.KERNEL_LIBRARY, mk.BWD_KERNEL_LIBRARY, mk.RETRACE_KERNEL_LIBRARY,
             gather_probe.LIBRARY)
    infos, ptxas, wall = build_libraries(names)
    add_trace_loops(ptxas, {n: i["path"] for n, i in zip(names, infos)})
    device = torch.device("cuda", 0)
    scenes = make_scenes(device)
    camera = Camera.default(device)
    out = {}
    for name in ("scene_2", "room"):
        job = mk.make_tile_job(scenes[name], camera, WIDTH, HEIGHT, RenderConfig())
        out[name] = {"k1_ms": time_launches(lambda s: mk.run_tiles(job, s), 20),
                     "k2_ms": time_launches(lambda s: mk.run_tiles(job, s, record=True), 20)}
        out[name]["k3_ms"], out[name]["k3_zero_cotangents_ms"] = time_bwd(job, 20)
        for kernel, key in (("replay", "k4"), ("direct", "k5")):
            out[name][f"{key}_ms"], out[name][f"{key}_zero_cotangents_ms"] = \
                time_retrace(job, kernel, 20)
    out["gather"] = gather_times(scenes, camera)
    room = mk.make_tile_job(scenes["room"], camera, WIDTH, HEIGHT, RenderConfig())
    launch = {k: mk.launch_info(k, room) for k in ("fwd", "fwd_record", *mk.BWD_KERNELS)}
    print(json.dumps({"times": out, "package": os.path.dirname(mk.__file__), "device": dev,
                      "build_seconds": round(wall, 2), "ptxas": ptxas, "launch_info_room": launch}),
          flush=True)
    return 0


def kernel_times_in_turns(checkouts) -> int:
    """`python3 chip_smoke.py --times CHECKOUT...`: kernel_times of each
    checkout (a directory holding a version of the package, `.` for this
    one) in the order given, each in a process of its own started in that
    directory, so that its package is the one imported and built; prints
    one JSON line {"turns": [...]} with each turn's line and seconds.
    Compare versions in turns (parent, change, change, parent): two calls
    may land on two cards."""
    script = os.path.abspath(__file__)
    code = ("import runpy, sys; sys.argv = ['chip_smoke.py', '--times']; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    turns = []
    for checkout in checkouts:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                              text=True)
        turn = {"checkout": checkout, "seconds": round(time.perf_counter() - t0, 1)}
        if proc.returncode == 0:
            turn.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        else:  # the other turns still run; the exit code says one failed
            turn["error"] = proc.stderr[-4000:]
        turns.append(turn)
    print(json.dumps({"turns": turns}), flush=True)
    return int(any("error" in t for t in turns))


def main() -> int:
    if sys.argv[1:2] == ["--two-process-child"]:  # spawned by phase two_process
        return two_process_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--times"]:
        return kernel_times()
    if sys.argv[1:2] == ["--times"]:
        return kernel_times_in_turns(sys.argv[2:])
    dev = phase_device()
    device = torch.device("cuda", 0)
    ptxas = phase_build()
    scenes = make_scenes(device)
    camera = Camera.default(device)
    sky = checker_sky(SKY_SIZE, device=device)
    at_full = phase_kernel_vs_plain(scenes, camera)
    bwd_results, bwd_at_full = phase_bwd_kernel_vs_plain(scenes, camera)
    retrace = phase_bwd_modes_vs_plain(scenes, camera)
    retrace_full_results, retrace_full = phase_bwd_modes_full_size(scenes, camera)
    many_fetch, many_retrace = phase_many_shadow_samples(scenes, camera)
    phase_stream_identity(bwd_results + many_fetch, retrace + retrace_full_results + many_retrace)
    checks = phase_peak_and_gather_vs_plain(scenes, camera, sky)
    sky_compose = phase_sky_compose_vs_plain(scenes, camera, sky)
    soft = phase_soft_silhouettes_vs_plain(scenes, camera, sky)
    counts = phase_main_path(scenes, camera, sky)
    phase_cli()
    phase_native()
    phase_cubemap_load(device)
    phase_film_vs_plain(scenes, camera, sky)
    film_counts = phase_film_path(scenes, camera, sky)
    phase_serve_path(scenes, sky)
    phase_viewer_path()
    train_counts, _ = phase_train_path(scenes, camera, sky)
    sharded_counts = {"sharded_render": phase_sharded_render(scenes, camera, sky),
                      "sharded_train": phase_sharded_train(scenes, camera, sky),
                      "two_process": phase_two_process(device),
                      "fit_resume": phase_fit_resume(scenes, camera, sky),
                      "apps_fit": phase_apps_fit(scenes, device),
                      "dryrun": phase_dryrun(device)}
    bench_res = phase_bench_path(scenes, camera, sky)
    sky_res = phase_sky_gather(scenes, camera, sky)
    timing = phase_timing(scenes, camera, sky, ptxas)
    phase_large_scene(camera)
    torch.cuda.synchronize()
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    phase_kernels(scenes, at_full, bwd_at_full, retrace, retrace_full, counts, train_counts,
                  film_counts, timing, checks, bench_res, sky_res, ptxas, dev, sharded_counts,
                  sky_compose, soft)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
