"""Inverse rendering: recover scene and camera parameters from a target
image by gradient descent through the renderer.

Counterpart of ``ray_tracing_tpu/diff/inverse.py``. The train step renders
through ``render_image_cuda`` on every cell of a (tile, sample) mesh
(parallel/): on the card the forward of every sample is the recording CUDA
kernel and ``backward()`` runs the backward CUDA kernel. Each cell renders
its row slice with its share of the samples, the tiles' squared errors make
the loss, and the gradients of the cells are summed (by autograd within a
process, by an all-reduce across processes). ``mesh=None`` is one device.

Beside the step: ``fit`` (Adam, with checkpoints and resume),
``fit_multiscale`` (coarse to fine), and ``coarse_pose_search`` (a
forward-only ranking of candidate camera poses at thumbnail size, the
global initialiser of apps/pose_recovery.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.diff.checkpoint import restore_checkpoint, save_checkpoint
from ray_tracing_tpu_torch.kernels.megakernel import _wrap_i32, render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import CubemapData
from ray_tracing_tpu_torch.parallel.distributed import is_coordinator
from ray_tracing_tpu_torch.parallel.mesh import (
    SAMPLE_AXIS,
    TILE_AXIS,
    Mesh,
    current_rank,
    single_device_mesh,
)
from ray_tracing_tpu_torch.parallel.render import all_reduce_, render_tiles_sharded
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, Scene
from ray_tracing_tpu_torch.utils.profiling import span

SCENE_PARAM_FIELDS = (
    "p0", "p1", "albedo", "roughness", "reflectance", "metallic",
    "emission_power", "emission_color",
)
CAMERA_PARAM_FIELDS = ("pos", "front", "up")


def extract_params(scene: Scene, fields) -> dict:
    """The optimisable leaves of a scene, by field name. Rejects anything
    outside SCENE_PARAM_FIELDS up front: static metadata (emissive,
    obj_type) or a mistyped name would otherwise surface deep inside the
    first step."""
    unknown = [f for f in fields if f not in SCENE_PARAM_FIELDS]
    if unknown:
        raise ValueError(
            f"not optimizable scene fields: {unknown}; "
            f"expected among {SCENE_PARAM_FIELDS}"
        )
    return {f: getattr(scene, f) for f in fields}


def apply_params(scene: Scene, params: dict) -> Scene:
    return dataclasses.replace(scene, **params)


def area_downsample(img, height: int, width: int):
    """Integer-factor area mean-pool of (H, W, C) to (height, width, C):
    crop to a multiple of the factor, reshape, mean. Raises when the source
    is smaller than the target: a zero factor would crop to nothing and the
    mean of an empty axis is NaN."""
    H, W = img.shape[0], img.shape[1]
    fy, fx = H // height, W // width
    if fy < 1 or fx < 1:
        raise ValueError(
            f"cannot area-downsample {(H, W)} to {(height, width)}: "
            "target grid is larger than the source image"
        )
    t = img[: height * fy, : width * fx]
    return t.reshape(height, fy, width, fx, *img.shape[2:]).mean(dim=(1, 3))


def step_seed(seed: int, step: int) -> int:
    """The render seed of training step `step`: seed * 1000003 + step in
    wrapping int32. Deterministic, distinct from step to step, and apart
    from the per-sample seeds render_frame derives from it (seed * 7919 +
    i)."""
    return _wrap_i32(seed * 1000003 + step)




def _image(target, device) -> torch.Tensor:
    """An (H, W, 3) image (tensor or array, any strides) as float32 on `device`."""
    if isinstance(target, np.ndarray):
        target = np.ascontiguousarray(target, np.float32)
    return torch.as_tensor(target, dtype=torch.float32, device=device)


def _reduce_over_processes(loss: torch.Tensor, optimizer: torch.optim.Optimizer) -> None:
    """Sum the loss and every parameter's gradient over the processes, in
    one all-reduce (a leaf no gradient reached counts as zeros)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    flat = torch.cat([loss.reshape(1)] + [
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])
    all_reduce_(flat)
    loss.copy_(flat[0])
    offset = 1
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
        offset += p.numel()


def make_train_step(base_scene: Scene, camera: Camera,
                    optimizer: torch.optim.Optimizer, width: int, height: int,
                    spp: int = 4, config: RenderConfig = DEFAULT_CONFIG,
                    cubemap: CubemapData | None = None, device=None,
                    mesh: Mesh | None = None):
    """Build the train step over `mesh` (None: one device, `device`).

    Returns step(params, target, seed) -> loss, a 0-dim tensor. `params` is
    {"scene": {field: leaf}, "camera": {field: leaf}} of tensors that
    require grad and that `optimizer` (any torch.optim.Optimizer, Adam where
    the JAX package takes optax's) was built over; `target` is the whole
    (H, W, 3) image. Every cell of this process renders its rows and samples
    of the frame seeded `seed` (parallel/render.py: the one-device frame's
    samples, so a mesh changes only the order of the sums), and

        loss = sum over tiles of SSE(tile) / (W * H * 3),

    each tile counted once. backward() sums the cells' gradients within the
    process; with cells in several processes the loss and the gradients are
    then summed over them in one all-reduce. The gradient is the loss's, at
    every mesh shape: the sample axis does not multiply it (the JAX
    package's step returns S times it; parallel/render.py::SampleSum). The
    step updates the leaves in place and does not synchronise with the
    device. While a profiler runs it records the spans "train_step" and,
    inside it, "step.params", "step.forward", "step.loss", "step.backward",
    "step.reduce" (across processes only) and "step.optimizer"
    (utils/profiling.py::span).

    When emission_power or emission_color are trained, the static
    `emissive` metadata is dropped here, so that the shadow trace takes the
    full scan and next-event emission gradients reach every row (the
    occlusion-only trace would send them to the build-time light alone).

    Guards, as in the JAX package: spp a positive multiple of the sample
    axis, height a multiple of the tile axis. device=None means the card,
    or with a mesh the device of this process's first cell: the leaves'
    device, where the loss is summed."""
    if mesh is None:
        mesh = single_device_mesh(resolve_device(device))
    if device is None:
        device = mesh.local_cells()[0][2].device
    device = resolve_device(device)
    n_tiles, n_samples = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    if spp < 1 or spp % n_samples:
        raise ValueError(f"spp {spp} must be a positive multiple of the sample axis "
                         f"size {n_samples}")
    if height % n_tiles:
        raise ValueError(f"height {height} not divisible by tile axis {n_tiles}")
    denom = float(width * height * 3)
    local_h = height // n_tiles
    rank = current_rank()
    owned = [t for t, row in enumerate(mesh.cells) if row[0].rank == rank]
    across = len(mesh.ranks) > 1
    base_scene = base_scene.to(device)
    camera = camera.to(device)

    def step(params: dict, target, seed: int):
        with span("train_step"):
            with span("step.params"):
                base = base_scene
                if {"emission_power", "emission_color"} & set(params["scene"]):
                    base = dataclasses.replace(base, emissive=None)
                scene = apply_params(base, params["scene"])
                cam = dataclasses.replace(camera, **params["camera"])
                optimizer.zero_grad(set_to_none=True)
            with span("step.forward"):
                images = render_tiles_sharded(scene, cam, width, height, seed, mesh, spp,
                                              config, cubemap)
            with span("step.loss"):
                sse = {t: torch.sum((img - target[t * local_h:(t + 1) * local_h]
                                     .to(img.device)) ** 2).to(device)
                       for t, img in images.items()}
                objective = sum(sse.values()) / denom
                loss = sum((sse[t].detach() for t in owned),
                           torch.zeros((), device=device)) / denom
            with span("step.backward"):
                objective.backward()
            if across:
                with span("step.reduce"):
                    _reduce_over_processes(loss, optimizer)
            with span("step.optimizer"):
                optimizer.step()
        return loss

    return step


def _checkpoint_fields(scene_fields, camera_fields) -> list:
    """The field list a checkpoint of fit stores, as the JAX package stores
    it: scene fields, then camera fields prefixed "cam:"."""
    return list(scene_fields) + ["cam:" + f for f in camera_fields]


def fit(base_scene: Scene, camera: Camera, target, scene_fields=("p0",),
        camera_fields=(), steps: int = 100, lr: float = 2e-2,
        width: int | None = None, height: int | None = None, spp: int = 4,
        config: RenderConfig = DEFAULT_CONFIG,
        cubemap: CubemapData | None = None, seed: int = 0, callback=None,
        device=None, mesh: Mesh | None = None, checkpoint_dir: str | None = None,
        checkpoint_every: int = 50):
    """Adam loop recovering `scene_fields` (and `camera_fields`) from the
    (H, W, 3) image `target` over `mesh` (None: one device). Returns (scene,
    camera, losses) with the recovered leaves put in and `losses` a list of
    floats.

    Step i renders with step_seed(seed, i). The losses stay on the device
    and are read when a checkpoint is written and at the end, so the loop
    does not wait for the device step by step, unless `callback(i, loss,
    params)` is given: it gets the loss as a float.

    With checkpoint_dir set, the state (the leaves, Adam's state, the step,
    the losses and the field list) is saved every `checkpoint_every` steps
    and after the last one, by the coordinating process (diff/checkpoint.py);
    a later call resumes from the latest checkpoint there, at step_seed(seed,
    step), so on the CPU a resumed run equals an uninterrupted one bit for
    bit. A checkpoint written for other fields raises. device=None means the
    card, or the device of this process's first cell of `mesh`."""
    if device is None and mesh is not None:
        device = mesh.local_cells()[0][2].device
    device = resolve_device(device)
    target = _image(target, device)
    height = height or target.shape[0]
    width = width or target.shape[1]

    dead = {"yaw", "pitch"} & set(camera_fields)
    if dead:
        # rendering reads only pos/front/up; yaw and pitch are the viewer's
        # control state and would get gradients that are identically zero
        raise ValueError(
            f"camera_fields {sorted(dead)} get zero gradients - optimize "
            "'pos'/'front' instead (yaw/pitch only feed the viewer's rotate())"
        )
    unknown = [f for f in camera_fields if f not in CAMERA_PARAM_FIELDS]
    if unknown:
        raise ValueError(
            f"not optimizable camera fields: {unknown}; expected among {CAMERA_PARAM_FIELDS}"
        )

    base_scene = base_scene.to(device)
    camera = camera.to(device)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    params = {
        "scene": {f: leaf(v) for f, v in extract_params(base_scene, scene_fields).items()},
        "camera": {f: leaf(getattr(camera, f)) for f in camera_fields},
    }
    leaves = [*params["scene"].values(), *params["camera"].values()]
    if not leaves:
        raise ValueError("nothing to optimize: scene_fields and camera_fields are empty")
    optimizer = torch.optim.Adam(leaves, lr=lr)
    fields = _checkpoint_fields(scene_fields, camera_fields)
    start, losses = 0, []
    if checkpoint_dir is not None:
        state = restore_checkpoint(checkpoint_dir)
        if state is not None:
            saved = list(state.get("fields", []))
            if saved and saved != fields:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir} was written for fields "
                    f"{saved}, not {fields} - leaves would be silently "
                    "mis-assigned; use a fresh checkpoint_dir"
                )
            with torch.no_grad():
                for x, v in zip(leaves, state["param_leaves"], strict=True):
                    x.copy_(v)
            optimizer.load_state_dict(state["opt_state"])
            start = int(state["step"])
            losses = [float(x) for x in state["losses"]]

    step = make_train_step(base_scene, camera, optimizer, width, height, spp=spp,
                           config=config, cubemap=cubemap, device=device, mesh=mesh)

    pending = []

    def drain():
        if pending:
            losses.extend(torch.stack(pending).tolist())
            pending.clear()

    for i in range(start, steps):
        loss = step(params, target, step_seed(seed, i))
        pending.append(loss)
        if callback is not None:
            drain()
            callback(i, losses[-1], params)
        if checkpoint_dir is not None and ((i + 1) % checkpoint_every == 0 or i + 1 == steps):
            drain()
            if is_coordinator():
                save_checkpoint(checkpoint_dir, {
                    "param_leaves": [x.detach() for x in leaves],
                    "opt_state": optimizer.state_dict(),
                    "step": i + 1,
                    "losses": list(losses),
                    "fields": fields,
                }, i + 1)
    drain()

    scene = apply_params(base_scene, {f: v.detach() for f, v in params["scene"].items()})
    cam = dataclasses.replace(camera, **{f: v.detach() for f, v in params["camera"].items()})
    return scene, cam, losses


def _fibonacci_directions(n: int) -> np.ndarray:
    """n roughly-uniform unit vectors (golden-spiral sphere covering)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
        axis=1,
    ).astype(np.float32)


def scene_bounds(scene: Scene) -> tuple[np.ndarray, float]:
    """(centre, half diagonal) of the scene's bounding box, from the packed
    rows (1.0 for a degenerate box)."""
    rows = scene.packed_rows().detach().cpu().numpy()
    is_sph = np.asarray(scene.obj_type) == OBJ_SPHERE
    p0, p1 = rows[:, 0:3], rows[:, 3:6]
    lo = np.where(is_sph[:, None], p0 - p1[:, :1], p0)
    hi = np.where(is_sph[:, None], p0 + p1[:, :1], p0 + p1)
    center = (lo.min(0) + hi.max(0)) / 2.0
    return center, float(np.linalg.norm(hi.max(0) - lo.min(0)) / 2.0) or 1.0


def _yaw_pitch_perturb(front, dyaw, dpitch):
    f = front / (np.linalg.norm(front) + 1e-9)
    yaw = np.arctan2(f[2], f[0]) + np.radians(dyaw)
    pitch = np.clip(
        np.arcsin(np.clip(f[1], -1.0, 1.0)) + np.radians(dpitch),
        -np.pi / 2 + 1e-3,
        np.pi / 2 - 1e-3,
    )
    return np.array(
        [np.cos(pitch) * np.cos(yaw), np.sin(pitch), np.cos(pitch) * np.sin(yaw)],
        np.float32,
    )


def pose_candidates(base_scene: Scene, base_pos, n_pos: int = 24, radii=(0.9, 1.6),
                    look_jitter=((0.0, 0.0), (18.0, 0.0), (-18.0, 0.0), (0.0, 14.0),
                                 (0.0, -14.0))) -> tuple[np.ndarray, np.ndarray]:
    """(positions, fronts), (K, 3) float32 each: `base_pos`, then n_pos
    golden-spiral positions on each sphere of radius r x the bounding box's
    half diagonal around its centre, every one looking at the centre with
    each (yaw, pitch) perturbation of `look_jitter` (degrees)."""
    center, half_diag = scene_bounds(base_scene)
    positions = [np.asarray(base_pos, np.float32)]
    for r in radii:
        positions.extend(center + _fibonacci_directions(n_pos) * (r * half_diag))
    poss, fronts = [], []
    for p in np.stack(positions).astype(np.float32):
        for dyaw, dpitch in look_jitter:
            poss.append(p)
            fronts.append(_yaw_pitch_perturb(center - p, dyaw, dpitch))
    return np.stack(poss), np.stack(fronts)


def coarse_pose_search(base_scene: Scene, target, *, base_camera: Camera | None = None,
                       n_pos: int = 24, radii=(0.9, 1.6),
                       look_jitter=((0.0, 0.0), (18.0, 0.0), (-18.0, 0.0), (0.0, 14.0),
                                    (0.0, -14.0)),
                       width: int = 32, height: int = 24, spp: int = 2, aa: int = 2,
                       config: RenderConfig = DEFAULT_CONFIG,
                       cubemap: CubemapData | None = None, seed: int = 7, top_k: int = 3,
                       device=None):
    """Global camera-pose initialisation by brute-force low-res scoring.

    A gradient pose fit stalls when its start is outside the loss basin
    (the silhouette gradient is local). This stage renders every candidate
    of pose_candidates at `aa` x the (width, height) thumbnail, mean-pools
    it down (the target arrives area-downsampled, the renderer point-samples
    pixel centres; on a high-frequency sky that aliasing can outweigh the
    geometry) and ranks by MSE against area_downsample(target). The ranking
    feeds a refinement tournament: the contract is that the true basin is
    among the top_k, not that it is first.

    Forward only (torch.no_grad): one render_image_cuda per candidate (K1
    on the card), every candidate with the same seed. Returns (cands,
    scores): `top_k` (pos, front) numpy pairs best first, and their MSEs.
    device=None means the card."""
    device = resolve_device(device)
    cam0 = (base_camera if base_camera is not None else Camera.default(device)).to(device)
    base_scene = base_scene.to(device)
    poss, fronts = pose_candidates(base_scene, cam0.pos.detach().cpu().numpy(), n_pos, radii,
                                   look_jitter)
    # raises when the target is smaller than the thumbnail: an empty mean
    # would score every candidate NaN
    t_small = area_downsample(_image(target, device), height, width)
    scores = []
    with torch.no_grad():
        for pos, front in zip(poss, fronts):
            cam = dataclasses.replace(cam0, pos=torch.from_numpy(pos).to(device),
                                      front=torch.from_numpy(front).to(device))
            img = render_image_cuda(base_scene, cam, width * aa, height * aa, seed, spp=spp,
                                    config=config, cubemap=cubemap, device=device)
            scores.append(torch.mean((area_downsample(img, height, width) - t_small) ** 2))
    scores = torch.stack(scores).cpu().numpy()
    order = np.argsort(scores)[:top_k]
    return [(poss[i], fronts[i]) for i in order], [float(scores[i]) for i in order]


def fit_multiscale(base_scene: Scene, camera: Camera, target, scene_fields=("p0",),
                   camera_fields=(), schedule=((4, 60), (2, 60), (1, 80)), lr: float = 2e-2,
                   spp: int = 4, config: RenderConfig = DEFAULT_CONFIG,
                   cubemap: CubemapData | None = None, seed: int = 0, callback=None,
                   device=None, mesh: Mesh | None = None):
    """Coarse-to-fine inverse rendering: each (downscale, steps) stage fits
    against area_downsample(target) at (H // down, W // down), the height
    rounded down to the tile axis. Low resolutions blur silhouettes across
    pixels and widen the basin for geometry; later stages refine. Stage k
    runs fit with the seed step_seed(seed, k) (the JAX package folds its key
    with the stage). Returns (scene, camera, the stages' losses in order)."""
    if device is None and mesh is not None:
        device = mesh.local_cells()[0][2].device
    device = resolve_device(device)
    target = _image(target, device)
    H, W = target.shape[0], target.shape[1]
    n_tiles = 1 if mesh is None else mesh.shape[TILE_AXIS]
    scene, cam = base_scene, camera
    all_losses: list[float] = []
    for stage, (down, steps) in enumerate(schedule):
        h, w = H // down, W // down
        h -= h % n_tiles  # keep rows divisible over the tile axis
        if h <= 0 or w <= 0:
            continue
        scene, cam, losses = fit(
            scene, cam, area_downsample(target, h, w), scene_fields=scene_fields,
            camera_fields=camera_fields, steps=steps, lr=lr, width=w, height=h, spp=spp,
            config=config, cubemap=cubemap, seed=step_seed(seed, stage), callback=callback,
            device=device, mesh=mesh)
        all_losses += losses
    return scene, cam, all_losses
