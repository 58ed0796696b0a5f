"""Inverse rendering: recover scene and camera parameters from a target
image by gradient descent through the renderer.

Counterpart of ``ray_tracing_tpu/diff/inverse.py``, on one device. The train
step renders through ``render_image_cuda``, so on the card the forward of
every sample is the recording CUDA kernel and ``loss.backward()`` runs the
backward CUDA kernel. The JAX package's device mesh, its ``psum``s and its
``sky_cache_mode`` have no counterpart yet (they come with the multi-device
and sky-cache modules), nor have ``checkpoint_dir``, ``fit_multiscale`` and
``coarse_pose_search``.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.kernels.megakernel import _wrap_i32, render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import CubemapData
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.types import Scene

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


def make_train_step(base_scene: Scene, camera: Camera,
                    optimizer: torch.optim.Optimizer, width: int, height: int,
                    spp: int = 4, config: RenderConfig = DEFAULT_CONFIG,
                    cubemap: CubemapData | None = None, device=None):
    """Build the train step of one device.

    Returns step(params, target, seed) -> loss, a 0-dim tensor on the
    device. `params` is {"scene": {field: leaf}, "camera": {field: leaf}}
    of tensors that require grad and that `optimizer` (any
    torch.optim.Optimizer, Adam where the JAX package takes optax's) was
    built over; the step renders the scene with those leaves put in,
    takes loss = sum((img - target)^2) / (W * H * 3), back-propagates and
    updates the leaves in place. It does not synchronise with the device.

    When emission_power or emission_color are trained, the static
    `emissive` metadata is dropped here, so that the shadow trace takes the
    full scan and next-event emission gradients reach every row (the
    occlusion-only trace would send them to the build-time light alone).

    device=None means the card. The JAX package's `mesh` argument, its
    psums over the mesh and `sky_cache_mode` wait for the multi-device and
    sky-cache modules."""
    device = resolve_device(device)
    if spp < 1:
        raise ValueError(f"spp {spp} must be positive")
    denom = float(width * height * 3)
    base_scene = base_scene.to(device)
    camera = camera.to(device)
    if cubemap is not None:
        cubemap = cubemap.to(device)

    def step(params: dict, target, seed: int):
        base = base_scene
        if {"emission_power", "emission_color"} & set(params["scene"]):
            base = dataclasses.replace(base, emissive=None)
        scene = apply_params(base, params["scene"])
        cam = dataclasses.replace(camera, **params["camera"])
        optimizer.zero_grad(set_to_none=True)
        img = render_image_cuda(scene, cam, width, height, seed, spp=spp,
                                config=config, cubemap=cubemap, device=device)
        loss = torch.sum((img - target) ** 2) / denom
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit(base_scene: Scene, camera: Camera, target, scene_fields=("p0",),
        camera_fields=(), steps: int = 100, lr: float = 2e-2,
        width: int | None = None, height: int | None = None, spp: int = 4,
        config: RenderConfig = DEFAULT_CONFIG,
        cubemap: CubemapData | None = None, seed: int = 0, callback=None,
        device=None):
    """Adam loop recovering `scene_fields` (and `camera_fields`) from the
    (H, W, 3) image `target`. Returns (scene, camera, losses) with the
    recovered leaves put in and `losses` a list of floats.

    Step i renders with step_seed(seed, i). The losses stay on the device
    and are read once at the end, so the loop does not wait for the device
    step by step, unless `callback(i, loss, params)` is given: it gets the
    loss as a float. device=None means the card. `checkpoint_dir`,
    `fit_multiscale` and `coarse_pose_search` of the JAX package are not
    ported yet."""
    device = resolve_device(device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
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
    step = make_train_step(base_scene, camera, optimizer, width, height, spp=spp,
                           config=config, cubemap=cubemap, device=device)

    pending = []
    for i in range(steps):
        loss = step(params, target, step_seed(seed, i))
        pending.append(loss)
        if callback is not None:
            callback(i, float(loss), params)
    losses = torch.stack(pending).tolist() if pending else []

    scene = apply_params(base_scene, {f: v.detach() for f, v in params["scene"].items()})
    cam = dataclasses.replace(camera, **{f: v.detach() for f, v in params["camera"].items()})
    return scene, cam, losses
