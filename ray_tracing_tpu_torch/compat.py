"""State carried across from the JAX package, as numpy arrays.

A scene, camera or cubemap that lives in ``ray_tracing_tpu`` objects crosses
over as the numpy arrays pulled out of them; nothing here imports that
package. ``packed_rows()`` of a Scene built by ``scene_from_numpy`` equals
the JAX ``Scene.packed_rows()`` of the source bit for bit. Parameters and
cotangents go the same way (``params_from_numpy``, ``cotangents_from_numpy``)
and gradients come back as numpy arrays (``grads_to_numpy``), field by field
or as the packed (N,16) / (16,) pair the kernels work on. As everywhere in
the port, ``device=None`` means the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.cubemap import CubemapData
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.types import Scene

_SCENE_LEAVES = {
    "p0": 2, "p1": 2, "albedo": 2, "emission_color": 2,
    "roughness": 1, "reflectance": 1, "metallic": 1, "emission_power": 1,
}


def _f32(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def scene_from_numpy(leaves: dict, obj_type, light_index: int, emissive=None,
                     device=None) -> Scene:
    """leaves: {"p0","p1","albedo","emission_color": (N,3); "roughness",
    "reflectance","metallic","emission_power": (N,)} numpy arrays."""
    device = resolve_device(device)
    n = len(obj_type)
    if set(leaves) != set(_SCENE_LEAVES):
        raise ValueError(f"expected leaves {sorted(_SCENE_LEAVES)}, got {sorted(leaves)}")
    for name, ndim in _SCENE_LEAVES.items():
        a = np.asarray(leaves[name])
        want = (n, 3) if ndim == 2 else (n,)
        if a.shape != want:
            raise ValueError(f"{name} has shape {a.shape}, expected {want}")
    return Scene(
        obj_type=tuple(int(t) for t in obj_type),
        light_index=int(light_index),
        emissive=None if emissive is None else tuple(bool(e) for e in emissive),
        **{name: _f32(leaves[name], device) for name in _SCENE_LEAVES},
    )


def camera_from_numpy(pos, front, up, yaw, pitch, device=None) -> Camera:
    device = resolve_device(device)
    return Camera(
        pos=_f32(pos, device), front=_f32(front, device), up=_f32(up, device),
        yaw=_f32(yaw, device), pitch=_f32(pitch, device),
    )


def cubemap_from_numpy(h: int, w: int, packed=None, r=None, g=None, b=None,
                       device=None) -> CubemapData:
    """Either `packed` ((6*h*w,) unsigned 0x00RRGGBB texels, stored as int32
    on the device) or the three float planes `r`, `g`, `b`."""
    device = resolve_device(device)
    if (packed is None) == (r is None):
        raise ValueError("give either packed or r, g, b")
    if packed is not None:
        p = np.asarray(packed)
        if p.shape != (6 * h * w,):
            raise ValueError(f"packed has shape {p.shape}, expected {(6 * h * w,)}")
        if p.size and int(p.max()) > 0x00FFFFFF:
            raise ValueError("packed texels must be 0x00RRGGBB (top byte zero)")
        t = torch.from_numpy(np.ascontiguousarray(p.astype(np.int32))).to(device)
        return CubemapData(t, None, None, None, h, w)
    planes = [_f32(np.asarray(c).reshape(-1), device) for c in (r, g, b)]
    if any(tuple(c.shape) != (6 * h * w,) for c in planes):
        raise ValueError(f"r, g, b must each hold {6 * h * w} texels")
    return CubemapData(None, *planes, h, w)


def params_from_numpy(params: dict, device=None, requires_grad: bool = True) -> dict:
    """A (possibly nested) dict of numpy arrays, e.g. {"scene": {"p0":
    (N,3)}, "camera": {"pos": (3,)}} or {"rows": (N,16), "cam_pack": (16,)},
    as float32 leaf tensors on `device` that require grad."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _f32(node, device).requires_grad_(requires_grad)

    return conv(params)


def cotangents_from_numpy(cotangents, device=None):
    """Ten (H,W) numpy cotangent planes, in the order of
    kernels/megakernel.py::PLANE_NAMES, as one (10,H,W) float32 tensor."""
    device = resolve_device(device)
    planes = [np.asarray(c, np.float32) for c in cotangents]
    if len(planes) != 10 or any(p.shape != planes[0].shape or p.ndim != 2 for p in planes):
        raise ValueError("expected ten (H, W) planes of one shape")
    return _f32(np.stack(planes), device)


def grads_to_numpy(grads) -> dict | np.ndarray:
    """Gradients back as numpy arrays: a tensor, or a (possibly nested)
    dict of tensors or of leaves whose .grad is read. A leaf that no
    gradient reached gives zeros."""
    if isinstance(grads, dict):
        return {k: grads_to_numpy(v) for k, v in grads.items()}
    t = grads
    if t.requires_grad and t.is_leaf:
        t = t.grad if t.grad is not None else torch.zeros_like(t)
    return t.detach().cpu().numpy()
