"""State carried across from the JAX package, as numpy arrays.

A scene, camera or cubemap that lives in ``ray_tracing_tpu`` objects crosses
over as the numpy arrays pulled out of them; nothing here imports that
package. ``packed_rows()`` of a Scene built by ``scene_from_numpy`` equals
the JAX ``Scene.packed_rows()`` of the source bit for bit. As everywhere
in the port, ``device=None`` means the card.
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
