"""Scene data model over torch tensors (struct-of-arrays, static topology).

Counterpart of ``ray_tracing_tpu/scene/types.py``. One tensor per field with
the object count as leading dimension; the object kinds, the index of the
light used for next-event estimation and the build-time ``emissive`` flags
are plain Python metadata. ``p0``/``p1`` mean (center, (radius,)*3) for a
sphere and (origin, size) for a cube.

``packed_rows()`` gives the (N, 16) float32 table that the CUDA kernel stages
into shared memory:

    cols 0-2 p0 | 3-5 p1 | 6-8 albedo | 9 roughness | 10 reflectance |
    11 metallic | 12-14 emission_color * emission_power | 15 type tag
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.vec import Vec3

OBJ_NONE = 0
OBJ_SPHERE = 1
OBJ_CUBE = 2

SCENE_COLS = 16


def light_origin_from(p0: Vec3, p1: Vec3, is_sphere: bool) -> Vec3:
    """Object 'origin' for light sampling: sphere center, or cube origin +
    size/2. The one formula every tracer's light origin goes through."""
    if is_sphere:
        return p0
    return p0 + p1 * 0.5


# Material and geometry defaults of the reference parser.
DEFAULT_ALBEDO = (0.44, 0.68, 0.84)
DEFAULT_ROUGHNESS = 0.0
DEFAULT_REFLECTANCE = 0.2
DEFAULT_METALLIC = 0.0
DEFAULT_EMISSION_POWER = 0.0
DEFAULT_EMISSION_COLOR = (1.0, 1.0, 1.0)
DEFAULT_SPHERE_CENTER = (0.0, 0.0, 0.0)
DEFAULT_SPHERE_RADIUS = 1.0
DEFAULT_CUBE_ORIGIN = (0.0, 0.0, 0.0)
DEFAULT_CUBE_SIZE = (1.0, 1.0, 1.0)

_LEAVES = (
    "p0", "p1", "albedo", "roughness", "reflectance", "metallic",
    "emission_power", "emission_color",
)


@dataclasses.dataclass
class ObjectSpec:
    """Host-side description of one object, produced by the parser."""

    kind: str  # "sphere" | "cube"
    p0: tuple = DEFAULT_SPHERE_CENTER           # center / origin
    p1: tuple = (DEFAULT_SPHERE_RADIUS,) * 3    # (radius,)*3 / size
    albedo: tuple = DEFAULT_ALBEDO
    roughness: float = DEFAULT_ROUGHNESS
    reflectance: float = DEFAULT_REFLECTANCE
    metallic: float = DEFAULT_METALLIC
    emission_power: float = DEFAULT_EMISSION_POWER
    emission_color: tuple = DEFAULT_EMISSION_COLOR


@dataclasses.dataclass(frozen=True)
class Scene:
    """Struct-of-arrays scene; leading dim of every tensor = num_objects.

    Tensors: p0, p1, albedo, emission_color (N, 3) and roughness,
    reflectance, metallic, emission_power (N,), all float32 on one device.
    Static metadata: obj_type (tuple of OBJ_* ints), light_index (first
    emissive object, -1 if none) and emissive (per-object emission_power > 0
    at build time, or None for unknown). Exactly one emissive object enables
    the occlusion-only shadow trace; ``emissive=None`` forces the full scan.
    """

    obj_type: tuple
    light_index: int
    p0: torch.Tensor
    p1: torch.Tensor
    albedo: torch.Tensor
    roughness: torch.Tensor
    reflectance: torch.Tensor
    metallic: torch.Tensor
    emission_power: torch.Tensor
    emission_color: torch.Tensor
    emissive: tuple | None = None

    @property
    def num_objects(self) -> int:
        return len(self.obj_type)

    @property
    def has_light(self) -> bool:
        return self.light_index >= 0

    @property
    def device(self) -> torch.device:
        return self.p0.device

    def to(self, device) -> "Scene":
        """The same scene with every tensor on `device` (self when it is
        there already)."""
        device = torch.device(device)
        if self.p0.device == device:
            return self
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device) for name in _LEAVES}
        )

    def is_sphere(self, i: int) -> bool:
        return self.obj_type[i] == OBJ_SPHERE

    def radius(self, i: int):
        return self.p1[i, 0]

    def center(self, i: int) -> Vec3:
        return Vec3(self.p0[i, 0], self.p0[i, 1], self.p0[i, 2])

    def box_lo(self, i: int) -> Vec3:
        return self.center(i)

    def box_hi(self, i: int) -> Vec3:
        return Vec3(
            self.p0[i, 0] + self.p1[i, 0],
            self.p0[i, 1] + self.p1[i, 1],
            self.p0[i, 2] + self.p1[i, 2],
        )

    def size_of(self, i: int) -> Vec3:
        """p1 of object i: (radius,)*3 of a sphere, the size of a box."""
        return Vec3(self.p1[i, 0], self.p1[i, 1], self.p1[i, 2])

    def albedo_of(self, i: int) -> Vec3:
        return Vec3(self.albedo[i, 0], self.albedo[i, 1], self.albedo[i, 2])

    def roughness_of(self, i: int):
        return self.roughness[i]

    def reflectance_of(self, i: int):
        return self.reflectance[i]

    def metallic_of(self, i: int):
        return self.metallic[i]

    def emission_of(self, i: int) -> Vec3:
        """emission_color * emission_power of object i."""
        p = self.emission_power[i]
        return Vec3(
            self.emission_color[i, 0] * p,
            self.emission_color[i, 1] * p,
            self.emission_color[i, 2] * p,
        )

    def origin_of(self, i: int) -> Vec3:
        """Object 'origin' for light sampling (light_origin_from)."""
        return light_origin_from(self.center(i), self.size_of(i), self.is_sphere(i))

    def packed_rows(self) -> torch.Tensor:
        """(N, 16) float32 parameter rows; the layout is in the module
        docstring."""
        emission = self.emission_color * self.emission_power[:, None]
        tag = torch.tensor(
            self.obj_type, dtype=torch.float32, device=self.p0.device
        ).reshape(-1, 1)
        return torch.cat(
            [
                self.p0,
                self.p1,
                self.albedo,
                self.roughness[:, None],
                self.reflectance[:, None],
                self.metallic[:, None],
                emission,
                tag,
            ],
            dim=1,
        ).to(torch.float32).contiguous()

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_objects(objects: list[ObjectSpec], device=None) -> "Scene":
        """Pack host-side ObjectSpecs into the tensors. The light is the
        FIRST object with emission_power > 0, frozen here. device=None
        means the card."""
        device = resolve_device(device)
        n = len(objects)
        obj_type = tuple(
            OBJ_SPHERE if o.kind == "sphere" else OBJ_CUBE for o in objects
        )
        light_index = -1
        for i, o in enumerate(objects):
            if o.emission_power > 0:
                light_index = i
                break

        def field(fn, shape):
            out = np.zeros((n, *shape), np.float32)
            for i, o in enumerate(objects):
                out[i] = fn(o)
            return torch.from_numpy(out).to(device)

        return Scene(
            obj_type=obj_type,
            light_index=light_index,
            emissive=tuple(o.emission_power > 0 for o in objects),
            p0=field(lambda o: o.p0, (3,)),
            p1=field(lambda o: o.p1, (3,)),
            albedo=field(lambda o: o.albedo, (3,)),
            roughness=field(lambda o: o.roughness, ()),
            reflectance=field(lambda o: o.reflectance, ()),
            metallic=field(lambda o: o.metallic, ()),
            emission_power=field(lambda o: o.emission_power, ()),
            emission_color=field(lambda o: o.emission_color, (3,)),
        )

    def to_objects(self) -> list[ObjectSpec]:
        """Inverse of from_objects, on the host."""
        host = {name: getattr(self, name).cpu().numpy() for name in _LEAVES}
        out = []
        for i in range(self.num_objects):
            out.append(
                ObjectSpec(
                    kind="sphere" if self.obj_type[i] == OBJ_SPHERE else "cube",
                    p0=tuple(host["p0"][i].tolist()),
                    p1=tuple(host["p1"][i].tolist()),
                    albedo=tuple(host["albedo"][i].tolist()),
                    roughness=float(host["roughness"][i]),
                    reflectance=float(host["reflectance"][i]),
                    metallic=float(host["metallic"][i]),
                    emission_power=float(host["emission_power"][i]),
                    emission_color=tuple(host["emission_color"][i].tolist()),
                )
            )
        return out

