"""Shared helpers of the tests that hold the PyTorch port
(ray_tracing_tpu_torch) against the JAX package (ray_tracing_tpu): the same
numpy inputs go into both, the outputs come back as numpy arrays."""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from ray_tracing_tpu.ops.vec import Vec3 as JVec3
from ray_tracing_tpu.scene.types import ObjectSpec as JObjectSpec, Scene as JScene

from ray_tracing_tpu_torch import compat
from ray_tracing_tpu_torch.ops.vec import Vec3 as TVec3
from ray_tracing_tpu_torch.scene.types import Scene as TScene

SCENE_LEAVES = (
    "p0", "p1", "albedo", "roughness", "reflectance", "metallic",
    "emission_power", "emission_color",
)


def jvec(a):
    """(3, ...) numpy -> JAX Vec3."""
    return JVec3(*(jnp.asarray(a[k]) for k in range(3)))


def tvec(a):
    """(3, ...) numpy -> torch Vec3 on the CPU."""
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[k])) for k in range(3)))


def vec_np(v):
    """Vec3 of either package -> (3, ...) numpy."""
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)])


def to_jax_specs(specs):
    """Port ObjectSpecs -> JAX-package ObjectSpecs."""
    return [JObjectSpec(**dataclasses.asdict(o)) for o in specs]


def scene_pair(specs):
    """(JAX Scene, port Scene) of the same ObjectSpecs."""
    return JScene.from_objects(to_jax_specs(specs)), TScene.from_objects(specs, device="cpu")


def scene_to_torch(jscene, emissive="same"):
    """JAX Scene -> port Scene through numpy arrays (compat)."""
    leaves = {name: np.asarray(getattr(jscene, name)) for name in SCENE_LEAVES}
    em = jscene.emissive if emissive == "same" else emissive
    return compat.scene_from_numpy(leaves, jscene.obj_type, jscene.light_index, em,
                                   device="cpu")


def camera_to_torch(jcam):
    return compat.camera_from_numpy(
        np.asarray(jcam.pos), np.asarray(jcam.front), np.asarray(jcam.up),
        np.asarray(jcam.yaw), np.asarray(jcam.pitch), device="cpu",
    )


class FixedDraws:
    """The same seeded draws for both packages: `.jax` and `.torch` are draw
    providers with the shadow(b)/direction(b)/branch(b) contract."""

    def __init__(self, seed, bounces, ns, shape):
        r = np.random.default_rng(seed)

        def unit(s):
            a = r.uniform(-1, 1, (3, *s)).astype(np.float32)
            n = np.sqrt((a * a).sum(0, keepdims=True))
            return (a / n).astype(np.float32)

        self.shadow_np = [unit((ns, *shape)) for _ in range(bounces)]
        self.dir_np = [unit(shape) for _ in range(bounces)]
        self.branch_np = [r.uniform(0, 1, shape).astype(np.float32) for _ in range(bounces)]
        self.jax = _Provider(self, jvec, jnp.asarray)
        self.torch = _Provider(self, tvec, torch.from_numpy)


class _Provider:
    def __init__(self, src, vec, arr):
        self._src, self._vec, self._arr = src, vec, arr

    def shadow(self, b):
        return self._vec(self._src.shadow_np[b])

    def direction(self, b):
        return self._vec(self._src.dir_np[b])

    def branch(self, b):
        return self._arr(self._src.branch_np[b])

