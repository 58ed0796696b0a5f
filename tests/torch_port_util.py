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



# ---------------------------------------------------------------------------
# A plain model of the CUDA kernels' traversal (csrc/rt_device.cuh): the
# trace table and the loops over it, for the tests of their contract. Not
# used by the package: its plain versions keep the in-order scan of
# ray_tracing_tpu_torch/ops/intersect.py, which the kernels must match.
# ---------------------------------------------------------------------------


def trace_table(rows, obj_type):
    """The trace table of a packed (N,16) scene as the kernels stage it:
    (spheres, boxes), each kind in index order, with the invariants each
    test reads computed once, by the operation the test made per ray:
    (index, centre, radius*radius) per sphere, (index, lo, lo + size) per
    box."""
    from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE

    spheres, boxes = [], []
    for i, kind in enumerate(obj_type):
        r = rows[i]
        lo = TVec3(r[0], r[1], r[2])
        if kind == OBJ_SPHERE:
            spheres.append((i, lo, r[3] * r[3]))
        else:
            boxes.append((i, lo, TVec3(r[0] + r[3], r[1] + r[4], r[2] + r[5])))
    return spheres, boxes


def _table_sphere_t(ro, d, a, inv2a, centre, r2):
    """csrc/rt_device.cuh::sphere_t, the squared radius given."""
    oc = centre - ro
    b = -2.0 * oc.dot(d)
    cq = oc.dot(oc) - r2
    discr = b * b - 4.0 * a * cq
    valid = discr > 0
    sq = torch.sqrt(torch.where(valid, discr, 0.0))
    s0 = (-b - sq) * inv2a
    s1 = (-b + sq) * inv2a
    t = torch.where(s0 < 0, s1, s0)
    return torch.where(valid & (t >= 0), t, 3.4e38)


def _table_sphere_occludes(ro, d, a, centre, r2, at_ref, strict):
    """csrc/rt_device.cuh::sphere_occludes<STRICT>, the squared radius
    given."""
    oc = centre - ro
    k = oc.dot(d)
    c = oc.dot(oc) - r2
    D = k * k - a * c
    w = k - at_ref
    w2 = w * w
    inside = (k < 0) | (c < 0)
    s1_fwd = (k >= 0) | (c <= 0)
    if strict:
        return (D > 0) & ((inside & (w < 0) & (D < w2) & s1_fwd) | (~inside & ((w < 0) | (D > w2))))
    return (D > 0) & ((inside & (w <= 0) & (D <= w2) & s1_fwd) | (~inside & ((w <= 0) | (D >= w2))))


def table_closest(rows, obj_type, ro, rd):
    """(t, winner index) of csrc/rt_device.cuh::closest: the spheres in
    index order with a strict comparison, then the boxes, each of which also
    wins a tie against a winner of higher index."""
    from ray_tracing_tpu_torch.ops import intersect as tint

    d, a, shape, inv2a, inv = tint._ray_setup(ro, rd)
    spheres, boxes = trace_table(rows, obj_type)
    t_best = torch.full(shape, 3.4e38)
    obj = torch.full(shape, -1, dtype=torch.int32)
    for i, centre, r2 in spheres:
        t = _table_sphere_t(ro, d, a, inv2a, centre, r2)
        win = t < t_best
        t_best, obj = torch.where(win, t, t_best), torch.where(win, i, obj)
    for i, lo, hi in boxes:
        t, _ = tint.intersect_cube(ro, d, lo, hi, inv)
        win = (t < t_best) | ((t == t_best) & (i < obj))
        t_best, obj = torch.where(win, t, t_best), torch.where(win, i, obj)
    return t_best, obj


def table_shadow(rows, obj_type, ro, rd, light=None):
    """The winner of csrc/rt_device.cuh::shadow_winner (-1: none). With the
    sole emitter `light`, shadow_occlusion: the light's test, then each
    kind's objects in two ranges split at the light's slot in its kind, the
    objects before it blocking on a tie too, those after it only strictly
    earlier; else shadow_scan (table_closest)."""
    from ray_tracing_tpu_torch.ops import intersect as tint

    if light is None:
        t, obj = table_closest(rows, obj_type, ro, rd)
        return torch.where(t < 1e37, obj, -1)
    d, a, shape, inv2a, inv = tint._ray_setup(ro, rd)
    spheres, boxes = trace_table(rows, obj_type)
    sph_before = sum(i < light for i, _, _ in spheres)
    box_before = sum(i < light for i, _, _ in boxes)
    light_is_sphere = any(i == light for i, _, _ in spheres)
    if light_is_sphere:
        _, centre, r2 = spheres[sph_before]
        t_e = _table_sphere_t(ro, d, a, inv2a, centre, r2)
    else:
        _, lo, hi = boxes[box_before]
        t_e, _ = tint.intersect_cube(ro, d, lo, hi, inv)
    at_ref = a * t_e
    blocked = torch.zeros(shape, dtype=torch.bool)
    for k, (_, centre, r2) in enumerate(spheres):
        if k != sph_before or not light_is_sphere:
            blocked |= _table_sphere_occludes(ro, d, a, centre, r2, at_ref, k >= sph_before)
    for m, (_, lo, hi) in enumerate(boxes):
        if m != box_before or light_is_sphere:
            t, _ = tint.intersect_cube(ro, d, lo, hi, inv)
            blocked |= (t < t_e) if m >= box_before else (t <= t_e)
    return torch.where((t_e < 1e37) & ~blocked, light, -1).to(torch.int32)


def read_constant(header: str, name: str) -> int:
    """The value of `constexpr int NAME = <int>;` in a header of the port's
    csrc/."""
    import pathlib
    import re

    path = (pathlib.Path(__file__).resolve().parent.parent / "ray_tracing_tpu_torch"
            / "kernels" / "csrc" / header)
    return int(re.search(rf"constexpr int {name} = (\d+);", path.read_text()).group(1))
