"""Closest-hit ray tracing in plain PyTorch (forward only).

Counterpart of ``ray_tracing_tpu/ops/intersect.py`` and the plain version of
what the CUDA kernel does per thread. A running-min loop over the scene's
objects: each object's intersection test is a set of elementwise passes over
all rays, and the winner's attributes are carried through ``where`` selects.
One loop serves every scene size (the JAX package's split into an unrolled
loop and a scan is a device of its compiler and has no counterpart here).

Semantics, faithful to the reference renderer:
  * sphere: quadratic solve, strict discr > 0, nearest non-negative root
  * cube: slab method with the exact axis-tracking sequence that picks the
    face normal, IEEE inf on axis-parallel rays
  * closest hit: strictly-less-than scan, so the first of equal t wins
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_tpu_torch.ops.vec import Vec3

BIG = 3.4e38           # stand-in for FLT_MAX
HIT_THRESHOLD = 1e37   # anything below this is a real hit


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest hit per ray with the winner's material."""

    t: torch.Tensor       # distance along the unit direction; BIG on miss
    hit: torch.Tensor     # bool
    obj: torch.Tensor     # int32 winner index; -1 on miss
    point: Vec3           # hit point (the ray origin on a miss)
    normal: Vec3          # unit normal (zero on a miss)
    albedo: Vec3
    roughness: torch.Tensor
    reflectance: torch.Tensor
    metallic: torch.Tensor
    emission: Vec3        # emission_color * emission_power


def ray_inverses(d: Vec3) -> Vec3:
    """Per-ray slab reciprocals 1/d, taken once per trace. A zero component
    gives a signed infinity, which the slab test relies on."""
    return Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)


def intersect_sphere(ro: Vec3, d: Vec3, a, center: Vec3, radius, inv2a=None):
    """t for one sphere against all rays; BIG where there is no hit.
    `a = d.dot(d)` and `inv2a = 0.5/a` are per-ray and passed in."""
    oc = center - ro
    b = -2.0 * oc.dot(d)
    c = oc.norm2() - radius * radius
    discr = b * b - 4.0 * a * c
    valid = discr > 0
    sq = torch.sqrt(torch.where(valid, discr, 0.0))
    if inv2a is None:
        inv2a = 0.5 / a
    s0 = (-b - sq) * inv2a
    s1 = (-b + sq) * inv2a
    t = torch.where(s0 < 0, s1, s0)  # nearest non-negative root
    valid = valid & (t >= 0)
    return torch.where(valid, t, BIG)


def intersect_cube(ro: Vec3, d: Vec3, lo: Vec3, hi: Vec3, inv: Vec3 | None = None):
    """(t, normal) for one axis-aligned box against all rays; t = BIG where
    there is no hit.

    Slab method with the reference's axis bookkeeping: start from the x
    slab; y then z replace the hit axis only when they strictly tighten
    tnear. The normal faces against the ray's component on the hit axis.
    tnear < 0 (origin inside) is a miss.

    The running near/far updates are comparisons and selects, not
    maximum/minimum: `if (b > a) a = b` keeps the incumbent when the
    challenger is NaN (0 * inf: origin exactly on a face plane with a zero
    direction component), whereas maximum would propagate the NaN and turn
    a hit into a miss.
    """
    if inv is None:
        inv = ray_inverses(d)
    t_a = (lo - ro) * inv
    t_b = (hi - ro) * inv
    pos = Vec3(d.x >= 0, d.y >= 0, d.z >= 0)
    tmin = Vec3.where_c(pos, t_a, t_b)
    tmax = Vec3.where_c(pos, t_b, t_a)

    miss = (tmin.x > tmax.y) | (tmin.y > tmax.x)
    y_tightens = tmin.y > tmin.x
    near = torch.where(y_tightens, tmin.y, tmin.x)
    far = torch.where(tmax.y < tmax.x, tmax.y, tmax.x)

    miss = miss | (near > tmax.z) | (tmin.z > far)
    z_tightens = tmin.z > near
    near = torch.where(z_tightens, tmin.z, near)

    sx = torch.where(d.x > 0, -1.0, 1.0)
    sy = torch.where(d.y > 0, -1.0, 1.0)
    sz = torch.where(d.z > 0, -1.0, 1.0)
    zero = torch.zeros_like(sx)
    on_x = ~z_tightens & ~y_tightens
    on_y = ~z_tightens & y_tightens
    normal = Vec3(
        torch.where(on_x, sx, zero),
        torch.where(on_y, sy, zero),
        torch.where(z_tightens, sz, zero),
    )

    valid = (~miss) & (near >= 0)
    return torch.where(valid, near, BIG), normal


def _finish_hit(hit, t, is_sph, center: Vec3, cube_n: Vec3, ro: Vec3, d: Vec3):
    """(point, normal) of a resolved closest hit. `center` is the winning
    sphere's center; it is read on sphere lanes only."""
    t_pt = torch.where(hit, t, 0.0)  # keeps the point finite on a miss
    point = ro + d * t_pt
    sphere_n = (point - center).normalize()
    normal = Vec3.where(is_sph, sphere_n, cube_n)
    return point, normal


def _ray_setup(ro: Vec3, rd: Vec3):
    d = rd.normalize()
    a = d.dot(d)  # recomputed from the normalised vector: not exactly 1
    shape = torch.broadcast_shapes(ro.shape, d.shape)
    return d, a, shape, 0.5 / a, ray_inverses(d)


def _intersect(scene, i: int, ro: Vec3, d: Vec3, a, inv2a, inv: Vec3):
    """(t, cube normal or None) of object i against all rays."""
    if scene.is_sphere(i):
        return intersect_sphere(ro, d, a, scene.center(i), scene.radius(i), inv2a), None
    return intersect_cube(ro, d, scene.box_lo(i), scene.box_hi(i), inv)


def trace(scene, ro: Vec3, rd: Vec3) -> Hit:
    """Closest hit with the winner's material, batched over ro/rd's shape.
    `Hit.obj` is the winner index the index-recording kernel stores."""
    d, a, shape, inv2a, inv = _ray_setup(ro, rd)
    dev = d.x.device

    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    zero3 = Vec3(zeros, zeros, zeros)
    t_best = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    obj_best = torch.full(shape, -1, dtype=torch.int32, device=dev)
    sphere_win = torch.zeros(shape, dtype=torch.bool, device=dev)
    center_best = zero3
    cube_n_best = zero3
    albedo_best = zero3
    rough_best = zeros
    refl_best = zeros
    metal_best = zeros
    emiss_best = zero3

    for i in range(scene.num_objects):
        t_i, n_i = _intersect(scene, i, ro, d, a, inv2a, inv)
        win = t_i < t_best  # strict: the first of equal t wins
        t_best = torch.where(win, t_i, t_best)
        obj_best = torch.where(win, i, obj_best)
        if n_i is None:
            sphere_win = win | sphere_win
            center_best = Vec3.where(win, scene.center(i), center_best)
        else:
            sphere_win = sphere_win & ~win
            cube_n_best = Vec3.where(win, n_i, cube_n_best)
        albedo_best = Vec3.where(win, scene.albedo_of(i), albedo_best)
        rough_best = torch.where(win, scene.roughness_of(i), rough_best)
        refl_best = torch.where(win, scene.reflectance_of(i), refl_best)
        metal_best = torch.where(win, scene.metallic_of(i), metal_best)
        emiss_best = Vec3.where(win, scene.emission_of(i), emiss_best)

    hit = t_best < HIT_THRESHOLD
    point, normal = _finish_hit(hit, t_best, sphere_win, center_best, cube_n_best, ro, d)
    return Hit(
        t=t_best, hit=hit, obj=obj_best, point=point, normal=normal,
        albedo=albedo_best, roughness=rough_best, reflectance=refl_best,
        metallic=metal_best, emission=emiss_best,
    )


def _occlude_sphere_masks(ro: Vec3, d: Vec3, a, center: Vec3, radius, at_ref):
    """Does this sphere block a shadow ray before t_ref? (strict,
    non-strict) boolean masks from one algebraic setup, with no sqrt and no
    divide.

    With k = oc.dot(d) and c = |oc|^2 - r^2, the quarter discriminant
    D = k^2 - a*c replaces discr/4; "the nearest root lies behind the
    origin" reduces to k < 0 or c < 0; "the far root is not behind" to
    k >= 0 or c <= 0; and the chosen root's comparison with t_ref squares
    the sqrt away. `at_ref = a * t_ref` is per ray."""
    oc = center - ro
    k = oc.dot(d)
    c = oc.norm2() - radius * radius
    D = k * k - a * c
    valid = D > 0
    w = k - at_ref
    w2 = w * w
    inside = (k < 0) | (c < 0)
    s1_fwd = (k >= 0) | (c <= 0)
    strict = valid & (
        (inside & (w < 0) & (D < w2) & s1_fwd) | (~inside & ((w < 0) | (D > w2)))
    )
    nonstrict = valid & (
        (inside & (w <= 0) & (D <= w2) & s1_fwd) | (~inside & ((w <= 0) | (D >= w2)))
    )
    return strict, nonstrict


def occlude_sphere(ro: Vec3, d: Vec3, a, center: Vec3, radius, at_ref, strict: bool):
    """One strictness variant of _occlude_sphere_masks."""
    s, ns = _occlude_sphere_masks(ro, d, a, center, radius, at_ref)
    return s if strict else ns


def _single_emissive_index(scene) -> int | None:
    """Index of the sole build-time emissive object, or None when the
    scene's emissive metadata is absent or names several lights."""
    emissive = getattr(scene, "emissive", None)
    if emissive is None or sum(bool(e) for e in emissive) != 1:
        return None
    return next(i for i, e in enumerate(emissive) if e)


def _trace_shadow_occlusion(scene, ro: Vec3, rd: Vec3, li: int):
    """Shadow trace for single-light scenes: intersect the light once, then
    OR together per-occluder "blocks it earlier" booleans instead of running
    the closest-hit scan. Equal in value to the scan when object `li` is the
    only emitter: the scan's result is the winner's emission, which is zero
    unless the light wins, i.e. unless some occluder j beats it under the
    first-of-equal-t rule (strictly earlier for j > li, ties included for
    j < li). Returns (hit, emission, winner index: li or -1)."""
    d, a, shape, inv2a, inv = _ray_setup(ro, rd)
    t_e, _ = _intersect(scene, li, ro, d, a, inv2a, inv)
    at_ref = a * t_e
    occluded = torch.zeros(shape, dtype=torch.bool, device=d.x.device)
    for j in range(scene.num_objects):
        if j == li:
            continue
        strict = j > li
        if scene.is_sphere(j):
            occ_j = occlude_sphere(
                ro, d, a, scene.center(j), scene.radius(j), at_ref, strict
            )
        else:
            t_j, _ = intersect_cube(ro, d, scene.box_lo(j), scene.box_hi(j), inv)
            occ_j = (t_j < t_e) if strict else (t_j <= t_e)
        occluded = occluded | occ_j

    hit = (t_e < HIT_THRESHOLD) & ~occluded
    zeros = torch.zeros(shape, dtype=torch.float32, device=d.x.device)
    emiss = Vec3.where(hit, scene.emission_of(li), Vec3(zeros, zeros, zeros))
    obj = torch.where(hit, li, -1).to(torch.int32)
    return hit, emiss, obj


def _trace_shadow_unrolled(scene, ro: Vec3, rd: Vec3):
    """Full shadow scan: the emission of the nearest object, whichever it
    is. Returns (hit, emission, winner index or -1)."""
    d, a, shape, inv2a, inv = _ray_setup(ro, rd)
    dev = d.x.device
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    t_best = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    emiss_best = Vec3(zeros, zeros, zeros)
    obj_best = torch.full(shape, -1, dtype=torch.int32, device=dev)

    for i in range(scene.num_objects):
        t_i, _ = _intersect(scene, i, ro, d, a, inv2a, inv)
        win = t_i < t_best
        t_best = torch.where(win, t_i, t_best)
        obj_best = torch.where(win, i, obj_best)
        emiss_best = Vec3.where(win, scene.emission_of(i), emiss_best)

    hit = t_best < HIT_THRESHOLD
    obj_best = torch.where(hit, obj_best, -1).to(torch.int32)
    return hit, emiss_best, obj_best


def trace_shadow_record(scene, ro: Vec3, rd: Vec3):
    """Light-sampling trace: (hit, emission of the nearest object, winner
    index). Single-light scenes (per the static `emissive` metadata) take
    the occlusion-only trace; several lights or `emissive=None` take the
    full scan."""
    li = _single_emissive_index(scene)
    if li is not None:
        return _trace_shadow_occlusion(scene, ro, rd, li)
    return _trace_shadow_unrolled(scene, ro, rd)


def trace_shadow(scene, ro: Vec3, rd: Vec3):
    """(hit, emission of the nearest object) for light-sampling rays."""
    hit, emiss, _ = trace_shadow_record(scene, ro, rd)
    return hit, emiss
