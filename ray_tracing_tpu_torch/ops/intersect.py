"""Closest-hit ray tracing in plain PyTorch, and its differentiable replay.

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

Every function here is safe to differentiate: which object wins, which root
or face is taken and every other comparison are detached decisions, and no
lane produces an infinite partial that could meet a zero cotangent
(``ray_inverses``). The backward passes' stand-ins for ``trace`` and
``trace_shadow`` rebuild a hit with no loop over the objects:
``trace_replay_fetch`` / ``trace_shadow_replay_fetch`` from a recorded winner
index and the packed scene table (the "fetch" backward), ``trace_replay`` /
``trace_shadow_replay`` from the winner's parameter planes that
``trace_record`` / ``trace_shadow_record`` recorded (the "replay" backward).
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE

BIG = 3.4e38           # stand-in for FLT_MAX
HIT_THRESHOLD = 1e37   # anything below this is a real hit

# Largest scene the "direct" backward differentiates through the whole
# trace; above it that mode runs the "replay" backward (the JAX package's
# _run_bwd rule; its unrolled trace loop ends here too).
UNROLL_LIMIT = 48


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest hit per ray with the winner's material."""

    t: torch.Tensor       # distance along the unit direction; BIG on miss
    hit: torch.Tensor     # bool
    obj: torch.Tensor     # winner index (int32 traced, int64 replayed); -1 on miss
    point: Vec3           # hit point (the ray origin on a miss)
    normal: Vec3          # unit normal (zero on a miss)
    albedo: Vec3
    roughness: torch.Tensor
    reflectance: torch.Tensor
    metallic: torch.Tensor
    emission: Vec3        # emission_color * emission_power


@dataclasses.dataclass(frozen=True)
class RayInverses:
    """Per-ray slab reciprocals, taken once per trace: `zero` marks the
    components of d that are exactly 0, `safe` is 1/d with those lanes
    replaced by 1 before the division (so it has a finite derivative
    everywhere), `raw` is the detached 1/d with its signed infinities."""

    zero: Vec3
    safe: Vec3
    raw: Vec3


def ray_inverses(d: Vec3) -> RayInverses:
    def one(den):
        zero = den == 0.0
        safe = 1.0 / torch.where(zero, torch.ones_like(den), den)
        return zero, safe, (1.0 / den).detach()

    (zx, sx, rx), (zy, sy, ry), (zz, sz, rz) = one(d.x), one(d.y), one(d.z)
    return RayInverses(Vec3(zx, zy, zz), Vec3(sx, sy, sz), Vec3(rx, ry, rz))


def _slab_t(num, zero, safe, raw):
    """num * (1/den) on every lane, the value the slab test relies on
    (signed infinity on a parallel ray, NaN for 0 * inf). On the parallel
    lanes the product is detached: its partials are infinite, and under
    autograd they would meet the zero cotangent of a slab that the select
    chain did not take (0 * inf = NaN) and poison every gradient."""
    return torch.where(zero, num.detach() * raw, num * safe)


def _slab_t3(num: Vec3, inv: RayInverses) -> Vec3:
    return Vec3(
        _slab_t(num.x, inv.zero.x, inv.safe.x, inv.raw.x),
        _slab_t(num.y, inv.zero.y, inv.safe.y, inv.raw.y),
        _slab_t(num.z, inv.zero.z, inv.safe.z, inv.raw.z),
    )


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


def intersect_cube(ro: Vec3, d: Vec3, lo: Vec3, hi: Vec3,
                   inv: RayInverses | None = None):
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
    t_a = _slab_t3(lo - ro, inv)
    t_b = _slab_t3(hi - ro, inv)
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


def _intersect(scene, i: int, ro: Vec3, d: Vec3, a, inv2a, inv: RayInverses):
    """(t, cube normal or None) of object i against all rays."""
    if scene.is_sphere(i):
        return intersect_sphere(ro, d, a, scene.center(i), scene.radius(i), inv2a), None
    return intersect_cube(ro, d, scene.box_lo(i), scene.box_hi(i), inv)


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """The winner of one closest-hit call, per ray: enough to rebuild the Hit
    differentiably (trace_replay) and to route its gradients back to the
    winner's row. Masks are float 0/1, as in the JAX package."""

    obj: torch.Tensor          # int32 winner index; -1 on miss
    hit: torch.Tensor          # float32 0/1
    is_sph: torch.Tensor       # float32 0/1
    p0: Vec3                   # winner row cols 0-2 (center / box origin)
    p1: Vec3                   # winner row cols 3-5 (radius x3 / box size)
    albedo: Vec3
    roughness: torch.Tensor
    reflectance: torch.Tensor
    metallic: torch.Tensor
    emission: Vec3


def trace(scene, ro: Vec3, rd: Vec3) -> Hit:
    """Closest hit with the winner's material, batched over ro/rd's shape.
    `Hit.obj` is the winner index the index-recording kernel stores."""
    return _trace(scene, ro, rd, record=False)


def _trace(scene, ro: Vec3, rd: Vec3, record: bool):
    """The object loop of trace() and trace_record(): with `record` it also
    keeps the winner's parameter planes and returns (Hit, TraceRecord)."""
    d, a, shape, inv2a, inv = _ray_setup(ro, rd)
    dev = d.x.device

    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    zero3 = Vec3(zeros, zeros, zeros)
    t_best = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    obj_best = torch.full(shape, -1, dtype=torch.int32, device=dev)
    sphere_win = torch.zeros(shape, dtype=torch.bool, device=dev)
    center_best = zero3
    p1_best = zero3
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
            if record:
                # the record's p0 is the row origin for both kinds; the Hit
                # reads center_best on sphere lanes only
                center_best = Vec3.where(win, scene.box_lo(i), center_best)
        if record:
            p1_best = Vec3.where(win, _p1_of(scene, i), p1_best)
        albedo_best = Vec3.where(win, scene.albedo_of(i), albedo_best)
        rough_best = torch.where(win, scene.roughness_of(i), rough_best)
        refl_best = torch.where(win, scene.reflectance_of(i), refl_best)
        metal_best = torch.where(win, scene.metallic_of(i), metal_best)
        emiss_best = Vec3.where(win, scene.emission_of(i), emiss_best)

    hit = t_best < HIT_THRESHOLD
    point, normal = _finish_hit(hit, t_best, sphere_win, center_best, cube_n_best, ro, d)
    h = Hit(
        t=t_best, hit=hit, obj=obj_best, point=point, normal=normal,
        albedo=albedo_best, roughness=rough_best, reflectance=refl_best,
        metallic=metal_best, emission=emiss_best,
    )
    if not record:
        return h
    rec = TraceRecord(
        obj=obj_best, hit=hit.to(torch.float32), is_sph=sphere_win.to(torch.float32),
        p0=center_best.broadcast_to(shape), p1=p1_best.broadcast_to(shape),
        albedo=albedo_best.broadcast_to(shape), roughness=rough_best.broadcast_to(shape),
        reflectance=refl_best.broadcast_to(shape), metallic=metal_best.broadcast_to(shape),
        emission=emiss_best.broadcast_to(shape),
    )
    return h, rec


def _p1_of(scene, i: int) -> Vec3:
    """Row cols 3-5 of object i as the record keeps them: (r, r, r) for a
    sphere, the box's size for a cube. The JAX package's unrolled recorder
    keeps hi - lo for a box, which can differ from the size in its last bit;
    the size itself (what its scan recorder keeps, and what the CUDA kernel
    reads) lets trace_replay rebuild hi = lo + size exactly as trace() did."""
    if scene.is_sphere(i):
        r = scene.radius(i)
        return Vec3(r, r, r)
    return scene.size_of(i)


def trace_record(scene, ro: Vec3, rd: Vec3):
    """(Hit, TraceRecord): trace() that also keeps the winner's parameter
    planes, for the "replay" backward."""
    return _trace(scene, ro, rd, record=True)


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


@dataclasses.dataclass(frozen=True)
class ShadowRecord:
    """The winner of one shadow trace: the occlusion bit (detached) and the
    nearest object's emission, the only shadow quantity a gradient flows
    through."""

    obj: torch.Tensor   # int32 winner index; -1 on miss
    hit: torch.Tensor   # float32 0/1
    emission: Vec3


def trace_shadow_record(scene, ro: Vec3, rd: Vec3):
    """Light-sampling trace: ((hit, emission of the nearest object),
    ShadowRecord). Single-light scenes (per the static `emissive` metadata)
    take the occlusion-only trace, whose winner is that light or -1; several
    lights or `emissive=None` take the full scan."""
    li = _single_emissive_index(scene)
    if li is not None:
        hit, emiss, obj = _trace_shadow_occlusion(scene, ro, rd, li)
    else:
        hit, emiss, obj = _trace_shadow_unrolled(scene, ro, rd)
    return (hit, emiss), ShadowRecord(obj=obj, hit=hit.to(torch.float32), emission=emiss)


def trace_shadow(scene, ro: Vec3, rd: Vec3):
    """(hit, emission of the nearest object) for light-sampling rays."""
    out, _ = trace_shadow_record(scene, ro, rd)
    return out


# ---------------------------------------------------------------------------
# Replay: a hit rebuilt from recorded winner parameters
# ---------------------------------------------------------------------------


def _replay_hit(obj, hit, is_sph, p0: Vec3, p1: Vec3, albedo: Vec3, roughness,
                reflectance, metallic, emission: Vec3, ro: Vec3, rd: Vec3) -> Hit:
    """A Hit recomputed from its winner's parameters with the very operations
    trace() applies to that winner, so that its values are the forward's
    bit for bit and its derivatives those of autograd through the full
    running-min trace. hit / is_sph are detached booleans."""
    d = rd.normalize()
    a = d.dot(d)
    shape = torch.broadcast_shapes(ro.shape, d.shape)
    ro = ro.broadcast_to(shape)
    t_s = intersect_sphere(ro, d, a, p0, p1.x)
    t_c, n_c = intersect_cube(ro, d, p0, p0 + p1)
    t = torch.where(is_sph, t_s, t_c)
    t = torch.where(hit, t, BIG)  # a miss carries all-zero parameters: mask it
    point, normal = _finish_hit(hit, t, is_sph, p0, n_c, ro, d)
    return Hit(
        t=t, hit=hit, obj=obj, point=point, normal=normal, albedo=albedo,
        roughness=roughness, reflectance=reflectance, metallic=metallic, emission=emission,
    )


def trace_replay(rec: TraceRecord, ro: Vec3, rd: Vec3) -> Hit:
    """Differentiable Hit from a TraceRecord: the "replay" backward's
    stand-in for trace(). The winner CHOICE (obj, hit, is_sph) is detached
    path topology; every continuous quantity is a function of the record's
    parameter planes, ro and rd."""
    return _replay_hit(rec.obj, rec.hit > 0.5, rec.is_sph > 0.5, rec.p0, rec.p1, rec.albedo,
                       rec.roughness, rec.reflectance, rec.metallic, rec.emission, ro, rd)


def trace_shadow_replay(rec: ShadowRecord):
    """Differentiable (hit, emission) from a ShadowRecord: the emission is
    the leaf, the occlusion bit is detached."""
    return rec.hit > 0.5, rec.emission


# ---------------------------------------------------------------------------
# Fetch replay: a hit rebuilt from a recorded winner index and the scene table
# ---------------------------------------------------------------------------


def fetch_winner_rows(rows, obj):
    """rows[obj] per lane, zeros where obj < 0 (a miss): (*obj.shape, C).
    Plain indexing; its autograd scatters each lane's cotangent back onto
    the winner's row of `rows`."""
    hit = obj >= 0
    got = rows[obj.clamp(min=0).to(torch.int64)]
    return torch.where(hit.unsqueeze(-1), got, torch.zeros_like(got))


def trace_replay_fetch(rows, obj, ro: Vec3, rd: Vec3) -> Hit:
    """Differentiable Hit from a recorded winner-index plane `obj` and the
    packed (N,16) scene table: the "fetch" backward's stand-in for trace().

    The winner CHOICE is detached path topology; t, point, normal and the
    material are recomputed from the winner's own row (_replay_hit). Column
    15, the type tag, is read detached."""
    cols = fetch_winner_rows(rows, obj).unbind(-1)
    return _replay_hit(
        obj, obj >= 0, cols[15].detach() == float(OBJ_SPHERE),
        Vec3(cols[0], cols[1], cols[2]), Vec3(cols[3], cols[4], cols[5]),
        Vec3(cols[6], cols[7], cols[8]), cols[9], cols[10], cols[11],
        Vec3(cols[12], cols[13], cols[14]), ro, rd,
    )


def trace_shadow_replay_fetch(rows, obj, light_index: int | None = None):
    """Differentiable (hit, emission) from the recorded shadow winners `obj`
    of shape (ns, *shape): the emission columns of each winner's row, the
    only shadow quantity a gradient flows through (occlusion is detached).

    With `light_index` given (the forward recorded through the single-light
    occlusion trace, so every index is that light or -1) the fetch reads the
    light's row alone."""
    hit = obj >= 0
    if light_index is not None:
        e = rows[light_index, 12:15]
        got = torch.where((obj == light_index).unsqueeze(-1), e, torch.zeros_like(e))
    else:
        got = fetch_winner_rows(rows[:, 12:15], obj)
    ex, ey, ez = got.unbind(-1)
    return hit, Vec3(ex, ey, ez)
