"""ops/ of the PyTorch port, elementwise against the JAX functions on the
same numpy inputs: random rays plus axis-parallel rays, origins on a face
plane and exact 45-degree ties. Integer and boolean outputs must be equal;
floats agree to rtol=1e-5, atol=1e-6 (the same float32 formulas, another
libm and another compiler's operation order)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tracing_tpu.ops import cubemap as jcm
from ray_tracing_tpu.ops import intersect as jint
from ray_tracing_tpu.ops import vec as jvecmod
from ray_tracing_tpu.scene.types import Scene as JScene
import dataclasses

from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.ops import intersect as tint
from ray_tracing_tpu_torch.ops import vec as tvecmod
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, random_objects
from ray_tracing_tpu_torch.scene.parser import parse_objects

import torch_port_util as U

RTOL, ATOL = 1e-5, 1e-6


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def _rays(seed=0, n=4096):
    """(ro, rd) as (3, n) float32: random rays toward the scene, then
    axis-parallel rays, origins on face planes with zero components, and
    exact 45-degree directions."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-9, 9, (3, n)).astype(np.float32)
    target = r.uniform(-6, 6, (3, n)).astype(np.float32)
    rd = (target - ro) * r.uniform(0.2, 3.0, (1, n)).astype(np.float32)
    special_o, special_d = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            for k in range(40):
                d = np.zeros(3, np.float32)
                d[axis] = sign
                o = r.uniform(-6, 6, 3).astype(np.float32)
                o[axis] = -8.0 * sign
                if k % 4 == 0:  # origin exactly on a unit-cube face plane
                    o[(axis + 1) % 3] = 1.0
                if k % 4 == 1:
                    o[(axis + 2) % 3] = 0.0
                special_o.append(o)
                special_d.append(d)
    for dx, dy, dz in [(1, 1, 0), (1, -1, 0), (-1, 1, 0), (0, 1, 1), (1, 0, 1),
                       (1, 1, 1), (-1, -1, -1), (1, 0, -1), (0, -1, 1)]:
        for k in range(10):
            special_d.append(np.array([dx, dy, dz], np.float32))
            special_o.append(-4.0 * np.array([dx, dy, dz], np.float32)
                             + (0 if k == 0 else r.integers(-2, 3, 3)).astype(np.float32)
                             if k else -4.0 * np.array([dx, dy, dz], np.float32))
    ro = np.concatenate([ro, np.array(special_o, np.float32).T], axis=1)
    rd = np.concatenate([rd, np.array(special_d, np.float32).T], axis=1)
    return ro, rd


def test_vec_normalize_reflect_is_zero():
    r = np.random.default_rng(1)
    a = r.normal(size=(3, 2000)).astype(np.float32)
    a[:, :50] *= 1e-6   # below the normalize epsilon: returned unchanged
    a[:, 50:100] *= 1e-4  # around the is_zero threshold
    n = r.normal(size=(3, 2000)).astype(np.float32)
    close(U.vec_np(U.tvec(a).normalize()), U.vec_np(U.jvec(a).normalize()))
    np.testing.assert_array_equal(
        U.vec_np(U.tvec(a).normalize())[:, :50], a[:, :50])
    close(U.vec_np(U.tvec(a).reflect(U.tvec(n))), U.vec_np(U.jvec(a).reflect(U.jvec(n))),
          rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        U.tvec(a).is_zero().numpy(), np.asarray(U.jvec(a).is_zero()))
    close(U.tvec(a).avg(), U.jvec(a).avg())
    close(U.tvec(a).dot(U.tvec(n)), U.jvec(a).dot(U.jvec(n)), atol=1e-5)
    close(U.vec_np(U.tvec(a).cross(U.tvec(n))), U.vec_np(U.jvec(a).cross(U.jvec(n))), atol=1e-5)


def test_fresnel_schlick():
    r = np.random.default_rng(2)
    c = r.uniform(0, 1, 5000).astype(np.float32)
    f0 = r.uniform(0, 1, (3, 5000)).astype(np.float32)
    t = tvecmod.fresnel_schlick(torch.from_numpy(c), U.tvec(f0))
    j = jvecmod.fresnel_schlick(jnp.asarray(c), U.jvec(f0))
    close(U.vec_np(t), U.vec_np(j))


def test_intersect_sphere_and_cube():
    ro, rd = _rays()
    jr, jd = U.jvec(ro), U.jvec(rd).normalize()
    tr, td = U.tvec(ro), U.tvec(rd).normalize()
    close(U.vec_np(td), U.vec_np(jd))
    # use the JAX direction on both sides so that only the intersection
    # formulas are compared
    td = U.tvec(U.vec_np(jd))
    ja, ta = jd.dot(jd), td.dot(td)
    for center, radius in [((0, 0, 0), 1.0), ((-3, 0.5, 2), 2.5), ((1, 1, 0), 0.7)]:
        tj = jint.intersect_sphere(jr, jd, ja, jvecmod.Vec3.of(*center), jnp.float32(radius))
        tt = tint.intersect_sphere(tr, td, ta, tvecmod.Vec3.of(*center),
                                   torch.tensor(radius))
        tj, tt = np.asarray(tj), tt.numpy()
        np.testing.assert_array_equal(tt > 1e37, tj > 1e37)
        close(tt, tj, rtol=1e-4, atol=1e-5)
    for lo, size in [((0, 0, 0), (1, 1, 1)), ((-1, -1, -1), (2, 2, 2)), ((-8, -1.5, -8), (16, 0.5, 16))]:
        hi = tuple(l + s for l, s in zip(lo, size))
        tj, nj = jint.intersect_cube(jr, jd, jvecmod.Vec3.of(*lo), jvecmod.Vec3.of(*hi))
        tt, nt = tint.intersect_cube(tr, td, tvecmod.Vec3.of(*lo), tvecmod.Vec3.of(*hi))
        tj, tt = np.asarray(tj), tt.numpy()
        np.testing.assert_array_equal(tt > 1e37, tj > 1e37)
        close(tt, tj)
        np.testing.assert_array_equal(U.vec_np(nt), U.vec_np(nj))
    assert (tt < 1e37).sum() > 100


def _scenes():
    room = parse_objects(ROOM_TEXT)
    return {
        "room_single_light": (room, "same"),
        "room_emissive_none": (room, None),
        "two_lights": (random_objects(12, seed=3, lights=(4, 7)), "same"),
    }


@pytest.mark.parametrize("name", ["room_single_light", "room_emissive_none", "two_lights"])
def test_trace_and_trace_shadow(name):
    specs, emissive = _scenes()[name]
    js, _ = U.scene_pair(specs)
    if emissive is None:
        js = dataclasses.replace(js, emissive=None)
    ts = U.scene_to_torch(js)
    assert ts.emissive == js.emissive
    ro, rd = _rays(seed=5)
    hj = jint.trace(js, U.jvec(ro), U.jvec(rd))
    ht = tint.trace(ts, U.tvec(ro), U.tvec(rd))
    same = np.asarray(hj.obj) == ht.obj.numpy()
    assert same.mean() >= 0.999, same.mean()  # a tie's last bit may differ
    np.testing.assert_array_equal(np.asarray(hj.hit)[same], ht.hit.numpy()[same])
    hitm = same & np.asarray(hj.hit)
    assert hitm.sum() > 500
    for f in ("t", "roughness", "reflectance", "metallic"):
        close(getattr(ht, f).numpy()[hitm], np.asarray(getattr(hj, f))[hitm], rtol=1e-4, atol=1e-5)
    for f in ("point", "normal", "albedo", "emission"):
        close(U.vec_np(getattr(ht, f))[:, hitm], U.vec_np(getattr(hj, f))[:, hitm],
              rtol=1e-4, atol=2e-5)

    # shadow rays: from the hit points toward the light, jittered
    li = js.light_index
    lo = U.vec_np(js.origin_of(li)).reshape(3, 1)
    pts = U.vec_np(hj.point)
    r = np.random.default_rng(6)
    sd = (lo - pts + 0.5 * r.uniform(-1, 1, pts.shape)).astype(np.float32)
    so = (pts + 1e-3 * sd / np.linalg.norm(sd, axis=0, keepdims=True)).astype(np.float32)
    (hit_j, em_j), rec_j = jint.trace_shadow_record(js, U.jvec(so), U.jvec(sd))
    (hit_t, em_t), rec_t = tint.trace_shadow_record(ts, U.tvec(so), U.tvec(sd))
    obj_t = rec_t.obj
    hit_t2, em_t2 = tint.trace_shadow(ts, U.tvec(so), U.tvec(sd))
    np.testing.assert_array_equal(hit_t.numpy(), hit_t2.numpy())
    agree = np.asarray(rec_j.obj) == obj_t.numpy()
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_array_equal(np.asarray(hit_j)[agree], hit_t.numpy()[agree])
    close(U.vec_np(em_t)[:, agree], U.vec_np(em_j)[:, agree])
    assert (np.asarray(em_j.x) > 0).sum() > 50  # the light is reached


def test_occlude_sphere_masks_match_jax():
    ro, rd = _rays(seed=8)
    jd = U.jvec(rd).normalize()
    td = U.tvec(U.vec_np(jd))
    ja, ta = jd.dot(jd), td.dot(td)
    t_ref = np.random.default_rng(9).uniform(0, 20, ro.shape[1]).astype(np.float32)
    sj, nj = jint._occlude_sphere_masks(
        U.jvec(ro), jd, ja, jvecmod.Vec3.of(0, 0, 0), jnp.float32(1.5), ja * t_ref)
    st, nt = tint._occlude_sphere_masks(
        U.tvec(ro), td, ta, tvecmod.Vec3.of(0, 0, 0), torch.tensor(1.5),
        ta * torch.from_numpy(t_ref))
    assert (np.asarray(sj) == st.numpy()).mean() >= 0.999
    assert (np.asarray(nj) == nt.numpy()).mean() >= 0.999
    assert np.asarray(sj).sum() > 20
    assert tint.occlude_sphere(U.tvec(ro), td, ta, tvecmod.Vec3.of(0, 0, 0),
                               torch.tensor(1.5), ta * torch.from_numpy(t_ref),
                               True).equal(st)


def _directions(seed=0, n=6000):
    r = np.random.default_rng(seed)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    ties = []
    for a in (1.0, -1.0):
        for b in (1.0, -1.0):
            s = np.float32(np.sqrt(0.5))
            ties += [(a * s, b * s, 0.0), (a * s, 0.0, b * s), (0.0, a * s, b * s)]
            ties += [(a * 0.5, b * 0.5, np.float32(np.sqrt(0.5)))]
    ties += [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
             (0.0, 0.0, 0.0), (-0.0, 0.0, 1.0)]
    return np.concatenate([d.astype(np.float32), np.array(ties, np.float32).T], axis=1)


def _seeded_cubemaps(size=16, seed=4):
    r = np.random.default_rng(seed)
    faces8 = r.integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    facesf = r.uniform(0, 2, (6, size, size, 3)).astype(np.float32)
    return [(jcm.CubemapData.from_faces(f), tcm.CubemapData.from_faces(f, device="cpu"))
            for f in (faces8, facesf)]


def test_face_uv_and_texel_index():
    d = _directions()
    fj, uj, vj = jcm.face_uv(U.jvec(d))
    ft, ut, vt = tcm.face_uv(U.tvec(d))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft.dtype == torch.int32
    close(ut, uj)
    close(vt, vj)
    for jc, tc in _seeded_cubemaps():
        ij = np.asarray(jcm.texel_flat_index(jc, U.jvec(d)))
        it = tcm.texel_flat_index(tc, U.tvec(d)).numpy()
        # truncation of a float texel coordinate: a last-bit difference in
        # the division can cross an integer on a handful of lanes
        assert (ij == it).mean() >= 0.999


@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_cubemap(bilinear):
    d = _directions(seed=2)
    for jc, tc in _seeded_cubemaps():
        sj = U.vec_np(jcm.sample_cubemap(jc, U.jvec(d), bilinear=bilinear))
        st = U.vec_np(tcm.sample_cubemap(tc, U.tvec(d), bilinear=bilinear))
        if bilinear:
            ok = np.isclose(st, sj, rtol=1e-4, atol=2e-3).all(axis=0)
        else:
            ok = (st == sj).all(axis=0)
        assert ok.mean() >= 0.999, ok.mean()


def test_packed_cubemap_is_int32_and_round_trips():
    from ray_tracing_tpu_torch import compat

    jc, tc = _seeded_cubemaps()[0]
    assert tc.packed.dtype == torch.int32
    np.testing.assert_array_equal(tc.packed.numpy().astype(np.uint32), np.asarray(jc.packed))
    via = compat.cubemap_from_numpy(jc.h, jc.w, packed=np.asarray(jc.packed),
                                    device="cpu")
    assert via.packed.equal(tc.packed)
    jf, tf = _seeded_cubemaps()[1]
    viaf = compat.cubemap_from_numpy(jf.h, jf.w, r=np.asarray(jf.r), g=np.asarray(jf.g),
                                     b=np.asarray(jf.b), device="cpu")
    assert viaf.r.equal(tf.r) and viaf.b.equal(tf.b)
    with pytest.raises(ValueError):
        compat.cubemap_from_numpy(2, 2, packed=np.full(24, 0x01000000, np.uint32),
                                  device="cpu")


@pytest.mark.parametrize("maker,args", [
    ("constant_sky", ((0.6, 0.7, 0.9),)), ("checker_sky", (32,)), ("gradient_sky", (8,)),
])
def test_procedural_skies_match_jax(maker, args):
    jc = getattr(jcm, maker)(*args)
    tc = getattr(tcm, maker)(*args, device="cpu")
    assert (jc.h, jc.w) == (tc.h, tc.w)
    if jc.packed is not None:
        np.testing.assert_array_equal(tc.packed.numpy().astype(np.uint32), np.asarray(jc.packed))
    else:
        for c in "rgb":
            np.testing.assert_array_equal(getattr(tc, c).numpy(), np.asarray(getattr(jc, c)))
    d = _directions(seed=3, n=500)
    sj = U.vec_np(jcm.sample_cubemap(jc, U.jvec(d)))
    st = U.vec_np(tcm.sample_cubemap(tc, U.tvec(d)))
    assert (st == sj).all(axis=0).mean() >= 0.995


def test_downsample_packed_matches_jax():
    jc, tc = jcm.checker_sky(30), tcm.checker_sky(30, device="cpu")
    jd, td = jcm.downsample_packed(jc, 4), tcm.downsample_packed(tc, 4)
    assert (jd.h, jd.w) == (td.h, td.w) == (8, 8)
    np.testing.assert_array_equal(td.packed.numpy().astype(np.uint32), np.asarray(jd.packed))


def test_rand_dir_from_uniforms_matches_jax():
    from ray_tracing_tpu.kernels.megakernel import _rand_dir_from_uniforms as jrd
    from ray_tracing_tpu_torch.ops.sampling import _rand_dir_from_uniforms as trd

    u = np.random.default_rng(7).uniform(0, 1, (3, 4000)).astype(np.float32)
    for biased in (True, False):
        j = jrd(*(jnp.asarray(u[k]) for k in range(3)), biased)
        t = trd(*(torch.from_numpy(u[k]) for k in range(3)), biased)
        close(U.vec_np(t), U.vec_np(j), atol=1e-6)
