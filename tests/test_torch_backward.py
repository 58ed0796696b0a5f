"""The backward half of the PyTorch port on the CPU: gradient-safe
intersections, the fetch replay (ops/intersect.py), the plain version of the
backward kernel (kernels/megakernel.py::replay_vjp / run_bwd_plain) and the
autograd boundary (TilesFunction), against the JAX package on the same numpy
inputs.

The JAX side runs the way its own test does
(tests/test_megakernel.py::test_fetch_replay_grads_match_xla_autodiff):
jax.vjp over tile_physics with a FetchReplayTracer and injected draws, and
jax.grad of the direct tile_physics. Tolerances, the JAX package's own:
scene rows rtol 2e-3 / atol 2e-4, camera pack rtol 2e-2 / atol 5e-2; the
type-tag column must be exactly 0.

A last-bit difference between the two packages can flip a decision (hit or
miss, specular or diffuse) in a pixel, which then follows another path in the
one than in the other. Such pixels are found by comparing the primal planes
and get a zero cotangent on both sides; their number is printed and bounded.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.kernels import megakernel as jmk
from ray_tracing_tpu.ops import intersect as jint
from ray_tracing_tpu.ops.vec import Vec3 as JVec3
from ray_tracing_tpu.render.camera import Camera as JCamera

from ray_tracing_tpu_torch import compat
from ray_tracing_tpu_torch.config import RenderConfig as TCfg
from ray_tracing_tpu_torch.diff.fd import finite_difference_grad
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops import intersect as tint
from ray_tracing_tpu_torch.ops.vec import Vec3 as TVec3
from ray_tracing_tpu_torch.render.camera import Camera as TCamera
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_objects
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import Scene

import torch_port_util as U

ROWS_RTOL, ROWS_ATOL = 2e-3, 2e-4
CAM_RTOL, CAM_ATOL = 2e-2, 5e-2
SHAPE = (16, 128)


def _leaf(v):
    return torch.tensor(v, dtype=torch.float32, requires_grad=True)


# ---------------------------------------------------------------------------
# Degenerate lanes: finite gradients
# ---------------------------------------------------------------------------


def test_axis_parallel_ray_gives_finite_cube_gradients():
    """A ray with a zero direction component against the unit cube: t = 3,
    the z partials are -1, -3, 1 and the x partials are 0, not NaN (an
    infinite partial of the parallel slab meeting a zero cotangent)."""
    ro = [_leaf(v) for v in (0.5, 0.5, -3.0)]
    d = [_leaf(v) for v in (0.0, 0.0, 1.0)]
    lo = [_leaf(0.0) for _ in range(3)]
    hi = [_leaf(1.0) for _ in range(3)]
    t, normal = tint.intersect_cube(TVec3(*ro), TVec3(*d), TVec3(*lo), TVec3(*hi))
    assert float(t.detach()) == 3.0 and float(normal.z) == -1.0
    gx = torch.autograd.grad(t, [ro[0], d[0], lo[0], hi[0]], retain_graph=True)
    assert all(float(g) == 0.0 for g in gx)
    gz = torch.autograd.grad(t, [ro[2], d[2], lo[2]])
    assert [float(g) for g in gz] == [-1.0, -3.0, 1.0]


def test_slab_reciprocals_keep_the_forward_value():
    """num * (1/den) on every lane, infinities and the 0 * inf NaN included."""
    d = TVec3(torch.tensor([0.0, -0.0, 2.0, -3.0]), torch.tensor([1.0, 0.0, 0.0, 1e-30]),
              torch.tensor([0.5, 0.25, 0.0, 0.0]))
    inv = tint.ray_inverses(d)
    num = TVec3(torch.tensor([1.0, 1.0, 0.0, 5.0]), torch.tensor([0.0, 0.0, -2.0, 1.0]),
                torch.tensor([3.0, 3.0, 0.0, -1.0]))
    got = tint._slab_t3(num, inv)
    for g, n, den in zip((got.x, got.y, got.z), (num.x, num.y, num.z), (d.x, d.y, d.z)):
        want = n * (1.0 / den)
        assert torch.equal(torch.isnan(g), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(want, nan=7.0))


def test_normalize_and_sphere_gradients_on_degenerate_lanes():
    # a zero vector passes through normalize: identity adjoint, not NaN
    z = [_leaf(0.0) for _ in range(3)]
    out = TVec3(*z).normalize()
    g = torch.autograd.grad(out.x + 2.0 * out.y + 3.0 * out.z, z)
    assert [float(v) for v in g] == [1.0, 2.0, 3.0]
    # a short vector likewise, a long one is projected
    s = [_leaf(v) for v in (3e-6, 0.0, 4e-6)]
    g = torch.autograd.grad(TVec3(*s).normalize().x, s)
    assert [float(v) for v in g] == [1.0, 0.0, 0.0]
    # a sphere that the ray misses (discr < 0) and one it grazes from behind
    ro = TVec3(*[_leaf(v) for v in (0.0, 5.0, -4.0)])
    d = TVec3(*[_leaf(v) for v in (0.0, 0.0, 1.0)])
    c = [_leaf(0.0) for _ in range(3)]
    r = _leaf(1.0)
    t = tint.intersect_sphere(ro, d, d.dot(d), TVec3(*c), r)
    assert float(t.detach()) > tint.HIT_THRESHOLD
    grads = torch.autograd.grad(t, [ro.x, ro.y, ro.z, d.x, d.y, d.z, *c, r], allow_unused=True)
    assert all(g is None or (torch.isfinite(g) and float(g) == 0.0) for g in grads)


def test_clip_passes_half_the_cotangent_on_a_bound_like_jax():
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    want = jax.grad(lambda a: JVec3(a, a, a).clip(0.0, 1.0).x.sum())(jnp.asarray(x))
    t = torch.from_numpy(x.copy()).requires_grad_()
    out = TVec3(t, t, t).clip(0.0, 1.0).x
    assert out.tolist() == [0.0, 0.0, 0.25, 1.0, 1.0]
    out.sum().backward()
    assert t.grad.tolist() == np.asarray(want).tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


# ---------------------------------------------------------------------------
# trace_replay_fetch / trace_shadow_replay_fetch against the JAX functions
# ---------------------------------------------------------------------------


def _replay_rays():
    """(ro, rd) of shape (3, 4, 64): random rays toward a nine-object room,
    then axis-parallel rays, an exact 45-degree tie, rays from inside a
    cube and rays that miss everything."""
    r = np.random.default_rng(3)
    n = 4 * 64
    ro = r.uniform(-7, 7, (3, n)).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.2
    target = r.uniform(-3, 3, (3, n)).astype(np.float32)
    rd = (target - ro) * r.uniform(0.3, 2.0, (1, n)).astype(np.float32)
    special = [
        ((-2.75, 6.0, -0.25), (0.0, -1.0, 0.0)),   # straight down onto a cube
        ((1.5, 0.25, 6.0), (0.0, 0.0, -1.0)),      # along -z into the tall cube
        ((6.0, -0.25, 2.5), (-1.0, 0.0, 0.0)),     # along -x
        ((4.0, 4.0, 0.0), (-1.0, -1.0, 0.0)),      # 45 degrees at the centre sphere
        ((-3.0, 0.5, -3.0), (1.0, 0.0, 1.0)),      # 45 degrees, tie of two slabs
        ((-2.75, -0.25, -0.25), (1.0, 0.3, 0.2)),  # from inside a cube
        ((1.5, 0.0, -3.0), (0.0, 1.0, 0.0)),       # from inside, axis-parallel
        ((0.0, 20.0, 0.0), (0.0, 1.0, 0.0)),       # misses everything
        ((0.0, 20.0, 0.0), (1.0, 0.0, 0.0)),
    ]
    for k, (o, d) in enumerate(special):
        ro[:, k] = o
        rd[:, k] = d
    return ro.reshape(3, 4, 64), rd.reshape(3, 4, 64)


def _hit_functional_weights(shape, seed=4):
    r = np.random.default_rng(seed)
    return {k: r.uniform(-1, 1, (n, *shape)).astype(np.float32)
            for k, n in (("t", 1), ("point", 3), ("normal", 3), ("albedo", 3),
                         ("scalars", 3), ("emission", 3))}


def _hit_functional(h, w, where, asarray):
    """sum of weights * every continuous field of a Hit."""
    parts = [
        (where(h.hit, h.t, 0.0), w["t"][0]),
        *[(c, w["point"][k]) for k, c in enumerate((h.point.x, h.point.y, h.point.z))],
        *[(c, w["normal"][k]) for k, c in enumerate((h.normal.x, h.normal.y, h.normal.z))],
        *[(c, w["albedo"][k]) for k, c in enumerate((h.albedo.x, h.albedo.y, h.albedo.z))],
        *[(c, w["scalars"][k]) for k, c in enumerate((h.roughness, h.reflectance, h.metallic))],
        *[(c, w["emission"][k]) for k, c in enumerate((h.emission.x, h.emission.y, h.emission.z))],
    ]
    return sum((c * asarray(wk)).sum() for c, wk in parts)


def test_trace_replay_fetch_matches_jax():
    js, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    ro, rd = _replay_rays()
    rows_np = np.asarray(js.packed_rows())
    np.testing.assert_array_equal(ts.packed_rows().numpy(), rows_np)
    obj = tint.trace(ts, U.tvec(ro), U.tvec(rd)).obj
    obj_np = obj.numpy().copy()
    obj_np[0, 8:16] = -1  # rays that hit, replayed as misses
    assert (obj_np >= 0).mean() > 0.5 and (obj_np[0, :9] < 0).sum() >= 2
    w = _hit_functional_weights(obj_np.shape)

    def jf(rows, ro_a, rd_a):
        h = jint.trace_replay_fetch(rows, jnp.asarray(obj_np), JVec3(*ro_a), JVec3(*rd_a))
        return _hit_functional(h, w, jnp.where, jnp.asarray), h

    (_, jh), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(rows_np), jnp.asarray(ro), jnp.asarray(rd))

    rows_t = torch.from_numpy(rows_np.copy()).requires_grad_()
    ro_t = torch.from_numpy(ro.copy()).requires_grad_()
    rd_t = torch.from_numpy(rd.copy()).requires_grad_()
    th = tint.trace_replay_fetch(rows_t, torch.from_numpy(obj_np), TVec3(*ro_t), TVec3(*rd_t))
    loss = _hit_functional(th, w, torch.where, torch.from_numpy)
    loss.backward()

    hit = obj_np >= 0
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_allclose(th.t.detach().numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5)
    for name in ("point", "normal", "albedo", "emission"):
        np.testing.assert_allclose(U.vec_np(_detached(getattr(th, name))),
                                   U.vec_np(getattr(jh, name)), rtol=1e-5, atol=1e-6)
    for name in ("roughness", "reflectance", "metallic"):
        np.testing.assert_allclose(getattr(th, name).detach().numpy(),
                                   np.asarray(getattr(jh, name)), rtol=1e-5, atol=1e-6)
    for got, want in zip((rows_t.grad, ro_t.grad, rd_t.grad), jg):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all() and np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=ROWS_RTOL, atol=ROWS_ATOL)
    # a lane replayed as a miss sends nothing anywhere
    assert np.abs(rd_t.grad.numpy()[:, ~hit]).max() == 0.0
    assert rows_t.grad[:, 15].abs().max() == 0.0


def _detached(v):
    return TVec3(v.x.detach(), v.y.detach(), v.z.detach())


@pytest.mark.parametrize("collapsed", [False, True])
def test_trace_shadow_replay_fetch_matches_jax(collapsed):
    js, _ = U.scene_pair(parse_objects(ROOM_TEXT))
    rows_np = np.asarray(js.packed_rows())
    r = np.random.default_rng(6)
    li = js.light_index
    if collapsed:  # the single-light occlusion trace records {light, -1}
        obj = np.where(r.uniform(size=(2, 4, 64)) < 0.6, li, -1).astype(np.int32)
    else:
        obj = r.integers(-1, js.num_objects, (2, 4, 64)).astype(np.int32)
    w = r.uniform(-1, 1, (3, 2, 4, 64)).astype(np.float32)

    def jf(rows):
        hit, e = jint.trace_shadow_replay_fetch(rows, jnp.asarray(obj),
                                                light_index=li if collapsed else None)
        return (e.x * w[0] + e.y * w[1] + e.z * w[2]).sum(), (hit, e)

    (_, (jhit, je)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(rows_np))
    rows_t = torch.from_numpy(rows_np.copy()).requires_grad_()
    thit, te = tint.trace_shadow_replay_fetch(rows_t, torch.from_numpy(obj),
                                              light_index=li if collapsed else None)
    wt = torch.from_numpy(w)
    (te.x * wt[0] + te.y * wt[1] + te.z * wt[2]).sum().backward()
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(U.vec_np(_detached(te)), U.vec_np(je), rtol=1e-6)
    np.testing.assert_allclose(rows_t.grad.numpy(), np.asarray(jg), rtol=ROWS_RTOL, atol=ROWS_ATOL)
    assert rows_t.grad[:, :12].abs().max() == 0.0


# ---------------------------------------------------------------------------
# The plain version of the backward kernel against jax.vjp and jax.grad
# ---------------------------------------------------------------------------


def _uv():
    xs = np.broadcast_to(np.arange(SHAPE[1], dtype=np.float32), SHAPE)
    ys = np.broadcast_to(np.arange(SHAPE[0], dtype=np.float32)[:, None], SHAPE)
    return (1.0 - xs / (SHAPE[1] - 1)).astype(np.float32), (1.0 - ys / (SHAPE[0] - 1)).astype(np.float32)


def _module_case(n_objects, with_metadata):
    """Both packages' scene, config, camera pack, draws and screen grid."""
    specs = random_objects(n_objects, seed=1, lights=(7,))
    js, ts = U.scene_pair(specs)
    assert js.light_index == 7
    if not with_metadata:
        js = dataclasses.replace(js, emissive=None)
        ts = dataclasses.replace(ts, emissive=None)
    jcfg, tcfg = JCfg(bounces=3, shadow_samples=2), TCfg(bounces=3, shadow_samples=2)
    draws = U.FixedDraws(9, 3, 2, SHAPE)
    u, v = _uv()
    jcam = jmk._camera_pack(JCamera.default(), 2.0, jcfg).reshape(1, 16)
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), SHAPE[1], SHAPE[0], tcfg, aspect=2.0)
    return js, ts, jcfg, draws, u, v, jcam, job


@pytest.mark.parametrize("n_objects", [9, 60])
@pytest.mark.parametrize("with_metadata", [True, False], ids=["one_light_metadata", "emissive_none"])
def test_replay_vjp_matches_jax_fetch_replay_and_direct_autodiff(n_objects, with_metadata):
    js, ts, jcfg, draws, u, v, jcam, job = _module_case(n_objects, with_metadata)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    rows0 = jmk.pack_scene(js)
    np.testing.assert_array_equal(job.rows.numpy(), np.asarray(rows0))

    # the JAX forward with its index recorder: the records both sides replay
    recorder = jmk.IndexRecordingTracer(js)
    jdirect = jmk.tile_physics(js, jcam[0], ju, jv, draws.jax, jcfg, SHAPE, tracer=recorder)
    records = np.concatenate([np.asarray(o).reshape(-1, *SHAPE) for o in recorder.objs])
    if with_metadata:  # occlusion trace: the shadow planes hold the light or -1
        assert set(np.unique(records[1:3])) <= {-1, 7}

    # the port's direct forward: pixels where a decision flipped get no cotangent
    ut, vt = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tdirect = tmk.tile_physics(view, job.cam_pack, ut, vt, draws.torch, job.config, SHAPE)
    same = np.ones(SHAPE, bool)
    for a, b in zip(tdirect, jdirect):
        same &= np.abs(a.numpy() - np.asarray(b)) <= 2e-4 + 2e-3 * np.abs(np.asarray(b))
    flipped = int((~same).sum())
    print(f"{n_objects} objects: {flipped} of {same.size} pixels flipped a decision")
    assert flipped <= 4
    cot = np.random.default_rng(5).uniform(-1, 1, (10, *SHAPE)).astype(np.float32) * same

    def f(rows, cam_arr):
        tracer = jmk.FetchReplayTracer(list(recorder.objs), rows, js.obj_type, js.light_index,
                                       emissive=js.emissive)
        return jmk.tile_physics(None, cam_arr[0], ju, jv, draws.jax, jcfg, SHAPE, tracer=tracer)

    _, vjpf = jax.vjp(f, rows0, jcam)
    jg_rows, jg_cam = vjpf(tuple(jnp.asarray(c) for c in cot))

    def loss_direct(rows, cam_arr):
        s = dataclasses.replace(
            js, p0=rows[:, 0:3], p1=rows[:, 3:6], albedo=rows[:, 6:9], roughness=rows[:, 9],
            reflectance=rows[:, 10], metallic=rows[:, 11], emission_color=rows[:, 12:15],
            emission_power=jnp.ones(n_objects, jnp.float32))
        outs = jmk.tile_physics(s, cam_arr[0], ju, jv, draws.jax, jcfg, SHAPE)
        return sum(jnp.vdot(o, jnp.asarray(c)) for o, c in zip(outs, cot))

    jd_rows, jd_cam = jax.grad(loss_direct, argnums=(0, 1))(rows0, jcam)

    # the port: the function run_bwd_plain wraps, on the same records at the
    # width the port keeps them
    narrow = torch.from_numpy(records).to(tmk.record_dtype(n_objects))
    planes, g_rows, g_cam = tmk.replay_vjp(job, ut, vt, draws.torch, narrow,
                                           compat.cotangents_from_numpy(cot, device="cpu"))
    got_rows, got_cam = compat.grads_to_numpy(g_rows), compat.grads_to_numpy(g_cam)
    assert np.isfinite(got_rows).all() and np.isfinite(got_cam).all()
    assert np.abs(got_rows[:, 15]).max() == 0.0
    np.testing.assert_allclose(got_rows[:, :15], np.asarray(jg_rows)[:, :15],
                               rtol=ROWS_RTOL, atol=ROWS_ATOL)
    np.testing.assert_allclose(got_cam, np.asarray(jg_cam).reshape(16), rtol=CAM_RTOL, atol=CAM_ATOL)
    # Against jax.grad of the DIRECT estimator, which says that the replay's
    # detachments are the right ones. Above 48 objects the JAX direct trace
    # is a scan whose gradients drift from the JAX package's own fetch
    # replay (grazing spheres; beyond this tolerance for most draws), so the
    # port is allowed the JAX package's own gap on top: it is zero to
    # rounding at 9 objects, where this is the plain tolerance.
    for got, fetch, direct, rtol, atol in (
        (got_rows[:, :15], np.asarray(jg_rows)[:, :15], np.asarray(jd_rows)[:, :15], ROWS_RTOL, ROWS_ATOL),
        (got_cam, np.asarray(jg_cam).reshape(16), np.asarray(jd_cam).reshape(16), CAM_RTOL, CAM_ATOL),
    ):
        own_gap = np.abs(fetch - direct)
        if n_objects <= 48:
            assert (own_gap <= atol + rtol * np.abs(direct)).all()
        assert (np.abs(got - direct) <= atol + rtol * np.abs(direct) + own_gap).all()
    # what the hand-written adjoint relies on, shown by jax.grad itself:
    # reflectance feeds only the specular/diffuse comparison, and the light's
    # position gets nothing through the detached shadow rays that another
    # object's hits would not give it (column 10 is zero everywhere)
    assert np.abs(np.asarray(jd_rows)[:, 10]).max() == 0.0 and np.abs(got_rows[:, 10]).max() == 0.0
    if with_metadata:  # emission gradients reach the one light only
        dark = [i for i in range(n_objects) if i != 7]
        assert np.abs(got_rows[dark, 12:15]).max() <= np.abs(np.asarray(jg_rows)[dark, 12:15]).max() + 1e-6


@pytest.mark.parametrize("n_objects", [9, 60])
def test_replay_primal_equals_direct_tile_physics_bit_for_bit(n_objects):
    _, ts, _, draws, u, v, _, job = _module_case(n_objects, True)
    ut, vt = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    recorder = tmk.IndexRecordingTracer(view)
    direct = tmk.tile_physics(view, job.cam_pack, ut, vt, draws.torch, job.config, SHAPE,
                              tracer=recorder)
    records = torch.cat([o.reshape(-1, *SHAPE) for o in recorder.objs])
    records = records.to(tmk.record_dtype(n_objects))
    planes, _, _ = tmk.replay_vjp(job, ut, vt, draws.torch, records, torch.ones((10, *SHAPE)))
    for k, (a, b) in enumerate(zip(planes, direct)):
        assert a.equal(b), tmk.PLANE_NAMES[k]


# ---------------------------------------------------------------------------
# TilesFunction on the CPU
# ---------------------------------------------------------------------------


def _room_job(cfg=None, width=40, height=12, **leaves):
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    ts = dataclasses.replace(ts, **leaves)
    return ts, tmk.make_tile_job(ts, TCamera.default("cpu"), width, height,
                                 cfg or TCfg(bounces=3, shadow_samples=2))


def _cotangents(shape, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (10, *shape)).astype(np.float32))


def test_tiles_function_backward_is_run_bwd_plain_and_close_to_direct_autograd():
    _, job = _room_job()
    cot = _cotangents((12, 40))
    rows = job.rows.clone().requires_grad_()
    cam = job.cam_pack.clone().requires_grad_()
    live = dataclasses.replace(job, rows=rows, cam_pack=cam)
    planes, _ = tmk.run_tiles_grad(live, seed=3)
    (planes * cot).sum().backward()
    # exactly the plain backward on the records of the recording forward
    want_planes, records = tmk.run_tiles_plain(job, 3, record=True)
    assert planes.detach().equal(want_planes)
    w_rows, w_cam = tmk.run_bwd_plain(job, 3, 0, records, cot)
    assert rows.grad.equal(w_rows) and cam.grad.equal(w_cam)
    # and autograd straight through the direct estimator, no replay
    rows2 = job.rows.clone().requires_grad_()
    cam2 = job.cam_pack.clone().requires_grad_()
    direct, _ = tmk.run_tiles_plain(dataclasses.replace(job, rows=rows2, cam_pack=cam2), 3)
    (direct * cot).sum().backward()
    np.testing.assert_allclose(rows.grad.numpy(), rows2.grad.numpy(), rtol=ROWS_RTOL, atol=ROWS_ATOL)
    np.testing.assert_allclose(cam.grad.numpy(), cam2.grad.numpy(), rtol=CAM_RTOL, atol=CAM_ATOL)
    assert rows.grad[:, 15].abs().max() == 0 and cam.grad[14:].abs().max() == 0


def test_tiles_function_records_only_under_grad(monkeypatch):
    _, job = _room_job()
    calls = []
    real = tmk.run_tiles
    monkeypatch.setattr(tmk, "run_tiles", lambda j, s, r=0, record=False: (
        calls.append(record), real(j, s, r, record))[1])
    planes, _ = tmk.run_tiles_grad(job, seed=3)
    assert calls == [False] and not planes.requires_grad
    live = dataclasses.replace(job, rows=job.rows.clone().requires_grad_())
    planes, _ = tmk.run_tiles_grad(live, seed=3)
    assert calls == [False, True] and planes.requires_grad


def test_seeds_above_two_to_the_24_stay_distinct():
    _, job = _room_job()
    live = dataclasses.replace(job, rows=job.rows.clone().requires_grad_())
    a, _ = tmk.run_tiles_grad(live, seed=2**24 + 1)
    b, _ = tmk.run_tiles_grad(live, seed=2**24 + 2)
    assert not a.equal(b)
    want, _ = tmk.run_tiles_plain(job, 2**24 + 1)
    assert a.detach().equal(want)


def test_row_slices_add_up_to_the_full_frame():
    ts, job = _room_job(height=12)
    cot = _cotangents((12, 40))
    _, records = tmk.run_tiles_plain(job, 4, record=True)
    full_rows, full_cam = tmk.run_bwd_plain(job, 4, 0, records, cot)
    sum_rows, sum_cam = torch.zeros_like(full_rows), torch.zeros_like(full_cam)
    for row0 in (0, 4, 8):
        part = tmk.make_tile_job(ts, TCamera.default("cpu"), 40, 4, job.config, norm_height=12)
        planes, recs = tmk.run_tiles_plain(part, 4, row0, record=True)
        assert recs.equal(records[:, row0:row0 + 4])
        g_rows, g_cam = tmk.run_bwd_plain(part, 4, row0, recs, cot[:, row0:row0 + 4].contiguous())
        sum_rows += g_rows
        sum_cam += g_cam
    np.testing.assert_allclose(sum_rows.numpy(), full_rows.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum_cam.numpy(), full_cam.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT, "sixty_two_lights"],
                         ids=["scene_2", "room", "sixty_two_lights_full_scan"])
def test_dead_lane_rule_changes_no_gradient(text):
    """The fetch backward never reads the entries dead_lane_rule overwrites:
    from the rule-applied records and from the raw tracer's, run_bwd_plain
    gives the same row and camera gradients bit for bit, and the replay the
    same planes."""
    specs = random_objects(60, seed=1, lights=(7, 20)) if text == "sixty_two_lights" \
        else parse_objects(text)
    _, ts = U.scene_pair(specs)
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 40, 24, TCfg())
    u, v, draws = tmk._sample_inputs(job, 9, 0)
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tracer = tmk.IndexRecordingTracer(view)
    tmk.tile_physics(view, job.cam_pack, u, v, draws, job.config, (24, 40), tracer=tracer)
    raw = torch.cat([o.reshape(-1, 24, 40) for o in tracer.objs])
    raw = raw.to(tmk.record_dtype(len(job.obj_type)))
    planes, ruled = tmk.run_tiles_plain(job, 9, record=True)
    assert ruled.equal(tmk.dead_lane_rule(raw, job.ns))
    if job.ns:
        assert not ruled.equal(raw)
    cot = _cotangents((24, 40))
    got = tmk.replay_vjp(job, u, v, draws, ruled, cot)
    want = tmk.replay_vjp(job, u, v, draws, raw, cot)
    assert got[0].equal(want[0]) and got[0].equal(planes)
    assert got[1].equal(want[1]) and got[2].equal(want[2])
    rows, cam = tmk.run_bwd_plain(job, 9, 0, ruled, cot)
    assert rows.equal(got[1]) and cam.equal(got[2])


@pytest.mark.parametrize("name", ["scene_2", "one_hundred_thirty_objects"])
def test_fetch_backward_is_the_same_from_narrow_and_int32_planes(name):
    """record_dtype stores the very integers: the plain fetch backward from
    the narrow planes (int8 on scene_2, int16 at 130 objects) and from the
    same planes widened to int32 gives the same gradients bit for bit."""
    specs = parse_objects(SCENE_2_TEXT) if name == "scene_2" \
        else random_objects(130, seed=5, lights=(7,))
    _, ts = U.scene_pair(specs)
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 32, 20,
                            TCfg(bounces=3, shadow_samples=2))
    _, narrow = tmk.run_tiles_plain(job, 8, record=True)
    assert narrow.dtype == (torch.int8 if name == "scene_2" else torch.int16)
    cot = _cotangents((20, 32))
    rows, cam = tmk.run_bwd_plain(job, 8, 0, narrow, cot)
    wide_rows, wide_cam = tmk.run_bwd_plain(job, 8, 0, narrow.to(torch.int32), cot)
    assert rows.equal(wide_rows) and cam.equal(wide_cam)
    assert rows.abs().max() > 0


def test_gradient_matches_finite_differences_for_smooth_parameters():
    """albedo, emission_color and emission_power enter the image smoothly
    (no decision depends on them below the clip), so a central difference
    agrees within 5 %."""
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    cam = TCamera.default("cpu")
    cfg = TCfg(bounces=3, shadow_samples=2)
    # weights that keep the loss away from the [0, 1] clip's corners
    wgt = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 1.0, (10, 24, 3)).astype(np.float32))

    def loss_of(params):
        scene = dataclasses.replace(ts, emissive=None, **params)
        img = tmk.render_image_cuda(scene, cam, 24, 10, seed=6, spp=2, config=cfg, device="cpu")
        return (img * wgt).sum()

    params = {
        "albedo": ts.albedo[3:5].clone(),
        "emission_color": ts.emission_color[7:8].clone(),
        "emission_power": ts.emission_power[7:8].clone() * 0.05,
    }

    def full(p):  # put the trained slices back into whole tensors
        albedo = torch.cat([ts.albedo[:3], p["albedo"], ts.albedo[5:]])
        color = torch.cat([ts.emission_color[:7], p["emission_color"], ts.emission_color[8:]])
        power = torch.cat([ts.emission_power[:7], p["emission_power"], ts.emission_power[8:]])
        return {"albedo": albedo, "emission_color": color, "emission_power": power}

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss_of(full(leaves)).backward()
    fd = finite_difference_grad(lambda p: loss_of(full(p)), params, eps=1e-2)
    for name in params:
        got, want = leaves[name].grad.numpy(), fd[name].numpy()
        assert np.abs(want).max() > 1e-3, name
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2 * np.abs(want).max(), err_msg=name)


def test_plain_renderer_differentiates_the_direct_estimator():
    """render_image (the plain twin) under grad goes straight through
    tile_physics; render_image_cuda on the CPU goes through the replay. Same
    image, gradients within the replay's tolerance."""
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    cam = TCamera.default("cpu")
    cfg = TCfg(bounces=3)
    grads = []
    for render in (render_image, tmk.render_image_cuda):
        p0 = ts.p0.clone().requires_grad_()
        img = render(dataclasses.replace(ts, p0=p0), cam, 32, 20, seed=2, spp=2, config=cfg,
                     device="cpu")
        img.sum().backward()
        grads.append((img.detach(), p0.grad))
    assert grads[0][0].equal(grads[1][0])
    np.testing.assert_allclose(grads[1][1].numpy(), grads[0][1].numpy(), rtol=ROWS_RTOL, atol=ROWS_ATOL)


MANY_SAMPLES = 33  # more shadow samples per bounce than a 32-bit mask holds
MANY_SHAPE = (8, 64)


def _many_samples_case(lights):
    """Both packages' scene (12 objects; one light: the occlusion-only
    shadow trace, two: the full scan), 2 bounces of MANY_SAMPLES shadow
    samples, the camera pack, injected draws and the screen grid."""
    js, ts = U.scene_pair(random_objects(12, seed=3, lights=lights))
    if len(lights) > 1:
        js = dataclasses.replace(js, emissive=None)
        ts = dataclasses.replace(ts, emissive=None)
    jcfg = JCfg(bounces=2, shadow_samples=MANY_SAMPLES)
    tcfg = TCfg(bounces=2, shadow_samples=MANY_SAMPLES)
    draws = U.FixedDraws(11, 2, MANY_SAMPLES, MANY_SHAPE)
    h, w = MANY_SHAPE
    xs = np.broadcast_to(np.arange(w, dtype=np.float32), MANY_SHAPE)
    ys = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], MANY_SHAPE)
    u = (1.0 - xs / (w - 1)).astype(np.float32)
    v = (1.0 - ys / (h - 1)).astype(np.float32)
    jcam = jmk._camera_pack(JCamera.default(), w / h, jcfg).reshape(1, 16)
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), w, h, tcfg)
    return js, jcfg, draws, u, v, jcam, job


@pytest.mark.parametrize("lights", [(7,), (2, 5)], ids=["one_emitter", "two_lights_full_scan"])
def test_backward_at_more_shadow_samples_than_a_mask_holds_matches_jax(lights):
    """The port's three backward computations (the plain versions of K3, K4
    and K5) at 33 shadow samples per bounce against jax.vjp of the JAX
    package's fetch replay, which takes any count: the count the backward
    kernels once refused."""
    js, jcfg, draws, u, v, jcam, job = _many_samples_case(lights)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    rows0 = jmk.pack_scene(js)
    recorder = jmk.IndexRecordingTracer(js)
    jdirect = jmk.tile_physics(js, jcam[0], ju, jv, draws.jax, jcfg, MANY_SHAPE, tracer=recorder)
    records = np.concatenate([np.asarray(o).reshape(-1, *MANY_SHAPE) for o in recorder.objs])
    assert (records[1:1 + MANY_SAMPLES] >= 0).sum() > 0  # shadow samples are taken

    ut, vt = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tdirect = tmk.tile_physics(view, job.cam_pack, ut, vt, draws.torch, job.config, MANY_SHAPE)
    same = np.ones(MANY_SHAPE, bool)
    for a, b in zip(tdirect, jdirect):
        same &= np.abs(a.numpy() - np.asarray(b)) <= 2e-4 + 2e-3 * np.abs(np.asarray(b))
    assert (~same).sum() <= 2
    cot = np.random.default_rng(7).uniform(-1, 1, (10, *MANY_SHAPE)).astype(np.float32) * same

    def f(rows, cam_arr):
        tracer = jmk.FetchReplayTracer(list(recorder.objs), rows, js.obj_type, js.light_index,
                                       emissive=js.emissive)
        return jmk.tile_physics(None, cam_arr[0], ju, jv, draws.jax, jcfg, MANY_SHAPE,
                                tracer=tracer)

    _, vjpf = jax.vjp(f, rows0, jcam)
    jg_rows, jg_cam = (np.asarray(g) for g in vjpf(tuple(jnp.asarray(c) for c in cot)))
    tcot = compat.cotangents_from_numpy(cot, device="cpu")
    port = {
        "fetch": tmk.replay_vjp(job, ut, vt, draws.torch,
                                torch.from_numpy(records).to(tmk.record_dtype(js.num_objects)),
                                tcot),
        "replay": tmk.record_replay_vjp(job, ut, vt, draws.torch, tcot),
        "direct": tmk.direct_vjp(job, ut, vt, draws.torch, tcot),
    }
    for mode, (_, g_rows, g_cam, *_) in port.items():
        got_rows, got_cam = compat.grads_to_numpy(g_rows), compat.grads_to_numpy(g_cam)
        assert np.isfinite(got_rows).all() and np.abs(got_rows[:, 15]).max() == 0.0, mode
        np.testing.assert_allclose(got_rows[:, :15], jg_rows[:, :15], rtol=ROWS_RTOL,
                                   atol=ROWS_ATOL, err_msg=mode)
        np.testing.assert_allclose(got_cam, jg_cam.reshape(16), rtol=CAM_RTOL, atol=CAM_ATOL,
                                   err_msg=mode)
    # the samples past the mask carry emission gradient to the lights
    assert np.abs(jg_rows[list(lights), 12:15]).max() > 0


def test_backward_launch_takes_more_shadow_samples_than_a_mask_holds(monkeypatch):
    """The wrapper hands a job of 33 shadow samples per bounce on to the
    kernel's library (here there is none: the stand-in raises as soon as
    it is asked for the kernel), for each backward kernel."""
    _, job = _room_job(TCfg(bounces=2, shadow_samples=MANY_SAMPLES))
    asked = []

    class ReachedTheLibrary(Exception):
        pass

    def kernel_function(kernel):
        asked.append(kernel)
        raise ReachedTheLibrary

    monkeypatch.setattr(tmk, "_bwd_kernel_function", kernel_function)
    recs = torch.zeros((tmk.record_layout(job.config, True), 12, 40),
                       dtype=tmk.record_dtype(len(job.obj_type)))
    for kernel in tmk.BWD_KERNELS:
        with pytest.raises(ReachedTheLibrary):
            tmk._launch_bwd(kernel, job, 1, 0, recs if kernel == "fetch" else None,
                            torch.zeros((10, 12, 40)))
    assert asked == list(tmk.BWD_KERNELS)


# ---------------------------------------------------------------------------
# The backward kernels' warp reduction by key, as a plain model
# ---------------------------------------------------------------------------


def _warp_reduce_by_key(keys, vals):
    """Plain model of csrc/rt_backward.cuh::reduce_by_key over one warp of
    32 lanes: peers from __match_any_sync, every round one shuffle from the
    next lane of the group above (all lanes read before any adds), then the
    lanes at odd rank drop out. Returns (which lanes are their group's
    lowest, the values after the call, the number of rounds)."""
    lanes = np.arange(32, dtype=np.uint64)
    keys = np.asarray(keys)
    vals = np.array(vals, dtype=np.float32)
    full = np.uint64(0xFFFFFFFF)
    peers = np.array([sum(1 << j for j in range(32) if keys[j] == keys[i]) for i in range(32)],
                     dtype=np.uint64)
    below = (np.uint64(1) << lanes) - np.uint64(1)
    popc = np.vectorize(lambda x: bin(int(x)).count("1"))
    lowest = (peers & below) == 0
    rank = popc(peers & below).astype(np.uint64)
    peers &= ~((np.uint64(2) << lanes) - np.uint64(1)) & full
    rounds = 0
    while (peers != 0).any():
        nxt = np.array([(int(p) & -int(p)).bit_length() for p in peers])  # __ffs
        pulled = vals[(nxt - 1) & 31]
        vals = np.where((nxt != 0)[:, None], vals + pulled, vals)
        ballot = sum(1 << i for i in range(32) if rank[i] & np.uint64(1))
        peers &= ~np.uint64(ballot) & full
        rank >>= np.uint64(1)
        rounds += 1
    return lowest, vals, rounds


@pytest.mark.parametrize("keys", ["one_key", "all_distinct", "random_few", "random_with_misses"])
def test_warp_reduction_by_key_sums_every_group_once(keys):
    """Each distinct key's lowest lane ends with its group's sums, in
    ceil(log2(largest group)) rounds: what lets the kernel add once per key
    and warp instead of once per lane."""
    rng = np.random.default_rng(len(keys))
    k = {"one_key": np.full(32, 4), "all_distinct": rng.permutation(32),
         "random_few": rng.integers(0, 4, 32),
         "random_with_misses": rng.integers(-1, 9, 32)}[keys]
    v = rng.integers(-50, 50, (32, 15)).astype(np.float32)  # integers: exact sums
    lowest, out, rounds = _warp_reduce_by_key(k, v)
    groups = {int(key): np.flatnonzero(k == key) for key in np.unique(k)}
    assert int(lowest.sum()) == len(groups)
    for key, members in groups.items():
        assert lowest[members[0]] and not lowest[members[1:]].any()
        np.testing.assert_array_equal(out[members[0]], v[members].sum(axis=0))
    largest = max(len(m) for m in groups.values())
    assert rounds == int(np.ceil(np.log2(largest)))


# ---------------------------------------------------------------------------
# On the card (skipped where there is none)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_cuda_backward_kernel_matches_plain_version(text, cuda_device):
    _, ts = U.scene_pair(parse_objects(text))
    job = tmk.make_tile_job(ts.to(cuda_device), TCamera.default(cuda_device), 256, 144, TCfg())
    _, records = tmk.run_tiles(job, seed=11, record=True)
    cot = _cotangents((144, 256)).to(cuda_device)
    before = tmk.launch_counts["megakernel_bwd_fetch"]
    g_rows, g_cam = tmk.run_bwd(job, 11, 0, records, cot)
    torch.cuda.synchronize()
    assert tmk.launch_counts["megakernel_bwd_fetch"] == before + 1
    w_rows, w_cam = tmk.run_bwd_plain(job, 11, 0, records, cot)
    scale = w_rows.abs().amax(dim=0, keepdim=True)
    assert ((g_rows - w_rows).abs() <= ROWS_RTOL * w_rows.abs() + ROWS_ATOL * scale).all()
    assert ((g_cam - w_cam).abs() <= CAM_RTOL * w_cam.abs() + 5e-4 * w_cam.abs().max()).all()
    assert g_rows[:, 15].abs().max() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("lights", [(7,), (2, 5)], ids=["one_emitter", "two_lights_full_scan"])
@pytest.mark.parametrize("kernel", ["fetch", "replay", "direct"])
def test_cuda_backward_kernels_take_more_shadow_samples_than_a_mask_holds(kernel, lights,
                                                                         cuda_device):
    """K3, K4 and K5 at 33 shadow samples per bounce against their plain
    versions on the card: the samples past the 32-bit masks are drawn and
    tested again where the routing needs them."""
    scene = Scene.from_objects(random_objects(12, seed=3, lights=lights), device=cuda_device)
    if len(lights) > 1:
        scene = dataclasses.replace(scene, emissive=None)
    cfg = TCfg(bounces=3, shadow_samples=MANY_SAMPLES, bwd_mode=kernel)
    job = tmk.make_tile_job(scene, TCamera.default(cuda_device), 96, 40, cfg)
    assert tmk.backward_kernel(job) == kernel
    cot = _cotangents((40, 96)).to(cuda_device)
    records = tmk.run_tiles(job, seed=13, record=True)[1] if kernel == "fetch" else None
    name = "megakernel_bwd_" + kernel
    before = tmk.launch_counts[name]
    g_rows, g_cam = tmk.run_bwd(job, 13, 0, records, cot)
    torch.cuda.synchronize()
    assert tmk.launch_counts[name] == before + 1
    if kernel == "fetch":
        w_rows, w_cam = tmk.run_bwd_plain(job, 13, 0, records, cot)
    else:
        plain = tmk.run_bwd_replay_plain if kernel == "replay" else tmk.run_bwd_direct_plain
        w_rows, w_cam = plain(job, 13, 0, cot)
    scale = w_rows.abs().amax(dim=0, keepdim=True)
    assert ((g_rows - w_rows).abs() <= ROWS_RTOL * w_rows.abs() + ROWS_ATOL * scale).all()
    assert ((g_cam - w_cam).abs() <= CAM_RTOL * w_cam.abs() + 5e-4 * w_cam.abs().max()).all()
    assert w_rows[list(lights), 12:15].abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["scene_2", "one_hundred_thirty_objects"])
def test_cuda_fetch_backward_from_narrow_planes_is_close_to_direct(name, cuda_device):
    """K3 at both widths of its index planes (int8 on scene_2, int16 at 130
    objects) against the backward that keeps no planes ("direct": K5, or
    K4 above 48 objects), which walks the same paths again."""
    specs = parse_objects(SCENE_2_TEXT) if name == "scene_2" \
        else random_objects(130, seed=5, lights=(7,))
    scene = Scene.from_objects(specs, device=cuda_device)
    cfg = TCfg(bounces=3, shadow_samples=2)
    job = tmk.make_tile_job(scene, TCamera.default(cuda_device), 256, 144, cfg)
    _, records = tmk.run_tiles(job, seed=14, record=True)
    assert records.dtype == (torch.int8 if name == "scene_2" else torch.int16)
    cot = _cotangents((144, 256)).to(cuda_device)
    g_rows, g_cam = tmk.run_bwd(job, 14, 0, records, cot)
    direct = dataclasses.replace(job, config=cfg.replace(bwd_mode="direct"))
    w_rows, w_cam = tmk.run_bwd(direct, 14, 0, None, cot)
    torch.cuda.synchronize()
    scale = w_rows.abs().amax(dim=0, keepdim=True)
    assert ((g_rows - w_rows).abs() <= ROWS_RTOL * w_rows.abs() + ROWS_ATOL * scale).all()
    assert ((g_cam - w_cam).abs() <= CAM_RTOL * w_cam.abs() + 5e-4 * w_cam.abs().max()).all()
    assert w_rows.abs().max() > 0


def _saved_index_planes(out):
    """The integer tensors the TilesFunction nodes of `out`'s graph saved:
    their winner-index planes."""
    seen, stack, planes = set(), [out.grad_fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "TilesFunctionBackward":
            planes += [t for t in node.saved_tensors
                       if t is not None and not t.dtype.is_floating_point]
        stack += [n for n, _ in node.next_functions]
    return planes


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_a_differentiated_frame_keeps_one_byte_an_index(device):
    """A differentiated 8-sample scene_2 frame (10 bounces, no light: 10
    planes a sample) keeps 8 * 10 * H * W bytes of index planes until
    backward(), one int8 entry a pixel and trace call."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    H, W = (96, 128) if device == "cuda" else (12, 16)
    scene = Scene.from_objects(parse_objects(SCENE_2_TEXT), device=device)
    leaf = dataclasses.replace(scene, albedo=scene.albedo.clone().requires_grad_())
    img = tmk.render_image_cuda(leaf, TCamera.default(device), W, H, seed=2, spp=8,
                                config=TCfg(), device=device)
    planes = _saved_index_planes(img)
    assert len(planes) == 8
    assert all(p.dtype == torch.int8 and tuple(p.shape) == (10, H, W) for p in planes)
    assert sum(p.numel() * p.element_size() for p in planes) == 8 * 10 * H * W
    img.sum().backward()
    assert leaf.albedo.grad is not None

