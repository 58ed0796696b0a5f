"""The backward modes of the PyTorch port that keep no index planes, on the
CPU: "replay" (the plain version of K4: record the winners' parameter planes,
take the VJP of a loop-free replay, route the record cotangents to rows) and
"direct" (the plain version of K5: autograd through the closest-hit trace),
against the JAX package on the same numpy inputs, against each other and
through the autograd boundary, the renderer and fit.

The JAX side runs as its own test does (tests/test_megakernel.py::
test_path_replay_grads_match_xla_autodiff): RecordingTracer, jax.vjp over a
ReplayTracer, _route_record_grads, the light row; and jax.grad of the direct
tile_physics. Draws are injected (torch_port_util.FixedDraws). Tolerances, the
JAX package's own: scene rows rtol 2e-3 / atol 2e-4, camera pack rtol 2e-2 /
atol 5e-2. Pixels where a last-bit difference between the two packages flips
a decision get a zero cotangent on both sides (test_torch_backward.py says
why); their number is printed and bounded.
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
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops import intersect as tint
from ray_tracing_tpu_torch.ops.vec import Vec3 as TVec3
from ray_tracing_tpu_torch.render.camera import Camera as TCamera
from ray_tracing_tpu_torch.scene.parser import parse_objects
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects

import torch_port_util as U

ROWS_RTOL, ROWS_ATOL = 2e-3, 2e-4
CAM_RTOL, CAM_ATOL = 2e-2, 5e-2
SHAPE = (16, 128)


def _rays(js, n=4 * 64, seed=3):
    """(ro, rd) of shape (3, 4, 64): random rays toward the scene, then
    axis-parallel rays straight at objects of both kinds, from outside and
    from inside a box, and rays that miss everything."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-9, 9, (3, n)).astype(np.float32)
    rd = (r.uniform(-4, 4, (3, n)).astype(np.float32) - ro) * r.uniform(0.3, 2.0, (1, n)).astype(np.float32)
    p0, p1 = np.asarray(js.p0), np.asarray(js.p1)
    special = []
    for i in range(6):
        centre = p0[i] if js.is_sphere(i) else p0[i] + 0.5 * p1[i]
        axis = np.eye(3, dtype=np.float32)[i % 3]
        special.append((centre - 12.0 * axis, axis))        # along +x, +y or +z
        special.append((centre + 12.0 * axis, -axis))       # and back
    cube = next(i for i in range(js.num_objects) if not js.is_sphere(i))
    special.append((p0[cube] + 0.5 * p1[cube], np.array([0.0, 1.0, 0.0])))  # from inside a box
    special += [((0.0, 40.0, 0.0), (0.0, 1.0, 0.0)), ((0.0, 40.0, 0.0), (1.0, 0.0, 0.0))]
    for k, (o, d) in enumerate(special):
        ro[:, k] = o
        rd[:, k] = d
    return ro.reshape(3, 4, 64), rd.reshape(3, 4, 64)


def _scene(n_objects, with_metadata=True):
    js, ts = U.scene_pair(random_objects(n_objects, seed=1, lights=(7,)))
    if not with_metadata:
        js = dataclasses.replace(js, emissive=None)
        ts = dataclasses.replace(ts, emissive=None)
    return js, ts


RECORD_PLANES = ("hit", "is_sph", "roughness", "reflectance", "metallic")
RECORD_VECS = ("p0", "p1", "albedo", "emission")


def _record_np(rec):
    """A TraceRecord of either package -> dict of numpy arrays."""
    out = {k: np.asarray(getattr(rec, k)) for k in ("obj", *RECORD_PLANES)}
    out.update({k: U.vec_np(getattr(rec, k)) for k in RECORD_VECS})
    return out


def _trace_record_from_np(d, vec, arr):
    """dict of numpy arrays -> a TraceRecord of the package whose Vec3 maker
    and array maker are given (the JAX or the port's class follows)."""
    cls = jint.TraceRecord if vec is U.jvec else tint.TraceRecord
    return cls(obj=arr(d["obj"]), **{k: arr(d[k]) for k in RECORD_PLANES},
               **{k: vec(d[k]) for k in RECORD_VECS})


# ---------------------------------------------------------------------------
# (a) trace_record / trace_replay / trace_shadow_record / _replay against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_objects", [9, 60])
def test_trace_record_matches_jax(n_objects):
    """Winner, masks and parameter planes elementwise. A box's p1 is its size
    (as JAX's scan recorder at 60 objects keeps it); JAX's unrolled recorder
    at 9 keeps hi - lo, within one rounding of it."""
    js, ts = _scene(n_objects)
    ro, rd = _rays(js)
    _, jrec = jint.trace_record(js, U.jvec(ro), U.jvec(rd))
    th, trec = tint.trace_record(ts, U.tvec(ro), U.tvec(rd))
    want, got = _record_np(jrec), _record_np(trec)
    same = want["obj"] == got["obj"]
    assert same.mean() >= 0.99, same.mean()  # a tie's last bit may differ
    assert (got["obj"] >= 0).mean() > 0.2 and (got["obj"] < 0).sum() >= 2
    assert got["is_sph"][same & (got["obj"] >= 0)].min() == 0.0  # boxes are hit too
    for k in ("hit", "is_sph", "p0", "albedo", "roughness", "reflectance", "metallic", "emission"):
        np.testing.assert_array_equal(got[k][..., same], want[k][..., same], err_msg=k)
    np.testing.assert_allclose(got["p1"][:, same], want["p1"][:, same], rtol=1e-6, err_msg="p1")
    # the record's winner and hit are the Hit's
    np.testing.assert_array_equal(got["obj"], th.obj.numpy())
    np.testing.assert_array_equal(got["hit"] > 0.5, th.hit.numpy())


@pytest.mark.parametrize("n_objects", [9, 60])
def test_trace_replay_matches_jax_and_rebuilds_the_trace(n_objects):
    js, ts = _scene(n_objects)
    ro, rd = _rays(js)
    th, trec = tint.trace_record(ts, U.tvec(ro), U.tvec(rd))
    # the port's replay of its own record is its trace, bit for bit, where
    # the ray hits (a miss's normal is never read)
    rh = tint.trace_replay(trec, U.tvec(ro), U.tvec(rd))
    hit = th.hit.numpy()
    for name in ("point", "normal", "albedo", "emission"):
        np.testing.assert_array_equal(U.vec_np(getattr(rh, name))[:, hit],
                                      U.vec_np(getattr(th, name))[:, hit], err_msg=name)
    np.testing.assert_array_equal(rh.t.numpy()[hit], th.t.numpy()[hit])

    # both packages' trace_replay on the same record planes and rays
    rec_np = _record_np(trec)
    rec_np["obj"][0, 10:14] = -1  # rays that hit, replayed as misses
    rec_np["hit"][0, 10:14] = 0.0
    w = np.random.default_rng(4).uniform(-1, 1, (13, *rec_np["obj"].shape)).astype(np.float32)

    def functional(h, where, arr):
        parts = [where(h.hit, h.t, 0.0), h.point.x, h.point.y, h.point.z, h.normal.x,
                 h.normal.y, h.normal.z, h.albedo.x, h.roughness, h.reflectance, h.metallic,
                 h.emission.x, h.emission.z]
        return sum((c * arr(wk)).sum() for c, wk in zip(parts, w))

    float_keys = ("p0", "p1", "albedo", "roughness", "metallic", "emission")

    def jf(planes, ro_a, rd_a):
        rec = _trace_record_from_np({**rec_np, **planes}, U.jvec, jnp.asarray)
        h = jint.trace_replay(rec, JVec3(*ro_a), JVec3(*rd_a))
        return functional(h, jnp.where, jnp.asarray), h

    jplanes = {k: jnp.asarray(rec_np[k]) for k in float_keys}
    (_, jh), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jplanes, jnp.asarray(ro), jnp.asarray(rd))

    leaves = {k: torch.from_numpy(rec_np[k].copy()).requires_grad_() for k in float_keys}
    ro_t = torch.from_numpy(ro.copy()).requires_grad_()
    rd_t = torch.from_numpy(rd.copy()).requires_grad_()
    rec = dataclasses.replace(
        _trace_record_from_np(rec_np, U.tvec, torch.from_numpy),
        **{k: (TVec3(*leaves[k]) if k in RECORD_VECS else leaves[k]) for k in float_keys})
    h = tint.trace_replay(rec, TVec3(*ro_t), TVec3(*rd_t))
    functional(h, torch.where, torch.from_numpy).backward()

    hit = rec_np["hit"] > 0.5
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_allclose(h.t.detach().numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5)
    for name in ("point", "normal"):
        v = getattr(h, name)
        got = np.stack([c.detach().numpy() for c in (v.x, v.y, v.z)])
        np.testing.assert_allclose(got[:, hit], U.vec_np(getattr(jh, name))[:, hit],
                                   rtol=1e-5, atol=1e-6)
    for k in float_keys:
        got, want = leaves[k].grad.numpy(), np.asarray(jg[0][k])
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, rtol=ROWS_RTOL, atol=ROWS_ATOL, err_msg=k)
    for got, want in ((ro_t.grad, jg[1]), (rd_t.grad, jg[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROWS_RTOL, atol=ROWS_ATOL)
    # a lane replayed as a miss sends nothing anywhere
    assert np.abs(rd_t.grad.numpy()[:, ~hit]).max() == 0.0


@pytest.mark.parametrize("n_objects", [9, 60])
@pytest.mark.parametrize("with_metadata", [True, False], ids=["one_light_metadata", "emissive_none"])
def test_trace_shadow_record_and_replay_match_jax(n_objects, with_metadata):
    js, ts = _scene(n_objects, with_metadata)
    ro, rd = _rays(js, seed=6)
    li = js.light_index
    # from the light's side toward it, so that the light is reached
    lo = U.vec_np(js.origin_of(li)).reshape(3, 1, 1)
    rd = (lo - ro + 0.3 * rd / np.linalg.norm(rd, axis=0, keepdims=True)).astype(np.float32)
    (jhit, jem), jrec = jint.trace_shadow_record(js, U.jvec(ro), U.jvec(rd))
    (thit, tem), trec = tint.trace_shadow_record(ts, U.tvec(ro), U.tvec(rd))
    same = np.asarray(jrec.obj) == trec.obj.numpy()
    assert same.mean() >= 0.99, same.mean()
    assert (trec.obj.numpy() >= 0).sum() > 10
    if with_metadata:  # the occlusion trace names the light or nothing
        assert set(np.unique(trec.obj.numpy())) <= {-1, li}
    np.testing.assert_array_equal(trec.hit.numpy()[same], np.asarray(jrec.hit)[same])
    np.testing.assert_array_equal(U.vec_np(trec.emission)[:, same], U.vec_np(jrec.emission)[:, same])
    np.testing.assert_array_equal(thit.numpy(), trec.hit.numpy() > 0.5)
    # the replay: the occlusion bit and the emission leaf, as in JAX
    rhit, rem = tint.trace_shadow_replay(trec)
    jrhit, jrem = jint.trace_shadow_replay(jint.ShadowRecord(
        obj=jnp.asarray(trec.obj.numpy()), hit=jnp.asarray(trec.hit.numpy()),
        emission=U.jvec(U.vec_np(trec.emission))))
    np.testing.assert_array_equal(rhit.numpy(), np.asarray(jrhit))
    np.testing.assert_array_equal(U.vec_np(rem), U.vec_np(jrem))
    assert rem.x is trec.emission.x


# ---------------------------------------------------------------------------
# (b) route_record_grads against a numpy segment sum and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_objects", [9, 300])
def test_route_record_grads_matches_segment_sum_and_jax(n_objects):
    """Three trace records and two shadow records (ns = 3) with -1 winners;
    300 objects takes the JAX package's chunked arm."""
    r = np.random.default_rng(11)
    shape = (4, 64)
    records, g_records, oracle = [], [], np.zeros((n_objects, 16), np.float64)
    jrecords, jg_records = [], []
    for k in range(5):
        trace = k < 3
        obj = r.integers(-1, n_objects, (shape if trace else (3, *shape))).astype(np.int32)
        obj.reshape(-1)[:20] = -1
        planes = {key: r.uniform(-1, 1, obj.shape).astype(np.float32) for key in RECORD_PLANES}
        planes.update({key: r.uniform(-1, 1, (3, *obj.shape)).astype(np.float32) for key in RECORD_VECS})
        grads = {key: r.uniform(-1, 1, v.shape).astype(np.float32) for key, v in planes.items()}
        if trace:
            records.append(_trace_record_from_np({"obj": obj, **planes}, U.tvec, torch.from_numpy))
            g_records.append(_trace_record_from_np({"obj": obj, **grads}, U.tvec, torch.from_numpy))
            jrecords.append(_trace_record_from_np({"obj": obj, **planes}, U.jvec, jnp.asarray))
            jg_records.append(_trace_record_from_np({"obj": obj, **grads}, U.jvec, jnp.asarray))
            cols = [*grads["p0"], *grads["p1"], *grads["albedo"], grads["roughness"],
                    grads["reflectance"], grads["metallic"], *grads["emission"]]
            first = 0
        else:
            def shadow(d, vec, arr, cls):
                return cls(obj=arr(obj), hit=arr(d["hit"]), emission=vec(d["emission"]))
            records.append(shadow(planes, U.tvec, torch.from_numpy, tint.ShadowRecord))
            g_records.append(shadow(grads, U.tvec, torch.from_numpy, tint.ShadowRecord))
            jrecords.append(shadow(planes, U.jvec, jnp.asarray, jint.ShadowRecord))
            jg_records.append(shadow(grads, U.jvec, jnp.asarray, jint.ShadowRecord))
            cols, first = list(grads["emission"]), 12
        keep = obj.reshape(-1) >= 0
        for c, plane in enumerate(cols):
            np.add.at(oracle[:, first + c], obj.reshape(-1)[keep], plane.reshape(-1)[keep])
    got = tmk.route_record_grads(n_objects, records, g_records).numpy()
    want_jax = np.asarray(jmk._route_record_grads(n_objects, jrecords, jg_records))
    assert np.abs(got[:, 15]).max() == 0.0
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)
    # a None cotangent plane routes nothing
    none_g = [dataclasses.replace(g, roughness=None) if isinstance(g, tint.TraceRecord) else g
              for g in g_records]
    got_none = tmk.route_record_grads(n_objects, records, none_g).numpy()
    assert np.abs(got_none[:, 9]).max() == 0.0
    np.testing.assert_array_equal(np.delete(got_none, 9, axis=1), np.delete(got, 9, axis=1))


# ---------------------------------------------------------------------------
# (c), (d) the plain versions of K4 and K5 against JAX
# ---------------------------------------------------------------------------


def _uv():
    xs = np.broadcast_to(np.arange(SHAPE[1], dtype=np.float32), SHAPE)
    ys = np.broadcast_to(np.arange(SHAPE[0], dtype=np.float32)[:, None], SHAPE)
    return (1.0 - xs / (SHAPE[1] - 1)).astype(np.float32), (1.0 - ys / (SHAPE[0] - 1)).astype(np.float32)


def _module_case(n_objects):
    """Both packages' scene, config, draws, screen grid, camera pack and the
    port's job; cotangents zero where a decision flipped between them."""
    js, ts = _scene(n_objects)
    assert js.light_index == 7
    jcfg, tcfg = JCfg(bounces=3, shadow_samples=2), TCfg(bounces=3, shadow_samples=2)
    draws = U.FixedDraws(9, 3, 2, SHAPE)
    u, v = _uv()
    jcam = jmk._camera_pack(JCamera.default(), 2.0, jcfg).reshape(1, 16)
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), SHAPE[1], SHAPE[0], tcfg, aspect=2.0)
    np.testing.assert_array_equal(job.rows.numpy(), np.asarray(jmk.pack_scene(js)))
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    ut, vt = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    jdirect = jmk.tile_physics(js, jcam[0], ju, jv, draws.jax, jcfg, SHAPE)
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tdirect = tmk.tile_physics(view, job.cam_pack, ut, vt, draws.torch, job.config, SHAPE)
    same = np.ones(SHAPE, bool)
    for a, b in zip(tdirect, jdirect):
        same &= np.abs(a.numpy() - np.asarray(b)) <= 2e-4 + 2e-3 * np.abs(np.asarray(b))
    flipped = int((~same).sum())
    print(f"{n_objects} objects: {flipped} of {same.size} pixels flipped a decision")
    assert flipped <= 4
    cot = np.random.default_rng(5).uniform(-1, 1, (10, *SHAPE)).astype(np.float32) * same
    return js, jcfg, draws, ju, jv, ut, vt, jcam, job, cot


@pytest.mark.parametrize("n_objects", [9, 60])
def test_replay_plain_matches_jax_path_replay(n_objects):
    """record_replay_vjp (what run_bwd_replay_plain wraps) against JAX's
    RecordingTracer -> jax.vjp over a ReplayTracer -> _route_record_grads ->
    light row. The light-origin gradient is zero on both sides: occlusion is
    detached, so the origin reaches only the shadow rays."""
    js, jcfg, draws, ju, jv, ut, vt, jcam, job, cot = _module_case(n_objects)
    recorder = jmk.RecordingTracer(js)
    jmk.tile_physics(js, jcam[0], ju, jv, draws.jax, jcfg, SHAPE, tracer=recorder)
    rows0 = jmk.pack_scene(js)
    li = js.light_index
    light_geom = (JVec3(*(rows0[li, k] for k in range(3))), JVec3(*(rows0[li, k] for k in range(3, 6))))

    def f(records, cam_arr, light_geom):
        tracer = jmk.ReplayTracer(records, True, light_geom, light_is_sphere=bool(js.is_sphere(li)))
        return jmk.tile_physics(None, cam_arr[0], ju, jv, draws.jax, jcfg, SHAPE, tracer=tracer)

    _, vjpf = jax.vjp(f, recorder.records, jcam, light_geom)
    g_records, jg_cam, (gp0, gp1) = vjpf(tuple(jnp.asarray(c) for c in cot))
    want = np.array(jmk._route_record_grads(n_objects, recorder.records, g_records))
    jg_light = np.array([float(c) for c in (gp0.x, gp0.y, gp0.z, gp1.x, gp1.y, gp1.z)])
    want[li, 0:6] += jg_light

    planes, g_rows, g_cam, g_light = tmk.record_replay_vjp(
        job, ut, vt, draws.torch, compat.cotangents_from_numpy(cot, device="cpu"))
    got_rows, got_cam = g_rows.numpy(), g_cam.numpy()
    assert np.isfinite(got_rows).all() and np.isfinite(got_cam).all()
    assert np.abs(got_rows[:, 15]).max() == 0.0
    np.testing.assert_allclose(got_rows[:, :15], want[:, :15], rtol=ROWS_RTOL, atol=ROWS_ATOL)
    np.testing.assert_allclose(got_cam, np.asarray(jg_cam).reshape(16), rtol=CAM_RTOL, atol=CAM_ATOL)
    assert np.abs(jg_light).max() == 0.0 and g_light.abs().max() == 0.0
    # the replay walked the forward's paths: its planes are the forward's bit for bit
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    direct = tmk.tile_physics(view, job.cam_pack, ut, vt, draws.torch, job.config, SHAPE)
    for k, (a, b) in enumerate(zip(planes, direct)):
        assert a.equal(b), tmk.PLANE_NAMES[k]


def test_direct_plain_matches_jax_grad():
    """direct_vjp (what run_bwd_direct_plain wraps) against jax.grad of the
    JAX tile_physics through its unrolled trace, at 9 objects (the direct
    kernel's domain is N <= 48)."""
    n_objects = 9
    js, jcfg, draws, ju, jv, ut, vt, jcam, job, cot = _module_case(n_objects)

    def loss_direct(rows, cam_arr):
        s = dataclasses.replace(
            js, p0=rows[:, 0:3], p1=rows[:, 3:6], albedo=rows[:, 6:9], roughness=rows[:, 9],
            reflectance=rows[:, 10], metallic=rows[:, 11], emission_color=rows[:, 12:15],
            emission_power=jnp.ones(n_objects, jnp.float32))
        outs = jmk.tile_physics(s, cam_arr[0], ju, jv, draws.jax, jcfg, SHAPE)
        return sum(jnp.vdot(o, jnp.asarray(c)) for o, c in zip(outs, cot))

    want_rows, want_cam = jax.grad(loss_direct, argnums=(0, 1))(jmk.pack_scene(js), jcam)
    planes, g_rows, g_cam = tmk.direct_vjp(job, ut, vt, draws.torch,
                                           compat.cotangents_from_numpy(cot, device="cpu"))
    got_rows, got_cam = g_rows.numpy(), g_cam.numpy()
    assert np.isfinite(got_rows).all() and np.isfinite(got_cam).all()
    np.testing.assert_allclose(got_rows[:, :15], np.asarray(want_rows)[:, :15],
                               rtol=ROWS_RTOL, atol=ROWS_ATOL)
    np.testing.assert_allclose(got_cam, np.asarray(want_cam).reshape(16), rtol=CAM_RTOL, atol=CAM_ATOL)
    assert np.abs(got_rows[:, 15]).max() == 0.0
    # reflectance feeds only the branch, the light's position only the
    # detached shadow rays: jax.grad agrees that neither has a gradient
    assert np.abs(np.asarray(want_rows)[:, 10]).max() == 0.0 == np.abs(got_rows[:, 10]).max()


# ---------------------------------------------------------------------------
# (e) fetch, replay and direct agree with each other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["room", "room_jitter", "scene_2", "two_lights_full_scan"])
def test_the_three_plain_backwards_agree(case):
    """The port's run_bwd_plain (fetch, on the recording forward's index
    planes), run_bwd_replay_plain and run_bwd_direct_plain on one sample:
    rows within rtol 2e-3 / atol 2e-4 of the column's largest entry, camera
    within rtol 2e-2 / atol 5e-4 of the pack's largest entry (the criterion
    chip_smoke.py holds the kernels to)."""
    text_or_specs = {"room": ROOM_TEXT, "room_jitter": ROOM_TEXT, "scene_2": SCENE_2_TEXT,
                     "two_lights_full_scan": random_objects(30, seed=4, lights=(7, 20))}[case]
    specs = parse_objects(text_or_specs) if isinstance(text_or_specs, str) else text_or_specs
    _, ts = U.scene_pair(specs)
    cfg = TCfg(bounces=4, shadow_samples=2, pixel_jitter=case == "room_jitter")
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 40, 12, cfg)
    if case == "two_lights_full_scan":
        assert job.single_emissive == -1 and job.light_index == 7
    cot = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (10, 12, 40)).astype(np.float32))
    _, records = tmk.run_tiles_plain(job, 3, record=True)
    f_rows, f_cam = tmk.run_bwd_plain(job, 3, 0, records, cot)
    assert f_rows.abs().max() > 0
    for plain in (tmk.run_bwd_replay_plain, tmk.run_bwd_direct_plain):
        g_rows, g_cam = plain(job, 3, 0, cot)
        assert torch.isfinite(g_rows).all() and g_rows[:, 15].abs().max() == 0
        scale = f_rows.abs().amax(dim=0, keepdim=True)
        assert ((g_rows - f_rows).abs() <= ROWS_RTOL * f_rows.abs() + ROWS_ATOL * scale).all()
        assert ((g_cam - f_cam).abs() <= CAM_RTOL * f_cam.abs() + 5e-4 * f_cam.abs().max()).all()


# ---------------------------------------------------------------------------
# (f) the autograd boundary and the dispatch
# ---------------------------------------------------------------------------


def test_backward_kernel_picks_direct_only_up_to_the_unroll_limit():
    _, ts = U.scene_pair(random_objects(60, seed=1, lights=(7,)))
    cam = TCamera.default("cpu")
    assert tint.UNROLL_LIMIT == jint.UNROLL_LIMIT == 48

    def job(n, mode):
        s = dataclasses.replace(ts, obj_type=ts.obj_type[:n],
                                **{k: getattr(ts, k)[:n] for k in U.SCENE_LEAVES},
                                emissive=ts.emissive[:n])
        return tmk.make_tile_job(s, cam, 8, 4, TCfg(bwd_mode=mode))

    assert tmk.backward_kernel(job(48, "direct")) == "direct"
    assert tmk.backward_kernel(job(49, "direct")) == "replay"
    assert tmk.backward_kernel(job(9, "replay")) == "replay"
    assert tmk.backward_kernel(job(60, "fetch")) == "fetch"
    # the JAX package reports "direct" where the replay kernel runs; so does the port
    assert tmk.effective_bwd_mode(ts, TCfg(bwd_mode="direct"), 8, 4, 1) == "direct"


@pytest.mark.parametrize("mode", ["fetch", "replay", "direct"])
def test_tiles_function_keeps_index_planes_in_fetch_only(mode, monkeypatch):
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 24, 8, TCfg(bounces=3, shadow_samples=2,
                                                                    bwd_mode=mode))
    calls = []
    real = tmk.run_tiles
    monkeypatch.setattr(tmk, "run_tiles", lambda j, s, r=0, record=False: (
        calls.append(record), real(j, s, r, record))[1])
    rows = job.rows.clone().requires_grad_()
    planes, _ = tmk.run_tiles_grad(dataclasses.replace(job, rows=rows), seed=3)
    saved = [t for t in planes.grad_fn.saved_tensors if t is not None]
    assert calls == [mode == "fetch"]
    index = tmk.record_dtype(len(job.obj_type))  # int8: the room's 9 objects
    assert any(t.dtype == index for t in saved) == (mode == "fetch")
    assert sum(t.numel() for t in saved if t.dtype != index) == rows.numel() + 16
    # the planes are the non-recording forward's either way, and backward runs
    want, _ = tmk.run_tiles_plain(job, 3)
    assert planes.detach().equal(want)
    cot = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (10, 8, 24)).astype(np.float32))
    (planes * cot).sum().backward()
    assert torch.isfinite(rows.grad).all() and rows.grad.abs().max() > 0


def test_residual_free_modes_through_the_renderer_on_a_row_slice():
    """render_image_cuda under grad in replay and direct, on a row slice with
    jitter and soft silhouettes: the gradients of fetch's."""
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    cam = TCamera.default("cpu")
    base = TCfg(bounces=3, shadow_samples=2, pixel_jitter=True, env_filter="bilinear",
                soft_silhouette_temp=0.08)
    grads = {}
    for mode in ("fetch", "replay", "direct"):
        p0 = ts.p0.clone().requires_grad_()
        albedo = ts.albedo.clone().requires_grad_()
        img = tmk.render_image_cuda(dataclasses.replace(ts, p0=p0, albedo=albedo), cam, 24, 6,
                                    seed=5, spp=2, config=base.replace(bwd_mode=mode), row0=4,
                                    norm_height=16, device="cpu")
        img.sum().backward()
        grads[mode] = (img.detach(), p0.grad, albedo.grad)
    for mode in ("replay", "direct"):
        assert grads[mode][0].equal(grads["fetch"][0])
        for got, want in zip(grads[mode][1:], grads["fetch"][1:]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ROWS_RTOL,
                                       atol=ROWS_ATOL * float(want.abs().max()))


# ---------------------------------------------------------------------------
# (g) fit in every mode
# ---------------------------------------------------------------------------


def test_fit_runs_in_every_backward_mode():
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    cam = TCamera.default("cpu")
    cfg = TCfg(bounces=3, shadow_samples=2)
    W, H = 24, 16
    target = tmk.render_image_cuda(ts, cam, W, H, seed=99, spp=4, config=cfg, device="cpu")
    start = dataclasses.replace(ts, albedo=(ts.albedo * 0.5).clamp(0.05, 1.0))
    seen_rows = [0, 1, 2, 3, 4, 6]  # the diffuse objects the camera sees
    e0 = float((start.albedo - ts.albedo)[seen_rows].abs().mean())
    losses = {}
    for mode in ("fetch", "replay", "direct"):
        scene, _, losses[mode] = inverse.fit(start, cam, target, scene_fields=("albedo",), steps=4,
                                             lr=0.05, spp=2, config=cfg.replace(bwd_mode=mode),
                                             seed=1, device="cpu")
        assert all(np.isfinite(losses[mode])) and not scene.albedo.requires_grad
        assert float((scene.albedo - ts.albedo)[seen_rows].abs().mean()) < e0, mode
    # the same first loss, and steps whose gradients agree to rounding
    for mode in ("replay", "direct"):
        assert losses[mode][0] == losses["fetch"][0]
        np.testing.assert_allclose(losses[mode], losses["fetch"], rtol=1e-4)


# ---------------------------------------------------------------------------
# On the card (skipped where there is none)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["replay", "direct"])
def test_cuda_residual_free_backward_kernels_match_their_plain_versions(mode, cuda_device):
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    job = tmk.make_tile_job(ts.to(cuda_device), TCamera.default(cuda_device), 256, 144,
                            TCfg(bwd_mode=mode))
    cot = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (10, 144, 256)).astype(np.float32))
    cot = cot.to(cuda_device)
    key = "megakernel_bwd_" + mode
    before = tmk.launch_counts[key]
    g_rows, g_cam = tmk.run_bwd(job, 11, 0, None, cot)
    torch.cuda.synchronize()
    assert tmk.launch_counts[key] == before + 1
    plain = tmk.run_bwd_replay_plain if mode == "replay" else tmk.run_bwd_direct_plain
    w_rows, w_cam = plain(job, 11, 0, cot)
    scale = w_rows.abs().amax(dim=0, keepdim=True)
    assert ((g_rows - w_rows).abs() <= ROWS_RTOL * w_rows.abs() + ROWS_ATOL * scale).all()
    assert ((g_cam - w_cam).abs() <= CAM_RTOL * w_cam.abs() + 5e-4 * w_cam.abs().max()).all()
    assert g_rows[:, 15].abs().max() == 0


def _direct_case(case, device):
    """(scene, config) of a case of K5's card test: the lit room; direct
    mode's largest scene (UNROLL_LIMIT = 48 objects, one emitter); more
    bounces than K5 keeps states for; more shadow samples than a mask
    holds, with one emitter and with a full scan of two lights."""
    from ray_tracing_tpu_torch.scene.types import Scene

    room = Scene.from_objects(parse_objects(ROOM_TEXT), device=device)
    two_lights = dataclasses.replace(
        Scene.from_objects(random_objects(12, seed=3, lights=(2, 5)), device=device),
        emissive=None)
    return {
        "room": (room, TCfg()),
        "48_objects": (Scene.from_objects(random_objects(tmk.UNROLL_LIMIT, seed=4, lights=(7,)),
                                          device=device), TCfg()),
        "room_16_bounces": (room, TCfg(bounces=16)),
        "room_33_samples": (room, TCfg(bounces=3, shadow_samples=33)),
        "two_lights_33_samples": (two_lights, TCfg(bounces=3, shadow_samples=33)),
        "two_lights": (two_lights, TCfg()),
    }[case]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["room", "48_objects", "room_16_bounces", "room_33_samples",
                                  "two_lights_33_samples", "two_lights"])
def test_cuda_direct_kernel_matches_its_plain_version_and_the_replay_kernel(case, cuda_device):
    """K5 at 256x144 against its plain version and against K4 on the same
    cotangents: both take the walk's winners, so they agree within the order
    of their float atomics, as each does with its plain version."""
    scene, cfg = _direct_case(case, cuda_device)
    job = tmk.make_tile_job(scene, TCamera.default(cuda_device), 256, 144,
                            cfg.replace(bwd_mode="direct"))
    assert tmk.backward_kernel(job) == "direct"
    cot = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (10, 144, 256)).astype(np.float32))
    cot = cot.to(cuda_device)
    before = tmk.launch_counts["megakernel_bwd_direct"]
    g_rows, g_cam = tmk.run_bwd(job, 11, 0, None, cot)
    k4_rows, k4_cam = tmk._launch_bwd("replay", job, 11, 0, None, cot)
    torch.cuda.synchronize()
    assert tmk.launch_counts["megakernel_bwd_direct"] == before + 1
    w_rows, w_cam = tmk.run_bwd_direct_plain(job, 11, 0, cot)
    for want_rows, want_cam in ((w_rows, w_cam), (k4_rows, k4_cam)):
        scale = want_rows.abs().amax(dim=0, keepdim=True)
        assert ((g_rows - want_rows).abs() <= ROWS_RTOL * want_rows.abs() + ROWS_ATOL * scale).all()
        assert ((g_cam - want_cam).abs() <= CAM_RTOL * want_cam.abs()
                + 5e-4 * want_cam.abs().max()).all()
    assert g_rows[:, 15].abs().max() == 0 and w_rows.abs().max() > 0
