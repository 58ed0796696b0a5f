"""The training slice of the PyTorch port on the CPU: gradients of the whole
render, the soft-silhouette composite against the JAX function, one train
step against a JAX loss under the same injected draws, and fit / the invert
app at a small size.

On the CPU the port renders through the plain versions of its kernels
(device="cpu"). Tolerances are stated where they are used.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.kernels import megakernel as jmk
from ray_tracing_tpu.ops import cubemap as jcm
from ray_tracing_tpu.ops.vec import Vec3 as JVec3
from ray_tracing_tpu.render import integrator as jint
from ray_tracing_tpu.render.camera import Camera as JCamera, ray_through_screen as j_ray_through_screen

from ray_tracing_tpu_torch import compat
from ray_tracing_tpu_torch.apps import invert
from ray_tracing_tpu_torch.config import RenderConfig as TCfg
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.ops.vec import Vec3 as TVec3
from ray_tracing_tpu_torch.render import integrator as tint
from ray_tracing_tpu_torch.render.camera import Camera as TCamera, ray_through_screen
from ray_tracing_tpu_torch.scene.parser import parse_objects
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT
from ray_tracing_tpu_torch.scene.types import ObjectSpec, Scene as TScene

import torch_port_util as U

CAMERA_LEAVES = ("pos", "front", "up")


def _with_leaves(scene, camera):
    """(scene, camera, leaves): every optimisable tensor replaced by a leaf
    that requires grad."""
    s_leaves = {n: getattr(scene, n).clone().requires_grad_() for n in inverse.SCENE_PARAM_FIELDS}
    c_leaves = {n: getattr(camera, n).clone().requires_grad_() for n in CAMERA_LEAVES}
    return (dataclasses.replace(scene, **s_leaves), dataclasses.replace(camera, **c_leaves),
            {**s_leaves, **c_leaves})


def _sky_pair(size=8):
    """The gradient sky of both packages from the same numpy faces."""
    jsky = jcm.gradient_sky(size)
    faces = np.stack([np.asarray(c).reshape(6, size, size) for c in (jsky.r, jsky.g, jsky.b)], -1)
    return jsky, tcm.CubemapData.from_faces(faces, device="cpu")


# ---------------------------------------------------------------------------
# Gradients of the whole render
# ---------------------------------------------------------------------------


def test_every_leaf_gets_a_finite_gradient_through_the_render():
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    scene, cam, leaves = _with_leaves(ts, TCamera.default("cpu"))
    _, sky = _sky_pair()
    cfg = TCfg(bounces=3, shadow_samples=2, env_filter="bilinear", soft_silhouette_temp=0.08)
    img = tmk.render_image_cuda(scene, cam, 33, 17, seed=3, spp=2, config=cfg, cubemap=sky,
                                device="cpu")
    assert tuple(img.shape) == (17, 33, 3) and torch.isfinite(img).all()
    img.sum().backward()
    for name, leaf in leaves.items():
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
        if name != "reflectance":  # feeds only the specular/diffuse comparison
            assert leaf.grad.abs().max() > 0, name
    assert leaves["reflectance"].grad.abs().max() == 0


def test_axis_parallel_centre_ray_does_not_poison_the_gradients():
    """An axis-aligned camera and an odd frame: the centre column and row
    have a zero direction component, the centre ray hits a cube face along
    its normal and its mirror bounce is axis-parallel too. One such lane
    used to turn every scene gradient into NaN."""
    specs = [
        ObjectSpec(kind="cube", p0=(-1.0, -1.0, 2.0), p1=(2.0, 2.0, 1.0), metallic=1.0),
        ObjectSpec(kind="cube", p0=(-4.0, -2.0, -1.0), p1=(8.0, 0.5, 8.0), roughness=0.7),
        ObjectSpec(kind="sphere", p0=(2.5, 0.0, 3.0), p1=(0.8,) * 3, reflectance=0.9),
        ObjectSpec(kind="sphere", p0=(0.0, 4.0, 1.0), p1=(0.7,) * 3, emission_power=6.0),
    ]
    ts = TScene.from_objects(specs, device="cpu")
    cam = TCamera(pos=torch.tensor([0.0, 0.0, -6.0]), front=torch.tensor([0.0, 0.0, 1.0]),
                  up=torch.tensor([0.0, 1.0, 0.0]), yaw=torch.tensor(90.0), pitch=torch.tensor(0.0))
    _, rd = ray_through_screen(cam, torch.tensor(0.5), torch.tensor(0.5), 21 / 13)
    assert float(rd.x) == 0.0 and float(rd.y) == 0.0  # the centre ray is axis-parallel
    scene, cam, leaves = _with_leaves(ts, cam)
    for cfg in (TCfg(bounces=3, shadow_samples=2),
                TCfg(bounces=3, shadow_samples=2, env_filter="bilinear", soft_silhouette_temp=0.08)):
        for leaf in leaves.values():
            leaf.grad = None
        img = tmk.render_image_cuda(scene, cam, 21, 13, seed=1, spp=1, config=cfg,
                                    cubemap=_sky_pair()[1], device="cpu")
        img.sum().backward()
        for name, leaf in leaves.items():
            assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
        assert leaves["albedo"].grad.abs().max() > 0
        # geometry is felt through the sky's direction and the soft edges only
        assert (leaves["p0"].grad.abs().max() > 0) == (cfg.soft_silhouette_temp > 0)


# ---------------------------------------------------------------------------
# Soft silhouettes against the JAX function
# ---------------------------------------------------------------------------


def test_soft_silhouette_composite_matches_jax():
    js, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    jsky, tsky = _sky_pair()
    jcfg = JCfg(env_filter="bilinear", soft_silhouette_temp=0.08)
    tcfg = TCfg(env_filter="bilinear", soft_silhouette_temp=0.08)
    shape = (12, 48)
    r = np.random.default_rng(8)
    u = np.broadcast_to(np.linspace(1, 0, shape[1], dtype=np.float32), shape).copy()
    v = np.broadcast_to(np.linspace(1, 0, shape[0], dtype=np.float32)[:, None], shape).copy()
    result = r.uniform(0, 1, (3, *shape)).astype(np.float32)
    wgt = r.uniform(-1, 1, (3, *shape)).astype(np.float32)
    rows_np = np.asarray(js.packed_rows())
    jcam, tcam = JCamera.default(), TCamera.default("cpu")

    def jf(rows, pos):
        s = dataclasses.replace(js, p0=rows[:, 0:3], p1=rows[:, 3:6], albedo=rows[:, 6:9],
                                emission_color=rows[:, 12:15],
                                emission_power=jnp.ones(js.num_objects, jnp.float32))
        ro0, rd0 = j_ray_through_screen(dataclasses.replace(jcam, pos=pos), jnp.asarray(u),
                                        jnp.asarray(v), 4.0, jcfg)
        out = jint.soft_silhouette_composite(s, ro0, rd0, U.jvec(result), jcfg, jsky)
        return (out.x * wgt[0] + out.y * wgt[1] + out.z * wgt[2]).sum(), out

    (_, jout), (jg_rows, jg_pos) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rows_np), jcam.pos)

    rows_t = torch.from_numpy(rows_np.copy()).requires_grad_()
    pos_t = tcam.pos.clone().requires_grad_()
    view = tmk.SceneView(rows_t, ts.obj_type, ts.light_index, ts.emissive)
    ro0, rd0 = ray_through_screen(dataclasses.replace(tcam, pos=pos_t), torch.from_numpy(u),
                                  torch.from_numpy(v), 4.0, tcfg)
    out = tint.soft_silhouette_composite(view, ro0, rd0, U.tvec(result), tcfg, tsky)
    wt = torch.from_numpy(wgt)
    (out.x * wt[0] + out.y * wt[1] + out.z * wt[2]).sum().backward()

    got = U.vec_np(TVec3(out.x.detach(), out.y.detach(), out.z.detach()))
    assert np.abs(got - result).max() > 0.05  # the blend does something
    np.testing.assert_allclose(got, U.vec_np(jout), rtol=1e-4, atol=1e-5)
    assert torch.isfinite(rows_t.grad).all() and torch.isfinite(pos_t.grad).all()
    scale = np.abs(np.asarray(jg_rows)).max()
    np.testing.assert_allclose(rows_t.grad.numpy(), np.asarray(jg_rows), rtol=2e-3, atol=2e-5 * scale)
    np.testing.assert_allclose(pos_t.grad.numpy(), np.asarray(jg_pos), rtol=2e-3,
                               atol=2e-5 * np.abs(np.asarray(jg_pos)).max())


def test_soft_slab_coverage_is_finite_on_deep_misses_and_parallel_rays():
    lo = [torch.tensor(v, requires_grad=True) for v in (0.0, 0.0, 0.0)]
    hi = [torch.tensor(v, requires_grad=True) for v in (1.0, 1.0, 1.0)]
    ro = TVec3(torch.tensor([0.5, 5.0, 0.5, 1e6]), torch.tensor([0.5, 0.5, 50.0, 0.5]),
               torch.tensor([-3.0, -3.0, -3.0, -3.0]))
    d = TVec3(torch.zeros(4), torch.tensor([0.0, 0.0, 0.0, 1e-9]), torch.ones(4))
    cov = tint._soft_slab_coverage(ro, d, TVec3(*lo), TVec3(*hi), 0.08)
    assert cov[0] > 0.99 and cov[1] < 1e-6 and cov[2] < 1e-6 and cov[3] < 1e-6
    grads = torch.autograd.grad(cov.sum(), [*lo, *hi])
    assert all(torch.isfinite(g) for g in grads)


# ---------------------------------------------------------------------------
# diff/inverse helpers
# ---------------------------------------------------------------------------


def test_extract_params_and_area_downsample_guards():
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    got = inverse.extract_params(ts, ("p0", "albedo"))
    assert set(got) == {"p0", "albedo"} and got["p0"] is ts.p0
    with pytest.raises(ValueError, match="not optimizable"):
        inverse.extract_params(ts, ("p0", "emissive"))
    img = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(4, 6, 3)
    small = inverse.area_downsample(img, 2, 3)
    want = img.numpy().reshape(2, 2, 3, 2, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(small.numpy(), want)
    assert inverse.area_downsample(img[:, :5], 2, 2).shape == (2, 2, 3)  # crops the odd column
    with pytest.raises(ValueError, match="larger than the source"):
        inverse.area_downsample(img, 8, 3)
    with pytest.raises(ValueError, match="zero gradients"):
        inverse.fit(ts, TCamera.default("cpu"), torch.zeros(4, 4, 3), camera_fields=("yaw",),
                    steps=1, device="cpu")
    assert inverse.step_seed(3, 0) != inverse.step_seed(3, 1) != inverse.step_seed(4, 0)
    assert -2**31 <= inverse.step_seed(2**31 - 1, 7) < 2**31


def test_compat_carries_parameters_and_gradients_as_numpy():
    params = compat.params_from_numpy(
        {"scene": {"p0": np.ones((3, 3)), "roughness": np.zeros(3)}, "rows": np.ones((3, 16))},
        device="cpu")
    p0 = params["scene"]["p0"]
    assert p0.dtype == torch.float32 and p0.requires_grad and p0.is_leaf
    (p0 * 2).sum().backward()
    back = compat.grads_to_numpy(params)
    np.testing.assert_array_equal(back["scene"]["p0"], np.full((3, 3), 2, np.float32))
    np.testing.assert_array_equal(back["scene"]["roughness"], np.zeros(3, np.float32))
    assert back["rows"].shape == (3, 16)
    cot = compat.cotangents_from_numpy([np.ones((2, 4))] * 10, device="cpu")
    assert tuple(cot.shape) == (10, 2, 4) and cot.is_contiguous()
    with pytest.raises(ValueError):
        compat.cotangents_from_numpy([np.ones((2, 4))] * 9, device="cpu")


def test_effective_bwd_mode_boundary_and_residual_free_modes(monkeypatch):
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    cfg = TCfg(bounces=3, shadow_samples=2)
    cam = TCamera.default("cpu")

    def albedo_grad(config, spp):
        """(image, albedo gradient) of the frame's sum."""
        leaf = ts.albedo.clone().requires_grad_()
        img = tmk.render_image_cuda(dataclasses.replace(ts, albedo=leaf), cam, 16, 8, spp=spp,
                                    config=config, device="cpu")
        img.sum().backward()
        return img.detach(), leaf.grad

    want = {spp: albedo_grad(cfg, spp) for spp in (1, 3)}  # fetch, within the budget

    n_rec = tmk.record_layout(cfg, True)
    assert tmk.record_dtype(ts.num_objects) == torch.int8  # one byte an index
    need = 2 * n_rec * 8 * 16 * 1
    monkeypatch.setattr(tmk, "FETCH_RECORD_BUDGET_BYTES", need)
    assert tmk.effective_bwd_mode(ts, cfg, 16, 8, 2) == "fetch"
    assert tmk.effective_bwd_mode(ts, cfg, 16, 8, 3) == "replay"
    assert tmk.effective_bwd_mode(ts, cfg.replace(bwd_mode="direct"), 16, 8, 3) == "direct"
    # a 1080-object scene keeps two bytes an index (int16), so the same
    # budget holds half its samples: the bytes are the only rule
    many = dataclasses.replace(ts, obj_type=ts.obj_type * 120)
    assert tmk.record_dtype(many.num_objects) == torch.int16
    assert tmk.effective_bwd_mode(many, cfg, 16, 8, 1) == "fetch"
    assert tmk.effective_bwd_mode(many, cfg, 16, 8, 2) == "replay"
    # no light: fewer planes, so more samples fit
    _, s2 = U.scene_pair(parse_objects(SCENE_2_TEXT))
    assert tmk.effective_bwd_mode(s2, cfg, 16, 8, 6) == "fetch"

    # the modes that keep no index planes run under grad and give fetch's
    # gradient (rtol 2e-3, atol 2e-4 of the largest entry): configured, and
    # over the budget, where "fetch" runs as "replay"
    runs = [(cfg.replace(bwd_mode="replay"), 1), (cfg.replace(bwd_mode="direct"), 1), (cfg, 3)]
    for config, spp in runs:
        img, grad = albedo_grad(config, spp)
        assert img.equal(want[spp][0]) and torch.isfinite(grad).all()
        np.testing.assert_allclose(grad.numpy(), want[spp][1].numpy(), rtol=2e-3,
                                   atol=2e-4 * float(want[spp][1].abs().max()))
    # without a gradient to take, no mode is executed
    for mode in ("replay", "direct"):
        img = tmk.render_image_cuda(ts, cam, 16, 8, spp=1, config=cfg.replace(bwd_mode=mode),
                                    device="cpu")
        assert img.equal(want[1][0])


# ---------------------------------------------------------------------------
# One train step against a JAX loss under the same draws
# ---------------------------------------------------------------------------


def test_train_step_loss_and_gradients_match_jax(monkeypatch):
    """make_train_step (one sample, bilinear gradient sky, soft silhouettes)
    against a JAX loss built from the JAX tile_physics, sample_cubemap,
    compose and soft_silhouette_composite, both fed the same draws: the
    port's draws are injected where its forward and backward plain versions
    fetch them. Loss rtol 1e-4; gradients rtol 2e-3, atol 2e-4 of the
    field's largest entry. The JAX make_train_step itself draws from
    threefry and cannot share a stream."""
    W, H = 64, 16
    js, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    js = dataclasses.replace(js, emissive=None)  # emission is trained: full shadow scan
    jsky, tsky = _sky_pair()
    kw = dict(bounces=3, shadow_samples=2, env_filter="bilinear", soft_silhouette_temp=0.08)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    draws = U.FixedDraws(21, 3, 2, (H, W))
    target = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jcam, tcam = JCamera.default(), TCamera.default("cpu")
    fields = ("p0", "albedo", "emission_power")

    u_t, v_t = tmk._tile_uv(W, H, H, 0, "cpu")
    u, v = u_t.numpy().copy(), v_t.numpy().copy()
    monkeypatch.setattr(tmk, "_sample_inputs", lambda job, seed, row0: (u_t, v_t, draws.torch))

    def jloss(p):
        s = dataclasses.replace(js, **p["scene"])
        cam = dataclasses.replace(jcam, **p["camera"])
        pack = jmk._camera_pack(cam, W / H, jcfg)
        t = jmk.tile_physics(s, pack, jnp.asarray(u), jnp.asarray(v), draws.jax, jcfg, (H, W))
        sky = jcm.sample_cubemap(jsky, JVec3(t[3], t[4], t[5]), bilinear=True)
        rgb = (JVec3(t[0], t[1], t[2]) + sky * JVec3(t[6], t[7], t[8]) * t[9]).clip(0.0, 1.0)
        ro0, rd0 = j_ray_through_screen(cam, jnp.asarray(u), jnp.asarray(v), W / H, jcfg)
        rgb = jint.soft_silhouette_composite(s, ro0, rd0, rgb, jcfg, jsky)
        return jnp.sum((rgb.to_array() - jnp.asarray(target)) ** 2) / (W * H * 3)

    jparams = {"scene": {f: getattr(js, f) for f in fields}, "camera": {"pos": jcam.pos}}
    want_loss, want_g = jax.value_and_grad(jloss)(jparams)

    params = compat.params_from_numpy(
        {"scene": {f: np.asarray(getattr(js, f)) for f in fields},
         "camera": {"pos": np.asarray(jcam.pos)}}, device="cpu")
    leaves = [*params["scene"].values(), *params["camera"].values()]
    before = [x.detach().clone() for x in leaves]
    step = inverse.make_train_step(ts, tcam, torch.optim.SGD(leaves, lr=0.0), W, H, spp=1,
                                   config=tcfg, cubemap=tsky, device="cpu")
    loss = step(params, torch.from_numpy(target), seed=5)
    assert all(a.equal(b) for a, b in zip(before, leaves))  # lr 0: only the gradients are read
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    got = compat.grads_to_numpy(params)
    for group in ("scene", "camera"):
        for name, g in got[group].items():
            w = np.asarray(want_g[group][name])
            assert np.isfinite(g).all() and np.abs(w).max() > 0, name
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4 * np.abs(w).max(), err_msg=name)
    # with emission trained, the dark objects' emission gets a gradient too
    assert np.abs(got["scene"]["emission_power"][:7]).max() > 0


def test_train_step_updates_the_leaves_in_place():
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    cam = TCamera.default("cpu")
    cfg = TCfg(bounces=2)
    _, sky = _sky_pair()
    target = tmk.render_image_cuda(ts, cam, 24, 16, seed=9, spp=1, config=cfg, cubemap=sky,
                                   device="cpu")
    albedo = (ts.albedo * 0.5).requires_grad_()
    opt = torch.optim.Adam([albedo], lr=0.05)
    step = inverse.make_train_step(ts, cam, opt, 24, 16, spp=1, config=cfg, cubemap=sky,
                                   device="cpu")
    start = albedo.detach().clone()
    loss = step({"scene": {"albedo": albedo}, "camera": {}}, target, seed=1)
    assert loss.ndim == 0 and not loss.requires_grad and float(loss) > 0
    assert not albedo.detach().equal(start)
    with pytest.raises(ValueError):
        inverse.make_train_step(ts, cam, opt, 24, 16, spp=0, device="cpu")


# ---------------------------------------------------------------------------
# fit and the invert app at a small size
# ---------------------------------------------------------------------------


def test_fit_recovers_a_perturbed_albedo():
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    cam = TCamera.default("cpu")
    cfg = TCfg(bounces=3, shadow_samples=2)
    _, sky = _sky_pair()
    W, H = 48, 32
    target = tmk.render_image_cuda(ts, cam, W, H, seed=99, spp=8, config=cfg, cubemap=sky,
                                   device="cpu")
    noise = torch.from_numpy(np.random.default_rng(0).normal(0, 0.2, ts.albedo.shape).astype(np.float32))
    start = dataclasses.replace(ts, albedo=(ts.albedo + noise).clamp(0.05, 1.0))
    seen = []
    scene, _, losses = inverse.fit(start, cam, target, scene_fields=("albedo",), steps=30, lr=0.03,
                                   spp=2, config=cfg, cubemap=sky, seed=1, device="cpu",
                                   callback=lambda i, loss, p: seen.append((i, loss)))
    assert len(losses) == 30 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert [i for i, _ in seen] == list(range(30)) and seen[-1][1] == pytest.approx(losses[-1])
    # the diffuse objects the camera sees: the floor, two walls, two boxes, a sphere
    seen_rows = [0, 1, 2, 3, 4, 6]
    e0 = float((start.albedo - ts.albedo)[seen_rows].abs().mean())
    e1 = float((scene.albedo - ts.albedo)[seen_rows].abs().mean())
    print(f"albedo error {e0:.4f} -> {e1:.4f}, loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    assert e1 < 0.5 * e0
    assert not scene.albedo.requires_grad and scene.p0 is start.p0


def test_fit_moves_a_sphere_toward_the_truth_with_soft_silhouettes():
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    cam = TCamera.default("cpu")
    _, sky = _sky_pair()
    cfg = TCfg(bounces=3, env_filter="bilinear", soft_silhouette_temp=0.08)
    W, H = 48, 32
    target = tmk.render_image_cuda(ts, cam, W, H, seed=99, spp=4, config=cfg, cubemap=sky,
                                   device="cpu")
    p0 = ts.p0.clone()
    p0[1] += torch.tensor([0.3, 0.25, 0.0])  # the middle sphere, off its place
    start = dataclasses.replace(ts, p0=p0)
    scene, _, losses = inverse.fit(start, cam, target, scene_fields=("p0",), steps=30, lr=0.03,
                                   spp=2, config=cfg, cubemap=sky, seed=2, device="cpu")
    e0 = float((start.p0[1] - ts.p0[1]).norm())
    e1 = float((scene.p0[1] - ts.p0[1]).norm())
    print(f"sphere offset {e0:.4f} -> {e1:.4f}, loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    assert e1 < e0 and losses[-1] < losses[0]


def test_invert_app_runs_on_the_cpu(tmp_path, capsys):
    scene_file = tmp_path / "scene_2.txt"
    scene_file.write_text(SCENE_2_TEXT)
    out = tmp_path / "fit.png"
    rc = invert.main(["--scene", str(scene_file), "--fields", "albedo", "--steps", "6",
                      "--width", "32", "--height", "20", "--spp", "2", "--out", str(out),
                      "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 0 and out.stat().st_size > 0
    assert "loss: " in err and " -> " in err
    assert "albedo: |err| " in err
    with pytest.raises(ValueError, match="TxS"):  # a malformed mesh is refused
        invert.main(["--scene", str(scene_file), "--mesh", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="not optimizable"):
        invert.main(["--scene", str(scene_file), "--fields", "emissive", "--device", "cpu"])
