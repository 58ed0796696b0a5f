"""The port's parallel/ (the tile x sample mesh, the sharded render and the
sharded train step) on meshes of CPU cells, against the JAX package's
sharded functions on its 8 virtual CPU devices and against the port's own
one-device render and step.

Parity with JAX without shared draws: the scene below (one emissive mirror
sphere under a constant sky, no shadow rays) draws no random number that
changes the image, so both packages render it exactly, at any seed and on
any mesh; the first test checks that. Tolerances are stated where they are
used. On the CPU every cell runs the plain estimator; `gpu` runs K1-K3 on
virtual cells of the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.diff.inverse import extract_params as j_extract_params
from ray_tracing_tpu.diff.inverse import make_train_step as j_make_train_step
from ray_tracing_tpu.ops.cubemap import constant_sky as j_constant_sky
from ray_tracing_tpu.parallel.mesh import make_mesh as j_make_mesh
from ray_tracing_tpu.parallel.render import render_image_sharded as j_render_image_sharded
from ray_tracing_tpu.render.camera import Camera as JCamera

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops.cubemap import checker_sky, constant_sky
from ray_tracing_tpu_torch.parallel import mesh as pmesh
from ray_tracing_tpu_torch.parallel.render import render_image_sharded
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.synthetic import random_objects
from ray_tracing_tpu_torch.scene.types import ObjectSpec, Scene

import torch_port_util as U

W, H, SPP = 32, 16, 2
MESHES = [(1, 1), (2, 2), (4, 2)]
# an emissive mirror sphere filling a quarter of the frame: the mirror bounce
# is deterministic (metallic 1, roughness 0), the reflected ray escapes the
# convex sphere into the constant sky, and no shadow ray is cast
DI_SPECS = [ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(2.0,) * 3, roughness=0.0,
                       metallic=1.0, albedo=(0.8, 0.3, 0.2), emission_power=1.0,
                       emission_color=(0.3, 0.2, 0.1))]
DI_KW = dict(bounces=2, shadow_samples=0)
DI_FIELDS = ("emission_color", "emission_power")


@pytest.fixture(scope="module", autouse=True)
def need_8_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")


def cpu_mesh(nt, ns):
    return pmesh.make_mesh(nt, ns, devices=["cpu"] * (nt * ns))


def jax_mesh(nt, ns):
    return j_make_mesh(nt, ns, devices=jax.devices()[:nt * ns])


@pytest.fixture(scope="module")
def di():
    js, ts = U.scene_pair(DI_SPECS)
    return js, ts, j_constant_sky((0.5, 0.5, 0.5)), constant_sky((0.5, 0.5, 0.5), device="cpu")


def test_the_scene_is_draw_independent_in_both_packages(di):
    js, ts, jsky, tsky = di
    mesh = jax_mesh(1, 1)
    j = [np.asarray(j_render_image_sharded(js, JCamera.default(), W, H, jax.random.key(k), mesh,
                                           spp=SPP, config=JCfg(**DI_KW), cubemap=jsky,
                                           kernel="xla")) for k in (1, 2)]
    t = [tmk.render_image_cuda(ts, Camera.default("cpu"), W, H, s, spp=SPP,
                               config=RenderConfig(**DI_KW), cubemap=tsky, device="cpu").numpy()
         for s in (1, 2)]
    np.testing.assert_array_equal(j[0], j[1])
    np.testing.assert_array_equal(t[0], t[1])
    np.testing.assert_allclose(t[0], j[0], atol=1e-5)
    covered = (np.abs(j[0] - 0.5).max(-1) > 1e-3).mean()
    assert covered > 0.2, covered  # the sphere covers many pixels


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_frame_equals_jax(di, shape):
    """render_image_sharded on CPU cells against JAX's (kernel="xla") on the
    same mesh shape: 1e-5."""
    js, ts, jsky, tsky = di
    want = np.asarray(j_render_image_sharded(js, JCamera.default(), W, H, jax.random.key(3),
                                             jax_mesh(*shape), spp=SPP, config=JCfg(**DI_KW),
                                             cubemap=jsky, kernel="xla"))
    got = render_image_sharded(ts, Camera.default("cpu"), W, H, 3, cpu_mesh(*shape), spp=SPP,
                               config=RenderConfig(**DI_KW), cubemap=tsky)
    assert tuple(got.shape) == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def jax_gradient(js, jsky, shape):
    """The gradient JAX's make_train_step applies on `shape`: params before
    minus after one optax.sgd(1.0) step (target: zeros)."""
    mesh = jax_mesh(*shape)
    params = {"scene": j_extract_params(js, DI_FIELDS), "camera": {}}
    opt = optax.sgd(1.0)
    step = j_make_train_step(js, JCamera.default(), mesh, opt, W, H, spp=SPP,
                             config=JCfg(**DI_KW), cubemap=jsky, kernel="xla")
    new, _, loss = step(params, opt.init(params), jnp.zeros((H, W, 3)), jax.random.key(0))
    grads = {f: np.asarray(params["scene"][f], np.float64) - np.asarray(new["scene"][f], np.float64)
             for f in DI_FIELDS}
    return float(loss), grads


@pytest.fixture(scope="module")
def jax_grads(di):
    js, _, jsky, _ = di
    return {shape: jax_gradient(js, jsky, shape) for shape in ((1, 1), (1, 2))}


def port_gradient(ts, tsky, mesh, cfg=RenderConfig(**DI_KW), fields=DI_FIELDS, seed=0,
                  target=None, spp=SPP, camera=None):
    leaves = {f: getattr(ts, f).clone().requires_grad_() for f in fields}
    opt = torch.optim.SGD(list(leaves.values()), lr=0.0)
    step = inverse.make_train_step(ts, camera or Camera.default("cpu"), opt, W, H, spp=spp,
                                   config=cfg, cubemap=tsky, device="cpu", mesh=mesh)
    target = torch.zeros(H, W, 3) if target is None else target
    loss = step({"scene": leaves, "camera": {}}, target, seed)
    return float(loss), {f: x.grad.double().numpy() for f, x in leaves.items()}


@pytest.mark.parametrize("shape", MESHES + [(1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_gradient_equals_jax_single_device(di, jax_grads, shape):
    """The port's step on every mesh against JAX's step on ONE device: the
    loss to 1e-6, the gradient to rtol 1e-4 (JAX's is read back from an
    sgd(1.0) update of float32 parameters)."""
    _, ts, _, tsky = di
    want_loss, want = jax_grads[(1, 1)]
    loss, got = port_gradient(ts, tsky, cpu_mesh(*shape))
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for f in DI_FIELDS:
        assert np.abs(want[f]).max() > 1e-4, f
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-7, err_msg=f)


def test_jax_sample_axis_gradient_is_doubled_reference_fault(jax_grads):
    """The record of reference-side fault 10 (ROADMAP.md §3): on a mesh whose
    sample axis has size 2, JAX's make_train_step applies twice the gradient
    of the loss it returns. No port behaviour is asserted against it."""
    (loss1, g1), (loss2, g2) = jax_grads[(1, 1)], jax_grads[(1, 2)]
    assert loss2 == pytest.approx(loss1, rel=1e-6)
    for f in DI_FIELDS:
        np.testing.assert_allclose(g2[f], 2.0 * g1[f], rtol=1e-4, atol=1e-7, err_msg=f)


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lit():
    """A random lit scene with NEE and a packed sky: every draw matters."""
    ts = Scene.from_objects(random_objects(6, seed=4, lights=(2,)), device="cpu")
    return ts, checker_sky(16, device="cpu"), RenderConfig(bounces=2, shadow_samples=2)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (1, 4), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_frame_and_gradient_equal_one_device(lit, shape):
    """Cell (t, s) renders the one-device frame's samples of its rows, so a
    mesh changes only the order of the sums: the frame within 1e-6, the
    loss rel 1e-6 and the gradient rtol 1e-5 of the one-device ones."""
    ts, sky, cfg = lit
    cam = Camera.default("cpu")
    spp = 4
    one = tmk.render_image_cuda(ts, cam, W, H, 9, spp=spp, config=cfg, cubemap=sky, device="cpu")
    got = render_image_sharded(ts, cam, W, H, 9, cpu_mesh(*shape), spp=spp, config=cfg,
                               cubemap=sky)
    assert float((got - one).abs().max()) <= 1e-6
    target = torch.full((H, W, 3), 0.3)
    fields = ("albedo", "emission_color")
    want_loss, want = port_gradient(ts, sky, None, cfg, fields, 5, target, spp, cam)
    loss, g = port_gradient(ts, sky, cpu_mesh(*shape), cfg, fields, 5, target, spp, cam)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for f in fields:
        assert np.abs(want[f]).max() > 0, f
        np.testing.assert_allclose(g[f], want[f], rtol=1e-5, atol=1e-6 * np.abs(want[f]).max(),
                                   err_msg=f)


def test_frame_sample_seeds_are_the_one_device_frames():
    assert tmk.frame_sample_seeds(5, 1) == [5]  # sample_seeds' special case
    assert tmk.frame_sample_seeds(5, 1, 3, 8) == [5 * 7919 + 3]
    assert tmk.frame_sample_seeds(5, 2, 4, 8) == tmk.sample_seeds(5, 8)[4:6]
    with pytest.raises(ValueError):
        tmk.frame_sample_seeds(5, 2, 7, 8)


def test_samples_of_a_sharded_fit_never_repeat(monkeypatch, lit):
    """A fit over a (4, 2) mesh: every sample of every cell and step reaches
    the estimator with a (seed, first row) of its own, and each step renders
    all the frame's samples of every tile."""
    ts, sky, cfg = lit
    seen = []
    real = tmk.run_tiles_grad

    def spy(job, seed, row0=0):
        seen.append((seed, row0))
        return real(job, seed, row0)

    monkeypatch.setattr(tmk, "run_tiles_grad", spy)
    steps, spp = 3, 4
    target = torch.zeros(H, W, 3)
    inverse.fit(ts, Camera.default("cpu"), target, scene_fields=("albedo",), steps=steps,
                spp=spp, config=cfg.replace(bounces=1), cubemap=sky, seed=2**31 - 3,
                mesh=cpu_mesh(4, 2))
    assert len(seen) == steps * 4 * spp
    assert len(set(seen)) == len(seen)


def test_mesh_shapes():
    for nt, ns in [(8, 1), (2, 4)]:
        img = render_image_sharded(Scene.from_objects(DI_SPECS, device="cpu"),
                                   Camera.default("cpu"), 16, 8 * nt, 1, cpu_mesh(nt, ns),
                                   spp=ns, config=RenderConfig(**DI_KW),
                                   cubemap=constant_sky((0.4, 0.5, 0.6), device="cpu"))
        assert tuple(img.shape) == (8 * nt, 16, 3)
    m = pmesh.make_mesh(num_samples=2, devices=["cpu"] * 8)
    assert m.shape == {"tile": 4, "sample": 2}
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        pmesh.make_mesh(3, 2, devices=["cpu"] * 8)
    assert pmesh.parse_mesh("4x2", "cpu").shape == {"tile": 4, "sample": 2}
    assert pmesh.parse_mesh(None, "cpu").shape == {"tile": 1, "sample": 1}
    with pytest.raises(ValueError, match="TxS"):
        pmesh.parse_mesh("4by2", "cpu")


def test_meshes_without_a_card_fail(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (pmesh.make_mesh, pmesh.single_device_mesh, lambda: pmesh.parse_mesh(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_divisibility_errors():
    ts, mesh = Scene.from_objects(DI_SPECS, device="cpu"), cpu_mesh(4, 2)
    kw = dict(config=RenderConfig(**DI_KW), cubemap=constant_sky(device="cpu"))
    with pytest.raises(ValueError, match="height"):
        render_image_sharded(ts, Camera.default("cpu"), 32, 30, 0, mesh, spp=2, **kw)
    with pytest.raises(ValueError, match="spp"):
        render_image_sharded(ts, Camera.default("cpu"), 32, 32, 0, mesh, spp=3, **kw)
    with pytest.raises(ValueError, match="spp"):
        render_image_sharded(ts, Camera.default("cpu"), 32, 32, 0, mesh, spp=0, **kw)


def test_successive_sharded_steps_take_the_loss_of_their_frames(lit):
    """Three Adam steps on a 2x2 mesh with the packed sky: each step's loss
    is the squared error of render_image_sharded's frame at the leaves it
    starts from (to the rounding of the order of the tiles' sums), and each
    step moves the leaves."""
    ts, sky, cfg = lit
    mesh, target = cpu_mesh(2, 2), torch.full((H, W, 3), 0.4)
    a = ts.albedo.clone().requires_grad_()
    step = inverse.make_train_step(ts, Camera.default("cpu"), torch.optim.Adam([a], lr=0.05),
                                   W, H, spp=4, config=cfg, cubemap=sky, mesh=mesh)
    for i in range(3):
        before = a.detach().clone()
        with torch.no_grad():
            img = render_image_sharded(dataclasses.replace(ts, albedo=before),
                                       Camera.default("cpu"), W, H, i, mesh, spp=4, config=cfg,
                                       cubemap=sky)
        want = float(torch.sum((img - target) ** 2)) / (W * H * 3)
        loss = step({"scene": {"albedo": a}, "camera": {}}, target, i)
        assert float(loss) == pytest.approx(want, rel=1e-6), i
        assert not a.detach().equal(before), i


# ---------------------------------------------------------------------------
# On the card: virtual cells of cuda:0
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sharded_frame_on_virtual_cuda_cells_equals_one_device(cuda_device):
    """K1 on a 4x2 mesh of cells of one card: the frame within 1e-6 of
    render_image_cuda's, and K1 launched n_tiles x spp times."""
    from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT
    from ray_tracing_tpu_torch.scene.parser import parse_scene_string

    scene, cam = parse_scene_string(ROOM_TEXT, device=cuda_device), Camera.default(cuda_device)
    sky = checker_sky(256, device=cuda_device)
    mesh = pmesh.make_mesh(4, 2, devices=[cuda_device] * 8)
    with torch.no_grad():
        one = tmk.render_image_cuda(scene, cam, 320, 240, 4, spp=8, cubemap=sky)
        before = tmk.launch_counts["megakernel_fwd"]
        got = render_image_sharded(scene, cam, 320, 240, 4, mesh, spp=8, cubemap=sky)
        torch.cuda.synchronize()
    assert tmk.launch_counts["megakernel_fwd"] - before == 4 * 8
    assert float((got - one).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_sharded_step_on_virtual_cuda_cells_equals_one_device(cuda_device):
    """K2 and K3 on a 2x2 mesh of cells of one card: the loss to 1e-6, the
    gradient within the backward kernels' tolerance (float atomics) and its
    norm 1 times, not 2 times, the one-device gradient's."""
    from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT
    from ray_tracing_tpu_torch.scene.parser import parse_scene_string

    scene, cam = parse_scene_string(ROOM_TEXT, device=cuda_device), Camera.default(cuda_device)
    sky = checker_sky(256, device=cuda_device)
    target = torch.full((240, 320, 3), 0.4, device=cuda_device)
    out = {}
    for name, mesh in (("one", None), ("2x2", pmesh.make_mesh(2, 2, devices=[cuda_device] * 4))):
        a = scene.albedo.clone().requires_grad_()
        step = inverse.make_train_step(scene, cam, torch.optim.SGD([a], lr=0.0), 320, 240, spp=4,
                                       cubemap=sky, device=cuda_device, mesh=mesh)
        out[name] = (float(step({"scene": {"albedo": a}, "camera": {}}, target, 3)), a.grad)
    (l0, g0), (l1, g1) = out["one"], out["2x2"]
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert float(g1.norm() / g0.norm()) == pytest.approx(1.0, abs=1e-3)
    scale = float(g0.abs().max())
    assert float((g1 - g0).abs().max()) <= 2e-3 * scale
