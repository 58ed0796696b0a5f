"""The rest of the port's diff/inverse.py on the CPU: the train step's
guards, fit's checkpoints and resume, and fit_multiscale's schedule, after
tests/test_inverse.py and tests/test_checkpoint.py (the cases that read the
reference's files are left out). Tolerances are stated where they are used.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tracing_tpu.diff.inverse import area_downsample as j_area_downsample

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.diff.checkpoint import latest_step, restore_checkpoint
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops.cubemap import checker_sky, constant_sky
from ray_tracing_tpu_torch.parallel.mesh import make_mesh
from ray_tracing_tpu_torch.parallel.render import render_image_sharded
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.types import ObjectSpec, Scene


def cpu_mesh(nt, ns):
    return make_mesh(nt, ns, devices=["cpu"] * (nt * ns))


def test_training_entry_guards():
    """The JAX package's guards: spp below (or not a multiple of) the
    sample axis would render a scaled or empty image, a height that does
    not divide over the tiles a wrong one; metadata is not a parameter; a
    target smaller than the thumbnail would score NaN."""
    scene = Scene.from_objects([ObjectSpec(kind="sphere", p0=(0.0, 0.0, 5.0), p1=(1.0,) * 3)],
                               device="cpu")
    mesh = cpu_mesh(4, 2)
    opt = torch.optim.Adam([scene.p0.clone().requires_grad_()], lr=1e-2)
    with pytest.raises(ValueError, match="multiple of the sample axis"):
        inverse.make_train_step(scene, Camera.default("cpu"), opt, 32, 24, spp=1, mesh=mesh)
    with pytest.raises(ValueError, match="multiple of the sample axis"):
        inverse.make_train_step(scene, Camera.default("cpu"), opt, 32, 24, spp=3, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by tile axis"):
        inverse.make_train_step(scene, Camera.default("cpu"), opt, 32, 25, spp=2, mesh=mesh)
    with pytest.raises(ValueError, match="not optimizable"):
        inverse.extract_params(scene, ("emissive",))
    with pytest.raises(ValueError, match="area-downsample"):
        inverse.area_downsample(torch.zeros(16, 40, 3), 24, 32)
    assert tuple(inverse.area_downsample(torch.arange(48.0).reshape(4, 4, 3), 2, 2).shape) == (2, 2, 3)


def test_train_step_loss_decreases():
    """After tests/test_parallel.py: fit over a (4, 2) mesh of CPU cells
    pulls a perturbed albedo back. The loss is read with common random numbers (the
    target's own seed and samples), where the truth scores 0: a step's loss
    also carries the noise of its own samples."""
    cfg = RenderConfig(bounces=2, shadow_samples=1, env_filter="bilinear")
    sky = constant_sky((0.4, 0.5, 0.6), device="cpu")
    cam = Camera.default("cpu")
    true = Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3, roughness=1.0,
                   albedo=(0.8, 0.3, 0.2)),
        ObjectSpec(kind="cube", p0=(-3.0, -0.6, -3.0), p1=(12.0, 0.5, 12.0)),
        ObjectSpec(kind="sphere", p0=(1.0, 5.0, 1.0), emission_power=3.0),
    ], device="cpu")
    mesh = cpu_mesh(4, 2)

    def render(s):
        return render_image_sharded(s, cam, 32, 16, 9, mesh, spp=4, config=cfg, cubemap=sky)

    target = render(true)
    albedo = true.albedo.clone()
    albedo[0] = torch.tensor([0.2, 0.8, 0.8])
    start = dataclasses.replace(true, albedo=albedo)
    rec, _, losses = inverse.fit(start, cam, target, scene_fields=("albedo",), steps=20,
                                 lr=5e-2, spp=2, config=cfg, cubemap=sky, mesh=mesh)
    assert len(losses) == 20 and np.isfinite(losses).all() and np.mean(losses[-5:]) < losses[0]
    mse0, mse1 = (float(((render(s) - target) ** 2).mean()) for s in (start, rec))
    assert mse1 < 0.5 * mse0, (mse0, mse1)
    # the perturbed object's albedo moved toward the truth
    err0 = float((start.albedo[0] - true.albedo[0]).abs().mean())
    err1 = float((rec.albedo[0] - true.albedo[0]).abs().mean())
    assert err1 < err0 * 0.6


@pytest.fixture(scope="module")
def resume_setup():
    cfg = RenderConfig(bounces=2, shadow_samples=1, env_filter="bilinear")
    sky = constant_sky((0.8, 0.7, 0.6), device="cpu")
    cam = Camera.default("cpu")
    true = Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3, albedo=(0.9, 0.2, 0.3),
                   roughness=1.0),
    ], device="cpu")
    mesh = cpu_mesh(2, 1)
    target = render_image_sharded(true, cam, 32, 24, 1, mesh, spp=2, config=cfg, cubemap=sky)
    start = dataclasses.replace(true, albedo=torch.tensor([[0.3, 0.7, 0.7]]))
    common = dict(mesh=mesh, scene_fields=("albedo",), lr=5e-2, spp=2, config=cfg, cubemap=sky,
                  seed=4)
    return start, cam, target, common


def test_fit_resumes_from_checkpoint(tmp_path, resume_setup):
    """After tests/test_checkpoint.py: 10 steps with a checkpoint every 5,
    then asked for 20 it resumes at 10; and on the CPU the resumed run
    equals an uninterrupted one bit for bit (leaves and losses)."""
    start, cam, target, common = resume_setup
    d = str(tmp_path / "fitck")
    _, _, losses10 = inverse.fit(start, cam, target, steps=10, checkpoint_dir=d,
                                 checkpoint_every=5, **common)
    assert latest_step(d) == 10 and sorted(p.name for p in tmp_path.joinpath("fitck").iterdir()) \
        == ["ckpt_00000005.pt", "ckpt_00000010.pt"]
    state = restore_checkpoint(d)
    assert state["fields"] == ["albedo"] and state["step"] == 10 and state["losses"] == losses10
    assert int(state["opt_state"]["state"][0]["step"]) == 10

    rec, _, losses20 = inverse.fit(start, cam, target, steps=20, checkpoint_dir=d,
                                   checkpoint_every=5, **common)
    assert len(losses20) == 20 and latest_step(d) == 20
    assert losses20[:10] == losses10
    assert losses20[-1] < losses10[0]

    whole, _, losses_whole = inverse.fit(start, cam, target, steps=20, **common)
    assert losses20 == losses_whole
    assert rec.albedo.equal(whole.albedo)


def test_fit_checkpoint_of_other_fields_raises(tmp_path, resume_setup):
    start, cam, target, common = resume_setup
    d = str(tmp_path / "fitck")
    inverse.fit(start, cam, target, steps=2, checkpoint_dir=d, **common)
    assert restore_checkpoint(d)["fields"] == ["albedo"]
    other = dict(common, scene_fields=("albedo", "roughness"))
    with pytest.raises(ValueError, match=r"written for fields \['albedo'\]"):
        inverse.fit(start, cam, target, steps=4, checkpoint_dir=d, **other)
    with pytest.raises(ValueError, match="cam:pos"):
        inverse.fit(start, cam, target, steps=4, checkpoint_dir=d, camera_fields=("pos",),
                    **common)


def test_fit_steps_once_a_step_at_the_step_seed(monkeypatch):
    """With a packed nearest-texel sky over a mesh, fit builds one step and
    calls it step(params, target, seed) once a step, at step_seed(seed, i),
    and its losses are the step's."""
    seeds, losses = [], []
    real = inverse.make_train_step

    def spy(*args, **kw):
        step = real(*args, **kw)

        def wrapped(params, target, seed):
            seeds.append(seed)
            loss = step(params, target, seed)
            losses.append(float(loss))
            return loss

        return wrapped

    monkeypatch.setattr(inverse, "make_train_step", spy)
    scene = Scene.from_objects([ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3)],
                               device="cpu")
    _, _, got = inverse.fit(scene, Camera.default("cpu"), torch.zeros(8, 16, 3),
                            scene_fields=("albedo",), steps=5, spp=2, seed=4,
                            config=RenderConfig(bounces=1, shadow_samples=0),
                            cubemap=checker_sky(8, device="cpu"), mesh=cpu_mesh(2, 1))
    assert seeds == [inverse.step_seed(4, i) for i in range(5)]
    assert got == losses


def test_fit_multiscale_stages_equal_jax_area_downsample(monkeypatch):
    """The stages of fit_multiscale: sizes H // down, W // down with the
    height rounded down to the tile axis, targets equal to the JAX
    package's area_downsample of the same image (1e-6), the stage seed
    step_seed(seed, stage), the losses concatenated."""
    calls = []

    def fake_fit(scene, cam, target, **kw):
        calls.append((target.numpy().copy(), kw["width"], kw["height"], kw["seed"], kw["steps"]))
        return scene, cam, [float(kw["steps"])] * kw["steps"]

    monkeypatch.setattr(inverse, "fit", fake_fit)
    img = np.random.default_rng(0).uniform(0, 1, (50, 64, 3)).astype(np.float32)
    scene = Scene.from_objects([ObjectSpec(kind="sphere")], device="cpu")
    _, _, losses = inverse.fit_multiscale(scene, Camera.default("cpu"), img, scene_fields=("albedo",),
                                          schedule=((4, 2), (2, 3), (1, 1), (64, 1)), seed=11,
                                          mesh=cpu_mesh(4, 1))
    # 50 // 4 = 12, 50 // 2 = 25 -> 24, 50 -> 48 (tile axis 4); 50 // 64 = 0 is skipped
    assert [(w, h) for _, w, h, _, _ in calls] == [(16, 12), (32, 24), (64, 48)]
    assert [s for *_, s, _ in calls] == [inverse.step_seed(11, k) for k in range(3)]
    assert losses == [2.0, 2.0, 3.0, 3.0, 3.0, 1.0]
    for target, w, h, _, _ in calls:
        np.testing.assert_allclose(target, np.asarray(j_area_downsample(img, h, w)), atol=1e-6)


def test_fit_multiscale_recovers_an_albedo():
    cfg = RenderConfig(bounces=2, shadow_samples=0, env_filter="bilinear")
    sky = constant_sky((0.8, 0.7, 0.6), device="cpu")
    cam = Camera.default("cpu")
    true = Scene.from_objects([ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.5,) * 3,
                                          albedo=(0.9, 0.2, 0.3), roughness=1.0)], device="cpu")
    target = tmk.render_image_cuda(true, cam, 32, 24, 1, spp=4, config=cfg, cubemap=sky,
                                   device="cpu")
    start = dataclasses.replace(true, albedo=torch.tensor([[0.3, 0.7, 0.7]]))
    rec, _, losses = inverse.fit_multiscale(start, cam, target, scene_fields=("albedo",),
                                            schedule=((4, 6), (2, 6), (1, 6)), lr=5e-2, spp=2,
                                            config=cfg, cubemap=sky, device="cpu")
    assert len(losses) == 18 and np.isfinite(losses).all()
    e0 = float((start.albedo - true.albedo).abs().mean())
    e1 = float((rec.albedo - true.albedo).abs().mean())
    assert e1 < 0.6 * e0, (e0, e1)
