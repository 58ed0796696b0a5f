"""The port's coarse pose search (diff/inverse.py::coarse_pose_search, the
global initialiser of apps/pose_recovery.py) on the CPU: its directions and
candidate poses against the JAX package's, and the ranking on the
asymmetric four-object scene of tests/test_pose_search.py, whose three
checks it mirrors with a target the port renders from a known pose.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_tpu.diff import inverse as jinv
from ray_tracing_tpu.render import integrator as jint
from ray_tracing_tpu.scene.parser import parse_scene_string as j_parse_scene_string

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import checker_sky
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import POSE_SEARCH_TEXT


@pytest.mark.parametrize("n", [1, 4, 16, 24])
def test_fibonacci_directions_equal_jax(n):
    np.testing.assert_array_equal(inverse._fibonacci_directions(n), jinv._fibonacci_directions(n))


@pytest.mark.parametrize("kw", [
    dict(n_pos=24),
    dict(n_pos=5, radii=(1.25,), look_jitter=((0.0, 0.0), (15.0, -80.0))),
], ids=["defaults", "steep-pitch"])
def test_candidate_poses_equal_jax(monkeypatch, kw):
    """Every candidate (position, front) of the JAX search, read back by
    asking it for all of them with a render that scores each one 0, equals
    the port's pose_candidates, as a set (the order of equal scores is
    argsort's)."""
    monkeypatch.setattr(jint, "render_image",
                        lambda scene, cam, w, h, key, spp, config, cubemap:
                        jnp.zeros((h, w, 3)) + 0.0 * cam.pos[0])
    jscene = j_parse_scene_string(POSE_SEARCH_TEXT)
    base = np.array([0.3, 1.2, 5.5], np.float32)
    jcam = dataclasses.replace(jinv.Camera.default(), pos=jnp.asarray(base))
    poss, fronts = inverse.pose_candidates(parse_scene_string(POSE_SEARCH_TEXT, device="cpu"),
                                           base, **kw)
    cands, _ = jinv.coarse_pose_search(jscene, np.zeros((48, 64, 3), np.float32),
                                       base_camera=jcam, top_k=len(poss), **kw)
    want = np.stack([np.concatenate([p, f]) for p, f in cands])
    got = np.concatenate([poss, fronts], axis=1)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[np.lexsort(got.T)], want[np.lexsort(want.T)])


@pytest.fixture(scope="module")
def setup():
    scene = parse_scene_string(POSE_SEARCH_TEXT, device="cpu")
    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = checker_sky(32, device="cpu")
    center, half_diag = inverse.scene_bounds(scene)
    # ground truth: not one of the spiral candidates (off-lattice direction
    # and radius), looking at the scene centre
    gdir = np.array([0.55, 0.35, 0.76])
    gdir /= np.linalg.norm(gdir)
    gpos = center + gdir * (1.25 * half_diag)
    cam_true = dataclasses.replace(Camera.default("cpu"),
                                   pos=torch.tensor(gpos, dtype=torch.float32),
                                   front=torch.tensor(center - gpos, dtype=torch.float32))
    target = render_image_cuda(scene, cam_true, 64, 48, 3, spp=2, config=cfg, cubemap=sky,
                               device="cpu").numpy()
    return scene, cfg, sky, center, gpos, target


def test_scene_bounds():
    scene = parse_scene_string(POSE_SEARCH_TEXT, device="cpu")
    center, half_diag = inverse.scene_bounds(scene)
    # the floor spans x and z, the blue sphere's top (1.1 + 0.55) and the
    # floor's bottom span y: (-3, -1, -3)..(3, 1.65, 3)
    np.testing.assert_allclose(center, [0.0, 0.325, 0.0], atol=1e-6)
    assert half_diag == pytest.approx(0.5 * np.linalg.norm([6.0, 2.65, 6.0]), rel=1e-6)


def test_coarse_search_finds_the_right_side(setup):
    scene, cfg, sky, center, gpos, target = setup
    cands, scores = inverse.coarse_pose_search(
        scene, target, n_pos=16, radii=(1.25,), width=32, height=24, spp=1,
        look_jitter=((0.0, 0.0), (15.0, 0.0), (-15.0, 0.0)), config=cfg, cubemap=sky,
        top_k=3, device="cpu")
    assert len(cands) == 3 and scores == sorted(scores)
    # the true basin is in the top-k the refinement tournament consumes
    true_dir = (gpos - center) / np.linalg.norm(gpos - center)
    dots = [float(true_dir @ ((p - center) / np.linalg.norm(p - center))) for p, _ in cands]
    assert max(dots) > 0.5, (dots, gpos)


def test_coarse_search_beats_the_opposite_pose(setup):
    scene, cfg, sky, center, gpos, target = setup
    cands, scores = inverse.coarse_pose_search(
        scene, target, n_pos=12, radii=(1.25,), width=32, height=24, spp=1,
        look_jitter=((0.0, 0.0),), config=cfg, cubemap=sky, top_k=1, device="cpu")
    wrong_pos = center - (gpos - center)
    cam_wrong = dataclasses.replace(Camera.default("cpu"),
                                    pos=torch.tensor(wrong_pos, dtype=torch.float32),
                                    front=torch.tensor(center - wrong_pos, dtype=torch.float32))
    t_small = inverse.area_downsample(torch.from_numpy(target), 24, 32)
    img = render_image_cuda(scene, cam_wrong, 32, 24, 7, spp=1, config=cfg, cubemap=sky,
                            device="cpu")
    wrong_mse = float(((img - t_small) ** 2).mean())
    assert scores[0] < 0.7 * wrong_mse, (scores[0], wrong_mse)


def test_manual_guess_stays_in_the_tournament(setup):
    """base_camera.pos is among the scored positions: the exact ground-truth
    position wins over a 4-point spiral."""
    scene, cfg, sky, center, gpos, target = setup
    guess = dataclasses.replace(Camera.default("cpu"),
                                pos=torch.tensor(gpos, dtype=torch.float32),
                                front=torch.tensor(center - gpos, dtype=torch.float32))
    cands, _ = inverse.coarse_pose_search(
        scene, target, base_camera=guess, n_pos=4, radii=(1.25,), width=32, height=24, spp=1,
        look_jitter=((0.0, 0.0),), config=cfg, cubemap=sky, top_k=1, device="cpu")
    np.testing.assert_allclose(cands[0][0], np.asarray(gpos, np.float32), atol=1e-5)


def test_coarse_search_refuses_a_target_smaller_than_the_thumbnail(setup):
    scene, cfg, sky, *_ = setup
    with pytest.raises(ValueError, match="area-downsample"):
        inverse.coarse_pose_search(scene, np.zeros((16, 20, 3), np.float32), n_pos=1,
                                   config=cfg, cubemap=sky, device="cpu")
