"""render/camera of the PyTorch port against the JAX package, rtol=1e-6
(the same float32 formulas; a few ulps of atol for sums that cancel)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.kernels.megakernel import _camera_pack as j_camera_pack
from ray_tracing_tpu.render import camera as jcam

from ray_tracing_tpu_torch.config import RenderConfig as TCfg
from ray_tracing_tpu_torch.render import camera as tcam

import torch_port_util as U

RTOL, ATOL = 1e-6, 1e-6


def _poses():
    cams = [jcam.Camera.default()]
    c = cams[0]
    for dx, dy in [(30.0, -12.0), (-400.0, 950.0), (3.5, 0.25)]:
        c = jcam.rotate(c, dx, dy)
        c = jcam.move(c, jcam.LEFT)
        cams.append(c)
    return cams


@pytest.mark.parametrize("bug", [True, False])
def test_camera_pack_and_screen_height(bug):
    jc, tc = JCfg(fov_degrees_bug=bug), TCfg(fov_degrees_bug=bug)
    assert tcam.screen_height(tc) == jcam.screen_height(jc)
    if bug:
        assert abs(tcam.screen_height(tc) - (-1.712)) < 1e-3  # 2*tan(15 rad)
    for cam in _poses():
        for aspect in (16 / 9, 1.0, 96 / 72):
            want = np.asarray(j_camera_pack(cam, aspect, jc))
            got = tcam.camera_pack(U.camera_to_torch(cam), aspect, tc)
            assert got.dtype == torch.float32 and got.shape == (16,)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_default_camera_keeps_raw_front():
    t, j = tcam.Camera.default("cpu"), jcam.Camera.default()
    for f in ("pos", "front", "up", "yaw", "pitch"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    assert t.front.tolist() == [-1.0, -1.0, -1.0]


@pytest.mark.parametrize("w,h,row0,nh", [(96, 72, 0, None), (64, 16, 32, 72), (1, 1, 0, None), (7, 3, 5, 11)])
def test_pixel_grid_and_rays(w, h, row0, nh):
    uj, vj = jcam.pixel_grid(w, h, row0, nh)
    ut, vt = tcam.pixel_grid(w, h, row0, nh, device="cpu")
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=RTOL, atol=1e-7)
    for cam in _poses()[:2]:
        roj, rdj = jcam.ray_through_screen(cam, uj, vj, w / (nh or h))
        rot, rdt = tcam.ray_through_screen(
            U.camera_to_torch(cam), torch.from_numpy(np.array(uj)),
            torch.from_numpy(np.array(vj)), w / (nh or h))
        np.testing.assert_allclose(U.vec_np(rdt), U.vec_np(rdj), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(U.vec_np(rot), U.vec_np(roj))


def test_tile_uv_matches_jax_tile_uv():
    from ray_tracing_tpu.kernels.megakernel import _tile_uv as j_tile_uv
    from ray_tracing_tpu_torch.kernels.megakernel import _tile_uv as t_tile_uv

    w, nh, row0 = 200, 144, 32
    uj, vj = j_tile_uv(jnp.int32(1), jnp.int32(0), 16, 128, w, nh, jnp.int32(row0))
    ut, vt = t_tile_uv(w, 32, nh, row0, "cpu")  # rows 32..63 of the frame
    np.testing.assert_array_equal(vt.numpy()[16:32, :128], np.asarray(vj))
    np.testing.assert_array_equal(ut.numpy()[16:32, :128], np.asarray(uj))


def test_move_and_rotate():
    j, t = jcam.Camera.default(), tcam.Camera.default("cpu")
    for step in (jcam.UP, jcam.RIGHT, jcam.DOWN, jcam.LEFT):
        j, t = jcam.move(j, step), tcam.move(t, step)
        np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), rtol=RTOL, atol=ATOL)
        j, t = jcam.rotate(j, 37.0, -11.0), tcam.rotate(t, 37.0, -11.0)
        np.testing.assert_allclose(t.front.numpy(), np.asarray(j.front), rtol=1e-5, atol=ATOL)
        np.testing.assert_allclose(t.yaw.numpy(), np.asarray(j.yaw), rtol=RTOL)
        np.testing.assert_allclose(t.pitch.numpy(), np.asarray(j.pitch), rtol=RTOL)
    t = tcam.rotate(t, 0.0, 1e6)
    assert float(t.pitch) == 89.0
