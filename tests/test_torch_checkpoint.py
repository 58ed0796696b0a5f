"""The port's checkpoints (diff/checkpoint.py) against the JAX package's.
Mirrors tests/test_checkpoint.py without the orbax and fit-resume cases
(fit's checkpoints come with the rest of diff/)."""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_tpu.diff import checkpoint as jck

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff.checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_film,
    save_checkpoint,
    save_film,
)
from ray_tracing_tpu_torch.ops.cubemap import gradient_sky
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.film import Film, render_pass
from ray_tracing_tpu_torch.scene.parser import parse_scene_string


def numpy_state():
    rng = np.random.default_rng(0)
    return {
        "params": {"a": rng.uniform(size=(2, 3)).astype(np.float32), "b": np.float32(3.5)},
        "step": 7,
        "tag": np.int32(1),
        "losses": np.asarray([1.0, 0.5], np.float32),
    }


def test_save_restore_roundtrip(tmp_path):
    state = numpy_state()
    state["params"]["t"] = torch.arange(4.0)
    d = str(tmp_path / "ck")
    assert restore_checkpoint(str(tmp_path / "nothing")) is None
    assert latest_step(d) is None
    path = save_checkpoint(d, state, 7)
    assert os.path.isfile(path) and latest_step(d) == 7
    back = restore_checkpoint(d)
    np.testing.assert_array_equal(back["params"]["a"].numpy(), state["params"]["a"])
    assert back["params"]["b"] == 3.5 and back["step"] == 7 and back["tag"] == 1
    assert back["params"]["t"].equal(torch.arange(4.0))
    save_checkpoint(d, state, 12)
    assert latest_step(d) == 12
    assert restore_checkpoint(d, step=7)["step"] == 7
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]  # written atomically


def test_restored_values_equal_jax(tmp_path):
    """The same numpy state through both packages reads back to the same
    numbers."""
    state = numpy_state()
    jck.save_checkpoint(str(tmp_path / "jax"), state, 3)
    save_checkpoint(str(tmp_path / "torch"), state, 3)
    want = jck.restore_checkpoint(str(tmp_path / "jax"))
    got = restore_checkpoint(str(tmp_path / "torch"))
    assert latest_step(str(tmp_path / "torch")) == jck.latest_step(str(tmp_path / "jax")) == 3
    for k in ("a", "b"):
        np.testing.assert_array_equal(np.asarray(got["params"][k]),
                                      np.asarray(want["params"][k]))
    np.testing.assert_array_equal(np.asarray(got["losses"]), np.asarray(want["losses"]))
    assert int(got["step"]) == int(want["step"])


def test_restore_loads_nothing_but_tensors_and_numbers(tmp_path):
    """weights_only: a file holding another object is refused with a
    warning, not executed."""
    d = tmp_path / "evil"
    d.mkdir()
    torch.save({"x": object()}, d / "ckpt_00000001.pt")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert restore_checkpoint(str(d)) is None
    assert any("failed to restore" in str(r.message) for r in rec)


@pytest.mark.parametrize("kind", ["garbage_file", "empty_directory"])
def test_restore_corrupt_checkpoint_warns(tmp_path, kind):
    d = tmp_path / "bad"
    d.mkdir()
    if kind == "garbage_file":
        (d / "ckpt_00000003.pt").write_bytes(b"\x00not a checkpoint")
    else:
        (d / "ckpt_00000003").mkdir()  # the JAX test's case: a directory that fails
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert restore_checkpoint(str(d)) is None
    assert any("failed to restore" in str(r.message) for r in rec)


def test_film_checkpoint_roundtrip(tmp_path):
    scene = parse_scene_string("sphere center {0 0 0} radius 1.5\n", device="cpu")
    cam = Camera.default("cpu")
    cfg = RenderConfig(bounces=2, shadow_samples=1)
    sky = gradient_sky(8, device="cpu")

    film = Film.zero(24, 16, "cpu")
    film = render_pass(scene, cam, film, 0, 2, cfg, sky, device="cpu")
    film = render_pass(scene, cam, film, 1, 1, cfg, sky, device="cpu")

    d = str(tmp_path / "film")
    assert restore_film(d, device="cpu") is None
    save_film(d, film, step=2)
    back = restore_film(d, device="cpu")
    assert back.weight.dtype == torch.float32 and back.weight.equal(film.weight)
    assert back.resolve().equal(film.resolve())
    # accumulation goes on from the restored film as from the original
    cont_a = render_pass(scene, cam, film, 2, 1, cfg, sky, device="cpu")
    cont_b = render_pass(scene, cam, back, 2, 1, cfg, sky, device="cpu")
    assert cont_a.resolve().equal(cont_b.resolve())
    # a checkpoint of something else is refused, not mis-assembled
    d2 = str(tmp_path / "notfilm")
    save_checkpoint(d2, {"x": torch.zeros(3)}, 1)
    with pytest.raises(ValueError, match="not a Film"):
        restore_film(d2, device="cpu")


def test_film_checkpoint_holds_what_the_jax_film_holds(tmp_path):
    """The same accum and weight, saved by each package's save_film, resolve
    to the same frame after each package's restore_film."""
    from ray_tracing_tpu.ops.vec import Vec3 as JVec3
    from ray_tracing_tpu.render.film import Film as JFilm

    from ray_tracing_tpu_torch.ops.vec import Vec3

    a = np.random.default_rng(2).uniform(0, 3, (3, 5, 7)).astype(np.float32)
    jck.save_film(str(tmp_path / "jax"), JFilm(JVec3(*map(jnp.asarray, a)), jnp.float32(2.5)))
    save_film(str(tmp_path / "torch"),
              Film(Vec3(*map(torch.from_numpy, a)), torch.tensor(2.5)))
    want = np.asarray(jck.restore_film(str(tmp_path / "jax")).resolve())
    got = restore_film(str(tmp_path / "torch"), device="cpu").resolve().numpy()
    np.testing.assert_array_equal(got, want)
