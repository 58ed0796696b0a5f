"""The plain reference agrees with the port's plain path (the port's CPU
path, not its kernels) at a small size: frames bit for bit, and a fit's
first steps to float rounding."""

import pytest
import torch

from portbench import inputs
from portbench.kinds import adam_steps
from portbench.reference import pathtracer as pt
from portbench.tests.conftest import LIT_SCENE

SCENES = pytest.mark.parametrize("scene", [None, LIT_SCENE], ids=["scene2", "lit"])


@SCENES
def test_reference_frame_equals_the_ports_plain_frame(small, scene):
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    from ray_tracing_tpu_torch.ops.cubemap import CubemapData
    from ray_tracing_tpu_torch.render.camera import Camera
    from ray_tracing_tpu_torch.scene.parser import parse_scene_string

    cell = small("scene2.render", scene)
    cfg = cell.config
    sky = inputs.make_sky(cfg["sky"], "cpu")
    s = cfg["sky"]["size"]
    scene = parse_scene_string(cfg["scene"], device="cpu")
    img = render_image_cuda(scene, Camera.default("cpu"), cfg["width"], cfg["height"],
                            seed=2**31 + 5, spp=3,
                            cubemap=CubemapData(sky, None, None, None, s, s), device="cpu")
    ref = pt.render(pt.make_scene(cfg["scene"], "cpu"), inputs.reference_frame(cfg, sky),
                    2**31 + 5, 3)
    assert torch.equal(img, ref)


@SCENES
def test_reference_fit_follows_the_ports_train_step(small, scene):
    cell = small("scene2.train", scene)
    load = adam_steps.Load(cell.config, cell.traffic, 77, torch.device("cpu"))
    load.setup()
    numbers = load.check()
    assert all(v < 1e-5 for v in numbers.values()), numbers
