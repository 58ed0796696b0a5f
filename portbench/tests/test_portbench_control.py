"""The control, the plain reference in bfloat16 put in the program's place,
comes out not correct under each cell's limits (at a size a test run
holds; on the card at the cells' own size: calibrate.py)."""

import pytest
import torch

from portbench import harness
from portbench.kinds import adam_steps


@pytest.mark.parametrize("name", ["scene2.render"])
@pytest.mark.parametrize("seed", [3, 2**31 + 8, 40])
def test_frames_control_is_not_correct(small, name, seed):
    cell = small(name)
    load = harness.load_kind("frames")(cell.config, cell.traffic, seed, torch.device("cpu"))
    load.setup()
    load.window(harness.Window(0.3))
    correct, compared = harness.judge(load.check(frames=load.control_frames()), cell.limits)
    assert not correct, compared


@pytest.mark.parametrize("seed", [3, 2**31 + 8, 40])
def test_train_control_is_not_correct(small, seed):
    cell = small("scene2.train")
    load = adam_steps.Load(cell.config, cell.traffic, seed, torch.device("cpu"))
    load.setup()
    ref = load.follow()
    numbers = adam_steps.compare(load.follow(torch.bfloat16), ref, load.fields)
    correct, compared = harness.judge(numbers, cell.limits)
    assert not correct, compared
