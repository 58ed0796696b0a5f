"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
small size, once for each fault the cell can have. The sound program comes
out correct at the same size."""

import pytest
import torch

from portbench import faults
from portbench.run import run_cell

RENDER_FAULTS = {"stale frame (state unchanged)": faults.stale_frame,
                 "half the samples": faults.half_samples,
                 "frame drawn from another seed (answer altered)": faults.wrong_seed}


def _render_fault(wrap):
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    return {"render_fault": wrap(render_image_cuda)}


TRAIN_FAULTS = {"state unchanged": {"optimizer_fault": faults.frozen_state},
                "half the batch": {"spp_fault": 1},
                "gradients altered": {"optimizer_fault": faults.halved_gradients}}


@pytest.mark.parametrize("name", ["scene2.render"])
@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_render_fault_is_not_correct(small, name, fault):
    result = run_cell(small(name), 2**31 + 3, 0.5, False, torch.device("cpu"),
                      faults=_render_fault(RENDER_FAULTS[fault]))
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_not_correct(small, fault):
    result = run_cell(small("scene2.train"), 2**31 + 3, 0.5, False, torch.device("cpu"),
                      faults=TRAIN_FAULTS[fault])
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("name", ["scene2.render", "scene2.train"])
def test_sound_program_is_correct(small, name):
    result = run_cell(small(name), 2**31 + 3, 0.5, False, torch.device("cpu"))
    assert result["correct"] is True, result["compared"]
