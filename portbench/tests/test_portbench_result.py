"""A run's last line carries exactly its keys (correct, attempted,
failed, metrics, device; breakdown when traced), the compared
numbers last; without a card the command prints no result."""

import io
import json
import contextlib

import pytest
import torch

from portbench import run
from portbench.tests.conftest import CELLS

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_its_keys(small, name):
    cell = small(name)
    result = run.run_cell(cell, 2**31 + 11, 0.5, False, torch.device("cpu"))
    assert list(result) == KEYS
    line = json.dumps(result)
    assert "\n" not in line and json.loads(line) == result
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["compared"]) == set(cell.limits)
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0


def test_traced_run_on_the_cpu_leaves_device_metrics_out(small):
    """No device trace on the CPU: only the spans' and the window's
    readings are read."""
    result = run.run_cell(small("scene2.render"), 3, 0.5, True, torch.device("cpu"))
    assert set(result["metrics"]) == {"enqueue_ms.render.scene2", "frame_ms.scene2",
                                      "frame_p95_ms.scene2"}
    assert "breakdown" not in result and list(result)[-1] == "compared"


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "scene2.render", "--seed", "1", "--seconds", "1"])
    assert rc == 3 and out.getvalue() == ""


def test_train_window_runs_fits_of_fit_steps(small):
    """Every `fit_steps` steps the fit starts again: leaves at the start,
    Adam's state empty, so no leaf has taken more than `fit_steps` steps."""
    from portbench import harness
    from portbench.kinds import adam_steps

    cell = small("scene2.train")
    cell.traffic = {**cell.traffic, "fit_steps": 3}
    load = adam_steps.Load(cell.config, cell.traffic, 5, torch.device("cpu"))
    load.setup()
    load.window(harness.Window(2.0))
    assert load.attempted >= 2 and load.failed == 0
    for x in load.params["scene"].values():
        state = load.optimizer.state.get(x)
        assert state is None or int(state["step"]) <= 3
