"""The readers of the program's spans (program_spans.py) on a made-up slice:
spans, idle gaps and the host's launch calls whose numbers are worked out
by hand; a span on a second thread nested by time; no spans from a program
without the recorder. On the card: each new metric in a traced run of its
cell."""

import json
import math
import subprocess
import sys
import types

import pytest

from portbench import harness, program_spans
from portbench.tests.conftest import ROOT
from portbench.trace import Trace

MAIN, AUTOGRAD = 101, 202

# name -> (cell, value on the made-up slice of that cell)
NEW_METRICS = {
    "tile_job_host_ms.render.scene2": ("scene2.render", (90 + 290) / 2 * 1e-6),
    "sky_compose_host_ms.render.scene2": ("scene2.render", (250 + 100 + 300 + 100) / 2 * 1e-6),
    "sky_compose_launches.render.scene2": ("scene2.render", 4 / 2),
    "idle_in_sky_compose_share.render.scene2": ("scene2.render", 200 / 1000 * 100),
    "step_forward_host_ms.train.scene2": ("scene2.train", (350 + 300) / 2 * 1e-6),
    "step_backward_host_ms.train.scene2": ("scene2.train", (450 + 400) / 2 * 1e-6),
    "step_optimizer_host_ms.train.scene2": ("scene2.train", (100 + 50) / 2 * 1e-6),
    "idle_in_backward_share.train.scene2": ("scene2.train", 300 / 500 * 100),
}


def rows(spec):
    """SpanRecorder rows from (name, start, end, thread, parent)."""
    return [(n, s, e, t, p, {}) for n, s, e, t, p in spec]


RENDER_SPANS = rows([
    ("render_image", 1000, 2000, MAIN, -1),
    ("tile_job", 1010, 1100, MAIN, 0),
    ("kernel.megakernel_fwd", 1100, 1150, MAIN, 0),
    ("sky_lookup", 1150, 1400, MAIN, 0),
    ("compose", 1400, 1500, MAIN, 0),
    ("average", 1900, 2000, MAIN, 0),
    ("render_image", 3000, 4000, MAIN, -1),
    ("tile_job", 3010, 3300, MAIN, 6),
    ("sky_lookup", 3300, 3600, MAIN, 6),
    ("compose", 3600, 3700, MAIN, 6),
])
RENDER_TRACE = Trace(
    ops=[], window_ns=(1000, 4000), busy_ns=2000,
    gaps=[(1160, 1240), (1420, 1460), (2100, 2900), (3310, 3390)],
    host_ops=[(1120, 1125, "cudaLaunchKernel"), (1200, 1205, "cudaLaunchKernel"),
              (1210, 1215, "cudaMemcpyAsync"), (1450, 1455, "cudaLaunchKernel"),
              (3350, 3355, "cudaLaunchKernel"), (3650, 3655, "cudaLaunchKernel"),
              (3800, 3805, "cudaLaunchKernel")],
    spans=[], units=2)

TRAIN_SPANS = rows([
    ("train_step", 0, 1000, MAIN, -1),
    ("step.params", 0, 50, MAIN, 0),
    ("step.forward", 50, 400, MAIN, 0),
    ("render_image", 60, 390, MAIN, 2),
    ("step.loss", 400, 450, MAIN, 0),
    ("step.backward", 450, 900, MAIN, 0),
    ("kernel.megakernel_bwd_fetch", 500, 600, AUTOGRAD, -1),   # autograd's thread
    ("kernel.megakernel_bwd_fetch", 650, 700, AUTOGRAD, -1),
    ("step.optimizer", 900, 1000, MAIN, 0),
    ("kernel.megakernel_bwd_fetch", 1500, 1600, AUTOGRAD, -1),  # in no step
    ("train_step", 2000, 3000, MAIN, -1),
    ("step.params", 2000, 2050, MAIN, 10),
    ("step.forward", 2050, 2350, MAIN, 10),
    ("step.loss", 2350, 2400, MAIN, 10),
    ("step.backward", 2400, 2800, MAIN, 10),
    ("kernel.megakernel_bwd_fetch", 2500, 2600, AUTOGRAD, -1),
    ("step.optimizer", 2800, 2850, MAIN, 10),
])
TRAIN_TRACE = Trace(
    ops=[], window_ns=(0, 3000), busy_ns=2500,
    gaps=[(500, 700), (1200, 1400), (2550, 2650)],   # middles 600, 1300, 2600
    host_ops=[(550, 555, "cudaLaunchKernel")], spans=[], units=2)


@pytest.fixture
def program(monkeypatch):
    """Stands the made-up spans in for the program's recorder."""
    from ray_tracing_tpu_torch.utils import profiling

    def use(spans):
        monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    return use


def ctx(trace):
    return types.SimpleNamespace(trace=trace, spans={}, readings={}, work={})


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_each_new_metric_reads_the_made_up_slice(program, name):
    cell, want = NEW_METRICS[name]
    render = cell == "scene2.render"
    program(RENDER_SPANS if render else TRAIN_SPANS)
    got = harness.metric_reader(ROOT, name)(ctx(RENDER_TRACE if render else TRAIN_TRACE))
    assert got == pytest.approx(want, rel=1e-12)


def test_a_span_on_another_thread_is_nested_by_time(program):
    spans = program_spans.Spans(TRAIN_SPANS, "train_step")
    assert spans.units == [0, 10]
    assert [spans.parent[i] for i in (6, 7, 9, 15)] == [5, 5, -1, 14]
    assert {i: spans.unit_of.get(i) for i in (6, 7, 9, 15)} == {6: 0, 7: 0, 9: None, 15: 10}
    # in no step: left out; inside step.backward: not counted twice
    kernel = ("kernel.megakernel_bwd_fetch",)
    program(TRAIN_SPANS)
    assert program_spans.host_ms_per_unit(ctx(TRAIN_TRACE), "train_step", kernel) == \
        pytest.approx((100 + 50 + 100) / 2 * 1e-6)
    assert spans.outermost(("step.backward",) + kernel) == [5, 14]
    assert program_spans.launches_per_unit(ctx(TRAIN_TRACE), "train_step", kernel) == 0.5


def test_nested_spans_of_one_name_set_count_once():
    spans = program_spans.Spans(TRAIN_SPANS, "train_step")
    assert spans.outermost(("step.forward", "render_image")) == [2, 12]
    assert spans.intervals(("step.forward", "step.loss")) == [(50, 450), (2050, 2400)]


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_nothing_to_read_gives_none(program, monkeypatch, name):
    from ray_tracing_tpu_torch.utils import profiling

    trace = RENDER_TRACE if NEW_METRICS[name][0] == "scene2.render" else TRAIN_TRACE
    read = harness.metric_reader(ROOT, name)
    assert read(ctx(None)) is None                  # nothing traced
    program([])
    assert read(ctx(trace)) is None                 # the recorder kept nothing
    monkeypatch.delattr(profiling, "recorded")
    assert read(ctx(trace)) is None                 # a program without the recorder


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["scene2.render", "scene2.train"])
def test_each_new_metric_is_in_a_traced_run_on_the_card(card, cell):
    """At the benchmark's own run length: in a short window the profiler's
    first start (seconds) can outlast the window, and the slice is empty."""
    seconds = harness.load_json(ROOT / "BENCHMARK.json")["run_seconds"]
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2**31 + 29), "--seconds", str(seconds), "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    for name, (c, _) in NEW_METRICS.items():
        if c == cell:
            assert math.isfinite(result["metrics"][name]["value"]), name
