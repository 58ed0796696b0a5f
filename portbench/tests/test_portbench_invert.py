"""The scene2.fit_invert cell on the CPU at a small size: its reference
(reference/invert.py) against the port's plain path, the control and each
planted fault not correct, the sound program correct, the float sky the
port's gradient_sky texel for texel, sky_work.py's counts against a hand
count, and the reference importing nothing of the port or of JAX."""

import json
import math
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness, sky_work
from portbench.kinds import adam_steps, invert_steps
from portbench.reference import invert as ref_invert
from portbench.reference.pathtracer import V
from portbench.run import Context, run_cell
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_faults import TRAIN_FAULTS
from portbench.tests.test_portbench_program_spans import MAIN, rows
from portbench.trace import DeviceOp, Trace

CELL = "scene2.fit_invert"


def small_invert(width=24, height=16):
    """The cell at 24x16 (invert's 4 samples, sky and physics): what a test
    run on the CPU holds. Its limits are the cell's own."""
    cell = harness.find_cell(ROOT, CELL)
    cell.config = {**cell.config, "width": width, "height": height}
    return cell


def test_cell_found_by_name():
    cell = harness.find_cell(ROOT, CELL)
    assert (cell.config["width"], cell.config["height"]) == (96, 64)
    assert cell.config["physics"]["env_filter"] == "bilinear"
    assert harness.load_kind(cell.traffic["kind"]) is invert_steps.Load
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_GiB"}
    assert len(cell.per_layer) == 14
    for m in cell.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]))
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}


def test_the_sky_is_the_ports_gradient_sky():
    from ray_tracing_tpu_torch.ops.cubemap import gradient_sky

    want = gradient_sky(32, device="cpu")
    got = invert_steps.make_sky({"kind": "gradient", "size": 32}, "cpu")
    assert all(torch.equal(a, b) for a, b in ((got.r, want.r), (got.g, want.g),
                                              (got.b, want.b)))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_follows_the_ports_plain_fit(seed):
    """The port's plain path (the CPU's: tile_physics, the sky compose's
    plain twin, the composite) against the reference: the losses and the
    p0 gradient to float rounding."""
    cell = small_invert()
    load = invert_steps.Load(cell.config, cell.traffic, seed, torch.device("cpu"))
    load.setup()
    ref = load.follow()
    assert max(abs(a - b) / abs(b) for a, b in zip(load.losses, ref["losses"])) < 1e-6
    g, want = load.first_grad["p0"], ref["first_grad"]["p0"]
    assert float(want.abs().max()) > 0
    assert torch.allclose(g, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    assert all(v < 1e-5 for v in load.check(ref=ref).values())


@pytest.mark.parametrize("seed", [3, 2**31 + 8])
def test_control_is_not_correct(seed):
    cell = small_invert()
    load = invert_steps.Load(cell.config, cell.traffic, seed, torch.device("cpu"))
    load.setup()
    numbers = adam_steps.compare(load.follow(torch.bfloat16), load.follow(), load.fields)
    correct, compared = harness.judge(numbers, cell.limits)
    assert not correct, compared


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_planted_fault_is_not_correct(fault):
    faults = TRAIN_FAULTS[fault]
    if "spp_fault" in faults:
        faults = {"spp_fault": 2}  # half of invert's 4 samples
    result = run_cell(small_invert(), 2**31 + 3, 0.5, False, torch.device("cpu"), faults=faults)
    assert result["correct"] is False, result["compared"]


def test_sound_program_is_correct():
    result = run_cell(small_invert(), 2**31 + 3, 0.5, False, torch.device("cpu"))
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"peak_mem_GiB", "setup_s"}


def test_traced_run_on_the_cpu_leaves_device_metrics_out():
    """No device trace on the CPU: the window's step time and the host's
    time in the step's call alone are read; the span readers find no trace
    and return None."""
    result = run_cell(small_invert(), 3, 0.5, True, torch.device("cpu"))
    assert set(result["metrics"]) == {"train_step_ms.scene2_invert",
                                      "enqueue_ms.scene2_invert"}


def test_work_bounds_k2_k3_and_the_bilinear_arms():
    """work() gives the bounds of K2 and K3, as adam_steps counts them, and
    of the two bilinear arms; scene_2 has no light, so K2 casts no shadow
    ray and its bytes are the scene, the ten planes and 3 index planes."""
    cell = small_invert()
    load = invert_steps.Load(cell.config, cell.traffic, 7, torch.device("cpu"))
    load.setup()
    work = load.work()
    assert set(work) == {"k2", "k3", "sky_bilinear", "sky_bilinear_adjoint"}
    assert all(w["bound_s"] > 0 and w["flops"] > 0 for w in work.values())
    # scene_2's three rows and the camera's, the ten planes and one index
    # plane a bounce
    assert work["k2"]["bytes"] == (3 + 1) * 64 + (10 + 3) * 24 * 16 * 4


def test_window_reads_each_fits_losses_when_it_ends(monkeypatch):
    """Every `fit_steps` steps the fit starts again and its losses are read:
    no read holds more than `fit_steps` losses, every step's loss is read
    once, and no leaf takes more than `fit_steps` steps."""
    cell = small_invert()
    cell.traffic = {**cell.traffic, "fit_steps": 3}
    load = invert_steps.Load(cell.config, cell.traffic, 5, torch.device("cpu"))
    load.setup()
    reads, stack, step, losses, kept = [], torch.stack, load.step, set(), []

    def spy_step(*a, **k):
        loss = step(*a, **k)
        kept.append(loss)  # alive, so that no other tensor takes its id
        losses.add(id(loss))
        return loss

    def spy(tensors, *a, **k):
        if tensors and all(id(t) in losses for t in tensors):
            reads.append(len(tensors))
        return stack(tensors, *a, **k)

    load.step = spy_step
    monkeypatch.setattr(invert_steps.torch, "stack", spy)
    load.window(harness.Window(2.0))
    assert load.attempted >= 4 and load.failed == 0
    assert sum(reads) == load.attempted and max(reads) <= 3 and len(reads) >= 2
    for x in load.params["scene"].values():
        state = load.optimizer.state.get(x)
        assert state is None or int(state["step"]) <= 3


def test_sky_work_equals_a_hand_count_at_8x6():
    """Half of an 8x6 frame looks down +z, half down +x: each direction's
    u = v = 0 lands at texel 15.5 of the 32-texel face, so corners x, y in
    {15, 16}: on face 0 the flat texels 495, 496, 527, 528 (32-byte sectors
    61, 62, 65, 66), on face 3 (right) 3567, 3568, 3599, 3600 (sectors 445,
    446, 449, 450); 8 sectors a plane, 24 over the three."""
    ones, zeros = torch.ones(6, 8), torch.zeros(6, 8)
    right = torch.arange(8) >= 4
    d = V(torch.where(right, ones, zeros), zeros, torch.where(right, zeros, ones))
    corners, wx, wy = ref_invert.bilinear_corners(32, d)
    assert [int(k[0, 0]) for k in corners] == [495, 496, 527, 528]
    assert [int(k[0, 7]) for k in corners] == [3567, 3568, 3599, 3600]
    assert bool((wx == 0.5).all() and (wy == 0.5).all())
    sectors = sky_work.sectors(32, d, planes=3)
    assert sectors == 24
    fwd, adj = sky_work.forward(48, sectors, 3 / 4), sky_work.adjoint(48, sectors)
    assert fwd["bytes"] == 48 * (80 + 12 * 3 / 4) + 24 * 32 == 5040
    assert adj["bytes"] == 48 * 80 + 24 * 32 == 4608
    assert fwd["flops"] == 48 * 51 and adj["flops"] == 48 * 100
    assert fwd["bound_by"] == adj["bound_by"] == "bytes"


def test_roofline_readers_find_their_kernels():
    """The two readers match the bilinear arms by name, demangled or
    mangled, and no other kernel; nothing traced, nothing read."""
    fwd = "void (anonymous namespace)::sky_compose_bilinear_kernel(float const*, int)"
    adj = "_ZN12_GLOBAL__N_135sky_compose_bilinear_adjoint_kernelEPKfPKi"
    other = "void (anonymous namespace)::sky_compose_kernel(float const*)"
    ops = [DeviceOp(fwd, "kernel", 0, 100), DeviceOp(adj, "kernel", 200, 400),
           DeviceOp(other, "kernel", 500, 600)]
    trace = Trace(ops, (0, 600), 400, [], [], [], 1)
    work = {"sky_bilinear": {"bound_s": 50e-9}, "sky_bilinear_adjoint": {"bound_s": 150e-9}}
    ctx = Context(trace, {}, {}, work)
    read = {m: harness.metric_reader(ROOT, m)(ctx) for m in (
        "sky_bilinear_roofline.scene2_invert", "sky_bilinear_adjoint_roofline.scene2_invert")}
    assert read == pytest.approx({"sky_bilinear_roofline.scene2_invert": 50.0,
                                  "sky_bilinear_adjoint_roofline.scene2_invert": 75.0})
    ctx = Context(None, {}, {}, work)
    assert all(harness.metric_reader(ROOT, m["name"])(ctx) is None
               for m in harness.find_cell(ROOT, CELL).per_layer
               if m["name"] != "train_step_ms.scene2_invert")


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import json, sys\nimport portbench.reference.invert\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"ray_tracing_tpu_torch", "ray_tracing_tpu", "jax", "jaxlib", "flax"}


# a made-up step: the fused compose a sample (one launch each), then the
# soft silhouettes with two launches
STEP_SPANS = rows([
    ("train_step", 0, 1000, MAIN, -1),
    ("step.forward", 0, 600, MAIN, 0),
    ("render_image", 10, 590, MAIN, 1),
    ("compose", 100, 150, MAIN, 2),
    ("compose", 200, 250, MAIN, 2),
    ("average", 300, 580, MAIN, 2),
    ("soft_silhouettes", 310, 570, MAIN, 5),
])
STEP_TRACE = Trace(ops=[], window_ns=(0, 1000), busy_ns=500, gaps=[],
                   host_ops=[(120, 121, "cudaLaunchKernel"), (220, 221, "cudaLaunchKernel"),
                             (400, 401, "cudaLaunchKernel"), (500, 501, "cudaLaunchKernel")],
                   spans=[], units=1)


def test_span_readers_read_a_made_up_step_and_nothing_without_the_span(monkeypatch):
    """On a made-up step the span readers read their spans; a program whose
    spans hold no "soft_silhouettes" (one from before that span) gives no
    number for the two soft-silhouette metrics, and still the launches in
    the compose spans."""
    from ray_tracing_tpu_torch.utils import profiling

    names = ("sky_compose_launches", "soft_silhouette_host_ms", "soft_silhouette_launches")
    ctx = types.SimpleNamespace(trace=STEP_TRACE, spans={}, readings={}, work={})

    def read_all(spans):
        monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
        return {n: harness.metric_reader(ROOT, f"{n}.scene2_invert")(ctx) for n in names}

    assert read_all(STEP_SPANS) == pytest.approx(
        {"sky_compose_launches": 2, "soft_silhouette_host_ms": 260e-6,
         "soft_silhouette_launches": 2})
    assert read_all(STEP_SPANS[:-1]) == {"sky_compose_launches": 2,
                                         "soft_silhouette_host_ms": None,
                                         "soft_silhouette_launches": None}


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card_with_every_metric(card):
    """An untraced run is correct; a traced run at the benchmark's run
    length reads every per-layer metric, the roofline shares at 105 % or
    less."""
    seconds = harness.load_json(ROOT / "BENCHMARK.json")["run_seconds"]
    cell = harness.find_cell(ROOT, CELL)
    for traced, run_s in ((0, 2), (1, seconds)):
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                              "--seed", str(2**31 + 31), "--seconds", str(run_s),
                              "--trace", str(traced)],
                             cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True, result["compared"]
        assert result["device"]["platform"] == "gpu"
    for m in cell.per_layer:
        value = result["metrics"][m["name"]]["value"]
        assert math.isfinite(value), m["name"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert 0 < value <= 105, (m["name"], value)
