"""The objects1024.render cell: the upstream's largest scene (1,024 objects,
one light) at 1920x1080 and 2 samples a frame. Found by name with its
readers and limits; the port's plain frame equals the plain reference's
bit for bit on the configuration cut to 64 objects (more than the 32 rows
that the kernels stage in one warp); the K1 reader on a made-up slice; on
the card, the cell runs correct and its traced run reports every new
metric; its untraced run reports the window's frame_ms end to end."""

import json
import math
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness, inputs
from portbench.reference import pathtracer as pt
from portbench.tests.conftest import ROOT
from portbench.trace import DeviceOp, Trace

CELL = "objects1024.render"
NEW_METRICS = ("device_idle_share.render.objects1024", "k1_ps_per_pixel_object.objects1024")


def test_the_cell_is_found_by_name():
    cell = harness.find_cell(ROOT, CELL)
    cfg = cell.config
    assert (cfg["width"], cfg["height"], cfg["reduced"]) == (1920, 1080, [])
    assert cfg["sky"] == {"kind": "checker", "size": 2048} and cfg["precision"] == "float32"
    assert cell.traffic["kind"] == "frames" and cell.traffic["spp"] == 2
    assert harness.load_kind(cell.traffic["kind"]).__name__ == "Load"
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "setup_s", "peak_mem_GiB"}
    assert [m["name"] for m in cell.per_layer] == list(NEW_METRICS)
    assert {m["moves"] for m in cell.per_layer} == {"frame_ms"}
    for m in cell.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]))
    assert set(cell.limits) == {"frame_mean_abs_err", "frame_px_off_share"}
    assert cell.chips == 1


def test_the_scene_is_the_large_scene_with_one_light():
    scene = pt.make_scene(harness.find_cell(ROOT, CELL).config["scene"], "cpu")
    assert scene.n == 1024 and scene.light == 1023
    assert int((scene.fields["emission_power"] > 0).sum()) == 1
    assert sum(scene.is_sphere) == 1024 - 341        # every third of the 1,023 a cube


def test_the_ports_plain_frame_equals_the_reference_on_64_objects(small):
    """The configuration's camera and physics at 32x24 with a 64-texel sky,
    on large_scene_objects(64): 63 objects and the light, so the shadow
    rays take the occlusion trace and the box tests run."""
    from ray_tracing_tpu_torch.config import RenderConfig
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    from ray_tracing_tpu_torch.ops.cubemap import CubemapData
    from ray_tracing_tpu_torch.render.camera import Camera
    from ray_tracing_tpu_torch.scene.parser import parse_scene_string, write_scene_string
    from ray_tracing_tpu_torch.scene.synthetic import large_scene_objects

    cell = small(CELL, write_scene_string(large_scene_objects(64)))
    cfg = cell.config
    sky = inputs.make_sky(cfg["sky"], "cpu")
    s = cfg["sky"]["size"]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32)

    cam = cfg["camera"]
    camera = Camera(pos=vec(cam["pos"]), front=vec(cam["front"]), up=vec(cam["up"]),
                    yaw=vec(-90.0), pitch=vec(0.0))
    seed = 2**31 + 23
    img = render_image_cuda(parse_scene_string(cfg["scene"], device="cpu"), camera,
                            cfg["width"], cfg["height"], seed=seed, spp=cell.traffic["spp"],
                            config=RenderConfig(**cfg["physics"]),
                            cubemap=CubemapData(sky, None, None, None, s, s), device="cpu")
    ref = pt.render(pt.make_scene(cfg["scene"], "cpu"), inputs.reference_frame(cfg, sky),
                    seed, cell.traffic["spp"])
    assert torch.equal(img, ref)


# A made-up traced slice of two frames: K1 launches of 2 and 3 us, one K2
# launch and a sky kernel that the reader leaves out.
K1 = "void fwd_kernel<false>(Params, float const*, float const*, float*)"
K2 = "void fwd_kernel<true>(Params, float const*, float const*, float*, signed char*)"
TRACE = Trace(ops=[DeviceOp(K1, "kernel", 0, 2000), DeviceOp("sky_compose_kernel", "kernel",
                                                                2000, 2500),
                   DeviceOp(K1, "kernel", 3000, 6000), DeviceOp(K2, "kernel", 7000, 9000)],
              window_ns=(0, 9000), busy_ns=7500, gaps=[], host_ops=[], spans=[], units=2)
LAUNCH = {"pixels": 100, "objects": 1024, "shadow_samples": 3, "occlusion": 1}


def spans(counts):
    return [("render_image", 0, 3000, 1, -1, {"pixels": 100, "samples": 1}),
            ("kernel.megakernel_fwd", 100, 200, 1, 0, dict(counts)),
            ("render_image", 3000, 9000, 1, -1, {"pixels": 100, "samples": 1}),
            ("kernel.megakernel_fwd", 3100, 3200, 1, 2, dict(counts))]


def ctx(trace):
    return types.SimpleNamespace(trace=trace, spans={}, readings={"frame_ms": 61.5}, work={})


def test_the_k1_reader_divides_k1_time_by_pixels_and_objects(monkeypatch):
    from ray_tracing_tpu_torch.utils import profiling

    read = harness.metric_reader(ROOT, "k1_ps_per_pixel_object.objects1024")
    monkeypatch.setattr(profiling, "recorded", lambda: spans(LAUNCH))
    # 5,000 ns of K1 over 2 launches of 100 pixels x 1,024 objects
    assert read(ctx(TRACE)) == pytest.approx(5000e-9 / (2 * 100 * 1024) * 1e12, rel=1e-12)
    assert harness.metric_reader(ROOT, "device_idle_share.render.objects1024")(ctx(TRACE)) \
        == pytest.approx(100 / 6, rel=1e-12)


class WindowOf61ms:
    """A frames load whose window reads frame_ms 61.5, in place of the
    card's, for the result line of an untraced run."""

    def __init__(self, config, traffic, seed, device):
        self.attempted, self.info = 0, {}

    def setup(self):
        pass

    def window(self, win):
        win.open()
        self.attempted = 2
        return {"frame_ms": 61.5, "frame_p95_ms": 120.0}

    def release(self):
        pass

    def check(self):
        return {"frame_mean_abs_err": 0.0, "frame_px_off_share": 0.0}


def test_an_untraced_run_reports_the_windows_frame_ms_end_to_end(monkeypatch):
    from portbench import run

    monkeypatch.setattr(harness, "load_kind", lambda kind: WindowOf61ms)
    result = run.run_cell(harness.find_cell(ROOT, CELL), 2**31 + 3, 0.1, False,
                          torch.device("cpu"))
    assert set(result["metrics"]) == {"frame_ms", "peak_mem_GiB", "setup_s"}
    assert result["metrics"]["frame_ms"] == {"value": 61.5, "unit": "ms"}
    assert "frame_ms.objects1024" not in result["metrics"] and result["correct"] is True


def test_the_k1_reader_finds_nothing_on_a_program_without_the_counts(monkeypatch):
    from ray_tracing_tpu_torch.utils import profiling

    read = harness.metric_reader(ROOT, "k1_ps_per_pixel_object.objects1024")
    assert read(ctx(None)) is None                                  # nothing traced
    monkeypatch.setattr(profiling, "recorded", lambda: spans({}))
    assert read(ctx(TRACE)) is None                                 # spans without counts
    monkeypatch.setattr(profiling, "recorded", lambda: [])
    assert read(ctx(TRACE)) is None                                 # no spans kept
    monkeypatch.delattr(profiling, "recorded")
    assert read(ctx(TRACE)) is None                                 # no recorder


def _run(trace: int, seconds) -> dict:
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", str(2**31 + 41), "--seconds", str(seconds),
                          "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"
    return result


@pytest.mark.gpu
def test_the_cell_runs_correct_on_the_card(card):
    result = _run(0, 2)
    assert set(result["metrics"]) == {"frame_ms", "peak_mem_GiB", "setup_s"}


@pytest.mark.gpu
def test_each_new_metric_is_in_a_traced_run_on_the_card(card):
    result = _run(1, harness.load_json(ROOT / "BENCHMARK.json")["run_seconds"])
    for name in NEW_METRICS:
        assert math.isfinite(result["metrics"][name]["value"]), name
