"""The port's bench (ray_tracing_tpu_torch/bench.py) and entry point
(ray_tracing_tpu_torch/entry.py) on the CPU, at a small size: the plain
PyTorch path, which measures no peak.

Tolerances: the ray accounting and the JSON line's arithmetic are exact;
entry(device="cpu") must return the port's render_image frame bit for bit
(that function is held against the JAX integrator in test_torch_slice.py).
"""

import json

import pytest

import torch

from ray_tracing_tpu.config import RenderConfig as JCfg

from ray_tracing_tpu_torch import bench
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.entry import entry
from ray_tracing_tpu_torch.ops.cubemap import constant_sky
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import SCENE_2_TEXT

SMALL = dict(width=16, height=8, config=RenderConfig(bounces=2, shadow_samples=1),
             spp_fwd=2, spp_bwd=2, sky_size=16)


@pytest.fixture(scope="module")
def result():
    return bench.run(device="cpu", **SMALL)


def test_bench_line_on_the_cpu(result):
    line = result["line"]
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    json.dumps(line)
    m = line["metric"]
    for part in ("bwd_mode=fetch", "fwd-only", "const-sky fwd", "env: dispatch",
                 "synthetic checker skybox", "device cpu", "no peak"):
        assert part in m, part
    rays = 16 * 8 * 2 * (1 + 1)  # width x height x bounces x (1 + shadow samples)
    assert line["value"] == rays / result["seconds_per_sample"]["fwd_bwd"] / 1e6 > 0
    assert line["vs_baseline"] == line["value"] / 290.6
    assert line["unit"] == "Mrays/s"


def test_bench_counts_the_fetch_forward_once(result):
    """fwd+bwd counts one forward in fetch (the backward starts from the
    recorded indices) and two in the replay modes."""
    cfg = SMALL["config"]
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    fetch = bench.flops_per_pixel(scene, cfg, "fetch")
    replay = bench.flops_per_pixel(scene, cfg, "replay")
    assert fetch == result["census_flops_per_px"]
    assert fetch["fwd"] == replay["fwd"] > 0
    assert replay["fwd_bwd"] > 2 * replay["fwd"] and fetch["fwd_bwd"] > fetch["fwd"]


def test_bench_ray_accounting_equals_jax():
    from ray_tracing_tpu.utils.profiling import traces_per_sample as jtraces

    from ray_tracing_tpu_torch.utils.profiling import traces_per_sample

    assert traces_per_sample(RenderConfig()) == jtraces(JCfg()) == 40
    assert bench.REF_CPU_MRAYS_32T == 290.6
    assert (bench.WIDTH, bench.HEIGHT, bench.SPP_FWD, bench.SPP_BWD) == (1920, 1080, 32, 8)


def test_peak_self_check_is_tried_then_refused():
    calls = []

    def measure(device=None):
        calls.append(device)
        return {"flops_per_s": 1.0, "ratio": [1.0, 2.0][min(len(calls) - 1, 1)]}

    assert bench.checked_peak(measure, "d")["ratio"] == 2.0 and len(calls) == 2

    def broken(device=None):
        return {"flops_per_s": 1.0, "ratio": 1.1}

    with pytest.raises(RuntimeError):
        bench.checked_peak(broken, "d")


def test_bench_without_a_card_fails(monkeypatch):
    """No card: the command raises, and prints no line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench.main([])


def test_entry_cpu_is_the_plain_constant_sky_render():
    fn, args = entry(device="cpu")
    img = fn(*args)
    assert tuple(img.shape) == (480, 640, 3)
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    from ray_tracing_tpu_torch.render.camera import Camera

    want = render_image(scene, Camera.default("cpu"), 640, 480, 0, spp=1,
                        cubemap=constant_sky((0.6, 0.7, 0.9), device="cpu"), device="cpu")
    assert torch.equal(img, want)


def test_entry_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry()
