"""The port's spans (utils/profiling.py::span) on the CPU: what a frame and a
train step record under torch.profiler, and that nothing is recorded, and
nothing changes, without one.

Exact: the span tree of a frame and of a train step (names, parents,
counts), the texels the sparse sky lookup counts, the cap's drops, and the
frame, bit for bit, with the recorder on and off. The clock: every aten::
event whose middle falls in a span lies inside it, by the profiler's own
start_ns() and end_ns().
"""

import threading

import pytest
import torch

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import SCENE_2_TEXT
from ray_tracing_tpu_torch.utils import profiling

W, H, SPP = 16, 12, 2
CPU = [torch.profiler.ProfilerActivity.CPU]
SKIES = {"constant": lambda: None, "checker": lambda: tcm.checker_sky(8, device="cpu")}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.clear()
    yield
    profiling.clear()


def frame(sky="constant", config=RenderConfig(), seed=3):
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    return mk.render_image_cuda(scene, Camera.default("cpu"), W, H, seed=seed, spp=SPP,
                                config=config, cubemap=SKIES[sky](), device="cpu")


def tree(spans):
    return [(name, parent, counts) for name, _, _, _, parent, counts in spans]


def frame_tree(root=0, parent=-1, kernel="kernel.megakernel_fwd", texels=W * H):
    """(name, parent, counts) of the spans of one SPP-sample W x H frame
    whose render_image is span number `root`, inside span `parent`."""
    sample = [(kernel, root, {}), ("sky_lookup", root, {"texels": texels}),
              ("compose", root, {})]
    return ([("render_image", parent, {"pixels": W * H, "samples": SPP}),
             ("tile_job", root, {})] + sample * SPP + [("average", root, {})])


def test_no_profiler_records_nothing():
    assert profiling.span("a", pixels=1) is profiling.span("b")
    frame()
    with profiling.span("outside"):
        profiling.add_counts(texels=1)
    assert profiling.recorded() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("sky,config,per_pixel", [
    ("constant", RenderConfig(), 1),
    ("checker", RenderConfig(), 1),                         # the sky cache, full gather
    ("checker", RenderConfig(sky_sparse_gather=True), 1),  # 192 pixels: the full arm
    ("checker", RenderConfig(env_filter="bilinear"), 4),   # no cache, 4 texels a pixel
])
def test_frame_records_its_span_tree(sky, config, per_pixel):
    with torch.profiler.profile(activities=CPU):
        frame(sky, config)
    spans = profiling.recorded()
    assert tree(spans) == frame_tree(texels=W * H * per_pixel)
    assert all(end is not None and start <= end for _, start, end, *_ in spans)
    assert len({tid for *_, tid, _, _ in spans}) == 1


@pytest.mark.parametrize("mode,fwd", [("fetch", "kernel.megakernel_fwd_record"),
                                      ("direct", "kernel.megakernel_fwd"),
                                      ("replay", "kernel.megakernel_fwd")])
def test_train_step_records_its_span_tree(mode, fwd):
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    cfg = RenderConfig(bounces=2, shadow_samples=1, bwd_mode=mode)
    target = torch.full((H, W, 3), 0.5)
    params = {"scene": {"albedo": scene.albedo.clone().requires_grad_(True)}, "camera": {}}
    opt = torch.optim.Adam(list(params["scene"].values()), lr=0.01)
    step = inverse.make_train_step(scene, Camera.default("cpu"), opt, W, H, spp=SPP,
                                   config=cfg, device="cpu")
    with torch.profiler.profile(activities=CPU):
        step(params, target, 5)
    head = [("train_step", -1, {}), ("step.params", 0, {}), ("step.forward", 0, {})]
    head += frame_tree(root=3, parent=2, kernel=fwd) + [("step.loss", 0, {})]
    want = (head + [("step.backward", 0, {})]
            + [("kernel.megakernel_bwd_" + mode, len(head), {})] * SPP
            + [("step.optimizer", 0, {})])
    assert tree(profiling.recorded()) == want


def test_spans_enclose_the_aten_events_they_issued():
    """The spans' clock is the profiler's: every aten:: event whose middle
    falls in a span starts and ends inside it, and each span that issues
    tensor work holds some."""
    frame()  # the first frame's one-time work stays out of the profile
    with torch.profiler.profile(activities=CPU) as prof:
        frame()
    spans = profiling.recorded()
    events = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert events
    held = {name: 0 for name, *_ in spans}
    for name, s0, s1, *_ in spans:
        for e0, e1, ename in events:
            if s0 <= (e0 + e1) // 2 <= s1:
                assert s0 <= e0 and e1 <= s1, (name, ename, e0 - s0, s1 - e1)
                held[name] += 1
    assert all(held[n] for n in ("render_image", "tile_job", "kernel.megakernel_fwd",
                                 "sky_lookup", "compose", "average")), held


def test_the_cap_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "cap", 5)
    with torch.profiler.profile(activities=CPU):
        frame()
    assert tree(profiling.recorded()) == frame_tree()[:5]
    assert profiling.dropped() == len(frame_tree()) - 5
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_a_frame_is_bit_equal_with_the_recorder_on_and_off():
    off = frame("checker", seed=11)
    with torch.profiler.profile(activities=CPU):
        on = frame("checker", seed=11)
    assert len(profiling.recorded()) == len(frame_tree())
    assert torch.equal(on, off)


def test_a_span_on_another_thread_is_a_root_there():
    seen = {}

    def work():
        with profiling.span("kernel.megakernel_bwd_fetch"):
            seen["tid"] = threading.get_native_id()

    with torch.profiler.profile(activities=CPU):
        with profiling.span("step.backward"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    (outer, o0, o1, otid, _, _), (inner, i0, i1, itid, parent, _) = profiling.recorded()
    assert (outer, inner, parent) == ("step.backward", "kernel.megakernel_bwd_fetch", -1)
    assert itid == seen["tid"] != otid == threading.get_native_id()
    assert o0 <= i0 <= i1 <= o1


@pytest.mark.parametrize("size,fresh_blocks,cached_blocks,texels", [
    (4 * tcm.SPARSE_BLOCK, (0, 2), (), 2 * tcm.SPARSE_BLOCK),   # compacted, no cache
    (4 * tcm.SPARSE_BLOCK, (0, 2), (0,), tcm.SPARSE_BLOCK),     # block 0 from the cache
    (4 * tcm.SPARSE_BLOCK + 7, (0, 2), (), 4 * tcm.SPARSE_BLOCK + 7),  # the full arm
])
def test_the_sparse_sky_lookup_counts_its_texels(size, fresh_blocks, cached_blocks, texels):
    sky = tcm.checker_sky(8, device="cpu")
    flat = torch.arange(size, dtype=torch.int32) % sky.packed.numel()
    need = torch.zeros(size, dtype=torch.bool)
    for b in fresh_blocks:
        need[b * tcm.SPARSE_BLOCK:(b + 1) * tcm.SPARSE_BLOCK] = True
    valid = torch.zeros(size, dtype=torch.bool)
    for b in cached_blocks:
        valid[b * tcm.SPARSE_BLOCK:(b + 1) * tcm.SPARSE_BLOCK] = True
    cache = (flat, tcm.gather_texels(sky, flat, valid), valid) if cached_blocks else ()
    want = tcm.sparse_sky_lookup(sky, flat, need, *cache)
    with torch.profiler.profile(activities=CPU):
        with profiling.span("sky_lookup"):
            got = tcm.sparse_sky_lookup(sky, flat, need, *cache)
    assert torch.equal(got, want)
    assert tree(profiling.recorded()) == [("sky_lookup", -1, {"texels": texels})]
