"""The port's spans (utils/profiling.py::span) on the CPU: what a frame and a
train step record under torch.profiler, and that nothing is recorded, and
nothing changes, without one.

Exact: the span tree of a frame and of a train step (names, parents,
counts), the texels the plain sky lookup counts, the cap's drops, and the
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
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import Scene
from ray_tracing_tpu_torch.utils import profiling

W, H, SPP = 16, 12, 2
CPU = [torch.profiler.ProfilerActivity.CPU]


def float_sky_with_grad():
    """A float 8x8 sky whose planes require grad: render_frame keeps the
    plain lookup and compose for it (kernels/megakernel.py::
    fused_sky_compose)."""
    base = tcm.gradient_sky(8, device="cpu")
    r, g, b = (t.clone().requires_grad_(True) for t in (base.r, base.g, base.b))
    return tcm.CubemapData(None, r, g, b, base.h, base.w)


SKIES = {"constant": lambda: None, "checker": lambda: tcm.checker_sky(8, device="cpu"),
         "float_grad": float_sky_with_grad}


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


# What scene_2's forward launch counts: its pixels and three objects, and no
# shadow ray (no light), so no occlusion trace either.
SCENE_2_LAUNCH = {"pixels": W * H, "objects": 3, "shadow_samples": 0, "occlusion": 0}


def frame_tree(root=0, parent=-1, kernel="kernel.megakernel_fwd", texels=W * H, fused=True,
               soft=False, kernel_counts=None):
    """(name, parent, counts) of the spans of one SPP-sample W x H frame
    whose render_image is span number `root`, inside span `parent`; the
    kernel's span counts `kernel_counts` (scene_2's SCENE_2_LAUNCH by
    default). With
    `fused` (kernels/megakernel.py::fused_sky_compose) a sample's sky lookup
    and compose are one span "compose" that counts the texels; with `soft`
    the average holds the soft-silhouette composite's span, which counts
    scene_2's three objects and the frame's pixels."""
    k = (kernel, root, kernel_counts or SCENE_2_LAUNCH)
    if fused:
        sample = [k, ("compose", root, {"texels": texels})]
    else:
        sample = [k, ("sky_lookup", root, {"texels": texels}),
                  ("compose", root, {})]
    spans = ([("render_image", parent, {"pixels": W * H, "samples": SPP}),
              ("tile_job", root, {})] + sample * SPP + [("average", root, {})])
    if soft:
        spans.append(("soft_silhouettes", root + len(spans) - 1, {"objects": 3, "pixels": W * H}))
    return spans


def _launch_spans(scene, config, record):
    """(name, counts) of the forward launch spans of one SPP-sample frame of
    `scene` under a profiler; with `record`, of the recording launch that
    a fetch-mode gradient takes."""
    job = mk.make_tile_job(scene, Camera.default("cpu"), W, H, config)
    with torch.profiler.profile(activities=CPU):
        for s in range(SPP):
            mk.run_tiles(job, s, record=record)
    return [(name, counts) for name, _, _, _, _, counts in profiling.recorded()]


@pytest.mark.parametrize("record", [False, True], ids=["render", "record"])
@pytest.mark.parametrize("scene,config,ns,occlusion", [
    (lambda: parse_scene_string(SCENE_2_TEXT, device="cpu"), RenderConfig(), 0, 0),
    (lambda: parse_scene_string(ROOM_TEXT, device="cpu"), RenderConfig(), 3, 1),
    (lambda: Scene.from_objects(random_objects(40, seed=3, lights=(7, 8)), device="cpu"),
     RenderConfig(shadow_samples=2), 2, 0),
    (lambda: parse_scene_string(ROOM_TEXT, device="cpu"), RenderConfig(shadow_samples=0),
     0, 0),
], ids=["unlit", "one_light_occlusion", "two_lights_full_scan", "nee_off"])
def test_launch_spans_count_pixels_objects_shadow_samples_and_occlusion(
        scene, config, ns, occlusion, record):
    """Each forward launch's span counts its pixels, the scene's objects,
    the shadow samples a bounce and whether its shadow rays take the sole
    emitter's occlusion trace (1) or the full scan (0); a recording launch
    also counts its index planes' bytes."""
    sc, config = scene(), config.replace(bounces=2)
    job = mk.make_tile_job(sc, Camera.default("cpu"), W, H, config)
    want = {"pixels": W * H, "objects": sc.num_objects, "shadow_samples": ns,
            "occlusion": occlusion}
    name = "kernel.megakernel_fwd"
    if record:
        want["index_bytes"] = mk.record_bytes(job)
        name += "_record"
    assert _launch_spans(sc, config, record) == [(name, want)] * SPP


def test_untraced_launches_compute_no_span_counts(monkeypatch):
    """Without a profiler run_tiles asks for no counts: single_emissive's
    walk over the objects is paid only while spans are kept."""
    def refuse(*a, **k):
        raise AssertionError("span counts computed with no profiler running")

    monkeypatch.setattr(mk, "fwd_span_counts", refuse)
    frame()


def test_no_profiler_records_nothing():
    assert profiling.span("a", pixels=1) is profiling.span("b")
    frame()
    with profiling.span("outside"):
        pass
    assert profiling.recorded() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("sky,config,per_pixel,fused", [
    ("constant", RenderConfig(), 1, True),
    ("checker", RenderConfig(), 1, True),
    ("float_grad", RenderConfig(), 1, False),                     # the plain lookup
    ("checker", RenderConfig(env_filter="bilinear"), 4, True),    # 4 texels a pixel
])
def test_frame_records_its_span_tree(sky, config, per_pixel, fused):
    with torch.profiler.profile(activities=CPU):
        frame(sky, config)
    spans = profiling.recorded()
    assert tree(spans) == frame_tree(texels=W * H * per_pixel, fused=fused)
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
    # the recording launch counts the bytes of its index planes too: scene_2
    # has no light, so 2 planes (one a bounce) of one byte a pixel (3 objects)
    counts = {**SCENE_2_LAUNCH, "index_bytes": 2 * H * W} if mode == "fetch" else None
    head += frame_tree(root=3, parent=2, kernel=fwd, kernel_counts=counts)
    head += [("step.loss", 0, {})]
    # each sample's compose adjoint, then its megakernel's backward
    want = (head + [("step.backward", 0, {})]
            + [("kernel.sky_compose_adjoint", len(head), {}),
               ("kernel.megakernel_bwd_" + mode, len(head), {})] * SPP
            + [("step.optimizer", 0, {})])
    assert tree(profiling.recorded()) == want


@pytest.mark.parametrize("config,sky,lookup", [
    (RenderConfig(), "constant", ()),
    (RenderConfig(env_filter="bilinear", soft_silhouette_temp=0.08), "constant",
     ("soft_silhouettes",)),
    (RenderConfig(), "float_grad", ("sky_lookup",))],
    ids=["fused", "bilinear", "plain"])
def test_spans_enclose_the_aten_events_they_issued(config, sky, lookup):
    """The spans' clock is the profiler's: every aten:: event whose middle
    falls in a span starts and ends inside it, and each span that issues
    tensor work holds some (a "soft_silhouettes" span where the frame is
    blended with the soft primary visibility, a "sky_lookup" span where a
    sky that requires grad keeps the plain lookup and compose)."""
    frame(sky, config)  # the first frame's one-time work stays out of the profile
    with torch.profiler.profile(activities=CPU) as prof:
        frame(sky, config)
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
                                 "compose", "average", *lookup)), held


@pytest.mark.parametrize("sky,per_pixel", [("constant", 1), ("checker", 4)])
def test_a_soft_silhouette_frame_records_the_composite(sky, per_pixel):
    """invert's frame (the bilinear filter, soft silhouettes): one fused
    "compose" a sample counting 4 texels a pixel (1 on a 1x1 sky), and the
    composite in a span "soft_silhouettes" inside "average" counting the
    objects and the pixels."""
    cfg = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                       soft_silhouette_temp=0.08)
    with torch.profiler.profile(activities=CPU):
        frame(sky, cfg)
    assert tree(profiling.recorded()) == frame_tree(texels=W * H * per_pixel, soft=True)


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


@pytest.mark.parametrize("sky,config,texels", [
    ("checker", RenderConfig(), W * H),
    ("checker", RenderConfig(env_filter="bilinear"), 4 * W * H),
    ("constant", RenderConfig(env_filter="bilinear"), W * H),  # a 1x1 sky: one texel
])
def test_the_plain_sky_lookup_counts_its_texels(sky, config, texels):
    """sky_lookup opens its span "sky_lookup" with the texels it gathers,
    and looks the sky up as sample_cubemap does."""
    cubemap = SKIES[sky]() or tcm.constant_sky(device="cpu")
    planes = torch.randn((10, H, W), generator=torch.Generator().manual_seed(4))
    d = Vec3(planes[3], planes[4], planes[5])
    want = tcm.sample_cubemap(cubemap, d, bilinear=config.env_filter == "bilinear")
    with torch.profiler.profile(activities=CPU):
        got = mk.sky_lookup(planes, cubemap, config, W * H)
    assert torch.equal(got.to_array(), want.to_array())
    assert tree(profiling.recorded()) == [("sky_lookup", -1, {"texels": texels})]
