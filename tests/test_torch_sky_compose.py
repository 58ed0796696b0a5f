"""One sample's sky lookup, compose and running sum as one step
(kernels/megakernel.py::sky_compose, SkyComposeFunction, csrc/sky_compose.cu)
against the plain lookup and compose it replaces (ops/cubemap.py::
sample_cubemap, kernels/megakernel.py::compose_sky) differentiated by
autograd.

Tolerance: none on frames and the cotangents of the radiance
and throughput planes, which repeat autograd's operations one for one
(the clip's tie rule included). The miss plane's cotangent sums three
channels' terms, in an order autograd does not fix: within 1e-6 of the sum
of their magnitudes, which bounds the rounding of any order of a float32
sum of three terms (about 1.2e-7 of it) where a relative error of the sum
itself has no bound (the terms may cancel). The bilinear filter's
direction cotangent sums six terms into the weight wx and three into wy
(in the order autograd adds them, but that order is autograd's to change)
and takes them through face_uv's divisions: within 2e-6 of a bound on the
magnitudes of everything it sums (ops/cubemap.py::bilinear_adjoint_scale),
which covers five roundings of a reordered six-term sum and four more on
the way (9 eps, about 1.1e-6).

The tests at the end need the card (marker `gpu`) and import nothing of
JAX, so that they run there (`python -m pytest tests/test_torch_sky_compose.py
--noconftest -m gpu`): the kernels against the plain version and the plain
lookup, bit for bit, and gradients through render_image_cuda.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT

H, W = 12, 16
MISS_RTOL = 1e-6
DIR_RTOL = 2e-6
ROWS_RTOL, ROWS_ATOL = 2e-3, 2e-4  # tests/test_torch_backward.py's: K3 sums with atomics


def packed_sky(size, device="cpu"):
    faces = np.random.default_rng(size).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    return tcm.CubemapData.from_faces(faces, device=device)


def float_sky(size, device="cpu"):
    faces = np.random.default_rng(10 + size).uniform(0.0, 1.5, (6, size, size, 3))
    return tcm.CubemapData.from_faces(faces.astype(np.float32), device=device)


SKIES = {
    "packed": lambda device="cpu": packed_sky(8, device),
    "packed_1x1": lambda device="cpu": packed_sky(1, device),
    "float": lambda device="cpu": float_sky(8, device),
    "float_1x1": lambda device="cpu": tcm.constant_sky((0.25, 0.5, 2.0), device=device),
}


def sample_planes(seed, device="cpu"):
    """(10,H,W) planes as the forward kernel writes them, with the cases the
    compose must keep: misses and hits, directions on the cube's edges and
    corners (axis ties, the |x| == |y|, z == 0 saturation), and pre-clip
    values exactly 0 and 1 and out of range."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, H, W))
    d /= np.linalg.norm(d, axis=0)
    ties = [(1, 1, 0), (-1, 1, 0), (1, -1, 0), (1, 1, 1), (0, 0, 1), (0, -1, 0), (1, 0, -1),
            (-1, -1, -1), (0.5, 0.5, -0.5)]
    for j, t in enumerate(ties):
        d[:, 0, j] = t
    rgb = rng.uniform(-0.5, 1.5, (3, H, W))
    c = rng.uniform(0.0, 2.0, (3, H, W))
    miss = (rng.uniform(size=(H, W)) < 0.6).astype(np.float64)
    rgb[:, 1, :4] = [[0.0], [1.0], [0.0]]   # hit pixels whose sum sits on a bound
    miss[1, :4] = 0.0
    rgb[:, 2, :4] = [[1.0], [0.0], [1.0]]   # misses with no throughput left: on a bound too
    c[:, 2, :4] = 0.0
    miss[2, :4] = 1.0
    planes = np.concatenate([rgb, d, c, miss[None]]).astype(np.float32)
    return torch.from_numpy(planes).to(device)


def reference(planes, total, cubemap, bilinear=False):
    """sample_cubemap and compose_sky, added into `total`: the plain path
    the fused step replaces."""
    sky = tcm.sample_cubemap(cubemap, Vec3(planes[3], planes[4], planes[5]), bilinear=bilinear)
    rgb = mk.compose_sky(planes, sky).to_array()
    return rgb if total is None else total + rgb


def cotangent(seed, device="cpu"):
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(H, W, 3)).astype(np.float32))
    return g.to(device)


def miss_terms_scale(g_planes, planes, cubemap, bilinear=False):
    """Per pixel the sum over the channels of |(g * w) * (sky * c)|: the
    magnitudes of the terms the miss plane's cotangent sums (g * w is the
    radiance planes' cotangent)."""
    _, state = mk.sky_compose_plain(planes, None, cubemap, keep_state=True, bilinear=bilinear)
    sky = mk._state_sky(state, cubemap, bilinear)
    return sum((g_planes[ch] * (s * planes[6 + ch])).abs()
               for ch, s in enumerate((sky.x, sky.y, sky.z)))


def direction_terms_scale(g_planes, planes, cubemap):
    """The bound on the magnitudes of what the bilinear filter's direction
    cotangent sums (ops/cubemap.py::bilinear_adjoint_scale), for the sky
    cotangent (g * w) * miss * c of the radiance planes' cotangent g * w."""
    g_sky = Vec3(*(g_planes[ch] * planes[9] * planes[6 + ch] for ch in range(3)))
    return tcm.bilinear_adjoint_scale(cubemap, Vec3(planes[3], planes[4], planes[5]), g_sky)


def assert_cotangents(got, want, planes, cubemap, bilinear=False):
    if mk._bilinear_arm(bilinear, cubemap):
        assert torch.equal(got[:3], want[:3]) and torch.equal(got[6:9], want[6:9])
        scale = direction_terms_scale(got, planes, cubemap)
        assert ((got[3:6] - want[3:6]).abs() <= DIR_RTOL * scale).all()
    else:
        assert torch.equal(got[:9], want[:9])
    scale = miss_terms_scale(got, planes, cubemap, bilinear)
    assert ((got[9] - want[9]).abs() <= MISS_RTOL * scale).all()


def reference_vjp(planes, total, cubemap, g, bilinear=False):
    p = planes.clone().requires_grad_(True)
    t = None if total is None else total.clone().requires_grad_(True)
    out = reference(p, t, cubemap, bilinear)
    grads = torch.autograd.grad(out, [p] if t is None else [p, t], g)
    return out.detach(), grads[0], (grads[1] if t is not None else None)


# ---------------------------------------------------------------------------
# The plain version, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("first", [True, False], ids=["first_sample", "running_sum"])
def test_plain_forward_equals_the_lookup_and_compose(sky, first):
    cubemap = SKIES[sky]()
    planes = sample_planes(1)
    total = None if first else torch.rand((H, W, 3), generator=torch.Generator().manual_seed(2))
    want = reference(planes, total, cubemap)
    got, state = mk.sky_compose_plain(planes, total, cubemap, keep_state=True)
    assert torch.equal(got, want)
    assert state.dtype == torch.int32
    assert tuple(state.shape) == (mk.sky_state_planes(cubemap), H, W)
    assert mk.sky_state_planes(cubemap) == (5 if sky == "float" else 4)
    hit_on_bound = (planes[9] == 0) & ((planes[0] == 0) | (planes[0] == 1))
    assert hit_on_bound.any()


@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("first", [True, False], ids=["first_sample", "running_sum"])
def test_plain_adjoint_equals_autograd(sky, first):
    cubemap = SKIES[sky]()
    planes = sample_planes(3)
    total = None if first else torch.rand((H, W, 3), generator=torch.Generator().manual_seed(4))
    g = cotangent(5)
    want_out, want_gp, want_gt = reference_vjp(planes, total, cubemap, g)
    p = planes.clone().requires_grad_(True)
    t = None if total is None else total.clone().requires_grad_(True)
    out = mk.sky_compose(p, t, cubemap)
    assert torch.equal(out.detach(), want_out)
    grads = torch.autograd.grad(out, [p] if t is None else [p, t], g)
    assert_cotangents(grads[0], want_gp, planes, cubemap)
    assert not grads[0][3:6].any()
    if t is not None:
        assert torch.equal(grads[1], want_gt)
    # the tie rule reached half a cotangent somewhere, and a full one
    half = grads[0][:3] == 0.5 * g.permute(2, 0, 1)
    assert (half & (g.permute(2, 0, 1) != 0)).any()


def test_the_first_sample_equals_the_lookup_with_and_without_grad():
    """Sample 0 (no running sum) through sky_compose: without grad the
    forward alone, a new (H,W,3) sum; under grad SkyComposeFunction, whose
    cotangent is the plain lookup's."""
    cubemap = SKIES["packed"]()
    planes = sample_planes(6)
    g = cotangent(7)
    want_out = reference(planes, None, cubemap)
    for grad in (False, True):
        p = planes.clone().requires_grad_(grad)
        out = mk.sky_compose(p, None, cubemap)
        assert torch.equal(out.detach(), want_out) and out.requires_grad is grad
        assert tuple(out.shape) == (H, W, 3) and out.is_contiguous()
        if grad:
            (gp,) = torch.autograd.grad(out, [p], g)
            assert_cotangents(gp, reference_vjp(planes, None, cubemap, g)[1], planes, cubemap)


def test_without_grad_the_sum_is_added_in_place():
    cubemap = SKIES["packed"]()
    planes = sample_planes(8)
    total = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(9))
    want = reference(planes, total, cubemap)
    with torch.no_grad():
        out = mk.sky_compose(planes, total, cubemap)
    assert out is total and torch.equal(total, want)


def test_the_state_word_holds_texel_clip_codes_and_miss():
    cubemap = SKIES["packed"]()
    planes = sample_planes(10)
    _, state = mk.sky_compose_plain(planes, None, cubemap, keep_state=True)
    word = state[0]
    assert (word >= 0).all()  # bit 31 stays clear
    flat = tcm.texel_flat_index(cubemap, Vec3(planes[3], planes[4], planes[5]))
    assert torch.equal(word & mk.SKY_TEXEL_MASK, cubemap.packed[flat.long()])
    assert torch.equal((word & mk.SKY_MISS_BIT) != 0, planes[9] > 0.5)
    codes = (word >> mk.SKY_CLIP_SHIFT) & 3
    assert set(codes.unique().tolist()) == {0, mk.SKY_CLIP_HALF, mk.SKY_CLIP_FULL}
    assert torch.equal(state[1:4].view(torch.float32), planes[6:9])


@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("first", [True, False], ids=["first_sample", "running_sum"])
def test_plain_bilinear_forward_equals_the_lookup_and_compose(sky, first):
    """The bilinear arm's plain twin is sample_cubemap(bilinear=True) and
    compose_sky bit for bit; it keeps seven planes (the word, the throughput
    and the direction) on a sky larger than 1x1, whose lookup then differs
    from the nearest texel's, and is the nearest arm on a 1x1 sky."""
    cubemap = SKIES[sky]()
    planes = sample_planes(21)
    total = None if first else torch.rand((H, W, 3), generator=torch.Generator().manual_seed(22))
    want = reference(planes, total, cubemap, bilinear=True)
    got, state = mk.sky_compose_plain(planes, total, cubemap, keep_state=True, bilinear=True)
    assert torch.equal(got, want)
    one = cubemap.h * cubemap.w == 1
    assert tuple(state.shape) == (mk.sky_state_planes(cubemap, True), H, W)
    assert mk.sky_state_planes(cubemap, True) == (mk.sky_state_planes(cubemap) if one else 7)
    nearest, n_state = mk.sky_compose_plain(planes, total, cubemap, keep_state=True)
    assert torch.equal(got, nearest) is one
    if one:
        assert torch.equal(state, n_state)
    else:
        assert torch.equal(state[4:7].view(torch.float32), planes[3:6])
        assert not (state[0] & mk.SKY_TEXEL_MASK).any()


@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("first", [True, False], ids=["first_sample", "running_sum"])
def test_plain_bilinear_adjoint_equals_autograd(sky, first):
    """The bilinear arm's adjoint against autograd through
    sample_cubemap(bilinear=True) and compose_sky: every plane, the
    direction's included, which a sky larger than 1x1 moves."""
    cubemap = SKIES[sky]()
    planes = sample_planes(23)
    total = None if first else torch.rand((H, W, 3), generator=torch.Generator().manual_seed(24))
    g = cotangent(25)
    want_out, want_gp, want_gt = reference_vjp(planes, total, cubemap, g, bilinear=True)
    p = planes.clone().requires_grad_(True)
    t = None if total is None else total.clone().requires_grad_(True)
    out = mk.sky_compose(p, t, cubemap, bilinear=True)
    assert torch.equal(out.detach(), want_out)
    grads = torch.autograd.grad(out, [p] if t is None else [p, t], g)
    assert_cotangents(grads[0], want_gp, planes, cubemap, bilinear=True)
    assert bool(grads[0][3:6].any()) is (cubemap.h * cubemap.w > 1)
    if t is not None:
        assert torch.equal(grads[1], want_gt)


# ---------------------------------------------------------------------------
# Frames through render_frame, on the CPU
# ---------------------------------------------------------------------------


def unfused_frame(job, seed, spp, cubemap):
    """A frame through run_tiles_grad and compose (the plain lookup), summed
    in sample order: what render_frame computed before the fused step."""
    total = None
    for s in mk.frame_sample_seeds(seed, spp):
        planes, _ = mk.run_tiles_grad(job, s, 0)
        rgb = mk.compose(planes, cubemap, job.config)
        total = rgb if total is None else total + rgb
    if spp > 1:
        total = total * (1.0 / spp)
    return total.to_array()


def unfused_frame_plain(job, seed, spp, cubemap):
    """unfused_frame with the plain version of the megakernel (no kernel on
    any device)."""
    total = None
    for s in mk.frame_sample_seeds(seed, spp):
        planes, _ = mk.run_tiles_plain(job, s, 0)
        rgb = mk.compose(planes, cubemap, job.config)
        total = rgb if total is None else total + rgb
    if spp > 1:
        total = total * (1.0 / spp)
    return total.to_array()


def scene_with_leaves(text, device):
    scene = parse_scene_string(text, device=device)
    leaves = {"albedo": scene.albedo.clone().requires_grad_(True),
              "p0": scene.p0.clone().requires_grad_(True)}
    return dataclasses.replace(scene, **leaves), leaves


def frame_and_gradients(render, scene, leaves, target):
    img = render(scene)
    loss = ((img - target) ** 2).sum()
    return img.detach(), torch.autograd.grad(loss, list(leaves.values()))


@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_frames_and_gradients_equal_the_unfused_path(text, sky):
    cfg = RenderConfig(bounces=3, shadow_samples=1)
    cubemap = SKIES[sky]()
    scene, leaves = scene_with_leaves(text, "cpu")
    cam = Camera.default("cpu")
    target = torch.full((H, W, 3), 0.4)
    job = mk.make_tile_job(scene, cam, W, H, cfg)
    got = frame_and_gradients(lambda s: mk.render_image_cuda(
        s, cam, W, H, seed=7, spp=3, config=cfg, cubemap=cubemap, device="cpu"),
        scene, leaves, target)
    want = frame_and_gradients(lambda s: unfused_frame(job, 7, 3, cubemap), scene, leaves,
                               target)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_bilinear_frames_and_gradients_equal_the_unfused_path(text, sky):
    """The fused bilinear step through render_image_cuda against the plain
    lookup and compose at 64x48: the frame bit for bit, the gradients of
    albedo and p0 (which the miss directions carry) as the nearest test's."""
    cfg = RenderConfig(bounces=3, shadow_samples=1, env_filter="bilinear")
    cubemap = SKIES[sky]()
    scene, leaves = scene_with_leaves(text, "cpu")
    cam = Camera.default("cpu")
    width, height = 64, 48
    target = torch.full((height, width, 3), 0.4)
    job = mk.make_tile_job(scene, cam, width, height, cfg)
    got = frame_and_gradients(lambda s: mk.render_image_cuda(
        s, cam, width, height, seed=7, spp=2, config=cfg, cubemap=cubemap, device="cpu"),
        scene, leaves, target)
    want = frame_and_gradients(lambda s: unfused_frame(job, 7, 2, cubemap), scene, leaves,
                               target)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def count_sky_steps(monkeypatch):
    """Calls of sky_compose and of compose_sky, counted as they happen."""
    calls = {"fused": 0, "compose_sky": 0}
    orig_fused, orig_compose = mk.sky_compose, mk.compose_sky

    def spy_fused(*a, **k):
        calls["fused"] += 1
        return orig_fused(*a, **k)

    def spy_compose(*a, **k):
        calls["compose_sky"] += 1
        return orig_compose(*a, **k)

    monkeypatch.setattr(mk, "sky_compose", spy_fused)
    monkeypatch.setattr(mk, "compose_sky", spy_compose)
    return calls


def float_sky_with_grad():
    """SKIES["float"] with planes that require grad, and those planes."""
    base = SKIES["float"]()
    leaves = [base.r.clone().requires_grad_(True), base.g.clone().requires_grad_(True),
              base.b.clone().requires_grad_(True)]
    return dataclasses.replace(base, r=leaves[0], g=leaves[1], b=leaves[2]), leaves


@pytest.mark.parametrize("cfg,fused", [
    (RenderConfig(), True),
    (RenderConfig(env_filter="bilinear"), True),
    (RenderConfig(), False),
    (RenderConfig(env_filter="bilinear"), False),
])
def test_which_path_runs(cfg, fused, monkeypatch):
    """The fused step for either filter on a packed sky; a float sky that
    requires grad keeps sample_cubemap and compose_sky. The CPU launches no
    kernel."""
    calls = count_sky_steps(monkeypatch)
    cubemap = SKIES["packed"]() if fused else float_sky_with_grad()[0]
    assert mk.fused_sky_compose(cubemap) is fused
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    mk.reset_launch_counts()
    mk.render_image_cuda(scene, Camera.default("cpu"), W, H, seed=1, spp=3,
                         config=cfg.replace(bounces=2), cubemap=cubemap, device="cpu")
    assert calls == ({"fused": 3, "compose_sky": 0} if fused else {"fused": 0, "compose_sky": 3})
    assert mk.launch_counts["sky_compose"] == mk.launch_counts["sky_compose_adjoint"] == 0


@pytest.mark.parametrize("sky", list(SKIES))
def test_the_plain_render_keeps_the_plain_lookup(sky, monkeypatch):
    """render_image, the plain reference the kernels are held against, takes
    sample_cubemap and compose_sky for every sample and never sky_compose,
    and its frame is the unfused frame bit for bit."""
    from ray_tracing_tpu_torch.render.integrator import render_image

    cfg = RenderConfig(bounces=3, shadow_samples=1)
    cubemap = SKIES[sky]()
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    cam = Camera.default("cpu")
    calls = count_sky_steps(monkeypatch)
    img = render_image(scene, cam, W, H, seed=7, spp=3, config=cfg, cubemap=cubemap,
                       device="cpu")
    assert calls == {"fused": 0, "compose_sky": 3}
    job = mk.make_tile_job(scene, cam, W, H, cfg)
    assert torch.equal(img, unfused_frame(job, 7, 3, cubemap))


def test_a_sky_that_requires_grad_keeps_the_plain_lookup_and_gets_its_gradient(monkeypatch):
    """sky_compose takes the sky as a constant: a float sky whose planes
    require grad goes through sample_cubemap and compose_sky, and gets the
    unfused frame's gradient."""
    cfg = RenderConfig(bounces=3, shadow_samples=1)
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    cam = Camera.default("cpu")
    target = torch.full((H, W, 3), 0.4)
    cubemap, leaves = float_sky_with_grad()
    assert not mk.fused_sky_compose(cubemap)
    calls = count_sky_steps(monkeypatch)
    img = mk.render_image_cuda(scene, cam, W, H, seed=7, spp=3, config=cfg, cubemap=cubemap,
                               device="cpu")
    got = torch.autograd.grad(((img - target) ** 2).sum(), leaves)
    assert calls == {"fused": 0, "compose_sky": 3}
    cubemap, leaves = float_sky_with_grad()
    job = mk.make_tile_job(scene, cam, W, H, cfg)
    want_img = unfused_frame(job, 7, 3, cubemap)
    want = torch.autograd.grad(((want_img - target) ** 2).sum(), leaves)
    assert torch.equal(img.detach(), want_img.detach())
    assert any(float(g.abs().max()) > 0 for g in want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("env_filter", ["nearest", "bilinear"])
@pytest.mark.parametrize("sky", list(SKIES))
def test_a_train_step_equals_the_plain_reference(sky, env_filter):
    """make_train_step (render_image_cuda: the fused sky step, the fetch
    backward) against the plain reference render_image, on every sky and
    filter: the loss of a 3-sample frame bit for bit, the gradient of
    albedo and p0 to the rounding of the backward's order of sums (the
    tolerance of the frames' gradients above)."""
    from ray_tracing_tpu_torch.diff.inverse import make_train_step
    from ray_tracing_tpu_torch.render.integrator import render_image

    cfg = RenderConfig(bounces=3, shadow_samples=1, env_filter=env_filter)
    cubemap = SKIES[sky]()
    scene, leaves = scene_with_leaves(SCENE_2_TEXT, "cpu")
    cam = Camera.default("cpu")
    target = torch.full((H, W, 3), 0.4)
    step = make_train_step(scene, cam, torch.optim.SGD(list(leaves.values()), lr=0.0), W, H,
                           spp=3, config=cfg, cubemap=cubemap, device="cpu")
    loss = step({"scene": leaves, "camera": {}}, target, 5)
    img = render_image(scene, cam, W, H, seed=5, spp=3, config=cfg, cubemap=cubemap,
                       device="cpu")
    want_loss = torch.sum((img - target) ** 2) / float(W * H * 3)
    want = torch.autograd.grad(want_loss, list(leaves.values()))
    assert torch.equal(loss, want_loss.detach()) and float(want[0].abs().max()) > 0
    for a, b in zip((x.grad for x in leaves.values()), want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def saved_planes_per_sample(width, height, spp, env_filter="nearest", device="cpu"):
    """Planes of width x height float32 that the tensors autograd saved
    still hold once the forward of a fetch frame of scene_2 is done, per
    sample. A saved view counts its whole storage; a storage is counted
    once, in whole planes (the scene rows and the camera pack hold none)."""
    scene, leaves = scene_with_leaves(SCENE_2_TEXT, device)
    refs = []

    def pack(t):
        refs.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        img = mk.render_image_cuda(scene, Camera.default(device), width, height, seed=3,
                                   spp=spp, config=RenderConfig(bwd_mode="fetch",
                                                                env_filter=env_filter),
                                   cubemap=SKIES["packed"](device), device=device)
    gc.collect()
    storages = {}
    for r in refs:
        t = r()
        if t is not None:
            s = t.untyped_storage()
            storages[s.data_ptr()] = s.nbytes()
    planes = sum(n // (width * height * 4) for n in storages.values())
    assert img.requires_grad
    return planes / spp


def test_a_differentiated_frame_keeps_at_most_14_planes_a_sample():
    """Ten planes of the fetch backward's winner indices (ten bounces, no
    light) and four of the compose's state, and no view of the sample's
    planes."""
    assert saved_planes_per_sample(64, 48, 4) <= 14


def test_a_differentiated_bilinear_frame_keeps_at_most_17_planes_a_sample():
    """Ten planes of winner indices and seven of the bilinear compose's
    state (the word, the throughput and the miss direction); the plain
    lookup and compose kept 32."""
    assert saved_planes_per_sample(64, 48, 4, "bilinear") <= 17


# ---------------------------------------------------------------------------
# On the card (skipped where there is none)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("first", [True, False], ids=["first_sample", "running_sum"])
def test_cuda_kernels_equal_the_plain_version(sky, first, cuda_device):
    cubemap = SKIES[sky](cuda_device)
    planes = sample_planes(11, cuda_device)
    total = None if first else torch.rand((H, W, 3), device=cuda_device)
    g = cotangent(12, cuda_device)
    before = dict(mk.launch_counts)
    out, state = mk._launch_sky_compose(planes, total, cubemap, True)
    g_planes = mk._launch_sky_compose_adjoint(g, state, cubemap)
    torch.cuda.synchronize()
    assert mk.launch_counts["sky_compose"] == before["sky_compose"] + 1
    assert mk.launch_counts["sky_compose_adjoint"] == before["sky_compose_adjoint"] + 1
    w_out, w_state = mk.sky_compose_plain(planes, total, cubemap, keep_state=True)
    assert torch.equal(out, w_out) and torch.equal(state, w_state)
    assert torch.equal(out, reference(planes, total, cubemap))
    assert torch.equal(g_planes, mk.sky_compose_adjoint_plain(g, state, cubemap))
    assert_cotangents(g_planes, reference_vjp(planes, total, cubemap, g)[1], planes, cubemap)


@pytest.mark.gpu
def test_cuda_kernel_adds_in_place(cuda_device):
    cubemap = SKIES["packed"](cuda_device)
    planes = sample_planes(13, cuda_device)
    with torch.no_grad():
        out = mk.sky_compose(planes, None, cubemap)
        assert torch.equal(out, reference(planes, None, cubemap))
        again = out.clone()
        out2 = mk.sky_compose(planes, out, cubemap)
    assert out2 is out and torch.equal(out, reference(planes, again, cubemap))


@pytest.mark.gpu
@pytest.mark.parametrize("sky", ["packed", "float_1x1"])
@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_cuda_frames_and_gradients_equal_the_unfused_path(text, sky, cuda_device):
    cfg = RenderConfig(bounces=4, shadow_samples=2)
    cubemap = SKIES[sky](cuda_device)
    scene, leaves = scene_with_leaves(text, cuda_device)
    cam = Camera.default(cuda_device)
    width, height, spp = 96, 64, 4
    target = torch.full((height, width, 3), 0.4, device=cuda_device)
    job = mk.make_tile_job(scene, cam, width, height, cfg)
    mk.reset_launch_counts()
    got = frame_and_gradients(lambda s: mk.render_image_cuda(
        s, cam, width, height, seed=7, spp=spp, config=cfg, cubemap=cubemap),
        scene, leaves, target)
    torch.cuda.synchronize()
    assert mk.launch_counts["sky_compose"] == spp
    assert mk.launch_counts["sky_compose_adjoint"] == spp
    want = frame_and_gradients(lambda s: unfused_frame(job, 7, spp, cubemap), scene, leaves,
                               target)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        scale = b.abs().amax(dim=0, keepdim=True)
        assert ((a - b).abs() <= ROWS_RTOL * b.abs() + ROWS_ATOL * scale).all()


@pytest.mark.gpu
@pytest.mark.parametrize("sky", ["packed", "float_1x1"])
def test_cuda_plain_render_launches_no_kernel(sky, cuda_device):
    """render_image on the card stays plain: no launch of any kernel, the
    sky compose's included, so that a comparison with it holds the kernels
    to plain code."""
    from ray_tracing_tpu_torch.render.integrator import render_image

    cfg = RenderConfig(bounces=4, shadow_samples=2)
    cubemap = SKIES[sky](cuda_device)
    scene = parse_scene_string(SCENE_2_TEXT, device=cuda_device)
    cam = Camera.default(cuda_device)
    before = dict(mk.launch_counts)
    with torch.no_grad():
        img = render_image(scene, cam, 96, 64, seed=7, spp=4, config=cfg, cubemap=cubemap)
    torch.cuda.synchronize()
    assert mk.launch_counts == before
    job = mk.make_tile_job(scene, cam, 96, 64, cfg)
    with torch.no_grad():
        want = unfused_frame_plain(job, 7, 4, cubemap)
    assert torch.equal(img, want)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,launches", [(RenderConfig(), 1),
                                          (RenderConfig(env_filter="bilinear"), 1)])
def test_cuda_launches_one_compose_a_sample(cfg, launches, cuda_device):
    scene = parse_scene_string(SCENE_2_TEXT, device=cuda_device)
    cubemap = packed_sky(64, cuda_device)
    key = "sky_compose_bilinear" if cfg.env_filter == "bilinear" else "sky_compose"
    mk.reset_launch_counts()
    with torch.no_grad():
        img = mk.render_image_cuda(scene, Camera.default(cuda_device), 128, 96, seed=2, spp=8,
                                   config=cfg, cubemap=cubemap)
    torch.cuda.synchronize()
    assert mk.launch_counts[key] == 8 * launches
    assert all(v == 0 for k, v in mk.launch_counts.items() if k not in (key, "megakernel_fwd"))
    assert img.shape == (96, 128, 3) and img.is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("sky", list(SKIES))
@pytest.mark.parametrize("first", [True, False], ids=["first_sample", "running_sum"])
def test_cuda_bilinear_kernels_equal_the_plain_version(sky, first, cuda_device):
    """The bilinear arms against their plain twin bit for bit (sum, state and
    cotangent), against the plain lookup and compose, and against autograd
    through it."""
    cubemap = SKIES[sky](cuda_device)
    planes = sample_planes(31, cuda_device)
    total = None if first else torch.rand((H, W, 3), device=cuda_device)
    g = cotangent(32, cuda_device)
    before = dict(mk.launch_counts)
    out, state = mk._launch_sky_compose(planes, total, cubemap, True, bilinear=True)
    g_planes = mk._launch_sky_compose_adjoint(g, state, cubemap, bilinear=True)
    torch.cuda.synchronize()
    # a 1x1 sky reads its face's texel under either filter: the nearest arm
    key = "sky_compose_bilinear" if mk._bilinear_arm(True, cubemap) else "sky_compose"
    assert {k: v - before[k] for k, v in mk.launch_counts.items()} == {
        **dict.fromkeys(before, 0), key: 1, key + "_adjoint": 1}
    w_out, w_state = mk.sky_compose_plain(planes, total, cubemap, keep_state=True,
                                          bilinear=True)
    assert torch.equal(out, w_out) and torch.equal(state, w_state)
    assert torch.equal(out, reference(planes, total, cubemap, bilinear=True))
    assert torch.equal(g_planes, mk.sky_compose_adjoint_plain(g, state, cubemap, bilinear=True))
    assert_cotangents(g_planes, reference_vjp(planes, total, cubemap, g, bilinear=True)[1],
                      planes, cubemap, bilinear=True)


@pytest.mark.gpu
@pytest.mark.parametrize("sky", ["packed", "float"])
@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_cuda_bilinear_frames_and_gradients_equal_the_unfused_path(text, sky, cuda_device):
    """A differentiated 4-sample bilinear frame launches four composes and
    four adjoints, equals the plain lookup's frame bit for bit and its
    gradients as the nearest test's; the plain reference render_image
    launches neither."""
    from ray_tracing_tpu_torch.render.integrator import render_image

    cfg = RenderConfig(bounces=4, shadow_samples=2, env_filter="bilinear")
    cubemap = SKIES[sky](cuda_device)
    scene, leaves = scene_with_leaves(text, cuda_device)
    cam = Camera.default(cuda_device)
    width, height, spp = 96, 64, 4
    target = torch.full((height, width, 3), 0.4, device=cuda_device)
    job = mk.make_tile_job(scene, cam, width, height, cfg)
    mk.reset_launch_counts()
    got = frame_and_gradients(lambda s: mk.render_image_cuda(
        s, cam, width, height, seed=7, spp=spp, config=cfg, cubemap=cubemap),
        scene, leaves, target)
    torch.cuda.synchronize()
    assert mk.launch_counts["sky_compose_bilinear"] == spp
    assert mk.launch_counts["sky_compose_bilinear_adjoint"] == spp
    assert mk.launch_counts["sky_compose"] == mk.launch_counts["sky_compose_adjoint"] == 0
    want = frame_and_gradients(lambda s: unfused_frame(job, 7, spp, cubemap), scene, leaves,
                               target)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        scale = b.abs().amax(dim=0, keepdim=True)
        assert ((a - b).abs() <= ROWS_RTOL * b.abs() + ROWS_ATOL * scale).all()
    before = dict(mk.launch_counts)
    with torch.no_grad():
        plain = render_image(scene, cam, width, height, seed=7, spp=spp, config=cfg,
                             cubemap=cubemap)
    torch.cuda.synchronize()
    assert mk.launch_counts == before
    assert torch.equal(plain, got[0])


@pytest.mark.gpu
def test_cuda_a_differentiated_bilinear_frame_keeps_at_most_17_planes_a_sample(cuda_device):
    assert saved_planes_per_sample(96, 64, 4, "bilinear", cuda_device) <= 17
