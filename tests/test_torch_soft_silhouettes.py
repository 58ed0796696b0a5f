"""The soft silhouettes' composite of a frame as one step
(kernels/megakernel.py::soft_silhouettes, SoftSilhouetteFunction, the
kernels of csrc/sky_compose.cu) against the plain composite it replaces on
the card (render/integrator.py::soft_silhouette_composite) differentiated by
autograd.

Tolerance: none on frames and on the colour's cotangent, which repeats
autograd's one product. The rows' and the camera's cotangents sum per-pixel
terms over the frame in another order than autograd's, and each term takes
autograd's steps in an order of its own (the channels of alpha's cotangent,
the slabs' quotients): within ADJ_RTOL of the sum of the magnitudes of the
terms each entry adds (soft_silhouettes_adjoint_scale), where a relative
error of the sum itself has no bound (the terms cancel: a silhouette's two
sides pull an object both ways), and ADJ_ATOL of the largest entry, for a
pixel's own term that cancels to nothing in one order and not in another
(a box's origin enters its slabs and its size's two ends). On the card the kernel's atomics add in
an order that changes from run to run: the same bound against the plain
version.

The tests at the end need the card (marker `gpu`) and import nothing of
JAX, so that they run there (`python -m pytest
tests/test_torch_soft_silhouettes.py --noconftest -m gpu`).
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
from ray_tracing_tpu_torch.render import integrator
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import Scene

ADJ_RTOL, ADJ_ATOL = 1e-5, 1e-6
TEMP = 0.08

CUBES_TEXT = """\
cube origin {-2.5 -1 -1} size {1.5 1.5 1.5} albedo    {0.9 0.3 0.2}
cube origin {-1.2 -0.4 -0.3} size {1 2.5 1} albedo    {0.2 0.7 0.3} emission_power 0.5 emission_color {1 0.5 0.2}
sphere center {1.5 0 0} radius 1 albedo    {0.2 0.5 1}
"""
# scene_2 with a sphere and a box behind the near camera
BEHIND_TEXT = SCENE_2_TEXT + """\
sphere center {0.5 1 10} radius 1.5 albedo    {1 0 0}
cube origin {-1 -1 9} size {2 2 1} albedo    {0 1 0}
"""


def camera(pos, front, device="cpu"):
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Camera(pos=t(pos), front=t(front), up=t([0.0, 1.0, 0.0]), yaw=t(-90.0), pitch=t(0.0))


CAMERAS = {
    "default": lambda device="cpu": Camera.default(device),
    "near": lambda device="cpu": camera([0.5, 1.0, 7.0], [-0.05, -0.15, -1.0], device),
    # down the z axis: the middle column's rays have d.x == 0, the middle
    # row's d.y == 0, the middle pixel's both
    "axis": lambda device="cpu": camera([0.0, 0.0, 10.0], [0.0, 0.0, -1.0], device),
}

SKIES = {
    "gradient": lambda device="cpu": tcm.gradient_sky(8, device=device),
    "packed": lambda device="cpu": tcm.CubemapData.from_faces(
        np.random.default_rng(3).integers(0, 256, (6, 8, 8, 3), dtype=np.uint8), device=device),
    "1x1": lambda device="cpu": tcm.constant_sky((0.25, 0.5, 2.0), device=device),
}


def scene_of(name, device="cpu"):
    if name == "random64":
        return Scene.from_objects(random_objects(64), device=device)
    text = {"scene_2": SCENE_2_TEXT, "cubes": CUBES_TEXT, "room": ROOM_TEXT,
            "behind": BEHIND_TEXT}[name]
    return parse_scene_string(text, device=device)


@dataclasses.dataclass(frozen=True)
class Case:
    scene: str
    camera: str
    sky: str
    env_filter: str
    width: int = 40
    height: int = 24
    row0: int = 0
    norm_height: int | None = None


CASES = {
    "spheres_bilinear": Case("scene_2", "default", "gradient", "bilinear"),
    "spheres_nearest": Case("scene_2", "near", "packed", "nearest"),
    "spheres_1x1": Case("scene_2", "near", "1x1", "bilinear"),
    "cubes_bilinear": Case("cubes", "near", "gradient", "bilinear"),
    "cubes_nearest": Case("cubes", "default", "packed", "nearest"),
    "room": Case("room", "default", "gradient", "bilinear"),
    "behind_camera": Case("behind", "near", "gradient", "bilinear"),
    "axis_parallel": Case("cubes", "axis", "gradient", "bilinear", 33, 21),
    "row_slice": Case("scene_2", "near", "gradient", "bilinear", 40, 9, 11, 30),
    "objects_64": Case("random64", "default", "gradient", "bilinear"),
    "objects_64_nearest": Case("random64", "near", "packed", "nearest"),
}


def make_inputs(case: Case, device="cpu", seed=1):
    """(job with rows and camera pack that require grad, colour that
    requires grad, sky, cotangent) of a case."""
    cfg = RenderConfig(soft_silhouette_temp=TEMP, env_filter=case.env_filter)
    scene = scene_of(case.scene, device)
    job = mk.make_tile_job(scene, CAMERAS[case.camera](device), case.width, case.height, cfg,
                           norm_height=case.norm_height)
    job = dataclasses.replace(job, rows=job.rows.clone().requires_grad_(True),
                              cam_pack=job.cam_pack.clone().requires_grad_(True))
    gen = torch.Generator().manual_seed(seed)
    shape = (case.height, case.width, 3)
    result = torch.rand(shape, generator=gen).to(device).requires_grad_(True)
    g = torch.randn(shape, generator=gen).to(device)
    return job, result, SKIES[case.sky](device), g


def composite(job, result, cubemap, row0):
    """The plain composite over the job's frame, as _soft_silhouettes calls
    it: (H,W,3)."""
    view = mk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    u, v = mk._tile_uv(job.width, job.height, job.norm_height, row0, job.rows.device)
    ro, rd = mk.camera_rays_from_pack(job.cam_pack, u, v, (job.height, job.width))
    return integrator.soft_silhouette_composite(view, ro, rd, Vec3(*result.unbind(-1)),
                                                job.config, cubemap).to_array()


def detached(job):
    return dataclasses.replace(job, rows=job.rows.detach(), cam_pack=job.cam_pack.detach())


def assert_within_terms(got, want, scale):
    allowed = ADJ_RTOL * scale + ADJ_ATOL * want.abs().max()
    assert ((got - want).abs() <= allowed).all(), float(
        ((got - want).abs() / allowed.clamp_min(1e-30)).max())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_equals_the_composite(name):
    case = CASES[name]
    job, result, sky, _ = make_inputs(case)
    with torch.no_grad():
        want = composite(job, result, sky, case.row0)
        got = mk.soft_silhouettes_plain(detached(job), result, sky, case.row0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_adjoint_equals_autograd(name):
    """The hand-written adjoint against autograd over the composite: the
    colour's cotangent bit for bit, every row entry (p0, p1, albedo,
    emission) and the camera pack within ADJ_RTOL of their terms'
    magnitudes."""
    case = CASES[name]
    job, result, sky, g = make_inputs(case)
    want = torch.autograd.grad(composite(job, result, sky, case.row0),
                               [result, job.rows, job.cam_pack], g)
    with torch.no_grad():
        plain = detached(job)
        got = mk.soft_silhouettes_adjoint_plain(plain, g, result.detach(), sky, case.row0)
        rows_scale, cam_scale = mk.soft_silhouettes_adjoint_scale(plain, g, result.detach(), sky,
                                                                  case.row0)
    assert torch.equal(got[0], want[0])
    assert_within_terms(got[1], want[1], rows_scale)
    assert_within_terms(got[2], want[2], cam_scale)
    # rows' columns the composite never reads (roughness, reflectance,
    # metallic, the type tag) get exactly nothing
    assert not got[1][:, 9:12].any() and not got[1][:, 15].any()


def test_the_cases_cover_what_they_name():
    """Across the cases: hits and misses, pixels just outside an edge (a
    miss with coverage), object-over-object edges (a hit with a runner-up),
    spheres and boxes as the coverage's object, an object behind the camera
    (a sphere whose centre lies behind every ray), axis-parallel rays, both
    sky filters and a 1x1 sky, a row slice, 3 and 64 objects."""
    seen = set()
    for case in CASES.values():
        job, _, sky, _ = make_inputs(case)
        with torch.no_grad():
            p = mk.soft_pixels(detached(job), sky, case.row0)
        rows = job.rows.detach()
        miss = ~p.hit
        seen |= {k for k, on in (
            ("hit", p.hit.any()), ("miss", miss.any()),
            ("outside_edge", (miss & (p.geo >= 0) & (p.alpha < 0.999)).any()),
            ("over_object", (p.hit & p.proxy).any()),
            ("sphere_cover", (rows[p.geo.clamp(min=0), 15][p.geo >= 0] == 1).any()),
            ("box_cover", (rows[p.geo.clamp(min=0), 15][p.geo >= 0] == 2).any()),
            ("axis_parallel", ((p.d.x == 0) & (p.d.y == 0)).any()),
            ("row_slice", case.row0 > 0), ("1x1", sky.h == 1),
            ("bilinear", case.env_filter == "bilinear" and sky.h > 1),
            ("nearest", case.env_filter == "nearest" and sky.h > 1),
            ("n3", rows.shape[0] == 3), ("n64", rows.shape[0] == 64)) if bool(on)}
        if case.scene == "behind":
            centre = rows[-2, :3]
            along = ((centre[0] - p.ro.x) * p.d.x + (centre[1] - p.ro.y) * p.d.y
                     + (centre[2] - p.ro.z) * p.d.z)
            if bool((along < 0).all()):
                seen.add("behind_camera")
    assert seen == {"hit", "miss", "outside_edge", "over_object", "sphere_cover", "box_cover",
                    "axis_parallel", "row_slice", "1x1", "bilinear", "nearest", "n3", "n64",
                    "behind_camera"}


@pytest.mark.parametrize("wanted", [(True, True, True), (False, True, False),
                                    (True, False, True)], ids=["all", "rows", "colour_camera"])
def test_the_function_routes_cotangents_on_the_cpu(wanted):
    """SoftSilhouetteFunction on CPU tensors: the plain version's frame and
    its adjoint's cotangents, for the inputs that require grad and None for
    the others."""
    case = CASES["cubes_bilinear"]
    job, result, sky, g = make_inputs(case)
    inputs = [t.detach().requires_grad_(w) for t, w in zip((result, job.rows, job.cam_pack),
                                                           wanted)]
    job = dataclasses.replace(job, rows=inputs[1], cam_pack=inputs[2])
    out = mk.soft_silhouettes(job, inputs[0], sky, case.row0)
    asked = [t for t in inputs if t.requires_grad]
    got = torch.autograd.grad(out, asked, g)
    with torch.no_grad():
        want = mk.soft_silhouettes_adjoint_plain(detached(job), g, result.detach(), sky)
        assert torch.equal(out, mk.soft_silhouettes_plain(detached(job), result, sky))
    for a, b in zip(got, [w for w, on in zip(want, wanted) if on]):
        assert torch.equal(a, b)


def count_composites(monkeypatch):
    calls = {"plain": 0, "kernel_path": 0}
    orig_plain, orig_kernel = integrator.soft_silhouette_composite, mk.soft_silhouettes

    def spy_plain(*a, **k):
        calls["plain"] += 1
        return orig_plain(*a, **k)

    def spy_kernel(*a, **k):
        calls["kernel_path"] += 1
        return orig_kernel(*a, **k)

    monkeypatch.setattr(integrator, "soft_silhouette_composite", spy_plain)
    monkeypatch.setattr(mk, "soft_silhouettes", spy_kernel)
    return calls


def invert_frame(device, sky, leaves=("p0",), spp=2, width=48, height=32, camera_leaves=()):
    """A differentiated frame of invert's configuration (bilinear sky, soft
    silhouettes) on scene_2 with the named leaves: (frame, {leaf: grad})."""
    scene = parse_scene_string(SCENE_2_TEXT, device=device)
    params = {f: getattr(scene, f).clone().requires_grad_(True) for f in leaves}
    scene = dataclasses.replace(scene, **params)
    cam = Camera.default(device)
    cam_params = {f: getattr(cam, f).clone().requires_grad_(True) for f in camera_leaves}
    cam = dataclasses.replace(cam, **cam_params)
    cfg = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                       soft_silhouette_temp=TEMP)
    img = mk.render_image_cuda(scene, cam, width, height, seed=5, spp=spp, config=cfg,
                               cubemap=sky, device=device)
    target = torch.full_like(img, 0.4)
    every = {**params, **{"camera." + f: t for f, t in cam_params.items()}}
    grads = torch.autograd.grad(((img - target) ** 2).sum(), list(every.values()))
    return img.detach(), dict(zip(every, grads))


def test_the_cpu_keeps_the_plain_composite(monkeypatch):
    """On the CPU every frame takes soft_silhouette_composite and launches
    nothing; fused_soft_silhouettes holds only for a frame on the card."""
    calls = count_composites(monkeypatch)
    mk.reset_launch_counts()
    invert_frame("cpu", SKIES["gradient"]())
    assert calls == {"plain": 1, "kernel_path": 0}
    assert mk.launch_counts["soft_silhouettes"] == mk.launch_counts[
        "soft_silhouettes_adjoint"] == 0
    job, _, sky, _ = make_inputs(CASES["room"])
    assert not mk.fused_soft_silhouettes(job, sky)


def kernel_path_on_the_cpu(monkeypatch):
    """_soft_silhouettes takes soft_silhouettes on the CPU too, where
    SoftSilhouetteFunction runs the plain versions of the kernels: the card's
    path through render_frame, short of the launches."""
    monkeypatch.setattr(mk, "fused_soft_silhouettes", lambda job, cubemap: True)


@pytest.mark.parametrize("camera_leaves", [(), ("pos", "front")], ids=["scene", "camera"])
def test_the_kernel_path_equals_the_plain_path_through_render_frame(camera_leaves, monkeypatch):
    """A differentiated invert frame through SoftSilhouetteFunction: the
    plain composite's frame bit for bit and its gradients of p0 (and of the
    camera, with temperature > 0) within rounding of their sums."""
    sky = SKIES["gradient"]()
    want = invert_frame("cpu", sky, camera_leaves=camera_leaves)
    calls = count_composites(monkeypatch)
    kernel_path_on_the_cpu(monkeypatch)
    got = invert_frame("cpu", sky, camera_leaves=camera_leaves)
    assert calls == {"plain": 0, "kernel_path": 1}
    assert torch.equal(got[0], want[0])
    for leaf, b in want[1].items():
        assert float(b.abs().max()) > 0, leaf
        assert torch.allclose(got[1][leaf], b, rtol=1e-5, atol=1e-5 * float(b.abs().max())), leaf


def saved_bytes(device, width=96, height=64, spp=4):
    """Bytes of the storages the tensors autograd saved still hold once the
    forward of an invert frame (p0, bilinear gradient sky, soft silhouettes)
    is done, each storage once, and the frame."""
    scene = parse_scene_string(SCENE_2_TEXT, device=device)
    p0 = scene.p0.clone().requires_grad_(True)
    scene = dataclasses.replace(scene, p0=p0)
    cfg = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                       soft_silhouette_temp=TEMP)
    refs = []

    def pack(t):
        refs.append(weakref.ref(t))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        img = mk.render_image_cuda(scene, Camera.default(device), width, height, seed=3,
                                   spp=spp, config=cfg, cubemap=tcm.gradient_sky(32, device=device),
                                   device=device)
    gc.collect()
    storages = {}
    for r in refs:
        t = r()
        if t is not None:
            s = t.untyped_storage()
            storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values()), img


# A differentiated 96x64 invert frame of 4 samples keeps each sample's three
# planes of winner indices and seven of the bilinear compose's state, and
# the composite's colour, 3 planes a frame: 43 planes of 24 KB and the scene
# rows and camera pack, under 44; autograd over the plain composite kept 100
# planes more (143, 3.5 MB).
SAVED_PLANES_BOUND = 44


def test_a_differentiated_invert_frame_keeps_under_44_planes(monkeypatch):
    plane = 96 * 64 * 4
    plain, _ = saved_bytes("cpu")
    kernel_path_on_the_cpu(monkeypatch)
    nbytes, img = saved_bytes("cpu")
    assert img.requires_grad
    assert nbytes <= SAVED_PLANES_BOUND * plane < plain - 90 * plane


# ---------------------------------------------------------------------------
# On the card (skipped where there is none)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    return torch.device("cuda")


def plain_path(monkeypatch):
    """render_frame with the kernels turned away: the plain composite on the
    card, what _soft_silhouettes ran before them."""
    monkeypatch.setattr(mk, "fused_soft_silhouettes", lambda job, cubemap: False)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernels_equal_the_plain_version(name, cuda_device):
    """The forward kernel against its plain twin and the plain composite on
    the card bit for bit; the adjoint's colour cotangent bit for bit, its
    rows' and camera's within ADJ_RTOL of their terms' magnitudes of the
    plain version (atomics) and of autograd over the composite."""
    case = CASES[name]
    job, result, sky, g = make_inputs(case, cuda_device)
    plain = detached(job)
    before = dict(mk.launch_counts)
    out = mk._launch_soft_silhouettes(plain, result.detach(), sky, case.row0)
    g_res, g_rows, g_cam = mk._launch_soft_silhouettes_adjoint(plain, g, result.detach(), sky,
                                                               case.row0)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in mk.launch_counts.items()} == {
        **dict.fromkeys(before, 0), "soft_silhouettes": 1, "soft_silhouettes_adjoint": 1}
    with torch.no_grad():
        twin = mk.soft_silhouettes_plain(plain, result.detach(), sky, case.row0)
        w_res, w_rows, w_cam = mk.soft_silhouettes_adjoint_plain(plain, g, result.detach(), sky,
                                                                 case.row0)
        rows_scale, cam_scale = mk.soft_silhouettes_adjoint_scale(plain, g, result.detach(), sky,
                                                                  case.row0)
    want = composite(job, result, sky, case.row0)
    a_res, a_rows, a_cam = torch.autograd.grad(want, [result, job.rows, job.cam_pack], g)
    assert torch.equal(out, twin) and torch.equal(out, want.detach())
    assert torch.equal(g_res, w_res) and torch.equal(g_res, a_res)
    for got, w, a, scale in ((g_rows, w_rows, a_rows, rows_scale),
                             (g_cam, w_cam, a_cam, cam_scale)):
        assert_within_terms(got, w, scale)
        assert_within_terms(got, a, scale)


@pytest.mark.gpu
def test_cuda_writes_only_the_cotangents_asked_for(cuda_device):
    case = CASES["room"]
    job, result, sky, g = make_inputs(case, cuda_device)
    _, g_rows, g_cam = mk._launch_soft_silhouettes_adjoint(detached(job), g, result.detach(), sky,
                                                           rows_grad=False, cam_grad=True)
    assert g_rows is None and g_cam is not None
    _, g_rows, g_cam = mk._launch_soft_silhouettes_adjoint(detached(job), g, result.detach(), sky,
                                                           rows_grad=True, cam_grad=False)
    assert g_rows is not None and g_cam is None


@pytest.mark.gpu
@pytest.mark.parametrize("camera_leaves", [(), ("pos", "front")], ids=["scene", "camera"])
def test_cuda_invert_frames_and_gradients_equal_the_plain_path(camera_leaves, cuda_device,
                                                               monkeypatch):
    """A differentiated 4-sample frame of invert's configuration at 96x64:
    one composite and one adjoint launch, the plain path's frame bit for bit
    and its gradients (p0, and the camera's with temperature > 0) as the
    sky compose's frame tests hold them."""
    sky = SKIES["gradient"](cuda_device)
    mk.reset_launch_counts()
    got = invert_frame(cuda_device, sky, spp=4, width=96, height=64,
                       camera_leaves=camera_leaves)
    torch.cuda.synchronize()
    assert mk.launch_counts["soft_silhouettes"] == 1
    assert mk.launch_counts["soft_silhouettes_adjoint"] == 1
    plain_path(monkeypatch)
    want = invert_frame(cuda_device, sky, spp=4, width=96, height=64,
                        camera_leaves=camera_leaves)
    assert mk.launch_counts["soft_silhouettes"] == 1
    assert torch.equal(got[0], want[0])
    for leaf, b in want[1].items():
        a = got[1][leaf]
        assert float(b.abs().max()) > 0, leaf
        scale = b.abs().amax(dim=0, keepdim=True) if b.dim() > 1 else b.abs().max()
        assert ((a - b).abs() <= 2e-3 * b.abs() + 2e-4 * scale).all(), leaf


@pytest.mark.gpu
def test_cuda_plain_render_launches_neither_kernel(cuda_device, monkeypatch):
    """render_image, the plain reference, composites with
    soft_silhouette_composite on the card and launches no kernel."""
    calls = count_composites(monkeypatch)
    sky = SKIES["gradient"](cuda_device)
    before = dict(mk.launch_counts)
    with torch.no_grad():
        scene = parse_scene_string(SCENE_2_TEXT, device=cuda_device)
        cfg = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                           soft_silhouette_temp=TEMP)
        plain = integrator.render_image(scene, Camera.default(cuda_device), 96, 64, seed=5,
                                        spp=4, config=cfg, cubemap=sky)
    torch.cuda.synchronize()
    assert mk.launch_counts == before
    assert calls == {"plain": 1, "kernel_path": 0}
    with torch.no_grad():
        fused = mk.render_image_cuda(scene, Camera.default(cuda_device), 96, 64, seed=5, spp=4,
                                     config=cfg, cubemap=sky)
    assert torch.equal(plain, fused)


@pytest.mark.gpu
def test_cuda_a_sky_that_requires_grad_keeps_the_plain_composite(cuda_device, monkeypatch):
    """A float sky whose planes require grad: the plain composite and the
    plain sky step, no launch of either soft-silhouette kernel, and the
    sky's gradient."""
    calls = count_composites(monkeypatch)
    base = SKIES["gradient"](cuda_device)
    leaves = [base.r.clone().requires_grad_(True), base.g.clone().requires_grad_(True),
              base.b.clone().requires_grad_(True)]
    sky = dataclasses.replace(base, r=leaves[0], g=leaves[1], b=leaves[2])
    scene = parse_scene_string(SCENE_2_TEXT, device=cuda_device)
    cfg = RenderConfig(bounces=3, shadow_samples=2, env_filter="bilinear",
                       soft_silhouette_temp=TEMP)
    before = dict(mk.launch_counts)
    img = mk.render_image_cuda(scene, Camera.default(cuda_device), 96, 64, seed=5, spp=2,
                               config=cfg, cubemap=sky)
    grads = torch.autograd.grad(((img - 0.4) ** 2).sum(), leaves)
    torch.cuda.synchronize()
    assert calls == {"plain": 1, "kernel_path": 0}
    assert mk.launch_counts["soft_silhouettes"] == before["soft_silhouettes"]
    assert mk.launch_counts["soft_silhouettes_adjoint"] == before["soft_silhouettes_adjoint"]
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.gpu
def test_cuda_a_differentiated_invert_frame_keeps_under_44_planes(cuda_device):
    nbytes, img = saved_bytes(cuda_device)
    assert img.requires_grad
    assert nbytes <= SAVED_PLANES_BOUND * 96 * 64 * 4
