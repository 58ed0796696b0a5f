"""kernels/megakernel of the PyTorch port: its plain estimator
(tile_physics, the plain version of the CUDA kernel) against the JAX
package's tile_physics under the same injected draws, and the wrapper's
behaviour without a card.

Tolerance: at least 99.9 % of the pixels of every plane within rtol=2e-3,
atol=2e-4 (the JAX package's own bar between its unrolled and scan traces)
and every plane's mean within 1e-4 plus 2/size for each flipped pixel. The
pixels outside the tolerance are decision flips: a last-bit difference turns
a hit into a miss or a specular bounce into a diffuse one, and the whole
pixel differs, by at most 2 in a direction plane (range [-1, 1]), which on a
2048-pixel tile moves that plane's mean by 1e-3. Their count is printed."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.kernels import megakernel as jmk
from ray_tracing_tpu.render.camera import Camera as JCamera

from ray_tracing_tpu_torch.config import RenderConfig as TCfg
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.render.camera import Camera as TCamera, camera_pack
from ray_tracing_tpu_torch.scene.parser import parse_objects
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects

import torch_port_util as U

SHAPE = (16, 128)
RTOL, ATOL, SHARE, MEAN_TOL = 2e-3, 2e-4, 0.999, 1e-4

CASES = {
    # name: (specs, bounces, shadow_samples, zoom)
    "scene_2": (lambda: parse_objects(SCENE_2_TEXT), 10, 3, (0.4, 0.08)),
    "room_one_light": (lambda: parse_objects(ROOM_TEXT), 3, 2, (1.0, 1.0)),
    "sixty_two_lights": (lambda: random_objects(60, seed=1, lights=(7, 20)), 3, 2, (1.0, 1.0)),
}


def _uv(zoom):
    """Screen coordinates of the tile, drawn in toward the middle of the
    screen by `zoom` (for u, for v) so that most lanes look at the scene."""
    xs = np.broadcast_to(np.arange(SHAPE[1], dtype=np.float32), SHAPE)
    ys = np.broadcast_to(np.arange(SHAPE[0], dtype=np.float32)[:, None], SHAPE)
    u = 0.5 + zoom[0] * (0.5 - xs / (SHAPE[1] - 1))
    v = 0.5 + zoom[1] * (0.5 - ys / (SHAPE[0] - 1))
    return u.astype(np.float32), v.astype(np.float32)


def _run_both(name, record=False):
    make, bounces, ns, zoom = CASES[name]
    js, ts = U.scene_pair(make())
    jcfg, tcfg = JCfg(bounces=bounces, shadow_samples=ns), TCfg(bounces=bounces, shadow_samples=ns)
    draws = U.FixedDraws(9, bounces, ns, SHAPE)
    u, v = _uv(zoom)
    jcam = jmk._camera_pack(JCamera.default(), 2.0, jcfg)
    tcam = camera_pack(TCamera.default("cpu"), 2.0, tcfg)
    np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), rtol=1e-6, atol=1e-6)

    jtracer = jmk.IndexRecordingTracer(js) if record else None
    jout = jmk.tile_physics(js, jcam, jnp.asarray(u), jnp.asarray(v), draws.jax, jcfg, SHAPE,
                            tracer=jtracer)
    view = tmk.SceneView(ts.packed_rows(), ts.obj_type, ts.light_index, ts.emissive)
    ttracer = tmk.IndexRecordingTracer(view) if record else None
    tout = tmk.tile_physics(view, tcam, torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
                            draws.torch, tcfg, SHAPE, tracer=ttracer)
    return js, jout, tout, jtracer, ttracer


@pytest.mark.parametrize("name", list(CASES))
def test_tile_physics_matches_jax(name):
    js, jout, tout, _, _ = _run_both(name)
    if name == "sixty_two_lights":
        assert js.num_objects > 48  # the JAX side takes its scan tier
    assert len(tout) == 10
    ok = np.ones(SHAPE, bool)
    for a, b in zip(tout, jout):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == SHAPE and a.dtype == np.float32 and np.isfinite(a).all()
        ok &= np.abs(a - b) <= ATOL + RTOL * np.abs(b)
    flipped = int((~ok).sum())
    print(f"{name}: {flipped} of {ok.size} pixels flipped a decision")
    assert ok.mean() >= SHARE, ok.mean()
    for k, (a, b) in enumerate(zip(tout, jout)):
        a, b = a.numpy(), np.asarray(b)
        assert abs(a.mean() - b.mean()) < MEAN_TOL + 2.0 * flipped / ok.size, (k, a.mean(), b.mean())


@pytest.mark.parametrize("name", list(CASES))
def test_winner_index_planes_match_jax(name):
    _, jout, tout, jtracer, ttracer = _run_both(name, record=True)
    assert len(ttracer.objs) == len(jtracer.objs)
    n_same = n_all = 0
    for a, b in zip(ttracer.objs, jtracer.objs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.int32
        n_same += int((a == b).sum())
        n_all += a.size
    print(f"{name}: {n_all - n_same} of {n_all} winner indices differ")
    first = ttracer.objs[0].numpy()
    assert 0.2 < (first >= 0).mean() and (first < 0).any()  # objects and sky
    assert n_same / n_all >= SHARE
    # recording changes nothing in the ten planes
    plain = _run_both(name)[2]
    for a, b in zip(tout, plain):
        assert a.equal(b)


@pytest.mark.parametrize("name,has_light", [("scene_2", False), ("room_one_light", True)])
def test_record_layout_order(name, has_light):
    """Per bounce the primary plane, then one plane per shadow sample."""
    make = CASES[name][0]
    _, ts = U.scene_pair(make())
    cfg = TCfg(bounces=2, shadow_samples=2)
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 32, 8, cfg)
    planes, recs = tmk.run_tiles(job, seed=4, record=True)
    ns = 2 if has_light else 0
    assert tmk.record_layout(cfg, has_light) == 2 * (1 + ns) == recs.shape[0]
    assert recs.dtype == tmk.record_dtype(ts.num_objects) == torch.int8
    assert tuple(recs.shape[1:]) == (8, 32)
    assert planes.shape == (10, 8, 32)
    assert int(recs.min()) >= -1 and int(recs.max()) < ts.num_objects
    if has_light:
        li = ts.light_index
        for b in range(2):
            shadow = recs[b * 3 + 1:b * 3 + 3]
            assert set(shadow.unique().tolist()) <= {-1, li}  # occlusion trace
    plain_planes, none = tmk.run_tiles(job, seed=4)
    assert none is None and plain_planes.equal(planes)


DEAD_LANE_SCENES = {
    "scene_2": lambda: parse_objects(SCENE_2_TEXT),
    "room": lambda: parse_objects(ROOM_TEXT),
    "sixty_two_lights_full_scan": lambda: random_objects(60, seed=1, lights=(7, 20)),
}


def _raw_records(job, seed):
    """The IndexRecordingTracer's planes of one plain sample, before the
    dead-lane rule: what run_tiles_plain(record=True) starts from."""
    u, v, draws = tmk._sample_inputs(job, seed, 0)
    view = tmk.SceneView(job.rows, job.obj_type, job.light_index, job.emissive)
    tracer = tmk.IndexRecordingTracer(view)
    tmk.tile_physics(view, job.cam_pack, u, v, draws, job.config, (job.height, job.width),
                     tracer=tracer)
    return torch.cat([o.reshape(-1, job.height, job.width) for o in tracer.objs]).to(torch.int32)


@pytest.mark.parametrize("name", list(DEAD_LANE_SCENES))
def test_plain_records_follow_the_dead_lane_rule(name):
    """run_tiles_plain(record=True): every shadow entry of a bounce whose
    primary entry is -1 is -1, every other entry is the raw tracer's."""
    _, ts = U.scene_pair(DEAD_LANE_SCENES[name]())
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 48, 27, TCfg())
    if name == "sixty_two_lights_full_scan":
        assert job.single_emissive == -1 and job.ns == 3
    raw = _raw_records(job, seed=7)
    planes, recs = tmk.run_tiles_plain(job, 7, record=True)
    assert recs.shape == raw.shape and recs.dtype == tmk.record_dtype(len(job.obj_type))
    recs = recs.to(torch.int32)  # compared with the tracer's entries, widened back
    per = 1 + job.ns
    overwritten = 0
    for b in range(job.config.bounces):
        dead = raw[b * per] < 0
        assert recs[b * per].equal(raw[b * per])
        for s in range(job.ns):
            got, was = recs[b * per + 1 + s], raw[b * per + 1 + s]
            assert (got[dead] == -1).all()
            assert got[~dead].equal(was[~dead])
            overwritten += int((was[dead] != -1).sum())
    if job.ns:  # the rule is not empty on a lit scene: frozen rays do reach the light
        assert overwritten > 0
    print(f"{name}: {overwritten} shadow entries of dead lanes overwritten")
    assert tmk.dead_lane_rule(recs, job.ns).equal(recs)  # applying it again changes nothing
    assert planes.equal(tmk.run_tiles_plain(job, 7)[0])


@pytest.mark.parametrize("n_objects,dtype", [(1, torch.int8), (127, torch.int8),
                                              (128, torch.int16), (32767, torch.int16),
                                              (32768, torch.int32)])
def test_record_dtype_is_the_narrowest_that_holds_every_index(n_objects, dtype):
    got = tmk.record_dtype(n_objects)
    assert got == dtype
    info = torch.iinfo(got)
    assert info.min <= -1 and n_objects - 1 <= info.max  # the miss and the last object
    if got != torch.int8:  # the narrowest type whose range holds the count itself
        assert n_objects > torch.iinfo({torch.int16: torch.int8,
                                        torch.int32: torch.int16}[got]).max


NARROW_SCENES = {
    "scene_2": (lambda: parse_objects(SCENE_2_TEXT), torch.int8),
    "one_hundred_thirty_objects": (lambda: random_objects(130, seed=5, lights=(7,)), torch.int16),
}


@pytest.mark.parametrize("name", list(NARROW_SCENES))
def test_plain_records_are_narrow_and_equal_the_int32_tracers(name):
    """run_tiles_plain(record=True) keeps record_dtype's width, and its
    entries are the int32 tracer's after the dead-lane rule, every one."""
    make, dtype = NARROW_SCENES[name]
    _, ts = U.scene_pair(make())
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 40, 24, TCfg(bounces=3, shadow_samples=2))
    raw = _raw_records(job, seed=6)
    _, recs = tmk.run_tiles_plain(job, 6, record=True)
    assert recs.dtype == dtype == tmk.record_dtype(ts.num_objects)
    want = tmk.dead_lane_rule(raw, job.ns)
    assert want.dtype == torch.int32 and recs.shape == want.shape
    assert torch.equal(recs.to(torch.int32), want)
    assert int(want.max()) > 0 and int(want.min()) == -1
    if dtype == torch.int16:  # indices past int8's range are kept
        assert int(want.max()) > 127


def test_fetch_budget_counts_the_bytes_of_an_index():
    """effective_bwd_mode weighs the index planes at record_dtype's width:
    a frame that 4 bytes an index would push past the budget stays in
    "fetch" at one byte, and goes to "replay" only past one byte's count."""
    scene = U.scene_pair(parse_objects(SCENE_2_TEXT))[1]
    cfg = TCfg(bounces=10)
    entries = 8 * tmk.record_layout(cfg, False) * 64 * 48  # spp * n_rec * H * W
    assert tmk.record_dtype(scene.num_objects).itemsize == 1
    real = tmk.FETCH_RECORD_BUDGET_BYTES
    try:
        tmk.FETCH_RECORD_BUDGET_BYTES = 2 * entries  # under the 4 * entries of int32
        assert tmk.effective_bwd_mode(scene, cfg, 64, 48, 8) == "fetch"
        tmk.FETCH_RECORD_BUDGET_BYTES = entries - 1
        assert tmk.effective_bwd_mode(scene, cfg, 64, 48, 8) == "replay"
    finally:
        tmk.FETCH_RECORD_BUDGET_BYTES = real


def test_the_recording_span_counts_the_bytes_of_its_index_planes():
    """kernel.megakernel_fwd_record counts `index_bytes`, which over
    n_rec * H * W gives the width in force; the plain launch counts none."""
    from ray_tracing_tpu_torch.utils import profiling

    for make, width in ((lambda: parse_objects(ROOM_TEXT), 1),
                        (lambda: random_objects(130, seed=5, lights=(7,)), 2)):
        _, ts = U.scene_pair(make())
        job = tmk.make_tile_job(ts, TCamera.default("cpu"), 16, 8,
                                TCfg(bounces=2, shadow_samples=2))
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _, recs = tmk.run_tiles(job, seed=3, record=True)
            tmk.run_tiles(job, seed=3)
        spans = [(name, counts) for name, *_, counts in profiling.recorded()]
        profiling.clear()
        n_rec = tmk.record_layout(job.config, True)
        assert spans == [("kernel.megakernel_fwd_record", {"index_bytes": n_rec * 8 * 16 * width}),
                         ("kernel.megakernel_fwd", {})]
        assert recs.numel() * recs.element_size() == n_rec * 8 * 16 * width == tmk.record_bytes(job)


def test_shadow_samples_zero_is_the_no_light_path():
    _, ts = U.scene_pair(parse_objects(ROOM_TEXT))
    job = tmk.make_tile_job(ts, TCamera.default("cpu"), 16, 8, TCfg(bounces=2, shadow_samples=0))
    assert job.light_index == -1 and job.ns == 0 and job.single_emissive == 7
    _, recs = tmk.run_tiles(job, seed=1, record=True)
    assert recs.shape[0] == 2


def test_pixel_jitter_moves_samples_inside_the_pixel():
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    cam = TCamera.default("cpu")
    a, _ = tmk.run_tiles(tmk.make_tile_job(ts, cam, 48, 32, TCfg(bounces=1)), seed=2)
    b, _ = tmk.run_tiles(tmk.make_tile_job(ts, cam, 48, 32, TCfg(bounces=1, pixel_jitter=True)), seed=2)
    assert not a.equal(b)
    assert (a[9] != b[9]).float().mean() < 0.1  # only silhouette pixels change


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    with pytest.raises(ValueError):
        tmk._check_tensor("rows", torch.zeros(3, 16)[:, ::2], (3, 8), torch.float32,
                          torch.device("cpu"))
    with pytest.raises(TypeError):
        tmk._check_tensor("rows", torch.zeros(3, 16, dtype=torch.float64), (3, 16),
                          torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError):
        tmk.render_frame(tmk.make_tile_job(ts, TCamera.default("cpu"), 8, 8), tmk.run_tiles, 0, 0, None)


def test_launch_counts_do_not_move_on_the_cpu():
    _, ts = U.scene_pair(parse_objects(SCENE_2_TEXT))
    tmk.reset_launch_counts()
    out = tmk.render_tiles_cuda(ts, TCamera.default("cpu"), 16, 8, seed=1, device="cpu", record=True)
    assert set(out) == set(tmk.PLANE_NAMES) | {"records"}
    for mode in ("fetch", "replay", "direct"):
        leaf = dataclasses.replace(ts, albedo=ts.albedo.clone().requires_grad_())
        tmk.render_image_cuda(leaf, TCamera.default("cpu"), 16, 8, seed=1, device="cpu",
                              config=TCfg(bwd_mode=mode)).sum().backward()
        assert leaf.albedo.grad is not None
    assert tmk.launch_counts == {"megakernel_fwd": 0, "megakernel_fwd_record": 0,
                                 "megakernel_bwd_fetch": 0, "megakernel_bwd_replay": 0,
                                 "megakernel_bwd_direct": 0, "sky_compose": 0,
                                 "sky_compose_adjoint": 0, "sky_compose_bilinear": 0,
                                 "sky_compose_bilinear_adjoint": 0, "soft_silhouettes": 0,
                                 "soft_silhouettes_adjoint": 0}


def test_sample_seeds_wrap_like_int32():
    assert tmk.sample_seeds(5, 1) == [5]
    assert tmk.sample_seeds(5, 3) == [5 * 7919, 5 * 7919 + 1, 5 * 7919 + 2]
    want = ((300000 * 7919 + 1 + 2**31) % 2**32) - 2**31
    assert tmk.sample_seeds(300000, 2)[1] == want and -2**31 <= want < 2**31


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_plain_version(name, cuda_device):
    make, bounces, ns, _ = CASES[name]
    _, ts = U.scene_pair(make())
    cfg = TCfg(bounces=bounces, shadow_samples=ns)
    job = tmk.make_tile_job(ts.to(cuda_device), TCamera.default(cuda_device), 256, 144, cfg)
    before = dict(tmk.launch_counts)
    planes, recs = tmk.run_tiles(job, seed=11, record=True)
    torch.cuda.synchronize()
    assert tmk.launch_counts["megakernel_fwd_record"] == before["megakernel_fwd_record"] + 1
    want_p, want_r = tmk.run_tiles_plain(job, seed=11, record=True)
    ok = ((planes - want_p).abs() <= 1e-4).all(dim=0)
    assert ok.float().mean() >= 0.995
    assert (recs == want_r).all(dim=0).float().mean() >= 0.995


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NARROW_SCENES))
def test_cuda_recording_kernel_writes_narrow_planes(name, cuda_device):
    """K2 at both widths (int8 on scene_2, int16 at 130 objects): its planes
    have run_tiles_plain's dtype and entries, and its span counts the bytes
    it wrote."""
    from ray_tracing_tpu_torch.utils import profiling

    make, dtype = NARROW_SCENES[name]
    _, ts = U.scene_pair(make())
    job = tmk.make_tile_job(ts.to(cuda_device), TCamera.default(cuda_device), 256, 144,
                            TCfg(bounces=3, shadow_samples=2))
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        planes, recs = tmk.run_tiles(job, seed=12, record=True)
        torch.cuda.synchronize()
    counted = [c for n, *_, c in profiling.recorded() if n == "kernel.megakernel_fwd_record"]
    profiling.clear()
    want_p, want_r = tmk.run_tiles_plain(job, seed=12, record=True)
    assert recs.dtype == want_r.dtype == dtype
    assert counted == [{"index_bytes": recs.numel() * dtype.itemsize}]
    assert ((planes - want_p).abs() <= 1e-4).all(dim=0).float().mean() >= 0.995
    assert (recs == want_r).all(dim=0).float().mean() >= 0.995

