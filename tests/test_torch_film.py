"""The port's progressive film (render/film.py) and render_pixels against
the JAX package. Mirrors tests/test_film.py: the grid, replication, pass
weights, the scale schedule and the resolve exactly; a port film against a
JAX film at converged means (the random streams differ); a pass of the
port exactly against its definition; the CUDA pass against the plain one
(on the CPU both run the plain estimator; `gpu`: K1 on the card)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.ops import cubemap as jcm
from ray_tracing_tpu.render import film as jfilm
from ray_tracing_tpu.render.camera import Camera as JCamera
from ray_tracing_tpu.render.integrator import render_pixels as j_render_pixels
from ray_tracing_tpu.scene.parser import parse_scene_string as j_parse

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops.cubemap import constant_sky, gradient_sky
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.camera import UP, Camera, move
from ray_tracing_tpu_torch.render.film import (
    Film,
    lowres_grid,
    pass_seed,
    progressive_scales,
    render_pass,
    render_pass_cuda,
    render_progressive,
    upsample_replicate,
)
from ray_tracing_tpu_torch.render.integrator import render_image, render_pixels
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT
from ray_tracing_tpu_torch.scene.types import ObjectSpec, Scene

import torch_port_util as U

CFG = RenderConfig(bounces=2, shadow_samples=1)
SKY_COLOR = (0.5, 0.6, 0.7)


def small_scene():
    return Scene.from_objects([
        ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3, roughness=1.0),
        ObjectSpec(kind="cube", p0=(-3.0, -0.6, -3.0), p1=(12.0, 0.5, 12.0)),
    ], device="cpu")


def sky():
    return constant_sky(SKY_COLOR, device="cpu")


@pytest.mark.parametrize("width,height,scale", [
    (33, 17, 4), (32, 24, 8), (96, 72, 1), (5, 3, 16), (320, 240, 2),
])
def test_lowres_grid_equals_jax(width, height, scale):
    uu, vv, lw, lh = lowres_grid(width, height, scale, device="cpu")
    juu, jvv, jlw, jlh = jfilm.lowres_grid(width, height, scale)
    assert (lw, lh) == (jlw, jlh)
    np.testing.assert_array_equal(uu.numpy(), np.asarray(juu))
    np.testing.assert_array_equal(vv.numpy(), np.asarray(jvv))


@pytest.mark.parametrize("lshape,scale,width,height", [
    ((2, 3), 2, 7, 5), ((4, 8), 4, 33, 17), ((3, 3), 1, 3, 3), ((1, 1), 16, 5, 3),
    ((15, 20), 8, 160, 120),
])
def test_upsample_replicate_equals_jax(lshape, scale, width, height):
    """Exact, with the edge-extended remainder and the crop."""
    a = np.random.default_rng(0).uniform(0, 1, (3, *lshape)).astype(np.float32)
    got = U.vec_np(upsample_replicate(U.tvec(a), scale, width, height))
    want = U.vec_np(jfilm.upsample_replicate(U.jvec(a), scale, width, height))
    assert got.shape == (3, height, width)
    np.testing.assert_array_equal(got, want)


def test_upsample_replicate_blocks():
    img = Vec3(torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.zeros(2, 3),
               torch.zeros(2, 3))
    x = upsample_replicate(img, 2, width=7, height=5).x.numpy()
    assert x.shape == (5, 7)
    assert x[0, 0] == 0 and x[1, 1] == 0 and x[0, 2] == 1 and x[3, 4] == 5
    assert x[0, 6] == 2 and x[4, 0] == 3  # edge-extended remainder


@pytest.mark.parametrize("init_scale", [1, 2, 4, 8, 16])
def test_progressive_scales_equal_jax(init_scale):
    assert progressive_scales(RenderConfig(init_scale=init_scale)) == \
        jfilm.progressive_scales(JCfg(init_scale=init_scale))


def test_pass_weights_equal_jax():
    """A scale-s pass weighs spp/s^2: the JAX plain pass's weights at spp 1,
    and the JAX kernel pass's accounting at spp 4."""
    cam, jcam = Camera.default("cpu"), JCamera.default()
    js = j_parse("sphere center {3 3 3} radius 1\n")
    jsky = jcm.constant_sky(SKY_COLOR)
    film, jf = Film.zero(32, 24, "cpu"), jfilm.Film.zero(32, 24)
    for n, scale in enumerate((4, 2, 1)):
        film = render_pass(small_scene(), cam, film, n, scale, CFG, sky(), device="cpu")
        jf = jfilm.render_pass(js, jcam, jf, jax.random.key(n), scale, JCfg(bounces=2,
                               shadow_samples=1), jsky)
        assert film.weight.dtype == torch.float32
        assert float(film.weight) == float(jf.weight)
    film = render_pass_cuda(small_scene(), cam, film, 7, 1, CFG, sky(), spp=4, device="cpu")
    assert float(film.weight) == 1 / 16 + 1 / 4 + 1 + 4
    film = render_pass_cuda(small_scene(), cam, film, 8, 2, CFG, sky(), spp=2, device="cpu")
    assert float(film.weight) == 1 / 16 + 1 / 4 + 1 + 4 + 0.5


@pytest.mark.parametrize("weight", [0.0, 1e-5, 1 / 64, 0.328125, 12.3125, 3.0])
def test_resolve_equals_jax(weight):
    """Exact: the same accum and weight resolve to the same bits."""
    a = np.random.default_rng(1).uniform(0, 7, (3, 6, 9)).astype(np.float32)
    film = Film(accum=U.tvec(a), weight=torch.tensor(weight, dtype=torch.float32))
    jf = jfilm.Film(accum=U.jvec(a), weight=jnp.float32(weight))
    got = film.resolve()
    assert got.shape == (6, 9, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.resolve()))


def test_empty_film_resolves_to_zero():
    img = Film.zero(8, 6, "cpu").resolve()
    assert img.shape == (6, 8, 3) and float(img.abs().max()) == 0.0


@pytest.mark.parametrize("scale,spp", [(1, 1), (1, 3), (2, 1), (4, 2), (8, 1)])
def test_pass_is_its_definition(scale, spp):
    """Exact on the port: a pass at scale s adds upsample_replicate of
    render_image(lw, lh, aspect=W/H) at the pass's sample seeds, times
    spp/s^2, to the old accum."""
    W, H, seed = 30, 22, 11
    scene, cam = parse_scene_string(ROOM_TEXT, device="cpu"), Camera.default("cpu")
    old = Film(accum=Vec3(*(torch.full((H, W), v) for v in (0.25, 0.5, 0.75))),
               weight=torch.tensor(1.5))
    got = render_pass(scene, cam, old, seed, scale, CFG, gradient_sky(8, device="cpu"),
                      spp=spp, device="cpu")
    lw, lh = max(W // scale, 1), max(H // scale, 1)
    render_seed = tmk._wrap_i32(seed * 7919) if spp == 1 else seed
    img = render_image(scene, cam, lw, lh, render_seed, spp=spp, config=CFG,
                       cubemap=gradient_sky(8, device="cpu"), aspect=W / H, device="cpu")
    full = upsample_replicate(Vec3(img[..., 0], img[..., 1], img[..., 2]), scale, W, H)
    w = spp / scale ** 2
    want = old.accum + full * w
    for g, e in zip((got.accum.x, got.accum.y, got.accum.z), (want.x, want.y, want.z)):
        assert g.equal(e)
    assert float(got.weight) == 1.5 + w


def test_samples_of_a_session_never_repeat(monkeypatch):
    """The viewer's pass policy over a session that restarts its pyramid:
    every sample handed to the estimator has a seed of its own."""
    from ray_tracing_tpu_torch.apps.cli import make_cuda_render_fn

    seen = []
    real = tmk.run_tiles_grad

    def spy(job, seed, row0=0):
        seen.append(seed)
        return real(job, seed, row0)

    monkeypatch.setattr(tmk, "run_tiles_grad", spy)
    cfg = RenderConfig(bounces=1, shadow_samples=0, init_scale=4)
    render_fn = make_cuda_render_fn(cfg, sky(), "cpu")
    film, total = Film.zero(8, 6, "cpu"), 0
    for n in range(14):
        if n == 7:
            film = Film.zero(8, 6, "cpu")  # invalidated mid-session
        scale = progressive_scales(cfg)[min(n % 7, 2)]
        film, spp = render_fn(small_scene(), Camera.default("cpu"), film,
                              pass_seed(2**31 - 5, n), scale)
        total += spp
    assert len(seen) == total == 2 * (2 + 5 * 4)
    assert len(set(seen)) == len(seen)


def test_pass_seed_is_the_step_seed_mix():
    from ray_tracing_tpu_torch.diff.inverse import step_seed

    for seed, n in ((0, 0), (7, 3), (2**31 - 1, 99), (-5, 12)):
        assert pass_seed(seed, n) == step_seed(seed, n)


@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_cuda_pass_equals_plain_pass_on_the_cpu(text):
    """render_pass_cuda through the pyramid and a full-res pass equals
    render_pass bit for bit (on the CPU the wrapper runs the kernel's plain
    version; `gpu` below runs K1)."""
    from ray_tracing_tpu_torch.ops.cubemap import checker_sky

    scene, cam = parse_scene_string(text, device="cpu"), Camera.default("cpu")
    cfg, cm = RenderConfig(bounces=3, shadow_samples=2, init_scale=8), checker_sky(32, device="cpu")
    plain, cuda = Film.zero(40, 30, "cpu"), Film.zero(40, 30, "cpu")
    for n, scale in enumerate(progressive_scales(cfg) + [1]):
        spp = 1 if scale != 1 else 2
        plain = render_pass(scene, cam, plain, pass_seed(3, n), scale, cfg, cm, spp=spp,
                            device="cpu")
        cuda = render_pass_cuda(scene, cam, cuda, pass_seed(3, n), scale, cfg, cm, spp=spp,
                                device="cpu")
    assert cuda.resolve().equal(plain.resolve())
    assert float(cuda.weight) == float(plain.weight) == 1 / 64 + 1 / 16 + 1 / 4 + 4


def test_progressive_film_matches_jax_film_at_converged_means():
    """scene_2 at 96x72, the pyramid plus 64 full-res samples in each
    package; tolerance as test_torch_slice.py's converged render."""
    jcfg, tcfg = JCfg(bounces=3, shadow_samples=2), RenderConfig(bounces=3, shadow_samples=2)
    js, jcam = j_parse(SCENE_2_TEXT), JCamera.default()
    jsky = jcm.constant_sky((0.6, 0.7, 0.9))
    step = jax.jit(jfilm.render_pass, static_argnames=("scale", "config"))
    jf = jfilm.Film.zero(96, 72)
    for n, s in enumerate(jfilm.progressive_scales(jcfg) + [1] * 63):
        jf = step(js, jcam, jf, jax.random.fold_in(jax.random.key(3), n), scale=s,
                  config=jcfg, cubemap=jsky)
    want = np.asarray(jf.resolve())

    film = render_progressive(parse_scene_string(SCENE_2_TEXT, device="cpu"),
                              Camera.default("cpu"), 96, 72, 3, num_full_passes=64,
                              config=tcfg, cubemap=constant_sky((0.6, 0.7, 0.9), device="cpu"),
                              device="cpu")
    got = film.resolve().numpy()
    assert float(film.weight) == float(jf.weight) == 1 / 64 + 1 / 16 + 1 / 4 + 64
    assert abs(got.mean() - want.mean()) < 0.01
    assert np.abs(got - want).mean() < 0.03
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_invalidation_is_a_fresh_film():
    """The camera moved: start over (invalidate_accumulation,
    src/main.c:115-124) from a zero film."""
    cam = Camera.default("cpu")
    f1 = render_pass(small_scene(), cam, Film.zero(16, 12, "cpu"), 0, 1, CFG, sky(),
                     device="cpu")
    f2 = render_pass(small_scene(), move(cam, UP, 0.5), Film.zero(16, 12, "cpu"), 0, 1, CFG,
                     sky(), device="cpu")
    assert float(f2.weight) == 1.0
    assert float((f1.resolve() - f2.resolve()).abs().max()) > 0


def test_render_pixels_is_render_image_on_the_pixel_grid():
    from ray_tracing_tpu_torch.render.camera import pixel_grid

    scene, cam = parse_scene_string(ROOM_TEXT, device="cpu"), Camera.default("cpu")
    cm = gradient_sky(8, device="cpu")
    u, v = pixel_grid(24, 16, device="cpu")
    got = render_pixels(scene, cam, u, v, 24 / 16, seed=5, config=CFG, cubemap=cm,
                        device="cpu")
    want = render_image(scene, cam, 24, 16, 5, config=CFG, cubemap=cm, device="cpu")
    assert got.to_array().equal(want)


def test_render_pixels_equals_jax_where_no_draw_is_taken():
    """One bounce without shadow rays takes no random number: at arbitrary
    screen coordinates the two packages' pixel() agree to float rounding."""
    specs = parse_scene_string(ROOM_TEXT, device="cpu").to_objects()
    js, ts = U.scene_pair(specs)
    rng = np.random.default_rng(7)
    u = rng.uniform(0, 1, (9, 13)).astype(np.float32)
    v = rng.uniform(0, 1, (9, 13)).astype(np.float32)
    cfg_kw = dict(bounces=1, shadow_samples=0, env_filter="bilinear")
    faces = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    want = U.vec_np(j_render_pixels(js, JCamera.default(), jnp.asarray(u), jnp.asarray(v),
                                    1.5, jax.random.key(0), JCfg(**cfg_kw),
                                    jcm.CubemapData.from_faces(faces)))
    from ray_tracing_tpu_torch.ops.cubemap import CubemapData

    got = U.vec_np(render_pixels(ts, Camera.default("cpu"), u, v, 1.5, seed=0,
                                 config=RenderConfig(**cfg_kw),
                                 cubemap=CubemapData.from_faces(faces, device="cpu"),
                                 device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_cuda_pass_equals_plain_pass_on_the_card(text, cuda_device):
    """render_pass_cuda (K1, one launch per sample) against render_pass on
    the card, with the same seeds: the films within 1e-6."""
    from ray_tracing_tpu_torch.apps.cli import make_cuda_render_fn
    from ray_tracing_tpu_torch.ops.cubemap import checker_sky

    scene, cam = parse_scene_string(text, device=cuda_device), Camera.default(cuda_device)
    cfg, cm = RenderConfig(init_scale=8), checker_sky(256, device=cuda_device)
    render_fn = make_cuda_render_fn(cfg, cm, cuda_device)
    cuda, plain, total = Film.zero(160, 120, cuda_device), Film.zero(160, 120, cuda_device), 0
    before = tmk.launch_counts["megakernel_fwd"]
    for n, scale in enumerate(progressive_scales(cfg) + [1, 1]):
        cuda, spp = render_fn(scene, cam, cuda, pass_seed(9, n), scale)
        plain = render_pass(scene, cam, plain, pass_seed(9, n), scale, cfg, cm, spp=spp,
                            device=cuda_device)
        total += spp
    torch.cuda.synchronize()
    assert tmk.launch_counts["megakernel_fwd"] - before == total
    assert float((cuda.resolve() - plain.resolve()).abs().max()) <= 1e-6
