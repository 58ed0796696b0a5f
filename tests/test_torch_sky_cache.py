"""The sparse sky cache of the PyTorch port: ops/cubemap.py::sparse_sky_lookup
against the JAX package's, and render_image_cuda's sky_cache /
return_sky_cache (the plain path, device="cpu"), with the sparse lookup
off (the default: every sample gathers in full) and on.

Tolerance: none. The lookup returns integer texels and must equal the JAX
function's bit for bit on the cases of the JAX package's own test (both
budget tiers, the full-gather arm, block-concentrated fresh pixels, a size
that is not a multiple of the block). A render through the cache, threaded,
stale or seeded by its first sample, must equal the render through the full
lookup bit for bit, and so must its gradients.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tracing_tpu.ops import cubemap as jcm

from ray_tracing_tpu_torch import compat
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff.inverse import SCENE_PARAM_FIELDS
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.render.camera import Camera, rotate
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT

BLOCK = tcm.SPARSE_BLOCK
FACES = np.random.default_rng(3).integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
N_TEXELS = 6 * 8 * 8
CFG = RenderConfig(bounces=2, shadow_samples=1)  # sky_sparse_gather off
SPARSE = CFG.replace(sky_sparse_gather=True)


@pytest.fixture(scope="module")
def cubemaps():
    return jcm.CubemapData.from_faces(FACES), tcm.CubemapData.from_faces(FACES, device="cpu")


def both(cubemaps, flat, need, cache=None, budget=None):
    """The JAX and the port's lookup of the same numpy inputs, as numpy."""
    jcmap, tcmap = cubemaps
    if cache is None:
        want = jcm.sparse_sky_lookup(jcmap, jnp.asarray(flat), jnp.asarray(need), budget=budget)
        got = tcm.sparse_sky_lookup(tcmap, torch.from_numpy(flat), torch.from_numpy(need),
                                    budget=budget)
    else:
        cflat, cpacked, cvalid = cache
        want = jcm.sparse_sky_lookup(jcmap, jnp.asarray(flat), jnp.asarray(need),
                                     jnp.asarray(cflat), jnp.asarray(cpacked),
                                     jnp.asarray(cvalid), budget)
        tf, tp, tv = compat.sky_cache_from_jax(cflat, cpacked, cvalid, device="cpu")
        got = tcm.sparse_sky_lookup(tcmap, torch.from_numpy(flat), torch.from_numpy(need),
                                    tf, tp, tv, budget)
    return np.asarray(want).astype(np.int64), got.numpy().astype(np.int64)


@pytest.fixture
def tiers(monkeypatch):
    """The budgets (in blocks) of the compacted gathers that ran."""
    ran = []
    orig = tcm._compacted_gather

    def spy(cubemap, flat, fb, bb):
        ran.append(bb)
        return orig(cubemap, flat, fb, bb)

    monkeypatch.setattr(tcm, "_compacted_gather", spy)
    return ran


@pytest.mark.parametrize("live_frac,budget", [(0.02, 4), (0.5, 2), (0.9, 1)])
def test_sparse_lookup_equals_jax_with_and_without_a_cache(cubemaps, live_frac, budget):
    rng = np.random.default_rng(int(live_frac * 100) + budget)
    shape = (8, BLOCK)
    flat = rng.integers(0, N_TEXELS, shape).astype(np.int32)
    need = rng.random(shape) < live_frac
    cache_flat = np.where(rng.random(shape) < 0.5, flat, -1).astype(np.int32)
    cache_valid = rng.random(shape) < 0.7
    cache_packed = np.asarray(jcm.CubemapData.from_faces(FACES).packed)[
        np.clip(cache_flat, 0, N_TEXELS - 1)]
    full = np.where(need, np.asarray(cubemaps[0].packed)[flat], 0).astype(np.int64)
    for cache in (None, (cache_flat, cache_packed, cache_valid)):
        want, got = both(cubemaps, flat, need, cache, budget)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("fresh_blocks,tier", [(1, 1), (3, 4)])
def test_sparse_lookup_compacted_tiers_run_and_equal_jax(cubemaps, tiers, fresh_blocks, tier):
    """Fresh pixels concentrated in a few blocks: the compacted gather of
    the small tier (budget // 4 = 1 block) or of the large one (4 blocks)
    runs, not the full arm."""
    rng = np.random.default_rng(fresh_blocks)
    flat = rng.integers(0, N_TEXELS, (8, BLOCK)).astype(np.int32)
    need = np.zeros((8, BLOCK), bool)
    for b in rng.choice(8, fresh_blocks, replace=False):
        need[b, rng.choice(BLOCK, 9, replace=False)] = True
    want, got = both(cubemaps, flat, need, budget=4)
    np.testing.assert_array_equal(got, want)
    assert tiers == [tier]


def test_sparse_lookup_full_arm_when_past_the_budget_or_off_the_block(cubemaps, tiers):
    rng = np.random.default_rng(9)
    flat = rng.integers(0, N_TEXELS, (8, BLOCK)).astype(np.int32)
    need = rng.random((8, BLOCK)) < 0.5  # every block fresh: past 2 blocks
    want, got = both(cubemaps, flat, need, budget=2)
    np.testing.assert_array_equal(got, want)
    flat = rng.integers(0, N_TEXELS, 100).astype(np.int32)  # not a multiple of 128
    need = rng.random(100) < 0.5
    want, got = both(cubemaps, flat, need, budget=2)
    np.testing.assert_array_equal(got, want)
    assert tiers == []


def test_unpack_texels_equals_jax(cubemaps):
    packed = cubemaps[0].packed
    want = jcm.unpack_texels(packed)
    got = tcm.unpack_texels(cubemaps[1].packed)
    for w, g in zip((want.x, want.y, want.z), (got.x, got.y, got.z)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sky_cache_from_jax_crops_and_checks():
    flat = np.arange(12, dtype=np.int32).reshape(3, 4)
    packed = (flat * 1000).astype(np.uint32)
    miss = flat % 2 == 0
    f, p, m = compat.sky_cache_from_jax(flat, packed, miss, height=2, width=3, device="cpu")
    assert (f.dtype, p.dtype, m.dtype) == (torch.int32, torch.int32, torch.bool)
    np.testing.assert_array_equal(p.numpy(), packed[:2, :3])
    with pytest.raises(ValueError):
        compat.sky_cache_from_jax(flat, packed | np.uint32(1 << 24), miss, device="cpu")


# -- the renderer ---------------------------------------------------------


def _scene(text):
    return parse_scene_string(text, device="cpu")


def _render(scene, camera, sky, seed, spp, cfg=CFG, **kw):
    return mk.render_image_cuda(scene, camera, 128, 32, seed, spp=spp, config=cfg,
                                cubemap=sky, device="cpu", **kw)


def _uncached(scene, camera, sky, seed, spp):
    """The full lookup with no cache at all (the plain render_image)."""
    return render_image(scene, camera, 128, 32, seed, spp=spp, config=CFG, cubemap=sky,
                        device="cpu")


@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_cached_renders_equal_the_full_lookup(text):
    """With the sparse lookup off and on: seeded by sample 0, threaded from
    an earlier call, stale from a turned camera, and one sample with a cache
    (which keeps the uncached sample's seed), each equals the render that
    keeps no cache; and a cache of either mode serves the other."""
    scene, cam = _scene(text), Camera.default("cpu")
    sky = tcm.checker_sky(16, device="cpu")
    full = _uncached(scene, cam, sky, 7, 2)
    moved = rotate(cam, 400.0, 120.0, CFG)
    want_moved = _uncached(scene, moved, sky, 9, 2)
    want1 = _uncached(scene, cam, sky, 11, 1)
    caches = {}
    for name, cfg in (("full", CFG), ("sparse", SPARSE)):
        img0, cache = _render(scene, cam, sky, 7, 2, cfg, return_sky_cache=True)
        assert cache is not None and tuple(cache[0].shape) == (32, 128)
        assert torch.equal(img0, full), name
        img1, cache1 = _render(scene, cam, sky, 7, 2, cfg, sky_cache=cache,
                               return_sky_cache=True)
        assert torch.equal(img1, full) and all(a is b for a, b in zip(cache, cache1)), name
        assert torch.equal(_render(scene, moved, sky, 9, 2, cfg, sky_cache=cache), want_moved)
        assert torch.equal(_render(scene, cam, sky, 11, 1, cfg, sky_cache=cache), want1)
        caches[name] = cache
    for a, b in zip(caches["full"], caches["sparse"]):
        assert torch.equal(a, b)


def test_no_cache_where_none_can_be_used():
    scene, cam = _scene(SCENE_2_TEXT), Camera.default("cpu")
    checker = tcm.checker_sky(16, device="cpu")
    for base in (CFG, SPARSE):
        for sky, cfg in ((tcm.constant_sky((0.3, 0.4, 0.5), device="cpu"), base),
                         (checker, base.replace(env_filter="bilinear")),
                         (tcm.gradient_sky(8, device="cpu"), base)):
            _, cache = _render(scene, cam, sky, 3, 2, cfg, return_sky_cache=True)
            assert cache is None
        _, cache = _render(scene, cam, checker, 3, 1, base, return_sky_cache=True)
        assert cache is None  # one sample and no cache: nothing to reuse


def test_default_lookup_never_reads_the_host(monkeypatch):
    """Off, the default, the cache is kept without the sparse lookup and
    its per-sample host read; on, the sparse lookup runs every sample."""
    scene, cam = _scene(SCENE_2_TEXT), Camera.default("cpu")
    sky = tcm.checker_sky(16, device="cpu")
    calls = []
    orig = mk.sparse_sky_lookup

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(mk, "sparse_sky_lookup", spy)
    _, cache = _render(scene, cam, sky, 3, 3, return_sky_cache=True)
    _render(scene, cam, sky, 4, 3, sky_cache=cache)
    assert cache is not None and calls == []
    _render(scene, cam, sky, 4, 3, SPARSE, sky_cache=cache)
    assert len(calls) == 3


def test_a_cache_of_another_shape_is_refused():
    scene, cam = _scene(SCENE_2_TEXT), Camera.default("cpu")
    sky = tcm.checker_sky(16, device="cpu")
    _, cache = _render(scene, cam, sky, 3, 2, return_sky_cache=True)
    for cfg in (CFG, SPARSE):
        with pytest.raises(ValueError):
            mk.render_image_cuda(scene, cam, 64, 32, 3, spp=2, config=cfg, cubemap=sky,
                                 sky_cache=cache, device="cpu")


def test_gradients_through_the_cache_equal_the_full_lookup():
    """fetch mode, the room: the gradient of the frame's sum with respect to
    every scene parameter is the same with the cache, in either mode, as
    without it."""
    scene, cam = _scene(ROOM_TEXT), Camera.default("cpu")
    sky = tcm.checker_sky(16, device="cpu")
    _, cache = mk.render_image_cuda(scene, cam, 48, 16, 6, spp=2, config=CFG, cubemap=sky,
                                    device="cpu", return_sky_cache=True)
    grads = []
    for cfg, kw in ((CFG, {}), (CFG, {"sky_cache": cache}), (SPARSE, {}),
                    (SPARSE, {"sky_cache": cache})):
        leaves = {n: getattr(scene, n).detach().clone().requires_grad_() for n in SCENE_PARAM_FIELDS}
        img = mk.render_image_cuda(dataclasses.replace(scene, **leaves), cam, 48, 16, 5, spp=2,
                                   config=cfg, cubemap=sky, device="cpu", **kw)
        img.sum().backward()
        grads.append({n: t.grad for n, t in leaves.items()})
    for other in grads[1:]:
        for n in SCENE_PARAM_FIELDS:
            assert torch.equal(other[n], grads[0][n]), n
