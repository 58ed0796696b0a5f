"""The port's one sky lookup a sample against the JAX package's sparse sky
lookup, and successive frames of render_image_cuda (the plain path,
device="cpu") against the plain render_image.

The JAX package keeps a sparse lookup (ray_tracing_tpu/ops/cubemap.py::
sparse_sky_lookup): a cache of an earlier sample's texels and two budget
tiers of block-compacted gathers. The port looks every pixel's texel up in
each sample (kernels/megakernel.py::render_frame). Both are exact, so the
JAX lookup in each of its tiers, with and without a cache, must equal the
port's nearest lookup on the same directions.

Tolerance: none on texels and frames. Texels are integers and their
unpacking is one float multiply in both packages; a frame of
render_image_cuda on the CPU takes the plain estimator and the sky compose's
plain twin, which render_image's frame holds bit for bit. Gradients:
render_image's autograd runs through its own trace, render_image_cuda's
fetch backward through the winners it recorded, which sums in another
order: the tolerance of tests/test_torch_sky_compose.py's gradients.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ray_tracing_tpu.ops import cubemap as jcm
from ray_tracing_tpu.ops.vec import Vec3 as JVec3

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff.inverse import SCENE_PARAM_FIELDS
from ray_tracing_tpu_torch.kernels import megakernel as mk
from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.camera import Camera, rotate
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.scene.parser import parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT

BLOCK = jcm.SPARSE_BLOCK
FACES = np.random.default_rng(3).integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
CFG = RenderConfig(bounces=2, shadow_samples=1)
BUDGET = 4  # blocks: the JAX lookup's tiers are 1 and 4 blocks


@pytest.fixture(scope="module")
def cubemaps():
    return jcm.CubemapData.from_faces(FACES), tcm.CubemapData.from_faces(FACES, device="cpu")


def directions(rng, shape):
    d = rng.normal(size=(3, *shape))
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


# (pixels, blocks with fresh pixels): the JAX lookup's small tier (at most
# BUDGET // 4 blocks), its large tier (at most BUDGET), its full gather past
# the budget, and its full gather of a size that is not a multiple of BLOCK
TIERS = {"small": (8 * BLOCK, 1), "large": (8 * BLOCK, 3), "full": (8 * BLOCK, 6),
         "off_block": (100, None)}


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_jax_sparse_lookup_equals_the_port_nearest_lookup(cubemaps, tier, cached):
    """The JAX sparse lookup of the texels of `need` pixels, in each tier,
    with no cache and with one that holds a whole block of them, equals
    the port's nearest lookup (sample_cubemap) of the same directions where
    `need`, and 0 elsewhere."""
    jcmap, tcmap = cubemaps
    size, fresh_blocks = TIERS[tier]
    rng = np.random.default_rng(size + (fresh_blocks or 0) + 10 * cached)
    d = directions(rng, (size,))
    flat = np.asarray(jcm.texel_flat_index(jcmap, JVec3(*(jnp.asarray(c) for c in d))))
    need = rng.random(size) < 0.5
    cache = ()
    if fresh_blocks is not None:
        need[:] = False
        # blocks 1 .. fresh_blocks hold fresh pixels; with a cache, block 0's
        # pixels are needed too and all come from it
        for b in range(1, fresh_blocks + 1):
            need[b * BLOCK + rng.choice(BLOCK, 9, replace=False)] = True
        if cached:
            need[:BLOCK] = True
            valid = np.zeros(size, bool)
            valid[:BLOCK] = True
            cache_flat = np.where(valid, flat, -1).astype(np.int32)
            packed = np.asarray(jcmap.packed)[np.clip(cache_flat, 0, None)]
            cache = (jnp.asarray(cache_flat), jnp.asarray(packed), jnp.asarray(valid))
        counted = need.reshape(-1, BLOCK)[int(cached):].any(axis=1).sum()
        assert counted == fresh_blocks
    elif cached:
        valid = rng.random(size) < 0.5
        cache = (jnp.asarray(np.where(valid, flat, -1).astype(np.int32)),
                 jnp.asarray(np.asarray(jcmap.packed)[flat]), jnp.asarray(valid))
    texels = jcm.sparse_sky_lookup(jcmap, jnp.asarray(flat), jnp.asarray(need), *cache,
                                   budget=BUDGET)
    want = jcm.unpack_texels(texels)
    got = tcm.sample_cubemap(tcmap, Vec3(*(torch.from_numpy(c) for c in d)))
    mask = torch.from_numpy(need)
    for w, g in zip((want.x, want.y, want.z), (got.x, got.y, got.z)):
        np.testing.assert_array_equal(torch.where(mask, g, 0.0).numpy(), np.asarray(w))
    assert np.asarray(texels)[need].any()


def test_unpack_texels_equals_jax(cubemaps):
    packed = cubemaps[0].packed
    want = jcm.unpack_texels(packed)
    got = tcm.unpack_texels(cubemaps[1].packed)
    for w, g in zip((want.x, want.y, want.z), (got.x, got.y, got.z)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the renderer ---------------------------------------------------------


def cameras():
    """A camera, then turned, then moved: the views of successive frames."""
    cam = Camera.default("cpu")
    turned = rotate(cam, 400.0, 120.0, CFG)
    moved = dataclasses.replace(turned, pos=turned.pos + torch.tensor([0.5, -0.25, 1.0]))
    return [cam, turned, moved]


@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT], ids=["scene_2", "room"])
def test_successive_frames_equal_the_plain_render(text):
    """Multi-sample frames of render_image_cuda, one after another with the
    camera moved between them, each equal to render_image's bit for bit."""
    scene = parse_scene_string(text, device="cpu")
    sky = tcm.checker_sky(16, device="cpu")
    for i, cam in enumerate(cameras()):
        got = mk.render_image_cuda(scene, cam, 128, 32, 7 + i, spp=2, config=CFG, cubemap=sky,
                                   device="cpu")
        want = render_image(scene, cam, 128, 32, 7 + i, spp=2, config=CFG, cubemap=sky,
                            device="cpu")
        assert torch.equal(got, want), i


def test_gradients_of_successive_frames_equal_the_plain_render():
    """fetch mode, the room: the gradient of each successive frame's sum
    with respect to every scene parameter is render_image's, to the
    rounding of the order of a sum."""
    scene = parse_scene_string(ROOM_TEXT, device="cpu")
    sky = tcm.checker_sky(16, device="cpu")
    for i, cam in enumerate(cameras()):
        grads = []
        for render in (mk.render_image_cuda, render_image):
            leaves = {n: getattr(scene, n).detach().clone().requires_grad_()
                      for n in SCENE_PARAM_FIELDS}
            img = render(dataclasses.replace(scene, **leaves), cam, 48, 16, 5 + i, spp=2,
                         config=CFG, cubemap=sky, device="cpu")
            img.sum().backward()
            grads.append({n: t.grad for n, t in leaves.items()})
        for n in SCENE_PARAM_FIELDS:
            a, b = grads[0][n], grads[1][n]
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max())), (i, n)
        assert float(grads[1]["albedo"].abs().max()) > 0
