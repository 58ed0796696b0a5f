"""The port's counter-based generator (ops/sampling.py): bit-equal to a
Philox4x32-10 written here on Python integers, the Random123 known-answer
vectors, and the statistics of the uniforms it feeds the renderer."""

import numpy as np
import pytest

import jax  # noqa: F401
import torch

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.ops import sampling as S

M32 = 0xFFFFFFFF


def philox_py(ctr, key, rounds=10):
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(rounds):
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & M32, p1 & M32, ((p0 >> 32) ^ c3 ^ k1) & M32, p0 & M32
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def _torch_philox(ctrs, key):
    cols = [torch.tensor([c[k] for c in ctrs], dtype=torch.int64) for k in range(4)]
    out = S.philox4x32(*cols, key[0], key[1])
    return [tuple(int(o[i]) for o in out) for i in range(len(ctrs))]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_random123_known_answers(ctr, key, want):
    assert philox_py(ctr, key) == want
    assert _torch_philox([ctr], key) == [want]


def test_bit_equal_to_python_integers_on_random_inputs():
    r = np.random.default_rng(0)
    for _ in range(20):
        key = tuple(int(x) for x in r.integers(0, 1 << 32, 2))
        ctrs = [tuple(int(x) for x in r.integers(0, 1 << 32, 4)) for _ in range(64)]
        assert _torch_philox(ctrs, key) == [philox_py(c, key) for c in ctrs]


def test_draw_provider_slots_and_seed_wrap():
    cfg = RenderConfig(bounces=2, shadow_samples=3)
    gpix = S.global_pixel_index(8, 4, row0=5, device="cpu")
    assert gpix[0, 0] == 40 and gpix[3, 7] == 8 * 8 + 7
    d = S.PhiloxDraws(-7, gpix, cfg, ns=3)  # negative seeds wrap to uint32
    base = S.bounce_base(1, 3)
    assert base == 2 + 13
    slot = base + 3 * 3 + 3  # branch of bounce 1
    want = philox_py((40, slot >> 2, 0, 0), ((-7) & M32, S.STREAM_KEY))[slot & 3]
    assert float(d.branch(1)[0, 0]) == (want >> 8) / float(1 << 24)
    sh = d.shadow(1)
    assert tuple(sh.x.shape) == (3, 4, 8)
    # reading out of order gives the same numbers
    again = S.PhiloxDraws(-7, gpix, cfg, ns=3)
    assert again.direction(0).x.equal(S.PhiloxDraws(-7, gpix, cfg, ns=3).direction(0).x)
    assert again.branch(1).equal(d.branch(1))
    n = np.sqrt(sh.x.numpy() ** 2 + sh.y.numpy() ** 2 + sh.z.numpy() ** 2)
    np.testing.assert_allclose(n, 1.0, atol=1e-5)


def test_row_slice_draws_equal_full_frame_rows():
    cfg = RenderConfig(bounces=1, shadow_samples=0)
    full = S.PhiloxDraws(3, S.global_pixel_index(16, 12, device="cpu"), cfg, 0)
    part = S.PhiloxDraws(3, S.global_pixel_index(16, 4, row0=8, device="cpu"), cfg, 0)
    assert part.branch(0).equal(full.branch(0)[8:12])


def test_uniform_statistics():
    n_pix, n_slots = 250_000, 4
    gpix = torch.arange(n_pix, dtype=torch.int64)
    d = S.PhiloxDraws(12345, gpix, RenderConfig(), 0)
    u = np.stack([d.uniform(s).numpy() for s in range(n_slots)]).astype(np.float64)  # 1e6 draws
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 1.5e-3            # sigma = 0.29/1e3
    assert abs(u.var() - 1.0 / 12.0) < 5e-4
    # neighbouring pixels and neighbouring slots are uncorrelated
    assert abs(np.corrcoef(u[0, :-1], u[0, 1:])[0, 1]) < 6e-3
    assert abs(np.corrcoef(u[0], u[1])[0, 1]) < 6e-3
    assert abs(np.corrcoef(u[3], S.PhiloxDraws(12345, gpix, RenderConfig(), 0).uniform(4).numpy())[0, 1]) < 6e-3
    # another seed is another stream
    v = S.PhiloxDraws(12346, gpix, RenderConfig(), 0).uniform(0).numpy()
    assert abs(np.corrcoef(u[0], v)[0, 1]) < 6e-3
    hist, _ = np.histogram(u, bins=16, range=(0, 1))
    assert np.abs(hist / u.size - 1 / 16).max() < 2e-3
