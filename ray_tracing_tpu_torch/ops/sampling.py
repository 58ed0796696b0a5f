"""Random numbers of the port: a counter-based generator and the direction
sampling built on it, in plain PyTorch.

The TPU kernels draw from that chip's hardware generator in call order; no
other machine can reproduce that stream. The port keys every uniform by what
it is for instead: Philox4x32-10 with

    key     = (seed, STREAM_KEY)
    counter = (global_pixel, slot // 4, 0, 0),  word = slot % 4

where ``global_pixel = (row0 + y) * width + x`` counts over the full frame,
so a row-slice render draws exactly what the same rows of the full frame
draw, and a later backward pass regenerates any draw without replaying the
ones before it. The CUDA kernel carries the same function
(``kernels/csrc/megakernel_fwd.cu``); the two are bit-identical.

Slots of one sample (``ns`` = shadow samples when the scene has a light and
next-event estimation is on, else 0):

    0, 1                      pixel jitter u, v (read only with pixel_jitter)
    per bounce b, base = 2 + b * (3*ns + 4):
      base + 3*s + {0,1,2}    shadow sample s: direction uniforms x, y, z
      base + 3*ns + {0,1,2}   bounce direction uniforms x, y, z
      base + 3*ns + 3         specular/diffuse branch uniform

A uniform is the top 24 bits of a word times 2^-24: in [0, 1), exact in
float32.
"""

from __future__ import annotations

import math

import torch

from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.ops.vec import Vec3

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
STREAM_KEY = 0x52545443  # second key word: names this renderer's stream
_MASK32 = 0xFFFFFFFF
JITTER_SLOTS = 2


def _mulhilo(m: int, a):
    """(high, low) 32-bit halves of m * a for a constant m < 2^32 and int64
    tensors a < 2^32. The 64-bit product does not fit int64's 63 bits, and
    PyTorch has no uint64 arithmetic to lean on, so `a` is split into
    16-bit limbs: m*al and m*ah are 48-bit and safe."""
    p0 = m * (a & 0xFFFF)
    p1 = m * (a >> 16)
    hi = ((p0 >> 16) + p1) >> 16
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32 on int64 tensors holding 32-bit words (counters) with
    Python-int keys. Returns the four output words as int64 tensors."""
    k0 &= _MASK32
    k1 &= _MASK32
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def uniform_from_bits(bits):
    """Top 24 bits of a 32-bit word (int64 tensor) -> float32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def slots_per_bounce(ns: int) -> int:
    return 3 * ns + 4


def bounce_base(b: int, ns: int) -> int:
    return JITTER_SLOTS + b * slots_per_bounce(ns)


def global_pixel_index(width: int, height: int, row0: int = 0, device=None):
    """(height, width) int64 tensor of (row0 + y) * width + x."""
    y = torch.arange(height, dtype=torch.int64, device=device) + row0
    x = torch.arange(width, dtype=torch.int64, device=device)
    return y[:, None] * width + x[None, :]


def _rand_dir_from_uniforms(ux, uy, uz, cube_biased: bool) -> Vec3:
    if cube_biased:
        # normalize(U[-1,1]^3): biased toward the cube's corners
        return Vec3(ux * 2.0 - 1.0, uy * 2.0 - 1.0, uz * 2.0 - 1.0).normalize()
    z = ux * 2.0 - 1.0
    phi = uy * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


class PhiloxDraws:
    """Draw provider of the plain estimator: the uniforms the CUDA kernel
    draws, slot for slot. `gpix` is the int64 global pixel index of each
    lane; `ns` the shadow samples per bounce (0 when next-event estimation
    is off). The estimator reads slots in rising order and four neighbours
    share one Philox call, so the last group computed is kept."""

    def __init__(self, seed: int, gpix, config: RenderConfig, ns: int):
        self.seed = int(seed)
        self.gpix = gpix & _MASK32
        self.config = config
        self.ns = ns
        self._group_id = -1
        self._group = None

    def uniform(self, slot: int):
        g = slot >> 2
        if g != self._group_id:
            zero = torch.zeros_like(self.gpix)
            self._group = philox4x32(
                self.gpix, zero + g, zero, zero, self.seed, STREAM_KEY
            )
            self._group_id = g
        return uniform_from_bits(self._group[slot & 3])

    def _dir(self, slot: int) -> Vec3:
        return _rand_dir_from_uniforms(
            self.uniform(slot), self.uniform(slot + 1), self.uniform(slot + 2),
            self.config.cube_biased_sampling,
        )

    def jitter(self):
        return self.uniform(0), self.uniform(1)

    def shadow(self, b: int) -> Vec3:
        """Vec3 of (ns, *shape): the shadow-ray jitter directions."""
        base = bounce_base(b, self.ns)
        dirs = [self._dir(base + 3 * s) for s in range(self.ns)]
        return Vec3(
            torch.stack([d.x for d in dirs]),
            torch.stack([d.y for d in dirs]),
            torch.stack([d.z for d in dirs]),
        )

    def direction(self, b: int) -> Vec3:
        return self._dir(bounce_base(b, self.ns) + 3 * self.ns)

    def branch(self, b: int):
        return self.uniform(bounce_base(b, self.ns) + 3 * self.ns + 3)
