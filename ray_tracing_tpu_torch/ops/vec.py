"""Vec3: struct-of-arrays 3-vectors over torch tensors.

Counterpart of ``ray_tracing_tpu/ops/vec.py``. Each component is its own
tensor (or Python scalar), so the batch of pixels is the only axis and every
vector operation is a handful of elementwise tensor ops. The formulas and
their order of evaluation are those of the JAX package: the port's plain
estimator is compared with it value by value.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

NORMALIZE_EPS = 1e-5  # normalize() returns short vectors unchanged
ZERO_EPS = 1e-4       # is_zero() threshold


def div_scalar(t, s: float):
    """t / s as a true IEEE division. On a CUDA tensor PyTorch turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which rounds differently from the division the CUDA kernel (and the CPU)
    performs; a 0-dim tensor divisor on the same device keeps it a division."""
    return t / torch.full((), s, dtype=t.dtype, device=t.device)


@dataclasses.dataclass(frozen=True)
class Vec3:
    x: Any
    y: Any
    z: Any

    # -- construction ------------------------------------------------------

    @staticmethod
    def of(x, y, z, dtype=torch.float32, device="cpu") -> "Vec3":
        return Vec3(
            torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(y, dtype=dtype, device=device),
            torch.as_tensor(z, dtype=dtype, device=device),
        )

    @staticmethod
    def zeros(shape=(), dtype=torch.float32, device="cpu") -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def full(shape, fill, dtype=torch.float32, device="cpu") -> "Vec3":
        c = torch.full(shape, fill, dtype=dtype, device=device)
        return Vec3(c, c, c)

    def to_array(self):
        """Vec3 -> (..., 3). For host IO and final image assembly."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # -- algebra -----------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        if not isinstance(o, torch.Tensor):
            return Vec3(div_scalar(self.x, o), div_scalar(self.y, o), div_scalar(self.z, o))
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return torch.sqrt(self.norm2())

    def normalize(self, eps: float = NORMALIZE_EPS) -> "Vec3":
        """Safe normalize: returns the vector unchanged when ||v|| < eps.
        The reciprocal is taken once and multiplied in, as the CUDA kernel
        does, so both round the same way."""
        n = self.norm()
        small = n < eps
        inv = 1.0 / torch.where(small, torch.ones_like(n), n)
        scaled = self * inv
        return Vec3.where(small, self, scaled)

    def reflect(self, n: "Vec3") -> "Vec3":
        """Mirror about the plane with normal n: d - 2*dot(n,d)*n."""
        return self - n * (2.0 * n.dot(self))

    def avg(self):
        """Mean of the components."""
        return div_scalar(self.x + self.y + self.z, 3.0)

    def clip(self, lo, hi) -> "Vec3":
        return Vec3(
            torch.clamp(self.x, lo, hi),
            torch.clamp(self.y, lo, hi),
            torch.clamp(self.z, lo, hi),
        )

    def is_zero(self, eps: float = ZERO_EPS):
        """All components within (-eps, eps)."""
        return (
            (torch.abs(self.x) < eps)
            & (torch.abs(self.y) < eps)
            & (torch.abs(self.z) < eps)
        )

    # -- selection / broadcasting -------------------------------------------

    @staticmethod
    def where(mask, a: "Vec3", b: "Vec3") -> "Vec3":
        """Componentwise select; mask has the batch shape."""
        return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y), torch.where(mask, a.z, b.z))

    @staticmethod
    def where_c(mask: "Vec3", a: "Vec3", b: "Vec3") -> "Vec3":
        """Select with a per-component mask (a Vec3 of booleans)."""
        return Vec3(
            torch.where(mask.x, a.x, b.x), torch.where(mask.y, a.y, b.y), torch.where(mask.z, a.z, b.z)
        )

    def broadcast_to(self, shape) -> "Vec3":
        return Vec3(
            torch.broadcast_to(self.x, shape),
            torch.broadcast_to(self.y, shape),
            torch.broadcast_to(self.z, shape),
        )

    @property
    def shape(self):
        return tuple(self.x.shape)


def fresnel_schlick(cos_theta, f0: Vec3) -> Vec3:
    """F = f0 + (1 - f0) * (1 - cos)^5. The fifth power is x * (x^2)^2, the
    repeated squaring that XLA's integer power expands to and that the CUDA
    kernel writes out, so all three agree to the bit."""
    x = 1.0 - cos_theta
    x2 = x * x
    p = x * (x2 * x2)
    return f0 + (1.0 - f0) * p
