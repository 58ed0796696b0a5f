"""The least time the card could take for one launch of the sky compose
kernel's bilinear arms (the port's csrc/sky_compose.cu:
sky_compose_bilinear_kernel and sky_compose_bilinear_adjoint_kernel) under
grad, as the train step runs them, and the reader of their shares of it.
chip_smoke.py's bound of the two arms is this one.

Counted as chip_smoke.py::sky_compose_bound counts the nearest arm: every
plane byte read or written once, and each distinct 32-byte sector of the
sky that the launch's texels lie in once, in each plane of the sky's
storage. The forward reads the ten planes (40 bytes a pixel) and the
running sum (12, where there is one: every sample of a frame but the
first), and writes the sum (12) and seven int32 planes of state (28); the
adjoint reads the sum's cotangent (12) and the state (28) and writes the
planes' cotangent (40). Both read the four texels of every pixel. The
operations a pixel are those of the kernels' code; at well under one a
byte the bytes bound them.
"""

from __future__ import annotations

import torch

from portbench import roofline
from portbench.reference import invert as ref_invert

FWD_BYTES = 40 + 12 + 28     # planes in, sum out, state out, a pixel
SUM_IN_BYTES = 12            # the running sum in, where there is one
ADJ_BYTES = 12 + 28 + 40     # cotangent and state in, planes' cotangent out
SECTOR = 32
# operations a pixel: face_uv 2, the remap 6, floor and weights 4, the lerp
# 27, the compose 12; the adjoint repeats the lookup (39) and adds the
# compose's adjoint 20, the lerp's 26, the remap's 4 and face_uv's 11
F_FWD = 51
F_ADJ = 100


def sectors(size: int, d, planes: int) -> int:
    """Distinct 32-byte sectors of a (6*size*size,) float32 sky plane that
    the bilinear lookup's four texels in directions `d` (a reference V)
    fall in, times the planes of the sky's storage."""
    corners, _, _ = ref_invert.bilinear_corners(size, d)
    flat = torch.cat([k.reshape(-1) for k in corners])
    return planes * int(torch.unique(flat // (SECTOR // 4)).numel())


def forward(pixels: int, sectors: int, sum_in: float) -> dict:
    """One forward launch, `sum_in` the share of launches that read a
    running sum: (spp - 1) / spp over a frame's samples, 1 for a sample
    added into a sum."""
    nbytes = pixels * (FWD_BYTES + SUM_IN_BYTES * sum_in) + SECTOR * sectors
    return roofline._result(F_FWD * pixels, nbytes)


def adjoint(pixels: int, sectors: int) -> dict:
    return roofline._result(F_ADJ * pixels, pixels * ADJ_BYTES + SECTOR * sectors)


def roofline_share(ctx, key: str, kernel: str):
    """The traced launches of the kernel named `kernel` (by its demangled
    name, or its mangled one) times the least time of one (ctx.work[key])
    over the device time they took, in %; None where the trace holds no
    such launch."""
    t = ctx.trace
    if t is None or key not in ctx.work:
        return None
    ops = t.kernels(lambda n: kernel + "(" in n or f"{len(kernel)}{kernel}" in n)
    if not ops:
        return None
    return len(ops) * ctx.work[key]["bound_s"] / t.seconds(ops) * 100.0
