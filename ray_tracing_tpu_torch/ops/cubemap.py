"""Cubemap skybox sampling in plain PyTorch.

Counterpart of ``ray_tracing_tpu/ops/cubemap.py``: the reference renderer's
dominant-axis face selection, per-face (u, v) formulas, [-1, 1] clamp and
nearest-texel lookup, plus a bilinear filter.

Storage: 8-bit cubemaps are packed into ONE plane of 0x00RRGGBB texels, so a
sky lookup is one indexed read and three shifts. PyTorch's support for
uint32 is thin, so the packed plane is ``int32`` on the device; the top byte
is zero, which makes the arithmetic right shifts safe. Float cubemaps
(procedural skies) keep three channel planes. 1x1 cubemaps (constant or
per-face colours) are read with a 6-way select and no indexing.

On the card the lookup of a render, under either filter, runs inside the
sky compose kernels (kernels/csrc/sky_compose.cu), which repeat face_uv,
texel_flat_index and the bilinear filter; these functions are their plain
reference, run as PyTorch indexing on the miss directions the megakernel
returns, and the lookup of a sky that requires grad.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.vec import Vec3

# Face order of the reference renderer.
CF_FRONT, CF_BACK, CF_LEFT, CF_RIGHT, CF_TOP, CF_BOTTOM = 0, 1, 2, 3, 4, 5


@dataclasses.dataclass(frozen=True)
class CubemapData:
    """Exactly one storage is populated:

    packed: (6*H*W,) int32 0x00RRGGBB  (8-bit cubemaps)
    r/g/b:  (6*H*W,) float32 planes    (float cubemaps)
    """

    packed: torch.Tensor | None
    r: torch.Tensor | None
    g: torch.Tensor | None
    b: torch.Tensor | None
    h: int
    w: int

    @property
    def device(self) -> torch.device:
        return (self.packed if self.packed is not None else self.r).device

    def to(self, device) -> "CubemapData":
        device = torch.device(device)
        if self.device == device:
            return self

        def mv(t):
            return None if t is None else t.to(device)

        return CubemapData(mv(self.packed), mv(self.r), mv(self.g), mv(self.b), self.h, self.w)

    @staticmethod
    def from_faces(faces, device=None) -> "CubemapData":
        """faces: (6, H, W, 3) uint8 (packed storage) or float (channel
        planes), a numpy array. device=None means the card."""
        device = resolve_device(device)
        f = np.asarray(faces)
        if f.ndim != 4 or f.shape[0] != 6 or f.shape[3] != 3:
            raise ValueError(f"expected (6, H, W, 3) faces, got {f.shape}")
        if f.dtype != np.uint8 and np.issubdtype(f.dtype, np.integer):
            raise ValueError(
                f"integer faces must be uint8 (got {f.dtype}); convert or "
                "pass float radiance"
            )
        h, w = f.shape[1], f.shape[2]
        flat = f.reshape(-1, 3)
        if f.dtype == np.uint8:
            packed = (
                (flat[:, 0].astype(np.int32) << 16)
                | (flat[:, 1].astype(np.int32) << 8)
                | flat[:, 2].astype(np.int32)
            )
            return CubemapData(torch.from_numpy(packed).to(device), None, None, None, h, w)
        flat = flat.astype(np.float32)
        return CubemapData(
            None,
            torch.from_numpy(np.ascontiguousarray(flat[:, 0])).to(device),
            torch.from_numpy(np.ascontiguousarray(flat[:, 1])).to(device),
            torch.from_numpy(np.ascontiguousarray(flat[:, 2])).to(device),
            h,
            w,
        )


def face_uv(d: Vec3):
    """Unit directions -> (face:int32, u, v); u, v in [-1, 1] before the
    clamp. Ties between axes fall to the Z faces."""
    ax, ay, az = torch.abs(d.x), torch.abs(d.y), torch.abs(d.z)

    x_dom = (ax > ay) & (ax > az)
    y_dom = (ay > ax) & (ay > az)  # else: Z dominant

    sx = torch.where(ax > 0, ax, 1.0)
    sy = torch.where(ay > 0, ay, 1.0)
    sz = torch.where(az > 0, az, 1.0)

    # The X and Y branches need strict dominance, so their divisors are
    # nonzero. The Z fallback can be taken with az == 0 (an exact
    # |x| == |y| tie). The reference divides by 0 there and its clamp lands
    # on the EDGE texel; dividing by the guard would land inside the face.
    # Saturate those lanes past the clamp range with the numerator's sign.
    z0 = az == 0.0
    uz_num = torch.where(d.z > 0, d.x, -d.x)
    vz_num = -d.y
    u_z = torch.where(z0, torch.sign(uz_num) * 4.0, uz_num / sz)
    v_z = torch.where(z0, torch.sign(vz_num) * 4.0, vz_num / sz)

    u = torch.where(
        x_dom,
        torch.where(d.x > 0, -d.z, d.z) / sx,
        torch.where(y_dom, d.x / sy, u_z),
    )
    v = torch.where(
        x_dom,
        -d.y / sx,
        torch.where(y_dom, torch.where(d.y > 0, d.z, -d.z) / sy, v_z),
    )
    face = torch.where(
        x_dom,
        torch.where(d.x > 0, CF_RIGHT, CF_LEFT),
        torch.where(
            y_dom,
            torch.where(d.y > 0, CF_TOP, CF_BOTTOM),
            torch.where(d.z > 0, CF_FRONT, CF_BACK),
        ),
    ).to(torch.int32)
    return face, u, v


def _unpack(t) -> Vec3:
    s = 1.0 / 255.0
    return Vec3(
        ((t >> 16) & 0xFF).to(torch.float32) * s,
        ((t >> 8) & 0xFF).to(torch.float32) * s,
        (t & 0xFF).to(torch.float32) * s,
    )


def _fetch_flat(cubemap: CubemapData, flat) -> Vec3:
    """Texel fetch at flat indices: one indexed read (packed) or three."""
    flat = flat.to(torch.int64)
    if cubemap.packed is not None:
        return _unpack(cubemap.packed[flat])
    return Vec3(cubemap.r[flat], cubemap.g[flat], cubemap.b[flat])


def _fetch_1x1(cubemap: CubemapData, face) -> Vec3:
    """1x1 cubemaps: a 6-way select on the face, no indexing."""
    if cubemap.packed is not None:
        texels = [_unpack(cubemap.packed[k]) for k in range(6)]
    else:
        texels = [Vec3(cubemap.r[k], cubemap.g[k], cubemap.b[k]) for k in range(6)]
    out = texels[5].broadcast_to(face.shape)
    for k in range(4, -1, -1):
        out = Vec3.where(face == k, texels[k], out)
    return out


def _flat_index(cubemap: CubemapData, face, y, x):
    """(face, y, x) -> flat texel index: the one copy of the layout."""
    return (face * cubemap.h + y) * cubemap.w + x


def _face_texel_f(cubemap: CubemapData, d: Vec3):
    """(face, fy, fx): clamp uv to [-1,1], remap to [0,1], scale to float
    texel coordinates; shared by the nearest truncation and the bilinear
    floor and lerp."""
    face, u, v = face_uv(d)
    u = 0.5 * (torch.clamp(u, -1.0, 1.0) + 1.0)
    v = 0.5 * (torch.clamp(v, -1.0, 1.0) + 1.0)
    return face, v * (cubemap.h - 1), u * (cubemap.w - 1)


def texel_flat_index(cubemap: CubemapData, d: Vec3):
    """Flat int32 texel index of the nearest-texel lookup (truncation of the
    float texel coordinates)."""
    face, fy, fx = _face_texel_f(cubemap, d)
    x = fx.to(torch.int32)
    y = fy.to(torch.int32)
    return _flat_index(cubemap, face, y, x)


def unpack_texels(packed) -> Vec3:
    """int32 0x00RRGGBB texels -> RGB Vec3 in [0, 1]."""
    return _unpack(packed)


def sample_cubemap(cubemap: CubemapData, d: Vec3, bilinear: bool = False) -> Vec3:
    """Skybox lookup for unit directions -> RGB in [0,1].

    bilinear=False is the reference's lookup: clamp uv to [-1,1], remap to
    [0,1], truncate to texel coordinates, bytes/255. bilinear=True is a
    4-texel lerp inside the face."""
    if cubemap.h == 1 and cubemap.w == 1:
        face, _, _ = face_uv(d)
        return _fetch_1x1(cubemap, face)
    if not bilinear:
        return _fetch_flat(cubemap, texel_flat_index(cubemap, d))
    return bilinear_terms(cubemap, d)[0]


def bilinear_corners(cubemap: CubemapData, d: Vec3):
    """The bilinear filter's four flat texel indices (corners 00, 01 = x + 1,
    10 = y + 1, 11; the next texel clamped to the face's last) and the
    weights wx, wy, of a sky larger than 1x1."""
    face, fy, fx = _face_texel_f(cubemap, d)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=cubemap.w - 1)
    y1 = torch.clamp(y0 + 1, max=cubemap.h - 1)
    corners = [_flat_index(cubemap, face, y, x) for y, x in ((y0, x0), (y0, x1), (y1, x0),
                                                             (y1, x1))]
    return corners, fx - x0, fy - y0


def bilinear_terms(cubemap: CubemapData, d: Vec3):
    """(sky, top, bot, d0, d1, wx, wy) of the bilinear filter: the lerp
    top = c00 + d0 * wx, bot = c10 + d1 * wx (d0 = c01 - c00, d1 = c11 -
    c10), sky = top + (bot - top) * wy, Vec3s, beside the weights. The
    sky compose kernel's bilinear arm and its adjoint repeat these steps."""
    (k00, k01, k10, k11), wx, wy = bilinear_corners(cubemap, d)
    c00, c01 = _fetch_flat(cubemap, k00), _fetch_flat(cubemap, k01)
    c10, c11 = _fetch_flat(cubemap, k10), _fetch_flat(cubemap, k11)
    d0, d1 = c01 - c00, c11 - c10
    top = c00 + d0 * wx
    bot = c10 + d1 * wx
    return top + (bot - top) * wy, top, bot, d0, d1, wx, wy


def face_uv_adjoint(d: Vec3, g_u, g_v) -> Vec3:
    """The cotangent of the directions d from those of face_uv's u and v
    (before any clamp), as autograd takes it back through face_uv: u = n_u /
    s and v = n_v / s, s the dominant component's magnitude and the
    numerators the two others up to sign; a division passes g / s to its
    numerator and -g * ((n / s) / s) to s, and abs passes that times the
    component's sign. The exact |x| == |y| tie with z == 0 saturates u and v
    to constants and gets 0."""
    ax, ay, az = torch.abs(d.x), torch.abs(d.y), torch.abs(d.z)
    x_dom = (ax > ay) & (ax > az)
    y_dom = (ay > ax) & (ay > az)
    tie = ~x_dom & ~y_dom & (az == 0.0)
    s = torch.where(x_dom, ax, torch.where(y_dom, ay, torch.where(tie, 1.0, az)))
    n_u = torch.where(x_dom, torch.where(d.x > 0, -d.z, d.z),
                      torch.where(y_dom, d.x, torch.where(d.z > 0, d.x, -d.x)))
    n_v = torch.where(x_dom, -d.y, torch.where(y_dom, torch.where(d.y > 0, d.z, -d.z), -d.y))
    g_nu, g_nv = g_u / s, g_v / s
    g_s = -g_u * ((n_u / s) / s) + -g_v * ((n_v / s) / s)
    pos = torch.where(x_dom, d.x > 0, torch.where(y_dom, d.y > 0, d.z > 0))
    g_s = torch.where(pos, g_s, -g_s)
    gx = torch.where(x_dom, g_s, torch.where(y_dom | pos, g_nu, -g_nu))
    gy = torch.where(x_dom, -g_nv, torch.where(y_dom, g_s, -g_nv))
    gz = torch.where(x_dom, torch.where(pos, -g_nu, g_nu),
                     torch.where(y_dom, torch.where(pos, g_nv, -g_nv), g_s))
    zero = torch.zeros_like(gx)
    return Vec3(torch.where(tie, zero, gx), torch.where(tie, zero, gy), torch.where(tie, zero, gz))


def bilinear_adjoint(cubemap: CubemapData, d: Vec3, g_sky: Vec3) -> Vec3:
    """The cotangent of the directions d of sample_cubemap(bilinear=True)
    on a sky larger than 1x1 (a constant sky), from the looked-up radiance's
    g_sky: through the lerp to wx and wy, through the remap to u and v
    where the clamp passes (-1 <= u <= 1, as torch.clamp's backward), and
    through face_uv (face_uv_adjoint). The weights' cotangents sum their
    terms in the order autograd adds them, the last use first: for wy the
    channels z, y, x; for wx the bottom row's z, y, x, then the top row's."""
    _, top, bot, d0, d1, wx, wy = bilinear_terms(cubemap, d)
    g_sky, top, bot = (g_sky.x, g_sky.y, g_sky.z), (top.x, top.y, top.z), (bot.x, bot.y, bot.z)
    g_bot = [gs * wy for gs in g_sky]
    g_top = [gs - gb for gs, gb in zip(g_sky, g_bot)]
    g_wy = (g_sky[2] * (bot[2] - top[2]) + g_sky[1] * (bot[1] - top[1])) \
        + g_sky[0] * (bot[0] - top[0])
    g_wx = ((((g_bot[2] * d1.z + g_bot[1] * d1.y) + g_bot[0] * d1.x) + g_top[2] * d0.z)
            + g_top[1] * d0.y) + g_top[0] * d0.x
    _, u, v = face_uv(d)
    g_u = torch.where((u >= -1.0) & (u <= 1.0), (g_wx * (cubemap.w - 1)) * 0.5, 0.0)
    g_v = torch.where((v >= -1.0) & (v <= 1.0), (g_wy * (cubemap.h - 1)) * 0.5, 0.0)
    return face_uv_adjoint(d, g_u, g_v)


def bilinear_adjoint_scale(cubemap: CubemapData, d: Vec3, g_sky: Vec3):
    """Per direction a bound on the magnitudes of everything bilinear_adjoint
    sums and divides on its way: the sums of the magnitudes of the weights'
    terms (|g_top * d0| and |g_bot * d1| over the channels for wx, |g_sky *
    (bot - top)| for wy), taken to u and v (times (size - 1) / 2) and
    through face_uv (times (1 + |u| + |v|) / s, s the dominant component's
    magnitude). Any order of those sums and roundings stays within a few
    float32 epsilons of it where the cotangent itself may cancel to 0: the
    yardstick its tests and the card's checks hold it to autograd with."""
    _, top, bot, d0, d1, _, wy = bilinear_terms(cubemap, d)
    _, u, v = face_uv(d)
    t_wx = t_wy = torch.zeros_like(wy)
    for gs, t, b, e0, e1 in zip((g_sky.x, g_sky.y, g_sky.z), (top.x, top.y, top.z),
                                (bot.x, bot.y, bot.z), (d0.x, d0.y, d0.z), (d1.x, d1.y, d1.z)):
        t_wx = t_wx + ((gs - gs * wy) * e0).abs() + (gs * wy * e1).abs()
        t_wy = t_wy + (gs * (b - t)).abs()
    s = torch.maximum(torch.maximum(d.x.abs(), d.y.abs()), d.z.abs()).clamp_min(1e-30)
    return (0.5 * ((cubemap.w - 1) * t_wx + (cubemap.h - 1) * t_wy)
            * (1.0 + u.abs() + v.abs()) / s)


def downsample_packed(cubemap: CubemapData, factor: int) -> CubemapData:
    """Nearest-decimated packed cubemap: the same one-read lookup over a
    table factor^2 smaller. The metadata comes from the sliced shape
    (::factor keeps ceil(h/factor) rows)."""
    if cubemap.packed is None:
        raise ValueError("downsample_packed needs a packed cubemap")
    faces = cubemap.packed.reshape(6, cubemap.h, cubemap.w)
    dec = faces[:, ::factor, ::factor]
    h2, w2 = int(dec.shape[1]), int(dec.shape[2])
    return CubemapData(dec.reshape(-1).contiguous(), None, None, None, h2, w2)


def checker_sky(size: int = 64, device=None) -> CubemapData:
    """Deterministic synthetic PACKED cubemap (face-tinted checkerboard): a
    stand-in for a photographic skybox wherever the 8-bit one-read lookup
    must run. Built with tensor ops on `device`, so a 2048^2 sky never
    crosses the bus. Texel for texel the same as the JAX package's
    checker_sky. device=None means the card."""
    device = resolve_device(device)
    ar = torch.arange(size, dtype=torch.int32, device=device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    check = (yy // 4 + xx // 4) % 2
    blue = (xx * 255) // max(size - 1, 1)
    faces = []
    for f in range(6):
        red = torch.clamp(40 * f + 55 + 120 * check, 0, 255)
        green = torch.clamp(255 - 30 * f - 100 * check, 0, 255)
        faces.append((red << 16) | (green << 8) | blue)
    packed = torch.stack(faces).reshape(-1).to(torch.int32).contiguous()
    return CubemapData(packed, None, None, None, size, size)


def constant_sky(color=(0.0, 0.0, 0.0), device=None) -> CubemapData:
    """1x1 uniform-colour cubemap (the 'no skybox' mode)."""
    c = np.broadcast_to(np.asarray(color, np.float32), (6, 1, 1, 3)).copy()
    return CubemapData.from_faces(c, device=device)


def gradient_sky(size: int = 32, device=None) -> CubemapData:
    """Smooth synthetic float sky with per-face linear ramps: radiance
    varies with direction, so with env_filter="bilinear" it is smooth in
    the ray direction."""
    yy, xx = np.meshgrid(
        np.linspace(0.0, 1.0, size), np.linspace(0.0, 1.0, size), indexing="ij"
    )
    faces = np.zeros((6, size, size, 3), np.float32)
    for f in range(6):
        faces[f, ..., 0] = 0.15 + 0.7 * xx * ((f % 3) + 1) / 3
        faces[f, ..., 1] = 0.2 + 0.6 * yy
        faces[f, ..., 2] = 0.25 + 0.1 * f + 0.4 * xx * (1 - yy)
    return CubemapData.from_faces(faces, device=device)
