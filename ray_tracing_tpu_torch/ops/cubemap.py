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

The sky lookup runs as PyTorch indexing outside the CUDA kernel, on the
miss directions the kernel returns; ``sparse_sky_lookup`` is the exact
lookup that gathers only the texels a cache of an earlier sample lacks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.utils.profiling import add_counts

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


def gather_texels(cubemap: CubemapData, flat, need):
    """Packed texels at the flat indices where `need`, 0 elsewhere: the full
    gather of a packed cubemap."""
    return torch.where(need, cubemap.packed[flat.long()], 0)


SPARSE_BLOCK = 128  # pixels per block of the sparse lookup's compaction


def sparse_sky_lookup(cubemap: CubemapData, flat, need, cache_flat=None,
                      cache_packed=None, cache_valid=None, budget: int | None = None):
    """EXACT nearest-texel lookup of the `need` pixels, gathering only the
    texels that a cache does not already hold.

    Counterpart of the JAX package's sparse_sky_lookup, with its contract:

      reuse:  cache_valid & (flat == cache_flat) -> the cached texel. Equal
              flat indices name the same texel, so reuse is exact by
              construction.
      fresh:  per SPARSE_BLOCK-pixel block an "any fresh pixel" flag; the
              flagged blocks are compacted (an exclusive cumsum gives each
              its slot, one scatter writes the block ids) and only their
              pixels are gathered. Two budget tiers (budget // 4 and
              `budget` blocks, default max(blocks // 8, 256)) cap the
              compacted gather; past the larger tier, and for a size that
              is not a multiple of SPARSE_BLOCK, every pixel is gathered.
              The tier changes the cost, never a texel.

    The tier is chosen from the number of fresh blocks, read on the host:
    one synchronisation per call (the JAX package chooses with lax.cond on
    the device). Returns an int32 texel plane of `flat`'s shape, 0 where
    ~need. Only for packed (8-bit) cubemaps. While a profiler runs, the
    texels gathered (the fresh blocks' pixels, or every pixel) are added to
    the open span's count `texels` (utils/profiling.py::add_counts): the
    sky cache's misses, at no extra read."""
    if cubemap.packed is None:
        raise ValueError("the sparse lookup needs a packed cubemap")
    shape = flat.shape
    size = flat.numel()
    flat = flat.reshape(-1)
    need = need.reshape(-1)
    if cache_flat is None:
        reuse = torch.zeros_like(need)
        cached = torch.zeros((), dtype=torch.int32, device=flat.device)
    else:
        reuse = cache_valid.reshape(-1) & (flat == cache_flat.reshape(-1))
        cached = cache_packed.reshape(-1)
    fresh_need = need & ~reuse
    if size % SPARSE_BLOCK:
        add_counts(texels=size)
        fresh = gather_texels(cubemap, flat, fresh_need)
    else:
        nb = size // SPARSE_BLOCK
        fb = fresh_need.reshape(nb, SPARSE_BLOCK).any(dim=1)
        if budget is None:
            budget = max(nb // 8, 256)
        tiers = sorted({max(min(budget // 4, nb), 1), max(min(budget, nb), 1)})
        count = int(fb.sum())  # the one read on the host
        bb = next((t for t in tiers if count <= t), None)
        add_counts(texels=size if bb is None else count * SPARSE_BLOCK)
        fresh = (gather_texels(cubemap, flat, fresh_need) if bb is None
                 else _compacted_gather(cubemap, flat, fb, bb))
    out = torch.where(need, torch.where(reuse, cached, fresh), 0)
    return out.reshape(shape)


def _compacted_gather(cubemap: CubemapData, flat, fb, bb: int):
    """Texels of every pixel of the first `bb` flagged blocks of `fb`, 0
    elsewhere, in a (size,) plane. Sync-free: blocks past the budget and the
    padding slots land in one extra slot or block that is cut off."""
    nb = fb.numel()
    dev = flat.device
    fbi = fb.to(torch.int64)
    slot = torch.cumsum(fbi, 0) - fbi  # exclusive prefix: each block's slot
    dest = torch.where(fb & (slot < bb), slot, bb)
    pos_b = torch.full((bb + 1,), nb, dtype=torch.int64, device=dev)
    pos_b.scatter_(0, dest, torch.arange(nb, dtype=torch.int64, device=dev))
    lanes = torch.arange(SPARSE_BLOCK, dtype=torch.int64, device=dev)
    pos = (pos_b[:bb, None] * SPARSE_BLOCK + lanes).reshape(-1)
    tex = cubemap.packed[flat[pos.clamp(max=flat.numel() - 1)].long()]
    out = torch.zeros(((nb + 1) * SPARSE_BLOCK,), dtype=torch.int32, device=dev)
    out[pos] = tex
    return out[:nb * SPARSE_BLOCK]


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

    face, fy, fx = _face_texel_f(cubemap, d)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=cubemap.w - 1)
    y1 = torch.clamp(y0 + 1, max=cubemap.h - 1)
    wx = fx - x0
    wy = fy - y0

    c00 = _fetch_flat(cubemap, _flat_index(cubemap, face, y0, x0))
    c01 = _fetch_flat(cubemap, _flat_index(cubemap, face, y0, x1))
    c10 = _fetch_flat(cubemap, _flat_index(cubemap, face, y1, x0))
    c11 = _fetch_flat(cubemap, _flat_index(cubemap, face, y1, x1))
    top = c00 + (c01 - c00) * wx
    bot = c10 + (c11 - c10) * wx
    return top + (bot - top) * wy


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
