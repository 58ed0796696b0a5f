"""The inputs that the benchmark makes from a configuration and `--seed`,
and hands the same to the program and to the plain reference: the packed
sky table, the frame and step seeds, and the perturbed start of a fit."""

from __future__ import annotations

import torch

from portbench.reference import pathtracer as pt

_MASK64 = (1 << 64) - 1


def mix(*words: int) -> int:
    """A 31-bit seed from whole numbers of any size (splitmix64 steps)."""
    x = 0x9E3779B97F4A7C15
    for w in words:
        x = (x ^ (w & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & 0x7FFFFFFF


def make_sky(sky: dict, device) -> torch.Tensor:
    """The packed (6*S*S,) int32 0x00RRGGBB cubemap of a configuration's
    "sky": kind "checker" is a face-tinted 4-texel checkerboard with a blue
    ramp across each face, made on the device in a few calls."""
    if sky["kind"] != "checker":
        raise ValueError(f"unknown sky kind {sky['kind']!r}")
    s = sky["size"]
    ar = torch.arange(s, dtype=torch.int32, device=device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    check = (yy // 4 + xx // 4) % 2
    blue = (xx * 255) // max(s - 1, 1)
    face = torch.arange(6, dtype=torch.int32, device=device)[:, None, None]
    red = torch.clamp(40 * face + 55 + 120 * check, 0, 255)
    green = torch.clamp(255 - 30 * face - 100 * check, 0, 255)
    return ((red << 16) | (green << 8) | blue).reshape(-1).contiguous()


def reference_frame(config: dict, sky_table: torch.Tensor, dtype=torch.float32) -> pt.Frame:
    return pt.Frame(config["width"], config["height"], config["physics"], config["camera"],
                    sky_table, config["sky"]["size"], dtype)


def perturbed_start(config: dict, fields, scale: float, seed: int) -> dict:
    """{field: float32 CPU tensor}: the configuration's scene values plus
    `scale` times standard normal noise drawn from the seed, field by field
    in the order given."""
    base = pt.make_scene(config["scene"], "cpu")
    gen = torch.Generator().manual_seed(mix(seed, 0x5E))
    return {f: base.fields[f] + scale * torch.randn(base.fields[f].shape, generator=gen)
            for f in fields}
