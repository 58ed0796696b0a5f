"""The inputs that the benchmark makes from a configuration and `--seed`,
and hands the same to the program and to the plain reference: the packed
sky table, the frame and step seeds, and the perturbed start of a fit."""

from __future__ import annotations

import torch

from portbench.reference import pathtracer as pt

_MASK64 = (1 << 64) - 1
# Rows of one face that make_sky fills at a time: 2 MiB an int32 temporary
# at S = 2048, where the whole (6,S,S) table's temporaries took 512 MiB.
SKY_ROWS = 256


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
    ramp across each face, made on the device into one table, SKY_ROWS rows
    of one face at a time, so that no temporary is larger than SKY_ROWS*S."""
    if sky["kind"] != "checker":
        raise ValueError(f"unknown sky kind {sky['kind']!r}")
    s = sky["size"]
    table = torch.empty((6, s, s), dtype=torch.int32, device=device)
    ar = torch.arange(s, dtype=torch.int32, device=device)
    xx = ar[None, :]
    blue = (xx * 255) // max(s - 1, 1)
    for face in range(6):
        for r0 in range(0, s, SKY_ROWS):
            yy = ar[r0:r0 + SKY_ROWS, None]
            check = (yy // 4 + xx // 4) % 2
            red = torch.clamp(40 * face + 55 + 120 * check, 0, 255)
            green = torch.clamp(255 - 30 * face - 100 * check, 0, 255)
            table[face, r0:r0 + SKY_ROWS] = (red << 16) | (green << 8) | blue
    return table.reshape(-1)


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
