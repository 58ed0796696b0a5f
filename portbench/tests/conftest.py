"""Shared fixtures of the benchmark's own tests: cells cut to a size the
CPU runs in seconds, and the card, decided inside a fixture."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELLS = ("scene2.render", "scene2.train")

# A floor cube and a light over scene_2's spheres: the cube tests, the shadow
# rays and the emission that scene_2 alone never reaches, for the tests that
# hold the reference against the port.
LIT_SCENE = (
    "cube origin {-8 -1.5 -8} size {16 0.5 16} albedo    {0.55 0.35 0.75} roughness 0.9\n"
    "cube origin {1 -1 -3.5} size {1 2.5 1} albedo    {0.2 0.7 0.3} roughness 0.3 reflectance 0.6\n"
    "sphere center {0 5 0} radius 1 emission_power 10 emission_color {1 0.95 0.85}\n"
    "sphere reflectance 1 roughness 0 albedo    {0.2 0.5 1} center {-3 0 0}\n"
    "sphere metallic    1 roughness 0 albedo    {0.5 0.2 1} center {3 0 0}\n")


def small_cell(name: str, scene: str | None = None):
    """The cell `name` at 32x24 with a 64-texel sky and 2 samples: what a
    test run on the CPU can hold, with the scene text `scene` in place of
    the configuration's where given. Its limits are the cell's own."""
    cell = harness.find_cell(ROOT, name)
    cell.config = {**cell.config, "width": 32, "height": 24,
                   "sky": {**cell.config["sky"], "size": 64}}
    if scene is not None:
        cell.config["scene"] = scene
    cell.traffic = {**cell.traffic, "spp": 2}
    return cell


@pytest.fixture
def small():
    return small_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
