"""The (tile, sample) mesh that sharded rendering and training run over.

Counterpart of ``ray_tracing_tpu/parallel/mesh.py``. The reference's only
parallelism is one pthread per image column on one host; the JAX package
lays its devices out as a 2-D mesh, and so does this package:

    "tile"   - data-parallel over pixel tiles (rows of the image);
    "sample" - parallel over the samples of a pixel, whose sums are added
               (parallel/render.py).

A mesh is a (tiles x samples) grid of **cells**. A cell is a (process rank,
torch.device) pair: the process that renders it and the device it renders
on. Several cells may name one device. Such *virtual* cells run one after
another on it, and play the part of the JAX package's
``--xla_force_host_platform_device_count`` devices: one card, or the CPU in
the tests, runs a 4x2 mesh in one process. A mesh whose cells belong to
several processes (parallel/distributed.py::global_mesh) also holds the
process group of every tile whose samples span more than one process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ray_tracing_tpu_torch.device import resolve_device

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def current_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Cell:
    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """cells[tile][sample]. `sample_groups` maps a tile whose cells belong to
    more than one process to the process group of those processes."""

    cells: tuple
    sample_groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                            hash=False, repr=False)

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: len(self.cells), SAMPLE_AXIS: len(self.cells[0])}

    @property
    def ranks(self) -> tuple:
        return tuple(sorted({c.rank for row in self.cells for c in row}))

    def local_cells(self, rank: int | None = None) -> list:
        """(tile, sample, cell) of every cell of process `rank` (default:
        this one), in row-major (tile, sample) order."""
        rank = current_rank() if rank is None else rank
        return [(t, s, c) for t, row in enumerate(self.cells) for s, c in enumerate(row)
                if c.rank == rank]


def to_cell(d) -> Cell:
    """A Cell as it is, or a device as a cell of this process (cuda without
    an index is the current card)."""
    if isinstance(d, Cell):
        return d
    device = resolve_device(d)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Cell(current_rank(), device)


def local_devices() -> list:
    """Every card of this process (cuda:0 .. cuda:n-1); raises without one."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(num_tiles: int | None = None, num_samples: int = 1, devices=None) -> Mesh:
    """Build a (tile, sample) mesh. Defaults: every local card, all on the
    tile axis. `devices` lists one device (or Cell) per cell in row-major
    (tile, sample) order and may name one device several times (virtual
    cells); a plain device becomes a cell of this process.

    A mesh of several processes' cells must hold cells of every process of
    the default group, and every process must build it, with the same
    cells: building it creates the tiles' sample groups, which is a
    collective call."""
    if devices is None:
        devices = local_devices()
    cells = [to_cell(d) for d in devices]
    n = len(cells)
    if num_tiles is None:
        num_tiles = n // num_samples
    if num_tiles < 1 or num_samples < 1 or num_tiles * num_samples != n:
        raise ValueError(f"mesh {num_tiles}x{num_samples} != {n} devices")
    grid = tuple(tuple(cells[t * num_samples:(t + 1) * num_samples]) for t in range(num_tiles))
    ranks = sorted({c.rank for c in cells})
    groups = {}
    if len(ranks) > 1:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if ranks != list(range(world)):
            raise ValueError(f"a mesh of the cells of processes {ranks} in a world of {world}")
        for t, row in enumerate(grid):
            tile_ranks = sorted({c.rank for c in row})
            if len(tile_ranks) > 1:
                # every process takes part in creating every group
                groups[t] = dist.new_group(tile_ranks)
    return Mesh(grid, groups)


def single_device_mesh(device=None) -> Mesh:
    """A 1x1 mesh of `device` (default: the card)."""
    return make_mesh(1, 1, devices=[device if device is not None else resolve_device(None)])


def parse_mesh(spec: str | None, device=None) -> Mesh:
    """The mesh of a command line's --mesh TxS over this process's devices.

    device "cpu" makes CPU cells; otherwise the cells go to the local cards,
    consecutive cells to one card, so that T*S may exceed the card count
    (virtual cells). spec None: every local card, with a sample axis of 2
    when their count is even (the JAX invert app's mesh); one cell on the
    CPU."""
    dev = resolve_device(device)
    devices = [dev] if dev.type == "cpu" else local_devices()
    if spec is None:
        n = len(devices)
        ns = 2 if n % 2 == 0 else 1
        return make_mesh(n // ns, ns, devices=devices)
    try:
        nt, ns = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {spec!r}: expected TxS, e.g. 4x2") from None
    n = nt * ns
    if n < 1 or nt < 1 or ns < 1:
        raise ValueError(f"mesh {spec!r}: both axes must be positive")
    return make_mesh(nt, ns, devices=[devices[i * len(devices) // n] for i in range(n)])
