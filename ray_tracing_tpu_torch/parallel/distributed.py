"""Several processes: bootstrap, the global mesh and row ownership.

Counterpart of ``ray_tracing_tpu/parallel/distributed.py``. The reference is
a single process; the JAX package starts several with
``jax.distributed.initialize``, this package with
``torch.distributed.init_process_group``, which nothing on a machine
configures by itself: every process is given the rendezvous address, the
world size and its rank.

    from ray_tracing_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize("file:///shared/store", world_size=2, rank=r)  # no-op alone
    mesh = global_mesh(num_samples=2)                          # every process's cells

Backends: ``nccl`` for cells on cards, ``gloo`` for CPU cells; an explicit
``backend="gloo"`` on cards is what two processes sharing one card need
(NCCL refuses two ranks on one GPU). Nothing falls back from one backend to
the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.parallel.mesh import (
    TILE_AXIS,
    Cell,
    Mesh,
    current_rank,
    local_devices,
    make_mesh,
    to_cell,
)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None, device=None) -> None:
    """torch.distributed.init_process_group, and nothing in a single
    process (no init_method, or a world of one). backend=None is "nccl"
    when this process's cells are cards (device=None means the card) and
    "gloo" when they are on the CPU."""
    if init_method is None or (world_size or 1) <= 1:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def global_mesh(num_samples: int = 1, devices=None) -> Mesh:
    """The (tile, sample) mesh over every process's cells. `devices` are
    this process's (default: every local card; they may repeat, as virtual
    cells). Cells are laid out by rank, so consecutive tiles land on one
    process and a tile's samples span processes only when num_samples
    exceeds a process's cells. Every process calls it, with the same
    num_samples."""
    if devices is None:
        devices = local_devices()
    devices = [to_cell(d).device for d in devices]
    if not dist.is_initialized():
        return make_mesh(num_samples=num_samples, devices=devices)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, [str(d) for d in devices])
    cells = [Cell(r, torch.device(d)) for r, names in enumerate(everyone) for d in names]
    return make_mesh(num_samples=num_samples, devices=cells)


def is_coordinator() -> bool:
    return current_rank() == 0


def local_tile_range(mesh: Mesh, height: int) -> tuple[int, int]:
    """Rows [lo, hi) of the image that this PROCESS owns: the tiles whose
    first sample cell it holds (each row is owned once, for host-side IO
    such as saving a process's rows). (0, 0) when it owns none."""
    rows_per_tile = height // mesh.shape[TILE_AXIS]
    rank = current_rank()
    local = [t for t, row in enumerate(mesh.cells) if row[0].rank == rank]
    if not local:
        return 0, 0
    return min(local) * rows_per_tile, (max(local) + 1) * rows_per_tile
