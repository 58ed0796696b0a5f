"""Sharded rendering: pixel tiles x samples over a mesh of cells.

Counterpart of ``ray_tracing_tpu/parallel/render.py``. Every cell (t, s) of
the mesh (parallel/mesh.py) renders the rows of tile t with its share of
the samples, through ``render_image_cuda``: the K1 kernel on a CUDA cell,
the plain estimator on a CPU cell, and nothing else decides. The JAX
package's ``kernel=`` choice (``resolve_kernel``, ``KERNELS``) is that
device rule here.

Seeds: cell (t, s) renders the global samples s*local_spp ..
(s+1)*local_spp - 1 of the one-device frame, with the seeds the one-device
frame gives them (kernels/megakernel.py::frame_sample_seeds), and the draws
are keyed by the global pixel. So a mesh changes only the order of the sums:
the sharded frame equals the one-device frame to float rounding. (The JAX
package folds a key per device instead; its sharded frame matches only
statistically.)

The sample-axis sum: the cells of one process are added in a fixed order
(sample index); a tile whose cells belong to several processes is then
summed across them by ``SampleSum``, whose backward is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tracing_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
from ray_tracing_tpu_torch.ops.cubemap import CubemapData
from ray_tracing_tpu_torch.parallel.mesh import SAMPLE_AXIS, TILE_AXIS, Mesh, current_rank
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.types import Scene


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM all-reduce of `t` over `group`. Gloo reduces a CUDA
    tensor through a host copy (two processes sharing one card need gloo:
    NCCL refuses two ranks on one GPU)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


class SampleSum(torch.autograd.Function):
    """A tile's total: the sum of every process's partial sample sum.

    forward: all_reduce(SUM) over the tile's sample group. backward: the
    IDENTITY. Each process's partial enters the total once, so the total's
    cotangent is each partial's cotangent; the gradients of the cells are
    summed once, by the train step's all-reduce over processes.

    Do not replace it with ``torch.distributed.nn.functional.all_reduce``:
    its backward all-reduces the cotangent, the transpose of a psum being a
    psum. That is the JAX package's sample-axis gradient fault (ROADMAP.md
    §3, reference-side fault 10): ``make_train_step`` differentiates through
    the sample psum of ``_local_tile_render`` inside ``shard_map(...,
    check_vma=False)``, so every sample device carries S copies of the
    image's cotangent and, after the gradient psum, a mesh whose sample axis
    has size S returns S times the gradient (the loss is right)."""

    @staticmethod
    def forward(ctx, partial, group):
        return all_reduce_(partial.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local_tile_render(scene: Scene, camera: Camera, seed: int, width: int, height: int,
                       spp: int, config: RenderConfig, cubemap: CubemapData | None,
                       mesh: Mesh, tile: int, sample: int, device):
    """The image of cell (tile, sample): the mean over its local samples of
    its row slice, (height / n_tiles, width, 3) on `device`."""
    local_h = height // mesh.shape[TILE_AXIS]
    local_spp = spp // mesh.shape[SAMPLE_AXIS]
    return render_image_cuda(
        scene, camera, width, local_h, seed, spp=local_spp, config=config, cubemap=cubemap,
        row0=tile * local_h, norm_height=height, aspect=width / height,
        first_sample=sample * local_spp, frame_spp=spp, device=device)


def check_shape(mesh: Mesh, height: int, spp: int) -> None:
    """The JAX package's guards: rows divide over the tile axis, samples
    over the sample axis (a remainder would render a scaled frame, and
    spp < n_samples nothing at all)."""
    n_tiles, n_samples = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if height % n_tiles:
        raise ValueError(f"height {height} not divisible by tile axis {n_tiles}")
    if spp % n_samples:
        raise ValueError(f"spp {spp} not divisible by sample axis {n_samples}")


def render_tiles_sharded(scene: Scene, camera: Camera, width: int, height: int, seed: int,
                         mesh: Mesh, spp: int = 1, config: RenderConfig = DEFAULT_CONFIG,
                         cubemap: CubemapData | None = None):
    """{tile: (height / n_tiles, width, 3) image} over the tiles and cells
    of this process. A tile's image is the frame's mean over all its
    samples, on the device of its first local cell, differentiable with
    respect to the scene's and camera's leaves."""
    check_shape(mesh, height, spp)
    n_samples = mesh.shape[SAMPLE_AXIS]
    rank = current_rank()
    images = {}
    for t, row in enumerate(mesh.cells):
        total = None
        for s, cell in enumerate(row):
            if cell.rank != rank:
                continue
            img = _local_tile_render(scene, camera, seed, width, height, spp, config, cubemap,
                                     mesh, t, s, cell.device)
            if n_samples > 1:
                img = img * float(spp // n_samples)
            total = img if total is None else total + img.to(total.device)
        if total is None:
            continue
        if t in mesh.sample_groups:
            total = SampleSum.apply(total, mesh.sample_groups[t])
        images[t] = total * (1.0 / spp) if n_samples > 1 else total
    return images


def render_image_sharded(scene: Scene, camera: Camera, width: int, height: int, seed: int,
                         mesh: Mesh, spp: int = 1, config: RenderConfig = DEFAULT_CONFIG,
                         cubemap: CubemapData | None = None):
    """The frame sharded over (tile, sample): (rows, width, 3), the rows of
    every tile with a cell in this process, in order, on the device of the
    first of them. In one process that is the whole (height, width, 3)
    frame. Requires height % n_tiles == 0 and spp % n_samples == 0 (pad
    upstream)."""
    images = render_tiles_sharded(scene, camera, width, height, seed, mesh, spp, config,
                                  cubemap)
    tiles = sorted(images)
    if not tiles:
        raise ValueError(f"process {current_rank()} has no cell in the mesh")
    if tiles != list(range(tiles[0], tiles[-1] + 1)):
        raise ValueError(f"this process's tiles {tiles} are not contiguous")
    home = images[tiles[0]].device
    return torch.cat([images[t].to(home) for t in tiles], dim=0)
