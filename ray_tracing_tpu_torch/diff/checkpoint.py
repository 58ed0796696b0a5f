"""Checkpoints: arbitrary state dicts, and the film's accumulation state.

Counterpart of ``ray_tracing_tpu/diff/checkpoint.py``. The reference has no
checkpointing at all; the JAX package writes orbax (or pickle) directories,
this package one ``torch.save`` file per step, ``ckpt_<step:08d>.pt``, read
back with ``torch.load(weights_only=True)``: tensors, Python numbers,
strings and containers of them, no arbitrary objects. Tensors are written
from the host and restored there; numpy arrays are stored as tensors and
numpy scalars as Python numbers, which the restricted loader would refuse.

Used by ``diff/inverse.py::fit`` (the leaves, Adam's state, the step, the
losses and the field list), ``apps/serve.py`` (the film and the camera pose
it was accumulated at) and ``save_film`` / ``restore_film``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.film import Film


def _to_host(tree):
    """Tensors -> CPU tensors, numpy arrays -> tensors, numpy scalars ->
    Python numbers, recursively through dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pt")


def save_checkpoint(directory: str, state: dict, step: int) -> str:
    """Write `state` for `step`; returns the path. The file is replaced
    atomically, so a reader never sees half of it."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_host(state), tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    """The highest step with a checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name[5:13]) for name in os.listdir(directory)
             if name.startswith("ckpt_") and name[5:13].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """The state dict at `step` (default: the latest) with tensors on the
    CPU, or None when there is none. A checkpoint that exists but does not
    read back warns and gives None: a resume is never taken silently for a
    fresh start."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = checkpoint_path(directory, step)
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # a torn, foreign or missing file: report and go on
        warnings.warn(f"failed to restore checkpoint {path} "
                      f"({type(e).__name__}: {e}); treating as no checkpoint")
        return None


# --- Film accumulation state (render/film.py) -------------------------------

FILM_TAG = 1


def film_state(film) -> dict:
    """The entries of a Film in a checkpoint."""
    return {"film_tag": FILM_TAG, "accum_x": film.accum.x, "accum_y": film.accum.y,
            "accum_z": film.accum.z, "weight": film.weight}


def film_from_state(state: dict, device):
    """The Film of a checkpoint's entries, on `device`; ValueError when the
    state holds no Film."""
    if state.get("film_tag") != FILM_TAG:
        raise ValueError("this checkpoint is not a Film checkpoint")
    accum = Vec3(*(state[k].to(device=device, dtype=torch.float32)
                   for k in ("accum_x", "accum_y", "accum_z")))
    return Film(accum=accum, weight=torch.as_tensor(state["weight"], dtype=torch.float32,
                                                    device=device))


def save_film(directory: str, film, step: int = 0) -> str:
    """Checkpoint a Film, so that a long progressive render survives a
    restart."""
    return save_checkpoint(directory, film_state(film), step)


def restore_film(directory: str, step: int | None = None, device=None):
    """The Film checkpointed in `directory` on `device` (device=None means
    the card), or None when there is none."""
    device = resolve_device(device)
    state = restore_checkpoint(directory, step)
    return None if state is None else film_from_state(state, device)
