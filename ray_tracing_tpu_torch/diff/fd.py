"""Finite-difference gradient oracle.

Counterpart of ``ray_tracing_tpu/diff/fd.py``: a central-difference check of
the renderer's gradients, independent of autograd and of the backward kernel.

Scope: the renderer's discrete decisions (which object a ray hits, specular
or diffuse) are detached, so its analytic gradients carry interior terms
only, no silhouette terms. A finite difference agrees tightly for material
and shading parameters everywhere, and for geometry and camera parameters
where no decision flips inside the step.
"""

from __future__ import annotations

import numpy as np
import torch


def finite_difference_grad(f, params: dict, eps: float = 1e-3) -> dict:
    """Central-difference gradient of the scalar f(params) with respect to
    every entry of every tensor in the (possibly nested) dict `params`.
    Returns a dict of the same structure with float32 tensors on each
    leaf's device.

    2 * (number of scalars) evaluations: for tiny parameter sets only."""

    def recurse(node, rebuild):
        if isinstance(node, dict):
            return {k: recurse(v, lambda new, k=k, node=node, rebuild=rebuild:
                               rebuild({**node, k: new}))
                    for k, v in node.items()}
        leaf = node.detach()
        base = leaf.cpu().numpy().astype(np.float64)
        grad = np.zeros_like(base)
        flat, gflat = base.reshape(-1), grad.reshape(-1)
        for i in range(flat.size):
            def eval_at(delta):
                pert = flat.copy()
                pert[i] += delta
                new = torch.from_numpy(pert.reshape(base.shape).astype(np.float32))
                with torch.no_grad():
                    return float(f(rebuild(new.to(leaf.device))))

            gflat[i] = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
        return torch.from_numpy(grad.astype(np.float32)).to(leaf.device)

    return recurse(params, lambda new: new)
