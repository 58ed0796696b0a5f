"""The plain reference of the train cell: the squared-error loss of a frame
against a target, its gradient by autograd through the plain path tracer,
and Adam written out by hand.

Imports nothing of the program. It renders the target itself from the
unperturbed scene, starts from the perturbed leaves that the benchmark
hands both sides, and follows the same step seeds.
"""

from __future__ import annotations

import torch

from portbench.reference.pathtracer import Frame, Scene, make_scene, render, replay_gradient

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def follow(scene_text: str, frame: Frame, start: dict, fields, target_seed: int,
           step_seeds, spp: int, lr: float, counts: list | None = None) -> dict:
    """Adam over `fields` from the leaves `start` ({field: float32 tensor}),
    one step per seed of `step_seeds`, each on the loss
    sum((frame - target)^2) / (W * H * 3) of an `spp`-sample frame, the
    target an `spp`-sample frame of the unperturbed scene seeded
    `target_seed`. Returns {"losses": [...], "first_grad": {field: tensor},
    "change": {field: tensor}} (the change of each leaf after the last
    step), float32 whatever the frame's dtype. `counts` gets the work
    counts of the first step's samples."""
    dev, dt = frame.sky.device, frame.dtype
    base = make_scene(scene_text, dev, dt)
    with torch.no_grad():
        target = render(base, frame, target_seed, spp)
    leaves = {f: start[f].to(dev, dt).clone().requires_grad_(True) for f in fields}
    scene = Scene({**base.fields, **leaves}, base.is_sphere, base.light)
    m = {f: torch.zeros_like(x) for f, x in leaves.items()}
    v = {f: torch.zeros_like(x) for f, x in leaves.items()}
    denom = float(frame.width * frame.height * 3)
    losses, first_grad = [], None
    for t, seed in enumerate(step_seeds, 1):
        kept = []
        with torch.no_grad():
            img = render(scene, frame, seed, spp, counts=counts if t == 1 else None, keep=kept)
            diff = img - target
            losses.append(float((diff.float() * diff.float()).sum()) / denom)
            cot = (2.0 / denom) * diff
        for x in leaves.values():
            x.grad = None
        replay_gradient(scene, frame, seed, spp, kept, cot)
        del kept
        grads = {f: (x.grad if x.grad is not None else torch.zeros_like(x))
                 for f, x in leaves.items()}
        if t == 1:
            first_grad = {f: g.float().clone() for f, g in grads.items()}
        with torch.no_grad():
            c1 = 1.0 - BETA1 ** t
            c2 = 1.0 - BETA2 ** t
            for f, x in leaves.items():
                g = grads[f]
                m[f].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v[f].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                x.sub_((lr / c1) * m[f] / (v[f].sqrt() / c2 ** 0.5 + EPS))
    change = {f: (x.detach().float() - start[f].to(dev).float()) for f, x in leaves.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
