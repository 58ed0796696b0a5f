"""Faults planted under the timed path, for the tests and the calibration
(never a benchmark run): each is one a change to the program could bring,
and the cell's comparison has to come out not correct under each."""

from __future__ import annotations


def frozen_state(optimizer) -> None:
    """A train step that returns its state unchanged: the optimizer's step
    does nothing."""
    optimizer.step = lambda *a, **k: None


def halved_gradients(optimizer) -> None:
    """An answer altered where it is produced: every gradient halved before
    the optimizer reads it."""
    step = optimizer.step

    def faulty(*a, **k):
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(0.5)
        return step(*a, **k)

    optimizer.step = faulty


def stale_frame(render):
    """A render that returns its first frame again: the state unchanged."""
    first = {}

    def faulty(*a, **k):
        if "img" not in first:
            first["img"] = render(*a, **k)
        return first["img"]

    return faulty


def half_samples(render):
    """Half of a frame's samples left out, the mean taken over the rest."""
    def faulty(*a, spp, **k):
        return render(*a, spp=max(spp // 2, 1), **k)

    return faulty


def wrong_seed(render):
    """An answer altered where it is produced: every frame drawn from the
    seed next to its own."""
    def faulty(*a, seed, **k):
        return render(*a, seed=seed + 1, **k)

    return faulty
