"""Fitting a scene to an image: Adam steps of the port's
``make_train_step``, back to back, as ``fit`` and the invert app run them.

Set-up renders the target from the configuration's scene (frame seed
mix(seed, 3)), perturbs the fitted fields by `perturb` times a standard
normal draw from the traffic's fixed `perturb_seed` (so that every run
starts the same fit, and the metallic threshold, which decides every
bounce's branch, cuts the same objects: the work is the seed's no
more), builds the step and its Adam state once, and
drives that same step through its first `followed_steps` steps (step i is
seeded mix(seed, 4, i)); the window then goes on with the same object, as
back-to-back fits of `fit_steps` steps (the invert app's default), each from
the same start: over one long fit the leaves drift, and with them the paths'
branches and lengths, by the seed's noise, so that the work would be the
seed's.
The step's losses stay on the device and are read when the window has
closed, as fit reads them.

Correctness: the plain reference follows the first steps from the same
start and seeds (reference/train.py). Compared, each the worst: the
relative gap of each step's loss; by leaf, the gap between the norms of the
first gradient (the program's worked out from Adam's first moment after one
step) and of the leaves' change after the followed steps, over the larger
of the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import inputs, roofline
from portbench.reference import pathtracer as pt
from portbench.reference import train as ref_train

BETA1 = 0.9  # torch.optim.Adam's default first-moment decay


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spp = traffic["spp"]
        self.fields = tuple(traffic["fields"])
        self.w, self.h = config["width"], config["height"]
        self.attempted = self.failed = 0
        self.slice_params = None
        self.info = {}

    def step_seed(self, i: int) -> int:
        return inputs.mix(self.seed, 4, i)

    # -- the program ----------------------------------------------------

    def setup(self, optimizer_fault=None, spp_fault=None) -> None:
        """Everything the window's steps need, and the first steps.
        `optimizer_fault` (a function of the optimizer) and `spp_fault`
        plant faults for the tests and the calibration only."""
        from ray_tracing_tpu_torch.config import RenderConfig
        from ray_tracing_tpu_torch.diff.inverse import make_train_step
        from ray_tracing_tpu_torch.kernels.megakernel import (
            effective_bwd_mode, render_image_cuda)
        from ray_tracing_tpu_torch.ops.cubemap import CubemapData
        from ray_tracing_tpu_torch.render.camera import Camera
        from ray_tracing_tpu_torch.scene.parser import parse_scene_string

        cfg, dev, tr = self.config, self.device, self.traffic
        self.sky_table = inputs.make_sky(cfg["sky"], dev)
        s = cfg["sky"]["size"]
        cubemap = CubemapData(self.sky_table, None, None, None, s, s)
        scene = parse_scene_string(cfg["scene"], device=dev)

        def vec(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        cam = cfg["camera"]
        camera = Camera(pos=vec(cam["pos"]), front=vec(cam["front"]), up=vec(cam["up"]),
                        yaw=vec(-90.0), pitch=vec(0.0))
        rc = RenderConfig(**cfg["physics"], bwd_mode=tr["bwd_mode"])
        with torch.no_grad():
            self.target = render_image_cuda(scene, camera, self.w, self.h,
                                            seed=inputs.mix(self.seed, 3), spp=self.spp,
                                            config=rc, cubemap=cubemap, device=dev)
        self.start = inputs.perturbed_start(cfg, self.fields, tr["perturb"], tr["perturb_seed"])
        self.params = {"scene": {f: self.start[f].to(dev).clone().requires_grad_(True)
                                 for f in self.fields}, "camera": {}}
        leaves = list(self.params["scene"].values())
        self.optimizer = torch.optim.Adam(leaves, lr=tr["lr"])
        if optimizer_fault is not None:
            optimizer_fault(self.optimizer)
        self.step = make_train_step(scene, camera, self.optimizer, self.w, self.h,
                                    spp=spp_fault or self.spp, config=rc, cubemap=cubemap,
                                    device=dev)
        mode = effective_bwd_mode(scene, rc, self.w, self.h, self.spp)
        losses = []
        for i in range(tr["followed_steps"]):
            losses.append(self.step(self.params, self.target, self.step_seed(i)))
            if i == 0:
                self.first_grad = {
                    f: (self.optimizer.state[x]["exp_avg"] / (1.0 - BETA1)).detach().clone()
                    if x in self.optimizer.state else torch.zeros_like(x)
                    for f, x in self.params["scene"].items()}
        self.losses = [float(x) for x in losses]
        self.change = {f: x.detach() - self.start[f].to(dev)
                       for f, x in self.params["scene"].items()}
        self.info = {"spp": self.spp, "frame": [self.w, self.h], "bwd_mode": mode,
                     "fields": list(self.fields), "followed_steps": tr["followed_steps"]}

    def window(self, win) -> dict:
        """Steps back to back until the window closes, as fits of
        `fit_steps` steps each from the same start: every `fit_steps` steps
        the leaves go back to the start and Adam's state is cleared (the
        first fit began at set-up). Returns the end-to-end readings."""
        pending = []
        i = self.traffic["followed_steps"]
        fit_steps = self.traffic["fit_steps"]
        win.open()
        while win.more():
            if win.in_slice and self.slice_params is None:
                self.slice_params = {f: x.detach().clone()
                                     for f, x in self.params["scene"].items()}
            with win.span("step"):
                if i % fit_steps == 0:
                    self._restart()
                pending.append(self.step(self.params, self.target, self.step_seed(i)))
            i += 1
        with win.span("drain"):
            losses = torch.stack(pending).tolist()
        elapsed = time.perf_counter() - win.t0
        win.close_slice()
        self.attempted = len(losses)
        self.failed = sum(1 for x in losses if not x == x or abs(x) == float("inf"))
        seconds, steps = win.before_slice(elapsed, len(losses))
        return {"train_step_ms": seconds / steps * 1e3}

    def _restart(self) -> None:
        """A new fit: the leaves back at the start, Adam's state empty."""
        with torch.no_grad():
            for f, x in self.params["scene"].items():
                x.copy_(self.start[f].to(x.device))
        self.optimizer.state.clear()

    def release(self) -> None:
        for name in ("step", "optimizer", "params", "target"):
            self.__dict__.pop(name, None)

    # -- the reference --------------------------------------------------

    def follow(self, dtype=torch.float32) -> dict:
        frame = inputs.reference_frame(self.config, self.sky_table, dtype)
        seeds = [self.step_seed(i) for i in range(self.traffic["followed_steps"])]
        counts = []
        out = ref_train.follow(self.config["scene"], frame, self.start, self.fields,
                               inputs.mix(self.seed, 3), seeds, self.spp, self.traffic["lr"],
                               counts=counts)
        out["counts"] = counts
        return out

    def check(self, ref=None) -> dict:
        """The compared numbers of the program's first steps against the
        reference's (`ref`, a result of follow(), computed here if None)."""
        ref = ref if ref is not None else self.follow()
        got = {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}
        if "counts" in ref:
            self.work_stats = roofline.per_sample(ref["counts"], self.spp)
        return compare(got, ref, self.fields)

    def work(self) -> dict:
        """Bounds of one K2 and one K3 launch on these inputs: the
        reference's counts of one sample at the leaves that the traced slice
        started from (else of the first step's samples). The fitted
        emission makes the port's shadow trace the full scan."""
        ph = self.config["physics"]
        if self.slice_params is not None:
            base = pt.make_scene(self.config["scene"], self.device)
            scene = pt.Scene({**base.fields, **self.slice_params}, base.is_sphere, base.light)
            frame = inputs.reference_frame(self.config, self.sky_table)
            counts = []
            with torch.no_grad():
                pt.render(scene, frame, self.step_seed(0), 1, counts=counts)
            self.work_stats = roofline.per_sample(counts, 1)
        scene = pt.make_scene(self.config["scene"], "cpu")
        ns = ph["shadow_samples"] if scene.light >= 0 else 0
        single = not ({"emission_power", "emission_color"} & set(self.fields))
        emitters = int((scene.fields["emission_power"] > 0).sum())
        light_sph = scene.is_sphere[scene.light] if ns and single and emitters == 1 else None
        px, n, nsph = self.w * self.h, scene.n, sum(scene.is_sphere)
        return {"k2": roofline.forward(self.work_stats, px, n, nsph, ph["bounces"], ns,
                                       light_sph, record=True),
                "k3": roofline.backward_fetch(self.work_stats, px, n, ph["bounces"], ns)}


def _gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else abs(a - b)


def compare(got: dict, ref: dict, fields) -> dict:
    """loss_gap, grad_gap and change_gap of a program's first steps (`got`)
    against the reference's (`ref`); see the module docstring."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    g_ref = {f: float(ref["first_grad"][f].norm()) for f in fields}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(_gap(float(got["first_grad"][f].float().norm()), g_ref[f],
                        max(g_ref[f], g_med)) for f in fields)
    moved = [f for f in fields if g_ref[f] >= 1e-3 * g_med]
    c_ref = {f: float(ref["change"][f].norm()) for f in moved}
    c_med = statistics.median(c_ref.values())
    change_gap = max(_gap(float(got["change"][f].float().norm()), c_ref[f],
                          max(c_ref[f], c_med)) for f in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
