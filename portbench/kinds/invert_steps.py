"""invert's own fit (the port's apps/invert.py at its defaults): Adam steps
of the port's ``make_train_step`` on a float sky read with the bilinear
filter and frames blended with the soft primary visibility, back to back,
as ``fit`` drives them.

The configuration's "sky" is {"kind": "gradient", "size": S}: the port's
``gradient_sky`` (per-face linear ramps in float32), written out here
(gradient_faces) and made once on the host; its texels are handed to the
program as a CubemapData of float planes and to the reference as they are.
Everything else is adam_steps': the set-up (target from frame seed
mix(seed, 3), the start perturbed from the traffic's fixed perturb_seed,
the first `followed_steps` steps seeded mix(seed, 4, i)), the window of
back-to-back fits of `fit_steps` steps (here with each fit's losses read
when it ends), and the comparison (loss_gap, grad_gap, change_gap); the
reference that follows the first steps is reference/invert.py.

It takes only what the port offered before its bilinear sky kernel
(make_train_step, render_image_cuda, CubemapData), so that a checkout
without that kernel runs the cell on its plain bilinear lookup.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, roofline, sky_work
from portbench.kinds import adam_steps
from portbench.reference import invert as ref_invert
from portbench.reference import pathtracer as pt


def gradient_faces(size: int) -> np.ndarray:
    """(6, S, S, 3) float32 faces of the port's gradient_sky(S): red
    0.15 + 0.7 x (f % 3 + 1) / 3, green 0.2 + 0.6 y, blue
    0.25 + 0.1 f + 0.4 x (1 - y), x and y from 0 to 1 across the face
    (numpy's linspace, in float64, stored as float32)."""
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, size), np.linspace(0.0, 1.0, size),
                         indexing="ij")
    faces = np.zeros((6, size, size, 3), np.float32)
    for f in range(6):
        faces[f, ..., 0] = 0.15 + 0.7 * xx * ((f % 3) + 1) / 3
        faces[f, ..., 1] = 0.2 + 0.6 * yy
        faces[f, ..., 2] = 0.25 + 0.1 * f + 0.4 * xx * (1 - yy)
    return faces


def make_sky(sky: dict, device) -> ref_invert.Sky:
    """The configuration's float sky as (6*S*S,) float32 planes on
    `device`."""
    if sky["kind"] != "gradient":
        raise ValueError(f"unknown sky kind {sky['kind']!r}")
    flat = torch.from_numpy(gradient_faces(sky["size"]).reshape(-1, 3))
    return ref_invert.Sky(*(flat[:, c].contiguous().to(device) for c in range(3)), sky["size"])


class Load(adam_steps.Load):
    def setup(self, optimizer_fault=None, spp_fault=None) -> None:
        """adam_steps.Load.setup with the configuration's float sky."""
        from ray_tracing_tpu_torch.config import RenderConfig
        from ray_tracing_tpu_torch.diff.inverse import make_train_step
        from ray_tracing_tpu_torch.kernels.megakernel import (
            effective_bwd_mode, render_image_cuda)
        from ray_tracing_tpu_torch.ops.cubemap import CubemapData
        from ray_tracing_tpu_torch.render.camera import Camera
        from ray_tracing_tpu_torch.scene.parser import parse_scene_string

        cfg, dev, tr = self.config, self.device, self.traffic
        self.sky = make_sky(cfg["sky"], dev)
        s = self.sky.size
        cubemap = CubemapData(None, self.sky.r, self.sky.g, self.sky.b, s, s)
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
        self.optimizer = torch.optim.Adam(list(self.params["scene"].values()), lr=tr["lr"])
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
                    f: (self.optimizer.state[x]["exp_avg"] / (1.0 - adam_steps.BETA1))
                    .detach().clone() if x in self.optimizer.state else torch.zeros_like(x)
                    for f, x in self.params["scene"].items()}
        self.losses = [float(x) for x in losses]
        self.change = {f: x.detach() - self.start[f].to(dev)
                       for f, x in self.params["scene"].items()}
        self.info = {"spp": self.spp, "frame": [self.w, self.h], "bwd_mode": mode,
                     "fields": list(self.fields), "followed_steps": tr["followed_steps"],
                     "sky": cfg["sky"], "env_filter": rc.env_filter,
                     "soft_silhouette_temp": rc.soft_silhouette_temp}

    def window(self, win) -> dict:
        """adam_steps.Load.window, with each fit's losses read when the fit
        ends, as fit reads them: the device holds one fit's losses at most,
        so that the memory peak does not grow with the steps the window
        takes (a 0-dim loss holds a 512-byte block of the card's allocator,
        some 10 % of this cell's peak over a thousand steps)."""
        losses, pending = [], []
        i = self.traffic["followed_steps"]
        fit_steps = self.traffic["fit_steps"]
        win.open()
        while win.more():
            if win.in_slice and self.slice_params is None:
                self.slice_params = {f: x.detach().clone()
                                     for f, x in self.params["scene"].items()}
            with win.span("step"):
                if i % fit_steps == 0:
                    if pending:
                        losses += torch.stack(pending).tolist()
                        pending = []
                    self._restart()
                pending.append(self.step(self.params, self.target, self.step_seed(i)))
            i += 1
        with win.span("drain"):
            losses += torch.stack(pending).tolist()
        elapsed = time.perf_counter() - win.t0
        win.close_slice()
        self.attempted = len(losses)
        self.failed = sum(1 for x in losses if not x == x or abs(x) == float("inf"))
        seconds, steps = win.before_slice(elapsed, len(losses))
        return {"train_step_ms": seconds / steps * 1e3}

    def frame(self, dtype=torch.float32) -> pt.Frame:
        cfg = self.config
        return pt.Frame(cfg["width"], cfg["height"], cfg["physics"], cfg["camera"], self.sky.r,
                        self.sky.size, dtype)

    def follow(self, dtype=torch.float32) -> dict:
        seeds = [self.step_seed(i) for i in range(self.traffic["followed_steps"])]
        return ref_invert.follow(self.config["scene"], self.frame(dtype), self.sky, self.start,
                                 self.fields, inputs.mix(self.seed, 3), seeds, self.spp,
                                 self.traffic["lr"], self.config["physics"]["soft_silhouette_temp"])

    def work(self) -> dict:
        """Bounds of one launch of K2 and of K3 (counted as adam_steps.work
        counts them) and of the bilinear sky compose and its adjoint
        (sky_work.py) on these inputs: the reference's per-bounce counts and
        miss directions of one sample at the leaves the traced slice started
        from (else at the start)."""
        ph = self.config["physics"]
        base = pt.make_scene(self.config["scene"], self.device)
        leaves = self.slice_params or {f: x.to(self.device) for f, x in self.start.items()}
        scene = pt.Scene({**base.fields, **leaves}, base.is_sphere, base.light)
        counts = []
        with torch.no_grad():
            _, sky_dir, _, _ = pt.sample_planes(scene, self.frame(), self.step_seed(0),
                                                pt.Winners(scene), counts)
        stats = roofline.per_sample(counts, 1)
        ns = ph["shadow_samples"] if base.light >= 0 else 0
        single = not ({"emission_power", "emission_color"} & set(self.fields))
        emitters = int((base.fields["emission_power"] > 0).sum())
        light_sph = base.is_sphere[base.light] if ns and single and emitters == 1 else None
        px, n, nsph = self.w * self.h, base.n, sum(base.is_sphere)
        sectors = sky_work.sectors(self.sky.size, sky_dir, planes=3)
        return {"k2": roofline.forward(stats, px, n, nsph, ph["bounces"], ns, light_sph,
                                       record=True),
                "k3": roofline.backward_fetch(stats, px, n, ph["bounces"], ns),
                "sky_bilinear": sky_work.forward(px, sectors, (self.spp - 1) / self.spp),
                "sky_bilinear_adjoint": sky_work.adjoint(px, sectors)}
