"""Frames handed to a user, in a closed loop: what the port's command line,
fly-through, viewer and HTTP service do with a frame.

A frame is `spp` samples of the configuration's view through
``render_image_cuda``, turned into uint8 on the device as the service does
(clamp, times 255, truncated) and copied into pinned host memory. Frames
are submitted back to back with `in_flight` of them in flight; each
frame's latency runs from its submission to its image on the host. Frame i
of a run is seeded mix(seed, 1, i).

Correctness: `check_frames` frames of the window, drawn from the seed by
reservoir sampling, are held against the plain reference's frames of the
same seeds, pixel for pixel on the host images.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import inputs, roofline
from portbench.harness import percentile
from portbench.reference import pathtracer as pt


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spp = traffic["spp"]
        self.w, self.h = config["width"], config["height"]
        self.kept = []          # (index, frame seed, host uint8 image)
        self.latencies = []
        self.attempted = 0
        self.info = {}

    # -- the program ----------------------------------------------------

    def setup(self, render_fault=None) -> None:
        """Build the scene, camera, configuration and sky on the card and
        warm every shape of the loop up with two frames. `render_fault`
        (tests and calibration only) stands in for render_image_cuda."""
        from ray_tracing_tpu_torch.config import RenderConfig
        from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
        from ray_tracing_tpu_torch.ops.cubemap import CubemapData
        from ray_tracing_tpu_torch.render.camera import Camera
        from ray_tracing_tpu_torch.scene.parser import parse_scene_string

        cfg, dev = self.config, self.device
        self.sky_table = inputs.make_sky(cfg["sky"], dev)
        s = cfg["sky"]["size"]
        self.cubemap = CubemapData(self.sky_table, None, None, None, s, s)
        self.scene = parse_scene_string(cfg["scene"], device=dev)

        def vec(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        cam = cfg["camera"]
        self.camera = Camera(pos=vec(cam["pos"]), front=vec(cam["front"]), up=vec(cam["up"]),
                             yaw=vec(-90.0), pitch=vec(0.0))
        self.render_config = RenderConfig(**cfg["physics"])
        self.render = render_fault or render_image_cuda
        n = self.traffic["in_flight"] + 1
        pin = dev.type == "cuda"
        self.buffers = [torch.empty((self.h, self.w, 3), dtype=torch.uint8, pin_memory=pin)
                        for _ in range(n)]
        for i in range(2):
            self._complete(self._submit(-1 - i))
        self.info = {"spp": self.spp, "in_flight": self.traffic["in_flight"],
                     "frame": [self.w, self.h]}

    def frame_seed(self, i: int) -> int:
        return inputs.mix(self.seed, 1, i)

    def _submit(self, i: int, profiled: bool = False):
        fs = self.frame_seed(i)
        t0 = time.perf_counter()
        with torch.no_grad():
            img = self.render(self.scene, self.camera, self.w, self.h, seed=fs, spp=self.spp,
                              config=self.render_config, cubemap=self.cubemap,
                              device=self.device)
            u8 = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
        host = self.buffers[i % len(self.buffers)]
        host.copy_(u8, non_blocking=True)
        done = torch.cuda.Event() if self.device.type == "cuda" else None
        if done is not None:
            done.record()
        return i, fs, t0, host, done, profiled

    @staticmethod
    def _complete(frame):
        t0, done = frame[2], frame[4]
        if done is not None:
            done.synchronize()
        return time.perf_counter() - t0

    def window(self, win) -> dict:
        """Frames back to back until the window closes; the ones in flight
        then finish. Returns the end-to-end readings (in a traced run, of the
        frames begun before the profiler started)."""
        rng = random.Random(inputs.mix(self.seed, 2))
        k = self.traffic["check_frames"]
        inflight = []
        win.open()
        i = 0
        while win.more():
            with win.span("render"):
                frame = self._submit(i, win.profiled)
            inflight.append(frame)
            i += 1
            if len(inflight) >= self.traffic["in_flight"]:
                with win.span("wait"):
                    self._done(inflight.pop(0), rng, k)
        with win.span("wait"):
            while inflight:
                self._done(inflight.pop(0), rng, k)
        elapsed = time.perf_counter() - win.t0
        win.close_slice()
        self.attempted = i
        seconds, frames = win.before_slice(elapsed, i)
        return {"frame_ms": seconds / frames * 1e3,
                "frame_p95_ms": percentile(self.latencies, 95) * 1e3}

    def _done(self, frame, rng, k) -> None:
        latency = self._complete(frame)
        j, fs, _, host, _, profiled = frame
        if not profiled:
            self.latencies.append(latency)
        slot = j if j < k else rng.randrange(j + 1)
        if slot < k:
            entry = (j, fs, host.clone())
            if slot < len(self.kept):
                self.kept[slot] = entry
            else:
                self.kept.append(entry)

    def release(self) -> None:
        for name in ("scene", "camera", "cubemap", "buffers", "render"):
            self.__dict__.pop(name, None)

    # -- the reference --------------------------------------------------

    def check(self, frames=None) -> dict:
        """The compared numbers over the kept frames (or `frames`, a list of
        (frame seed, host uint8 image) standing in for the program's):
        the mean absolute difference of the uint8 images in units of 1/255
        of full scale, and the share of pixels off by more than one unit in
        some channel, each the worst frame's. The reference's frames and
        work counts are kept for a later call and for the roofline."""
        frames = frames if frames is not None else [(fs, img) for _, fs, img in self.kept]
        if not hasattr(self, "_want"):
            self._want, self._counts = {}, []
        mean_err, off = 0.0, 0.0
        for fs, got in frames:
            if fs not in self._want:
                frame = inputs.reference_frame(self.config, self.sky_table, torch.float32)
                scene = pt.make_scene(self.config["scene"], self.device)
                with torch.no_grad():
                    self._want[fs] = pt.to_uint8(pt.render(scene, frame, fs, self.spp,
                                                           counts=self._counts))
            got = got.to(self.device).to(torch.int16)
            diff = (got - self._want[fs].to(torch.int16)).abs()
            mean_err = max(mean_err, float(diff.float().mean()) / 255.0)
            off = max(off, float((diff > 1).any(dim=-1).float().mean()))
        self.work_stats = roofline.per_sample(self._counts, self.spp * len(self._want))
        return {"frame_mean_abs_err": mean_err, "frame_px_off_share": off}

    def control_frames(self, dtype=torch.bfloat16) -> list:
        """The kept frames' seeds rendered by the reference in `dtype`: the
        control, put in the program's place."""
        frame = inputs.reference_frame(self.config, self.sky_table, dtype)
        scene = pt.make_scene(self.config["scene"], self.device, dtype)
        out = []
        for _, fs, _ in self.kept:
            with torch.no_grad():
                out.append((fs, pt.to_uint8(pt.render(scene, frame, fs, self.spp)).cpu()))
        return out

    def work(self) -> dict:
        """Bound of one K1 launch on these inputs, from the reference's
        counts of the compared frames."""
        scene = pt.make_scene(self.config["scene"], "cpu")
        ph = self.config["physics"]
        ns = ph["shadow_samples"] if scene.light >= 0 else 0
        emitters = int((scene.fields["emission_power"] > 0).sum())
        # one emitter: the port's shadow trace is the occlusion test
        light_sph = scene.is_sphere[scene.light] if ns and emitters == 1 else None
        k1 = roofline.forward(self.work_stats, self.w * self.h, scene.n, sum(scene.is_sphere),
                              ph["bounces"], ns, light_sph, record=False)
        return {"k1": k1}
