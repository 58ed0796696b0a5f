"""HTTP render service: remote interactive viewing.

    GET  /            a small HTML viewer (a PNG stream and key capture)
    GET  /stream      multipart/x-mixed-replace stream of the live film as PNGs
    GET  /frame.png   the current frame as a PNG
    GET  /healthz     JSON health and stats (passes, weight, rays/s, device)
    POST /key         body: one of w,a,s,d,i,j,k,l,space,r,reset: the
                      reference's event loop over HTTP
    POST /look        body: "<dx> <dy>", raw pointer deltas (mouse look)

    python -m ray_tracing_tpu_torch.apps.serve --scene scene.txt \\
        --port 8400 --width 320 --height 240 [--device cpu]

Counterpart of ``ray_tracing_tpu/apps/serve.py``. One render thread owns
the device, as the reference's worker pool owned the frame
(src/main.c:324-414): it drains the event queue, runs one progressive pass
(apps/cli.py::make_cuda_render_fn, K1 on the card), quantises the resolved
film to uint8 on the device and publishes it. HTTP threads only read the
published frame under a lock and queue events. Two things differ from the
JAX service on purpose: the frame is quantised by truncation, as the
reference and save_png do (JAX rounds half up), and an event's arrival is
stamped for the event-to-frame latency only when it invalidates the film,
at the moment it is queued.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ray_tracing_tpu_torch.apps.cli import make_cuda_render_fn
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.diff.checkpoint import (
    film_from_state,
    film_state,
    restore_checkpoint,
    save_checkpoint,
)
from ray_tracing_tpu_torch.io.image import encode_png
from ray_tracing_tpu_torch.render import camera as cam_mod
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.film import Film, lowres_size, pass_seed, progressive_scales
from ray_tracing_tpu_torch.utils.profiling import RateMeter, rays_per_frame

_PAGE = """<!doctype html><title>ray_tracing_tpu_torch</title>
<body style="background:#111;color:#eee;font-family:monospace">
<h3>ray_tracing_tpu_torch: live render (WASD move, click the image for mouse
look, IJKL look, R reset, ESC releases the pointer)</h3>
<img id=v src=/stream style="image-rendering:pixelated;width:640px">
<div id=s></div>
<script>
document.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if ('wasdijkl r'.includes(k)) fetch('/key', {method:'POST', body:k});
});
// mouse look: raw pointer deltas, the reference's MOVE_MOUSE stream
// (src/gpu_and_windowing.c:266-269), sent in batches of one tick
const img = document.getElementById('v');
img.onclick = () => img.requestPointerLock();
let ax = 0, ay = 0;
document.addEventListener('mousemove', e => {
  if (document.pointerLockElement === img) { ax += e.movementX; ay += e.movementY; }
});
setInterval(() => {
  if (ax || ay) { fetch('/look', {method:'POST', body: ax + ' ' + ay}); ax = 0; ay = 0; }
}, 50);
setInterval(async () => {
  const h = await (await fetch('/healthz')).json();
  document.getElementById('s').textContent = JSON.stringify(h);
}, 1000);
</script>"""

_MOVES = {"w": cam_mod.UP, "s": cam_mod.DOWN, "a": cam_mod.LEFT, "d": cam_mod.RIGHT}
_LOOKS = {"i": (0, 60.0), "k": (0, -60.0), "j": (-60.0, 0), "l": (60.0, 0)}
_CAMERA_FIELDS = ("pos", "front", "up", "yaw", "pitch")


def resolve_u8(film: Film) -> torch.Tensor:
    """The display frame on the film's device: the resolved film clipped
    to [0, 1], times 255, truncated to uint8 (io/image.py::to_uint8)."""
    return (torch.clamp(film.resolve(), 0.0, 1.0) * 255.0).to(torch.uint8)


class RenderService:
    """Progressive passes and event handling on one device, in the thread
    that calls run(). device=None means the card."""

    def __init__(self, scene, width, height, config, cubemap, device=None,
                 film_checkpoint: str | None = None, film_checkpoint_every: int = 64):
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.cubemap = cubemap.to(self.device)
        self.camera = Camera.default(self.device)
        self.width, self.height = width, height
        self.config = config
        self.render_fn = make_cuda_render_fn(config, self.cubemap, self.device)
        self.seed = int(time.time())  # pass n is seeded pass_seed(seed, n)
        self.film = Film.zero(width, height, device=self.device)
        self.scales = progressive_scales(config)
        self.pass_i = 0
        self.passes_done = 0
        self.meter = RateMeter()
        # (event, arrival) pairs; 512 slots like the reference's ring
        self.events: queue.Queue = queue.Queue(maxsize=512)
        # what HTTP threads read: the published frame and its film's
        # weight, under frame_lock
        self.frame_lock = threading.Lock()
        self.frame = np.zeros((height, width, 3), np.uint8)
        self.frame_weight = 0.0
        self.running = True
        # event -> frame latency: from the arrival of the first event that
        # invalidated the film to the publication of the first frame after
        self._lat_start = None
        self.event_to_frame_ms = None
        self.latencies_ms: collections.deque = collections.deque(maxlen=256)
        self.started = time.time()
        self.film_checkpoint = film_checkpoint
        self.film_checkpoint_every = film_checkpoint_every
        self._digest = None
        if film_checkpoint:
            self._restore_film_state()

    def post(self, ev: str) -> bool:
        """Queue an event from any thread with its arrival time; False when
        the queue is full (the reference drops it too)."""
        try:
            self.events.put_nowait((ev, time.perf_counter()))
            return True
        except queue.Full:
            return False

    def invalidate(self):
        self.film = Film.zero(self.width, self.height, device=self.device)
        self.pass_i = 0

    def handle(self, ev: str) -> bool:
        """Apply one event; True when it moved the camera (and so
        invalidated the film)."""
        if ev.startswith("look "):
            # "look <dx> <dy>", dy in screen-down pixels; rotate() wants
            # screen-up (the reference's last_y - y, src/camera.c:52)
            try:
                _, dxs, dys = ev.split()
                dx, dy = float(dxs), -float(dys)
            except ValueError:
                return False
            self.camera = cam_mod.rotate(self.camera, dx, dy, self.config)
        elif ev in _MOVES:
            self.camera = cam_mod.move(self.camera, _MOVES[ev], self.config.move_speed,
                                       self.config)
        elif ev in _LOOKS:
            self.camera = cam_mod.rotate(self.camera, *_LOOKS[ev], self.config)
        elif ev in ("r", "reset"):
            self.camera = Camera.default(self.device)
        else:
            return False
        self.invalidate()
        return True

    def _film_digest(self) -> int:
        """What the film accumulates: the scene's rows, the physics, the
        resolution and the sky. A checkpoint of another digest is never
        blended into this film. Computed once: all of it is fixed for the
        service's life."""
        if self._digest is None:
            h = hashlib.sha256()
            h.update(self.scene.packed_rows().detach().cpu().numpy().tobytes())
            h.update(repr(self.config).encode())
            h.update(np.asarray([self.width, self.height], np.int64).tobytes())
            cm = self.cubemap
            h.update(np.asarray([cm.h, cm.w], np.int64).tobytes())
            for leaf in (cm.packed, cm.r, cm.g, cm.b):
                if leaf is not None:
                    h.update(leaf.cpu().numpy().tobytes())
            self._digest = int(np.frombuffer(h.digest()[:8], dtype=np.int64)[0])
        return self._digest

    def _restore_film_state(self):
        """Resume a progressive render: the film and the camera pose it was
        accumulated at, together, when the digest matches and the
        resolution is this service's."""
        state = restore_checkpoint(self.film_checkpoint)
        if state is None:
            return
        if state.get("digest") != self._film_digest():
            print("Film checkpoint is for a different scene/config; starting fresh",
                  file=sys.stderr)
            return
        try:
            film = film_from_state(state, self.device)
            if (film.height, film.width) != (self.height, self.width):
                return  # resolution changed: start fresh
            camera = Camera(**{f: state["cam_" + f].to(device=self.device,
                                                        dtype=torch.float32)
                               for f in _CAMERA_FIELDS})
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            print(f"Film checkpoint unusable ({e}); starting fresh", file=sys.stderr)
            return
        self.film, self.camera = film, camera
        self.pass_i = len(self.scales)  # past the pyramid: full res
        self.passes_done = int(state.get("passes", 0))
        with self.frame_lock:
            self.frame_weight = float(film.weight)
        print(f"Resumed film at weight {self.frame_weight:.1f} "
              f"({self.passes_done} passes)", file=sys.stderr)

    def _save_film_state(self):
        save_checkpoint(
            self.film_checkpoint,
            {**film_state(self.film),
             **{"cam_" + f: getattr(self.camera, f) for f in _CAMERA_FIELDS},
             "passes": self.passes_done, "digest": self._film_digest()},
            step=0,  # one rolling slot: the latest state wins
        )

    def step(self) -> None:
        """Drain the events, run one pass, publish its frame."""
        while True:
            try:
                ev, arrival = self.events.get_nowait()
            except queue.Empty:
                break
            if self.handle(ev) and self._lat_start is None:
                self._lat_start = arrival
        scale = self.scales[min(self.pass_i, len(self.scales) - 1)]
        self.film, spp = self.render_fn(self.scene, self.camera, self.film,
                                        pass_seed(self.seed, self.passes_done), scale)
        frame = resolve_u8(self.film).cpu().numpy()  # the pass's one synchronisation
        weight = float(self.film.weight)
        with self.frame_lock:
            self.frame, self.frame_weight = frame, weight
        if self._lat_start is not None:
            ms = (time.perf_counter() - self._lat_start) * 1e3
            self.latencies_ms.append(ms)
            self.event_to_frame_ms = round(ms, 1)
            self._lat_start = None
        # each pass at the samples it took (the JAX service counts one)
        lw, lh = lowres_size(self.width, self.height, scale)
        self.meter.add(rays_per_frame(lw, lh, spp, self.config))
        self.pass_i += 1
        self.passes_done += 1
        if self.film_checkpoint and self.passes_done % self.film_checkpoint_every == 0:
            self._save_film_state()

    def run(self):
        """The render thread's loop, until `running` is cleared. Selects
        the service's card for this thread first."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while self.running:
            self.step()

    def snapshot_png(self) -> bytes:
        with self.frame_lock:
            # flipped to the display's row order (the reference's GL quad,
            # save_png's flip on write)
            arr = self.frame[::-1].copy()
        return encode_png(arr)

    def stats(self) -> dict:
        with self.frame_lock:
            weight = self.frame_weight
        return {
            "status": "ok",
            "passes": self.passes_done,
            "film_weight": weight,
            "rays_per_second": self.meter.rays_per_second,
            "uptime_s": round(time.time() - self.started, 1),
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "resolution": [self.width, self.height],
            "event_to_frame_ms": self.event_to_frame_ms,
        }


def make_handler(svc: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif self.path == "/frame.png":
                self._send(200, "image/png", svc.snapshot_png())
            elif self.path == "/healthz":
                self._send(200, "application/json", json.dumps(svc.stats()).encode())
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while svc.running:
                        png = svc.snapshot_png()
                        self.wfile.write(b"--frame\r\nContent-Type: image/png\r\n")
                        self.wfile.write(f"Content-Length: {len(png)}\r\n\r\n".encode())
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                        time.sleep(0.1)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path in ("/key", "/look"):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode(errors="ignore").strip().lower()
                ok = svc.post(f"look {body}" if self.path == "/look" else body)
                self.send_response(200 if ok else 429)
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                self.send_error(404)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytrace-serve-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True)
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--init-scale", type=int, default=8, choices=[1, 2, 4, 8, 16])
    p.add_argument("--no-skybox", action="store_true")
    p.add_argument("--assets", default=None,
                   help="skybox root (skybox/right.jpg, ...); default: a checkerboard sky")
    p.add_argument("--film-checkpoint", default=None,
                   help="directory: save and resume the accumulation state (film and "
                        "camera pose) across restarts")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the hand-written megakernel; cpu: plain PyTorch ops")
    args = p.parse_args(argv)

    from ray_tracing_tpu_torch.apps.cli import load_sky
    from ray_tracing_tpu_torch.config import RenderConfig
    from ray_tracing_tpu_torch.scene.parser import parse_scene_file

    device = resolve_device(None if args.device == "cuda" else args.device)
    scene = parse_scene_file(args.scene, device=device)
    config = RenderConfig(init_scale=args.init_scale)
    svc = RenderService(scene, args.width, args.height, config,
                        load_sky(args.no_skybox, args.assets, device), device,
                        film_checkpoint=args.film_checkpoint)
    render_thread = threading.Thread(target=svc.run, daemon=True)
    render_thread.start()

    server = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"Serving on http://{args.host}:{args.port}", file=sys.stderr)

    # SIGTERM takes Ctrl-C's path, so that the film since the last periodic
    # save is not lost
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        svc.running = False
        render_thread.join(timeout=30.0)  # let the pass in flight land
        server.server_close()
        if svc.film_checkpoint and not render_thread.is_alive():
            svc._save_film_state()
            print("Final film checkpoint saved", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
