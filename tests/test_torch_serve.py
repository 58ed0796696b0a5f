"""The port's HTTP render service (apps/serve.py), driven over a socket on
the CPU at 32x24. Mirrors tests/test_serve.py; every wait has its own
deadline, and the service is shut down (running cleared, the render thread
joined, the server stopped) after each use."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from ray_tracing_tpu_torch.apps.cli import FULL_RES_SPP
from ray_tracing_tpu_torch.apps.serve import RenderService, make_handler, resolve_u8
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.io.image import to_uint8
from ray_tracing_tpu_torch.ops.cubemap import constant_sky
from ray_tracing_tpu_torch.ops.vec import Vec3
from ray_tracing_tpu_torch.render.film import Film
from ray_tracing_tpu_torch.scene.types import ObjectSpec, Scene
from ray_tracing_tpu_torch.utils.profiling import rays_per_frame

CFG = RenderConfig(bounces=2, shadow_samples=1, init_scale=4)
HEALTH_KEYS = {"status", "passes", "film_weight", "rays_per_second", "uptime_s", "device",
               "resolution", "event_to_frame_ms"}


def sphere_scene(x=3.0):
    return Scene.from_objects([ObjectSpec(kind="sphere", p0=(x, 3.0, 3.0), p1=(1.0,) * 3)],
                              device="cpu")


def sky(color=(0.4, 0.5, 0.6)):
    return constant_sky(color, device="cpu")


def wait_for(cond, seconds=60.0, step=0.05):
    end = time.time() + seconds
    while time.time() < end:
        if cond():
            return True
        time.sleep(step)
    return cond()


def shut_down(svc, thread, httpd=None):
    svc.running = False
    thread.join(timeout=60)
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
    assert not thread.is_alive(), "the render thread did not stop"


@pytest.fixture(scope="module")
def server():
    svc = RenderService(sphere_scene(), 32, 24, CFG, sky(), device="cpu")
    thread = threading.Thread(target=svc.run, daemon=True)
    thread.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert wait_for(lambda: svc.passes_done > 0, 120), "no pass in 120 s"
        yield base, svc
    finally:
        shut_down(svc, thread, httpd)
        http_thread.join(timeout=30)


def get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def post(url, body, timeout=30):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status


def test_healthz(server):
    base, _ = server
    status, _, body = get(base + "/healthz")
    h = json.loads(body)
    assert status == 200 and set(h) == HEALTH_KEYS
    assert h["status"] == "ok" and h["passes"] >= 1 and h["film_weight"] > 0
    assert h["device"] == "cpu" and h["resolution"] == [32, 24]


def test_frame_png(server):
    from PIL import Image

    base, svc = server
    status, headers, body = get(base + "/frame.png")
    assert status == 200 and headers["Content-Type"] == "image/png"
    with Image.open(io.BytesIO(body)) as im:
        assert im.size == (32, 24)
        arr = np.asarray(im.convert("RGB"))
    assert arr.mean() > 1  # content, not black


def test_index_page_and_404(server):
    base, _ = server
    status, _, body = get(base + "/")
    assert status == 200 and b"/stream" in body
    with pytest.raises(urllib.error.HTTPError) as e:
        get(base + "/nope")
    assert e.value.code == 404


def test_key_event_invalidates(server):
    base, svc = server
    pos_before = svc.camera.pos.clone()
    assert post(base + "/key", b"w") == 200
    assert wait_for(lambda: not torch.equal(svc.camera.pos, pos_before))
    assert wait_for(lambda: json.loads(get(base + "/healthz")[2])["event_to_frame_ms"]
                    is not None)
    lat = json.loads(get(base + "/healthz")[2])["event_to_frame_ms"]
    assert 0.0 < lat < 120_000.0


def test_mouse_look_endpoint(server):
    """POST /look carries raw pointer deltas: dx=30 -> yaw +3, dy=-10 (up)
    -> pitch +1."""
    base, svc = server
    yaw0, pitch0 = float(svc.camera.yaw), float(svc.camera.pitch)
    assert post(base + "/look", b"30 -10") == 200
    assert wait_for(lambda: float(svc.camera.yaw) != yaw0)
    assert float(svc.camera.yaw) == pytest.approx(yaw0 + 3.0)
    assert float(svc.camera.pitch) == pytest.approx(pitch0 + 1.0)


def test_published_frame_is_the_truncated_film():
    """The display frame is the film resolved, clipped and truncated
    (to_uint8), not rounded half up as the JAX service does; /frame.png is
    it flipped."""
    from PIL import Image

    a = np.full((3, 2, 2), 254.9 / 255, np.float32)
    a[:, 1, 1] = 0.5
    film = Film(accum=Vec3(*map(torch.from_numpy, a * 2)), weight=torch.tensor(2.0))
    u8 = resolve_u8(film).numpy()
    np.testing.assert_array_equal(u8, to_uint8(film.resolve()))
    assert u8[0, 0, 0] == 254  # half up would give 255

    svc = RenderService(sphere_scene(), 32, 24, CFG, sky(), device="cpu")
    for _ in range(3):
        svc.step()
    np.testing.assert_array_equal(svc.frame, to_uint8(svc.film.resolve()))
    with Image.open(io.BytesIO(svc.snapshot_png())) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), svc.frame[::-1])
    assert svc.stats()["film_weight"] == float(svc.film.weight)


def test_only_invalidating_events_start_the_latency():
    svc = RenderService(sphere_scene(), 32, 24, CFG, sky(), device="cpu")
    assert svc.post("x") and svc.post("space")  # change nothing
    svc.step()
    assert svc.event_to_frame_ms is None and len(svc.latencies_ms) == 0
    assert svc.post("d")
    svc.step()
    assert svc.event_to_frame_ms is not None and len(svc.latencies_ms) == 1
    svc.step()
    assert len(svc.latencies_ms) == 1


def test_rays_counted_at_each_pass_spp():
    svc = RenderService(sphere_scene(), 32, 24, CFG, sky(), device="cpu")
    for _ in range(4):
        svc.step()
    assert [r for _, r in svc.meter.samples] == [
        rays_per_frame(8, 6, 1, CFG), rays_per_frame(16, 12, 1, CFG),
        rays_per_frame(32, 24, FULL_RES_SPP, CFG), rays_per_frame(32, 24, FULL_RES_SPP, CFG)]


def test_pass_hands_render_fn_the_pyramid_scale_and_pass_seed():
    """Each pass calls render_fn(scene, camera, film, seed, scale) with the
    pyramid's scale, the seed pass_seed(seed, passes done) and the film of
    the last pass; a camera event restarts the pyramid on a fresh film."""
    from ray_tracing_tpu_torch.render.film import pass_seed

    svc = RenderService(sphere_scene(), 32, 24, RenderConfig(bounces=2, shadow_samples=1,
                                                             init_scale=2), sky(),
                        device="cpu")
    real, seen = svc.render_fn, []

    def spy(scene, camera, film, seed, scale):
        seen.append((scale, seed, float(film.weight)))
        return real(scene, camera, film, seed, scale)

    svc.render_fn = spy
    for _ in range(3):
        svc.step()
    assert seen == [(2, pass_seed(svc.seed, 0), 0.0), (1, pass_seed(svc.seed, 1), 1 / 4),
                    (1, pass_seed(svc.seed, 2), 1 / 4 + FULL_RES_SPP)]
    svc.post("a")
    svc.step()
    assert seen[-1] == (2, pass_seed(svc.seed, 3), 0.0)


def test_film_checkpoint_resume(tmp_path):
    """A restarted service resumes the film AND the camera pose it was
    accumulated at; another resolution, scene, physics or sky starts
    fresh."""
    cfg = RenderConfig(bounces=1, shadow_samples=1, init_scale=2)
    ck = str(tmp_path / "film")
    svc = RenderService(sphere_scene(), 24, 16, cfg, sky(), device="cpu",
                        film_checkpoint=ck, film_checkpoint_every=4)
    thread = threading.Thread(target=svc.run, daemon=True)
    thread.start()
    try:
        assert wait_for(lambda: svc.passes_done >= 5, 120)
        svc.post("d")  # a move: pose and film change before the next save
        assert wait_for(lambda: svc.passes_done >= 12, 120)
    finally:
        shut_down(svc, thread)
    svc._save_film_state()

    again = RenderService(sphere_scene(), 24, 16, cfg, sky(), device="cpu",
                          film_checkpoint=ck)
    assert again.film.weight.equal(svc.film.weight)
    assert again.film.resolve().equal(svc.film.resolve())
    for f in ("pos", "front", "up", "yaw", "pitch"):
        assert getattr(again.camera, f).equal(getattr(svc.camera, f))
    assert again.passes_done == svc.passes_done and again.pass_i == len(again.scales)
    assert again.stats()["film_weight"] == float(svc.film.weight)

    for other in (
        RenderService(sphere_scene(), 32, 24, cfg, sky(), device="cpu", film_checkpoint=ck),
        RenderService(sphere_scene(-3.0), 24, 16, cfg, sky(), device="cpu",
                      film_checkpoint=ck),
        RenderService(sphere_scene(), 24, 16, RenderConfig(bounces=2, shadow_samples=1,
                                                           init_scale=2),
                      sky(), device="cpu", film_checkpoint=ck),
        RenderService(sphere_scene(), 24, 16, cfg, sky((0.9, 0.1, 0.1)), device="cpu",
                      film_checkpoint=ck),
    ):
        assert float(other.film.weight) == 0.0 and other.passes_done == 0
