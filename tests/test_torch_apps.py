"""The port's command line and terminal viewer (apps/cli.py, apps/viewer.py)
against the JAX package's. Mirrors tests/test_apps.py: the flags, the
viewer's pyramid, invalidation, resize, screenshots and mouse look, the
ANSI frame and the keyboard parser (both exactly against JAX), the pass
policy of the render function, and the whole viewer under a
pseudo-terminal through `python -m ray_tracing_tpu_torch --interactive`
on the CPU, with its own deadlines."""

import io
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tracing_tpu.apps import viewer as jviewer

from ray_tracing_tpu_torch import native
from ray_tracing_tpu_torch.apps.cli import (
    FULL_RES_SPP,
    build_parser,
    main as cli_main,
    make_cuda_render_fn,
)
from ray_tracing_tpu_torch.apps.viewer import (
    EV_LOOK,
    EV_MOUSE,
    EV_QUIT,
    EV_SHOT,
    EV_W,
    NativeEventSource,
    TerminalInput,
    Viewer,
    frame_to_ansi,
)
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.io.image import png_size, read_png
from ray_tracing_tpu_torch.ops.cubemap import constant_sky
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.film import render_pass
from ray_tracing_tpu_torch.scene.types import ObjectSpec, Scene
from ray_tracing_tpu_torch.utils.profiling import rays_per_frame

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = RenderConfig(bounces=2, shadow_samples=1, init_scale=4)
SPHERE = "sphere\n\tcenter {3 3 3}\n\tradius 1\n"


def sky():
    return constant_sky((0.4, 0.5, 0.6), device="cpu")


def sphere_scene():
    return Scene.from_objects([ObjectSpec(kind="sphere", p0=(3.0, 3.0, 3.0), p1=(1.0,) * 3)],
                              device="cpu")


def make_viewer(cfg=CFG, **kw):
    return Viewer(sphere_scene(), Camera.default("cpu"), 32, 24, cfg,
                  make_cuda_render_fn(cfg, sky(), "cpu"), out=io.StringIO(), **kw)


def test_parser_reference_flags():
    p = build_parser()
    a = p.parse_args(["--scene", "s.txt", "--threads", "16", "--init-scale", "2",
                      "--passes", "3", "--assets", "sky_dir"])
    assert (a.scene, a.threads, a.init_scale, a.passes, a.assets) == ("s.txt", 16, 2, 3,
                                                                       "sky_dir")
    assert not a.interactive and a.output is None and a.device == "cuda"
    with pytest.raises(SystemExit):  # invalid init-scale, as the reference refuses it
        p.parse_args(["--scene", "s.txt", "--init-scale", "3"])
    with pytest.raises(SystemExit):  # missing --scene
        p.parse_args([])


def test_cli_bad_scene_returns_error(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("pyramid")
    assert cli_main(["--scene", str(bad), "--output", str(tmp_path / "x.png"),
                     "--device", "cpu"]) == 1


def test_cli_offline_render_with_skybox_assets(tmp_path, capsys):
    """--assets loads the six faces (load_cubemap); a directory without them
    says so and takes the checkerboard sky."""
    from PIL import Image

    from ray_tracing_tpu_torch.io.image import SKYBOX_FILES

    for face, rel in SKYBOX_FILES.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        Image.new("RGB", (4, 4), (30 * face, 200, 90)).save(tmp_path / rel)
    scn = tmp_path / "s.txt"
    scn.write_text(SPHERE)
    common = ["--scene", str(scn), "--width", "24", "--height", "16", "--spp", "1",
              "--device", "cpu", "--threads", "4"]
    assert cli_main(common + ["--assets", str(tmp_path), "--output",
                              str(tmp_path / "a.png")]) == 0
    assert png_size(tmp_path / "a.png") == (24, 16, 8, 2)
    assert cli_main(common + ["--assets", str(tmp_path / "none"), "--output",
                              str(tmp_path / "b.png")]) == 0
    assert "Couldn't load cubemap" in capsys.readouterr().err
    assert not np.array_equal(read_png(tmp_path / "a.png"), read_png(tmp_path / "b.png"))


def test_viewer_progressive_and_invalidation():
    v = make_viewer()
    # pyramid 4 -> 2 -> 1, then 1; full-res passes take FULL_RES_SPP samples
    assert [v.step(n) for n in range(4)] == [4, 2, 1, 1]
    assert float(v.film.weight) == 1 / 16 + 1 / 4 + 2 * FULL_RES_SPP
    pos_before = v.camera.pos.clone()
    assert v.handle_events([(EV_W, None)])
    assert float(v.film.weight) == 0.0
    assert v.step(4) == 4
    assert not torch.allclose(v.camera.pos, pos_before)
    yaw = float(v.camera.yaw)
    v.handle_events([(EV_LOOK, (60.0, 0.0))])
    assert float(v.camera.yaw) == pytest.approx(yaw + 6.0)  # 0.1 degree per pixel
    assert v.handle_events([(EV_QUIT, None)]) is False


def test_viewer_counts_rays_at_each_pass_spp():
    """The HUD's rays/s counts each pass at the samples it took: the JAX
    viewer counts one per pass, 4x low at full res (a reference-side
    fault the port does not inherit)."""
    v = make_viewer()
    for n in range(3):
        v.step(n)
    rays = [r for _, r in v.meter.samples]
    assert rays == [rays_per_frame(8, 6, 1, CFG), rays_per_frame(16, 12, 1, CFG),
                    rays_per_frame(32, 24, FULL_RES_SPP, CFG)]


def test_viewer_hands_render_fn_each_pass_and_keeps_its_film():
    """render_fn(scene, camera, film, seed, scale) -> (film, spp): each pass
    gets the seed it was stepped with, the pyramid's scale and the film the
    last pass returned; invalidation and resize restart the pyramid on a
    fresh film of the frame's size."""
    seen = []

    def render_fn(scene, camera, film, seed, scale):
        seen.append((seed, scale, float(film.weight), film.width))
        film = render_pass(scene, camera, film, seed, scale, CFG, sky(), device="cpu")
        return film, 1

    v = Viewer(sphere_scene(), Camera.default("cpu"), 32, 24, CFG, render_fn,
               out=io.StringIO())
    v.step(10)
    v.step(11)
    assert seen == [(10, 4, 0.0, 32), (11, 2, 1 / 16, 32)]
    v.invalidate()
    v.step(12)
    assert seen[-1] == (12, 4, 0.0, 32)
    v.resize(16, 8)
    v.step(13)
    assert seen[-1] == (13, 4, 0.0, 16) and v.film.width == 16


def test_cuda_render_fn_pass_policy(monkeypatch):
    """make_cuda_render_fn: pyramid passes take one sample, full-res passes
    FULL_RES_SPP; the film's device is the render function's."""
    from ray_tracing_tpu_torch.render import film as film_mod

    calls = []

    def fake(scene, camera, film, seed, scale, config, cubemap, spp=1, device=None):
        calls.append((scale, spp, str(device)))
        return render_pass(scene, camera, film, seed, scale, config, cubemap, spp=spp,
                           device=device)

    monkeypatch.setattr(film_mod, "render_pass_cuda", fake)
    cfg = RenderConfig(bounces=2, shadow_samples=1, init_scale=2)
    v = Viewer(sphere_scene(), Camera.default("cpu"), 32, 24, cfg,
               make_cuda_render_fn(cfg, sky(), "cpu"), out=io.StringIO())
    for n in range(3):
        v.step(n)
    assert calls == [(2, 1, "cpu"), (1, FULL_RES_SPP, "cpu"), (1, FULL_RES_SPP, "cpu")]
    assert float(v.film.weight) == 1 / 4 + 2 * FULL_RES_SPP


def test_viewer_resize():
    v = make_viewer()
    v.step(0)
    assert float(v.film.weight) > 0
    v.resize(48, 36)
    assert (v.width, v.height) == (48, 36) and float(v.film.weight) == 0.0 and v.pass_i == 0
    assert v.step(1) == 4
    assert v.film.accum.shape == (36, 48)
    v.resize(48, 36)  # the same size: nothing happens
    assert float(v.film.weight) > 0


def test_viewer_screenshot(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    v = make_viewer()
    v.step(0)
    v.handle_events([(EV_SHOT, None)])
    v.handle_events([(EV_SHOT, None)])  # the next free name (src/main.c:642-659)
    assert (tmp_path / "screenshot_0.png").exists() and (tmp_path / "screenshot_1.png").exists()
    assert png_size(tmp_path / "screenshot_0.png") == (32, 24, 8, 2)


def test_viewer_draws_frame_and_hud():
    v = make_viewer()
    v.draw()
    assert v.out.getvalue().count("▀") == 32 * 12
    v.step(0)
    v.draw()
    assert "pass 1  weight 0.06" in v.out.getvalue()


@pytest.mark.parametrize("shape", [(4, 3), (7, 5), (24, 32)])
def test_frame_to_ansi_equals_jax(shape):
    img = np.random.default_rng(sum(shape)).uniform(-0.1, 1.1, (*shape, 3)).astype(np.float32)
    got = frame_to_ansi(img)
    assert got == jviewer.frame_to_ansi(img)
    assert got.count("▀") == shape[1] * (shape[0] // 2)


def test_frame_to_ansi_cells():
    img = np.zeros((4, 3, 3), np.float32)
    img[0, 0] = [1, 0, 0]
    s = frame_to_ansi(img)
    assert s.count("▀") == 6 and "\x1b[38;2;255;0;0m" in s


class _FakeStdin:
    def __init__(self, fd):
        self._fd = fd

    def fileno(self):
        return self._fd


@pytest.mark.parametrize("chunks", [
    [b"\x1b[<35;20;10M\x1b[<35;25;12Mw\x1b[<0;5;5M"],
    [bytes([0x1B, ord("["), ord("M"), 32 + 35, 32 + 81, 32 + 17]) + b"w"],
    [bytes([0x1B, ord("["), ord("M"), 32 + 35, 32 + 100, 32 + 130]) + b"w"],
    [bytes([0x1B, ord("["), ord("M"), 32 + 35]), bytes([32 + 5, 32 + 6])],
    [b"\x1b[A\x1b[B\x1b[C\x1b[DijklWaSd \x1bOP\x1b[15~x"],
    [b"\x1b", b"[A", b"w"],
    [b"\x1b", b"", b""],
    [b"\x1bxq"],
], ids=["sgr", "x10", "x10_high", "x10_split", "keys", "split_csi", "lone_esc", "esc_key"])
def test_terminal_input_equals_jax_poll_events(monkeypatch, chunks):
    """Exact: the same byte streams, read in the same pieces, give the same
    events as the JAX package's poll_events."""
    r1, w1 = os.pipe()
    r2, w2 = os.pipe()
    try:
        monkeypatch.setattr(jviewer.sys, "stdin", _FakeStdin(r2))
        monkeypatch.setattr(jviewer, "_pending", "")
        monkeypatch.setattr(jviewer, "_pending_age", 0)
        ours = TerminalInput(r1)
        got, want = [], []
        for chunk in chunks:
            if chunk:
                os.write(w1, chunk)
                os.write(w2, chunk)
            got.append(ours.poll(timeout=0.2 if chunk else 0.0))
            want.append(jviewer.poll_events(timeout=0.2 if chunk else 0.0))
    finally:
        for fd in (r1, w1, r2, w2):
            os.close(fd)
    assert got == want
    assert any(got)


def test_native_event_source_maps_the_queue():
    lib = native.lib()
    if lib is None:
        pytest.skip("no C++ compiler available")
    lib.rt_events_stop()
    data = b"w \x1b[<35;7;9Mq\x1b[C"
    lib.rt_events_parse(data, len(data))
    src = NativeEventSource.__new__(NativeEventSource)
    src.lib = lib
    assert src.poll() == [(EV_W, None), (EV_SHOT, None), (EV_MOUSE, (7.0, 9.0)),
                          (EV_QUIT, None), (EV_LOOK, (60.0, 0))]
    assert src.poll() == []


def test_viewer_mouse_look_events():
    """Absolute positions drive mouse look with the reference's first-move
    skip, y inversion and 0.1 degree per pixel (src/camera.c:42-78)."""
    import math

    v = make_viewer(RenderConfig(bounces=1, shadow_samples=1))
    v._cell_px = (1.0, 1.0)  # raw deltas; the cell scaling is tested below
    yaw0, pitch0 = float(v.camera.yaw), float(v.camera.pitch)
    assert v.handle_events([(EV_MOUSE, (100.0, 50.0))])
    assert float(v.camera.yaw) == yaw0 and float(v.camera.pitch) == pitch0
    assert v.handle_events([(EV_MOUSE, (130.0, 60.0))])
    assert float(v.camera.yaw) == pytest.approx(yaw0 + 3.0)
    assert float(v.camera.pitch) == pytest.approx(pitch0 - 1.0)
    yr, pr = math.radians(yaw0 + 3.0), math.radians(pitch0 - 1.0)
    np.testing.assert_allclose(
        v.camera.front.numpy(),
        [math.cos(yr) * math.cos(pr), math.sin(pr), math.sin(yr) * math.cos(pr)], atol=1e-6)


def test_viewer_mouse_look_cell_to_pixel_scaling():
    v = make_viewer(RenderConfig(bounces=1, shadow_samples=1))
    v._cell_px = (10.0, 20.0)
    yaw0, pitch0 = float(v.camera.yaw), float(v.camera.pitch)
    assert v.handle_events([(EV_MOUSE, (40.0, 12.0))])
    assert v.handle_events([(EV_MOUSE, (43.0, 13.0))])  # +30 px right, +20 px down
    assert float(v.camera.yaw) == pytest.approx(yaw0 + 3.0)
    assert float(v.camera.pitch) == pytest.approx(pitch0 - 2.0)
    v.resize(20, 10)
    assert v._cell_px is None
    assert v._cell_pixels() == (10.0, 20.0)  # not a terminal: the typical cell


def drive_pty(args, cwd, size=(14, 32), keys=(b"w", b" ", b"q"), deadline_s=240.0):
    """Run `python -m ray_tracing_tpu_torch ARGS` on a pseudo-terminal of
    `size` (rows, cols); after the first painted frame send each key once
    the previous one has shown its effect. Returns (returncode, stdout
    bytes, stderr text)."""
    import fcntl
    import pty
    import select
    import struct
    import termios

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", size[0], size[1], 0, 0))
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    err_path = pathlib.Path(cwd) / "stderr.txt"
    with open(err_path, "wb") as err:
        proc = subprocess.Popen([sys.executable, "-m", "ray_tracing_tpu_torch", *args],
                                stdin=slave, stdout=slave, stderr=err, cwd=cwd, env=env)
    os.close(slave)
    out = b""
    end = time.time() + deadline_s
    pending = list(keys)
    try:
        while time.time() < end and proc.poll() is None:
            if select.select([master], [], [], 0.2)[0]:
                try:
                    out += os.read(master, 1 << 16)
                except OSError:
                    break
            if pending and out.count(b"\x1b[H") >= 2 + 2 * (len(keys) - len(pending)):
                key = pending.pop(0)
                os.write(master, key)
                if key == b" ":  # wait for the screenshot before quitting
                    while time.time() < end and b"Took screenshot" not in err_path.read_bytes():
                        if select.select([master], [], [], 0.2)[0]:
                            out += os.read(master, 1 << 16)
        rc = proc.wait(timeout=max(end - time.time(), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        os.close(master)
    return rc, out, err_path.read_text(errors="replace")


def test_interactive_cli_under_a_pty(tmp_path):
    """The whole viewer on the CPU at 32x24: paints 24-bit half-block
    cells, moves on w, writes a screenshot on space, exits 0 on q."""
    scn = tmp_path / "s.txt"
    scn.write_text(SPHERE)
    rc, out, err = drive_pty(["--scene", str(scn), "--interactive", "--device", "cpu",
                              "--width", "32", "--height", "24", "--init-scale", "4"],
                             cwd=tmp_path)
    assert rc == 0, err[-2000:]
    assert b"\x1b[38;2;" in out and "▀".encode() in out
    assert "Took screenshot" in err
    assert png_size(tmp_path / "screenshot_0.png") == (32, 24, 8, 2)


# ---------------------------------------------------------------------------
# The fit and fly-through apps (apps/invert.py, apps/flythrough.py,
# apps/pose_recovery.py) with --device cpu at tiny sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [0.0, 0.7, 2.5, 6.0])
def test_orbit_camera_equals_jax(t):
    from ray_tracing_tpu.apps.flythrough import orbit_camera as j_orbit_camera
    from ray_tracing_tpu.render.camera import Camera as JCamera

    from ray_tracing_tpu_torch.apps.flythrough import orbit_camera

    want = j_orbit_camera(JCamera.default(), t, radius=6.0, height=3.0, look_at=(0.5, 1.0, -1.0))
    got = orbit_camera(Camera.default("cpu"), t, radius=6.0, height=3.0, look_at=(0.5, 1.0, -1.0))
    for name in ("pos", "front", "up"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("sharded", [[], ["--sharded", "--mesh", "2x2"]], ids=["one", "sharded"])
def test_flythrough_app_runs_on_the_cpu(tmp_path, capsys, sharded):
    from ray_tracing_tpu_torch.apps import flythrough

    scn = tmp_path / "s.txt"
    scn.write_text(SPHERE)
    out = tmp_path / "fly"
    assert flythrough.main(["--scene", str(scn), "--frames", "3", "--width", "16", "--height",
                            "8", "--spp", "2", "--out-dir", str(out), "--device", "cpu",
                            *sharded]) == 0
    assert sorted(p.name for p in out.iterdir()) == [f"frame_{i:04d}.png" for i in range(3)]
    assert png_size(out / "frame_0002.png") == (16, 8, 8, 2)
    err = capsys.readouterr().err
    assert "frame 3/3" in err and "rays/s" in err
    assert ("mesh={'tile': 2, 'sample': 2}" in err) == bool(sharded)


def test_flythrough_sharded_frames_equal_the_one_device_frames(tmp_path):
    from ray_tracing_tpu_torch.apps import flythrough

    scn = tmp_path / "s.txt"
    scn.write_text(SPHERE)
    common = ["--scene", str(scn), "--frames", "2", "--width", "16", "--height", "8",
              "--spp", "2", "--device", "cpu", "--assets", str(tmp_path / "none")]
    assert flythrough.main(common + ["--out-dir", str(tmp_path / "a")]) == 0
    assert flythrough.main(common + ["--out-dir", str(tmp_path / "b"), "--sharded",
                                     "--mesh", "4x2"]) == 0
    for i in range(2):
        a = read_png(tmp_path / "a" / f"frame_{i:04d}.png").astype(int)
        b = read_png(tmp_path / "b" / f"frame_{i:04d}.png").astype(int)
        assert np.abs(a - b).max() <= 1  # float rounding may move a truncated byte


def test_invert_multiscale_app_runs_on_the_cpu(tmp_path, capsys):
    from ray_tracing_tpu_torch.apps import invert

    scn = tmp_path / "s.txt"
    scn.write_text(SPHERE)
    assert invert.main(["--scene", str(scn), "--fields", "albedo", "--steps", "6",
                        "--width", "32", "--height", "17", "--spp", "2", "--multiscale",
                        "--mesh", "2x2", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "mesh={'tile': 2, 'sample': 2}" in err and "loss: " in err
    assert "albedo: |err| " in err
    with pytest.raises(SystemExit):  # the JAX app ignores the pair; this one refuses it
        invert.main(["--scene", str(scn), "--multiscale", "--checkpoint-dir", str(tmp_path)])


def test_invert_checkpoint_dir_resumes(tmp_path, capsys):
    from ray_tracing_tpu_torch.apps import invert
    from ray_tracing_tpu_torch.diff.checkpoint import latest_step

    scn = tmp_path / "s.txt"
    scn.write_text(SPHERE)
    d = tmp_path / "ck"
    common = ["--scene", str(scn), "--fields", "albedo", "--width", "16", "--height", "8",
              "--spp", "1", "--checkpoint-dir", str(d), "--device", "cpu"]
    assert invert.main(common + ["--steps", "3"]) == 0
    assert latest_step(str(d)) == 3
    first = capsys.readouterr().err
    assert "step     0" in first
    assert invert.main(common + ["--steps", "5"]) == 0
    assert latest_step(str(d)) == 5
    resumed = capsys.readouterr().err
    assert "step     4" in resumed and "step     0" not in resumed  # steps 3-4 only


def test_pose_recovery_app_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    """Against a target the port renders from a known pose and writes
    flipped, as the reference's screenshots are; the search at a reduced
    size (its own tests run it at the JAX tests' sizes)."""
    import dataclasses
    import functools

    from ray_tracing_tpu_torch.apps import pose_recovery
    from ray_tracing_tpu_torch.diff import inverse
    from ray_tracing_tpu_torch.io.image import save_png
    from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda
    from ray_tracing_tpu_torch.scene.parser import parse_scene_string
    from ray_tracing_tpu_torch.scene.synthetic import POSE_SEARCH_TEXT

    scn = tmp_path / "pose.txt"
    scn.write_text(POSE_SEARCH_TEXT)
    scene = parse_scene_string(POSE_SEARCH_TEXT, device="cpu")
    true = dataclasses.replace(Camera.default("cpu"), pos=torch.tensor([1.5, 1.2, 4.0]),
                               front=torch.tensor([-0.3, -0.25, -1.0]))
    cfg = RenderConfig(env_filter="bilinear", bounces=3, shadow_samples=1)
    from ray_tracing_tpu_torch.ops.cubemap import checker_sky

    target = render_image_cuda(scene, true, 16, 12, 1, spp=4, config=cfg,
                               cubemap=checker_sky(2048, device="cpu"), device="cpu")
    save_png(target, tmp_path / "target.png")
    monkeypatch.setattr(inverse, "coarse_pose_search",
                        functools.partial(inverse.coarse_pose_search, n_pos=2, width=8,
                                          height=6, aa=1, spp=1))
    assert pose_recovery.main(["--scene", str(scn), "--target", str(tmp_path / "target.png"),
                               "--width", "16", "--height", "12", "--spp", "1", "--steps", "2",
                               "--refine-steps", "1", "--init-pos", "1.3,1.0,4.4",
                               "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "coarse search: top MSEs" in err and err.count("refine loss") == 4
    assert "fine-tune loss -> " in err and "pos: [" in err and "front: [" in err
    assert "search " in err and " s, refinement " in err
    assert "correlation vs target: " in err and " -> " in err.split("correlation vs target: ")[1]
