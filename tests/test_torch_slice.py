"""The first slice of the PyTorch port as a whole: estimator -> sky lookup
-> compose against the same three steps of the JAX package, the converged
scene_2 golden, row-slice renders, the command line, and the rules every
entry point keeps (the card unless the caller says CPU; no JAX inside)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.kernels import megakernel as jmk
from ray_tracing_tpu.ops import cubemap as jcm
from ray_tracing_tpu.ops.vec import Vec3 as JVec3
from ray_tracing_tpu.render.camera import Camera as JCamera
from ray_tracing_tpu.render.integrator import render_image as j_render_image
from ray_tracing_tpu.scene.parser import parse_scene_string as j_parse

import ray_tracing_tpu_torch as rtt
from ray_tracing_tpu_torch.config import RenderConfig as TCfg
from ray_tracing_tpu_torch.io import image as timage
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.ops import cubemap as tcm
from ray_tracing_tpu_torch.render.camera import Camera as TCamera, camera_pack
from ray_tracing_tpu_torch.scene.parser import parse_objects, parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT

import torch_port_util as U

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens" / "c_oracle_scene_2_const_96x72.npy"
SHAPE = (16, 128)


TEXTS = {"scene_2": SCENE_2_TEXT, "room": ROOM_TEXT}


@pytest.mark.parametrize("scene_name,bounces,ns,bilinear", [
    ("scene_2", 6, 3, False), ("room", 3, 2, False), ("scene_2", 4, 0, True),
])
def test_physics_sky_compose_matches_jax(scene_name, bounces, ns, bilinear):
    """(a) injected draws -> tile_physics -> sample_cubemap on a seeded
    packed 64^2 cubemap -> compose. Tolerance as in test_torch_megakernel:
    >= 99.9 % of pixels within rtol=2e-3, atol=2e-4; a pixel outside it
    flipped a decision (here also: landed on a neighbouring texel)."""
    js, ts = U.scene_pair(parse_objects(TEXTS[scene_name]))
    filt = "bilinear" if bilinear else "nearest"
    jcfg = JCfg(bounces=bounces, shadow_samples=ns, env_filter=filt)
    tcfg = TCfg(bounces=bounces, shadow_samples=ns, env_filter=filt)
    faces = np.random.default_rng(4).integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    jsky, tsky = jcm.CubemapData.from_faces(faces), tcm.CubemapData.from_faces(faces, device="cpu")
    draws = U.FixedDraws(3, bounces, max(ns, 1), SHAPE)
    xs = np.broadcast_to(np.arange(SHAPE[1], dtype=np.float32), SHAPE)
    ys = np.broadcast_to(np.arange(SHAPE[0], dtype=np.float32)[:, None], SHAPE)
    u = (0.5 + 0.5 * (0.5 - xs / 127)).astype(np.float32)
    v = (0.5 + 0.3 * (0.5 - ys / 15)).astype(np.float32)

    jcam = jmk._camera_pack(JCamera.default(), 2.0, jcfg)
    t = dict(zip(tmk.PLANE_NAMES, jmk.tile_physics(
        js, jcam, jnp.asarray(u), jnp.asarray(v), draws.jax, jcfg, SHAPE)))
    sky = jcm.sample_cubemap(jsky, JVec3(t["sx"], t["sy"], t["sz"]), bilinear=bilinear)
    # the compose formula of the JAX package's render_image_pallas
    want = (JVec3(t["r"], t["g"], t["b"])
            + sky * JVec3(t["cr"], t["cg"], t["cb"]) * t["miss"]).clip(0.0, 1.0)
    want = U.vec_np(want)

    view = tmk.SceneView(ts.packed_rows(), ts.obj_type, ts.light_index, ts.emissive)
    planes = torch.stack(tmk.tile_physics(
        view, camera_pack(TCamera.default("cpu"), 2.0, tcfg), torch.from_numpy(u),
        torch.from_numpy(v), draws.torch, tcfg, SHAPE))
    got = U.vec_np(tmk.compose(planes, tsky, tcfg))

    ok = (np.abs(got - want) <= 2e-4 + 2e-3 * np.abs(want)).all(axis=0)
    print(f"{int((~ok).sum())} of {ok.size} pixels differ")
    assert ok.mean() >= 0.999
    assert got.min() >= 0.0 and got.max() <= 1.0 and 0.05 < got.mean() < 0.95


@pytest.fixture(scope="module")
def scene2_render():
    """(b) render_image(device="cpu") of scene_2, 96x72, constant sky, 64 spp."""
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    sky = tcm.constant_sky((0.6, 0.7, 0.9), device="cpu")
    img = rtt.render_image(scene, TCamera.default("cpu"), 96, 72, seed=7, spp=64,
                           cubemap=sky, device="cpu")
    assert img.shape == (72, 96, 3) and img.dtype == torch.float32
    return img.numpy()


def test_scene2_matches_c_oracle_golden(scene2_render):
    golden = np.load(GOLDEN)
    mae = np.abs(scene2_render - golden).mean()
    assert mae < 0.03, mae
    assert abs(scene2_render.mean() - golden.mean()) < 0.01


def test_scene2_matches_jax_render_image(scene2_render):
    want = np.asarray(j_render_image(
        j_parse(SCENE_2_TEXT), JCamera.default(), 96, 72, jax.random.key(7), spp=64,
        cubemap=jcm.constant_sky((0.6, 0.7, 0.9))))
    assert abs(scene2_render.mean() - want.mean()) < 0.01
    assert np.abs(scene2_render - want).mean() < 0.03


@pytest.mark.parametrize("scene_name,jitter", [("scene_2", False), ("room", True)])
def test_row_slice_equals_rows_of_full_frame(scene_name, jitter):
    """(c) bit for bit."""
    scene = parse_scene_string(TEXTS[scene_name], device="cpu")
    cfg = TCfg(bounces=3, shadow_samples=2, pixel_jitter=jitter)
    sky = tcm.checker_sky(64, device="cpu")
    kw = dict(seed=5, spp=2, config=cfg, cubemap=sky, device="cpu")
    full = rtt.render_image(scene, TCamera.default("cpu"), 64, 48, **kw)
    part = rtt.render_image(scene, TCamera.default("cpu"), 64, 16, row0=24, norm_height=48, **kw)
    assert part.equal(full[24:40])
    # and through the entry point that takes the CUDA path on a card
    part2 = rtt.render_image_cuda(scene, TCamera.default("cpu"), 64, 16, row0=24,
                                  norm_height=48, **kw)
    assert part2.equal(part)
    one = rtt.render_image(scene, TCamera.default("cpu"), 64, 48, seed=5, spp=1, config=cfg,
                           cubemap=sky, device="cpu")
    assert not one.equal(full) and float(one.min()) >= 0 and float(one.max()) <= 1


def test_cli_writes_png_on_cpu(tmp_path):
    """(d)"""
    from ray_tracing_tpu_torch.apps.cli import main

    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_2_TEXT)
    out = tmp_path / "out.png"
    rc = main(["--scene", str(scene_file), "--width", "40", "--height", "30", "--spp", "2",
               "--seed", "3", "--output", str(out), "--no-skybox",
               "--device", "cpu"])
    assert rc == 0
    assert timage.png_size(out) == (40, 30, 8, 2)
    got = timage.read_png(out)
    want = rtt.render_image(parse_scene_string(SCENE_2_TEXT, device="cpu"),
                            TCamera.default("cpu"), 40, 30, seed=3, spp=2, cubemap=tcm.constant_sky((0.6, 0.7, 0.9), device="cpu"),
                            device="cpu")
    np.testing.assert_array_equal(got, timage.to_uint8(want)[::-1])  # flipped on save
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), got)


def test_cli_reports_parse_error_line(tmp_path, capsys):
    from ray_tracing_tpu_torch.apps.cli import main

    scene_file = tmp_path / "bad.txt"
    scene_file.write_text("sphere\n\n  radius oops\n")
    rc = main(["--scene", str(scene_file), "--output", str(tmp_path / "x.png"),
               "--device", "cpu"])
    assert rc != 0 and not (tmp_path / "x.png").exists()
    assert "(line 3)" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # a scale the reference refuses is refused
        main(["--scene", str(scene_file), "--init-scale", "3"])


def test_cli_device_alone_selects_the_renderer(tmp_path):
    """--device cpu is all a card-less user passes; a renderer switch of its
    own is refused."""
    from ray_tracing_tpu_torch.apps.cli import main

    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_2_TEXT)
    rc = main(["--scene", str(scene_file), "--output", str(tmp_path / "x.png"), "--width", "8",
               "--height", "6", "--spp", "1", "--device", "cpu"])  # checkerboard sky
    assert rc == 0 and timage.png_size(tmp_path / "x.png") == (8, 6, 8, 2)
    with pytest.raises(SystemExit):
        main(["--scene", str(scene_file), "--device", "cpu", "--kernel", "torch"])


def test_to_uint8_truncates():
    a = np.array([[[0.0, 0.999, 1.0], [0.5, 254.9 / 255, 0.00392]]], np.float32)
    np.testing.assert_array_equal(
        timage.to_uint8(a), (a * 255.0).astype(np.uint8))
    assert timage.to_uint8(torch.tensor(a))[0, 0, 1] == 254


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


def test_entry_points_raise_without_device_argument(no_card, tmp_path):
    """(e) device=None means the card: nothing renders on the CPU unasked."""
    from ray_tracing_tpu_torch.apps.cli import main

    from ray_tracing_tpu_torch import compat
    from ray_tracing_tpu_torch.render.camera import pixel_grid
    from ray_tracing_tpu_torch.scene.types import Scene

    leaves = {k: np.zeros((1, 3) if k in ("p0", "p1", "albedo", "emission_color") else (1,),
                          np.float32) for k in U.SCENE_LEAVES}
    for make in (
        lambda: parse_scene_string(SCENE_2_TEXT),
        lambda: Scene.from_objects(parse_objects(SCENE_2_TEXT)),
        TCamera.default,
        lambda: tcm.constant_sky((0.1, 0.2, 0.3)),
        lambda: tcm.checker_sky(8),
        lambda: tcm.gradient_sky(8),
        lambda: pixel_grid(8, 8),
        lambda: compat.scene_from_numpy(leaves, (1,), -1),
        lambda: compat.camera_from_numpy([0, 0, 0], [0, 0, -1], [0, 1, 0], 0.0, 0.0),
        lambda: compat.cubemap_from_numpy(1, 1, packed=np.zeros(6, np.uint32)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    scene = parse_scene_string(SCENE_2_TEXT, device="cpu")
    cam = TCamera.default("cpu")
    for fn in (rtt.render_image, rtt.render_image_cuda):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(scene, cam, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rtt.render_tiles_cuda(scene, cam, 8, 8, seed=0)
    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_2_TEXT)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scene", str(scene_file), "--output", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()

    # the interactive frame path: the film, its passes, the viewer's and the
    # server's render function, the server, the CLI's viewer
    from ray_tracing_tpu_torch.apps.cli import make_cuda_render_fn
    from ray_tracing_tpu_torch.apps.serve import RenderService
    from ray_tracing_tpu_torch.diff.checkpoint import restore_film, save_film
    from ray_tracing_tpu_torch.io.image import load_cubemap
    from ray_tracing_tpu_torch.render.film import Film, render_pass, render_pass_cuda
    from ray_tracing_tpu_torch.scene.native import parse_scene_string_native

    sky = tcm.constant_sky((0.1, 0.2, 0.3), device="cpu")
    film = Film.zero(8, 6, device="cpu")
    save_film(str(tmp_path / "film"), film)
    for make in (
        lambda: Film.zero(8, 6),
        lambda: render_pass(scene, cam, film, 0, 2, cubemap=sky),
        lambda: render_pass_cuda(scene, cam, film, 0, 2, cubemap=sky),
        lambda: render_pass_cuda(scene, cam, film, 0, 1, cubemap=sky, spp=4),
        lambda: make_cuda_render_fn(TCfg(), sky),
        lambda: RenderService(scene, 8, 6, TCfg(), sky),
        lambda: parse_scene_string_native(SCENE_2_TEXT),
        lambda: restore_film(str(tmp_path / "film")),
        lambda: load_cubemap(tmp_path / "no_assets"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scene", str(scene_file), "--interactive"])

    # the sharded paths and the last apps: meshes, the train step, fit and
    # its schedules, the pose search, the dry run, the apps' defaults
    import torch

    from ray_tracing_tpu_torch.apps import flythrough, invert, pose_recovery
    from ray_tracing_tpu_torch.diff import inverse
    from ray_tracing_tpu_torch.entry import dryrun_multichip
    from ray_tracing_tpu_torch.parallel import distributed, mesh

    opt = torch.optim.SGD([scene.albedo.clone().requires_grad_()], lr=0.0)
    target = torch.zeros(8, 8, 3)
    for make in (
        mesh.make_mesh,
        mesh.single_device_mesh,
        lambda: mesh.parse_mesh("2x1"),
        lambda: distributed.global_mesh(),
        lambda: distributed.initialize("file:///none", world_size=2, rank=0),
        lambda: inverse.make_train_step(scene, cam, opt, 8, 8),
        lambda: inverse.fit(scene, cam, target, steps=1),
        lambda: inverse.fit_multiscale(scene, cam, target, schedule=((1, 1),)),
        lambda: inverse.coarse_pose_search(scene, target),
        lambda: dryrun_multichip(2),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    png = tmp_path / "t.png"
    from ray_tracing_tpu_torch.io.image import save_png

    save_png(np.zeros((8, 8, 3), np.float32), png)
    for app, argv in ((invert.main, ["--scene", str(scene_file)]),
                      (flythrough.main, ["--scene", str(scene_file), "--out-dir",
                                         str(tmp_path / "fly")]),
                      (pose_recovery.main, ["--scene", str(scene_file), "--target", str(png)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            app(argv)


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """(f) checked in a fresh interpreter, after importing the package and
    every module of it, after the CLI's main, and after running the
    interactive frame path's modules (native, scene.native, render.film,
    diff.checkpoint, apps.viewer, apps.serve) and the sharded ones
    (parallel, fit with a checkpoint, apps.flythrough), whose imports are
    partly made inside their functions."""
    scene_file = tmp_path / "scene.txt"
    scene_file.write_text(SCENE_2_TEXT)
    code = f"""
import importlib, pkgutil, sys
import ray_tracing_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from ray_tracing_tpu_torch.apps.cli import main, make_cuda_render_fn
rc = main(["--scene", {str(scene_file)!r}, "--width", "16", "--height", "12", "--spp", "1",
           "--output", {str(tmp_path / 'o.png')!r}, "--no-skybox", "--device", "cpu"])
# the modules of the interactive frame path, imported by name and run
import io
from ray_tracing_tpu_torch import native
from ray_tracing_tpu_torch.apps.serve import RenderService
from ray_tracing_tpu_torch.apps.viewer import Viewer
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff.checkpoint import restore_film, save_film
from ray_tracing_tpu_torch.io.image import save_png
from ray_tracing_tpu_torch.ops.cubemap import constant_sky
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.film import render_progressive
from ray_tracing_tpu_torch.scene.native import parse_scene_string_native
assert native.lib() is not None
scene = parse_scene_string_native("sphere center {{3 3 3}} radius 1", device="cpu")
cfg, sky = RenderConfig(bounces=1, shadow_samples=1, init_scale=2), constant_sky(device="cpu")
film = render_progressive(scene, Camera.default("cpu"), 8, 6, 0, 2, cfg, sky, device="cpu")
save_film({str(tmp_path / 'film')!r}, film)
assert restore_film({str(tmp_path / 'film')!r}, device="cpu").resolve().equal(film.resolve())
save_png(film.resolve(), {str(tmp_path / 'f.png')!r})
v = Viewer(scene, Camera.default("cpu"), 8, 6, cfg, make_cuda_render_fn(cfg, sky, "cpu"),
           out=io.StringIO())
v.step(0); v.step(1); v.draw()
svc = RenderService(scene, 8, 6, cfg, sky, device="cpu")
svc.step(); svc.snapshot_png()
# the sharded paths and the last apps, run
from ray_tracing_tpu_torch.apps import flythrough
from ray_tracing_tpu_torch.diff.inverse import fit
from ray_tracing_tpu_torch.parallel.mesh import make_mesh
from ray_tracing_tpu_torch.parallel.render import render_image_sharded
m = make_mesh(2, 2, devices=["cpu"] * 4)
img = render_image_sharded(scene, Camera.default("cpu"), 8, 6, 0, m, spp=2, config=cfg)
fit(scene, Camera.default("cpu"), img, scene_fields=("albedo",), steps=1, spp=2, config=cfg,
    mesh=m, checkpoint_dir={str(tmp_path / 'ck')!r})
flythrough.main(["--scene", {str(scene_file)!r}, "--frames", "1", "--width", "8", "--height",
                 "6", "--spp", "1", "--out-dir", {str(tmp_path / 'fly')!r}, "--sharded",
                 "--mesh", "2x1", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "ray_tracing_tpu"
             or m.startswith("ray_tracing_tpu."))
print("RC", rc, "BAD", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "RC 0 BAD []" in proc.stdout, proc.stdout + proc.stderr
