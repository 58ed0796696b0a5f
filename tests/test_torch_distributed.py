"""The port's parallel/distributed.py over two processes on the CPU, after
tests/test_distributed.py: torch.distributed with gloo, four CPU cells per
process, one global mesh; a sharded render, the rows each process owns, and
one train step, each against the same computation in one process; and
entry.dryrun_multichip on an 8-cell mesh of CPU cells.

The processes meet through a file:// store under the test's tmp_path (no
port: the JAX test's fixed port runs beside these under xdist), and each
child has a timeout.
"""

import json
import os
import subprocess
import sys

import pytest

CHILD = r'''
import json, sys
import torch
from ray_tracing_tpu_torch.config import RenderConfig
from ray_tracing_tpu_torch.diff import inverse
from ray_tracing_tpu_torch.ops.cubemap import checker_sky
from ray_tracing_tpu_torch.parallel import distributed
from ray_tracing_tpu_torch.parallel.mesh import make_mesh
from ray_tracing_tpu_torch.parallel.render import render_image_sharded
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.scene.synthetic import random_objects
from ray_tracing_tpu_torch.scene.types import Scene

rank, store = int(sys.argv[1]), sys.argv[2]
distributed.initialize(store, world_size=2, rank=rank, device="cpu")
assert torch.distributed.get_backend() == "gloo"
W, H, SPP = 32, 16, 8
scene = Scene.from_objects(random_objects(5, seed=3, lights=(1,)), device="cpu")
cam, sky = Camera.default("cpu"), checker_sky(16, device="cpu")
cfg = RenderConfig(bounces=2, shadow_samples=1)
target = torch.full((H, W, 3), 0.35)
out = {"rank": rank, "coordinator": distributed.is_coordinator()}


def step(mesh):
    albedo = scene.albedo.clone().requires_grad_()
    opt = torch.optim.SGD([albedo], lr=0.0)
    fn = inverse.make_train_step(scene, cam, opt, W, H, spp=SPP, config=cfg, cubemap=sky,
                                 device="cpu", mesh=mesh)
    loss = fn({"scene": {"albedo": albedo}, "camera": {}}, target, 7)
    return float(loss), albedo.grad


# the same frame and step in this process alone, on an 8-cell local mesh
local = make_mesh(4, 2, devices=["cpu"] * 8)
assert local.ranks == (rank,)
one = render_image_sharded(scene, cam, W, H, 5, local, spp=SPP, config=cfg, cubemap=sky)
loss1, grad1 = step(local)

for num_samples in (2, 8):  # 4x2: tiles per process; 1x8: one tile over both
    mesh = distributed.global_mesh(num_samples=num_samples, devices=["cpu"] * 4)
    lo, hi = distributed.local_tile_range(mesh, H)
    img = render_image_sharded(scene, cam, W, H, 5, mesh, spp=SPP, config=cfg, cubemap=sky)
    rows = (0, H) if num_samples == 8 else (lo, hi)
    loss, grad = step(mesh)
    out[num_samples] = {
        "shape": mesh.shape, "ranks": list(mesh.ranks), "tile_range": [lo, hi],
        "img_shape": list(img.shape),
        "frame_err": float((img - one[rows[0]:rows[1]]).abs().max()),
        "loss": loss, "loss1": loss1,
        "grad_err": float((grad - grad1).abs().max()), "grad_scale": float(grad1.abs().max()),
        "norm_ratio": float(grad.norm() / grad1.norm()),
    }
print("DIST-JSON " + json.dumps(out), flush=True)
'''


def test_two_process_distributed_render_and_train_step(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("DIST-JSON ")]
        assert line, out[-3000:]
        r = json.loads(line[-1][len("DIST-JSON "):])
        res[r["rank"]] = r
    assert res[0]["coordinator"] and not res[1]["coordinator"]
    for rank in (0, 1):
        tiles = res[rank]["2"]
        assert tiles["shape"] == {"tile": 4, "sample": 2} and tiles["ranks"] == [0, 1]
        # consecutive tiles on one process: each owns its half of the rows
        assert tiles["tile_range"] == ([0, 8] if rank == 0 else [8, 16])
        assert tiles["img_shape"] == [8, 32, 3]
        one_tile = res[rank]["8"]
        assert one_tile["shape"] == {"tile": 1, "sample": 8}
        assert one_tile["tile_range"] == ([0, 16] if rank == 0 else [0, 0])
        assert one_tile["img_shape"] == [16, 32, 3]  # the tile summed over both processes
        for r in (tiles, one_tile):
            # the same samples in another order of sums: frame 1e-6, loss
            # rel 1e-6, gradient 1e-5 of its largest entry, norm ratio 1
            assert r["frame_err"] <= 1e-6, r
            assert r["loss"] == pytest.approx(r["loss1"], rel=1e-6)
            assert r["grad_scale"] > 0 and r["grad_err"] <= 1e-5 * r["grad_scale"], r
            assert r["norm_ratio"] == pytest.approx(1.0, abs=1e-5)
    assert res[0]["8"]["loss"] == res[1]["8"]["loss"]


def test_initialize_is_a_no_op_in_one_process():
    import torch.distributed as dist

    from ray_tracing_tpu_torch.parallel import distributed

    distributed.initialize(None, world_size=4, rank=0, device="cpu")
    distributed.initialize("file:///nonexistent/store", world_size=1, rank=0, device="cpu")
    assert not dist.is_initialized()
    assert distributed.is_coordinator()
    mesh = distributed.global_mesh(num_samples=2, devices=["cpu"] * 4)
    assert mesh.shape == {"tile": 2, "sample": 2} and mesh.ranks == (0,)
    assert distributed.local_tile_range(mesh, 16) == (0, 16)


def test_dryrun_multichip_entrypoint_on_the_cpu(capsys):
    """After tests/test_parallel.py::test_dryrun_multichip_entrypoint: one
    sharded forward and one sharded train step on 8 cells, default physics."""
    from ray_tracing_tpu_torch.entry import dryrun_multichip

    loss = dryrun_multichip(8, device="cpu")
    assert loss > 0
    assert "dryrun_multichip OK: mesh={'tile': 4, 'sample': 2}" in capsys.readouterr().out
