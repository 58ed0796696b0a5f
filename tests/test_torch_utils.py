"""utils/ of the PyTorch port (timing, profiling, flops, the gather probe) and
the plain versions of the two measurement kernels (K6 FMA peak, P1 gather)
against the JAX package on the CPU.

Tolerances: the timing and ray-accounting functions and the cost-model
formulas must give the JAX functions' numbers exactly (same arithmetic on
the same scripted clock). The census of the plain estimator is held to
within CENSUS_RTOL of the JAX jaxpr census; the gap comes from how the two
frameworks spell the same arithmetic, op kinds named in test_census_*. K6's
plain recurrence equals numpy's float32 recurrence bit for bit; P1's plain
version equals the JAX probe kernel (Pallas interpret mode, one grid step)
bit for bit (integers).
"""

import importlib.util
import json
import pathlib
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from ray_tracing_tpu.config import RenderConfig as JCfg
from ray_tracing_tpu.scene.parser import parse_scene_string as jparse
from ray_tracing_tpu.utils import flops as jflops
from ray_tracing_tpu.utils import profiling as jprof
from ray_tracing_tpu.utils import timing as jtiming

from ray_tracing_tpu_torch.config import RenderConfig as TCfg
from ray_tracing_tpu_torch.kernels import megakernel as tmk
from ray_tracing_tpu_torch.kernels import peak
from ray_tracing_tpu_torch.render.camera import Camera as TCamera
from ray_tracing_tpu_torch.scene.parser import parse_scene_string as tparse
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.utils import flops as tflops
from ray_tracing_tpu_torch.utils import gather_probe
from ray_tracing_tpu_torch.utils import profiling as tprof
from ray_tracing_tpu_torch.utils import timing as ttiming

import torch_port_util as U

REPO = pathlib.Path(__file__).resolve().parent.parent

# The census of the plain estimator against the JAX census, relative. Both
# price ops alike, but spell the arithmetic differently: PyTorch's 1/x is a
# reciprocal and a multiply (JAX: one div); autograd's accumulation of a
# tensor's several gradients is priced as adds where JAX's add_any is
# priced 0; the port's gradient-safe normalize and slab tests add selects and
# bit logic; the JAX fetch builds one-hot rows (compares, selects) that the
# port's index fetch does not need. Measured at 3 bounces: +1 % to +14 %, and
# -8 % for the room's fetch.
CENSUS_RTOL = 0.15
CENSUS_CFG = dict(bounces=3, shadow_samples=2)


def scripted_clock(n=200, seed=0):
    """A perf_counter that returns a fixed increasing sequence."""
    steps = np.random.default_rng(seed).uniform(1e-4, 5e-3, n)
    values = iter(np.cumsum(steps).tolist())
    return lambda: next(values)


def scenes(name):
    """(JAX scene, port scene) of the same objects."""
    if name == "sixty_two_lights":
        return U.scene_pair(random_objects(60, seed=1, lights=(7, 20)))
    text = {"scene_2": SCENE_2_TEXT, "room": ROOM_TEXT}[name]
    return jparse(text), tparse(text, device="cpu")


# -- timing and profiling -------------------------------------------------


@pytest.mark.parametrize("k,k1,repeats", [(4, 1, 2), (3, 2, 3)])
def test_timed_marginal_equals_jax_on_one_clock(monkeypatch, k, k1, repeats):
    got = {}
    for name, mod, fn in (("jax", jtiming, lambda x: jnp.asarray(x) * 2),
                          ("torch", ttiming, lambda x: torch.tensor(x) * 2)):
        monkeypatch.setattr(time, "perf_counter", scripted_clock())
        got[name] = mod.timed_marginal(fn, lambda i: (float(i),), k=k, k1=k1, repeats=repeats)
    assert got["torch"] == got["jax"] and got["jax"] != 0


def test_timed_per_sample_equals_jax_on_one_clock(monkeypatch):
    got = {}
    for name, mod, fn in (("jax", jtiming, lambda s, seed: jnp.asarray(seed) + s),
                          ("torch", ttiming, lambda s, seed: torch.tensor(seed) + s)):
        monkeypatch.setattr(time, "perf_counter", scripted_clock(seed=1))
        got[name] = mod.timed_per_sample(fn, 3, n=8)
    assert got["torch"] == got["jax"]


def test_materialize_reads_one_element_per_leaf():
    out = {"a": torch.arange(5.0) + 2, "b": (torch.zeros((2, 2)) + 3, 1.5)}
    assert ttiming.materialize(out) == 2 + 3 + 1.5
    assert jtiming.materialize({"a": jnp.arange(5.0) + 2, "b": (jnp.zeros((2, 2)) + 3, 1.5)}) \
        == ttiming.materialize(out)


@pytest.mark.parametrize("window", [2, 4])
def test_rate_meter_equals_jax_on_one_clock(monkeypatch, window):
    meters = {}
    for name, mod in (("jax", jprof), ("torch", tprof)):
        monkeypatch.setattr(time, "perf_counter", scripted_clock(seed=2))
        m = mod.RateMeter(window=window)
        rates = [m.rays_per_second]
        for rays in (1_000_000, 3_000_000, 2_500_000_000, 7, 40_000_000):
            m.add(rays)
            rates.append((m.rays_per_second, m.format()))
        meters[name] = rates
    assert meters["torch"] == meters["jax"]


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace holds the profiler's events and the program's spans on
    one clock: a frame's render_image span encloses its TileJob's cat."""
    scene = tparse(SCENE_2_TEXT, device="cpu")
    with tprof.trace(str(tmp_path / "t")):
        (torch.arange(512.0) @ torch.arange(512.0)).item()
        tmk.render_image_cuda(scene, TCamera.default("cpu"), 8, 6, seed=1, device="cpu")
    doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    events = doc["traceEvents"]
    (frame,) = [e for e in events if e.get("cat") == "span" and e["name"] == "render_image"]
    assert frame["args"] == {"pixels": 48, "samples": 1}
    assert frame["tid"] == threading.get_native_id()
    cats = [e for e in events if e.get("name") == "aten::cat" and e.get("tid") == frame["tid"]]
    assert any(frame["ts"] <= e["ts"] and e["ts"] + e["dur"] <= frame["ts"] + frame["dur"]
               for e in cats)
    assert {e["name"] for e in events if e.get("cat") == "span"} >= {
        "tile_job", "kernel.megakernel_fwd", "sky_lookup", "compose", "average"}


def test_environment_fingerprint_on_the_cpu():
    fp = ttiming.environment_fingerprint("cpu")
    assert set(fp) == {"dispatch_ms_per_call", "item_ms"}
    assert all(v > 0 for v in fp.values())


@pytest.mark.parametrize("call", [
    lambda: ttiming.device_seconds(lambda i: None, 1, "cpu"),
    lambda: tflops.measured_vpu_peak(grid=1, iters=64, device="cpu"),
    lambda: tflops.measured_mxu_peak(n=8, iters=1, device="cpu"),
    lambda: gather_probe.run("cpu"),
], ids=["device_seconds", "vpu_peak", "mxu_peak", "gather_probe"])
def test_card_measurements_refuse_the_cpu(call):
    """A measurement of the card never times a plain version instead."""
    with pytest.raises(ValueError):
        call()


# -- cost-model formulas and the census ------------------------------------


@pytest.mark.parametrize("name", ["scene_2", "room", "sixty_two_lights"])
def test_cost_model_formulas_equal_jax(name):
    js, ts = scenes(name)
    for kw in (dict(), dict(bounces=3, shadow_samples=2), dict(shadow_samples=0)):
        jc, tc = JCfg(**kw), TCfg(**kw)
        assert tprof.traces_per_sample(tc) == jprof.traces_per_sample(jc)
        assert tprof.rays_per_frame(64, 36, 3, tc) == jprof.rays_per_frame(64, 36, 3, jc)
        assert tflops.rays_per_sample(1920, 1080, tc) == jflops.rays_per_sample(1920, 1080, jc)
        for light in (False, True):
            assert tflops.prng_flops_per_pixel(tc, light) == jflops.prng_flops_per_pixel(jc, light)
        assert tflops.routing_mxu_flops_per_pixel(ts, tc) \
            == jflops.routing_mxu_flops_per_pixel(js, jc)
        for passes in (1, 6):
            assert tflops.fetch_mxu_flops_per_pixel(ts, tc, passes) \
                == jflops.fetch_mxu_flops_per_pixel(js, jc, passes)


def _jax_census(what, js, jc):
    if what == "physics":
        return jflops.physics_cost_per_pixel(js, jc)
    if what == "fetch_vjp":
        c = jflops.fetch_vjp_cost_per_pixel(js, jc)
        # the port fetches by index: no one-hot products to count
        return {**c, "flops_per_px": c["flops_per_px"] - jflops.fetch_mxu_flops_per_pixel(js, jc)}
    return jflops.replay_vjp_cost_per_pixel(js, jc)


@pytest.mark.parametrize("what", ["physics", "fetch_vjp", "replay_vjp"])
@pytest.mark.parametrize("name", ["scene_2", "room"])
def test_census_within_tolerance_of_jax(name, what):
    """The counted flops per pixel of the plain estimator (and of its fetch
    and replay VJPs) against the JAX census. Transcendentals (the square
    roots) agree exactly; the histogram sums to the total."""
    js, ts = scenes(name)
    want = _jax_census(what, js, JCfg(**CENSUS_CFG))
    got = getattr(tflops, what + "_cost_per_pixel")(ts, TCfg(**CENSUS_CFG))
    assert abs(got["flops_per_px"] - want["flops_per_px"]) <= CENSUS_RTOL * want["flops_per_px"]
    assert got["transcendentals_per_px"] == want["transcendentals_per_px"]
    assert sum(got["ops"].values()) == pytest.approx(got["flops_per_px"], rel=1e-12)
    assert got["ops"]["where"] > 0 and got["ops"]["mul"] > 0


def test_census_prices():
    """A clamp with two bounds is 2 per element, with one bound 1; a select
    2; sqrt 1 plus a transcendental; an integer power its multiplications; a
    reduction its input; views and gathers nothing."""
    x = torch.rand(4, 8)
    with tflops.FlopCensus() as c:
        torch.clamp(x, 0.0, 1.0)
        torch.clamp(x, min=0.5)
        torch.where(x > 0.5, x, 0.0)
        torch.sqrt(x)
        x ** 5
        x.sum(dim=0)
        x[:, 1:3].reshape(-1)
        x[torch.tensor([0, 2])]
    assert c.by_op == {"clamp": 64 + 32, "gt": 32, "where": 64, "sqrt": 32, "pow": 3 * 32,
                       "sum": 32}
    assert c.transcendentals == 32


# -- the plain versions of K6 and P1 ----------------------------------------


@pytest.mark.parametrize("iters", [64, 128])
def test_peak_fma_plain_equals_numpy(iters):
    a_np = (0.25 + 1e-6 * np.arange(16, dtype=np.float32)[:, None]
            + np.zeros((16, 128), np.float32)).astype(np.float32)
    xs = [a_np + np.float32(0.01 * k) for k in range(8)]
    for _ in range(iters):
        xs = [x * x + a_np for x in xs]
    want = xs[0]
    for x in xs[1:]:
        want = want + x
    got = peak.peak_fma(torch.from_numpy(a_np), iters)  # the CPU takes the plain version
    np.testing.assert_array_equal(got.numpy(), want)


def test_peak_fma_rejects_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        peak.peak_fma(torch.zeros(8), 100)  # not a multiple of the unrolled body
    with pytest.raises(TypeError):
        peak.peak_fma(torch.zeros(8, dtype=torch.float64), 64)


def test_gather_plain_equals_the_jax_probe_kernel():
    """The JAX probe's Pallas kernel, in interpret mode at one grid step (a
    TILE of indices), against the port's gather on the CPU."""
    spec = importlib.util.spec_from_file_location("vmem_gather_probe",
                                                  REPO / "benchmarks" / "vmem_gather_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert (probe.TABLE, probe.TILE) == (gather_probe.TABLE, gather_probe.TILE)
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, probe.TABLE, dtype=np.int32)
    idx = rng.integers(0, probe.TABLE, probe.TILE, dtype=np.int32)
    call = pl.pallas_call(
        probe.kernel, grid=(1,),
        in_specs=[pl.BlockSpec((probe.TABLE,), lambda i: (0,)),
                  pl.BlockSpec(probe.TILE, lambda i: (i, 0))],
        out_specs=pl.BlockSpec(probe.TILE, lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(probe.TILE, jnp.int32), interpret=True)
    want = np.asarray(call(jnp.asarray(table), jnp.asarray(idx)))
    got = gather_probe.gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_checks_its_inputs():
    table = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_probe.gather(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather_probe.gather(table.reshape(2, 5), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(IndexError):
        gather_probe.gather(table, torch.tensor([10], dtype=torch.int32))


# Ragged lengths (n mod 4 = 1, 3, 3) and storage offsets past a 16-byte
# boundary: the kernel's scalar head and tail (csrc/gather_probe.cu).
RAGGED = (1, 7, 8 * 1021 + 3)
OFFSETS = (1, 2, 3, 5)


def _gather_cases(table_entries, device, seed=0):
    """(name, indices) of every shape the gather takes: ragged 1-D lengths,
    1-D views at a storage offset, a 2-D index plane, and a 2-D view at a
    row offset; int32 indices into a table of `table_entries`."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.randint(0, table_entries, (9000,), generator=gen, dtype=torch.int32).to(device)
    cases = [(f"ragged_{n}", base[:n]) for n in RAGGED]
    cases += [(f"offset_{k}", base[k:k + RAGGED[-1]]) for k in OFFSETS]
    plane = base[:60 * 128].reshape(60, 128)
    cases += [("plane", plane), ("plane_rows_from_1", plane[1:]),
              ("plane_offset_3", base[3:3 + 7 * 129].reshape(7, 129))]
    return cases


@pytest.mark.parametrize("case", range(len(_gather_cases(16, "cpu"))))
def test_gather_on_the_cpu_equals_torch_take_at_every_shape(case):
    """The wrapper on CPU tensors (its plain version) at ragged lengths, on
    views at a storage offset and on 2-D indices: bit-equal to torch.take,
    in idx's shape."""
    table = torch.randint(0, 1 << 30, (4096,), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32)
    name, idx = _gather_cases(table.numel(), "cpu")[case]
    assert idx.is_contiguous()
    got = gather_probe.gather(table, idx)
    assert got.shape == idx.shape and got.dtype == torch.int32, name
    assert torch.equal(got, torch.take(table, idx.long())), name


def test_gather_of_no_indices_is_empty():
    table = torch.arange(10, dtype=torch.int32)
    got = gather_probe.gather(table, torch.zeros((0, 3), dtype=torch.int32))
    assert got.shape == (0, 3) and got.dtype == torch.int32


def test_gather_bound_counts_each_byte_once():
    """The probe's bound: 256 KB of table, 8 MB of indices, 8 MB of
    results at 3.35 TB/s, about 5.09 us."""
    s = gather_probe.bound_seconds(gather_probe.TABLE, gather_probe.N_IDX)
    assert s == 4 * (65536 + 2 * 2 * 1024 * 1024) / 3.35e12
    assert 5.0e-6 < s < 5.2e-6


# -- the kernels on the card ---------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_peak_fma_kernel_matches_plain_version(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = 0.05 + 0.15 * torch.rand((256, 128), generator=gen, device=cuda_device)
    before = peak.launch_counts["peak_fma"]
    got = peak.peak_fma(a, 256)
    assert peak.launch_counts["peak_fma"] == before + 1
    want = peak.peak_fma_plain(a, 256)
    assert ((got - want).abs() <= 1e-5 * want.abs()).all()


@pytest.mark.gpu
def test_gather_kernel_equals_torch_take(cuda_device):
    table, idx = gather_probe.probe_inputs(cuda_device)
    before = gather_probe.launch_counts["gather_probe"]
    got = gather_probe.gather(table, idx)
    assert gather_probe.launch_counts["gather_probe"] == before + 1
    assert torch.equal(got, torch.take(table, idx.long()))


@pytest.mark.gpu
def test_gather_kernel_equals_torch_take_at_every_shape(cuda_device):
    """The kernel at ragged lengths, on views at a storage offset and on 2-D
    indices (its scalar head and tail): bit-equal to torch.take, one launch
    each."""
    table, _ = gather_probe.probe_inputs(cuda_device)
    for name, idx in _gather_cases(table.numel(), cuda_device):
        before = gather_probe.launch_counts["gather_probe"]
        got = gather_probe.gather(table, idx)
        assert gather_probe.launch_counts["gather_probe"] == before + 1, name
        assert got.shape == idx.shape, name
        assert torch.equal(got, torch.take(table, idx.long())), name


@pytest.mark.gpu
@pytest.mark.parametrize("entries, n", [(5000, 8171), (40000, 65539), (70000, 70001)],
                         ids=["small", "all_staged", "part_staged"])
def test_gather_kernel_equals_torch_take_from_a_table_in_shared_memory(entries, n, cuda_device):
    """A table that at least as many indices read is staged in shared
    memory, all of it up to STAGED entries and its first STAGED above
    (csrc/gather_probe.cu, gather_staged_kernel): bit-equal to torch.take,
    whole and from storage offsets of 1 and 3 indices."""
    gen = torch.Generator().manual_seed(entries)
    table = torch.randint(0, 1 << 30, (entries,), generator=gen, dtype=torch.int32).to(cuda_device)
    base = torch.randint(0, entries, (n + 3,), generator=gen, dtype=torch.int32).to(cuda_device)
    for off in (0, 1, 3):
        idx = base[off:off + n]
        assert torch.equal(gather_probe.gather(table, idx), torch.take(table, idx.long()))


@pytest.mark.gpu
def test_gather_kernel_equals_torch_take_on_the_sky_indices(cuda_device):
    """The main path's gather: one sample's texel indices of the lit room
    and of scene_2 at 256x144 into a packed 256^2 cubemap, whole and from a
    storage offset of 3."""
    from ray_tracing_tpu_torch.ops.cubemap import checker_sky

    sky = checker_sky(256, device=cuda_device)
    camera = TCamera.default(cuda_device)
    for text in (ROOM_TEXT, SCENE_2_TEXT):
        job = tmk.make_tile_job(tparse(text, device=cuda_device), camera, 256, 144, TCfg())
        flat, _ = tmk._miss_texel_index(sky, tmk.run_tiles(job, 3)[0])
        for idx in (flat, flat.reshape(-1)[3:]):
            got = gather_probe.gather(sky.packed, idx)
            assert torch.equal(got, torch.take(sky.packed, idx.long()))
