"""The contract of the CUDA kernels' trace loops on the CPU
(ray_tracing_tpu_torch/kernels/csrc/rt_device.cuh): a trace table with one
kind of object per loop, `radius*radius` and `lo + size` computed once, and
the closest hit breaking ties by index across the two loops. A plain model
of that traversal (torch_port_util.table_closest / table_shadow) is held
against the in-order scan of ops/intersect.py (trace, trace_shadow_record),
which the kernels must match bit for bit, and whose winners are the JAX
package's: identical winners and bit-identical t on random rays,
axis-parallel rays, duplicated objects that tie exactly, a sphere and a box
that tie exactly, and shadow rays blocked on a tie on either side of the
light's index. Also the layout of the backward kernels' state word.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tracing_tpu.ops import intersect as jint

from ray_tracing_tpu_torch.ops import intersect as tint
from ray_tracing_tpu_torch.scene.parser import parse_objects
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import ObjectSpec

import torch_port_util as U


def _rays(specs, n=512, seed=3):
    """(ro, rd) of shape (3, 8, 64): random rays toward the scene, then
    rays along each axis straight at the centre of every object, from
    outside and back."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-9, 9, (3, n)).astype(np.float32)
    rd = (r.uniform(-4, 4, (3, n)).astype(np.float32) - ro) * r.uniform(0.3, 2.0, (1, n)).astype(np.float32)
    k = 0
    for i, o in enumerate(specs):
        p0, p1 = np.asarray(o.p0, np.float32), np.asarray(o.p1, np.float32)
        centre = p0 if o.kind == "sphere" else p0 + np.float32(0.5) * p1
        axis = np.eye(3, dtype=np.float32)[i % 3]
        for o_, d_ in ((centre - 12.0 * axis, axis), (centre + 12.0 * axis, -axis)):
            if k < n // 2:
                ro[:, n // 2 + k], rd[:, n // 2 + k] = o_, d_
                k += 1
    return ro.reshape(3, 8, 64), rd.reshape(3, 8, 64)


def _pair(specs):
    js, ts = U.scene_pair(specs)
    return js, ts, ts.packed_rows()


SCENES = {
    "room": parse_objects(ROOM_TEXT),
    "sixty": random_objects(60, seed=1, lights=(7,)),
    # every room object twice, the copies in reverse order: exact ties
    "room_twice": parse_objects(ROOM_TEXT) + parse_objects(ROOM_TEXT)[::-1],
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_table_closest_hit_is_the_in_order_scan_bit_for_bit(name):
    specs = SCENES[name]
    js, ts, rows = _pair(specs)
    ro, rd = _rays(specs)
    t, obj = U.table_closest(rows, ts.obj_type, U.tvec(ro), U.tvec(rd))
    h = tint.trace(ts, U.tvec(ro), U.tvec(rd))
    assert obj.equal(h.obj) and t.equal(h.t)
    assert (obj >= 0).float().mean() > 0.3 and (obj < 0).any()
    # and the JAX package's winners (a last-bit tie may differ between packages)
    jobj = np.asarray(jint.trace(js, U.jvec(ro), U.jvec(rd)).obj)
    assert (jobj == obj.numpy()).mean() >= 0.99
    if name == "room_twice":  # the first copy of a pair wins its tie
        n = len(specs) // 2
        assert obj.max() < n


def _tie_pair(box_first):
    """A sphere of centre (0,0,5) and radius 1 and a box [-1,1]^2 x [4,6]:
    a ray from the origin along +z meets both at t = 4 exactly."""
    sphere = ObjectSpec(kind="sphere", p0=(0.0, 0.0, 5.0), p1=(1.0, 1.0, 1.0))
    box = ObjectSpec(kind="cube", p0=(-1.0, -1.0, 4.0), p1=(2.0, 2.0, 2.0))
    return [box, sphere] if box_first else [sphere, box]


def _axis_rays():
    """Rays along +z from the origin (the exact tie) and from points beside
    it, and along -z from behind."""
    xs = np.array([0.0, 0.0, 0.25, -0.5, 0.9, 0.0, 3.0, 0.0], np.float32)
    ro = np.stack([xs, np.zeros(8, np.float32), np.zeros(8, np.float32)])
    rd = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, 8))
    ro[:, 5], rd[:, 5] = (0.0, 0.0, 12.0), (0.0, 0.0, -1.0)
    return ro, rd


@pytest.mark.parametrize("box_first", [True, False], ids=["box_first", "sphere_first"])
def test_table_closest_hit_breaks_a_sphere_box_tie_by_index(box_first):
    specs = _tie_pair(box_first)
    _, ts, rows = _pair(specs)
    ro, rd = _axis_rays()
    t, obj = U.table_closest(rows, ts.obj_type, U.tvec(ro), U.tvec(rd))
    h = tint.trace(ts, U.tvec(ro), U.tvec(rd))
    assert float(h.t[0]) == 4.0  # the tie is exact
    assert obj.equal(h.obj) and t.equal(h.t)
    assert int(obj[0]) == 0  # the lower index wins, whichever kind it is


@pytest.mark.parametrize("light_first", [True, False], ids=["light_first", "light_last"])
@pytest.mark.parametrize("light_kind", ["cube", "sphere"])
def test_table_shadow_blocks_on_a_tie_only_before_the_light(light_first, light_kind):
    """The light and an occluder of the other kind tie at t = 4: the
    occluder blocks the ray when its index is below the light's, not when
    it is above."""
    box, sphere = _tie_pair(True)
    light, occluder = (box, sphere) if light_kind == "cube" else (sphere, box)
    light = dataclasses.replace(light, emission_power=2.0)
    specs = [light, occluder] if light_first else [occluder, light]
    _, ts, rows = _pair(specs)
    li = ts.light_index
    ro, rd = _axis_rays()
    got = U.table_shadow(rows, ts.obj_type, U.tvec(ro), U.tvec(rd), light=li)
    (_, _), rec = tint.trace_shadow_record(ts, U.tvec(ro), U.tvec(rd))
    assert got.equal(rec.obj)
    assert int(got[0]) == (li if light_first else -1)


@pytest.mark.parametrize("light", [0, 4, 27, 29])
def test_table_shadow_occlusion_is_the_in_order_trace(light):
    """Random and axis-parallel shadow rays, the sole emitter at the start,
    in the middle and at the end of the index order, of either kind
    (every third object of random_objects is a box)."""
    specs = random_objects(31, seed=5, lights=(light,))
    js, ts, rows = _pair(specs)
    ro, rd = _rays(specs, seed=light)
    # a quarter of the random rays aimed at the light's centre
    o = specs[light]
    centre = np.asarray(o.p0, np.float32)
    if o.kind == "cube":
        centre = centre + np.float32(0.5) * np.asarray(o.p1, np.float32)
    rd[:, :2] = centre[:, None, None] - ro[:, :2]
    got = U.table_shadow(rows, ts.obj_type, U.tvec(ro), U.tvec(rd), light=light)
    (_, _), rec = tint.trace_shadow_record(ts, U.tvec(ro), U.tvec(rd))
    assert got.equal(rec.obj)
    assert (got == light).any() and (got < 0).any()
    (_, _), jrec = jint.trace_shadow_record(js, U.jvec(ro), U.jvec(rd))
    assert (np.asarray(jrec.obj) == got.numpy()).mean() >= 0.99


def test_table_shadow_full_scan_is_the_in_order_scan():
    specs = random_objects(31, seed=6, lights=(2, 9))
    _, ts, rows = _pair(specs)
    ts = dataclasses.replace(ts, emissive=None)
    ro, rd = _rays(specs)
    got = U.table_shadow(rows, ts.obj_type, U.tvec(ro), U.tvec(rd))
    (_, _), rec = tint.trace_shadow_record(ts, U.tvec(ro), U.tvec(rd))
    assert got.equal(rec.obj) and (got >= 0).any()


# ---------------------------------------------------------------------------
# The state word of the backward kernels (csrc/rt_backward.cuh, pack_word)
# ---------------------------------------------------------------------------

KNOWN = U.read_constant("rt_backward.cuh", "KNOWN_SAMPLES")
SHIFT = 2 * KNOWN


def _pack(accepted, taken, obj):
    known = (1 << KNOWN) - 1
    return ((accepted & known) | ((taken & known) << KNOWN) | (obj << SHIFT)) & 0xFFFFFFFF


def _unpack(word):
    known = (1 << KNOWN) - 1
    return word & known, (word >> KNOWN) & known, word >> SHIFT


def test_state_word_keeps_the_masks_and_the_winner():
    """Masks of up to KNOWN_SAMPLES samples and any winner a saved bounce
    can have come back unchanged; the winner's bits hold more objects than
    the backward kernels' shared memory admits (each object takes at least
    its row and its gradient row: 128 bytes of the 227 KB a block may opt
    in to)."""
    assert SHIFT + 11 <= 32  # the winner has at least 11 bits
    most_objects = 232448 // (64 + 64)
    assert most_objects < 1 << (32 - SHIFT)
    rng = np.random.default_rng(0)
    for ns in range(0, KNOWN + 1):
        for _ in range(50):
            accepted = int(rng.integers(0, 1 << ns)) if ns else 0
            taken = accepted & (int(rng.integers(0, 1 << ns)) if ns else 0)
            obj = int(rng.integers(0, most_objects))
            assert _unpack(_pack(accepted, taken, obj)) == (accepted, taken, obj)
    assert _unpack(_pack(0, 0, most_objects - 1))[2] == most_objects - 1
    # above KNOWN_SAMPLES the masks are not kept, and the winner still is
    assert _unpack(_pack((1 << 33) - 1, (1 << 33) - 1, 5))[2] == 5


# ---------------------------------------------------------------------------
# chip_smoke.py's reading of the trace loops in SASS
# ---------------------------------------------------------------------------

SASS = """
	code for sm_90a
		Function : _Z5otherv
        /*0000*/                   EXIT ;
		Function : _ZN2rt10fwd_kernelILb0EEEvPKf
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   STS.128 [R3], R8 ;
        /*0030*/                   LDS.128 R12, [UR5] ;
        /*0040*/              @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0050*/                   LDS.128 R4, [R2] ;
        /*0060*/                   FMUL R5, R4, R4 ;
        /*0070*/                   FMUL R6, R4, R4 ;
        /*0080*/                   MUFU.RSQ R7, R6 ;
        /*0090*/              @P1 BRA `(.L_x_1) ;
.L_x_2:
        /*00a0*/                   LDS.128 R4, [R2] ;
        /*00b0*/                   LDS.64 R8, [R2+0x10] ;
        /*00c0*/                   FMUL R5, R4, R4 ;
        /*00d0*/                   FMUL R6, R4, R4 ;
        /*00e0*/                   FADD R6, R4, R4 ;
        /*00f0*/              @P1 BRA `(.L_x_2) ;
.L_x_3:
        /*0100*/                   LDS.128 R4, [R2] ;
        /*0110*/                   FMUL R5, R4, R4 ;
        /*0120*/                   FMUL R5, R4, R4 ;
        /*0130*/                   FMUL R5, R4, R4 ;
        /*0140*/                   FMUL R5, R4, R4 ;
        /*0150*/                   FMUL R5, R4, R4 ;
        /*0160*/              @P1 BRA `(.L_x_3) ;
        /*0170*/              @P2 BRA `(.L_x_1) ;
        /*0180*/                   EXIT ;
		Function : _ZN2rt10fwd_kernelILb1EEEvPKf
        /*0000*/                   EXIT ;
"""


def test_sass_trace_loops_are_found_and_classed():
    """The innermost loops that read 16-byte shared entries, classed by
    opcode: a square root makes a closest-hit sphere test, five multiplies
    per shared load a sphere occluder, fewer a box (two loads per box); a
    loop that also stores to shared memory (staging) is left out, and so is
    the loop around the others."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    loops = cs.trace_loops(SASS, "fwd_kernelILb0E")
    assert [(lp["kind"], lp["instructions"], lp["objects"]) for lp in loops] == [
        ("sphere", 5, 1), ("box", 6, 1), ("sphere_occluder", 7, 1)]
    assert loops[1]["lds_bytes"] == 24 and loops[1]["lds128"] == 1
    tests = cs.per_object_test(loops)
    assert tests == {"sphere": 5, "box": 6, "sphere_occluder": 7, "lds_per_object": 2}


PTXAS_LOG = "\n".join(
    f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {sym}\n"
    f"    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, used 1 barriers, {frame} bytes cumulative stack size"
    for sym, regs, frame in (
        ("_ZN50_GLOBAL__N__6bb81bdc_17_megakernel_fwd_cu_3443d9d410fwd_kernelILb0EEEvPKfS2_PfPiN2rt6ParamsE", 80, 48),
        ("_ZN50_GLOBAL__N__6bb81bdc_17_megakernel_fwd_cu_3443d9d410fwd_kernelILb1EEEvPKfS2_PfPiN2rt6ParamsE", 80, 56),
        ("_ZN2rt10bwd_kernelIN50_GLOBAL__N__f02959ca_17_megakernel_bwd_cu_3443d9d412FetchWinnersEEEvPKfS4_S4_PKiPfS7_S7_NS_6ParamsEi", 126, 32),
        ("_ZN2rt10bwd_kernelIN58_GLOBAL__N__15dd57c3_25_megakernel_bwd_retrace_cu_3443d9d413TracedWinnersEEEvPKfS4_S4_PKiPfS7_S7_NS_6ParamsEi", 127, 32),
        ("_ZN2rt10bwd_kernelIN58_GLOBAL__N__15dd57c3_25_megakernel_bwd_retrace_cu_3443d9d415RecordedWinnersEEEvPKfS4_S4_PKiPfS7_S7_NS_6ParamsEi", 128, 32),
        ("_ZN44_GLOBAL__N__e2c5a0e2_11_peak_fma_cu_f2c675a815peak_fma_kernelEPKfPfii", 24, 0),
        ("_ZN48_GLOBAL__N__210f412a_15_gather_probe_cu_7060ba7713gather_kernelEPKiS1_Pixii", 38, 0),
        ("_ZN48_GLOBAL__N__210f412a_15_gather_probe_cu_7060ba7720gather_staged_kernelEPKiS1_Pixiii", 40, 0),
    ))


def test_ptxas_report_names_every_kernel():
    """chip_smoke.py's reading of `nvcc -Xptxas -v`: each of the eight
    kernels of the five libraries under its own name (the build phase
    fails unless it finds all eight), with its registers and frame."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    kernels = cs._ptxas_report(PTXAS_LOG)
    assert {k: (v["registers"], v["stack"]) for k, v in kernels.items()} == {
        "fwd_b0": (80, 48), "fwd_b1": (80, 56), "bwd_fetch": (126, 32), "bwd_direct": (127, 32),
        "bwd_replay": (128, 32), "peak_fma": (24, 0), "gather_probe": (38, 0),
        "gather_probe_staged": (40, 0)}
