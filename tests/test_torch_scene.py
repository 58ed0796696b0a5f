"""Scene layer of the PyTorch port against the JAX package: parser, packed
rows, numpy round trip, the scene writer and the 1,024-object scene of the
benchmark's largest cell."""

import dataclasses
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax  # noqa: F401  (kept on the CPU by conftest)
import torch

from ray_tracing_tpu.scene import parser as jparser
from ray_tracing_tpu.scene.types import Scene as JScene

from ray_tracing_tpu_torch.scene import parser as tparser
from ray_tracing_tpu_torch.scene.synthetic import (
    ROOM_TEXT,
    SCENE_2_TEXT,
    large_scene_objects,
    random_objects,
)
from ray_tracing_tpu_torch.scene.types import ObjectSpec as TObjectSpec, Scene as TScene

import torch_port_util as U


def _parse_both(src):
    """(kind, payload) from each parser: ("ok", specs as dicts) or
    ("err", (line, message))."""
    out = []
    for mod in (jparser, tparser):
        warnings = []
        try:
            objs = mod.parse_objects(src, warn=warnings.append)
            out.append(("ok", [dataclasses.asdict(o) for o in objs], warnings))
        except ValueError as e:  # both SceneParseErrors derive from it
            out.append(("err", (e.line, str(e)), warnings))
    return out


@pytest.mark.parametrize("text,n,light", [(SCENE_2_TEXT, 3, -1), (ROOM_TEXT, 9, 7)])
def test_parser_matches_jax_on_builtin_scenes(text, n, light):
    j, t = _parse_both(text)
    assert j == t and j[0] == "ok" and len(j[1]) == n
    js = jparser.parse_scene_string(text)
    ts = tparser.parse_scene_string(text, device="cpu")
    assert ts.obj_type == js.obj_type
    assert ts.light_index == js.light_index == light
    assert ts.emissive == js.emissive
    np.testing.assert_array_equal(ts.packed_rows().numpy(), np.asarray(js.packed_rows()))
    assert ts.packed_rows().dtype == torch.float32 and ts.packed_rows().shape == (n, 16)


@pytest.mark.parametrize("src,line", [
    ("sphere\n  radius x", 2),
    ("sphere\ncube\n center {0 0 0}", 3),
    ("sphere\n\n\n albedo    {0 2 0}", 4),
    ("cube size {1 -1 1}", 1),
    ("sphere radius 1.", 1),
    ("sphere center {1 2", 1),
    ("ball", 1),
    ("sphere metallic\n\n\n", 4),
])
def test_parser_error_lines_match_jax(src, line):
    j, t = _parse_both(src)
    assert j == t
    assert t[0] == "err" and t[1][0] == line


_NUM = st.one_of(
    st.integers(-9, 9).map(str),
    st.floats(-9, 9, allow_nan=False).map(lambda x: f"{x:.3f}"),
    st.sampled_from(["0", "1", "0.5", "-", "1.", ".5", "1e3", "x"]),
)
_VEC = st.one_of(
    st.tuples(_NUM, _NUM, _NUM).map(lambda t: "{" + " ".join(t) + "}"),
    st.sampled_from(["{1 2}", "{1 2 3", "1 2 3}", "{}"]),
)
_SP = st.sampled_from([" ", "  ", "   ", "    ", "\n", "\t", " \n ", ""])
_PROP = st.one_of(
    st.tuples(st.sampled_from(["albedo", "emission_color", "center", "origin", "size"]), _SP, _VEC),
    st.tuples(st.sampled_from(
        ["roughness", "reflectance", "metallic", "emission_power", "radius"]), _SP, _NUM),
).map(lambda t: t[0] + t[1] + t[2])
_OBJ = st.tuples(
    st.sampled_from(["sphere", "cube", "cube", "sphere", "tube"]),
    st.lists(st.tuples(_SP, _PROP), max_size=4),
).map(lambda t: t[0] + "".join(sp + p for sp, p in t[1]))
_DSL = st.lists(st.tuples(_OBJ, _SP), max_size=4).map(
    lambda objs: "".join(o + (sp or "\n") for o, sp in objs)
)


@settings(max_examples=300, deadline=None)
@given(_DSL)
def test_parser_matches_jax_on_generated_dsl(src):
    j, t = _parse_both(src)
    assert j == t
    if t[0] == "ok" and t[1]:
        js = JScene.from_objects(jparser.parse_objects(src))
        ts = TScene.from_objects(tparser.parse_objects(src), device="cpu")
        np.testing.assert_array_equal(ts.packed_rows().numpy(), np.asarray(js.packed_rows()))
        assert (ts.obj_type, ts.light_index, ts.emissive) == (
            js.obj_type, js.light_index, js.emissive)


def test_max_objects_drop_with_warning():
    src = "sphere\n" * (tparser.MAX_OBJECTS + 2)
    j, t = _parse_both(src)
    assert j == t
    assert len(t[1]) == tparser.MAX_OBJECTS == jparser.MAX_OBJECTS and len(t[2]) == 2


@pytest.mark.parametrize("n,lights", [(9, (7,)), (60, (7, 20))])
def test_compat_scene_round_trip(n, lights):
    specs = random_objects(n, seed=1, lights=lights)
    js, ts = U.scene_pair(specs)
    via = U.scene_to_torch(js)
    want = np.asarray(js.packed_rows())
    np.testing.assert_array_equal(via.packed_rows().numpy(), want)
    np.testing.assert_array_equal(ts.packed_rows().numpy(), want)
    assert via.obj_type == js.obj_type and via.light_index == js.light_index
    assert via.emissive == js.emissive
    assert [dataclasses.asdict(o) for o in via.to_objects()] == [
        dataclasses.asdict(o) for o in js.to_objects()]
    # light_origin_from: sphere center, cube origin + size / 2
    for i in (0, 1):
        np.testing.assert_array_equal(
            U.vec_np(via.origin_of(i)), U.vec_np(js.origin_of(i)))


def test_compat_rejects_bad_shapes():
    from ray_tracing_tpu_torch import compat

    js, _ = U.scene_pair(random_objects(4))
    leaves = {k: np.asarray(getattr(js, k)) for k in U.SCENE_LEAVES}
    leaves["p0"] = leaves["p0"][:3]
    with pytest.raises(ValueError):
        compat.scene_from_numpy(leaves, js.obj_type, js.light_index, device="cpu")


def test_config_fields_match_jax():
    from ray_tracing_tpu.config import RenderConfig as JCfg
    from ray_tracing_tpu_torch.config import DEFAULT_CONFIG, RenderConfig as TCfg

    # the port has no sparse sky lookup: the JAX package's two fields of it
    # are the only ones it lacks
    jax_only = {"sky_sparse_gather": True, "sky_sparse_budget_frac": 0.125}
    assert dataclasses.asdict(JCfg()) == {**dataclasses.asdict(TCfg()), **jax_only}
    assert not set(jax_only) & {f.name for f in dataclasses.fields(TCfg)}
    assert TCfg().replace(bounces=3).bounces == 3 and DEFAULT_CONFIG == TCfg()


# -- the benchmark's 1,024-object scene and the scene writer -----------------

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_large_scene(n):
    """benchmarks/large_scene.py::make_scene(n), the JAX package's own
    layout of the scene the upstream's MAX_OBJECTS exists for."""
    spec = importlib.util.spec_from_file_location("large_scene_benchmark",
                                                  REPO / "benchmarks" / "large_scene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_scene(n)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _assert_same_scene(a, b):
    """Two packed scenes (either package's) equal field by field, bit for
    bit, with the same kinds, light and emitters."""
    assert a.obj_type == b.obj_type and a.light_index == b.light_index
    assert tuple(a.emissive) == tuple(b.emissive)
    for f in U.SCENE_LEAVES:
        x, y = getattr(a, f), getattr(b, f)
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f)


@pytest.mark.parametrize("n", [64, 1024])
def test_large_scene_objects_equal_the_jax_benchmarks_scene(n):
    objs = large_scene_objects(n)
    assert len(objs) == n and sum(o.emission_power > 0 for o in objs) == 1
    _assert_same_scene(TScene.from_objects(objs, device="cpu"), _jax_large_scene(n))


@pytest.mark.parametrize("make", [lambda: large_scene_objects(64), lambda: large_scene_objects(1024),
                                  lambda: tparser.parse_objects(ROOM_TEXT),
                                  lambda: random_objects(60, seed=4, lights=(7, 20))],
                         ids=["large64", "large1024", "room", "random60"])
def test_written_scene_parses_back_bit_for_bit(make):
    """write_scene_string's text packs the same float32 scene through the
    port's parser, the JAX package's parser and the benchmark's plain
    reference (portbench/reference/pathtracer.py::parse_scene)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from portbench.reference import pathtracer as pt

    objs = make()
    text = tparser.write_scene_string(objs)
    want = TScene.from_objects(objs, device="cpu")
    _assert_same_scene(tparser.parse_scene_string(text, device="cpu"), want)
    _assert_same_scene(JScene.from_objects(jparser.parse_objects(text)), want)
    ref = pt.make_scene(text, "cpu")
    assert ref.is_sphere == tuple(t == 1 for t in want.obj_type) and ref.light == want.light_index
    for f in U.SCENE_LEAVES:
        np.testing.assert_array_equal(_bits(ref.fields[f]), _bits(getattr(want, f).numpy()),
                                      err_msg=f)


@pytest.mark.parametrize("number", [0.1, -15.0, 1e-7, 2.5e-30, 14.999999, 1 / 3, -0.0, 1234567.0])
def test_written_numbers_are_fixed_point_and_name_their_float32(number):
    text = tparser.write_scene_string([TObjectSpec(kind="sphere", p1=(number,) * 3)])
    radius = text.split("radius ")[1].split()[0]
    assert "e" not in radius.lower() and not radius.startswith(".")
    assert _bits(float(radius)) == _bits(number)


def test_the_writer_refuses_what_the_language_cannot_say():
    with pytest.raises(ValueError, match="one radius"):
        tparser.write_scene_string([TObjectSpec(kind="sphere", p1=(1.0, 2.0, 1.0))])
    with pytest.raises(ValueError, match="fixed-point"):
        tparser.write_scene_string([TObjectSpec(kind="cube", p0=(float("inf"), 0, 0))])


def test_objects1024_config_holds_the_written_large_scene():
    """The benchmark's objects1024 configuration renders the writer's text of
    large_scene_objects(1024), and nothing else of it is cut."""
    conf = json.loads((REPO / "portbench" / "configs" / "objects1024.json").read_text())
    assert conf["scene"] == tparser.write_scene_string(large_scene_objects(1024))
    assert (conf["width"], conf["height"], conf["reduced"]) == (1920, 1080, [])
