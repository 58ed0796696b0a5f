"""Scene layer of the PyTorch port against the JAX package: parser, packed
rows, numpy round trip."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax  # noqa: F401  (kept on the CPU by conftest)
import torch

from ray_tracing_tpu.scene import parser as jparser
from ray_tracing_tpu.scene.types import Scene as JScene

from ray_tracing_tpu_torch.scene import parser as tparser
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT, random_objects
from ray_tracing_tpu_torch.scene.types import Scene as TScene

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

    # one default differs on purpose: the port's sparse sky lookup is opt-in
    # (its tier choice reads a count on the host every sample)
    assert dataclasses.asdict(JCfg()) == {**dataclasses.asdict(TCfg()), "sky_sparse_gather": True}
    assert not TCfg().sky_sparse_gather
    assert TCfg().replace(bounces=3).bounces == 3 and DEFAULT_CONFIG == TCfg()
