"""The port's native layer (ray_tracing_tpu_torch/native, scene/native.py)
against the JAX package: the C++ parser object for object against the JAX
package's Python parser, the PNG writer, the event queue. Mirrors
tests/test_native.py without the cases that read the reference's files."""

import ctypes
import os
import time

import numpy as np
import pytest
import torch

from ray_tracing_tpu.io.image import save_png as j_save_png
from ray_tracing_tpu.scene import parser as jparser

from ray_tracing_tpu_torch import native
from ray_tracing_tpu_torch.io.image import read_png, save_png, to_uint8
from ray_tracing_tpu_torch.kernels.build import BUILD_DIR
from ray_tracing_tpu_torch.scene import native as tnative
from ray_tracing_tpu_torch.scene.native import (
    parse_objects_native,
    parse_scene_file_native,
    parse_scene_string_native,
)
from ray_tracing_tpu_torch.scene.parser import SceneParseError, parse_scene_string
from ray_tracing_tpu_torch.scene.synthetic import ROOM_TEXT, SCENE_2_TEXT

EVENT_EMPTY, EVENT_PRESS_SPACE, EVENT_PRESS_ESC = 0, 2, 3
EVENT_PRESS_W, EVENT_PRESS_D, EVENT_MOVE_MOUSE = 4, 7, 8


@pytest.fixture(scope="module")
def lib():
    l = native.lib()
    if l is None:
        pytest.skip("no C++ compiler available")
    return l


def objects_array(specs):
    """(kinds, (N, 16) float32): the objects as the float32 rows a Scene
    holds, so that two parsers compare exactly."""
    kinds = [o.kind for o in specs]
    rows = np.array([[*o.p0, *o.p1, *o.albedo, o.roughness, o.reflectance, o.metallic,
                      *o.emission_color, o.emission_power] for o in specs], np.float32)
    return kinds, rows.reshape(-1, 16)


def assert_objects_equal(got, want):
    gk, gr = objects_array(got)
    wk, wr = objects_array(want)
    assert gk == wk
    np.testing.assert_array_equal(gr, wr)


def generated_corpus(seed: int = 0, n: int = 50) -> str:
    """The generated corpus of tests/test_native.py: spheres with every
    property, cubes with negative origins, 3-space gaps after albedo and
    metallic."""
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(n):
        if i % 2 == 0:
            chunks.append(
                f"sphere radius {rng.uniform(0.1, 5):.3f} center "
                f"{{{rng.uniform(-9, 9):.3f} {rng.uniform(-9, 9):.3f} {rng.uniform(-9, 9):.3f}}} "
                f"albedo    {{{rng.uniform(0,1):.3f} {rng.uniform(0,1):.3f} {rng.uniform(0,1):.3f}}} "
                f"roughness {rng.uniform(0,1):.3f} metallic    {rng.uniform(0,1):.3f} "
                f"emission_power {rng.uniform(0, 8):.3f}"
            )
        else:
            chunks.append(
                f"cube origin {{{rng.uniform(-9, 9):.3f} -{rng.uniform(0, 9):.3f} "
                f"{rng.uniform(-9, 9):.3f}}} "
                f"size {{{rng.uniform(0, 5):.3f} {rng.uniform(0, 5):.3f} {rng.uniform(0, 5):.3f}}} "
                f"reflectance {rng.uniform(0,1):.3f} emission_color {{0.5 0.25 1}}"
            )
    return "\n".join(chunks)


def test_library_is_built_into_the_ports_own_build_directory(lib):
    assert native.LIB_PATH.parent == BUILD_DIR
    assert native.LIB_PATH.is_file()
    assert native.LIB_PATH.stat().st_mtime >= native.SOURCE.stat().st_mtime
    assert native.SOURCE.parent.name == "native" and native.SOURCE.is_file()


@pytest.mark.parametrize("text", [SCENE_2_TEXT, ROOM_TEXT, generated_corpus(0),
                                  generated_corpus(1, 200)],
                         ids=["scene_2", "room", "corpus_50", "corpus_200"])
def test_native_parser_equals_jax_python_parser(lib, text):
    """Exact: the same kinds and the same float32 rows."""
    assert_objects_equal(parse_objects_native(text), jparser.parse_objects(text))


@pytest.mark.parametrize("text,match,line", [
    ("pyramid", "Invalid character", 1),
    ("sphere radius -", "minus sign", 1),
    ("cube radius 1", "radius", 1),
    ("sphere\n\nbogus", "Invalid character", 3),
    ("sphere\n radius 1.", "decimal part", 2),
    ("sphere albedo   {1 2 0}", "albedo", 1),
    ("cube\n\n\n size {1 -1 1}", "positive", 4),
    ("sphere center {1 2", "Missing number", 1),
])
def test_native_parser_errors_match_jax(lib, text, match, line):
    """The same texts are refused, on the same line, by both parsers."""
    with pytest.raises(jparser.SceneParseError) as want:
        jparser.parse_objects(text)
    with pytest.raises(SceneParseError, match=match) as got:
        parse_objects_native(text)
    assert got.value.line == want.value.line == line


def test_scene_on_an_explicit_device(lib, tmp_path):
    scene = parse_scene_string_native(ROOM_TEXT, device="cpu")
    want = parse_scene_string(ROOM_TEXT, device="cpu")
    assert scene.device == torch.device("cpu")
    assert scene.obj_type == want.obj_type and scene.light_index == want.light_index
    assert scene.packed_rows().equal(want.packed_rows())
    path = tmp_path / "room.txt"
    path.write_text(ROOM_TEXT)
    assert parse_scene_file_native(str(path), device="cpu").packed_rows().equal(
        want.packed_rows())


def test_python_parser_runs_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "lib", lambda: None)
    assert_objects_equal(tnative.parse_objects_native(ROOM_TEXT),
                         jparser.parse_objects(ROOM_TEXT))
    with pytest.raises(SceneParseError) as e:
        tnative.parse_objects_native("sphere\n\nbogus")
    assert e.value.line == 3


@pytest.mark.parametrize("flip", [True, False])
def test_native_png_equals_jax_png(lib, tmp_path, flip):
    """The native writer's file decodes (through PIL and through read_png)
    to the pixels the JAX package's PIL writer stores."""
    from PIL import Image

    img = np.random.default_rng(1).uniform(0, 1, (33, 47, 3)).astype(np.float32)
    ours, theirs = tmp_path / "native.png", tmp_path / "jax.png"
    save_png(img, ours, flip_vertically=flip, use_native=True)
    j_save_png(img, theirs, flip_vertically=flip, use_native=False)
    with Image.open(theirs) as im:
        want = np.asarray(im.convert("RGB"))
    with Image.open(ours) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)
    np.testing.assert_array_equal(read_png(ours), want)
    expect = to_uint8(img)
    np.testing.assert_array_equal(want, expect[::-1] if flip else expect)


def test_native_event_queue(lib):
    """FIFO ring (src/gpu_and_windowing.c:220-246)."""
    lib.rt_events_stop()
    assert lib.rt_events_pop() == EVENT_EMPTY
    lib.rt_events_inject(EVENT_PRESS_W)
    lib.rt_events_inject(EVENT_PRESS_SPACE)
    assert lib.rt_events_pop() == EVENT_PRESS_W
    assert lib.rt_events_pop() == EVENT_PRESS_SPACE
    assert lib.rt_events_pop() == EVENT_EMPTY


def test_native_event_reader_thread(lib):
    """A pipe fed to the reader thread like a terminal."""
    r, w = os.pipe()
    try:
        assert lib.rt_events_start(r) == 0
        os.write(w, b"wdq")
        deadline = time.time() + 30
        got = []
        while time.time() < deadline and len(got) < 3:
            ev = lib.rt_events_pop()
            if ev:
                got.append(ev)
            else:
                time.sleep(0.01)
    finally:
        lib.rt_events_stop()
        os.close(w)
        os.close(r)
    assert got == [EVENT_PRESS_W, EVENT_PRESS_D, EVENT_PRESS_ESC]


def _mouse(lib):
    x, y = ctypes.c_double(), ctypes.c_double()
    lib.rt_mouse_pos(ctypes.byref(x), ctypes.byref(y))
    return x.value, y.value


def test_native_sgr_mouse_parse(lib):
    """SGR-1006 motion reports -> EVENT_MOVE_MOUSE with the coordinates
    fetched after it; arrows through the general CSI path."""
    lib.rt_events_stop()
    data = b"\x1b[<35;100;50M\x1b[<35;110;45Mw\x1b[<0;5;5M"
    lib.rt_events_parse(data, len(data))
    assert [lib.rt_events_pop() for _ in range(4)] == [EVENT_MOVE_MOUSE, EVENT_MOVE_MOUSE,
                                                       EVENT_PRESS_W, EVENT_EMPTY]
    assert _mouse(lib) == (110.0, 45.0)
    data = b"\x1b[A\x1b[D"
    lib.rt_events_parse(data, len(data))
    assert [lib.rt_events_pop() for _ in range(3)] == [20, 22, EVENT_EMPTY]


def test_native_x10_mouse_parse(lib):
    """X10 reports (ESC [ M + 3 raw bytes) are mouse data: the printable
    payload never reaches the key switch."""
    lib.rt_events_stop()
    data = (bytes([0x1B, ord("["), ord("M"), 32 + 35, 32 + 81, 32 + 17]) + b"w"
            + bytes([0x1B, ord("["), ord("M"), 32 + 0, 32 + 1, 32 + 1]))
    lib.rt_events_parse(data, len(data))
    assert [lib.rt_events_pop() for _ in range(3)] == [EVENT_MOVE_MOUSE, EVENT_PRESS_W,
                                                       EVENT_EMPTY]
    assert _mouse(lib) == (81.0, 17.0)
