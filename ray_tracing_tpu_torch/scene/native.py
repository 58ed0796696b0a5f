"""ctypes binding of the C++ scene parser (native/rt_native.cpp).

Counterpart of ``ray_tracing_tpu/scene/native.py``. The native parser and
the Python one (scene/parser.py) implement one grammar and are held against
each other object for object by the tests. Without the library (no C++
compiler) the Python parser runs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ray_tracing_tpu_torch import native
from ray_tracing_tpu_torch.scene import parser as pyparser
from ray_tracing_tpu_torch.scene.parser import MAX_OBJECTS, SceneParseError
from ray_tracing_tpu_torch.scene.types import OBJ_SPHERE, ObjectSpec, Scene

NCOLS = 16


def parse_objects_native(src: str) -> list[ObjectSpec]:
    """Parse through the C++ library; raises SceneParseError, with the line
    number, on bad input. The Python parser runs when the library is
    unavailable."""
    lib = native.lib()
    if lib is None:
        return pyparser.parse_objects(src)

    data = src.encode()
    params = np.zeros((MAX_OBJECTS, NCOLS), np.float32)
    types = np.zeros((MAX_OBJECTS,), np.int32)
    err = ctypes.create_string_buffer(256)
    n = lib.rt_parse_scene(
        data, len(data),
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        MAX_OBJECTS, err, len(err),
    )
    if n < 0:
        msg = err.value.decode(errors="replace")
        # the native message ends in " (line N)": split it off into the
        # exception's line, as the Python parser reports it
        line = 0
        if msg.endswith(")") and "(line " in msg:
            base, _, tail = msg.rpartition(" (line ")
            line = int(tail[:-1])
            msg = base
        raise SceneParseError(msg, line)

    return [
        ObjectSpec(
            kind="sphere" if types[i] == OBJ_SPHERE else "cube",
            p0=tuple(params[i, 0:3].tolist()),
            p1=tuple(params[i, 3:6].tolist()),
            albedo=tuple(params[i, 6:9].tolist()),
            roughness=float(params[i, 9]),
            reflectance=float(params[i, 10]),
            metallic=float(params[i, 11]),
            emission_power=float(params[i, 15]),
            emission_color=tuple(params[i, 12:15].tolist()),
        )
        for i in range(n)
    ]


def parse_scene_string_native(src: str, device=None) -> Scene:
    """The Scene of `src` on `device`; device=None means the card."""
    return Scene.from_objects(parse_objects_native(src), device=device)


def parse_scene_file_native(path: str, device=None) -> Scene:
    with open(path, "r") as f:
        return parse_scene_string_native(f.read(), device=device)
