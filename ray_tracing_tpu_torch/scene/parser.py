"""Scene DSL parser of the port: a Python scanner, no tensor library needed
until the ObjectSpecs are packed into a Scene.

Counterpart of ``ray_tracing_tpu/scene/parser.py``; it accepts and rejects
the same texts with the same line-numbered messages.

Grammar:

    scene    := object*
    object   := ("sphere" | "cube") property*
    property := name value
    value    := number | "{" number number number "}"
    number   := "-"? digit+ ("." digit+)?        # no exponents, no leading dot

Quirks of the reference renderer's parser that are kept on purpose:

* After the property names ``albedo`` and ``metallic`` the cursor advances
  by 3 more characters than the name is long, whatever they are. A value
  with fewer than 3 spaces after those names loses its leading characters
  ("metallic 1.0000" parses as metallic=0).
* Whitespace is space, CR, tab and LF only.
* albedo / emission_color components and roughness / reflectance / metallic
  must lie in [0,1]; cube size components must be >= 0.
* radius/center belong to spheres only, origin/size to cubes only.
* Objects beyond MAX_OBJECTS are dropped with a warning.

``write_scene_string`` goes the other way, from ObjectSpecs to a text that
parses back to the same float32 scene.
"""

from __future__ import annotations

import sys

import numpy as np

from ray_tracing_tpu_torch.scene.types import (
    DEFAULT_CUBE_ORIGIN,
    DEFAULT_CUBE_SIZE,
    ObjectSpec,
    Scene,
)

MAX_OBJECTS = 1024

_SPACE = " \r\t\n"

# name -> (is_vector, sphere_only, cube_only, extra_skip)
_PROPERTIES = {
    "albedo": (True, False, False, 3),
    "roughness": (False, False, False, 0),
    "reflectance": (False, False, False, 0),
    "metallic": (False, False, False, 3),
    "emission_power": (False, False, False, 0),
    "emission_color": (True, False, False, 0),
    "radius": (False, True, False, 0),
    "center": (True, True, False, 0),
    "origin": (True, False, True, 0),
    "size": (True, False, True, 0),
}


def _is_digit(c: str) -> bool:
    """ASCII digits only: str.isdigit also accepts Unicode digit-likes that
    float() may then refuse."""
    return "0" <= c <= "9"


class SceneParseError(ValueError):
    def __init__(self, message: str, line: int):
        super().__init__(f"{message} (line {line})")
        self.line = line


class _Scanner:
    __slots__ = ("src", "i", "line")

    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.line = 1

    def eof(self) -> bool:
        return self.i >= len(self.src)

    def peek(self) -> str:
        return self.src[self.i] if self.i < len(self.src) else ""

    def skip_spaces(self) -> None:
        src, i, n = self.src, self.i, len(self.src)
        while i < n and src[i] in _SPACE:
            if src[i] == "\n":
                self.line += 1
            i += 1
        self.i = i

    def skip_raw(self, count: int) -> None:
        """Advance exactly `count` characters whatever they are (the
        albedo/metallic cursor quirk); newlines among them still count."""
        src, i, n = self.src, self.i, len(self.src)
        end = min(n, i + count)
        while i < end:
            if src[i] == "\n":
                self.line += 1
            i += 1
        self.i = i

    def match_word(self, word: str) -> bool:
        if self.src.startswith(word, self.i):
            self.i += len(word)
            return True
        return False

    def parse_number(self, what: str) -> float:
        """-?digits(.digits)?"""
        src, n = self.src, len(self.src)
        sign = 1.0
        if self.peek() == "-":
            sign = -1.0
            self.i += 1
            if self.eof() or not _is_digit(src[self.i]):
                raise SceneParseError("Error: Missing number after minus sign", self.line)
        elif self.eof() or not _is_digit(src[self.i]):
            raise SceneParseError(f"Error: Missing number {what}", self.line)

        start = self.i
        i = self.i
        while i < n and _is_digit(src[i]):
            i += 1
        if i < n and src[i] == ".":
            i += 1
            if i == n or not _is_digit(src[i]):
                self.i = i
                raise SceneParseError("Error: Missing decimal part after dot", self.line)
            while i < n and _is_digit(src[i]):
                i += 1
        self.i = i
        return sign * float(src[start:i])

    def parse_vector(self) -> tuple:
        if self.peek() != "{":
            raise SceneParseError("Error: Missing '{' after property name", self.line)
        self.i += 1
        vals = []
        for j in range(3):
            self.skip_spaces()
            vals.append(self.parse_number(f"{j} in vector value"))
        self.skip_spaces()
        if self.eof() or self.peek() != "}":
            raise SceneParseError("Error: Missing '}' after property value", self.line)
        self.i += 1
        return tuple(vals)


def _check_unit_range(name: str, v, line: int) -> None:
    vals = v if isinstance(v, tuple) else (v,)
    if any(x < 0 or x > 1 for x in vals):
        raise SceneParseError(f"Error: {name} values must be between 0 and 1", line)


def _warn_stderr(msg: str) -> None:
    print(msg, file=sys.stderr)


def parse_objects(src: str, warn=None) -> list[ObjectSpec]:
    """Parse the DSL into a list of ObjectSpecs (host side)."""
    if warn is None:
        warn = _warn_stderr

    s = _Scanner(src)
    objects: list[ObjectSpec] = []

    while True:
        s.skip_spaces()
        if s.eof():
            break

        if s.match_word("sphere"):
            obj = ObjectSpec(kind="sphere")
        elif s.match_word("cube"):
            obj = ObjectSpec(kind="cube", p0=DEFAULT_CUBE_ORIGIN, p1=DEFAULT_CUBE_SIZE)
        else:
            raise SceneParseError("Error: Invalid character", s.line)

        while True:  # properties of this object
            s.skip_spaces()
            prop = None
            for name, meta in _PROPERTIES.items():
                if s.src.startswith(name, s.i):
                    prop, (is_vec, sphere_only, cube_only, extra) = name, meta
                    s.i += len(name)
                    s.skip_raw(extra)
                    break
            if prop is None:
                break  # not a property name: next object or end of text

            if sphere_only and obj.kind != "sphere":
                raise SceneParseError(f"Property '{prop}' only allowed on spheres", s.line)
            if cube_only and obj.kind != "cube":
                raise SceneParseError(f"Property '{prop}' only allowed on cubes", s.line)

            s.skip_spaces()
            if s.eof():
                raise SceneParseError("Error: Property value is missing", s.line)

            if is_vec:
                value = s.parse_vector()
            else:
                value = s.parse_number("after property name")

            line = s.line
            if prop == "albedo":
                _check_unit_range("albedo", value, line)
                obj.albedo = value
            elif prop == "roughness":
                _check_unit_range("Roughness", value, line)
                obj.roughness = value
            elif prop == "reflectance":
                _check_unit_range("Reflectance", value, line)
                obj.reflectance = value
            elif prop == "metallic":
                _check_unit_range("Metallic", value, line)
                obj.metallic = value
            elif prop == "emission_power":
                obj.emission_power = value
            elif prop == "emission_color":
                _check_unit_range("Emission color", value, line)
                obj.emission_color = value
            elif prop == "radius":
                obj.p1 = (value, value, value)
            elif prop in ("center", "origin"):
                obj.p0 = value
            elif prop == "size":
                if any(x < 0 for x in value):
                    raise SceneParseError("Error: Size values must be positive", line)
                obj.p1 = value

        if len(objects) >= MAX_OBJECTS:
            warn(f"Warning: Ignoring object because the scene is too big (line {s.line})")
        else:
            objects.append(obj)

    return objects


def parse_scene_string(src: str, device=None) -> Scene:
    """Parse the DSL text into a Scene whose tensors lie on `device`;
    device=None means the card. A text that does not parse raises its
    SceneParseError before the device is looked at."""
    return Scene.from_objects(parse_objects(src), device=device)


def _fixed(x: float) -> str:
    """`x` rounded to float32, in fixed point (the language has no
    exponents): the fewest digits that name that float32, or, where
    reading them as a double and rounding that to float32 lands elsewhere,
    the double's own shortest digits, which name the float32 exactly."""
    v = np.float32(x)
    if not np.isfinite(v):
        raise ValueError(f"{x} has no fixed-point form")
    text = np.format_float_positional(v, unique=True, trim="-")
    if np.float32(float(text)) != v:
        text = np.format_float_positional(np.float64(v), unique=True, trim="-")
    return text


def _value(v) -> str:
    if isinstance(v, (tuple, list)):
        return "{" + " ".join(_fixed(x) for x in v) + "}"
    return _fixed(v)


def _same(a, b) -> bool:
    """Whether two values are one float32 value (componentwise)."""
    return bool(np.array_equal(np.float32(a), np.float32(b)))


# Material properties in the order written, with their names as written:
# the parser skips 3 characters after "albedo" and "metallic" whatever they
# are, so those names take 4 spaces.
_WRITTEN = (("albedo", "albedo    "), ("roughness", "roughness "),
            ("reflectance", "reflectance "), ("metallic", "metallic    "),
            ("emission_power", "emission_power "), ("emission_color", "emission_color "))


def write_scene_string(objects: list[ObjectSpec]) -> str:
    """The scene text of `objects`, one line an object: its geometry, then
    each material value that differs from the parser's default. Every
    number parses back to the float32 that Scene.from_objects makes of it,
    so parse_scene_string of the text packs the same scene bit for bit."""
    defaults = ObjectSpec(kind="sphere")
    lines = []
    for o in objects:
        if o.kind == "sphere":
            if not (_same(o.p1[0], o.p1[1]) and _same(o.p1[0], o.p1[2])):
                raise ValueError(f"a sphere takes one radius, not {o.p1}")
            words = ["sphere", "center", _value(o.p0), "radius", _value(o.p1[0])]
        elif o.kind == "cube":
            words = ["cube", "origin", _value(o.p0), "size", _value(o.p1)]
        else:
            raise ValueError(f"unknown object kind {o.kind!r}")
        for field, name in _WRITTEN:
            v = getattr(o, field)
            if not _same(v, getattr(defaults, field)):
                words.append(name + _value(v))
        lines.append(" ".join(words))
    return "".join(line + "\n" for line in lines)


def parse_scene_file(path: str, device=None) -> Scene:
    with open(path, "r") as f:
        return parse_scene_string(f.read(), device=device)
