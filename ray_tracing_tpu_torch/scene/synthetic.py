"""Scenes that need no file: the three-sphere scene_2, a nine-object lit
room, the four-object scene of the pose search, and seeded random scenes of
any size.

They serve the tests, the smoke script and anyone who wants a render
without writing a scene file first.
"""

from __future__ import annotations

import numpy as np

from ray_tracing_tpu_torch.scene.types import ObjectSpec

# The reference renderer's scene_2: three unit spheres in a row, no light.
SCENE_2_TEXT = (
    "sphere reflectance 1 roughness 0 albedo    {0.2 0.5 1} center {-3 0 0}\n"
    "sphere reflectance 0 roughness 0 albedo    {0.2 0.5 1} center {0 0 0}\n"
    "sphere metallic    1 roughness 0 albedo    {0.5 0.2 1} center {3 0 0}\n"
)

# A room of six cubes and three spheres, one of them the only light: next
# event estimation runs, through the occlusion-only shadow trace.
ROOM_TEXT = """\
cube origin {-8 -1.5 -8} size {16 0.5 16} albedo    {0.55 0.35 0.75} roughness 0.9
cube origin {-8.5 -1 -8} size {0.5 8 16} albedo    {0.8 0.8 0.8} roughness 1
cube origin {-8 -1 -8.5} size {16 8 0.5} albedo    {0.8 0.75 0.6} roughness 1
cube origin {-3.5 -1 -1} size {1.5 1.5 1.5} albedo    {0.9 0.3 0.2} roughness 0.6
cube origin {1 -1 -3.5} size {1 2.5 1} albedo    {0.2 0.7 0.3} roughness 0.3 reflectance 0.6
cube origin {-1 -1 2} size {2 0.7 1} albedo    {0.9 0.8 0.2} metallic    1 roughness 0.2
sphere center {0 0 0} radius 1 albedo    {0.2 0.5 1} reflectance 1
sphere center {0 5 0} radius 1 emission_power 10 emission_color {1 0.95 0.85}
sphere center {2.5 -0.3 1.5} radius 0.7 albedo    {0.5 0.2 1} metallic    1 roughness 0.1
"""

# Distinctly coloured diffuse objects at distinct offsets over a dark floor
# (tests/test_pose_search.py's scene): every viewing side sees another
# arrangement of colours, which a mirror-symmetric scene would not give the
# pose search (apps/pose_recovery.py).
POSE_SEARCH_TEXT = """\
sphere
\temission_color {0 0 0}
\temission_power 0
\tmetallic       0
\treflectance    0
\troughness      1
\talbedo         {0.9 0.1 0.1}
\tcenter         {-1.5 0 0}
\tradius         0.8

cube
\temission_color {0 0 0}
\temission_power 0
\tmetallic       0
\treflectance    0
\troughness      1
\talbedo         {0.1 0.8 0.1}
\torigin         {0.5 -0.6 0.4}
\tsize           {1.2 1.2 1.2}

sphere
\temission_color {0 0 0}
\temission_power 0
\tmetallic       0
\treflectance    0
\troughness      1
\talbedo         {0.15 0.25 0.9}
\tcenter         {0.2 1.1 -1.3}
\tradius         0.55

cube
\temission_color {0 0 0}
\temission_power 0
\tmetallic       0
\treflectance    0
\troughness      1
\talbedo         {0.25 0.2 0.15}
\torigin         {-3 -1 -3}
\tsize           {6 0.2 6}
"""


def random_objects(n: int, seed: int = 1, lights=(7,)) -> list[ObjectSpec]:
    """`n` seeded random objects, every third one a cube; the objects whose
    index is in `lights` emit. Two or more lights force the full shadow
    scan; exactly one takes the occlusion-only trace."""
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n):
        if i % 3 == 0:
            objs.append(ObjectSpec(
                kind="cube",
                p0=tuple(float(x) for x in rng.uniform(-6, 6, 3)),
                p1=tuple(float(x) for x in rng.uniform(0.5, 2.0, 3)),
                albedo=tuple(float(x) for x in rng.uniform(0.2, 1, 3)),
                roughness=float(rng.uniform()),
                emission_power=1.5 if i in lights else 0.0,
            ))
        else:
            objs.append(ObjectSpec(
                kind="sphere",
                p0=tuple(float(x) for x in rng.uniform(-6, 6, 3)),
                p1=(float(rng.uniform(0.4, 1.2)),) * 3,
                albedo=tuple(float(x) for x in rng.uniform(0.2, 1, 3)),
                roughness=float(rng.uniform()),
                reflectance=float(rng.uniform()),
                metallic=float(rng.uniform() < 0.2),
                emission_power=2.0 if i in lights else 0.0,
            ))
    return objs
