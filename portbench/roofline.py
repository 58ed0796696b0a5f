"""The least time the card could take for one launch of a megakernel on
these inputs: the larger of the bytes over the memory rate and the float
operations over the float32 rate, for what the inputs need.

The counts per bounce (lanes alive at its start, lanes that hit, lanes that
hit a sphere, accepted shadow samples of lanes that hit) come from the
plain reference's own forward of the same inputs
(reference/pathtracer.py, `counts`), so the bound reads the same work
whatever implements the kernel. The operation counts per step are those of
the port's device code (csrc/rt_device.cuh, csrc/rt_backward.cuh), as its
chip_smoke.py counts them (`bound`, `bound_bwd`, `trace_flops`).
"""

from __future__ import annotations

# Published peaks of one H100 SXM at 700 W: float32 outside the tensor
# cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

F_RAY = 19          # ray set-up: normalize 10, d.d 5, 0.5/a 1, three reciprocals
F_SPHERE = 24       # a sphere's distance
F_CUBE = 12         # a box's distance: two slab triples
F_OCC_SPHERE = 19   # does a sphere occlude
F_FINISH = 19       # hit point 6 + sphere normal 13
F_SHADE = 114       # shading of a lane that hits
F_LIGHT_BLEND = 19  # to the light 3, mean 4, blend 12
F_ACCEPT = 5        # per shadow sample of a lane that hits
F_SHADOW_RAY = 41   # per shadow ray cast: direction 19, ray 22
F_SHADOW_SUM = 4    # per accepted sample
F_ADJ_COMMON = 50   # backward, per bounce a path hits in
F_ADJ_LIGHT = 27
F_ADJ_BRANCH = 57
F_ADJ_SPHERE = 113
F_ADJ_CUBE = 12
F_ADJ_ROUTE = 15
F_ADJ_MISS = 27
F_ADJ_CAMERA = 30
ROW_BYTES = 16 * 4  # one packed scene row; the camera pack is one more


def per_sample(counts, spp_samples: int) -> dict:
    """Mean per sample of the reference's per-bounce counts: `counts` is the
    list that reference.pathtracer.render filled (one tuple of five device
    scalars per bounce per sample, samples in order)."""
    n = len(counts) // spp_samples
    keys = ("alive", "active", "active_spheres", "shadow_rays", "shadow_taken")
    out = {k: [0.0] * n for k in keys}
    for i, row in enumerate(counts):
        for k, v in zip(keys, row):
            out[k][i % n] += float(v) / spp_samples
    return out


def trace_flops(n_spheres: int, n_cubes: int, light_is_sphere: bool | None) -> tuple:
    """Operations of one closest-hit trace and of one shadow trace. With
    `light_is_sphere` given (one emitter), the shadow trace is the
    occlusion test; None: the full scan."""
    f_trace = F_RAY + n_spheres * F_SPHERE + n_cubes * F_CUBE + F_FINISH
    if light_is_sphere is None:
        f_shadow = F_RAY + n_spheres * F_SPHERE + n_cubes * F_CUBE
    else:
        f_shadow = (F_RAY + (F_SPHERE if light_is_sphere else F_CUBE) + 1
                    + (n_spheres - light_is_sphere) * F_OCC_SPHERE
                    + (n_cubes - (not light_is_sphere)) * F_CUBE)
    return f_trace, f_shadow


def _result(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def forward(stats: dict, pixels: int, n_obj: int, n_spheres: int, bounces: int, ns: int,
            light_is_sphere: bool | None, record: bool) -> dict:
    """One forward sample (K1; K2 with `record`, which writes one index
    plane per trace call and casts every shadow ray of a lane that hits).
    ns = 0: no next-event estimation."""
    f_trace, f_shadow = trace_flops(n_spheres, n_obj - n_spheres, light_is_sphere)
    flops = 0.0
    for b in range(bounces):
        alive, active = stats["alive"][b], stats["active"][b]
        flops += alive * f_trace + active * F_SHADE
        if ns:
            rays = ns * active if record else stats["shadow_rays"][b]
            flops += active * (F_LIGHT_BLEND + ns * F_ACCEPT)
            flops += rays * (F_SHADOW_RAY + f_shadow)
            flops += stats["shadow_rays"][b] * F_SHADOW_SUM
    n_rec = bounces * (1 + ns) if record else 0
    nbytes = n_obj * ROW_BYTES + ROW_BYTES + (10 + n_rec) * pixels * 4
    return _result(flops, nbytes)


def backward_fetch(stats: dict, pixels: int, n_obj: int, bounces: int, ns: int) -> dict:
    """One backward sample from the recorded index planes (K3): the
    gradient's own bytes and operations, a hit replayed from its index."""
    per_live = F_SHADE + F_ADJ_COMMON + F_ADJ_BRANCH + F_ADJ_ROUTE
    if ns:
        per_live += F_LIGHT_BLEND + ns * F_ACCEPT + F_ADJ_LIGHT
    flops = pixels * F_ADJ_CAMERA
    nbytes = 2 * (n_obj * ROW_BYTES + ROW_BYTES) + 3 * 4 * stats["active"][0]
    for b in range(bounces):
        alive, active = stats["alive"][b], stats["active"][b]
        spheres = stats["active_spheres"][b]
        leaving = alive - active
        flops += active * per_live + spheres * F_ADJ_SPHERE + (active - spheres) * F_ADJ_CUBE
        flops += leaving * F_ADJ_MISS
        nbytes += 6 * 4 * leaving
        if ns:
            flops += stats["shadow_rays"][b] * (F_SHADOW_SUM + 3)
        flops += (spheres * (F_RAY + F_SPHERE + F_FINISH)
                  + (active - spheres) * (F_RAY + 6 + F_CUBE) + leaving * F_RAY)
        nbytes += 4 * alive + (4 * stats["shadow_rays"][b] if ns else 0)
    return _result(flops, nbytes)
