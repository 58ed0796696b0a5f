"""Render configuration of the PyTorch/CUDA port.

Counterpart of ``ray_tracing_tpu/config.py``: the same fields with the same
defaults, so a configuration written for one package reads the same in the
other. The reference renderer hard-codes every physics constant (10 bounces,
3 shadow samples with spread 0.5, light weight 0.05, hit offset 1e-3, fov 30
passed to ``tan`` in degrees); this dataclass exposes them.

``RenderConfig`` is frozen and hashable. Its fields select loop lengths and
sampling modes; they are passed to the CUDA kernel as plain scalars, so one
compiled kernel serves every configuration.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Parameters of the path tracer; defaults reproduce the reference.

    * ``fov_degrees_bug=True`` keeps ``screen_h = 2*tan(fov/2)`` evaluated
      with ``fov`` in degrees handed to ``tan`` as radians: ``2*tan(15)`` is
      about -1.712, a negative screen height that flips the image.
    * ``cube_biased_sampling=True`` draws random directions by normalising a
      uniform point of the [-1,1]^3 cube (biased toward the corners).
    """

    # Path tracing
    bounces: int = 10
    shadow_samples: int = 3
    shadow_spread: float = 0.5
    light_sample_weight: float = 0.05
    hit_offset: float = 1e-3

    # Camera
    fov: float = 30.0
    fov_degrees_bug: bool = True
    move_speed: float = 0.5
    mouse_sensitivity: float = 0.1

    # Sampling
    cube_biased_sampling: bool = True
    # Each sample jitters u/v uniformly inside the pixel footprint.
    pixel_jitter: bool = False

    # "nearest" is faithful to the reference; "bilinear" is the smooth
    # filter of the differentiable mode.
    env_filter: str = "nearest"  # "nearest" | "bilinear"

    # The fields below belong to machinery that later slices of the port
    # bring over (the backward kernels, the sparse sky cache, soft
    # silhouettes, the progressive viewer). They are kept so that
    # configurations stay interchangeable between the two packages.
    bwd_mode: str = "fetch"  # "fetch" | "replay" | "direct"
    sky_sparse_gather: bool = True
    sky_sparse_budget_frac: float = 0.125
    # A non-zero value raises NotImplementedError in the renderers for now.
    soft_silhouette_temp: float = 0.0
    init_scale: int = 8

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
