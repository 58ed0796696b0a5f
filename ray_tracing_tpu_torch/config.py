"""Render configuration of the PyTorch/CUDA port.

Counterpart of ``ray_tracing_tpu/config.py``: the same fields with the same
defaults, so a configuration written for one package reads the same in the
other, but for the two fields of the JAX package's sparse sky lookup, which
the port does not have: it looks the sky up in full every sample. The
reference renderer hard-codes every physics constant (10 bounces,
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

    # Backward pass under grad (kernels/megakernel.py::backward_kernel).
    # "fetch": the forward records one winner index per trace call and
    #   sample (int8 up to 127 objects, int16 above: kernels/megakernel.py::
    #   record_dtype), kept until backward(), and the backward kernel replays
    #   the paths from them; past FETCH_RECORD_BUDGET_BYTES of those planes
    #   render_image_cuda runs "replay" instead (effective_bwd_mode).
    # "replay": the forward keeps nothing; the backward kernel traces each
    #   path again, keeps every call's winner in the thread and replays the
    #   adjoint from them (the least memory).
    # "direct": the forward keeps nothing; the backward kernel runs the
    #   closest-hit trace again wherever the adjoint needs a hit. Up to 48
    #   objects; above that "replay" runs, as in the JAX package.
    bwd_mode: str = "fetch"  # "fetch" | "replay" | "direct"

    # Training only: above 0, the frame is blended with a soft primary
    # visibility (render/integrator.py::soft_silhouette_composite), which
    # gives the geometry a gradient across silhouettes. 0 = hard edges.
    soft_silhouette_temp: float = 0.0

    # Where the progressive pyramid starts (render/film.py::
    # progressive_scales; the reference's --init-scale).
    init_scale: int = 8

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
