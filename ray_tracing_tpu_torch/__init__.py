"""ray_tracing_tpu_torch: the PyTorch/CUDA port of the ray_tracing_tpu path
tracer, for NVIDIA Hopper.

The JAX package ``ray_tracing_tpu`` stays beside it as the reference; this
package imports torch and numpy and nothing of JAX. Sub-packages carry the
names of their counterparts:

    ops/       vector math, intersections, cubemap, random numbers
    scene/     scene tensors + DSL parser (Python and native) + built-in scenes
    render/    camera, the plain PyTorch renderer, soft silhouettes, the
               progressive film
    kernels/   the CUDA megakernels, forward and backward (csrc/), their
               build, their wrappers and the autograd boundary
    native/    the C++ runtime layer (parser, PNG writer, event queue)
    parallel/  the (tile, sample) mesh of cells, the sharded render, and
               several processes through torch.distributed
    diff/      finite differences, the train step (over a mesh), fit with
               checkpoints and resume, fit_multiscale, the coarse pose
               search, checkpoints
    io/        skybox loading, PNG output, screenshots
    apps/      command line (render, terminal viewer), the HTTP render
               service, the invert app (fit), the fly-through and the pose
               recovery
    compat.py  scenes, cameras, cubemaps, parameters and cotangents from
               numpy arrays, gradients back

Every public entry point, the constructors of scenes, cameras and cubemaps
included, takes ``device=None``, which means the card; it raises when there
is none. Only an explicit ``device="cpu"`` runs on the CPU.
"""

__version__ = "0.1.0"

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.scene.types import Scene, ObjectSpec, OBJ_NONE, OBJ_SPHERE, OBJ_CUBE
from ray_tracing_tpu_torch.scene.parser import parse_scene_file, parse_scene_string, SceneParseError
from ray_tracing_tpu_torch.render.camera import Camera
from ray_tracing_tpu_torch.render.integrator import render_image
from ray_tracing_tpu_torch.kernels.megakernel import render_image_cuda, render_tiles_cuda

__all__ = [
    "RenderConfig",
    "DEFAULT_CONFIG",
    "Scene",
    "ObjectSpec",
    "OBJ_NONE",
    "OBJ_SPHERE",
    "OBJ_CUBE",
    "parse_scene_file",
    "parse_scene_string",
    "SceneParseError",
    "Camera",
    "render_image",
    "render_image_cuda",
    "render_tiles_cuda",
]
