from ray_tracing_tpu_torch.scene.types import Scene, ObjectSpec, OBJ_NONE, OBJ_SPHERE, OBJ_CUBE
from ray_tracing_tpu_torch.scene.parser import (
    parse_scene_file,
    parse_scene_string,
    SceneParseError,
    MAX_OBJECTS,
)

__all__ = [
    "Scene",
    "ObjectSpec",
    "OBJ_NONE",
    "OBJ_SPHERE",
    "OBJ_CUBE",
    "parse_scene_file",
    "parse_scene_string",
    "SceneParseError",
    "MAX_OBJECTS",
]
