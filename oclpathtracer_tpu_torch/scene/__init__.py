from oclpathtracer_tpu_torch.scene.types import Geometry, Materials, Scene, Lights
from oclpathtracer_tpu_torch.scene.loader import load_cornell_box, parse_mesh_file, build_scene

__all__ = [
    "Geometry",
    "Materials",
    "Scene",
    "Lights",
    "load_cornell_box",
    "parse_mesh_file",
    "build_scene",
]
