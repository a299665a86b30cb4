from .cameras import Camera, MiniCam
from .editable import Edit, EditableGaussianScene
from .gaussian_scene import GaussianScene, build_frames, from_arrays
from .scene import Scene, load_scene_ply, save_scene_ply

__all__ = [
    "Camera", "MiniCam", "Edit", "EditableGaussianScene", "GaussianScene",
    "build_frames", "from_arrays", "Scene", "load_scene_ply",
    "save_scene_ply",
]
