"""Dataset package: the Blender layout (dataset/blender.py).  The prior and
COLMAP layouts of the JAX package are not ported yet (ROADMAP.md Queue 1,
item 8)."""

from .blender import BlenderDataset
from .camera_info import CameraInfo

__all__ = ["BlenderDataset", "CameraInfo"]
