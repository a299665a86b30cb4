"""Dataset package: the Blender layout (dataset/blender.py) and the
Blender-prior and COLMAP-prior layouts (dataset/blender_prior.py,
dataset/colmap_prior.py, with the COLMAP readers in dataset/colmap_loader.py
and dataset/colmap_parser.py)."""

from .blender import BlenderDataset
from .blender_prior import BlenderPriorDataset
from .camera_info import CameraInfo
from .colmap_prior import ColmapPriorDataset

__all__ = ["BlenderDataset", "BlenderPriorDataset", "CameraInfo",
           "ColmapPriorDataset"]
