"""Dataset package: the Blender layout (dataset/blender.py).  The JAX
package's Blender-prior and COLMAP-prior layouts (dataset/blender_prior.py,
dataset/colmap_prior.py and the COLMAP readers) are not ported yet."""

from .blender import BlenderDataset
from .camera_info import CameraInfo

__all__ = ["BlenderDataset", "CameraInfo"]
