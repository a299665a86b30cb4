"""CameraInfo record - twin of reference dataset/camera_info.py:7-24 (numpy HWC;
the port's copy of the JAX package's dataset/camera_info.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: Optional[np.ndarray]
    image_path: str
    image_name: str
    width: int
    height: int
    diffuse_image: Optional[np.ndarray] = None
    specular_image: Optional[np.ndarray] = None
    depth_image: Optional[np.ndarray] = None
    normal_image: Optional[np.ndarray] = None
    roughness_image: Optional[np.ndarray] = None
    f0_image: Optional[np.ndarray] = None
