"""Graphics helpers - twin of reference editable_gauss_refl/utils/graphics_utils.py:20-88
(the port's copy of the JAX package's pure-numpy utils/graphics.py)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray   # [N, 3]
    colors: np.ndarray   # [N, 3]
    normals: np.ndarray  # [N, 3]


def getWorld2View2(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """World->view 4x4 with optional recentering (graphics_utils.py:38-56).

    Convention: R is stored transposed (camera-to-world rotation), t is the
    world-to-camera translation - matching COLMAP-loader conventions.
    """
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0

    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def getProjectionMatrix(znear, zfar, fovX, fovY):
    """OpenGL-style projection (graphics_utils.py:59-80)."""
    tanHalfFovY = math.tan(fovY / 2)
    tanHalfFovX = math.tan(fovX / 2)

    top = tanHalfFovY * znear
    bottom = -top
    right = tanHalfFovX * znear
    left = -right

    P = np.zeros((4, 4))
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))
