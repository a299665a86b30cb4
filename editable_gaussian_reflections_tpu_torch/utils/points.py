"""Point-cloud helpers - the port's copy of the JAX package's utils/points.py
(twin of reference dataset/points_utils.py and utils/point_utils.py: the
make_skybox sphere sampler and the depth unprojection)."""

from __future__ import annotations

import numpy as np

from .graphics import BasicPointCloud


def make_skybox(num_points: int, radius: float, color=(0.5, 0.5, 0.5),
                seed: int = 0) -> BasicPointCloud:
    """Uniform sphere shell of points (points_utils.py:27-35)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(num_points, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = (v * radius).astype(np.float32)
    cols = np.tile(np.asarray(color, np.float32), (num_points, 1))
    return BasicPointCloud(points=pts, colors=cols, normals=-v.astype(np.float32))


def depth_to_points(depth, rays_o, rays_d):
    """Unproject a depth map along precomputed rays -> world points."""
    d = np.asarray(depth).reshape(-1, 1)
    return np.asarray(rays_o).reshape(-1, 3) + np.asarray(rays_d).reshape(-1, 3) * d
