"""ColmapParser - the port's copy of the JAX package's dataset/colmap_parser.py
(twin of reference dataset/colmap_parser.py:6-43).

The reference wraps pycolmap's SceneManager; here the pure-python readers in
colmap_loader provide the same surface: points3D + per-image visible point
indices (looked up by binary search over the sorted ids, the JAX package's
dict lookups one array operation an image).
"""

from __future__ import annotations

import os

import numpy as np

from .colmap_loader import read_model


class ColmapParser:
    def __init__(self, data_dir: str, sparse_subdir: str = "sparse/0"):
        sparse = os.path.join(data_dir, sparse_subdir)
        if not os.path.isdir(sparse):
            sparse = os.path.join(data_dir, "sparse")
        assert os.path.exists(sparse), f"COLMAP directory {sparse} does not exist."
        self.cameras, self.images, pts = read_model(sparse)
        xyz, rgb, err, ids = pts
        self.points = xyz.astype(np.float32)
        self.points_rgb = rgb.astype(np.float32)
        self.points_err = err.astype(np.float32)
        # point id -> row (the last row of a repeated id), by binary search
        self._order = np.argsort(ids, kind="stable")
        self._sorted_ids = ids[self._order]

        # {image_name -> [point_idx]} like the reference's pycolmap wrapper
        self.point_indices = {
            img.name: self._rows(img.point3D_ids).astype(np.int32)
            for img in self.images.values()}

    def _rows(self, point3D_ids) -> np.ndarray:
        """Rows of self.points for the ids >= 0 that name a point, in
        order."""
        pids = np.asarray(point3D_ids, np.int64)
        pids = pids[pids >= 0]
        if not self._sorted_ids.size:
            return np.zeros(0, np.int64)
        pos = np.searchsorted(self._sorted_ids, pids, side="right") - 1
        hit = (pos >= 0) & (self._sorted_ids[np.maximum(pos, 0)] == pids)
        return self._order[pos[hit]].astype(np.int64)

    def image_by_name(self, name: str):
        for img in self.images.values():
            if img.name == name:
                return img
        return None

    def visible_point_indices(self, image) -> np.ndarray:
        """Indices into self.points of the 3D points observed by `image`."""
        return self._rows(image.point3D_ids)
