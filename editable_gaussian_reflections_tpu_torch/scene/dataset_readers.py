"""Scene loading: dataset dispatch, camera materialization, NeRF++ norm.

Twin of the JAX package's scene/dataset_readers.py (reference
scene/dataset_readers.py:32-140): the Blender, Blender-prior and
COLMAP-prior layouts.  Image decoding
runs in a thread pool; the NO_WORKERS environment variable turns it off,
as in the reference, and the prior layouts read in order (read_dataset).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List

import numpy as np

from ..config import Config
from ..utils.graphics import BasicPointCloud, getWorld2View2
from ..utils.ply import load_xyzrgb_ply
from .cameras import Camera


@dataclass
class SceneInfo:
    point_cloud: BasicPointCloud
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    nerf_normalization: dict
    ply_path: str


def getNerfppNorm(cameras: List[Camera]) -> dict:
    """dataset_readers.py:41-62."""
    cam_centers = []
    for cam in cameras:
        W2C = getWorld2View2(cam.R, cam.T)
        C2W = np.linalg.inv(W2C)
        cam_centers.append(C2W[:3, 3:4])
    cam_centers = np.hstack(cam_centers)
    center = np.mean(cam_centers, axis=1, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=0, keepdims=True)
    diagonal = np.max(dist)
    return {"translate": -center.flatten(), "radius": diagonal * 1.1}


def get_dataset(cfg: Config, data_dir: str, split: str):
    """Dispatch: priors/ -> ColmapPrior, sparse/ -> BlenderPrior, else Blender
    (dataset_readers.py:65-89)."""
    if os.path.exists(os.path.join(data_dir, "priors")):
        from ..dataset.colmap_prior import ColmapPriorDataset
        return ColmapPriorDataset(
            data_dir, split=split, resolution=cfg.resolution,
            max_images=cfg.max_images, clamp_max=cfg.clamp_max,
        )
    if os.path.exists(os.path.join(data_dir, "sparse")):
        from ..dataset.blender_prior import BlenderPriorDataset
        return BlenderPriorDataset(
            data_dir, split=split, resolution=cfg.resolution,
            max_images=cfg.max_images,
        )
    from ..dataset.blender import BlenderDataset
    return BlenderDataset(
        data_dir, split=split, resolution=cfg.resolution,
        max_images=cfg.max_images,
    )


def read_dataset(dataset, num_workers: int = 16) -> List[Camera]:
    """Every item of `dataset` as a Camera, decoded in a thread pool; in
    order, in this thread, under NO_WORKERS and for the prior layouts
    (whose RANSAC depth fits draw from a shared generator: threads would
    take its draws in any order, so a seeded run would not repeat)."""
    n = len(dataset)
    if "NO_WORKERS" in os.environ or hasattr(dataset, "rng"):
        infos = [dataset[i] for i in range(n)]
    else:
        workers = max(1, min(num_workers, (os.cpu_count() or 2) // 2 or 1))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            infos = list(ex.map(dataset.__getitem__, range(n)))
    return [Camera.from_cam_info(ci) for ci in infos]


def readSceneInfo(cfg: Config, data_dir: str) -> SceneInfo:
    """dataset_readers.py:109-140."""
    train_cameras = read_dataset(get_dataset(cfg, data_dir, "train"))
    test_cameras = read_dataset(get_dataset(cfg, data_dir, "test"))

    points, colors = load_xyzrgb_ply(
        os.path.join(data_dir, f"point_cloud_{cfg.init_type}.ply")
    )
    point_cloud = BasicPointCloud(
        points=points, colors=colors, normals=np.zeros_like(points)
    )
    return SceneInfo(
        point_cloud=point_cloud,
        train_cameras=train_cameras,
        test_cameras=test_cameras,
        nerf_normalization=getNerfppNorm(train_cameras),
        ply_path=os.path.join(data_dir, "sparse/0/points3D.ply"),
    )
