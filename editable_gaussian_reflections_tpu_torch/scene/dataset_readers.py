"""Scene loading: dataset dispatch, camera materialization, NeRF++ norm.

Twin of the JAX package's scene/dataset_readers.py (reference
scene/dataset_readers.py:32-140), for the Blender layout.  Image decoding
runs in a thread pool; the NO_WORKERS environment variable turns it off,
as in the reference.
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
    """The Blender layout (dataset_readers.py:65-89).  A priors/ or sparse/
    directory marks the COLMAP-prior or Blender-prior layouts, which are not
    ported yet: they raise rather than load as something else."""
    for marker, layout, module in (
            ("priors", "COLMAP prior", "colmap_prior"),
            ("sparse", "Blender prior", "blender_prior")):
        if os.path.exists(os.path.join(data_dir, marker)):
            raise NotImplementedError(
                f"{data_dir}: the {layout} dataset layout ({marker}/) needs "
                f"dataset/{module}.py, which is not ported yet")
    from ..dataset.blender import BlenderDataset
    return BlenderDataset(
        data_dir, split=split, resolution=cfg.resolution,
        max_images=cfg.max_images,
    )


def read_dataset(dataset, num_workers: int = 16) -> List[Camera]:
    n = len(dataset)
    if "NO_WORKERS" in os.environ:
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
