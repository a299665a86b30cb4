"""Scene - host-side orchestration of dataset + GaussianScene.

Twin of the JAX package's scene/scene.py (reference scene/scene.py:24-131):
loads the scene info, shuffles the train cameras, computes the NeRF++
camera extent, auto-adjusts each camera's znear/zfar from its GT depth,
then loads a PLY checkpoint from the reference's artifact layout
(model_path/point_cloud/iteration_N/point_cloud.ply) or initializes from the
point cloud (create_from_pcd), and saves checkpoints in that layout.
`Scene(cfg, scene_info=...)` does all of it but the reading, for a
SceneInfo built in memory.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..device import DEFAULT_DEVICE
from ..utils.ply import load_gaussian_ply, save_gaussian_ply
from .cameras import Camera
from .dataset_readers import SceneInfo, readSceneInfo
from .gaussian_scene import GaussianScene, from_arrays
from .init import create_from_pcd


class Scene:
    def __init__(
        self,
        cfg: Config,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        model_path: Optional[str] = None,
        device: torch.device | str = DEFAULT_DEVICE,
        scene_info: Optional[SceneInfo] = None,
    ):
        """Read cfg.source_path (unless `scene_info`, e.g. one built in
        memory, is given), then set up cameras and Gaussians on `device`."""
        self.cfg = cfg
        self.model_path = model_path or cfg.model_path
        if scene_info is None:
            scene_info = readSceneInfo(cfg, cfg.source_path)
        if shuffle:
            random.shuffle(scene_info.train_cameras)

        self.cameras_extent = float(scene_info.nerf_normalization["radius"])
        self.train_cameras: List[Camera] = scene_info.train_cameras
        self.test_cameras: List[Camera] = scene_info.test_cameras
        self.loaded_iter = load_iteration

        self.autoadjust_zplanes()

        if load_iteration:
            ply = os.path.join(
                self.model_path, "point_cloud",
                f"iteration_{load_iteration}", "point_cloud.ply",
            )
            self.gaussians = load_scene_ply(ply, pad_multiple=cfg.trace_chunk,
                                            device=device)
        else:
            self.gaussians = create_from_pcd(
                scene_info.point_cloud, cfg, pad_multiple=cfg.trace_chunk,
                device=device)

    def autoadjust_zplanes(self):
        """scene.py:107-121: znear/zfar from GT depth amin/amax x0.8/x1.5."""
        for camera in self.train_cameras + self.test_cameras:
            if camera.depth_image is not None:
                camera.znear = (float(camera.depth_image.min())
                                * self.cfg.znear_scaledown)
                camera.zfar = (float(camera.depth_image.max())
                               * self.cfg.zfar_scaleup)
                camera.update()
        first = self.train_cameras[0]
        for camera in self.train_cameras:
            assert camera.image_height == first.image_height
            assert camera.FoVy == first.FoVy
        self.max_zfar = max(c.zfar for c in self.train_cameras)

    def select_points_to_prune_near_cameras(self, points: np.ndarray
                                            ) -> np.ndarray:
        """scene.py:88-105: points inside any camera's znear sphere."""
        mask = np.zeros(points.shape[0], bool)
        for camera in self.train_cameras:
            d = np.linalg.norm(points - camera.camera_center[None], axis=1)
            mask |= d < camera.znear
        return mask

    def camera_centers_znears(self):
        return (
            [c.camera_center for c in self.train_cameras],
            [c.znear for c in self.train_cameras],
        )

    def save(self, iteration: int, scene: Optional[GaussianScene] = None):
        """scene.py:123-125 artifact layout; compacts padded slots."""
        g = scene if scene is not None else self.gaussians
        path = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}",
            "point_cloud.ply",
        )
        save_scene_ply(path, g)

    def getTrainCameras(self):
        return self.train_cameras

    def getTestCameras(self):
        return self.test_cameras


def save_scene_ply(path: str, scene: GaussianScene):
    """The live Gaussians as a reference-layout PLY (the JAX package's
    bytes for the same Gaussians)."""
    idx = torch.nonzero(scene.live_mask).squeeze(1)

    def live(a):
        return a[idx].cpu().numpy()

    save_gaussian_ply(
        path,
        xyz=live(scene.xyz),
        diffuse=live(scene.diffuse),
        opacity=live(scene.opacity),
        scaling=live(scene.scaling),
        rotation=live(scene.rotation),
        normal=live(scene.normal),
        roughness=live(scene.roughness),
        f0=live(scene.f0),
    )


def load_scene_ply(path: str, pad_multiple: int = 2048,
                   device: torch.device | str = DEFAULT_DEVICE
                   ) -> GaussianScene:
    """A checkpoint PLY as a GaussianScene padded to `pad_multiple`."""
    d = load_gaussian_ply(path)
    return from_arrays(**d, pad_multiple=pad_multiple, device=device)


def search_for_max_iteration(folder: str) -> int:
    """utils/system_utils.py:28-30."""
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)]
    return max(saved)
