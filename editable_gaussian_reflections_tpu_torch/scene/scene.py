"""Scene - host-side orchestration of dataset + GaussianScene.

Twin of the JAX package's scene/scene.py (reference scene/scene.py:24-131),
for the inference CLIs: loads the scene info, shuffles the train cameras,
computes the NeRF++ camera extent, auto-adjusts each camera's znear/zfar
from its GT depth, and loads a PLY checkpoint from the reference's artifact
layout (model_path/point_cloud/iteration_N/point_cloud.ply).  Initializing
from the point cloud (create_from_pcd) belongs to the training CLI, which
is not ported yet.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import torch

from ..config import Config
from ..device import DEFAULT_DEVICE
from ..utils.ply import load_gaussian_ply
from .cameras import Camera
from .dataset_readers import readSceneInfo
from .gaussian_scene import GaussianScene, from_arrays


class Scene:
    def __init__(
        self,
        cfg: Config,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        model_path: Optional[str] = None,
        device: torch.device | str = DEFAULT_DEVICE,
    ):
        if not load_iteration:
            raise NotImplementedError(
                "Scene without load_iteration initializes from the point "
                "cloud (create_from_pcd), which comes with the training CLI "
                "(ROADMAP.md Queue 1, item 9)")
        self.cfg = cfg
        self.model_path = model_path or cfg.model_path

        scene_info = readSceneInfo(cfg, cfg.source_path)
        if shuffle:
            random.shuffle(scene_info.train_cameras)

        self.cameras_extent = float(scene_info.nerf_normalization["radius"])
        self.train_cameras: List[Camera] = scene_info.train_cameras
        self.test_cameras: List[Camera] = scene_info.test_cameras
        self.loaded_iter = load_iteration

        self.autoadjust_zplanes()

        ply = os.path.join(
            self.model_path, "point_cloud",
            f"iteration_{load_iteration}", "point_cloud.ply",
        )
        self.gaussians = load_scene_ply(ply, pad_multiple=cfg.trace_chunk,
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

    def getTrainCameras(self):
        return self.train_cameras

    def getTestCameras(self):
        return self.test_cameras


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
