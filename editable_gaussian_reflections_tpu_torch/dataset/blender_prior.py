"""BlenderPriorDataset - synthetic scenes with network-predicted priors.

The port's copy of the JAX package's dataset/blender_prior.py (twin of
reference dataset/blender_prior_dataset.py: buffers from
{split}/{name}/{name}_{id}.png, render/diffuse/specular untonemapped,
monocular depth rescaled by a RANSAC linear fit against COLMAP points
projected to a sparse depth map, depth -> distance via the position image,
metalness -> f0 = 0.04(1-m)+m, normals camera -> world).  PNGs are read
with utils/image.read_png; cv2 is needed only for a resize.  The RANSAC
samples come from `rng` (default: the `random` module's generator).
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path

import numpy as np
import torch

from ..utils.depth import (
    project_pointcloud_to_depth_map,
    ransac_linear_fit,
    transform_depth_to_position_image,
    transform_normals_to_world,
    transform_points,
)
from ..utils.graphics import BasicPointCloud, focal2fov, fov2focal
from ..ops.tonemap import untonemap
from .blender import resize_area
from .camera_info import CameraInfo
from .colmap_parser import ColmapParser
from .image_utils import from_png


def _untonemap_np(x):
    return untonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()


class BlenderPriorDataset:
    BUFFERS = ("render", "diffuse", "specular", "roughness", "metalness",
               "depth", "normal")

    def __init__(self, data_dir: str, split: str = "train",
                 resolution: int | None = None, max_images: int | None = None,
                 rng: random.Random | None = None):
        self.data_dir = data_dir
        self.rng = rng
        self.split = split
        self.resolution = resolution
        self.max_images = max_images

        self.colmap_parser = ColmapParser(data_dir)
        self.point_cloud = BasicPointCloud(
            points=self.colmap_parser.points,
            colors=self.colmap_parser.points_rgb,
            normals=np.zeros_like(self.colmap_parser.points),
        )
        self.buffers_dir = os.path.join(data_dir, split)
        with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
            self.contents = json.load(f)
        self.frames = sorted(self.contents["frames"], key=lambda x: x["file_path"])
        if max_images is not None:
            self.frames = self.frames[:max_images]

    def __len__(self):
        return len(self.frames)

    def _get_buffer(self, frame_name: str, buffer_name: str) -> np.ndarray:
        file_name = frame_name.split("/")[-1]
        frame_id = file_name.split("_")[-1]
        path = os.path.join(self.buffers_dir, buffer_name,
                            f"{buffer_name}_{frame_id}.png")
        buffer = from_png(path)
        if buffer_name in ("render", "irradiance", "diffuse", "specular"):
            buffer = _untonemap_np(buffer)
        elif buffer_name in ("depth", "roughness", "metalness"):
            pass
        elif buffer_name == "normal":
            buffer = buffer * 2.0 - 1.0
        else:
            raise ValueError(f"Buffer name not recognized: {buffer_name}")
        return np.asarray(buffer, np.float32)

    def __getitem__(self, idx: int) -> CameraInfo:
        frame = self.frames[idx]
        frame_name = frame["file_path"]
        image_name = Path(frame_name).stem + ".png"
        image_path = os.path.join(self.data_dir, image_name)

        buffers = {b: self._get_buffer(frame_name, b) for b in self.BUFFERS}
        if self.resolution is not None:
            buffers = {k: resize_area(v, self.resolution)
                       for k, v in buffers.items()}

        height, width = buffers["render"].shape[:2]
        if "camera_angle_y" in self.contents:
            fovy = self.contents["camera_angle_y"]
            fovx = self.contents["camera_angle_x"]
        else:
            fovx = self.contents["camera_angle_x"]
            fovy = focal2fov(fov2focal(fovx, width), height)

        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        # normals camera -> world (blender_prior_dataset.py:98)
        buffers["normal"] = transform_normals_to_world(
            buffers["normal"], R.astype(np.float32)
        ).astype(np.float32)

        # monocular depth rescale vs sparse COLMAP depth (:100-113)
        pidx = self.colmap_parser.point_indices.get(image_name, np.zeros(0, np.int32))
        if pidx.size >= 2:
            pts = transform_points(
                self.colmap_parser.points[pidx].astype(np.float64), w2c
            )
            sparse_depth = project_pointcloud_to_depth_map(
                pts, fovx, fovy, buffers["depth"].shape[:2]
            )
            valid = sparse_depth != 0
            if valid.sum() >= 2:
                x = buffers["depth"][:, :, 0][valid].astype(np.float64)
                y = sparse_depth[valid]
                fit, _ = ransac_linear_fit(x, y, rng=self.rng)
                if fit is not None:
                    a, b = fit
                    buffers["depth"] = buffers["depth"] * a + b

        # depth -> distance (:116-123)
        position = transform_depth_to_position_image(
            buffers["depth"][..., 0], fovx, fovy
        )
        distance = np.linalg.norm(position, axis=-1, keepdims=True).astype(np.float32)

        # metalness -> f0 (:126)
        m = buffers["metalness"]
        f0_image = np.repeat(0.04 * (1.0 - m) + m, 3, axis=-1).astype(np.float32)

        return CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx,
            image=buffers["render"], image_path=image_path,
            image_name=image_name, width=width, height=height,
            diffuse_image=buffers["diffuse"],
            specular_image=buffers["specular"],
            depth_image=distance,
            normal_image=buffers["normal"],
            roughness_image=buffers["roughness"],
            f0_image=f0_image,
        )
