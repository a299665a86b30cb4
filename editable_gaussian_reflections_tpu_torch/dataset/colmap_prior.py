"""ColmapPriorDataset - real captured scenes with network-predicted priors.

The port's copy of the JAX package's dataset/colmap_prior.py (twin of
reference dataset/colmap_prior_dataset.py: COLMAP sparse/0
intrinsics/extrinsics (bin or txt), llffhold=8 train/test split,
PINHOLE/SIMPLE_PINHOLE only, same prior-buffer + RANSAC depth-fit pipeline as
BlenderPriorDataset).  PNGs are read with utils/image.read_png; PIL is
needed only for a resize.  The RANSAC samples come from `rng` (default:
the `random` module's generator).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from ..ops.tonemap import untonemap
from ..utils.depth import (
    project_pointcloud_to_depth_map,
    ransac_linear_fit,
    transform_depth_to_position_image,
    transform_normals_to_world,
    transform_points,
)
from ..utils.graphics import BasicPointCloud, focal2fov
from .camera_info import CameraInfo
from .colmap_loader import (
    qvec2rotmat,
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
)
from .colmap_parser import ColmapParser
from .image_utils import from_pil_image, from_png


def _untonemap_np(x):
    return untonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()


class ColmapPriorDataset:
    def __init__(self, data_dir: str, split: str = "train",
                 resolution: int | None = None, max_images: int | None = None,
                 do_eval: bool = True, clamp_max: float | None = None,
                 rng: random.Random | None = None):
        self.data_dir = data_dir
        self.rng = rng
        self.split = split
        self.resolution = resolution
        self.max_images = max_images
        self.do_eval = do_eval
        self.clamp_max = clamp_max

        self.colmap_parser = ColmapParser(data_dir)
        self.point_cloud = BasicPointCloud(
            points=self.colmap_parser.points,
            colors=self.colmap_parser.points_rgb,
            normals=np.zeros_like(self.colmap_parser.points),
        )

        self.buffers_dir = os.path.join(data_dir, "priors")
        self.llffhold = 8
        try:
            self.cam_extrinsics = read_images_binary(
                os.path.join(data_dir, "sparse/0", "images.bin"))
            self.cam_intrinsics = read_cameras_binary(
                os.path.join(data_dir, "sparse/0", "cameras.bin"))
        except Exception:
            self.cam_extrinsics = read_images_text(
                os.path.join(data_dir, "sparse/0", "images.txt"))
            self.cam_intrinsics = read_cameras_text(
                os.path.join(data_dir, "sparse/0", "cameras.txt"))

        keys = sorted(self.cam_extrinsics.keys())
        if self.do_eval:
            if split == "train":
                self.keys = [k for i, k in enumerate(keys) if i % self.llffhold != 0]
            else:
                self.keys = [k for i, k in enumerate(keys) if i % self.llffhold == 0]
        else:
            self.keys = keys if split == "train" else []
        if max_images is not None:
            self.keys = self.keys[:max_images]

    def __len__(self):
        return len(self.keys)

    def _get_buffer(self, frame_name: str, buffer_name: str) -> np.ndarray:
        fno = frame_name.split("/")[-1]
        path = os.path.join(self.buffers_dir, buffer_name,
                            f"{buffer_name}_{fno}.png")
        buffer = from_png(path)
        if (self.resolution is not None
                and buffer.shape[0] != self.resolution):
            # PIL's resize (at the file's own size it returns the image)
            from PIL import Image
            img = Image.open(path)
            h = self.resolution
            w = int(h * (img.size[0] / img.size[1]))
            buffer = from_pil_image(img.resize((w, h)))
        if buffer_name in ("render", "diffuse", "specular"):
            buffer = _untonemap_np(buffer)
            if self.clamp_max is not None:
                buffer = np.clip(buffer, 0, self.clamp_max)
        elif buffer_name in ("roughness", "metalness", "depth"):
            pass
        elif buffer_name == "normal":
            buffer = buffer * 2.0 - 1.0
        else:
            raise ValueError(f"Buffer name not recognized: {buffer_name}")
        return np.asarray(buffer, np.float32)

    def __getitem__(self, idx: int) -> CameraInfo:
        key = self.keys[idx]
        extr = self.cam_extrinsics[key]
        intr = self.cam_intrinsics[extr.camera_id]
        image_name = extr.name
        frame_name = os.path.splitext(image_name)[0]
        image_path = os.path.join(self.data_dir, "images", frame_name + ".jpg")

        bufs = {b: self._get_buffer(frame_name, b)
                for b in ("render", "diffuse", "specular", "roughness",
                          "metalness", "depth", "normal")}
        m = bufs["metalness"]
        f0_image = np.repeat(0.04 * (1.0 - m) + m, 3, axis=-1).astype(np.float32)

        height, width = intr.height, intr.width
        if intr.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(intr.params[0], height)
            fovx = focal2fov(intr.params[0], width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], height)
            fovx = focal2fov(intr.params[0], width)
        else:
            raise AssertionError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!")

        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(extr.qvec)
        w2c[:3, 3] = extr.tvec
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        bufs["normal"] = transform_normals_to_world(
            bufs["normal"], R.astype(np.float32)).astype(np.float32)

        pidx = self.colmap_parser.point_indices.get(image_name, np.zeros(0, np.int32))
        if pidx.size >= 2:
            pts = transform_points(
                self.colmap_parser.points[pidx].astype(np.float64), w2c)
            sparse = project_pointcloud_to_depth_map(
                pts, fovx, fovy, bufs["depth"].shape[:2])
            valid = sparse != 0
            if valid.sum() >= 2:
                fit, _ = ransac_linear_fit(
                    bufs["depth"][:, :, 0][valid].astype(np.float64),
                    sparse[valid], rng=self.rng)
                if fit is not None:
                    a, b = fit
                    bufs["depth"] = bufs["depth"] * a + b

        position = transform_depth_to_position_image(
            bufs["depth"][:, :, 0], fovx, fovy)
        distance = np.linalg.norm(position, axis=-1, keepdims=True).astype(np.float32)

        return CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx,
            image=bufs["render"], image_path=image_path,
            image_name=image_name, width=width, height=height,
            diffuse_image=bufs["diffuse"], specular_image=bufs["specular"],
            depth_image=distance, normal_image=bufs["normal"],
            roughness_image=bufs["roughness"], f0_image=f0_image,
        )
