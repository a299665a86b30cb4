"""BlenderDataset - GT synthetic scenes with per-frame G-buffers.

The port's copy of the JAX package's dataset/blender.py, itself the twin of
reference dataset/blender_dataset.py: transforms_{split}.json
frames, 7 buffers per frame (render/diffuse/specular/roughness/normal/depth/f0)
loaded with an .exr -> .tiff -> .png fallback chain, OpenGL->COLMAP axis flip
with R stored transposed, area-downsampling to `resolution`.

Pure numpy: cv2 for EXR and for a resize, imported where it is used;
float32 TIFFs are read by utils/image.read_tiff and PNGs by
utils/image.read_png, so a dataset of TIFFs or PNGs at its native
resolution loads with no imaging package installed.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

from ..utils.graphics import focal2fov, fov2focal
from ..utils.image import read_png, read_tiff
from .camera_info import CameraInfo
from .image_utils import pil_samples


def _read_exr(path):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"failed to read {path}")
    if img.ndim == 3 and img.shape[-1] >= 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return np.asarray(img)


def _read_png(path):
    return pil_samples(read_png(path))


def resize_area(image: np.ndarray, resolution: int) -> np.ndarray:
    """Area-downsample so height == resolution (blender_dataset.py:112-129);
    at that height already, the image itself (cv2 is not imported)."""
    h, w = image.shape[:2]
    if h == resolution:
        return image
    import cv2
    aspect = w / h
    out_w = int(resolution * aspect)
    was_uint = image.dtype == np.uint8
    img = image.astype(np.float32) if was_uint else image
    img = cv2.resize(img, (out_w, resolution), interpolation=cv2.INTER_AREA)
    if img.ndim == 2:
        img = img[..., None]
    if was_uint:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return img


class BlenderDataset:
    BUFFERS = ("render", "diffuse", "specular", "roughness", "normal",
               "depth", "f0")

    def __init__(self, data_dir: str, split: str = "train",
                 resolution: int | None = None, max_images: int | None = None):
        self.data_dir = data_dir
        self.split = split
        self.resolution = resolution
        self.max_images = max_images
        with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
            self.contents = json.load(f)
        self.frames = sorted(self.contents["frames"], key=lambda x: x["file_path"])
        if max_images is not None:
            self.frames = self.frames[:max_images]
        assert len(self.frames) != 0, "Dataset is empty"

    def __len__(self):
        return len(self.frames)

    def _get_buffer(self, frame_name: str, buffer_name: str):
        buffer_filename = frame_name.replace("render", buffer_name)
        base = os.path.join(self.data_dir, buffer_filename)
        if os.path.exists(base + ".exr"):
            image = _read_exr(base + ".exr")
        elif os.path.exists(base + ".tiff"):
            image = read_tiff(base + ".tiff")
        elif os.path.exists(base + ".png"):
            image = _read_png(base + ".png")
        else:
            raise FileNotFoundError(base + ".{exr,tiff,png}")
        assert image.shape[0] != 1
        if image.ndim == 2:
            image = image[..., None]
        if self.resolution is not None and image.shape[0] != self.resolution:
            image = resize_area(image, self.resolution)
        return image

    def __getitem__(self, idx: int) -> CameraInfo:
        frame = self.frames[idx]
        frame_name = frame["file_path"]
        image_name = Path(frame_name).stem + ".png"
        image_path = os.path.join(self.data_dir, image_name)

        bufs = {b: self._get_buffer(frame_name, b) for b in self.BUFFERS}
        image = bufs["render"]
        height, width = image.shape[0], image.shape[1]
        fovx = self.contents["camera_angle_x"]
        fovy = focal2fov(fov2focal(fovx, width), height)

        c2w = np.array(frame["transform_matrix"], np.float64)
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])  # stored transposed (glm convention)
        T = w2c[:3, 3]

        return CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx,
            image=image, image_path=image_path, image_name=image_name,
            width=width, height=height,
            diffuse_image=bufs["diffuse"], specular_image=bufs["specular"],
            depth_image=bufs["depth"], normal_image=bufs["normal"],
            roughness_image=bufs["roughness"], f0_image=bufs["f0"],
        )
