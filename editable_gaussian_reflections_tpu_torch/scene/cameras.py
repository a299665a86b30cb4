"""Camera with G-buffer supervision targets.

Twin of the JAX package's scene/cameras.py (reference scene/cameras.py:
22-177), with the viewer's pose-only MiniCam.  Targets are stored as
float16 numpy on host (the IMAGE_HOLDING_DEVICE=cpu default), promoted to
float32 lazily via properties; uint8 render/diffuse/specular inputs are
untonemapped to HDR exactly like cameras.py:56-70.

The pose the renderer consumes (origin + c2w rotation in the kernel's
Y-up/Z-back convention) is derived the same way as
renderer/gaussian_raytracer.py:95-103: c2w_render = -R with the first column
re-negated, origin = camera center from the world-view inverse.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import torch

from ..ops.tonemap import untonemap
from ..utils.graphics import getProjectionMatrix, getWorld2View2


def _untonemap_np(x: np.ndarray) -> np.ndarray:
    return untonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()


class Camera:
    def __init__(
        self,
        colmap_id,
        R,
        T,
        FoVx,
        FoVy,
        image,              # HWC numpy (uint8 or float)
        image_name,
        uid,
        specular_image=None,
        diffuse_image=None,
        depth_image=None,
        normal_image=None,
        roughness_image=None,
        f0_image=None,
        trans=np.array([0.0, 0.0, 0.0]),
        scale=1.0,
    ):
        self.uid = uid
        self.colmap_id = colmap_id
        self.R = np.asarray(R, np.float64)
        self.T = np.asarray(T, np.float64)
        self.FoVx = float(FoVx)
        self.FoVy = float(FoVy)
        self.image_name = image_name
        self.trans = trans
        self.scale = scale

        ref = diffuse_image if diffuse_image is not None else image
        self.image_height = ref.shape[0]
        self.image_width = ref.shape[1]

        def hdr(x):
            if x is None:
                return None
            x = np.asarray(x)
            if x.dtype == np.uint8:
                x = _untonemap_np(x.astype(np.float32) / 255.0)
            return x.astype(np.float16)

        def lin(x, scale_offset=False):
            if x is None:
                return None
            x = np.asarray(x)
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0
                if scale_offset:
                    x = x * 2.0 - 1.0
            return x.astype(np.float16)

        if normal_image is not None and np.asarray(normal_image).dtype == np.uint8:
            normal_image = lin(normal_image, scale_offset=True)
        else:
            normal_image = lin(normal_image)
        if roughness_image is not None and roughness_image.ndim == 3 and roughness_image.shape[-1] == 3:
            roughness_image = roughness_image[..., :1]
        if depth_image is not None and depth_image.ndim == 3 and depth_image.shape[-1] == 3:
            depth_image = depth_image[..., :1]

        self._original_image = hdr(image)
        self._diffuse_image = hdr(diffuse_image)
        self._specular_image = hdr(specular_image)
        self._normal_image = normal_image
        self._depth_image = lin(depth_image)
        self._roughness_image = lin(roughness_image)
        self._f0_image = lin(f0_image)

        self.znear = 0.01
        self.zfar = 100.0
        self.update()

    @classmethod
    def from_cam_info(cls, ci):
        return cls(
            colmap_id=ci.uid, R=ci.R, T=ci.T, FoVx=ci.FovX, FoVy=ci.FovY,
            image=ci.image, image_name=ci.image_name, uid=ci.uid,
            specular_image=ci.specular_image, diffuse_image=ci.diffuse_image,
            depth_image=ci.depth_image, normal_image=ci.normal_image,
            roughness_image=ci.roughness_image, f0_image=ci.f0_image,
        )

    def _f32(self, a) -> Optional[np.ndarray]:
        return None if a is None else np.asarray(a, np.float32)

    @property
    def original_image(self):
        return self._f32(self._original_image)

    @property
    def diffuse_image(self):
        return self._f32(self._diffuse_image)

    @property
    def specular_image(self):
        return self._f32(self._specular_image)

    @property
    def normal_image(self):
        return self._f32(self._normal_image)

    @property
    def depth_image(self):
        return self._f32(self._depth_image)

    @property
    def roughness_image(self):
        return self._f32(self._roughness_image)

    @property
    def f0_image(self):
        return self._f32(self._f0_image)

    def update(self):
        self.world_view_transform = getWorld2View2(
            self.R, self.T, self.trans, self.scale
        ).T
        self.projection_matrix = getProjectionMatrix(
            znear=0.01, zfar=100.0, fovX=self.FoVx, fovY=self.FoVy
        ).T
        self.full_proj_transform = self.world_view_transform @ self.projection_matrix
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]

    def render_pose(self, znear=0.01, zfar=999.9):
        """Pose in the renderer's convention (gaussian_raytracer.py:95-103).

        Returns (origin[3], c2w_render[3,3], fov_y, znear, zfar); ZNEAR/ZFAR
        env vars override like the reference.
        """
        Rc2w = -np.asarray(self.R, np.float32)
        Rc2w[:, 0] = -Rc2w[:, 0]
        zn = float(os.getenv("ZNEAR", znear))
        zf = float(os.getenv("ZFAR", zfar))
        return (
            np.asarray(self.camera_center, np.float32),
            Rc2w,
            np.float32(self.FoVy),
            np.float32(zn),
            np.float32(zf),
        )


class MiniCam:
    """Pose-only camera for the viewer (cameras.py:155-177)."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.image_width = width
        self.image_height = height
        self.FoVy = fovy
        self.FoVx = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = np.asarray(world_view_transform)
        self.full_proj_transform = np.asarray(full_proj_transform)
        view_inv = np.linalg.inv(self.world_view_transform)
        self.camera_center = view_inv[3][:3]
        self.R = self.world_view_transform[:3, :3]

    def render_pose(self, znear=None, zfar=None):
        Rc2w = -np.asarray(self.R, np.float32)
        Rc2w[:, 0] = -Rc2w[:, 0]
        zn = float(os.getenv("ZNEAR", self.znear if znear is None else znear))
        zf = float(os.getenv("ZFAR", self.zfar if zfar is None else zfar))
        return (
            np.asarray(self.camera_center, np.float32),
            Rc2w,
            np.float32(self.FoVy),
            np.float32(zn),
            np.float32(zf),
        )
