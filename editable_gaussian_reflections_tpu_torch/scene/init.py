"""Scene initialization and dynamic-count operations (twin of the JAX
package's scene/init.py, itself the twin of reference
scene/gaussian_model.py):

  * create_from_pcd (:182-230) - init from a point cloud with knn-sized
    scales;
  * farfield_arrays (:232-284) - the random environment shell injected
    after the bounce warm-up, drawn from the caller's numpy Generator in
    the JAX package's order, so both packages get the same points from the
    same seed;
  * append_points, prune_mask, znear_prune_mask - the padded capacity and
    live mask stand in for the reference's optimizer-state surgery.

The host arrays stay numpy as in the JAX package; the scenes are tensors on
the caller's device, and the knn3 distances are computed there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..device import DEFAULT_DEVICE
from ..ops.precision import norm
from ..utils.general import inverse_sigmoid, mean_dist2_knn3
from ..utils.graphics import BasicPointCloud
from .gaussian_scene import (
    GaussianScene,
    from_arrays,
    num_live,
    pad_to,
    round_up,
)


def create_from_pcd(pcd: BasicPointCloud, cfg: Config,
                    pad_multiple: int = 2048,
                    device: torch.device | str = DEFAULT_DEVICE
                    ) -> GaussianScene:
    """gaussian_model.py:182-230: one Gaussian per point, isotropic scales
    from the mean squared distance to the 3 nearest points."""
    n = pcd.points.shape[0]
    dist2 = np.maximum(mean_dist2_knn3(pcd.points, device=device), 1e-7)
    scales = np.log(np.sqrt(dist2) * cfg.init_scale)[:, None].repeat(3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    opacity = np.full(n, inverse_sigmoid(cfg.init_opa), np.float32)
    diffuse = np.asarray(pcd.colors, np.float32)
    if cfg.clamp_max is not None:
        diffuse = np.clip(diffuse, 0.0, cfg.clamp_max)
    return from_arrays(
        xyz=np.asarray(pcd.points, np.float32),
        scaling=scales.astype(np.float32),
        rotation=rots,
        opacity=opacity,
        diffuse=diffuse,
        normal=np.asarray(pcd.normals, np.float32),
        f0=np.full((n, 3), cfg.init_f0, np.float32),
        roughness=np.full(n, cfg.init_roughness, np.float32),
        pad_multiple=pad_multiple,
        device=device,
    )


def farfield_arrays(cfg: Config, cameras_extent: float, camera_centers,
                    camera_znears, rng: np.random.Generator,
                    device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """gaussian_model.py:232-284, the book-demo extras of the environment
    (ADD_BOOK_INIT_PTS, NUM_BOOK_PTS, BOOK_PTS_SCALE) included: numpy arrays
    of the new Gaussians' parameters; their knn3 scales on `device`."""
    new_xyz = (
        np.clip(rng.standard_normal((cfg.init_num_pts_farfield, 3)), -3, 3)
        * cameras_extent * cfg.scene_extent_init_radius
    ).astype(np.float32)

    # drop points inside any camera's znear sphere (scene.py:88-105)
    keep = np.ones(new_xyz.shape[0], bool)
    for c, zn in zip(camera_centers, camera_znears):
        keep &= np.linalg.norm(new_xyz - np.asarray(c)[None], axis=1) >= zn
    new_xyz = new_xyz[keep]

    add_book_points = "ADD_BOOK_INIT_PTS" in os.environ
    num_book = 0
    if add_book_points:
        num_book = int(os.getenv("NUM_BOOK_PTS", 50000))
        extra = rng.random((num_book, 3)).astype(np.float32) * 0.3 + np.array(
            [-0.15, -0.10, -0.15], np.float32
        )
        new_xyz = np.concatenate([new_xyz, extra])

    n = new_xyz.shape[0]
    dist2 = np.maximum(mean_dist2_knn3(new_xyz, device=device), 1e-7)
    scaling = np.log(np.sqrt(dist2) * cfg.init_scale_farfield)[:, None].repeat(3, 1)
    if add_book_points and num_book > 0:
        scaling[-num_book:] = np.log(float(os.getenv("BOOK_PTS_SCALE", 0.001)))
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    opacity = np.full(n, inverse_sigmoid(cfg.init_opa_farfield), np.float32)
    diffuse = np.full((n, 3), cfg.init_diffuse_farfield, np.float32)
    if add_book_points and num_book > 0:
        diffuse[-num_book:] = rng.random((num_book, 3)).astype(np.float32)
    return dict(
        xyz=new_xyz.astype(np.float32),
        scaling=scaling.astype(np.float32),
        rotation=rotation,
        opacity=opacity,
        diffuse=diffuse,
        normal=np.zeros((n, 3), np.float32),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=np.zeros(n, np.float32),
    )


def append_points(scene: GaussianScene, new: dict,
                  pad_multiple: int = 2048) -> GaussianScene:
    """densification_postfix: the live Gaussians compacted to the front,
    then the new ones, padded to a multiple of `pad_multiple`."""
    dev = scene.xyz.device
    idx = torch.nonzero(scene.live_mask).squeeze(1)
    n_new = np.asarray(new["xyz"]).shape[0]
    needed = round_up(idx.numel() + n_new, pad_multiple)
    merged = {}
    for f in GaussianScene._fields[:-1]:
        old = getattr(scene, f)[idx]
        add = np.asarray(new[f], np.float32).reshape(
            (n_new,) + tuple(old.shape[1:]))
        merged[f] = torch.cat([old.cpu(), torch.from_numpy(add)]).numpy()
    out = from_arrays(**merged, pad_multiple=pad_multiple, device=dev)
    return pad_to(out, needed)


def prune_mask(scene: GaussianScene, kill: torch.Tensor) -> GaussianScene:
    """prune_points: clear live_mask where `kill`."""
    return scene._replace(live_mask=scene.live_mask & ~kill)


def znear_prune_mask(scene: GaussianScene, camera_centers,
                     camera_znears) -> torch.Tensor:
    """prune_znear_only: the Gaussians inside any camera's znear sphere."""
    dev = scene.xyz.device
    kill = torch.zeros(scene.capacity, dtype=torch.bool, device=dev)
    for c, zn in zip(camera_centers, camera_znears):
        c = torch.as_tensor(np.asarray(c, np.float32), device=dev)
        kill = kill | (norm(scene.xyz - c[None]) < zn)
    return kill


__all__ = [
    "create_from_pcd", "farfield_arrays", "append_points", "prune_mask",
    "znear_prune_mask", "num_live",
]
