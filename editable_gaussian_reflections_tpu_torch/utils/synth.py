"""Synthetic surface-like scenes for benchmarks and tests.

Real captures put Gaussians on surfaces (walls, floors, objects), which is
what makes spatial culling effective; uniform random blobs are a worst case
no renderer optimizes for.  `room_scene` builds a shiny_kitchen-like box:
6 walls + a few ellipsoidal objects + an optional far-field shell, with
surface-aligned normals and plausible material parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..renderer.raytracer import (
    RenderSettings,
    camera_from_numpy,
    render_accumulated_chunked,
)
from ..scene.gaussian_scene import from_arrays
from ..utils.general import inverse_sigmoid

# the synthetic room of the denoiser tools and its fused render's options
# (the root tools/denoiser_eval.py and tools/denoise_train.py)
ROOM_N = 100_000
ROOM_FRAME_KW = dict(num_bounces=2, max_hits=32, cull_cluster=128,
                     max_clusters=128)
ROOM_SPP_CHUNK = 16


def room_scene(n: int = 100_000, extent: float = 3.0, seed: int = 0,
               farfield_fraction: float = 0.3):
    """Returns dict of raw parameter arrays for scene.from_arrays."""
    rng = np.random.default_rng(seed)
    n_far = int(n * farfield_fraction)
    n_surf = n - n_far

    # 6 walls of a box [-e, e]^2 x [0, 1.5e] + 3 ellipsoid objects
    per_wall = n_surf // 8
    pts, nrm = [], []

    def wall(axis, sign, count):
        p = rng.uniform(-extent, extent, (count, 3))
        p[:, 2] = p[:, 2] * 0.25 + extent * 0.75  # z in [0.5e, e]
        p[:, axis] = sign * extent
        if axis == 2:
            p[:, 2] = extent * (0.5 if sign < 0 else 1.5)
        normal = np.zeros((count, 3))
        normal[:, axis] = -sign
        return p, normal

    for axis, sign in [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]:
        p, normal = wall(axis, sign, per_wall)
        pts.append(p)
        nrm.append(normal)

    # objects: spheres of surface points
    n_obj = n_surf - 6 * per_wall
    centers = rng.uniform(-extent * 0.5, extent * 0.5, (3, 3))
    centers[:, 2] = extent * 0.75
    radii = rng.uniform(0.3, 0.7, 3)
    per_obj = n_obj // 3
    for i in range(3):
        cnt = per_obj if i < 2 else n_obj - 2 * per_obj
        v = rng.normal(size=(cnt, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts.append(centers[i] + radii[i] * v)
        nrm.append(v)

    # far-field shell (add_farfield_points analog)
    v = rng.normal(size=(n_far, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts.append(v * extent * 4.0)
    nrm.append(np.zeros((n_far, 3)))

    xyz = np.concatenate(pts).astype(np.float32)
    normal = np.concatenate(nrm).astype(np.float32)
    n_total = xyz.shape[0]

    # scales ~ local spacing; far-field chunkier
    base_scale = extent * 2.0 / np.sqrt(max(n_surf, 1)) * 2.0
    scaling = np.log(
        rng.uniform(0.5, 1.5, (n_total, 3)) * base_scale
    ).astype(np.float32)
    scaling[-n_far:] = np.log(base_scale * 4.0)

    rotation = rng.normal(size=(n_total, 4)).astype(np.float32)
    opacity = np.full(n_total, inverse_sigmoid(0.5), np.float32)
    opacity[-n_far:] = inverse_sigmoid(0.1)
    diffuse = rng.uniform(0.1, 0.9, (n_total, 3)).astype(np.float32)
    f0 = np.full((n_total, 3), 0.04, np.float32)
    # a shiny floor + shiny objects
    shiny = (normal[:, 2] > 0.9) | (
        np.arange(n_total) >= 6 * per_wall
    ) & (np.arange(n_total) < n_surf)
    f0[shiny] = rng.uniform(0.3, 0.9)
    roughness = rng.uniform(0.3, 0.9, n_total).astype(np.float32)
    roughness[shiny] = 0.08

    return dict(xyz=xyz, scaling=scaling, rotation=rotation, opacity=opacity,
                diffuse=diffuse, normal=normal, f0=f0, roughness=roughness)


def room_camera(extent: float = 3.0):
    """A camera inside the room looking at its center."""
    eye = np.array([0.0, -extent * 0.8, extent * 0.9], np.float32)
    target = np.array([0.0, 0.0, extent * 0.75], np.float32)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # renderer convention: dir = c2w @ [x, y, -1] with y up
    c2w = np.stack([right, -down, -fwd], axis=1).astype(np.float32)
    return eye, c2w


def room(device: torch.device, n: int = ROOM_N):
    """room_scene(n) padded to 2048 rows on `device` (the denoiser tools'
    scene)."""
    return from_arrays(**room_scene(n), pad_multiple=2048, device=device)


def camera_at(eye, c2w, device: torch.device):
    """The synthetic-room tools' camera at `eye` with rotation `c2w` (fov
    0.9, znear 0.05, zfar 50)."""
    return camera_from_numpy(dict(
        origin=np.asarray(eye, np.float32), c2w=np.asarray(c2w, np.float32),
        fov_y=np.float32(0.9), znear=np.float32(0.05),
        zfar=np.float32(50.0)), device=device)


def room_frame(scene, camera, size: int, spp: int, seed: int) -> dict:
    """One frame of the denoiser tools at `spp` samples
    (render_accumulated_chunked, fused, ROOM_FRAME_KW): final, the primary
    diffuse, normal, depth and roughness as [H, W(, 3)] tensors on the
    scene's device."""
    dev = scene.xyz.device
    H = W = size
    steps, final = render_accumulated_chunked(
        scene, camera, RenderSettings(), seed, W, H, spp=spp,
        spp_chunk=ROOM_SPP_CHUNK, fused=True, **ROOM_FRAME_KW)
    return dict(final=final.reshape(H, W, 3).to(dev),
                diffuse=steps.rgb[0].reshape(H, W, 3).to(dev),
                normal=steps.normal[0].reshape(H, W, 3).to(dev),
                depth=steps.depth[0].reshape(H, W).to(dev),
                rough=steps.roughness[0].reshape(H, W).to(dev))
