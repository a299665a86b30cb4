"""Depth utilities - the port's copy of the JAX package's utils/depth.py
(twin of reference utils/depth_utils.py, numpy-native).

Used by dense PLY init (unproject GT depth along camera rays) and the prior
datasets (monocular-depth rescaling via RANSAC against sparse COLMAP depth).
"""

from __future__ import annotations

import math
import random

import numpy as np


def compute_primary_ray_directions(height, width, vertical_fov_radians,
                                   rotation_c2w):
    """World-space primary ray dirs per pixel, (H, W, 3) (depth_utils.py:27-63).

    Identical math to the device camera (camera.h:17-36); camera looks down -z
    in the c2w frame used by the renderer.
    """
    view_size = math.tan(vertical_fov_radians * 0.5)
    aspect = width / float(height)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    u = (xs + 0.5) / width
    v = (ys + 0.5) / height
    x = aspect * view_size * (2.0 * u - 1.0)
    y = view_size * (1.0 - 2.0 * v)
    dirs_cam = np.stack([x, y, -np.ones_like(x)], axis=-1)
    dirs_world = dirs_cam @ np.asarray(rotation_c2w).T
    return dirs_world / np.linalg.norm(dirs_world, axis=-1, keepdims=True)


def transform_depth_to_position_image(depth, fov_x_rad, fov_y_rad):
    """depth (H,W) -> camera-space positions (H,W,3) (depth_utils.py:66-99)."""
    H, W = depth.shape
    fx = W / (2 * math.tan(fov_x_rad / 2))
    fy = H / (2 * math.tan(fov_y_rad / 2))
    cx, cy = W / 2, H / 2
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64), indexing="xy")
    Z = depth
    X = (u - cx) * Z / fx
    Y = (v - cy) * Z / fy
    return np.stack([X, Y, Z], axis=-1)


def transform_points(points, transformation_matrix):
    """Apply 4x4 to (..., 3) points (depth_utils.py:102-129)."""
    shape = points.shape[:-1]
    flat = points.reshape(-1, 3)
    hom = np.concatenate([flat, np.ones((flat.shape[0], 1))], axis=1)
    out = hom @ np.asarray(transformation_matrix).T
    return out[:, :3].reshape(*shape, 3)


def project_pointcloud_to_depth_map(points, fov_x_rad, fov_y_rad, image_size):
    """Camera-space points -> sparse nearest-depth map (depth_utils.py:130-180)."""
    H, W = image_size
    fx = W / (2 * math.tan(fov_x_rad / 2))
    fy = H / (2 * math.tan(fov_y_rad / 2))
    cx, cy = W / 2, H / 2
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    valid = z > 0
    x, y, z = x[valid], y[valid], z[valid]
    u = np.round(x * fx / z + cx).astype(np.int64)
    v = np.round(y * fy / z + cy).astype(np.int64)
    mask = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z = u[mask], v[mask], z[mask]
    lin = v * W + u
    order = np.lexsort((z, lin))
    lin_s = lin[order]
    keep = np.ones_like(lin_s, bool)
    keep[1:] = lin_s[1:] != lin_s[:-1]
    depth_map = np.zeros((H, W))
    depth_map[v[order][keep], u[order][keep]] = z[order][keep]
    return depth_map


def transform_normals_to_world(normals_camera, view_matrix):
    """depth_utils.py:7-16 (camera normals flipped then rotated to world)."""
    n = -1.0 * np.asarray(normals_camera)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return np.einsum("ij,...j->...i", np.asarray(view_matrix), n)


def transform_normals_world_to_camera(normals_world, view_matrix):
    """depth_utils.py:19-25."""
    n = np.einsum("ij,...j->...i", np.asarray(view_matrix).T,
                  np.asarray(normals_world))
    return -1.0 * n


def linear_least_squares_1d(x, y):
    """(w, b) for y ~ w x + b (depth_utils.py:183-203)."""
    X = np.stack([x, np.ones_like(x)], axis=1)
    theta, *_ = np.linalg.lstsq(X, y, rcond=None)
    return float(theta[0]), float(theta[1])


def ransac_linear_fit(x, y, num_iters=100, sample_fraction=0.1,
                      max_sample_size=50, best_fraction=0.1,
                      rng: random.Random | None = None):
    """Robust linear fit keeping the best-residual fraction (depth_utils.py:206-278).

    The samples are drawn from `rng`, by default the `random` module's own
    generator (which the JAX package draws from, unseeded): a caller that
    seeds a random.Random and the module alike gets the same fit."""
    draw = random if rng is None else rng
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    N = x.shape[0]
    sample_size = min(max(2, math.ceil(N * sample_fraction)), max_sample_size)
    top_k = max(1, math.ceil(N * best_fraction))

    best_model, best_inliers, best_error = None, None, None
    for _ in range(num_iters):
        idxs = draw.sample(range(N), sample_size)
        xs, ys = x[idxs], y[idxs]
        if float(np.ptp(xs)) < 1e-12:
            # Degenerate sample (all x identical): lstsq returns a
            # minimum-norm line through the duplicates that scores 0 on its
            # own top-k and beats the true fit. Skip (robustness guard the
            # reference lacks; depth_utils.py:240-249 hits the same trap).
            continue
        X = np.stack([xs, np.ones_like(xs)], axis=1)
        wb, *_ = np.linalg.lstsq(X, ys, rcond=None)
        if wb.size < 2:
            continue
        w, b = wb[0], wb[1]
        residuals = np.abs(y - (w * x + b))
        best_idx = np.argpartition(residuals, top_k - 1)[:top_k]
        inliers = np.zeros(N, bool)
        inliers[best_idx] = True
        error = float((residuals[best_idx] ** 2).sum())
        if best_error is None or error < best_error:
            best_model, best_inliers, best_error = (w, b), inliers, error

    if best_model is not None and best_inliers is not None:
        xi, yi = x[best_inliers], y[best_inliers]
        if float(np.ptp(xi)) < 1e-12:
            # Refit would be rank-deficient (top-k landed on duplicated x,
            # e.g. quantized mono-depth): keep the candidate line instead.
            return (float(best_model[0]), float(best_model[1])), best_inliers
        X = np.stack([xi, np.ones_like(xi)], axis=1)
        wb, *_ = np.linalg.lstsq(X, yi, rcond=None)
        return (float(wb[0]), float(wb[1])), best_inliers
    return None, None
