"""Novel-view camera path generation - the port's copy of the JAX package's
utils/cam_paths.py (twin of reference utils/cam_utils.py;
EnvGS/regnerf-style spiral paths), numpy-native."""

from __future__ import annotations

import numpy as np


def normalize(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-13)


def closest_point_2_lines(oa, da, ob, db):
    """cam_utils.py:50-60."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det(np.stack([t, db, c])) / (denom + 1e-10)
    tb = np.linalg.det(np.stack([t, da, c])) / (denom + 1e-10)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def compute_center_of_attention(c2ws: np.ndarray):
    """cam_utils.py:36-48."""
    totw = 0.0
    totp = np.zeros(3, np.float32)
    for mf in c2ws:
        for mg in c2ws:
            p, w = closest_point_2_lines(mf[:, 3], mf[:, 2], mg[:, 3], mg[:, 2])
            if w > 0.01:
                totp += p * w
                totw += w
    totp /= totw
    return totp[..., None]


def average_c2ws(c2ws, align_cameras=True, look_at_center=True):
    """cam_utils.py:63-108."""
    if align_cameras:
        center = compute_center_of_attention(c2ws)[..., 0]
        z = -normalize(c2ws[..., 1].mean(0))
        y_ = c2ws[..., 2].mean(0)
        x = -normalize(np.cross(z, y_))
        y = -np.cross(x, z)
    else:
        center = c2ws[..., 3].mean(0)
        if look_at_center:
            look = compute_center_of_attention(c2ws)[..., 0]
            z = normalize(look - center)
        else:
            z = normalize(c2ws[..., 2].mean(0))
        y_ = c2ws[..., 1].mean(0)
        x = -normalize(np.cross(z, y_))
        y = -np.cross(x, z)
    return np.stack([x, y, z, center], 1)


def generate_spiral_path(
    c2ws: np.ndarray,
    n_render_views=300,
    n_rots=2,
    zrate=0.5,
    percentile=70,
    focal_offset=0.0,
    radius_ratio=1.0,
    xyz_ratio=(1.0, 1.0, 0.25),
    xyz_offset=(0.0, 0.0, 0.0),
    **kwargs,
) -> np.ndarray:
    """Forward-facing spiral path (cam_utils.py:110-164)."""
    c2ws = c2ws[..., :3, :4]
    c2w_avg = average_c2ws(c2ws, align_cameras=False, look_at_center=True)
    v_up = -normalize(c2ws[:, :3, 1].sum(0))
    focal = focal_offset + np.linalg.norm(
        compute_center_of_attention(c2ws)[..., 0] - c2w_avg[..., 3]
    )
    radii = np.percentile(
        np.abs(c2ws[:, :3, 3] - c2w_avg[..., 3]), percentile, 0
    ) * radius_ratio
    radii = np.concatenate([np.asarray(xyz_ratio) * radii, [1.0]])

    render_c2ws = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_render_views,
                             endpoint=False):
        t = radii * [np.cos(theta), np.sin(theta), np.sin(theta * zrate), 1.0]
        t = t + np.concatenate([np.asarray(xyz_offset), [0.0]])
        center = (c2w_avg @ t).astype(c2ws.dtype)
        lookat = c2w_avg @ np.array([0, 0, focal, 1.0], dtype=c2ws.dtype)
        v_front = -normalize(center - lookat)
        v_right = normalize(np.cross(v_front, v_up))
        v_down = np.cross(v_front, v_right)
        render_c2ws.append(np.stack([v_right, v_down, v_front, center], axis=-1))
    return np.stack(render_c2ws, axis=0)
