"""A Blender-prior dataset on disk (the layout of run_all_synthetic_priors.sh's
scenes: dataset/blender_prior.py), built from the port's render, as
`chip_smoke.py` phase 19 trains, renders and scores it.

The views are tools/cli_setup.py's (gbuffer_views: orbit views of the room,
G-buffers the port's render of the seed-0 room_scene(n)); the COLMAP
sparse model holds the seed-1 room's centres and diffuse colours, each
with a track for every view that sees it: it projects onto a pixel whose
rendered depth is within VISIBLE of its own (the others are occluded, or
lie where the render's alpha-blended depth is not yet the surface's), so
that the dataset's RANSAC depth rescale runs on true correspondences.
Everything is written with the port's own writers (utils/image.write_png,
struct):

  * {split}/{render,diffuse,specular}/..._{id}.png: tonemapped 8-bit RGB;
  * {split}/{roughness,metalness,depth}/..._{id}.png: 16-bit gray, the
    metalness solved from f0's channel mean (f0 = 0.04 (1 - m) + m), the
    depth the camera-space z of each pixel's rendered distance (the
    dataset's position-image convention), scaled per view to [0, 1] (the
    monocular prior the RANSAC fit rescales);
  * {split}/normal/..._{id}.png: camera-space normals as 8-bit RGB
    (n_cam * 0.5 + 0.5, n_cam = -R^T n_world);
  * transforms_{train,test}.json (Blender c2w, camera_angle_x/y) and
    sparse/0/{cameras,images,points3D}.bin (one PINHOLE camera).
"""

from __future__ import annotations

import json
import math
import os
import struct

import numpy as np
import torch

from ..dataset.colmap_loader import rotmat2qvec
from ..ops.tonemap import tonemap
from ..utils.image import write_png
from ..utils.synth import room_scene
from .cli_setup import gbuffer_views

BUFFERS = ("render", "diffuse", "specular", "roughness", "metalness", "depth",
           "normal")
# a point is seen by a view where its camera z is within this share of the
# view's rendered z at its pixel
VISIBLE = 0.01


def intrinsics(view):
    """(fx, fy, cx, cy) of a view in the prior datasets' convention
    (utils/depth.py: pixel u at (u - cx), cx = W / 2)."""
    W, H = view.image_width, view.image_height
    return (W / (2 * math.tan(view.FoVx / 2)),
            H / (2 * math.tan(view.FoVy / 2)), W / 2, H / 2)


def ray_length(view) -> np.ndarray:
    """[H, W] distance over camera-space z at each pixel (the dataset's
    transform_depth_to_position_image, inverted)."""
    fx, fy, cx, cy = intrinsics(view)
    v, u = np.mgrid[0:view.image_height, 0:view.image_width]
    return np.sqrt(1.0 + ((u - cx) / fx) ** 2 + ((v - cy) / fy) ** 2)


def w2c(view) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.asarray(view.R).T
    m[:3, 3] = view.T
    return m


def tonemapped8(x) -> np.ndarray:
    t = tonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()
    return np.round(np.clip(t, 0, 1) * 255).astype(np.uint8)


def gray16(x) -> np.ndarray:
    return np.round(np.clip(np.asarray(x, np.float64), 0, 1)
                    * 65535).astype(np.uint16)


def metalness(f0) -> np.ndarray:
    """[H, W] metalness whose 0.04 (1 - m) + m is f0's channel mean."""
    return np.clip((np.asarray(f0, np.float64).mean(-1) - 0.04) / 0.96, 0, 1)


def unit(n) -> np.ndarray:
    n = np.asarray(n, np.float64)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def write_buffers(buf_dir: str, frame_id: str, view) -> dict:
    """The 7 prior buffers of one view; returns its depth scaling (z_lo,
    z_hi: mono = (z - z_lo) / (z_hi - z_lo))."""
    dist = view.depth_image[..., 0].astype(np.float64)
    z = dist / ray_length(view)
    hit = dist > 0
    z_lo, z_hi = float(z[hit].min()), float(z[hit].max())
    n_cam = -np.einsum("ji,...j->...i", np.asarray(view.R), unit(
        view.normal_image))
    images = {
        "render": tonemapped8(view.original_image),
        "diffuse": tonemapped8(view.diffuse_image),
        "specular": tonemapped8(view.specular_image),
        "roughness": gray16(view.roughness_image[..., 0]),
        "metalness": gray16(metalness(view.f0_image)),
        "depth": gray16(np.where(hit, (z - z_lo) / (z_hi - z_lo), 0.0)),
        "normal": np.round(np.clip(n_cam * 0.5 + 0.5, 0, 1)
                           * 255).astype(np.uint8),
    }
    for name, img in images.items():
        d = os.path.join(buf_dir, name)
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{name}_{frame_id}.png"), img)
    return dict(z_lo=z_lo, z_hi=z_hi)


def project(points: np.ndarray, view):
    """(point rows, [M, 2] pixel coordinates) of the points `view` sees:
    in front of it, on its pixels (rounded as
    utils/depth.project_pointcloud_to_depth_map rounds them) and within
    VISIBLE of the rendered z there."""
    fx, fy, cx, cy = intrinsics(view)
    m = w2c(view)
    pc = points @ m[:3, :3].T + m[:3, 3]
    z = pc[:, 2]
    front = z > 0
    u = np.where(front, pc[:, 0] * fx / np.where(front, z, 1) + cx, -1)
    v = np.where(front, pc[:, 1] * fy / np.where(front, z, 1) + cy, -1)
    ui, vi = np.round(u), np.round(v)
    rows = np.nonzero(front & (ui >= 0) & (ui < view.image_width)
                      & (vi >= 0) & (vi < view.image_height))[0]
    rz = (view.depth_image[..., 0] / ray_length(view))[
        vi[rows].astype(np.int64), ui[rows].astype(np.int64)]
    rows = rows[np.abs(z[rows] - rz) <= VISIBLE * rz]
    return rows, np.stack([u[rows], v[rows]], -1)


def write_colmap(sparse_dir: str, views, names, points, colors) -> list:
    """sparse/0 in COLMAP's binary format; returns each image's number of
    observations."""
    os.makedirs(sparse_dir, exist_ok=True)
    fx, fy, cx, cy = intrinsics(views[0])
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, views[0].image_width,
                            views[0].image_height))           # PINHOLE
        f.write(struct.pack("<4d", fx, fy, cx, cy))
    obs_dtype = np.dtype([("xy", "<f8", 2), ("id", "<i8")])
    tracks = []       # (point row, image id, 2D index) per observation
    counts = []
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, (view, name) in enumerate(zip(views, names)):
            rows, xy = project(points, view)
            obs = np.zeros(rows.size, obs_dtype)
            obs["xy"], obs["id"] = xy, rows + 1
            m = w2c(view)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *rotmat2qvec(m[:3, :3])))
            f.write(struct.pack("<3d", *m[:3, 3]))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", rows.size))
            f.write(obs.tobytes())
            tracks.append(np.stack([rows, np.full_like(rows, i + 1),
                                    np.arange(rows.size)], -1))
            counts.append(int(rows.size))
    tracks = np.concatenate(tracks)
    tracks = tracks[np.argsort(tracks[:, 0], kind="stable")]
    starts = np.searchsorted(tracks[:, 0], np.arange(len(points) + 1))
    rgb = np.round(np.clip(colors, 0, 1) * 255).astype(np.uint8)
    record = struct.Struct("<Q3d3BdQ")
    chunks = [struct.pack("<Q", len(points))]
    for p in range(len(points)):
        track = tracks[starts[p]:starts[p + 1], 1:].astype("<i4")
        chunks.append(record.pack(p + 1, *points[p].tolist(),
                                  *rgb[p].tolist(), 0.5, len(track)))
        chunks.append(track.tobytes())
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(b"".join(chunks))
    return counts


def write_prior_dataset(out_dir: str, n: int, side: int, n_train: int,
                        n_test: int, device) -> dict:
    """The dataset under `out_dir` from gbuffer_views(n, side, ...) on
    `device`.  Returns dict(views=(train, test) cameras as rendered,
    depth=[per-view z scaling], observations=[per-view counts],
    names=[frame file names])."""
    train, test = gbuffer_views(n, side, n_train, n_test, device)
    views = list(train) + list(test)
    room = room_scene(n, seed=1)
    ids = [f"{i:03d}" for i in range(len(views))]
    depth = []
    for split, lo, cnt in (("train", 0, n_train),
                           ("test", n_train, n_test)):
        frames = []
        for i in range(lo, lo + cnt):
            v = views[i]
            depth.append(write_buffers(os.path.join(out_dir, split), ids[i],
                                       v))
            c2w = np.linalg.inv(w2c(v))
            c2w[:3, 1:3] *= -1          # COLMAP -> Blender axes
            frames.append({"file_path": f"{split}/r_{ids[i]}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": views[lo].FoVx,
                       "camera_angle_y": views[lo].FoVy,
                       "frames": frames}, f)
    counts = write_colmap(os.path.join(out_dir, "sparse", "0"), views,
                          [f"r_{i}.png" for i in ids],
                          room["xyz"].astype(np.float64), room["diffuse"])
    return dict(views=(train, test), depth=depth, observations=counts,
                names=[f"r_{i}" for i in ids])
