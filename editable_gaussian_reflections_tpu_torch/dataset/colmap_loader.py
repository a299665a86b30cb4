"""Pure-python COLMAP sparse-reconstruction readers.

The port's copy of the JAX package's dataset/colmap_loader.py (twin of
reference dataset/colmap_loader.py): binary and text
readers for cameras/images/points3D plus qvec2rotmat.  Implemented from the
COLMAP file-format spec (fixed little-endian records).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


def qvec2rotmat(qvec):
    """Scalar-first quaternion -> rotation matrix (COLMAP convention)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
    ])


def rotmat2qvec(R):
    import torch

    from ..ops.quaternion import rotmat_to_quat
    return rotmat_to_quat(
        torch.as_tensor(np.asarray(R, np.float32))).numpy()


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * num_pts),
                                 dtype=[("xy", "<f8", 2), ("id", "<i8")])
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"),
                np.ascontiguousarray(data["xy"]),
                np.ascontiguousarray(data["id"]),
            )
    return images


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(p) for p in pts], np.float64)
        if xys.size:
            xys = xys.reshape(-1, 3)
            point_ids = xys[:, 2].astype(np.int64)
            xys = xys[:, :2]
        else:
            point_ids = np.zeros(0, np.int64)
            xys = np.zeros((0, 2))
        images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys,
                                     point_ids)
    return images


def read_points3D_binary(path):
    """Returns (xyz [N,3], rgb [N,3] uint8, errors [N], ids [N]).  One
    struct unpack a record (id, xyz, rgb, error, track length), the track
    skipped."""
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    record = struct.Struct("<Q3d3BdQ")
    rows, off = [], 8
    for _ in range(num):
        row = record.unpack_from(data, off)
        rows.append(row)
        off += record.size + 8 * row[-1]
    if not rows:
        return (np.zeros((0, 3)), np.zeros((0, 3), np.uint8), np.zeros(0),
                np.zeros(0, np.int64))
    cols = list(zip(*rows))
    return (np.array(cols[1:4]).T.copy(),
            np.array(cols[4:7], np.uint8).T.copy(),
            np.array(cols[7], np.float64), np.array(cols[0], np.int64))


def read_points3D_text(path):
    xyz, rgb, err, ids = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ids.append(int(parts[0]))
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([int(p) for p in parts[4:7]])
            err.append(float(parts[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err),
            np.array(ids, np.int64))


def read_model(sparse_dir):
    """Auto-detect binary vs text; returns (cameras, images, points)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3D_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3D_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts
