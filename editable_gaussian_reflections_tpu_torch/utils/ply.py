"""Minimal binary-little-endian PLY codec (no plyfile dependency); the
port's copy of the JAX package's pure-numpy utils/ply.py.

Byte-compatible with the reference's 21-float vertex schema
(scene/gaussian_model.py:354-462):
  x,y,z, f_dc_0..2, opacity, scale_0..2, rot_0..3, normal_0..2, roughness,
  f0_0..2
and the simple xyz+rgb PLYs used for point-cloud init
(utils/ply_utils.py / dataset points).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

GAUSSIAN_FIELDS: List[str] = [
    "x", "y", "z",
    "f_dc_0", "f_dc_1", "f_dc_2",
    "opacity",
    "scale_0", "scale_1", "scale_2",
    "rot_0", "rot_1", "rot_2", "rot_3",
    "normal_0", "normal_1", "normal_2",
    "roughness",
    "f0_0", "f0_1", "f0_2",
]

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read the first (vertex) element of a PLY file into a dict of columns.

    Supports binary_little_endian and ascii formats, scalar properties only
    (list properties terminate parsing of later elements).
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().split()
            if not tokens:
                continue
            if tokens[0] == b"format":
                fmt = tokens[1].decode()
            elif tokens[0] == b"element":
                cur = (tokens[1].decode(), int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == b"property":
                if tokens[1] == b"list":
                    cur[2].append(("__list__", tokens[-1].decode()))
                else:
                    cur[2].append((tokens[-1].decode(), tokens[1].decode()))
            elif tokens[0] == b"end_header":
                break

        name, count, props = elements[0]
        if any(p[0] == "__list__" for p in props):
            raise ValueError(f"{path}: list properties unsupported")
        dtype = np.dtype([(n, _PLY_TO_NP[t]) for n, t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count)
        elif fmt == "ascii":
            rows = [f.readline().split() for _ in range(count)]
            arr = np.array(rows, dtype=np.float64)
            data = np.zeros(count, dtype=dtype)
            for i, (n, _) in enumerate(props):
                data[n] = arr[:, i]
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")
        return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_ply(path, columns: Dict[str, np.ndarray], comment: str | None = None):
    """Write float32 scalar columns as a binary_little_endian vertex element."""
    names = list(columns)
    count = len(next(iter(columns.values())))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    dtype = np.dtype([(n, "<f4") for n in names])
    data = np.zeros(count, dtype=dtype)
    for n in names:
        col = np.asarray(columns[n]).reshape(count)
        data[n] = col.astype(np.float32)
    header = ["ply", "format binary_little_endian 1.0"]
    if comment:
        header.append(f"comment {comment}")
    header.append(f"element vertex {count}")
    header += [f"property float {n}" for n in names]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(data.tobytes())


def save_gaussian_ply(path, xyz, diffuse, opacity, scaling, rotation, normal,
                      roughness, f0):
    """The 21-field checkpoint PLY (gaussian_model.py:354-407)."""
    n = xyz.shape[0]
    cols = {}
    arrs = np.concatenate(
        [
            np.asarray(xyz).reshape(n, 3),
            np.asarray(diffuse).reshape(n, 3),
            np.asarray(opacity).reshape(n, 1),
            np.asarray(scaling).reshape(n, 3),
            np.asarray(rotation).reshape(n, 4),
            np.asarray(normal).reshape(n, 3),
            np.asarray(roughness).reshape(n, 1),
            np.asarray(f0).reshape(n, 3),
        ],
        axis=1,
    ).astype(np.float32)
    for i, name in enumerate(GAUSSIAN_FIELDS):
        cols[name] = arrs[:, i]
    write_ply(path, cols)


def load_gaussian_ply(path):
    """Returns dict of arrays: xyz, diffuse, opacity, scaling, rotation,
    normal, roughness, f0 (float32, [N,*] shapes)."""
    c = read_ply(path)
    n = len(c["x"])

    def stack(names):
        return np.stack([c[nm].astype(np.float32) for nm in names], axis=1)

    return dict(
        xyz=stack(["x", "y", "z"]),
        diffuse=stack(["f_dc_0", "f_dc_1", "f_dc_2"]),
        opacity=c["opacity"].astype(np.float32).reshape(n),
        scaling=stack(["scale_0", "scale_1", "scale_2"]),
        rotation=stack(["rot_0", "rot_1", "rot_2", "rot_3"]),
        normal=stack(["normal_0", "normal_1", "normal_2"]),
        roughness=c["roughness"].astype(np.float32).reshape(n),
        f0=stack(["f0_0", "f0_1", "f0_2"]),
    )


def save_xyzrgb_ply(path, xyz, rgb):
    """Init point clouds (utils/ply_utils.py schema: x,y,z,red,green,blue)."""
    write_ply(
        path,
        {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
        },
    )


def load_xyzrgb_ply(path):
    """Init point clouds (utils/ply_utils.py schema: x,y,z,red,green,blue)."""
    c = read_ply(path)
    xyz = np.stack([c["x"], c["y"], c["z"]], axis=1).astype(np.float32)
    if "red" in c:
        rgb = np.stack([c["red"], c["green"], c["blue"]], axis=1).astype(np.float32)
        if rgb.max() > 1.5:  # uchar colors
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb
