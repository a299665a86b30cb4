"""A viewer model directory on disk, as `chip_smoke.py` phase 20 opens it
with ViewerState.from_ply, and the poses its scripted client sends.

The directory is what train.py writes for a trained scene: the seed-0
room_scene(n) saved with the port's save_scene_ply as
point_cloud/iteration_1/point_cloud.ply, cfg.json (the Config defaults at
side x side), transforms_train.json (the orbit views of
tools/fused_setup.py, Blender axes) and a bounding_boxes.json around the
room's three sphere objects: one box, one elliptic cylinder ("cyl") that
excludes the first box, and one box with an f0 filter and a zrange.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..config import Config, save_config
from ..scene.gaussian_scene import from_arrays
from ..scene.scene import save_scene_ply
from ..utils.synth import room_camera, room_scene
from .fused_setup import orbit_views
from .prior_setup import w2c

OBJECTS = ("sphere_0", "sphere_1", "sphere_2")
# the boxes' half-width over each sphere's radius
BOX_MARGIN = 1.05
FOVY = 0.9


def room_objects(n: int, extent: float = 3.0, seed: int = 0):
    """(centers [3, 3], radii [3]) of room_scene(n, extent, seed)'s sphere
    objects, from the same draws (utils/synth.py)."""
    rng = np.random.default_rng(seed)
    per_wall = (n - int(n * 0.3)) // 8
    for _ in range(6):
        rng.uniform(-extent, extent, (per_wall, 3))
    centers = rng.uniform(-extent * 0.5, extent * 0.5, (3, 3))
    centers[:, 2] = extent * 0.75
    return centers, rng.uniform(0.3, 0.7, 3)


def bounding_boxes(centers, radii) -> dict:
    def box(i):
        h = radii[i] * BOX_MARGIN
        return {"min": (centers[i] - h).tolist(),
                "max": (centers[i] + h).tolist()}

    return {
        OBJECTS[0]: box(0),
        OBJECTS[1]: dict(box(1), cyl=True, exclude=[OBJECTS[0]]),
        # the objects are shiny (f0 0.3-0.9), the walls 0.04; the top half
        # of the box is kept whatever its f0
        OBJECTS[2]: dict(box(2), f0=[0.2, 1.0], zrange=0.5),
    }


def write_viewer_model(out_dir: str, n: int, side: int, n_views: int,
                       device) -> dict:
    """The model directory under `out_dir`; returns dict(centers, radii,
    boxes)."""
    scene = from_arrays(**room_scene(n, seed=0), pad_multiple=1,
                        device=device)
    ply = os.path.join(out_dir, "point_cloud", "iteration_1",
                       "point_cloud.ply")
    os.makedirs(os.path.dirname(ply), exist_ok=True)
    save_scene_ply(ply, scene)
    save_config(Config(resolution=side), os.path.join(out_dir, "cfg.json"))
    centers, radii = room_objects(n)
    boxes = bounding_boxes(centers, radii)
    with open(os.path.join(out_dir, "bounding_boxes.json"), "w") as f:
        json.dump(boxes, f)
    views = orbit_views(n_views, side, side)
    frames = []
    for i, v in enumerate(views):
        c2w = np.linalg.inv(w2c(v))
        c2w[:3, 1:3] *= -1          # COLMAP -> Blender axes
        frames.append({"file_path": f"train/r_{i:03d}",
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(out_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": views[0].FoVx,
                   "camera_angle_y": views[0].FoVy, "frames": frames}, f)
    return dict(centers=centers, radii=radii, boxes=boxes)


def look_at(eye, target, fovy: float = FOVY) -> dict:
    """A camera in the tick protocol's convention: R's columns (right,
    down, forward), z up (room_camera's basis)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    return dict(R=R.tolist(), camera_center=eye.tolist(), fovy=fovy)


def room_view() -> dict:
    """room_camera's pose."""
    eye, c2w = room_camera()
    return look_at(eye, eye - c2w[:, 2].astype(np.float64))


def object_view(center, radius, distance: float = 3.0) -> dict:
    """A camera `distance` radii above a sphere object's centre (tilted
    towards -y), looking at the centre (the image centre): the objects
    stand side by side at one height, so none is in the way."""
    center = np.asarray(center, np.float64)
    away = np.array([0.0, -0.25, 1.0]) / np.hypot(0.25, 1.0)
    return look_at(center + away * radius * distance, center)
