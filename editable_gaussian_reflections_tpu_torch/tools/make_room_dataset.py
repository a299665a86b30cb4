"""Render the synthetic room into a Blender-format dataset - twin of the
root tools/make_room_dataset.py.

    python -m editable_gaussian_reflections_tpu_torch.tools.make_room_dataset \\
        [--out /tmp/room_dataset] [--size 128] [--n_gaussians 20000] \\
        [--n_train 10] [--n_test 2] [--spp 4] [--extent 3.0] [--device cpu]

room_scene(n, extent, farfield_fraction=0.25) padded to 2048 rows is
written as gt_scene.ply; n_train + n_test orbit views around the room's
centre are rendered at `--spp` with 2 bounces, and each view's seven
buffers (render, diffuse, specular, depth, normal, roughness, f0) are
written as float32 TIFFs with utils/image.write_tiff, beside
transforms_{split}.json; point_cloud_dense.ply holds the jittered centres
(the dense-init analog).  A view renders on the fused k-buffer path where
the JAX tool takes it (a card, and fused_path_ok at cluster 128), else with
render_accumulated (2048-row chunks, 8192-ray tiles): on the card through
the brute trace kernel, on the CPU through the plain tracer, as JAX renders
on the CPU.  View i of the dataset draws its samples from seed 1000 + i.
On the card unless `--device cpu`; without a card and without it the tool
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..renderer.raytracer import (
    RenderSettings,
    fused_path_ok,
    render_accumulated,
    render_accumulated_fused,
)
from ..scene.gaussian_scene import from_arrays
from ..scene.scene import save_scene_ply
from ..utils.image import write_tiff
from ..utils.ply import save_xyzrgb_ply
from ..utils.synth import camera_at, room_scene

# the buffers of a view, in the order they are written
BUFFERS = ("render", "diffuse", "specular", "depth", "normal", "roughness",
           "f0")


def look_at_blender_c2w(eye, target):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    u = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = u
    c2w[:3, 2] = -fwd     # OpenGL: camera looks down -z
    c2w[:3, 3] = eye
    return c2w


def orbit_eye(k: int, n_views: int, extent: float) -> np.ndarray:
    """The eye of view k of n_views orbiting the room (the JAX tool's)."""
    ang = 2 * np.pi * k / n_views
    return np.array([
        extent * 0.7 * np.cos(ang),
        extent * 0.7 * np.sin(ang),
        extent * (0.6 + 0.3 * (k % 3) / 2),
    ])


def use_fused(scene, size: int, device: torch.device) -> bool:
    """The JAX tool's route: the fused k-buffer path on an accelerator
    where fused_path_ok holds at cluster 128."""
    return device.type == "cuda" and fused_path_ok(scene, size, size, 128)


def render_view(scene, c2w, eye, seed: int, size: int, spp: int,
                fused: bool, device: torch.device) -> dict:
    """One view's seven buffers as float32 numpy arrays ([H, W, 3] or
    [H, W]).  The OpenGL/Blender c2w is the renderer's convention (dir =
    c2w @ [x, y_up, -1]); the dataset loader's GL -> COLMAP -> render pose
    round trip reconstructs exactly it.  fused=False renders with the trace
    kernel on the card and the plain tracer on the CPU."""
    cam = camera_at(eye, c2w[:3, :3], device)
    settings = RenderSettings()
    if fused:
        steps, final = render_accumulated_fused(
            scene, cam, settings, seed, size, size, spp=spp, num_bounces=2,
            max_hits=32, cull_cluster=128, max_clusters=192)
    else:
        steps, final = render_accumulated(
            scene, cam, settings, seed, size, size, spp=spp, num_bounces=2,
            max_hits=32, chunk=2048, tile=8192,
            use_pallas=device.type == "cuda")
    H = W = size

    def host(t, *shape):
        return t.reshape(H, W, *shape).cpu().numpy().astype(np.float32)

    return {
        "render": host(final, 3),
        "diffuse": host(steps.rgb[0], 3),
        "specular": host(steps.rgb[1:].sum(0), 3),
        "depth": host(steps.depth[0]),
        "normal": host(steps.normal[0], 3),
        "roughness": host(steps.roughness[0]),
        "f0": host(steps.f0[0], 3),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="make_room_dataset", allow_abbrev=False)
    p.add_argument("--out", default="/tmp/room_dataset")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--n_gaussians", type=int, default=20000)
    p.add_argument("--n_train", type=int, default=10)
    p.add_argument("--n_test", type=int, default=2)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--extent", type=float, default=3.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    arrs = room_scene(args.n_gaussians, extent=args.extent,
                      farfield_fraction=0.25)
    scene = from_arrays(**arrs, pad_multiple=2048, device=dev)
    os.makedirs(args.out, exist_ok=True)
    save_scene_ply(os.path.join(args.out, "gt_scene.ply"), scene)

    target = np.array([0.0, 0.0, args.extent * 0.75])
    fused = use_fused(scene, args.size, dev)
    n_views = args.n_train + args.n_test

    def render_split(split, count, offset):
        frames = []
        for i in range(count):
            eye = orbit_eye(i + offset, n_views, args.extent)
            c2w = look_at_blender_c2w(eye, target)
            bufs = render_view(scene, c2w, eye, 1000 + i + offset, args.size,
                               args.spp, fused, dev)
            name = f"{split}_render_{i:03d}"
            for buf in BUFFERS:
                write_tiff(os.path.join(
                    args.out, name.replace("render", buf) + ".tiff"),
                    bufs[buf])
            frames.append({"file_path": name,
                           "transform_matrix": c2w.tolist()})
            print(f"rendered {split} {i + 1}/{count}")
        with open(os.path.join(args.out, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": 0.9, "camera_angle_y": 0.9,
                       "frames": frames}, f)

    render_split("train", args.n_train, 0)
    render_split("test", args.n_test, args.n_train)

    # init point cloud: jittered GT means (the dense-init analog)
    rng = np.random.default_rng(0)
    n_init = min(args.n_gaussians, 120000)
    idx = rng.permutation(args.n_gaussians)[:n_init]
    pts = arrs["xyz"][idx] + rng.normal(0, 0.02, (n_init, 3)).astype(
        np.float32)
    cols = np.clip(arrs["diffuse"][idx], 0, 1)
    save_xyzrgb_ply(os.path.join(args.out, "point_cloud_dense.ply"), pts,
                    cols)
    print(f"dataset written -> {args.out}")


if __name__ == "__main__":
    main()
