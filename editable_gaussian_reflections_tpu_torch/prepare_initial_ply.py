"""Dense/sfm initialization point cloud - twin of the root
prepare_initial_ply.py (reference prepare_initial_ply.py).

    python -m editable_gaussian_reflections_tpu_torch.prepare_initial_ply \\
        -s <dataset> [--mode sfm|dense] [--voxel_scale 400] \\
        [--resolution 128] [--max_images N] [--device cpu]

dense mode: unproject the GT/prior depth along camera rays for every train
view, voxelize at voxel_scale, keep voxels hit >= 2 with averaged colours
-> point_cloud_dense.ply; 8-bit colours go through the port's untonemap
on the card unless `--device cpu`.  sfm mode: the COLMAP sparse points
(sparse/0) -> point_cloud_sfm.ply.  The PLY bytes are the root file's for
the same inputs.  Without a card and without `--device cpu` the CLI exits
non-zero.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .ops.tonemap import untonemap
from .scene.dataset_readers import get_dataset
from .utils.depth import compute_primary_ray_directions
from .utils.general import set_seeds
from .utils.ply import save_xyzrgb_ply


def main(argv=None):
    p = argparse.ArgumentParser(prog="prepare_initial_ply", allow_abbrev=False)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--mode", choices=["sfm", "dense"], default="dense")
    p.add_argument("--filename", default="point_cloud_{mode}.ply")
    p.add_argument("--voxel_scale", type=float, default=400.0)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda or cpu: where the colours are untonemapped")
    cli = p.parse_args(argv)
    dev = resolve_device(cli.device)

    set_seeds()

    if cli.mode == "sfm":
        from .dataset.colmap_parser import ColmapParser
        parser = ColmapParser(cli.source_path)
        print("SFM Point Cloud:", parser.points.shape)
        # deliberately NOT untonemapped (prepare_initial_ply.py:40-41)
        save_xyzrgb_ply(
            os.path.join(cli.source_path, cli.filename.format(mode="sfm")),
            parser.points, parser.points_rgb / 255.0,
        )
        return

    cfg = Config(resolution=cli.resolution, max_images=cli.max_images)
    dataset = get_dataset(cfg, cli.source_path, split="train")

    points_all, colors_all = [], []
    for idx in range(len(dataset)):
        ci = dataset[idx]
        depth = np.asarray(ci.depth_image, np.float32)
        if depth.ndim == 3:
            depth = depth[..., :1]
        R_blender = -np.asarray(ci.R).copy()
        R_blender[:, 0] = -R_blender[:, 0]
        ray_dirs = compute_primary_ray_directions(
            depth.shape[0], depth.shape[1], ci.FovY, R_blender[:3, :3]
        )
        origin = -np.asarray(ci.R) @ np.asarray(ci.T)
        positions = origin[None, None] + ray_dirs * depth
        points_all.append(positions.reshape(-1, 3))

        colors = np.asarray(ci.diffuse_image).reshape(-1, 3)
        if colors.dtype == np.uint8:
            colors = untonemap(torch.as_tensor(
                colors, dtype=torch.float32, device=dev) / 255.0).cpu().numpy()
        colors_all.append(colors.astype(np.float32))
        print(f"unprojected view {idx + 1}/{len(dataset)}")

    points = np.concatenate(points_all)
    colors = np.concatenate(colors_all)

    voxel_coords = np.round(points * cli.voxel_scale).astype(np.int64)
    unique_coords, inverse, counts = np.unique(
        voxel_coords, axis=0, return_inverse=True, return_counts=True
    )
    accum = np.zeros((unique_coords.shape[0], 3), np.float64)
    np.add.at(accum, inverse, colors)
    avg_colors = accum / counts[:, None]

    mask = counts >= 2
    pts = unique_coords[mask].astype(np.float32) / cli.voxel_scale
    cols = avg_colors[mask].astype(np.float32)
    print("Dense Point Cloud:", pts.shape)
    save_xyzrgb_ply(
        os.path.join(cli.source_path, cli.filename.format(mode="dense")),
        pts, cols,
    )


if __name__ == "__main__":
    main()
