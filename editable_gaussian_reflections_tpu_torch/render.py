"""Offline evaluation rendering CLI - twin of the root render.py (reference
render.py).

    python -m editable_gaussian_reflections_tpu_torch.render -m <model_path> \\
        [--iteration N] [--spp 128] [--spp_chunk 16] [--split test] \\
        [--modes regular env_rot_1 ...] [--no_denoise] [--skip_video] \\
        [--skip_save_frames] [--znear 1.0] [--device cpu] [Config options]

Each view of the split is rendered at `--spp` samples (at most
`--spp_chunk` a dispatch, render_accumulated_chunked) through the fused
path where fused_path_ok holds and the Config culls, else through the
non-fused render_frame, then denoised (on by default: the KPN or the
a-trous filter, renderer/denoise.py) on the scene's device.  Every pass is
written as model_path/{split}/ours_{iter}/{pass}[_gt]/{idx:05d}_{pass}.png
with utils/image.py, and the candidate lists' overflow share as
overflow.json.  The env_rot_*/env_move_* modes render the environment
from the reference's hardcoded poses.  The side-by-side MP4s need imageio;
without it they are skipped with a message, as in the JAX package.  The
scene sits on the card unless `--device cpu` (the kernels' plain
versions); without a card and without `--device cpu` the CLI exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from .config import load_model_config
from .device import resolve_device
from .ops.tonemap import tonemap
from .renderer.denoise import denoise_specular
from .renderer.raytracer import fused_path_ok, render_accumulated_chunked
from .renderer.render import (
    camera_params,
    default_backend_kwargs,
    nonfused_kwargs,
)
from .scene.scene import Scene, search_for_max_iteration
from .training import settings_from_config
from .utils.general import set_seeds
from .utils.image import save_image

# env-mode base rotation (render.py:128-145, the Blender convention pose the
# reference hardcodes for the environment fly-throughs)
_ENV_BASE_R = np.array([
    [-0.9882196187973022, 0.10767492651939392, -0.10875695198774338],
    [-0.10844696313142776, 0.008747747167944908, 0.9940638542175293],
    [0.10798710584640503, 0.994147777557373, 0.003032323671504855],
])

PASSES = ("render", "diffuse", "specular", "depth", "normal", "roughness", "f0")


def _np_tonemap(x):
    return tonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def env_mode_pose(mode: str, idx: int, num_views: int):
    """render.py:118-186: R_blender/T_blender for the env fly-through modes."""
    if "env_rot" in mode:
        theta = (2 * math.pi * idx) / num_views
    else:
        theta = 0.0
    rot = np.array([
        [math.cos(theta), -math.sin(theta), 0.0],
        [math.sin(theta), math.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ])
    R_blender = rot @ _ENV_BASE_R
    if mode == "env_rot_1":
        T_blender = np.array([0.0, -0.2, 0.2])
    elif mode == "env_rot_2":
        T_blender = np.array([1.3, -2.0, 0.0])
    elif mode == "env_move_1":
        t = idx / max(num_views - 1, 1)
        T_blender = (1 - t) * np.array([0.0, -0.2, 0.2]) + t * np.array([1.3, -2.0, 0.0])
    elif mode == "env_move_2":
        t = idx / max(num_views - 1, 1)
        T_blender = (1 - t) * np.array([0.0, -0.2, 0.2]) + t * np.array([1.3, -0.3, 0.0])
    else:
        raise ValueError(mode)
    R_colmap = -R_blender
    R_colmap[:, 0] = -R_colmap[:, 0]
    T_colmap = -R_colmap.T @ T_blender
    return R_colmap, T_colmap


def render_view(cfg, scene, cam, settings, seed: int, W: int, H: int,
                spp: int, spp_chunk: int):
    """One view at `spp` samples (render.py:118-148): the fused path when
    the Config culls and fused_path_ok holds (the k-buffer composite, as the
    JAX CLI renders), else render_frame.  Returns float32 CPU tensors
    (StepOutputs, final) from render_accumulated_chunked."""
    bk = default_backend_kwargs(cfg)
    if bk["use_culling"] and fused_path_ok(scene, W, H, cfg.cull_cluster):
        return render_accumulated_chunked(
            scene, cam, settings, seed, W, H, spp=spp, spp_chunk=spp_chunk,
            fused=True, num_bounces=2, max_hits=cfg.max_hits,
            cull_cluster=cfg.cull_cluster, max_clusters=cfg.max_clusters,
            max_clusters_secondary=cfg.max_clusters_secondary or None,
            cull_tile_secondary=cfg.cull_tile_secondary,
            split_far=cfg.split_far, mc_far=cfg.mc_far,
            max_hits_far=cfg.max_hits_far,
            split_radius_scale=cfg.split_radius_scale)
    return render_accumulated_chunked(
        scene, cam, settings, seed, W, H, spp=spp, spp_chunk=spp_chunk,
        fused=False, num_bounces=2, max_hits=cfg.max_hits,
        chunk=cfg.trace_chunk, tile=cfg.ray_tile, **nonfused_kwargs(cfg))


def render_set(cli, cfg, split, iteration, views, scene, settings):
    """Render `views` of `scene` (a GaussianScene, on its device) and write
    the passes, their targets and overflow.json (render.py:80-230)."""
    dev = scene.xyz.device
    base = os.path.join(cli.model_path, split, f"ours_{iteration}")
    dirs = {}
    for p in PASSES:
        dirs[p] = os.path.join(base, p)
        dirs[p + "_gt"] = os.path.join(base, p + "_gt")
        os.makedirs(dirs[p], exist_ok=True)
        os.makedirs(dirs[p + "_gt"], exist_ok=True)

    videos = {p: [] for p in PASSES}
    overflow_fracs = []

    for mode in cli.modes:
        view0 = None
        for idx, view in enumerate(views):
            if "env" in mode:
                if idx == 0:
                    view0 = view
                    view0.FoVx = 2.0944 * 2
                    view0.FoVy = -2.0944 * 2
                    continue
                view = view0
                R, T = env_mode_pose(mode, idx, len(views))
                view.R = R
                view.T = T
                view.update()

            cam = camera_params(view, znear=cli.znear, zfar=view.zfar,
                                device=dev)
            H, W = view.image_height, view.image_width
            steps, final = render_view(cfg, scene, cam, settings, idx, W, H,
                                       cli.spp, cli.spp_chunk)
            rgb = steps.rgb.reshape(-1, H, W, 3).numpy()
            depth = steps.depth[0].reshape(H, W).numpy()
            normal = steps.normal[0].reshape(H, W, 3).numpy()
            rough = steps.roughness[0].reshape(H, W).numpy()
            f0 = steps.f0[0].reshape(H, W, 3).numpy()
            final_img = final.reshape(H, W, 3).numpy()
            if cli.denoise:
                final_img = denoise_specular(
                    final.reshape(H, W, 3).to(dev),
                    rgb[0], normal, depth, rough, spp=cli.spp).cpu().numpy()

            diffuse = np.clip(_np_tonemap(rgb[0]), 0, 1)
            specular = np.clip(_np_tonemap(rgb[1:].sum(0)), 0, 1)
            pred = np.clip(_np_tonemap(final_img), 0, 1)

            gt = {
                "render": None if view.original_image is None else np.clip(_np_tonemap(view.original_image), 0, 1),
                "diffuse": None if view.diffuse_image is None else np.clip(_np_tonemap(view.diffuse_image), 0, 1),
                "specular": None if view.specular_image is None else np.clip(_np_tonemap(view.specular_image), 0, 1),
                "depth": view.depth_image,
                "normal": view.normal_image,
                "roughness": view.roughness_image,
                "f0": view.f0_image,
            }
            depth_max = (
                float(np.max(gt["depth"])) if gt["depth"] is not None
                else max(float(depth.max()), 1e-6)
            )
            pred_imgs = {
                "render": pred,
                "diffuse": diffuse,
                "specular": specular,
                "depth": np.clip(depth / depth_max, 0, 1),
                "normal": np.clip(normal / 2 + 0.5, 0, 1),
                "roughness": np.clip(rough, 0, 1),
                "f0": np.clip(f0, 0, 1),
            }
            gt_imgs = {
                "render": gt["render"],
                "diffuse": gt["diffuse"],
                "specular": gt["specular"],
                "depth": None if gt["depth"] is None else np.clip(np.asarray(gt["depth"])[..., 0] / depth_max, 0, 1),
                "normal": None if gt["normal"] is None else np.clip(np.asarray(gt["normal"]) / 2 + 0.5, 0, 1),
                "roughness": None if gt["roughness"] is None else np.clip(np.asarray(gt["roughness"])[..., 0], 0, 1),
                "f0": None if gt["f0"] is None else np.clip(np.asarray(gt["f0"]), 0, 1),
            }

            if not cli.skip_save_frames and mode == "regular":
                for p in PASSES:
                    save_image(pred_imgs[p], os.path.join(dirs[p], f"{idx:05d}_{p}.png"))
                    if gt_imgs[p] is not None:
                        save_image(gt_imgs[p], os.path.join(dirs[p + "_gt"], f"{idx:05d}_{p}.png"))
            if not cli.skip_video:
                for p in PASSES:
                    if gt_imgs[p] is not None:
                        a = pred_imgs[p]
                        b = gt_imgs[p]
                        if a.ndim == 2:
                            a = a[..., None].repeat(3, -1)
                        if b.ndim == 2:
                            b = b[..., None].repeat(3, -1)
                        videos[p].append(np.concatenate([a, b], axis=1))
            ovf = float(steps.overflow.mean())
            overflow_fracs.append(ovf)
            print(f"[{mode}] rendered {split} view {idx + 1}/{len(views)}"
                  f" (cull_overflow {ovf:.4f})")

    if overflow_fracs:
        # candidate-list overflow drops hits WITHOUT tail correction
        # (culling.py select_candidates) - record it next to the renders so
        # silent hit loss is auditable
        with open(os.path.join(base, "overflow.json"), "w") as f:
            json.dump({"mean": float(np.mean(overflow_fracs)),
                       "max": float(np.max(overflow_fracs))}, f)
    if not cli.skip_video:
        _write_videos(base, videos)


def _write_videos(base, videos):
    try:
        import imageio.v3 as iio
        for p, frames in videos.items():
            if not frames:
                continue
            arr = (np.stack(frames) * 255).astype(np.uint8)
            iio.imwrite(os.path.join(base, f"{p}_video.mp4"), arr, fps=10)
    except Exception as e:
        print(f"[render] video writing unavailable ({e}); skipping MP4s")


def parse_cli(argv=None):
    p = argparse.ArgumentParser(prog="render", allow_abbrev=False)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--spp", type=int, default=128)
    p.add_argument("--spp_chunk", type=int, default=16,
                   help="max samples per dispatch")
    p.add_argument("--split", choices=["train", "test"], default="test")
    p.add_argument("--denoise", dest="denoise", action="store_true",
                   default=None)
    p.add_argument("--no_denoise", dest="denoise", action="store_false")
    p.add_argument("--modes", nargs="*", default=["regular"])
    p.add_argument("--skip_video", action="store_true")
    p.add_argument("--skip_save_frames", action="store_true")
    p.add_argument("--znear", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_known_args(argv)


def main(argv=None):
    cli, unknown = parse_cli(argv)
    dev = resolve_device(cli.device)
    cfg = load_model_config(cli.model_path, unknown, prog="render")
    set_seeds()

    if cli.denoise is None:
        # reference protocol: denoise always on (render.py:31-36); the
        # SPP-aware blend backs the filter off at high spp
        cli.denoise = True
    if cli.iteration is None:
        cli.iteration = search_for_max_iteration(
            os.path.join(cli.model_path, "point_cloud")
        )
    scene = Scene(cfg, load_iteration=cli.iteration, shuffle=False,
                  model_path=cli.model_path, device=dev)
    settings = settings_from_config(cfg)
    views = (scene.getTestCameras() if cli.split == "test"
             else scene.getTrainCameras())
    render_set(cli, cfg, cli.split, cli.iteration, views, scene.gaussians,
               settings)


if __name__ == "__main__":
    main()
