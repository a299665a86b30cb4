"""Spiral-path novel-view rendering - twin of the root
tools/render_novel_views.py (reference tools/render_novel_views.py).

    python -m editable_gaussian_reflections_tpu_torch.tools.render_novel_views \\
        -m <model_path> [--iteration N] [--spp 128] [--n_views 300] \\
        [--no_denoise] [--znear 1.0] [--device cpu] [Config options]

An EnvGS-style spiral around the train cameras (utils/cam_paths.py), each
view rendered by render_accumulated (the non-fused path, with
default_backend_kwargs' culling) at `--spp`, denoised on the scene's
device, with the EnvGS normal visualisation (camera space, flipped axes);
the passes go to model_path/novel_views/ours_{iter}/{pass}/
{idx:05d}_{pass}.png.  On the card unless `--device cpu`; without a card
and without it the CLI exits non-zero.
"""

from __future__ import annotations

import argparse
import os
from copy import deepcopy

import numpy as np
import torch

from ..config import load_model_config
from ..device import resolve_device
from ..ops.tonemap import tonemap
from ..renderer.denoise import denoise_specular
from ..renderer.raytracer import render_accumulated
from ..renderer.render import camera_params, nonfused_kwargs
from ..scene.scene import Scene, search_for_max_iteration
from ..training import settings_from_config
from ..utils.cam_paths import generate_spiral_path
from ..utils.general import set_seeds
from ..utils.image import save_image


def _np_tonemap(x):
    return tonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def render_set(cli, cfg, cameras, scene, settings, save_dir):
    """tools/render_novel_views.py:39-92 of the root file."""
    dev = scene.xyz.device
    for idx, camera in enumerate(cameras):
        H, W = camera.image_height, camera.image_width
        cam = camera_params(camera, znear=cli.znear, zfar=camera.zfar,
                            device=dev)
        steps, final = render_accumulated(
            scene, cam, settings, idx, W, H, spp=cli.spp, num_bounces=2,
            max_hits=cfg.max_hits, chunk=cfg.trace_chunk, tile=cfg.ray_tile,
            **nonfused_kwargs(cfg))
        final_img = final.reshape(H, W, 3)
        if cli.denoise:
            final_img = denoise_specular(
                final_img, steps.rgb[0].reshape(H, W, 3),
                steps.normal[0].reshape(H, W, 3),
                steps.depth[0].reshape(H, W),
                steps.roughness[0].reshape(H, W), spp=cli.spp)
        final_img = final_img.cpu().numpy()

        rgb = steps.rgb.reshape(-1, H, W, 3).cpu().numpy()
        depth = steps.depth[0].reshape(H, W).cpu().numpy()

        # EnvGS-matched normal viz (tools/render_novel_views.py:86-96)
        normal = steps.normal[0].reshape(H, W, 3).cpu().numpy()
        normal = normal / np.maximum(
            np.linalg.norm(normal, axis=-1, keepdims=True), 1e-8)
        normal = np.einsum("ij,...j->...i", camera.R.T.astype(np.float32), normal)
        normal *= -1
        normal[..., 0] *= -1

        result = {
            "render": np.clip(_np_tonemap(final_img), 0, 1),
            "specular": np.clip(_np_tonemap(rgb[1:].sum(0)), 0, 1),
            "diffuse": np.clip(_np_tonemap(rgb[0]), 0, 1),
            "depth": depth / max(float(depth.max()), 1e-8),
            "normal": np.clip(normal * 0.5 + 0.5, 0, 1),
            "roughness": np.clip(steps.roughness[0].reshape(H, W).cpu().numpy(), 0, 1),
            "f0": np.clip(steps.f0[0].reshape(H, W, 3).cpu().numpy(), 0, 1),
        }
        for k, v in result.items():
            save_image(v, os.path.join(save_dir, k, f"{idx:05d}_{k}.png"))
        print(f"novel view {idx + 1}/{len(cameras)}")


def spiral_cameras(views, n_views: int, max_images=None):
    """The spiral path's cameras (copies of views[0] posed on it)."""
    c2ws = []
    for view in views:
        w2c = np.eye(4)
        w2c[:3, :3] = view.R.T
        w2c[:3, 3] = view.T
        c2ws.append(np.linalg.inv(w2c))
    spiral = generate_spiral_path(np.array(c2ws), n_render_views=n_views)
    spiral = np.concatenate(
        [spiral, np.repeat(np.array([[[0.0, 0.0, 0.0, 1.0]]]),
                           len(spiral), axis=0)], axis=1)

    cameras = []
    for c2w in spiral:
        camera = deepcopy(views[0])
        w2c = np.linalg.inv(c2w)
        camera.R = np.transpose(w2c[:3, :3])
        camera.T = w2c[:3, 3]
        camera.update()
        cameras.append(camera)
    if max_images is not None:
        cameras = cameras[:max_images]
    return cameras


def main(argv=None):
    p = argparse.ArgumentParser(prog="render_novel_views", allow_abbrev=False)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--spp", type=int, default=128)
    p.add_argument("--denoise", dest="denoise", action="store_true", default=True)
    p.add_argument("--no_denoise", dest="denoise", action="store_false")
    p.add_argument("--znear", type=float, default=1.0)
    p.add_argument("--n_views", type=int, default=300)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    cli, unknown = p.parse_known_args(argv)
    dev = resolve_device(cli.device)

    cfg = load_model_config(cli.model_path, unknown, prog="render_novel_views")
    iteration = cli.iteration or search_for_max_iteration(
        os.path.join(cli.model_path, "point_cloud"))
    print(f"Loading trained model at iteration {iteration}")
    set_seeds()

    scene = Scene(cfg, load_iteration=iteration, shuffle=False,
                  model_path=cli.model_path, device=dev)
    cameras = spiral_cameras(scene.getTrainCameras(), cli.n_views,
                             cfg.max_images)
    save_dir = os.path.join(cfg.model_path, "novel_views", f"ours_{iteration}")
    render_set(cli, cfg, cameras, scene.gaussians,
               settings_from_config(cfg), save_dir)


if __name__ == "__main__":
    main()
