"""Protocol sweep: one checkpoint over all test views at a grid of (spp,
denoise) - twin of the root tools/eval_sweep.py.

    python -m editable_gaussian_reflections_tpu_torch.tools.eval_sweep \\
        -m <model_dir> [--iteration N] [--spp 1 16 128] [--znear 1.0] \\
        [--device cpu] [Config options]

For each spp and denoise in (0, 1), every test view is rendered at that
spp (at most 16 samples a dispatch, seed = the view's index) and scored in
tonemapped clamped PSNR against the view's G-buffers: diffuse (bounce 0),
specular (bounces 1-2) and render (denoised with the default denoiser on
the scene's device where denoise is 1); the means over the views go to
model_dir/eval_sweep.json.  A view renders on the fused k-buffer path
where the Config culls and fused_path_ok holds (cluster, candidates and the
secondary budget from the Config; no split-far, as in the JAX tool), else
on the non-fused render_frame with the Config's trace chunk, ray tile and
culling.  On the card the k-buffer kernels take K 8, 16, 32 or 64: a
model trained at another --max_hits raises there (it renders with
--device cpu).  On the card unless `--device cpu`; without a card and without it
the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import load_model_config
from ..device import resolve_device
from ..ops.tonemap import tonemap
from ..renderer.denoise import denoise_specular
from ..renderer.raytracer import fused_path_ok, render_accumulated_chunked
from ..renderer.render import (
    camera_params,
    default_backend_kwargs,
    nonfused_kwargs,
)
from ..scene.scene import Scene, search_for_max_iteration
from ..training import settings_from_config

SPP_CHUNK = 16


def psnr(a, b):
    m = float(np.mean((np.asarray(a, np.float64)
                       - np.asarray(b, np.float64)) ** 2))
    return float(20.0 * np.log10(1.0 / np.sqrt(max(m, 1e-12))))


def tm(x) -> np.ndarray:
    return np.clip(tonemap(torch.as_tensor(np.asarray(x, np.float32))
                           ).numpy(), 0, 1)


def render_sweep_view(cfg, scene, cam, settings, seed: int, W: int, H: int,
                      spp: int):
    """One view at `spp` samples through the JAX tool's gate (module
    docstring); float32 CPU tensors (StepOutputs, final)."""
    bk = default_backend_kwargs(cfg)
    if bk["use_culling"] and fused_path_ok(scene, W, H, cfg.cull_cluster):
        return render_accumulated_chunked(
            scene, cam, settings, seed, W, H, spp=spp, spp_chunk=SPP_CHUNK,
            fused=True, num_bounces=2, max_hits=cfg.max_hits,
            cull_cluster=cfg.cull_cluster, max_clusters=cfg.max_clusters,
            max_clusters_secondary=cfg.max_clusters_secondary or None,
            cull_tile_secondary=cfg.cull_tile_secondary)
    return render_accumulated_chunked(
        scene, cam, settings, seed, W, H, spp=spp, spp_chunk=SPP_CHUNK,
        fused=False, num_bounces=2, max_hits=cfg.max_hits,
        chunk=cfg.trace_chunk, tile=cfg.ray_tile, **nonfused_kwargs(cfg))


def parse_args(argv=None):
    """(the tool's arguments, the Config options left over)."""
    p = argparse.ArgumentParser(
        prog="eval_sweep", allow_abbrev=False,
        description="On the card the k-buffer kernels take K 8, 16, 32 or "
        "64: a model trained at another --max_hits raises there.")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--spp", type=int, nargs="*", default=[1, 16, 128])
    p.add_argument("--znear", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_known_args(argv)


def main(argv=None):
    args, unknown = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_model_config(args.model_path, unknown, prog="eval_sweep")

    iteration = args.iteration or search_for_max_iteration(
        os.path.join(args.model_path, "point_cloud"))
    scene = Scene(cfg, load_iteration=iteration, shuffle=False,
                  model_path=args.model_path, device=dev)
    settings = settings_from_config(cfg)
    views = scene.getTestCameras()

    results = {}
    for spp in args.spp:
        for denoise in (False, True):
            key = f"spp{spp}_denoise{int(denoise)}"
            scores = dict(diffuse=0.0, specular=0.0, render=0.0)
            for idx, view in enumerate(views):
                cam = camera_params(view, znear=args.znear, zfar=view.zfar,
                                    device=dev)
                H, W = view.image_height, view.image_width
                steps, final = render_sweep_view(
                    cfg, scene.gaussians, cam, settings, idx, W, H, spp)
                rgb = steps.rgb.reshape(-1, H, W, 3)
                final_img = final.reshape(H, W, 3)
                if denoise:
                    final_img = denoise_specular(
                        final_img.to(dev), rgb[0],
                        steps.normal[0].reshape(H, W, 3),
                        steps.depth[0].reshape(H, W),
                        steps.roughness[0].reshape(H, W), spp=spp).cpu()
                scores["diffuse"] += psnr(tm(rgb[0]),
                                          tm(view.diffuse_image))
                scores["specular"] += psnr(tm(rgb[1:].sum(0)),
                                           tm(view.specular_image))
                scores["render"] += psnr(tm(final_img),
                                         tm(view.original_image))
            results[key] = {k: round(v / len(views), 2)
                            for k, v in scores.items()}
            print(f"{key}: {results[key]}", flush=True)

    out = os.path.join(args.model_path, "eval_sweep.json")
    with open(out, "w") as f:
        json.dump(dict(iteration=iteration, n_views=len(views),
                       znear=args.znear, results=results), f, indent=2)
    print(f"-> {out}")
    return results


if __name__ == "__main__":
    main()
