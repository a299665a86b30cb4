"""FPS measurement CLI - twin of the JAX package's measure_fps.py (reference
measure_fps.py:27-52).

A warm-up pass over all views, then a timed loop at 1 spp, no denoise, no
targets; prints FPS and writes fps.json into the model directory.  The
renders are queued asynchronously on the card, so the timed loop is closed
by torch.cuda.synchronize() (the JAX package closes it with a transfer).

    python -m editable_gaussian_reflections_tpu_torch.measure_fps -m <model_path>
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .config import load_model_config
from .renderer.render import (
    camera_params,
    default_backend_kwargs,
    dispatch_render_frame,
)
from .renderer.raytracer import SCAN_MODES
from .scene.scene import Scene, search_for_max_iteration
from .training import settings_from_config
from .utils.general import set_seeds


def _render_all(cfg, views, scene, settings, kwargs, seed_of):
    H, W = views[0].image_height, views[0].image_width
    dev = scene.xyz.device
    final = None
    for i, view in enumerate(views):
        cam = camera_params(view, znear=view.znear, zfar=view.zfar,
                            device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed_of(i))
        _, final = dispatch_render_frame(scene, cam, settings, gen, W, H,
                                         **kwargs)
    return final


def measure_fps(cfg, views, scene, settings) -> float:
    """Frames per second over `views` of `scene` (a GaussianScene) with the
    Config's render options: 2 bounces, 1 spp, jittered.  The scan modes run
    with kernel_stats=False (the counters compiled out; every other output
    is unchanged), the FPS protocol of the JAX package.  Renders on the
    scene's device; the timed loop ends once the card has finished."""
    kwargs = dict(num_bounces=2, max_hits=cfg.max_hits, jitter=True,
                  **default_backend_kwargs(cfg))
    if kwargs["composite_mode"] in SCAN_MODES:
        kwargs["kernel_stats"] = False

    def synchronize():
        if scene.xyz.device.type == "cuda":
            torch.cuda.synchronize(scene.xyz.device)

    # warm-up: builds the kernels, fills the caching allocator
    _render_all(cfg, views, scene, settings, kwargs, lambda i: 0)
    synchronize()

    t0 = time.perf_counter()
    _render_all(cfg, views, scene, settings, kwargs, lambda i: i)
    synchronize()
    elapsed = time.perf_counter() - t0

    fps = len(views) / elapsed
    print(f"{fps:.2f} FPS")
    with open(os.path.join(cfg.model_path, "fps.json"), "w") as f:
        f.write(f"{fps:.2f}\n")
    return fps


def main(argv=None):
    p = argparse.ArgumentParser(prog="measure_fps", allow_abbrev=False)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--split", choices=["train", "test"], default="test")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    cli, unknown = p.parse_known_args(argv)

    cfg = load_model_config(cli.model_path, unknown, prog="measure_fps")
    if not any(a.startswith("--composite_mode") for a in unknown):
        # the inference protocol's default: the streaming scan composite
        # with the quadric pair math, as in the JAX package; pass
        # --composite_mode kbuffer to time the exact k-buffer path
        cfg.composite_mode = "scanq"
    print(f"composite_mode: {cfg.composite_mode}")
    set_seeds()
    iteration = cli.iteration or search_for_max_iteration(
        os.path.join(cli.model_path, "point_cloud"))
    scene = Scene(cfg, load_iteration=iteration, shuffle=False,
                  model_path=cli.model_path, device=cli.device)
    views = (scene.getTestCameras() if cli.split == "test"
             else scene.getTrainCameras())
    return measure_fps(cfg, views, scene.gaussians,
                       settings_from_config(cfg))


if __name__ == "__main__":
    main()
