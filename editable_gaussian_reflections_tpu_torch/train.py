"""Training CLI (twin of the JAX package's root train.py, itself the twin of
reference train.py:172-274).

    python -m editable_gaussian_reflections_tpu_torch.train -s <dataset> \\
        -m <model_path> [Config options] [--resume] [--device cpu]

Writes the reference's model directory: cfg.json, the copied
transforms_*.json and bounding_boxes.json, point_cloud/iteration_N/
point_cloud.ply, checkpoints/step_N (the full TrainState), time.txt,
num_gaussians.txt, {train,test}_validation_scores.csv, the preview PNG
grids and tensorboard scalars (with tensorboardX, where installed).

`main` reads the dataset into a Scene on the device (the card unless
`--device cpu`: the kernels' plain versions) and hands it to `train_scene`,
the loop: the viewpoint stack drawn by Python's `random`, each camera's
targets staged once on the device, the bounce warm-up, the far-field shell
injected when it ends (the candidate budget grown with the capacity),
pruning by accumulated weight and by the cameras' znear spheres, the
reports and the saves.  The steps draw their samples from one
torch.Generator on the device seeded with set_seeds()'s seed (the JAX
package splits a key per step); the reports render with a generator seeded
0 (JAX: PRNGKey(0)).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from dataclasses import asdict
from datetime import datetime
from random import randint

import numpy as np
import torch

from .checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_train_state,
    save_train_state,
)
from .config import Config, parse_config
from .device import resolve_device
from .ops.gaussian_kernel import MAX_BOUNCES
from .ops.precision import div
from .ops.tonemap import tonemap
from .renderer.render import camera_params, default_backend_kwargs, render
from .scene.gaussian_scene import num_live
from .scene.init import farfield_arrays, znear_prune_mask
from .scene.scene import Scene
from .training import (
    append_with_opt_state,
    init_train_state,
    lr_tree,
    pick_tile_size,
    prune_step,
    settings_from_config,
    step_culls,
    targets_from_camera,
    train_step,
    use_pallas_backend,
)
from .utils.general import set_seeds
from .utils.image import psnr, save_image_grid


def prepare_output_and_logger(cfg: Config):
    """train.py:34-71: the model directory, cfg.json and the copied dataset
    files; a tensorboardX writer when the package is there, else None."""
    if not cfg.model_path:
        cfg.model_path = os.path.join(
            "output", datetime.now().isoformat(timespec="seconds")
        )
    os.makedirs(cfg.model_path, exist_ok=True)
    for name in ("transforms_train.json", "transforms_test.json",
                 "bounding_boxes.json"):
        src = os.path.join(cfg.source_path, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(cfg.model_path, name))
    with open(os.path.join(cfg.model_path, "cfg.json"), "w") as f:
        json.dump(asdict(cfg), f, indent=2)
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(cfg.model_path)
    except Exception:
        return None


def _np_tonemap(x):
    return tonemap(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def training_report(cfg, scene, state, tb_writer, iteration, start_time,
                    settings, num_bounces, max_clusters=None):
    """train.py:75-169: time.txt, num_gaussians.txt, and per split the
    PSNRs of a denoised render (diffuse, specular, final), the validation
    CSV and a preview grid."""
    delta = time.time() - start_time
    with open(os.path.join(cfg.model_path, "time.txt"), "a") as f:
        f.write("\n[ITER {}] elapsed {}".format(
            iteration, time.strftime("%H:%M:%S", time.gmtime(delta))))
    n_live = num_live(state.scene)
    with open(os.path.join(cfg.model_path, "num_gaussians.txt"), "a") as f:
        f.write(f"\n[ITER {iteration}] # {n_live}")

    configs = [{
        "name": "train",
        "cameras": [sorted(scene.getTrainCameras(), key=lambda x: x.image_name)[
            min(cfg.val_view, (cfg.max_images or len(scene.getTrainCameras())) - 1)
        ]],
    }]
    if len(scene.getTestCameras()) > 0:
        configs.append({"name": "test", "cameras": scene.getTestCameras()})

    for vc in configs:
        scores = np.zeros(3)
        overflow_frac = 0.0
        for idx, viewpoint in enumerate(vc["cameras"]):
            bk = default_backend_kwargs(cfg)
            if max_clusters and bk.get("use_culling"):
                # the step's budget grows at the far-field injection; the
                # eval render takes it too, or its PSNR and cull_overflow
                # measure a starved render
                bk["max_clusters"] = max(bk["max_clusters"], max_clusters)
            pkg = render(
                viewpoint, state.scene, settings,
                num_bounces=num_bounces, max_hits=cfg.max_hits,
                chunk=cfg.trace_chunk, tile=cfg.ray_tile, denoise=True,
                **bk,
            )
            diffuse = np.clip(_np_tonemap(pkg.rgb[0]), 0, 1)
            specular = np.clip(_np_tonemap(pkg.rgb[1:].sum(0)), 0, 1)
            pred = np.clip(_np_tonemap(pkg.final), 0, 1)
            d_gt = np.clip(_np_tonemap(pkg.target_diffuse), 0, 1)
            s_gt = np.clip(_np_tonemap(pkg.target_specular), 0, 1)
            gt = np.clip(_np_tonemap(pkg.target), 0, 1)
            scores += [psnr(diffuse, d_gt), psnr(specular, s_gt), psnr(pred, gt)]
            overflow_frac += pkg.overflow_frac
            if idx == 0:
                def hwc(a):
                    return a.transpose(1, 2, 0)
                save_image_grid(
                    [hwc(diffuse), hwc(d_gt), hwc(specular), hwc(s_gt),
                     hwc(pred), hwc(gt)],
                    os.path.join(cfg.model_path,
                                 f"{vc['name']}_preview_iteration_{iteration}.png"),
                    nrow=2,
                )
        scores /= len(vc["cameras"])
        overflow_frac /= len(vc["cameras"])
        print(f"\n[ITER {iteration}] Evaluating {vc['name']}: "
              f"PSNR {scores[2]:.2f} (diffuse {scores[0]:.2f} / specular {scores[1]:.2f})"
              f" cull_overflow {overflow_frac:.4f}")
        if tb_writer:
            tb_writer.add_scalar(vc["name"] + "/loss_viewpoint - psnr", scores[2], iteration)
            tb_writer.add_scalar(vc["name"] + "/loss_viewpoint - specular_psnr", scores[1], iteration)
            tb_writer.add_scalar(vc["name"] + "/loss_viewpoint - diffuse_psnr", scores[0], iteration)
        with open(os.path.join(cfg.model_path,
                               f"{vc['name']}_validation_scores.csv"), "a") as f:
            f.write(f"{iteration}, {scores[0]:02.2f}, {scores[1]:02.2f}, {scores[2]:02.2f}\n")


def start_viewer(state, cfg: Config, width: int, height: int, fovy: float,
                 settings):
    """The live training viewer (train.py:221-240): a ViewerState over the
    training scene and the websocket RenderService in a daemon thread.  A
    missing `websockets` raises here, in the caller's thread, before the
    first step."""
    from threading import Thread

    from .scene.editable import EditableGaussianScene
    from .viewer.service import RenderService, require_websockets
    from .viewer.state import ViewerState

    require_websockets()
    viewer_state = ViewerState(
        EditableGaussianScene(state.scene), cfg,
        width=min(width, 512), height=min(height, 512), fovy=fovy,
        settings=settings)
    Thread(target=RenderService(viewer_state).serve, daemon=True).start()
    return viewer_state


def grown_budget(max_clusters: int, capacity: int, before: int) -> int:
    """The candidate budget grown with the cluster count, to a multiple of
    64 (train.py:345-352)."""
    grow = capacity / max(before, 1)
    return -(-int(max_clusters * grow) // 64) * 64


def train_scene(cfg: Config, scene: Scene, tb_writer=None,
                resume: bool = False, seed: int = 0):
    """The training loop (train.py:172-365) on `scene`, on its Gaussians'
    device; writes into cfg.model_path (prepare_output_and_logger's).  With
    `resume`, continues from the latest checkpoints/step_N.  Returns the
    final TrainState.  With cfg.viewer the websocket viewer shows the
    state after each iteration (start_viewer)."""
    dev = scene.gaussians.xyz.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    first_iter = 1
    ckpt = latest_checkpoint(cfg.model_path) if resume else None
    if ckpt:
        state = load_train_state(ckpt, device=dev)
        first_iter = int(ckpt.split("_")[-1]) + 1
        print(f"resumed from {ckpt} at iteration {first_iter}")
    else:
        state = init_train_state(scene.gaussians)
    settings = settings_from_config(cfg)

    cameras = scene.getTrainCameras()
    W, H = cameras[0].image_width, cameras[0].image_height
    tile = pick_tile_size(W * H, cfg.ray_tile)
    # each camera's targets are staged on the device once
    targets_cache = {}

    viewpoint_stack = list(range(len(cameras)))
    use_pallas = use_pallas_backend(cfg)
    exp_power_static = float(cfg.exp_power)
    # culling needs tiles that divide the frame and cluster-aligned slots
    use_culling = (
        use_pallas and step_culls(cfg)
        and (W * H) % cfg.cull_tile == 0
        and tile % cfg.cull_tile == 0
        and state.scene.capacity % cfg.cull_cluster == 0
    )
    cull_kw = dict(use_culling=use_culling, cull_tile=cfg.cull_tile,
                   cull_cluster=cfg.cull_cluster,
                   max_clusters=cfg.max_clusters, split_far=cfg.split_far,
                   mc_far=cfg.mc_far, max_hits_far=cfg.max_hits_far,
                   split_radius_scale=cfg.split_radius_scale)
    start_time = time.time()
    if first_iter > 1:
        # resume: time.txt stays cumulative across restarts, the timer
        # offset by the last recorded elapsed time
        try:
            with open(os.path.join(cfg.model_path, "time.txt")) as f:
                last = f.read().strip().splitlines()[-1]
            h, m, s = last.split("elapsed")[-1].strip().split(":")
            start_time -= int(h) * 3600 + int(m) * 60 + int(s)
        except (OSError, ValueError, IndexError):
            pass
    num_bounces = 0 if cfg.no_bounces_until_iter > 0 else min(MAX_BOUNCES, 2)
    if first_iter > max(cfg.no_bounces_until_iter, 0):
        # resuming past the warm-up: bounces are on and the far-field shell
        # is in the checkpointed state
        num_bounces = min(MAX_BOUNCES, 2)
        if use_culling and cfg.no_bounces_until_iter > 0:
            # the injection's budget growth again, the shell's share of the
            # capacity estimated from the config
            cap = state.scene.capacity
            mc = grown_budget(cfg.max_clusters, cap,
                               cap - cfg.init_num_pts_farfield)
            cull_kw["max_clusters"] = max(cull_kw["max_clusters"], mc)

    rng = np.random.default_rng(seed)
    hyper = dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0)
    viewer_state = (start_viewer(state, cfg, W, H, cameras[0].FoVy, settings)
                    if cfg.viewer else None)

    for iteration in range(first_iter, cfg.iterations + 1):
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cameras)))
        cam_idx = viewpoint_stack.pop(randint(0, len(viewpoint_stack) - 1))
        cam = cameras[cam_idx]
        if cam_idx not in targets_cache:
            targets_cache[cam_idx] = targets_from_camera(cam, device=dev)
        targets = targets_cache[cam_idx]
        cp = camera_params(cam, znear=cam.znear, zfar=cam.zfar, device=dev)

        lrs = lr_tree(cfg, iteration, scene.cameras_extent)
        prune_now = (
            iteration % cfg.pruning_interval == 0
            and iteration > cfg.pruning_start_iter
            and cfg.min_weight > 0
        )
        znear_prune_now = (
            iteration % cfg.pruning_interval == 0
            and not cfg.disable_znear_densif_pruning
        )

        step_args = (cp, targets, settings, lrs)
        step_kw = dict(generator=generator, width=W, height=H,
                       num_bounces=num_bounces, max_hits=cfg.max_hits,
                       chunk=cfg.trace_chunk, tile=tile,
                       use_pallas=use_pallas,
                       exp_power_static=exp_power_static, **cull_kw)
        if prune_now or znear_prune_now:
            # the reference renders first (train.py:221), then prunes
            # (238-245), which kills slots and zeroes this step's gradients,
            # then the optimizer steps
            state2, metrics = train_step(
                state, *step_args, {**hyper, "apply_grads": 0.0}, **step_kw)
            kill = torch.zeros(state.scene.capacity, dtype=torch.bool,
                               device=dev)
            if prune_now:
                kill = kill | (div(state2.total_weight, cfg.pruning_interval)
                               < cfg.min_weight)
            if znear_prune_now:
                centers, znears = scene.camera_centers_znears()
                kill = kill | znear_prune_mask(state2.scene, centers, znears)
            kill = kill & state2.scene.live_mask
            state = prune_step(state2, kill)
        else:
            state, metrics = train_step(state, *step_args, hyper, **step_kw)

        if iteration % 100 == 0:
            # drain the queue, so that elapsed times are honest and the host
            # does not run unboundedly ahead of the device
            float(metrics["l1_diffuse"])

        if iteration in cfg.test_iterations:
            training_report(cfg, scene, state, tb_writer, iteration,
                            start_time, settings, num_bounces,
                            max_clusters=cull_kw.get("max_clusters"))
        if iteration in cfg.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, state.scene)
            # the full state (params + Adam moments) for a mid-training
            # resume, beyond the reference's PLY-only checkpoints
            try:
                save_train_state(checkpoint_path(cfg.model_path, iteration),
                                 state)
            except Exception as e:  # noqa: BLE001 - best-effort, as in JAX
                print(f"[checkpoint] skipped: {e}")

        # the bounce warm-up ends: bounces on, far-field shell injected
        if iteration == cfg.no_bounces_until_iter or (
            iteration == 1 and cfg.no_bounces_until_iter in (-1, 0)
        ):
            num_bounces = min(MAX_BOUNCES, 2)
            centers, znears = scene.camera_centers_znears()
            new = farfield_arrays(cfg, scene.cameras_extent, centers, znears,
                                  rng, device=dev)
            prev_capacity = state.scene.capacity
            # a culled loop keeps its capacity a multiple of the cluster
            # (the JAX loop pads to trace_chunk alone, and its culled steps
            # raise where that is not a multiple of cull_cluster)
            pad = (math.lcm(cfg.trace_chunk, cfg.cull_cluster) if use_culling
                   else cfg.trace_chunk)
            state = append_with_opt_state(state, new, pad_multiple=pad)
            print(f"[ITER {iteration}] far-field injection -> capacity "
                  f"{state.scene.capacity}")
            if use_culling:
                # the shell surrounds every camera, so each tile's cone sees
                # its share of the new clusters: the candidate budget grows
                # with the cluster count (without it the starved share
                # spiked until pruning thinned the shell)
                mc = grown_budget(cfg.max_clusters, state.scene.capacity,
                                   prev_capacity)
                if mc > cull_kw["max_clusters"]:
                    cull_kw["max_clusters"] = mc
                    print(f"[ITER {iteration}] candidate budget "
                          f"max_clusters {cfg.max_clusters} -> {mc}")

        if viewer_state is not None:
            # the viewer renders this iteration's Gaussians from here on
            # (train_step writes no tensor in place, so the swap is safe)
            viewer_state.gaussians.base = state.scene
            viewer_state.gaussians.is_dirty = True
            viewer_state.gaussians._cached = None

    print("\nTraining complete.")
    return state


def main(cfg: Config, resume: bool = False, device: str = "cuda"):
    """Train cfg.source_path's scene into cfg.model_path on `device` (the
    card unless "cpu"; without a card "cuda" raises)."""
    dev = resolve_device(device)
    seed = set_seeds()
    tb_writer = prepare_output_and_logger(cfg)
    scene = Scene(cfg, device=dev)
    return train_scene(cfg, scene, tb_writer, resume=resume, seed=seed)


def cli(argv=None):
    p = argparse.ArgumentParser(prog="train", add_help=False,
                                allow_abbrev=False)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    extra, rest = p.parse_known_args(argv)
    cfg = parse_config(rest, prog="train")
    if cfg.viewer:
        cfg.test_iterations = []
    return main(cfg, resume=extra.resume, device=extra.device)


if __name__ == "__main__":
    cli()
