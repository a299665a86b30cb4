"""The non-fused path at full width, as `chip_smoke.py` drives it (phases 11
and 12) and `tools/walk_ab.py` times its trace launches, in one place:

  eval render    a 16:9 frame at the default -r 768 (1365x768, as
                 dataset/blender.py loads it) of bench.py's
                 room_scene(100_000), 2 bounces, the Config defaults' k-buffer
                 (K 32, cluster 256, 192 candidates), 8192-ray tiles: the
                 dispatch's fallback, traced culled;
  training step  the same frame of room_scene(175_000) at the Config
                 defaults: ray tile 8190, which does not divide into 256-ray
                 cull tiles, so train.py's rule traces it brute.

and `first_trace_calls`, which records the trace_hits launches a run makes.
The module imports the package by its absolute name, so that walk_ab.py can
load it from its own tree onto the package of another (an older tree it
times).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    CameraParams,
    RayTargets,
    RenderSettings,
    draw_tile_samples,
)
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene.gaussian_scene import (
    from_arrays,
)
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)

# the Config defaults' eval render (config.py): the k-buffer configuration
FRAME_KW = dict(max_hits=32, cull_cluster=256, max_clusters=192)
ZNEAR, ZFAR = 0.05, 50.0
NF_W, NF_H = 1365, 768
NF_RENDER_N = 100_000
TRAIN_N = 175_000      # init_num_pts + init_num_pts_farfield


def room(n: int, device, seed: int = 0) -> tuple:
    """(scene, camera): room_scene(n, seed) on `device` and its camera."""
    scene = from_arrays(**room_scene(n, seed=seed), pad_multiple=2048,
                        device=device)
    eye, c2w = room_camera()
    camera = CameraParams(origin=torch.tensor(eye, device=device),
                          c2w=torch.tensor(c2w, device=device), fov_y=0.9,
                          znear=ZNEAR, zfar=ZFAR)
    return scene, camera


class _Enough(Exception):
    """Raised to cut a run once its trace launches are recorded."""


def first_trace_calls(run, n: int = 2) -> list:
    """The first `n` trace_hits calls (args, kwargs) that `run()` makes
    through ops/trace.py (the primary and first reflected pass); the run is
    cut after them."""
    from editable_gaussian_reflections_tpu_torch.ops import trace as trace_mod

    calls, real = [], trace_mod.trace_hits

    def record(*args, **kwargs):
        if len(calls) == n:
            raise _Enough
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    trace_mod.trace_hits = record
    try:
        run()
    except _Enough:
        pass
    finally:
        trace_mod.trace_hits = real
    return calls


def eval_render(device) -> SimpleNamespace:
    """The eval render's inputs: scene, camera, settings, the render's
    keywords `kw`, its ray `tile`, and `samples` drawn from `gen` (seed 6),
    which later frames go on drawing from."""
    scene, camera = room(NF_RENDER_N, device)
    tile = min(8192, NF_W * NF_H)
    gen = torch.Generator(device=device).manual_seed(6)
    samples = draw_tile_samples(gen, NF_W, NF_H, tile, 3)
    return SimpleNamespace(scene=scene, camera=camera,
                           settings=RenderSettings(), gen=gen,
                           samples=samples, tile=tile,
                           kw=dict(num_bounces=2, **FRAME_KW))


def render_trace_calls(r: SimpleNamespace) -> list:
    """The primary and first reflected trace_hits launch of `r`'s frame on
    its own samples."""
    return first_trace_calls(lambda: dispatch_render_frame(
        r.scene, r.camera, r.settings, None, NF_W, NF_H, samples=r.samples,
        **r.kw))


def training_step(device) -> SimpleNamespace:
    """The training step's inputs, and `step(state)` -> (state, metrics):
    the state from room_scene(TRAIN_N, seed 1), the targets the G-buffers
    of the seed-0 room rendered on `gen` (seed 8), which the steps go on
    drawing from.  `use_culling` is train.py's rule (it is False here)."""
    cfg = Config()
    settings = tr.settings_from_config(cfg)
    W, H = NF_W, NF_H
    num_bounces, K = 2, cfg.max_hits
    tile = tr.pick_tile_size(W * H, cfg.ray_tile)
    scene_t, camera = room(TRAIN_N, device, seed=0)
    gen = torch.Generator(device=device).manual_seed(8)
    gb, _ = dispatch_render_frame(scene_t, camera, settings, gen, W, H,
                                  num_bounces=2, **FRAME_KW)
    targets = RayTargets(diffuse=gb.rgb[0], specular=gb.rgb[1] + gb.rgb[2],
                         depth=gb.depth[0], normal=gb.normal[0],
                         roughness=gb.roughness[0], f0=gb.f0[0])
    del scene_t, gb
    scene0, _ = room(TRAIN_N, device, seed=1)
    state = tr.init_train_state(scene0)
    cap = scene0.capacity
    # train.py's rule: cull only when the frame and the ray tile divide into
    # cull tiles and the capacity into clusters
    use_culling = (cfg.cull and (W * H) % cfg.cull_tile == 0
                   and tile % cfg.cull_tile == 0
                   and cap % cfg.cull_cluster == 0)
    lrs = tr.lr_tree(cfg, 1, 1.0)
    hyper = dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0)
    step_kw = dict(num_bounces=num_bounces, max_hits=K,
                   chunk=cfg.trace_chunk, tile=tile, use_pallas=True,
                   exp_power_static=float(cfg.exp_power),
                   use_culling=use_culling, cull_tile=cfg.cull_tile,
                   cull_cluster=cfg.cull_cluster,
                   max_clusters=cfg.max_clusters)

    def step(st):
        return tr.train_step(st, camera, targets, settings, lrs, hyper, gen,
                             W, H, **step_kw)

    return SimpleNamespace(cfg=cfg, num_bounces=num_bounces, K=K, tile=tile,
                           capacity=cap, use_culling=use_culling,
                           state=state, step=step)


def step_trace_calls(s: SimpleNamespace) -> list:
    """The primary and first reflected trace_hits launch of `s`'s first
    step."""
    return first_trace_calls(lambda: s.step(s.state))
