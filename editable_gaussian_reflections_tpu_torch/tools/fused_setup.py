"""The fused path at full width, as `chip_smoke.py` drives it (phases 4, 5,
7 and 9) and `tools/walk_ab.py` and `tools/fused_ab.py` time it, in one
place:

  eval render    bench.py's room_scene(100_000) at 800x800, 2 bounces, the
                 Config defaults' k-buffer (K 32, cluster 256, 192
                 candidates): dispatch_render_frame -> render_frame_fused,
                 render_culled three times a frame;
  training step  train.py's Config defaults at 768x768 on
                 room_scene(175_000) (capacity 176,128): seed 1 as the
                 state, the seed-0 room's G-buffers as targets, 8192-ray
                 tiles, culled, all tiles in one trace_slots launch per
                 bounce;
  fast path      the eval render's scene and frame in the scan modes, (a)
                 at bench.py's configuration (BENCH_KW, as the bench twin
                 resolves it: scanq, K 16, cluster 128, 128/768
                 candidates, counters off, bf16 attributes, throughput
                 cutoff 1e-3) and (b) as
                 measure_fps() renders at the Config defaults (scanq, K 32,
                 cluster 256, 192 candidates, counters off) over
                 N_FPS_VIEWS views orbiting room_camera.

`first_two_passes` records a frame's first two render kernel calls, and
`time_frames` / `time_steps` are the timed runs (warm-up, timed, profiled).
The module imports the package by its absolute name, so that a tool can
load it from its own tree onto the package of another (an older tree it
times).
"""

from __future__ import annotations

import math
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.bench import bench_config
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    RayTargets,
    RenderSettings,
    _prepare_fused_frame,
    bounce_epilogue,
    draw_samples,
    fused_forward,
    kernel_call,
    padded_ray_count,
    render_frame_fused,
)
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene.cameras import Camera
from editable_gaussian_reflections_tpu_torch.tools.nonfused_setup import (
    FRAME_KW,
    TRAIN_N,
    ZFAR,
    ZNEAR,
    room,
)
from editable_gaussian_reflections_tpu_torch.utils.synth import room_camera

SETTINGS = RenderSettings()
EVAL_SIZE, EVAL_N = 800, 100_000
TRAIN_W = TRAIN_H = 768
# bench.py's render configuration as the bench twin resolves it from
# artifacts/bench_best.json (today scanq, K 16, cluster 128, 128/768
# candidates, 256-ray cull tiles, counters off, bf16 attributes, throughput
# cutoff 1e-3), in dispatch_render_frame's keywords
BENCH_KW, BENCH_SETTINGS = bench_config()
N_FPS_VIEWS = 8


def first_two_passes(scene, camera, width, height, samples,
                     frame_kw=FRAME_KW, settings=SETTINGS):
    """The render kernel calls (KernelCall) of bounces 0 and 1 of a frame
    rendered with render_frame_fused's keywords `frame_kw`, built by the
    renderer's own helpers (bounce 1 = reflected rays and alive mask)."""
    kw = dict(frame_kw)
    mode = kw.pop("composite_mode", "kbuffer")
    cluster, mc = kw["cull_cluster"], kw["max_clusters"]
    mcs = kw.get("max_clusters_secondary")
    tile_s = kw.get("cull_tile_secondary", 256)
    prep = _prepare_fused_frame(scene, camera, settings, samples, width,
                                height, jitter=True, cull_cluster=cluster,
                                cull_tile_primary=256, num_steps=3,
                                composite_mode=mode)
    R = prep["R"]
    Rp = padded_ray_count(R, mc, mcs, 256, tile_s, composite_mode=mode)
    dirs = torch.cat([prep["dirs"], prep["dirs"][:Rp - R]])
    us = torch.cat([prep["us"], prep["us"][:, :Rp - R]], dim=1)
    rays_o = camera.origin.expand(Rp, 3)
    alive = torch.ones((Rp,), dtype=torch.bool, device=dirs.device)
    throughput = torch.ones((Rp, 3), device=dirs.device)
    common = (prep["gpack"], prep["bounds"], prep["scene_lo"],
              prep["scene_hi"], settings, ZNEAR, ZFAR)
    pass_kw = dict(capacity=scene.capacity, max_hits=kw["max_hits"],
                   exp_power_static=3.0, cull_cluster=cluster,
                   max_clusters=mc, max_clusters_secondary=mcs,
                   cull_tile_secondary=tile_s, cull_tile_primary=256,
                   scan=prep["scan"],
                   kernel_stats=kw.get("kernel_stats", True),
                   attr_precision=kw.get("attr_precision", "highest"))
    call0 = kernel_call(rays_o, dirs, alive, 0, *common, **pass_kw)
    out0 = call0.kernel(*call0.args, **call0.kwargs)
    _, (o1, d1, _t1, al1) = bounce_epilogue(out0, call0, rays_o, dirs,
                                            throughput, alive, us[0], 0,
                                            settings, ZFAR)
    call1 = kernel_call(o1, d1, al1, 1, *common, **pass_kw)
    return call0, call1


def eval_frame(device) -> SimpleNamespace:
    """The eval render's inputs: scene, camera, its generator `gen` (seed
    2), the keywords `frame_kw`, and `calls`, the render_culled calls of the
    primary and first reflected pass of a frame on gen's first samples
    (later frames go on drawing from gen)."""
    W = H = EVAL_SIZE
    scene, camera = room(EVAL_N, device)
    gen = torch.Generator(device=device).manual_seed(2)
    calls = first_two_passes(scene, camera, W, H, draw_samples(gen, W, H, 3))
    return SimpleNamespace(scene=scene, camera=camera, gen=gen, W=W, H=H,
                           settings=SETTINGS, calls=calls,
                           frame_kw=dict(num_bounces=2, **FRAME_KW))


def orbit_views(n: int, width: int, height: int) -> list:
    """`n` scene cameras (scene/cameras.py) circling the room's vertical
    axis around room_camera's pose, +-0.25 rad, the z-planes of the smoke's
    frames: the views measure_fps renders."""
    eye, c2w = room_camera()
    views = []
    blank = np.zeros((height, width, 3), np.float32)
    for i in range(n):
        a = -0.25 + 0.5 * i / max(1, n - 1)
        rz = np.array([[math.cos(a), -math.sin(a), 0.0],
                       [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
        c2w_i, eye_i = rz @ c2w, rz @ eye
        # Camera.render_pose negates R and then its first column again
        R = -c2w_i
        R[:, 0] = c2w_i[:, 0]
        T = -R.T @ eye_i
        fov_x = 2.0 * math.atan(math.tan(0.45) * width / height)
        view = Camera(colmap_id=i, R=R, T=T, FoVx=fov_x, FoVy=0.9,
                      image=blank, image_name=f"orbit_{i}", uid=i)
        view.znear, view.zfar = ZNEAR, ZFAR
        views.append(view)
    return views


def fast_path(device, model_path: str) -> SimpleNamespace:
    """The fast path's inputs: the eval render's scene and camera, its
    generator `gen` (seed 5) and the samples of its first frame; `calls`,
    the render_scan calls of the primary and first reflected pass of a
    frame on those samples for (a) bench.py's scanq ("bench scanq") and its
    scan twin ("bench scan": direct pair math, float attributes) and (b)
    measure_fps's scanq at the Config defaults ("fps scanq"); `bench`, the
    eval_frame-like inputs of time_frames for (a)'s scanq frame (later
    frames go on drawing from gen); and (b)'s Config `cfg` (its fps.json
    written to model_path), settings and N_FPS_VIEWS `views`."""
    from editable_gaussian_reflections_tpu_torch.config import Config

    W = H = EVAL_SIZE
    scene, camera = room(EVAL_N, device)
    gen = torch.Generator(device=device).manual_seed(5)
    samples = draw_samples(gen, W, H, 3)
    cfg = Config()
    cfg.composite_mode = "scanq"        # measure_fps.main's default
    cfg.model_path = model_path
    settings = tr.settings_from_config(cfg)
    fps_kw = dict(max_hits=cfg.max_hits, cull_cluster=cfg.cull_cluster,
                  max_clusters=cfg.max_clusters, composite_mode="scanq",
                  kernel_stats=False)
    configs = {"bench scanq": (BENCH_KW, BENCH_SETTINGS),
               "bench scan": (dict(BENCH_KW, composite_mode="scan",
                                   attr_precision="highest"),
                              BENCH_SETTINGS),
               "fps scanq": (fps_kw, settings)}
    calls = {name: first_two_passes(scene, camera, W, H, samples, kw, st)
             for name, (kw, st) in configs.items()}
    bench = SimpleNamespace(scene=scene, camera=camera, gen=gen, W=W, H=H,
                            settings=BENCH_SETTINGS,
                            frame_kw=dict(num_bounces=2, **BENCH_KW))
    return SimpleNamespace(scene=scene, camera=camera, gen=gen, W=W, H=H,
                           samples=samples, calls=calls, bench=bench,
                           cfg=cfg, settings=settings,
                           views=orbit_views(N_FPS_VIEWS, W, H))


def training_step(device, n: int = TRAIN_N, side: int = TRAIN_W,
                  max_hits: int = 0, **split) -> SimpleNamespace:
    """The training step's inputs at side x side pixels (768x768 unless a
    test shrinks it), and `step(state)` -> (state, metrics): the state from
    room_scene(n, seed 1), the targets the G-buffers of the seed-0 room
    rendered on `gen` (seed 3), which prepare_step and the
    steps go on drawing from.  `calls`: the trace_slots calls of the
    primary and first reflected pass of the first batch of tiles the step
    launches, from fused_forward, whose outputs (`steps`, `residuals`) and
    targets (`targets_b`) it keeps for the backward.  `max_hits`: K in
    place of the Config's (0 keeps it).  `split`: train_step's split-far
    keywords for `step` (the calls stay one pass's)."""
    cfg = Config()
    settings = tr.settings_from_config(cfg)
    num_bounces, K = 2, max_hits or cfg.max_hits
    tile = tr.pick_tile_size(side * side, cfg.ray_tile)
    step_kw = dict(num_bounces=num_bounces, max_hits=K,
                   chunk=cfg.trace_chunk, tile=tile, use_pallas=True,
                   exp_power_static=float(cfg.exp_power), use_culling=True,
                   cull_tile=cfg.cull_tile, cull_cluster=cfg.cull_cluster,
                   max_clusters=cfg.max_clusters)
    scene_t, camera = room(n, device, seed=0)
    gen = torch.Generator(device=device).manual_seed(3)
    gb, _ = render_frame_fused(scene_t, camera, settings, gen, side, side,
                               num_bounces=2, **FRAME_KW)
    targets = RayTargets(diffuse=gb.rgb[0], specular=gb.rgb[1] + gb.rgb[2],
                         depth=gb.depth[0], normal=gb.normal[0],
                         roughness=gb.roughness[0], f0=gb.f0[0])
    del scene_t, gb
    scene0, _ = room(n, device, seed=1)
    state = tr.init_train_state(scene0)
    cap = scene0.capacity
    lrs = tr.lr_tree(cfg, 1, 1.0)
    hyper = dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0)
    prep = tr.prepare_step(
        state, camera, targets, settings, gen, side, side,
        num_bounces, tile, True, True, True, cfg.cull_tile, cfg.cull_cluster,
        cfg.max_clusters)
    n_tiles = prep["dirs_t"].shape[0]
    tiles_per_launch = tr.tiles_per_launch_for(n_tiles, tile,
                                               num_bounces + 1, K, device)
    # the first batch of tiles the main path launches
    rays_o, rays_d, targets_b, us = tr.tile_batch(
        camera.origin, prep["dirs_t"], prep["targets_t"], prep["us_t"], 0,
        tiles_per_launch)
    cull = prep["culling"]
    steps, _final, residuals, calls = fused_forward(
        rays_o, rays_d, settings, camera.znear, camera.zfar, us, num_bounces,
        K, gpack=prep["gpack"], table=cull["table"], ftable=cull["ftable"],
        bounds=cull["bounds"], cull_tile=cfg.cull_tile,
        cull_cluster=cfg.cull_cluster, max_clusters=cfg.max_clusters,
        n_capacity=cap, exp_power_static=float(cfg.exp_power),
        tile_rays=tile)
    del prep

    def step(st):
        return tr.train_step(st, camera, targets, settings, lrs, hyper, gen,
                             side, side, **step_kw, **split)

    return SimpleNamespace(
        cfg=cfg, settings=settings, num_bounces=num_bounces, K=K, tile=tile,
        step_kw=step_kw, camera=camera, gen=gen, state=state, capacity=cap,
        lrs=lrs, hyper=hyper, n_tiles=n_tiles,
        tiles_per_launch=tiles_per_launch, targets_b=targets_b, steps=steps,
        residuals=residuals, calls=calls[:2], step=step)


def card() -> str:
    """The card's name, power limit, SM clock now and its maximum, as
    nvidia-smi gives them (beside every time a tool prints)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_time_us(event) -> float:
    # renamed from self_cuda_time_total in recent PyTorch releases
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


def profile_device(fn) -> tuple:
    """(host ms, {kernel: device ms}, fn's result) of one profiled call of
    fn."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            by_kernel[e.key] = device_time_us(e) / 1e3
    return host_ms, by_kernel, out


def time_frames(e: SimpleNamespace, n_timed: int = 3) -> SimpleNamespace:
    """`e`'s frame (eval_frame) through dispatch_render_frame: one warm-up,
    `n_timed` timed (host clock, synchronized) and one profiled frame, each
    on gen's next samples.  ms per frame, the last timed frame's (steps,
    final) and the profiled frame's device ms by kernel."""
    def frame():
        return dispatch_render_frame(e.scene, e.camera, e.settings, e.gen,
                                     e.W, e.H, **e.frame_kw)

    frame()                                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        steps, final = frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    _host, by_kernel, _ = profile_device(frame)
    return SimpleNamespace(ms=ms, steps=steps, final=final,
                           by_kernel=by_kernel)


def time_steps(t: SimpleNamespace, n_timed: int = 3, reset=None,
               count=None) -> SimpleNamespace:
    """`t`'s training step (training_step) from its state: one warm-up,
    `n_timed` timed steps (host clock, synchronized) and one profiled step,
    each on the state the last left.  ms per step, l1_diffuse and starved
    share per timed step, the peak of allocated memory (GB), the state after
    the timed steps and after the profiled one, and the profiled step's
    device ms by kernel.  reset() and count(), where given, run just before
    and just after the timed steps (launch counters); `launches` is what
    count() returned."""
    torch.cuda.reset_peak_memory_stats()
    st, _m = t.step(t.state)                                     # warm-up
    torch.cuda.synchronize()
    if reset is not None:
        reset()
    l1s, starved = [], []
    t0 = time.perf_counter()
    for _ in range(n_timed):
        st, m = t.step(st)
        l1s.append(m["l1_diffuse"])
        starved.append(m["starved"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = count() if count is not None else None
    timed_state = st
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _host, by_kernel, (st, _m) = profile_device(lambda: t.step(timed_state))
    return SimpleNamespace(ms=ms, l1s=[x.item() for x in l1s],
                           starved=[x.item() for x in starved],
                           peak_gb=peak_gb, launches=launches,
                           timed_state=timed_state, state=st,
                           by_kernel=by_kernel)
