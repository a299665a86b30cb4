"""The training step in plain PyTorch: a frozen copy of the port's
training.py (the fused, culled step and Adam), over the reference's
renderer/raytracer.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops.camera_rays import primary_ray_directions
from .ops.culling import cluster_bounds, morton_order, tile_pixel_order
from .ops.plain.layout import pack_attr_table, pack_frame_table, pack_frames
from .ops.precision import div, rounded
from .ops.render_grads import (
    ParamGrads,
    grads_from_accumulator,
    new_grad_accumulator,
)
from .renderer.raytracer import (
    CameraParams,
    RayTargets,
    RenderSettings,
    TileSamples,
    far_hits,
    render_tile_with_grads_fused,
    tiles_per_launch_for,
)
from .scene.gaussian_scene import GaussianScene, build_frames


class TrainState(NamedTuple):
    scene: GaussianScene
    mu: GaussianScene          # Adam first moments (same fields as params)
    nu: GaussianScene          # Adam second moments
    count: int                 # Adam step count
    total_weight: torch.Tensor  # [N] accumulated per-Gaussian weight


PARAM_FIELDS = ("xyz", "scaling", "rotation", "opacity", "diffuse", "normal",
                "f0", "roughness")


_GRAD_TO_PARAM = dict(mean="xyz", scale="scaling", rotation="rotation",
                      opacity="opacity", rgb="diffuse", normal="normal",
                      f0="f0", roughness="roughness")


def init_train_state(scene: GaussianScene) -> TrainState:
    zeros = scene._replace(**{f: torch.zeros_like(getattr(scene, f))
                              for f in PARAM_FIELDS})
    return TrainState(scene=scene, mu=zeros, nu=zeros, count=0,
                      total_weight=torch.zeros(scene.capacity,
                                               dtype=torch.float32,
                                               device=scene.xyz.device))


def prepare_render_inputs(scene: GaussianScene, settings: RenderSettings,
                          use_pallas: bool, use_culling: bool, cull_tile: int,
                          cull_cluster: int, max_clusters: int,
                          split_far: bool = False, mc_far: int = 32,
                          max_hits_far: int = 0,
                          split_radius_scale: float = 1.5):
    """Per-step scene preprocessing: activated frames and gpack; with
    culling also the Morton sort (the BVH-refit analog), cluster bounds and
    the slots kernel's tables, all in the sorted layout, and split-far's
    options in the culling dict.  Without culling the scene keeps its
    order: culling and gauss_perm are None.

    use_pallas=False (the XLA tracer) needs no packed table and never
    culls: (frames, attrs, None, None, scene, None), as in JAX.

    Returns (frames, attrs, gpack, culling, scene_for_bwd, gauss_perm)."""
    frames, attrs = build_frames(scene, settings.alpha_threshold,
                                 settings.exp_power,
                                 settings.global_scale_factor)
    if not use_pallas:
        return frames, attrs, None, None, scene, None
    if not use_culling:
        return (frames, attrs, pack_frames(frames, attrs).contiguous(), None,
                scene, None)
    gauss_perm = morton_order(frames)
    frames = frames.take(gauss_perm)
    attrs = attrs.take(gauss_perm)
    scene_for_bwd = GaussianScene(*(a[gauss_perm] for a in scene))
    culling = dict(bounds=cluster_bounds(frames, cull_cluster),
                   cull_tile=cull_tile, cluster=cull_cluster, mc=max_clusters,
                   table=pack_attr_table(attrs).contiguous(),
                   ftable=pack_frame_table(frames,
                                           scene_for_bwd).contiguous(),
                   split_far=split_far, mc_far=mc_far,
                   max_hits_far=max_hits_far,
                   split_radius_scale=split_radius_scale)
    gpack = pack_frames(frames, attrs).contiguous()
    return frames, attrs, gpack, culling, scene_for_bwd, gauss_perm


def prepare_rays(width: int, height: int, camera: CameraParams,
                 jitter: torch.Tensor | None, cull_tile: int,
                 use_culling: bool):
    """Primary ray dirs (+ optional jitter [H, W, 2]) and the square-pixel
    tile permutation used when culling.  Returns (dirs [R, 3],
    ray_perm | None, ray_inv | None)."""
    dirs = primary_ray_directions(width, height, camera.fov_y, camera.c2w,
                                  jitter=jitter).reshape(-1, 3)
    ray_perm = ray_inv = None
    if use_culling:
        th = tw = int(cull_tile ** 0.5)
        if height % th or width % tw or th * tw != cull_tile:
            th, tw = 16, cull_tile // 16
        if height % th == 0 and width % tw == 0:
            perm_np, inv_np = tile_pixel_order(height, width, th, tw)
            dev = dirs.device
            ray_perm = torch.as_tensor(perm_np, dtype=torch.int64, device=dev)
            ray_inv = torch.as_tensor(inv_np, dtype=torch.int64, device=dev)
            dirs = dirs[ray_perm]
    return dirs, ray_perm, ray_inv


def tile_batch(origin, dirs_t, targets_t: RayTargets, us_t, b0: int,
               b1: int):
    """Tiles b0..b1-1 as one batch of rays: (rays_o, rays_d, targets,
    us [S, rays, 2])."""
    B, tile = b1 - b0, dirs_t.shape[1]
    rays_d = dirs_t[b0:b1].reshape(B * tile, 3)
    targets = RayTargets(*(a[b0:b1].reshape((B * tile,) + a.shape[2:])
                           for a in targets_t))
    us = us_t[b0:b1].permute(1, 0, 2, 3).reshape(us_t.shape[1], B * tile, 2)
    return origin.expand(B * tile, 3), rays_d, targets, us


def accumulate_over_tiles(origin, dirs_t, targets_t: RayTargets, settings,
                          camera: CameraParams, us_t, num_bounces: int,
                          max_hits: int, exp_power_static: float, gpack,
                          culling: dict | None, n_capacity: int,
                          tiles_per_launch: int | None = None, *,
                          frames=None, attrs=None,
                          scene_for_bwd: GaussianScene | None = None,
                          use_pallas: bool = True, chunk: int = 2048,
                          opts=None):
    """grads_over_tiles before its rounding: (the [N, SCATTER_COLS] float64
    gradient sums, the per-tile l1_diffuse sums [T] float64, the starved
    flags' sum).  The ray-sharded step reduces these across its ranks and
    rounds once, as one process does."""
    T, tile = dirs_t.shape[:2]
    dev = dirs_t.device
    split = culling is not None and culling.get("split_far", False)
    if tiles_per_launch is None:
        # a split bounce keeps K + K_far slots a ray
        slots = max_hits + (far_hits(max_hits, culling["max_hits_far"])
                            if split else 0)
        tiles_per_launch = tiles_per_launch_for(T, tile, num_bounces + 1,
                                                slots, dev)
    acc = new_grad_accumulator(n_capacity, dev)
    l1_tiles, starved = [], []
    for b0 in range(0, T, tiles_per_launch):
        b1 = min(T, b0 + tiles_per_launch)
        rays_o, rays_d, targets, us = tile_batch(origin, dirs_t, targets_t,
                                                 us_t, b0, b1)
        if culling is None:
            raise ValueError("the reference runs the fused, culled step")
        steps, _final, _ = render_tile_with_grads_fused(
            rays_o, rays_d, targets, settings, camera.znear, camera.zfar,
            us, num_bounces, max_hits, gpack=gpack,
            table=culling["table"], ftable=culling["ftable"],
            bounds=culling["bounds"], cull_tile=culling["cull_tile"],
            cull_cluster=culling["cluster"], max_clusters=culling["mc"],
            n_capacity=n_capacity, exp_power_static=exp_power_static,
            split_far=split, mc_far=culling.get("mc_far", 32),
            max_hits_far=culling.get("max_hits_far", 0),
            split_radius_scale=culling.get("split_radius_scale", 1.5),
            tile_rays=tile, grad_acc=acc, opts=opts)
        err = (steps.rgb[0] - targets.diffuse).abs()
        per_ray = div(err[:, 0] + err[:, 1] + err[:, 2], 3.0)
        l1_tiles.append(per_ray.reshape(b1 - b0, tile).to(torch.float64)
                        .sum(1))
        starved.append(steps.overflow.to(torch.float64).sum())
    return acc, torch.cat(l1_tiles), torch.stack(starved).sum()


def grads_over_tiles(origin, dirs_t, targets_t: RayTargets, settings,
                     camera: CameraParams, us_t, num_bounces: int,
                     max_hits: int, exp_power_static: float, gpack,
                     culling: dict | None, n_capacity: int,
                     tiles_per_launch: int | None = None, *, frames=None,
                     attrs=None, scene_for_bwd: GaussianScene | None = None,
                     use_pallas: bool = True, chunk: int = 2048,
                     opts=None):
    """The forward + backward over [T, tile, ...] ray tiles, in batches of
    `tiles_per_launch` tiles (module docstring; None: tiles_per_launch_for's
    count): the fused path (render_tile_with_grads_fused) with `culling`,
    else the non-fused path (render_tile_with_grads: the brute kernel, or
    with use_pallas=False trace_rays in chunks of `chunk` Gaussians), which
    reads `frames`, `attrs` and `scene_for_bwd` (prepare_render_inputs').

    us_t [T, S, tile, 2] are each tile's GGX uniforms.  Returns (ParamGrads
    summed over tiles, rounded once; l1_diffuse summed over rays; the sum
    of the starved flags over bounces and rays)."""
    acc, l1_tiles, starved = accumulate_over_tiles(
        origin, dirs_t, targets_t, settings, camera, us_t, num_bounces,
        max_hits, exp_power_static, gpack, culling, n_capacity,
        tiles_per_launch, frames=frames, attrs=attrs,
        scene_for_bwd=scene_for_bwd, use_pallas=use_pallas, chunk=chunk,
        opts=opts)
    return grads_from_accumulator(acc), l1_tiles.sum(), starved


def apply_updates(state: TrainState, grads: ParamGrads, lrs: dict,
                  hyper: dict) -> TrainState:
    """Scale decay + per-group Adam + clamps (train.py:224-254), in the JAX
    package's operation order; sqrt and pow from WIDE, rounded once."""
    scene = state.scene
    dev = scene.xyz.device
    live = scene.live_mask
    # scale decay right after render (train.py:224-226)
    log_decay = rounded(torch.log, torch.tensor(hyper["scale_decay"],
                                                dtype=torch.float32))
    decayed = torch.where(live[:, None],
                          scene.scaling + log_decay.to(dev), scene.scaling)
    scene = scene._replace(scaling=decayed)

    # Adam (torch semantics: m / (sqrt(v) + eps), bias-corrected)
    g_tree = {_GRAD_TO_PARAM[k]: getattr(grads, k) for k in _GRAD_TO_PARAM}
    apply = hyper["apply_grads"]
    b1, b2 = hyper["beta_1"], hyper["beta_2"]
    eps = 1e-15
    count = state.count + 1

    def bias(beta):
        p = rounded(torch.pow, torch.tensor(beta, dtype=torch.float32),
                    float(count))
        return (1.0 - p).to(dev)

    c1, c2 = bias(b1), bias(b2)
    new_params, new_mu, new_nu = {}, {}, {}
    for f in PARAM_FIELDS:
        p = getattr(scene, f)
        g = g_tree[f].reshape(p.shape) * apply
        m = b1 * getattr(state.mu, f) + (1.0 - b1) * g
        v = b2 * getattr(state.nu, f) + (1.0 - b2) * g * g
        update = (m / c1) / (rounded(torch.sqrt, v / c2) + eps)
        mask = live.reshape((-1,) + (1,) * (p.ndim - 1)).to(p.dtype)
        new_params[f] = p - lrs[f] * update * mask
        new_mu[f] = m
        new_nu[f] = v

    # clamps (train.py:251-254)
    new_params["diffuse"] = torch.clamp(new_params["diffuse"], min=0.0)
    new_params["roughness"] = torch.clamp(new_params["roughness"], 0.0, 1.0)
    new_params["f0"] = torch.clamp(new_params["f0"], 0.0, 1.0)
    return TrainState(
        scene=scene._replace(**new_params),
        mu=state.mu._replace(**new_mu),
        nu=state.nu._replace(**new_nu),
        count=count,
        total_weight=state.total_weight + grads.total_weight,
    )


def prepare_step(state: TrainState, camera: CameraParams,
                 targets: RayTargets, settings: RenderSettings,
                 generator: torch.Generator | None, width: int, height: int,
                 num_bounces: int, tile: int, jitter: bool = True,
                 use_pallas: bool = False, use_culling: bool = False,
                 cull_tile: int = 256, cull_cluster: int = 256,
                 max_clusters: int = 192, split_far: bool = False,
                 samples: TileSamples | None = None, *, mc_far: int = 32,
                 max_hits_far: int = 0,
                 split_radius_scale: float = 1.5) -> dict:
    """Everything a step computes before its ray tiles: the scene's sorted
    tables, the samples, the primary rays and targets in pixel-tile order
    cut into [T, tile, ...] ray tiles.  Returns a dict of grads_over_tiles'
    inputs plus gauss_perm (None when not culling).  Culling needs
    use_pallas, as in JAX."""
    scene = state.scene
    cull_tile = min(cull_tile, 256)
    use_culling = use_culling and use_pallas
    frames, attrs, gpack, culling, scene_s, gauss_perm = (
        prepare_render_inputs(scene, settings, use_pallas, use_culling,
                              cull_tile, cull_cluster, max_clusters,
                              split_far=split_far, mc_far=mc_far,
                              max_hits_far=max_hits_far,
                              split_radius_scale=split_radius_scale))
    R = width * height
    tile_sz = min(tile, R)
    # padding would duplicate rays and double-count their gradients; the
    # host picks a tile size dividing H*W (pick_tile_size)
    if R % tile_sz:
        raise ValueError(f"H*W={R} must be divisible by tile={tile_sz}")
    num_tiles = R // tile_sz
    if samples is None:
        raise ValueError("the reference's step takes its samples")
    dirs, ray_perm, _ray_inv = prepare_rays(
        width, height, camera, samples.jitter if jitter else None, cull_tile,
        use_culling)
    if ray_perm is not None:
        targets = RayTargets(*(a[ray_perm] for a in targets))
    return dict(
        dirs_t=dirs.reshape(num_tiles, tile_sz, 3),
        targets_t=RayTargets(*(a.reshape((num_tiles, tile_sz) + a.shape[1:])
                               for a in targets)),
        us_t=samples.us, gpack=gpack, culling=culling, gauss_perm=gauss_perm,
        frames=frames, attrs=attrs, scene_for_bwd=scene_s)


def train_step(
    state: TrainState,
    camera: CameraParams,
    targets: RayTargets,          # flattened [H*W, ...]
    settings: RenderSettings,
    lrs: dict,                    # per-field scalar LRs
    hyper: dict,                  # beta_1, beta_2, scale_decay, apply_grads
    generator: torch.Generator | None,
    width: int,
    height: int,
    num_bounces: int,
    max_hits: int,
    chunk: int,
    tile: int,
    jitter: bool = True,
    use_pallas: bool = False,
    exp_power_static: float = 3.0,
    use_culling: bool = False,
    cull_tile: int = 256,
    cull_cluster: int = 256,
    max_clusters: int = 192,
    split_far: bool = False,
    samples: TileSamples | None = None,
    mc_far: int = 32,
    max_hits_far: int = 0,
    split_radius_scale: float = 1.5,
    opts=None,
):
    """One training iteration (the JAX train_step's contract).

    With use_pallas, use_culling selects the fused kernel path (the JAX
    package's Pallas culled backend), else the non-fused brute path
    (module docstring), whose kernel blocks the Gaussians its own way and
    so does not read `chunk`.  use_pallas=False (the default, as in JAX) is
    the JAX XLA tracer's step: never culled, traced by trace_rays in chunks
    of `chunk` Gaussians.  The step's randomness is `samples`, or drawn
    from `generator` when that is None.  split_far (mc_far, max_hits_far
    0 = max(8, max_hits // 2), split_radius_scale) splits every bounce of
    the fused step in two passes (module docstring).

    Returns (new TrainState, metrics) with metrics l1_diffuse (mean over
    rays) and starved (share of bounce x ray slots whose candidate list
    overflowed while the ray was still accumulating), 0-d tensors."""
    prep = prepare_step(state, camera, targets, settings, generator, width,
                        height, num_bounces, tile, jitter, use_pallas,
                        use_culling, cull_tile, cull_cluster, max_clusters,
                        split_far, samples, mc_far=mc_far,
                        max_hits_far=max_hits_far,
                        split_radius_scale=split_radius_scale)
    grads, l1, starved = grads_over_tiles(
        camera.origin, prep["dirs_t"], prep["targets_t"], settings, camera,
        prep["us_t"], num_bounces, max_hits, exp_power_static, prep["gpack"],
        prep["culling"], state.scene.capacity, frames=prep["frames"],
        attrs=prep["attrs"], scene_for_bwd=prep["scene_for_bwd"],
        use_pallas=use_pallas, chunk=chunk, opts=opts)
    if prep["gauss_perm"] is not None:
        # grads are in the Morton-sorted layout; back to the scene's slots
        grads = grads.take(torch.argsort(prep["gauss_perm"]))
    new_state = apply_updates(state, grads, lrs, hyper)
    R = width * height
    metrics = dict(
        l1_diffuse=(l1 / R).to(torch.float32),
        starved=(starved / ((num_bounces + 1) * R)).to(torch.float32))
    return new_state, metrics


def pick_tile_size(num_rays: int, preferred: int) -> int:
    """Largest divisor of num_rays that is <= preferred."""
    t = min(preferred, num_rays)
    while num_rays % t != 0:
        t -= 1
    return t
