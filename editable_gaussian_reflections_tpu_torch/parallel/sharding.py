"""Ray-parallel rendering and training over a process mesh (twin of the JAX
parallel/sharding.py).

  * Rays (pixels) shard across the mesh axis "rays": each rank traces and
    composites its contiguous share of the frame's tile-ordered rays.
  * The Gaussian parameters are replicated, so the one collective of the
    step is the gradient all-reduce, and the Adam update then runs
    replicated on every rank.

Every rank calls these functions with the same replicated inputs (state,
targets, samples or an identically seeded generator) and gets the same
replicated outputs.  The samples are drawn per ray tile, as the
single-process step draws them; a rank takes the tiles of its shard (the
JAX tile_offset), so sharded_train_step with the same `tile` equals
training.train_step.  It reduces the step's float64 gradient sums before
their one rounding (training.py's module docstring), and sums the per-tile
l1 in tile order, so the parameter delta against train_step is 0 (up to the
order in which the float64 sums are added, below float32's resolution).
"""

from __future__ import annotations

import torch

from ..ops.cuda.trace_hits import BRUTE_TILE
from ..ops.render_grads import grads_from_accumulator
from ..renderer.raytracer import (
    CameraParams,
    FrameSamples,
    RayTargets,
    RenderSettings,
    StepOutputs,
    TileSamples,
    _fused_bounce_core,
    _prepare_fused_frame,
    check_composite_mode,
    draw_tile_samples,
    full_f32_matmuls,
    render_tile,
    tiles_per_launch_for,
)
from ..training import (
    TrainState,
    accumulate_over_tiles,
    apply_updates,
    prepare_render_inputs,
    prepare_rays,
    prepare_step,
)
from .mesh import Mesh, all_gather, all_reduce, make_mesh

__all__ = ["make_mesh", "sharded_train_step", "sharded_render",
           "sharded_render_fused"]


def _shard(mesh: Mesh, axis: str, n: int) -> tuple[int, slice]:
    """(shard size, this rank's slice) of n items split over `axis`."""
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} must divide by the {size} ranks of "
                         f"{axis!r}")
    per = n // size
    i = mesh.index[axis]
    return per, slice(i * per, (i + 1) * per)


def sharded_train_step(
    mesh: Mesh,
    state: TrainState,
    camera: CameraParams,
    targets: RayTargets,
    settings: RenderSettings,
    lrs: dict,
    hyper: dict,
    generator: torch.Generator | None,
    width: int,
    height: int,
    num_bounces: int = 2,
    max_hits: int = 32,
    chunk: int = 2048,
    tile: int | None = None,
    jitter: bool = True,
    use_pallas: bool = False,
    exp_power_static: float = 3.0,
    use_culling: bool = False,
    cull_tile: int = 256,
    cull_cluster: int = 256,
    max_clusters: int = 192,
    split_far: bool = False,
    samples: TileSamples | None = None,
    axis: str = "rays",
    mc_far: int = 32,
    max_hits_far: int = 0,
    split_radius_scale: float = 1.5,
):
    """One data-parallel training step: rays sharded over `axis`, the
    parameters replicated, the gradients all-reduced.  Returns (new
    TrainState, metrics), the same on every rank; metrics as train_step's
    (split-far as there: each ray's two passes are its own).

    With `tile` equal to train_step's tile (default: one tile per shard)
    the result equals train_step on the same samples.  The shard must be a
    whole number of tiles."""
    R = width * height
    shard_R, _ = _shard(mesh, axis, R)
    tile_sz = min(tile or shard_R, shard_R)
    if shard_R % tile_sz:
        raise ValueError(f"a shard of {shard_R} rays is not a whole number "
                         f"of {tile_sz}-ray tiles")
    if samples is None:
        if generator is None:
            raise ValueError("a step needs samples or a generator")
        samples = draw_tile_samples(generator, width, height, tile_sz,
                                    num_bounces + 1, jitter)
    if samples.us.shape[2] != tile_sz:
        raise ValueError(f"samples are drawn for {samples.us.shape[2]}-ray "
                         f"tiles, the step takes {tile_sz}-ray tiles")
    prep = prepare_step(state, camera, targets, settings, None, width,
                        height, num_bounces, tile_sz, jitter, use_pallas,
                        use_culling, cull_tile, cull_cluster, max_clusters,
                        split_far, samples, mc_far=mc_far,
                        max_hits_far=max_hits_far,
                        split_radius_scale=split_radius_scale)
    _, tiles = _shard(mesh, axis, prep["dirs_t"].shape[0])
    acc, l1_tiles, starved = accumulate_over_tiles(
        camera.origin, prep["dirs_t"][tiles],
        RayTargets(*(a[tiles] for a in prep["targets_t"])), settings, camera,
        prep["us_t"][tiles], num_bounces, max_hits, exp_power_static,
        prep["gpack"], prep["culling"], state.scene.capacity,
        frames=prep["frames"], attrs=prep["attrs"],
        scene_for_bwd=prep["scene_for_bwd"], use_pallas=use_pallas,
        chunk=chunk)
    acc = all_reduce(acc, mesh, axis)
    l1_tiles = all_gather(l1_tiles, mesh, axis)
    starved = all_reduce(starved, mesh, axis)
    grads = grads_from_accumulator(acc)
    if prep["gauss_perm"] is not None:
        grads = grads.take(torch.argsort(prep["gauss_perm"]))
    new_state = apply_updates(state, grads, lrs, hyper)
    metrics = dict(
        l1_diffuse=(l1_tiles.sum() / R).to(torch.float32),
        starved=(starved / ((num_bounces + 1) * R)).to(torch.float32))
    return new_state, metrics


def sharded_render(
    mesh: Mesh,
    scene,
    camera: CameraParams,
    settings: RenderSettings,
    generator: torch.Generator | None,
    width: int,
    height: int,
    num_bounces: int = 2,
    max_hits: int = 32,
    chunk: int = 2048,
    jitter: bool = False,
    use_pallas: bool = False,
    exp_power_static: float = 3.0,
    use_culling: bool = False,
    cull_tile: int = 256,
    cull_cluster: int = 256,
    max_clusters: int = 192,
    samples: TileSamples | None = None,
    axis: str = "rays",
) -> torch.Tensor:
    """Forward render with the rays sharded over `axis`, each shard one ray
    tile of render_frame (so it equals render_frame with tile = H*W / the
    shards, on the same TileSamples); returns final [H*W, 3] in linear
    pixel order on every rank.  Culling needs use_pallas, and each shard a
    whole number of cull tiles.  A shard goes through render_tile in
    batches of whole cull tiles (tiles_per_launch_for), which equals one
    batch: nothing in it spans rays beyond a cull tile."""
    full_f32_matmuls()
    R = width * height
    shard_R, rays = _shard(mesh, axis, R)
    cull_tile = min(cull_tile, 256)
    use_culling = use_culling and use_pallas
    if use_culling and shard_R % cull_tile:
        raise ValueError(f"a shard of {shard_R} rays is not a whole number "
                         f"of {cull_tile}-ray cull tiles")
    frames, attrs, gpack, culling, _s, _p = prepare_render_inputs(
        scene, settings, use_pallas, use_culling, cull_tile, cull_cluster,
        max_clusters)
    num_steps = num_bounces + 1
    if samples is None:
        if generator is None:
            raise ValueError("a frame needs samples or a generator")
        samples = draw_tile_samples(generator, width, height, shard_R,
                                    num_steps, jitter)
    dirs, _perm, ray_inv = prepare_rays(
        width, height, camera, samples.jitter if jitter else None, cull_tile,
        culling is not None)
    dirs = dirs[rays]
    us = samples.us[mesh.index[axis]]                        # [S, shard, 2]
    unit = cull_tile if culling is not None else BRUTE_TILE
    batch = unit * tiles_per_launch_for(-(-shard_R // unit), unit, num_steps,
                                        max_hits, dirs.device)
    finals = []
    for b0 in range(0, shard_R, batch):
        n = min(batch, shard_R - b0)
        _steps, final, _ = render_tile(
            camera.origin.expand(n, 3), dirs[b0:b0 + n], gpack, attrs,
            settings, camera.znear, camera.zfar, us[:, b0:b0 + n],
            num_bounces, max_hits, exp_power_static=exp_power_static,
            culling=culling, use_pallas=use_pallas, frames=frames,
            chunk=chunk)
        finals.append(final)
    final = all_gather(torch.cat(finals), mesh, axis)
    return final if ray_inv is None else final[ray_inv]


def sharded_render_fused(
    mesh: Mesh,
    scene,
    camera: CameraParams,
    settings: RenderSettings,
    generator: torch.Generator | None,
    width: int,
    height: int,
    num_bounces: int = 2,
    max_hits: int = 32,
    jitter: bool = True,
    exp_power_static: float = 3.0,
    cull_cluster: int = 256,
    max_clusters: int = 64,
    rays_per_call: int = 65536,
    max_clusters_secondary: int | None = None,
    cull_tile_secondary: int = 256,
    cull_tile_primary: int = 256,
    split_far: bool = False,
    composite_mode: str = "kbuffer",
    samples: FrameSamples | None = None,
    axis: str = "rays",
    mc_far: int = 32,
    split_radius_scale: float = 1.5,
    max_hits_far: int = 0,
):
    """render_frame_fused's per-bounce kernel path with the rays sharded
    over `axis`.  The scene preparation (Morton sort, cluster bounds,
    gpack) and the frame's samples are replicated, as in
    render_frame_fused; each rank runs the same bounce loop on its
    contiguous share of the tile-ordered rays.  The reflected rays'
    re-sorts and culling become shard-local, which changes only which tile
    a ray shares its candidate list with, so the output equals the
    single-process frame where neither starved.  The shard must be a whole
    number of the larger cull tile and of `rays_per_call` (the JAX
    assertions; the port's bounce loop itself needs no per-call slabs).
    split_far splits every bounce as render_frame_fused does, the split
    sphere replicated and the far pass's re-sort shard-local too.

    Returns (StepOutputs [S, H*W, ...], final [H*W, 3]) in linear pixel
    order on every rank."""
    check_composite_mode(composite_mode)
    full_f32_matmuls()
    prep = _prepare_fused_frame(
        scene, camera, settings, samples, width, height, jitter=jitter,
        cull_cluster=cull_cluster, cull_tile_primary=cull_tile_primary,
        num_steps=num_bounces + 1, generator=generator,
        composite_mode=composite_mode, split_far=split_far,
        split_radius_scale=split_radius_scale)
    R = prep["R"]
    n_shards = mesh.shape[axis]
    tile_max = max(cull_tile_primary, cull_tile_secondary)
    R_s = R // n_shards
    if R % n_shards or R_s % tile_max:
        raise ValueError(f"H*W={R} must split into {n_shards} shards of "
                         f"whole {tile_max}-ray culling tiles")
    rays_per_call = min(rays_per_call, R_s)
    if R_s % rays_per_call:
        raise ValueError(f"a shard of {R_s} rays is not a whole number of "
                         f"rays_per_call={rays_per_call}")
    _, rays = _shard(mesh, axis, R)
    stacked, final = _fused_bounce_core(
        prep["rays_o"][rays], prep["dirs"][rays], prep["us"][:, rays],
        prep["gpack"], prep["bounds"], prep["scene_lo"], prep["scene_hi"],
        settings, camera.znear, camera.zfar, capacity=scene.capacity,
        num_bounces=num_bounces, max_hits=max_hits,
        exp_power_static=exp_power_static, cull_cluster=cull_cluster,
        max_clusters=max_clusters,
        max_clusters_secondary=max_clusters_secondary,
        cull_tile_secondary=cull_tile_secondary,
        cull_tile_primary=cull_tile_primary, scan=prep["scan"],
        split=prep["split"], mc_far=mc_far, max_hits_far=max_hits_far)
    ray_inv = prep["ray_inv"]
    stacked = StepOutputs(*(all_gather(a, mesh, axis, dim=1)[:, ray_inv]
                            for a in stacked))
    return stacked, all_gather(final, mesh, axis)[ray_inv]
