"""Gaussian-axis sharding: scenes too large to replicate (twin of the JAX
parallel/gaussian_sharded.py).

The scene's rows split over the mesh axis "gauss": each rank holds only its
[N/S] rows of the parameters, the Adam moments and the gradients.  Every
rank traces its rays against its own rows, and the cross-shard merge is
exact:

  * top-K: the global K nearest hits lie in the union of the shards' K
    nearest, so an all-gather of the [R, K] hit payloads followed by a
    stable sort on t over [R, S*K] gives the single-process list;
  * transmittance: log full_T is a sum over the shards (the product of
    their transmittances), all-reduced in float64 and rounded once.

With a "rays" axis beside it this is the 2D mesh: rays shard along "rays",
the payload gather rides "gauss", and the gradients are all-reduced over
"rays".  Compositing and shading then run on the merged lists as in the
single-process step, and each rank scatters only the hits of Gaussians it
owns (ids are contiguous per shard).

The shard trace is trace_rays (the XLA tracer's twin), as in JAX; with
use_pallas, gaussian_sharded_trace runs each shard through the slots kernel
(Morton sort, cluster culling, ops/cuda/trace_slots.py, in the exit mode
exit_mode_for picks for the shard's capacity).  Randomness: the step draws
per ray shard (the JAX fold_in(key_b, ray_idx)), so it takes the
TileSamples of tile = R / the ray shards.  No split-far: its steps take no
such option, as the JAX Gaussian-sharded step has none.
"""

from __future__ import annotations

import torch

from ..ops.composite import composite
from ..ops.culling import cluster_bounds, morton_order, select_candidates
from ..ops.cuda.layout import (
    pack_attr_table,
    pack_frame_table,
    pack_frames,
    unpack_slots,
)
from ..ops.cuda.scatter import scatter_add
from ..ops.cuda.trace_slots import exit_mode_for, trace_slots
from ..ops.camera_rays import primary_ray_directions
from ..ops.precision import WIDE, div, rounded
from ..ops.render_grads import (
    backward_step,
    grads_from_accumulator,
    new_grad_accumulator,
    pack_scatter_payload,
)
from ..ops.trace import RayHits, gather_frames, trace_rays_log
from ..renderer.raytracer import (
    CameraParams,
    RayTargets,
    RenderSettings,
    StepOutputs,
    TileSamples,
    _mask_hits,
    draw_tile_samples,
    loss_gradients_per_step,
    next_wavefront,
)
from ..scene.gaussian_scene import (
    GaussianScene,
    build_frames,
    pad_to,
    round_up,
)
from ..training import TrainState, apply_updates
from .mesh import Mesh, all_gather, all_reduce

# the JAX chunk the padding keeps each shard a multiple of
SHARD_CHUNK = 2048


def shard_scene(scene: GaussianScene, n_shards: int) -> GaussianScene:
    """Pad the capacity to a multiple of n_shards * SHARD_CHUNK, so every
    shard stays chunk-aligned."""
    return pad_to(scene, round_up(scene.capacity, n_shards * SHARD_CHUNK))


def local_rows(tree, mesh: Mesh, axis: str = "gauss"):
    """This rank's contiguous rows of a shard_scene-padded GaussianScene
    or TrainState (count kept), as copies: a rank holds only these."""
    def rows(a):
        if a.shape[0] % mesh.shape[axis]:
            raise ValueError(f"{a.shape[0]} rows do not split over the "
                             f"{mesh.shape[axis]} ranks of {axis!r} "
                             "(shard_scene pads them)")
        per = a.shape[0] // mesh.shape[axis]
        i = mesh.index[axis]
        return a[i * per:(i + 1) * per].clone()

    if isinstance(tree, TrainState):
        return TrainState(scene=local_rows(tree.scene, mesh, axis),
                          mu=local_rows(tree.mu, mesh, axis),
                          nu=local_rows(tree.nu, mesh, axis),
                          count=tree.count,
                          total_weight=rows(tree.total_weight))
    return type(tree)(*(rows(a) for a in tree))


def gather_rows(tree, mesh: Mesh, axis: str = "gauss"):
    """The inverse of local_rows: the shards' rows gathered in axis order,
    the same on every rank of the axis (for tests and checks)."""
    if isinstance(tree, TrainState):
        return TrainState(scene=gather_rows(tree.scene, mesh, axis),
                          mu=gather_rows(tree.mu, mesh, axis),
                          nu=gather_rows(tree.nu, mesh, axis),
                          count=tree.count,
                          total_weight=all_gather(tree.total_weight, mesh,
                                                  axis))
    return type(tree)(*(all_gather(a, mesh, axis) for a in tree))


def _merge(payload: dict, log_T, traversed, mesh: Mesh, axis: str, K: int):
    """The exact cross-shard merge of per-shard [R, K, ...] payloads
    (t: inf where empty; ids global, any value where empty): the global K
    nearest by a stable sort on t over the shards' lists in axis order,
    log T and the traversal counts summed.  Returns (merged payload, valid
    [R, K], full_T [R], traversed [R])."""
    S = mesh.shape[axis]
    R = payload["t"].shape[0]
    gath = {k: all_gather(v, mesh, axis, dim=1) if S > 1 else v
            for k, v in payload.items()}                    # [R, S*K, ...]
    order = torch.sort(gath["t"], dim=1, stable=True).indices[:, :K]

    def take(a):
        idx = order.reshape(order.shape + (1,) * (a.ndim - 2))
        return a.gather(1, idx.expand((R, K) + a.shape[2:]))

    m = {k: take(v) for k, v in gath.items()}
    if S > 1:
        log_T = all_reduce(log_T, mesh, axis)
        traversed = all_reduce(traversed, mesh, axis)
    return m, torch.isfinite(m["t"]), rounded(torch.exp, log_T), traversed


def _merged_hits(m: dict, valid, full_T, traversed) -> RayHits:
    zero = torch.zeros_like(m["alpha"])
    return RayHits(
        ids=torch.where(valid, m["ids"], torch.zeros_like(m["ids"])),
        t=torch.where(valid, m["t"], zero),
        alpha=torch.where(valid, m["alpha"], zero),
        gaussval=m["gaussval"], local_hit=m["local_hit"], valid=valid,
        full_T=full_T, num_traversed=traversed)


def shard_slots_call(scene_s: GaussianScene, o, d, exp_power: float,
                     near: float, far: float, alpha_threshold: float,
                     max_hits: int, cull_cluster: int, cull_tile: int,
                     max_clusters: int):
    """One shard's slots-kernel call, as gaussian_sharded_trace launches
    it: Morton sort, cluster bounds, candidates per ray tile, no early
    exit.  Returns (args, kwargs, perm): trace_slots(*args, **kwargs)
    traces the shard, and perm maps the sorted rows back to the shard's."""
    frames, attrs = build_frames(scene_s, alpha_threshold, exp_power)
    perm = morton_order(frames)
    frames_p, attrs_p = frames.take(perm), attrs.take(perm)
    scene_p = GaussianScene(*(a[perm] for a in scene_s))
    bounds = cluster_bounds(frames_p, cull_cluster)
    gpack = pack_frames(frames_p, attrs_p).contiguous()
    table = pack_attr_table(attrs_p).contiguous()
    ftable = pack_frame_table(frames_p, scene_p).contiguous()
    cands, cnear, _num, _ovf, _tdrop = select_candidates(
        o, d, bounds, near, far, tile=cull_tile, max_clusters=max_clusters)
    exit_mode, check_every = exit_mode_for(scene_s.capacity)
    args = (o.contiguous(), d.contiguous(), gpack, table, ftable, cands,
            cnear, near, far, exp_power, 0.0, 0.1, 0.9)
    kwargs = dict(transmittance_threshold=1e-30, max_hits=max_hits,
                  cluster=cull_cluster, tile=cull_tile, secondary_static=0,
                  exit_mode=exit_mode, check_every=check_every)
    return args, kwargs, perm


def _shard_hits_fused(scene_s: GaussianScene, o, d, *call_args):
    """One shard's trace through the slots kernel (shard_slots_call), the
    slots unpacked and the ids mapped back through the sort.  Returns
    (RayHits with shard-local ids, log T [R] in WIDE)."""
    args, kwargs, perm = shard_slots_call(scene_s, o, d, *call_args)
    slots, acc = trace_slots(*args, **kwargs)
    hits_d, _attrs, _frames = unpack_slots(slots, acc, kwargs["max_hits"],
                                           o, d)
    hits = RayHits(**hits_d)
    hits = hits._replace(ids=perm[hits.ids.to(torch.int64)].to(torch.int32))
    return hits, acc[:, 0].to(WIDE)


def gaussian_sharded_trace(
    mesh: Mesh,
    scene_s: GaussianScene,
    rays_o,
    rays_d,
    exp_power: float,
    near: float,
    far: float,
    alpha_threshold: float = 0.005,
    max_hits: int = 32,
    chunk: int = 2048,
    axis: str = "gauss",
    use_pallas: bool = False,
    cull_cluster: int = 256,
    cull_tile: int = 256,
    max_clusters: int = 64,
) -> RayHits:
    """Trace the replicated rays [R, 3] against the scene whose rows are
    sharded over `axis` (`scene_s`: this rank's rows, local_rows); returns
    the same RayHits on every rank, equal to the single-process trace_rays
    of the whole scene.

    use_pallas=True traces each shard through the slots kernel
    (shard_slots_call) for any shard capacity: exit_mode_for picks the
    kernel variant (the JAX package falls back to the XLA trace where a
    shard outgrows the TPU's VMEM; the H100 kernel has no such limit).
    Requires R % cull_tile == 0 and the shard a multiple of cull_cluster."""
    S = mesh.shape[axis]
    n_local = scene_s.capacity
    R = rays_o.shape[0]
    assert n_local % chunk == 0, (n_local * S, S, chunk)
    if use_pallas:
        assert R % cull_tile == 0 and n_local % cull_cluster == 0, (
            R, cull_tile, n_local, cull_cluster)
        hits, log_T = _shard_hits_fused(
            scene_s, rays_o, rays_d, exp_power, near, far, alpha_threshold,
            max_hits, cull_cluster, cull_tile, max_clusters)
    else:
        frames, _ = build_frames(scene_s, alpha_threshold, exp_power)
        hits, log_T = trace_rays_log(rays_o, rays_d, frames, exp_power, near,
                                     far, max_hits=max_hits, chunk=chunk)
    offset = mesh.index[axis] * n_local
    inf = torch.full_like(hits.t, float("inf"))
    payload = dict(
        t=torch.where(hits.valid, hits.t, inf),
        ids=torch.where(hits.valid, hits.ids + offset,
                        torch.zeros_like(hits.ids)),
        alpha=torch.where(hits.valid, hits.alpha, torch.zeros_like(hits.t)),
        gaussval=hits.gaussval, local_hit=hits.local_hit)
    m, valid, full_T, trav = _merge(payload, log_T, hits.num_traversed, mesh,
                                    axis, max_hits)
    return _merged_hits(m, valid, full_T, trav)


def _payload(hits: RayHits, frames_s, attrs_s, scene_s: GaussianScene,
             scaling_act) -> dict:
    """Per-hit payload [R, K, ...] of a shard's hits (local ids): every
    field compositing and the backward read, so no attribute gather ever
    crosses shards."""
    ids = hits.ids.to(torch.int64)
    fg = gather_frames(frames_s, ids)
    ga = attrs_s.take(ids)
    return dict(
        alpha=hits.alpha, gaussval=hits.gaussval, local_hit=hits.local_hit,
        rgb=ga.rgb, normal=ga.normal, f0=ga.f0, roughness=ga.roughness,
        opacity=fg.opacity, scaling_act=scaling_act[ids],
        rotation_raw=scene_s.rotation[ids], rot=fg.rot,
        inv_sizes=fg.inv_sizes, sf=fg.sf)


def gaussian_sharded_train_step(
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
    jitter: bool = True,
    gauss_axis: str = "gauss",
    ray_axis: str | None = None,
    samples: TileSamples | None = None,
):
    """One training step with the Gaussians sharded over `gauss_axis`
    (`state`: this rank's rows, local_rows) and the rays over `ray_axis`
    when the mesh has one; targets [H*W, ...] replicated.

    Equal to training.train_step(use_pallas=False) with tile = R / the ray
    shards on the same samples, up to the order of the collective sums: the
    gradients are the stable contract (Adam is scale-invariant, so
    summation-order noise on ~zero gradients flips update signs).  Each
    rank holds only its [N/S] rows of the parameters, the moments and the
    gradients, and per bounce all-gathers [R_local, K, ~40] hit payloads.
    Returns (new state rows, metrics, gradient rows), the metrics
    (l1_diffuse) the same on every rank."""
    S = mesh.shape[gauss_axis]
    n_ray = mesh.shape[ray_axis] if ray_axis else 1
    ray_idx = mesh.index[ray_axis] if ray_axis else 0
    scene_s = state.scene
    n_local = scene_s.capacity
    assert n_local % chunk == 0, (n_local * S, S, chunk)
    R = width * height
    if R % n_ray:
        raise ValueError(f"H*W={R} must divide by {n_ray} ray shards")
    Rl = R // n_ray
    K = max_hits
    num_steps = num_bounces + 1
    dev = scene_s.xyz.device
    if samples is None:
        if generator is None:
            raise ValueError("a step needs samples or a generator")
        samples = draw_tile_samples(generator, width, height, Rl, num_steps,
                                    jitter)
    rays = slice(ray_idx * Rl, (ray_idx + 1) * Rl)
    dirs = primary_ray_directions(
        width, height, camera.fov_y, camera.c2w,
        jitter=samples.jitter if jitter else None).reshape(-1, 3)
    rays_d = dirs[rays]
    targets_s = RayTargets(*(a[rays] for a in targets))
    us = samples.us[ray_idx]                                 # [S, Rl, 2]

    frames_s, attrs_s = build_frames(scene_s, settings.alpha_threshold,
                                     settings.exp_power,
                                     settings.global_scale_factor)
    scaling_act = rounded(torch.exp, scene_s.scaling)
    offset = mesh.index[gauss_axis] * n_local
    rays_o = camera.origin.expand(Rl, 3)
    alive = torch.ones((Rl,), dtype=torch.bool, device=dev)
    throughput = torch.ones((Rl, 3), dtype=torch.float32, device=dev)
    bf = dict(backfacing_max_dist=settings.backfacing_max_dist,
              backfacing_invalid_normal_threshold=(
                  settings.backfacing_invalid_normal_threshold))
    thr = settings.transmittance_threshold
    outs, residuals = [], []
    for step in range(num_steps):
        near = camera.znear if step == 0 else 0.0
        hits_l, log_T = trace_rays_log(
            rays_o, rays_d, frames_s, settings.exp_power, near, camera.zfar,
            max_hits=K, chunk=chunk, secondary=step > 0, **bf)
        payload = _payload(hits_l, frames_s, attrs_s, scene_s, scaling_act)
        payload["t"] = torch.where(hits_l.valid, hits_l.t,
                                   torch.full_like(hits_l.t, float("inf")))
        payload["ids"] = torch.where(hits_l.valid, hits_l.ids + offset,
                                     torch.full_like(hits_l.ids, -1))
        m, valid, full_T, trav = _merge(payload, log_T, hits_l.num_traversed,
                                        mesh, gauss_axis, K)
        mhits = _mask_hits(_merged_hits(m, valid, full_T, trav), alive)
        comp = composite(mhits, m["rgb"], m["normal"], m["f0"],
                         m["roughness"], thr,
                         settings.eps_forward_normalization)
        residuals.append((mhits, comp, m))
        rgb_step = comp.rgb if step == 0 else comp.rgb * throughput
        next_origin, next_dir, next_throughput, next_alive = next_wavefront(
            comp.normal, comp.roughness, comp.depth, comp.f0, rays_o, rays_d,
            throughput, alive, us[step], settings)
        outs.append(dict(
            rgb=rgb_step, normal=comp.normal, f0=comp.f0,
            roughness=comp.roughness, depth=comp.depth,
            transmittance=comp.T_final, total_transmittance=comp.full_T,
            throughput=next_throughput, alive=alive.to(torch.float32),
            overflow=torch.zeros((Rl,), dtype=torch.float32, device=dev)))
        rays_o, rays_d = next_origin, next_dir
        throughput, alive = next_throughput, next_alive

    steps = StepOutputs(**{k: torch.stack([o[k] for o in outs], dim=0)
                           for k in outs[0]})
    dLs = loss_gradients_per_step(steps, targets_s, settings, num_bounces)
    acc = new_grad_accumulator(n_local, dev)
    for step in range(num_steps):
        mhits, comp, m = residuals[step]
        residuals[step] = None
        per_hit = backward_step(
            mhits, comp, m["rgb"], m["normal"], m["f0"], m["roughness"],
            m["opacity"], m["scaling_act"], m["rotation_raw"], m["rot"],
            m["inv_sizes"], m["sf"], *dLs[step], settings.exp_power,
            settings.eps_scale_grad, n_local, settings.global_scale_factor)
        # ownership filter: scatter only the hits of this shard's Gaussians
        own = mhits.valid & (mhits.ids >= offset) & (mhits.ids
                                                     < offset + n_local)
        ids = torch.where(own, mhits.ids - offset,
                          torch.full_like(mhits.ids, -1))
        scatter_add(acc, pack_scatter_payload(per_hit),
                    ids.reshape(-1).to(torch.int32))
    err = (steps.rgb[0] - targets_s.diffuse).abs()
    l1 = div(err[:, 0] + err[:, 1] + err[:, 2], 3.0).to(WIDE).sum()
    if ray_axis:
        acc = all_reduce(acc, mesh, ray_axis)
        l1 = all_gather(l1.reshape(1), mesh, ray_axis).sum()
    grads = grads_from_accumulator(acc)
    new_state = apply_updates(state, grads, lrs, hyper)
    return new_state, dict(l1_diffuse=(l1 / R).to(torch.float32)), grads
