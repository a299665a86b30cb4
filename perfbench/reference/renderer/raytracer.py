"""The fused frame and the fused training step's forward and backward, in
plain PyTorch: a frozen copy of the port's renderer/raytracer.py (those
functions only), whose kernels are the plain versions of ops/plain/.

The benchmark's reference: it imports nothing of the program, and the
program may change without moving it."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import ranks_per_card
from ..ops import ggx
from ..ops.camera_rays import primary_ray_directions
from ..ops.composite import composite
from ..ops.culling import (
    ClusterBounds,
    cluster_bounds,
    live_bounds,
    morton_codes,
    morton_order,
    select_candidates,
    sort_within_clusters,
    tile_pixel_order,
)
from ..ops.plain.layout import (
    merge_slots,
    pack_frames,
    pack_scan_table,
    unpack_composite,
    unpack_slots,
)
from ..ops.plain.render_kernel import check_every_for, render_culled
from ..ops.plain.scan_kernel import ATTR_PRECISIONS, render_scan, scan_fits
from ..ops.plain.scatter import scatter_add
from ..ops.plain.trace_slots import (
    exit_mode_for,
    slots_resident_fits,
    trace_slots,
)
from ..ops.gaussian_kernel import ROUGHNESS_DOWNWEIGHT_GRAD_POWER
from ..ops.intersect import GaussianFrames
from ..ops.precision import WIDE, dot, norm, rounded
from ..ops.render_grads import (
    SCATTER_COLS,
    backward_step,
    grads_from_accumulator,
    new_grad_accumulator,
    pack_scatter_payload,
    sign,
)
from ..ops.trace import RayHits
from ..scene.gaussian_scene import GaussianScene, build_frames

COMPOSITE_MODES = ("kbuffer", "scan", "scanq")
SCAN_MODES = ("scan", "scanq")


class RenderSettings(NamedTuple):
    """Runtime knobs (cuda/csrc/core/config.h:31-51 defaults)."""

    exp_power: float = 3.0
    alpha_threshold: float = 0.005
    transmittance_threshold: float = 0.01
    global_scale_factor: float = 1.0
    loss_weight_diffuse: float = 1.0
    loss_weight_specular: float = 1.0
    loss_weight_depth: float = 1.0
    loss_weight_normal: float = 1.0
    loss_weight_f0: float = 1.0
    loss_weight_roughness: float = 1.0
    eps_forward_normalization: float = 1e-12
    eps_scale_grad: float = 1e-12
    eps_ray_surface_offset: float = 0.01
    eps_min_roughness: float = 0.01
    reflection_invalid_normal_threshold: float = 0.7
    backfacing_invalid_normal_threshold: float = 0.9
    backfacing_max_dist: float = 0.1
    # secondary rays whose max-channel throughput falls to or below this
    # die; -1 (default) disables the cutoff, as the reference has none
    secondary_throughput_threshold: float = -1.0


class CameraParams(NamedTuple):
    """Pose + intrinsics (cuda/csrc/core/camera.h:8-36)."""

    origin: torch.Tensor     # [3]
    c2w: torch.Tensor        # [3, 3]
    fov_y: float             # radians
    znear: float
    zfar: float


class StepOutputs(NamedTuple):
    """Per-bounce-step framebuffer slices, [S, R, ...] stacked over steps."""

    rgb: torch.Tensor        # [S, R, 3] (throughput-premultiplied)
    normal: torch.Tensor     # [S, R, 3]
    f0: torch.Tensor         # [S, R, 3]
    roughness: torch.Tensor  # [S, R]
    depth: torch.Tensor      # [S, R]
    transmittance: torch.Tensor        # [S, R] T_final per step
    total_transmittance: torch.Tensor  # [S, R] full_T per step
    throughput: torch.Tensor  # [S, R, 3]
    alive: torch.Tensor      # [S, R] ray was active at this step
    overflow: torch.Tensor   # [S, R] starved-ray flag (see _starved)


class FrameSamples(NamedTuple):
    """The random numbers one frame consumes, in linear pixel order."""

    jitter: torch.Tensor | None  # [H, W, 2] sub-pixel offsets in [-0.5, 0.5)
    us: torch.Tensor             # [S, H*W, 2] GGX uniforms in [0, 1)


class RayTargets(NamedTuple):
    """Per-ray supervision targets (framebuffer.h:145-152)."""

    diffuse: torch.Tensor    # [R, 3]
    specular: torch.Tensor   # [R, 3]
    depth: torch.Tensor      # [R]
    normal: torch.Tensor     # [R, 3]
    roughness: torch.Tensor  # [R]
    f0: torch.Tensor         # [R, 3]


def full_f32_matmuls() -> None:
    """Keep float32 products in full float32 on the card (TF32 off for both
    matmuls and cuDNN convolutions).  The render entry points call this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _starved(t_drop_ray, t_limit, full_T, alive, transmittance_threshold):
    """Refine the per-tile overflow to the rays it can actually bias: the
    ray was still accumulating (full_T above the threshold) when its list
    ran out, its depth window reaches past the first dropped cluster, and
    it is alive."""
    reaches = t_limit > t_drop_ray
    return (reaches & (full_T > transmittance_threshold) & alive).to(
        torch.float32)


def check_composite_mode(composite_mode: str) -> None:
    """Raise for a composite mode the renderer does not have (a typo would
    otherwise render with the k-buffer kernel)."""
    if composite_mode not in COMPOSITE_MODES:
        raise ValueError(
            f"composite_mode={composite_mode!r}: expected one of "
            "'kbuffer' | 'scan' | 'scanq'")


class SplitSphere(NamedTuple):
    """Split-far's sphere: a near pass keeps the hits before a ray's exit
    from it, the far pass those beyond.  The partition is exact for any
    sphere; the sphere decides only how the passes cull."""

    center: torch.Tensor     # [3] f32
    radius: torch.Tensor     # 0-d f32


def _split_sphere(points, valid, scale: float) -> SplitSphere:
    """Centre the mean of the valid points (summed in WIDE, rounded once),
    radius `scale` x the median of their distances to it (the element
    n_valid // 2 of the sorted distances, as JAX indexes it)."""
    w = valid[:, None].to(WIDE)
    cnt = torch.clamp(w.sum(), min=1.0)
    center = ((points.to(WIDE) * w).sum(dim=0) / cnt).to(torch.float32)
    dist = norm(points - center[None])
    key = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    r_med = torch.sort(key).values[torch.clamp(valid.sum() // 2, min=0)]
    return SplitSphere(center, r_med * torch.tensor(
        scale, dtype=torch.float32, device=r_med.device))


def split_sphere_from_bounds(bounds: ClusterBounds,
                             scale: float = 1.5) -> SplitSphere:
    """The training step's sphere, from the valid clusters' centres (JAX
    raytracer.py:432-448)."""
    return _split_sphere(bounds.center, bounds.any_valid, scale)


def split_sphere_from_frames(frames: GaussianFrames,
                             scale: float = 1.5) -> SplitSphere:
    """The frame's sphere, from the live means: the dense scene inside, the
    far-field shell's bulk outside (JAX raytracer.py:882-896)."""
    return _split_sphere(frames.mean, frames.valid, scale)


def split_exit_t(rays_o, rays_d, sphere: SplitSphere) -> torch.Tensor:
    """[R] each ray's exit distance from the split sphere (in the ray's own
    t, as the kernels intersect), 0 for a ray that misses it: everything on
    such a ray lies in the far pass."""
    oc = rays_o - sphere.center[None]
    a2 = dot(rays_d, rays_d)
    b = dot(rays_d, oc)
    cc = dot(oc, oc) - sphere.radius * sphere.radius
    disc = b * b - a2 * cc
    root = rounded(torch.sqrt, torch.clamp(disc, min=0.0))
    t = torch.where(disc > 0, (-b + root) / torch.clamp(a2, min=1e-30),
                    torch.zeros_like(disc))
    return torch.clamp(t, min=0.0)


def _prepare_fused_frame(scene: GaussianScene, camera: CameraParams,
                         settings: RenderSettings,
                         samples: FrameSamples | None, width: int,
                         height: int, *, jitter: bool, cull_cluster: int,
                         cull_tile_primary: int, num_steps: int,
                         generator: torch.Generator | None = None,
                         composite_mode: str = "kbuffer",
                         split_far: bool = False,
                         split_radius_scale: float = 1.5):
    """Morton sort + cluster bounds + gpack, pixel-tile ray ordering and the
    per-step GGX uniforms in tile order.  The frame's randomness is
    `samples`, or drawn from `generator` when that is None.  Scan modes
    also depth-sort each cluster along the camera's forward axis and build
    the frame's scan table once (None where scan_fits says the JAX renderer
    would composite with the k-buffer kernel).  With split_far, the split
    sphere from the live means (else None).  Returns a dict of everything
    _fused_bounce_core consumes plus (ray_perm, ray_inv, R)."""
    if samples is None:
        if generator is None:
            raise ValueError("a frame needs samples or a generator")
        samples = draw_samples(generator, width, height, num_steps, jitter)
    dev = scene.xyz.device
    frames, attrs = build_frames(scene, settings.alpha_threshold,
                                 settings.exp_power,
                                 settings.global_scale_factor)
    perm = morton_order(frames)
    frames = frames.take(perm)
    attrs = attrs.take(perm)
    if composite_mode in SCAN_MODES:
        # the scan composite follows table order within a chunk: sort each
        # cluster by depth along the view axis (membership, and so the
        # bounds and the candidate lists, unchanged)
        perm2 = sort_within_clusters(frames, -camera.c2w[:, 2], cull_cluster)
        frames = frames.take(perm2)
        attrs = attrs.take(perm2)
    bounds = cluster_bounds(frames, cull_cluster)
    gpack = pack_frames(frames, attrs).contiguous()
    scan = None
    if composite_mode in SCAN_MODES and scan_fits(gpack.shape[1],
                                                  cull_cluster):
        scan = pack_scan_table(
            gpack, "quadric" if composite_mode == "scanq" else "direct")

    # square pixel tiles sized to the primary cull tile (256 -> 16x16)
    tpx = math.isqrt(cull_tile_primary)
    if tpx * tpx != cull_tile_primary:
        raise ValueError(f"cull_tile_primary={cull_tile_primary} is not a "
                         "square")
    perm_np, inv_np = tile_pixel_order(height, width, tpx, tpx)
    ray_perm = torch.as_tensor(perm_np, dtype=torch.int64, device=dev)
    ray_inv = torch.as_tensor(inv_np, dtype=torch.int64, device=dev)
    dirs = primary_ray_directions(
        width, height, camera.fov_y, camera.c2w,
        jitter=samples.jitter if jitter else None,
    ).reshape(-1, 3)[ray_perm]
    R = dirs.shape[0]
    scene_lo, scene_hi = live_bounds(frames.mean, frames.valid)
    us = samples.us[:, ray_perm]
    rays_o = camera.origin.expand(R, 3)
    split = (split_sphere_from_frames(frames, split_radius_scale)
             if split_far else None)
    return dict(gpack=gpack, scan=scan, bounds=bounds, scene_lo=scene_lo,
                scene_hi=scene_hi, split=split, rays_o=rays_o, dirs=dirs,
                us=us, ray_perm=ray_perm, ray_inv=ray_inv, R=R)


def _sorted_by(keys, alive, group_rays: int | None):
    """(order, inverse) of a stable sort by (group, liveness, keys < 2^26).
    With `group_rays`, rays stay inside their consecutive groups of that
    many (the training step's ray tiles, which the JAX package traces one
    at a time)."""
    keys = torch.where(alive, 0, 1 << 26) | keys
    R = keys.shape[0]
    index = torch.arange(R, device=keys.device)
    if group_rays is not None:
        keys = keys | ((index // group_rays) << 27)
    order = torch.sort(keys, stable=True).indices
    inv_order = torch.empty_like(order)
    inv_order[order] = index
    return order, inv_order


def secondary_order(rays_o, rays_d, alive, scene_lo, scene_hi,
                    group_rays: int | None = None):
    """(order, inverse) re-tiling a reflected wavefront: a stable sort by
    (group, liveness, origin Morton cell, direction bin), so tile cones stay
    tight and dead tiles skip."""
    pos_bits = morton_codes(rays_o, scene_lo, scene_hi, bits=5)
    qd = torch.clamp((rays_d * 0.5 + 0.5) * 4.0, 0, 3).to(torch.int64)
    dir_bits = (qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]
    return _sorted_by((pos_bits << 6) | dir_bits, alive, group_rays)


def far_order(rays_o, rays_d, alive, scene_lo, scene_hi,
              group_rays: int | None = None):
    """(order, inverse) of split-far's far pass over a reflected wavefront:
    by (group, liveness, direction Morton cell, coarse origin cell).  The
    far-field shell lies at a near-constant distance, so a tile of rays of
    one direction sees few of its clusters (JAX raytracer.py:554-570)."""
    one = torch.ones(3, dtype=rays_d.dtype, device=rays_d.device)
    dirm = morton_codes(rays_d, -one, one, bits=5)
    posm = morton_codes(rays_o, scene_lo, scene_hi, bits=2)
    return _sorted_by((dirm << 6) | posm, alive, group_rays)


class KernelCall(NamedTuple):
    """One bounce's render kernel and its arguments, rays in wavefront
    order: kernel(*args, **kwargs)."""

    kernel: object                  # render_culled / render_scan /
                                    # trace_slots
    args: tuple
    kwargs: dict
    inv_order: torch.Tensor | None  # output row of each canonical ray
    tdrop_ray: torch.Tensor         # first dropped cluster's near distance,


class SplitCalls(NamedTuple):
    """One split bounce of the training forward: its near (window 1) and
    far (window 2) slots calls and each pass's starved flags [R],
    canonical order."""

    near: KernelCall
    far: KernelCall
    starved_near: torch.Tensor
    starved_far: torch.Tensor


def center_depth_order(rays_o, rays_d, cands, cnear, centers, tile: int):
    """Each tile's candidate list re-sorted by cluster-centre depth along
    the tile's mean direction, empty entries last (raytracer.py:1038-1059):
    the order in which the scan composite takes the chunks.  The tile means
    are taken in WIDE and rounded once, the depth dot is spelled out and the
    sort is stable, so the order is the same on every device."""
    T = cands.shape[0]
    tpo = rays_o.to(WIDE).reshape(T, tile, 3).mean(dim=1).to(torch.float32)
    tpd = rays_d.to(WIDE).reshape(T, tile, 3).mean(dim=1).to(torch.float32)
    tpd = tpd / torch.clamp(norm(tpd, keepdim=True), min=1e-12)
    listed = cands >= 0
    cid = torch.where(listed, cands, 0).to(torch.int64)
    cdep = dot(centers[cid] - tpo[:, None, :], tpd[:, None, :])
    key = torch.where(listed, cdep, torch.full_like(cdep, float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices
    return cands.gather(1, order), cnear.gather(1, order)


def kernel_call(rays_o, rays_d, alive, step: int, gpack, bounds, scene_lo,
                scene_hi, settings: RenderSettings, znear: float,
                zfar: float, *, capacity: int, max_hits: int,
                exp_power_static: float, cull_cluster: int,
                max_clusters: int, max_clusters_secondary: int | None,
                cull_tile_secondary: int, cull_tile_primary: int,
                scan=None, kernel_stats: bool = True,
                attr_precision: str = "highest", t_split=None,
                window_mode: int = 0, opts=None) -> KernelCall:
    """Order the wavefront of bounce `step`, cull per tile, and assemble
    the render kernel's call: render_scan over the frame's scan table
    `scan` when there is one (scan modes within scan_fits), else
    render_culled.  window_mode 1 / 2 is split-far's near / far pass over
    the rays' split distances `t_split` [R] (canonical order): each tile
    culls up to its rays' largest split distance / from their smallest,
    and a far pass re-sorts reflected rays by direction (far_order)."""
    near = znear if step == 0 else 0.0
    inv_order = None
    if step > 0:
        sort = far_order if window_mode == 2 else secondary_order
        order, inv_order = sort(rays_o, rays_d, alive, scene_lo, scene_hi)
        rays_o, rays_d, alive = rays_o[order], rays_d[order], alive[order]
        if t_split is not None:
            t_split = t_split[order]
    mc = (max_clusters if step == 0 or max_clusters_secondary is None
          else max_clusters_secondary)
    tile = cull_tile_primary if step == 0 else cull_tile_secondary
    cull_near, cull_far = window_bounds(near, zfar, t_split, window_mode,
                                        tile)
    cands, cnear, _num, _ovf, tdrop = select_candidates(
        rays_o, rays_d, bounds, cull_near, cull_far, tile=tile,
        max_clusters=mc)
    tdrop_ray = tdrop.repeat_interleave(tile)
    if inv_order is not None:
        tdrop_ray = tdrop_ray[inv_order]
    kwargs = dict(
        transmittance_threshold=settings.transmittance_threshold,
        eps_forward_normalization=settings.eps_forward_normalization,
        max_hits=max_hits, cluster=cull_cluster, tile=tile, alive=alive,
        # the backfacing test only applies to reflected rays
        secondary_static=1 if step > 0 else 0, opts=opts)
    if window_mode:
        kwargs.update(t_split=t_split.contiguous(), window_mode=window_mode)
    if scan is not None:
        # the k-buffer's exit needs near-sorted lists; the scan takes them
        # in centre-depth order, so they are re-sorted for it alone
        cands, cnear = center_depth_order(rays_o, rays_d, cands, cnear,
                                          bounds.center, tile)
        kernel, table = render_scan, scan
        kwargs.update(stats=kernel_stats, attr_precision=(
            attr_precision if scan.pair_math == "quadric" else "highest"))
    else:
        kernel, table = render_culled, gpack
        kwargs.update(check_every=check_every_for(capacity))
    args = (rays_o.contiguous(), rays_d.contiguous(), table, cands, cnear,
            near, zfar, exp_power_static, 1.0 if step > 0 else 0.0,
            settings.backfacing_max_dist,
            settings.backfacing_invalid_normal_threshold)
    return KernelCall(kernel, args, kwargs, inv_order, tdrop_ray)


def window_bounds(near, far, t_split, window_mode: int, tile: int):
    """The depth window each cull tile's list covers: (near, far), or with
    split-far's window per tile (near, the tile's largest t_split) for a
    near pass and (its smallest t_split, far) for a far pass (JAX
    raytracer.py:546,571)."""
    if window_mode == 1:
        return near, t_split.reshape(-1, tile).amax(dim=1)
    if window_mode == 2:
        return t_split.reshape(-1, tile).amin(dim=1), far
    return near, far


def next_wavefront(normal, roughness, depth, f0, rays_o, rays_d, throughput,
                   alive, u, settings: RenderSettings):
    """Normal post-processing, path termination, GGX reflection sample and
    cumulative throughput (shaders.cu:116-146): the next bounce's (origin,
    direction, throughput, alive).  Dead rays get zero throughput, so a NaN
    weight of a degenerate normal never reaches a later bounce."""
    nlen = norm(normal)
    eff_normal = normal / torch.clamp(nlen, min=1e-20)[:, None]
    eff_roughness = torch.clamp(roughness, min=settings.eps_min_roughness)
    next_alive = alive & (nlen >= settings.reflection_invalid_normal_threshold)
    eff_position = rays_o + depth[:, None] * rays_d
    next_dir = ggx.sample_cook_torrance(eff_normal, -rays_d, eff_roughness, u)
    next_origin = eff_position + settings.eps_ray_surface_offset * next_dir
    w = ggx.cook_torrance_weight(eff_normal, -rays_d, next_dir,
                                 eff_roughness, f0)
    big = torch.finfo(torch.float32).max   # nan_to_num's bounds, as in JAX
    next_throughput = torch.where(
        next_alive[:, None],
        throughput * torch.nan_to_num(w, posinf=big, neginf=-big),
        torch.zeros_like(throughput))
    return next_origin, next_dir, next_throughput, next_alive


def bounce_epilogue(out, call: KernelCall, rays_o, rays_d, throughput, alive,
                    u, step: int, settings: RenderSettings, zfar: float):
    """Per-ray epilogue of one bounce (shaders.cu:116-146): the step's
    framebuffer record and the next wavefront (origin, direction,
    throughput, alive), all in canonical ray order.  float32 under the
    rules of ops/precision.py, so the next wavefront is the same on every
    device (near-mirror bounces amplify ulp differences ~10x per bounce)."""
    comp = unpack_composite(canonical(out, call))
    starved = _starved(call.tdrop_ray, zfar, comp["full_T"], alive,
                       settings.transmittance_threshold)
    return composite_epilogue(comp, starved, rays_o, rays_d, throughput,
                              alive, u, step, settings)


def canonical(out, call: KernelCall):
    """A kernel's output rows in canonical ray order."""
    return out if call.inv_order is None else out[call.inv_order]


def composite_epilogue(comp: dict, starved, rays_o, rays_d, throughput,
                       alive, u, step: int, settings: RenderSettings):
    """bounce_epilogue from a bounce's composite fields (canonical order)
    and its starved flags."""
    rgb = comp["rgb"] if step == 0 else comp["rgb"] * throughput
    next_origin, next_dir, next_throughput, next_alive = next_wavefront(
        comp["normal"], comp["roughness"], comp["depth"], comp["f0"], rays_o,
        rays_d, throughput, alive, u, settings)
    next_alive &= (next_throughput.amax(dim=-1)
                   > settings.secondary_throughput_threshold)
    record = dict(
        rgb=rgb, normal=comp["normal"], f0=comp["f0"],
        roughness=comp["roughness"], depth=comp["depth"],
        transmittance=comp["T_final"], total_transmittance=comp["full_T"],
        throughput=next_throughput, alive=alive.to(torch.float32),
        overflow=starved)
    return record, (next_origin, next_dir, next_throughput, next_alive)


def split_bounce(rays_o, rays_d, alive, step: int, gpack, bounds, scene_lo,
                 scene_hi, settings: RenderSettings, znear: float,
                 zfar: float, split: SplitSphere, *, mc_far: int,
                 max_hits_far: int, **pass_kw):
    """One bounce of a split-far frame (JAX raytracer.py:1125-1185): the
    near pass (window 1), then the far pass (window 2, `mc_far`
    candidates, K `max_hits_far` or the near K) of the rays the near pass
    left unsaturated, combined exactly behind the near pass's full_T (every
    far hit lies behind every near hit; the composite's fields are linear
    in the per-hit weights).  Returns (the composite fields, the starved
    flags: the larger of the two passes', each pass's own composite
    fields and its starved flags under "starved" (near, far)), canonical
    order."""
    thr = settings.transmittance_threshold
    ts = split_exit_t(rays_o, rays_d, split)
    common = (step, gpack, bounds, scene_lo, scene_hi, settings, znear, zfar)
    call_n = kernel_call(rays_o, rays_d, alive, *common, t_split=ts,
                         window_mode=1, **pass_kw)
    comp_n = unpack_composite(canonical(
        call_n.kernel(*call_n.args, **call_n.kwargs), call_n))
    alive_f = alive & (comp_n["full_T"] > thr)
    far_kw = dict(pass_kw, max_clusters=mc_far, max_clusters_secondary=None,
                  max_hits=max_hits_far or pass_kw["max_hits"])
    call_f = kernel_call(rays_o, rays_d, alive_f, *common, t_split=ts,
                         window_mode=2, **far_kw)
    comp_f = unpack_composite(canonical(
        call_f.kernel(*call_f.args, **call_f.kwargs), call_f))
    fTn = comp_n["full_T"]
    comp = {k: comp_n[k] + (fTn[:, None] if comp_n[k].ndim == 2 else fTn)
            * comp_f[k] for k in ("rgb", "normal", "f0", "roughness",
                                  "depth")}
    comp.update(T_final=comp_n["T_final"] * comp_f["T_final"],
                full_T=fTn * comp_f["full_T"])
    comp_n["starved"] = _starved(call_n.tdrop_ray, ts, fTn, alive, thr)
    comp_f["starved"] = _starved(call_f.tdrop_ray, zfar, comp["full_T"],
                                 alive_f, thr)
    starved = torch.maximum(comp_n["starved"], comp_f["starved"])
    return comp, starved, (comp_n, comp_f)


def _fused_bounce_core(rays_o, rays_d, us, gpack, bounds, scene_lo, scene_hi,
                       settings: RenderSettings, znear: float, zfar: float, *,
                       num_bounces: int, split: SplitSphere | None = None,
                       mc_far: int = 32, max_hits_far: int = 0, **pass_kw):
    """The per-bounce wavefront loop over a prepared, tile-ordered ray batch
    (rays_o/rays_d [Rp, 3], us [num_steps, Rp, 2]); `pass_kw` are
    kernel_call's keyword options.  With a split sphere every bounce is
    split_bounce's two passes.  Returns (StepOutputs [S, Rp, ...], final
    [Rp, 3]) in the given order."""
    Rp = rays_o.shape[0]
    dev = rays_o.device
    alive = torch.ones((Rp,), dtype=torch.bool, device=dev)
    throughput = torch.ones((Rp, 3), dtype=torch.float32, device=dev)
    outs = []
    for step in range(num_bounces + 1):
        if split is None:
            call = kernel_call(rays_o, rays_d, alive, step, gpack, bounds,
                               scene_lo, scene_hi, settings, znear, zfar,
                               **pass_kw)
            out = call.kernel(*call.args, **call.kwargs)
            record, nxt = bounce_epilogue(
                out, call, rays_o, rays_d, throughput, alive, us[step], step,
                settings, zfar)
        else:
            comp, starved, _passes = split_bounce(
                rays_o, rays_d, alive, step, gpack, bounds, scene_lo,
                scene_hi, settings, znear, zfar, split, mc_far=mc_far,
                max_hits_far=max_hits_far, **pass_kw)
            record, nxt = composite_epilogue(
                comp, starved, rays_o, rays_d, throughput, alive, us[step],
                step, settings)
        rays_o, rays_d, throughput, alive = nxt
        outs.append(record)

    stacked = StepOutputs(**{k: torch.stack([o[k] for o in outs], dim=0)
                             for k in outs[0]})
    return stacked, stacked.rgb.sum(dim=0)


def padded_ray_count(R: int, max_clusters: int,
                     max_clusters_secondary: int | None,
                     cull_tile_primary: int, cull_tile_secondary: int,
                     rays_per_call: int = 65536,
                     composite_mode: str = "kbuffer",
                     mc_far: int = 0) -> int:
    """Rays after the JAX renderer's padding rule: R rounded up to a
    multiple of its per-call ray count (raytracer.py:1332-1363).  The padded
    rays (copies of the leading rays) join the secondary re-sort, so they
    change tile membership; keeping the rule keeps the result equal to the
    JAX render.  The cap itself came from a TPU scalar-memory budget, 8
    bytes per candidate for the k-buffer kernels and 4 for the scan
    kernels' packed word; `mc_far` is a split frame's far-pass budget (0
    without split-far)."""
    rays_per_call = min(rays_per_call, R)

    def pad8(m):
        return (m + 7) // 8 * 8

    cand_bytes = 4.0 if composite_mode in SCAN_MODES else 8.0
    per_ray = max(pad8(max_clusters) / cull_tile_primary,
                  pad8(max_clusters_secondary or max_clusters)
                  / cull_tile_secondary,
                  pad8(mc_far) / cull_tile_secondary) * cand_bytes
    tile_lcm = max(cull_tile_primary, cull_tile_secondary)
    cap = max(tile_lcm, int(0.4 * 2**20 / per_ray) // tile_lcm * tile_lcm)
    rays_per_call = min(rays_per_call, cap)
    return -(-R // rays_per_call) * rays_per_call


def render_frame_fused(
    scene: GaussianScene,
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
    mc_far: int = 32,
    split_radius_scale: float = 1.5,
    max_hits_far: int = 0,
    composite_mode: str = "kbuffer",
    samples: FrameSamples | None = None,
    kernel_stats: bool = True,
    attr_precision: str = "highest",
    opts=None,
):
    """Whole-frame render where each bounce is one render kernel launch:
    render_culled (composite_mode "kbuffer") or render_scan ("scan": direct
    pair math; "scanq": quadric), module docstring.  split_far=True makes
    every bounce two launches of that kernel (split_bounce): the far pass
    with `mc_far` candidates and K `max_hits_far` (0: the near K), the
    split sphere's radius `split_radius_scale` x the median live distance
    from the live centroid.

    `kernel_stats=False` compiles the scan kernels' counters out (lanes
    num_accumulated, num_traversed, chunks read zero; every other output is
    the same); `attr_precision="bf16"` rounds scanq's attribute products'
    operands to bf16.  The k-buffer kernel ignores both.  The frame's
    randomness comes from `samples` when given, else it is drawn from
    `generator`.  Requires sqrt(cull_tile_primary) | height and | width and
    the scene capacity padded to cull_cluster (fused_path_ok).  Returns
    (StepOutputs [S, H*W, ...], final [H*W, 3]) in linear pixel order, on
    the scene's device."""
    check_composite_mode(composite_mode)
    if attr_precision not in ATTR_PRECISIONS:
        raise ValueError(f"attr_precision={attr_precision!r}: expected one "
                         f"of {ATTR_PRECISIONS}")
    full_f32_matmuls()
    prep = _prepare_fused_frame(
        scene, camera, settings, samples, width, height, jitter=jitter,
        cull_cluster=cull_cluster, cull_tile_primary=cull_tile_primary,
        num_steps=num_bounces + 1, generator=generator,
        composite_mode=composite_mode, split_far=split_far,
        split_radius_scale=split_radius_scale)
    dirs, us, ray_inv, R = prep["dirs"], prep["us"], prep["ray_inv"], prep["R"]
    if R % 256:
        raise ValueError(f"{width}x{height}: pixel count must be a multiple "
                         "of 256")
    Rp = padded_ray_count(R, max_clusters, max_clusters_secondary,
                          cull_tile_primary, cull_tile_secondary,
                          rays_per_call, composite_mode,
                          mc_far if split_far else 0)
    pad = Rp - R
    if pad:
        # duplicate leading rays into the padded tail (sliced off below);
        # the uniforms pad identically so each pixel's samples are unchanged
        dirs = torch.cat([dirs, dirs[:pad]], dim=0)
        us = torch.cat([us, us[:, :pad]], dim=1)
    rays_o = camera.origin.expand(Rp, 3)

    stacked, final = _fused_bounce_core(
        rays_o, dirs, us, prep["gpack"], prep["bounds"], prep["scene_lo"],
        prep["scene_hi"], settings, camera.znear, camera.zfar,
        capacity=scene.capacity, num_bounces=num_bounces, max_hits=max_hits,
        exp_power_static=exp_power_static, cull_cluster=cull_cluster,
        max_clusters=max_clusters,
        max_clusters_secondary=max_clusters_secondary,
        cull_tile_secondary=cull_tile_secondary,
        cull_tile_primary=cull_tile_primary, scan=prep["scan"],
        kernel_stats=kernel_stats, attr_precision=attr_precision,
        split=prep["split"], mc_far=mc_far, max_hits_far=max_hits_far,
        opts=opts)
    unpad = StepOutputs(*(a[:, :R][:, ray_inv] for a in stacked))
    return unpad, final[:R][ray_inv]


class TileSamples(NamedTuple):
    """The random numbers of a frame or a training step traced in ray tiles
    (the JAX non-fused path and training step draw them per tile:
    fold_in(key_b, i), then one split per bounce)."""

    jitter: torch.Tensor | None  # [H, W, 2] sub-pixel offsets, [-0.5, 0.5)
    us: torch.Tensor             # [T, S, tile, 2] GGX uniforms per ray tile


# device bytes a batch holds per (bounce, ray, slot): hits, gathered
# attributes and frames, gradient payload and the backward's transients,
# with room to spare (the fused full-width training step peaked at 30.7 GB
# for 56.6M of them, 540 B each, on an H100 80GB HBM3); bounds
# tiles_per_launch_for
BYTES_PER_RAY_HIT = 640


def tiles_per_launch_for(num_tiles: int, tile: int, num_steps: int,
                         max_hits: int, device: torch.device) -> int:
    """How many ray tiles one launch per bounce takes: as many as fit in
    half of this process's share of the card's total memory (the card over
    the ranks that share it, device.ranks_per_card), 1 GiB on the CPU."""
    if device.type == "cuda":
        budget = (torch.cuda.get_device_properties(device).total_memory
                  // (2 * ranks_per_card()))
    else:
        budget = 1 << 30
    per_tile = tile * num_steps * max_hits * BYTES_PER_RAY_HIT
    return max(1, min(num_tiles, budget // per_tile))


def loss_gradients_per_step(steps: StepOutputs, targets: RayTargets,
                            settings: RenderSettings, num_bounces: int):
    """Per-ray upstream gradients of the fused L1 losses, per step.

    backward_pass.cu:80-108: sign of the difference times the loss weight,
    deliberately not averaged over pixels, with the specular term shared
    across bounce steps, weighted by the previous step's throughput and the
    (1 - roughness)^3 downweighting.  Returns per step (dL_drgb [R, 3],
    dL_dnormal [R, 3], dL_df0 [R, 3], dL_droughness [R], dL_ddepth [R])."""
    out = []
    spec_pred = None
    if num_bounces > 0:
        spec_pred = steps.rgb[1]
        for b in range(2, num_bounces + 1):
            spec_pred = spec_pred + steps.rgb[b]
    third = 1.0 / 3.0
    for step in range(num_bounces + 1):
        if step == 0:
            dL_drgb = third * sign(steps.rgb[0] - targets.diffuse) \
                * settings.loss_weight_diffuse
            dL_ddepth = sign(steps.depth[0] - targets.depth) \
                * settings.loss_weight_depth
            dL_dnormal = third * sign(steps.normal[0] - targets.normal) \
                * settings.loss_weight_normal
            dL_df0 = third * sign(steps.f0[0] - targets.f0) \
                * settings.loss_weight_f0
            dL_drough = sign(steps.roughness[0] - targets.roughness) \
                * settings.loss_weight_roughness
        else:
            downweight = rounded(
                torch.pow,
                torch.clamp(1.0 - steps.roughness[step - 1], min=0.0),
                ROUGHNESS_DOWNWEIGHT_GRAD_POWER)
            dL_drgb = (third * sign(spec_pred - targets.specular)
                       * settings.loss_weight_specular * downweight[:, None])
            # times the throughput of the previous step (backward_pass.cu:107)
            dL_drgb = dL_drgb * steps.throughput[step - 1]
            dL_ddepth = torch.zeros_like(targets.depth)
            dL_dnormal = torch.zeros_like(targets.normal)
            dL_df0 = torch.zeros_like(targets.f0)
            dL_drough = torch.zeros_like(targets.depth)
        out.append((dL_drgb, dL_dnormal, dL_df0, dL_drough, dL_ddepth))
    return out


def scene_box(bounds: ClusterBounds):
    """Per-axis box of the valid cluster spheres: the training step's frame
    for the Morton cells of reflected-ray origins."""
    v = bounds.any_valid[:, None]
    r = bounds.radius[:, None]
    inf = torch.tensor(float("inf"), device=r.device)
    lo = torch.where(v, bounds.center - r, inf).amin(dim=0)
    hi = torch.where(v, bounds.center + r, -inf).amax(dim=0)
    return lo, hi


def slots_call(rays_o, rays_d, alive, step: int, gpack, table, ftable,
               bounds: ClusterBounds, scene_lo, scene_hi,
               settings: RenderSettings, znear: float, zfar: float, *,
               max_hits: int, cull_tile: int, cull_cluster: int,
               max_clusters: int, n_capacity: int, exp_power_static: float,
               tile_rays: int | None, t_split=None,
               window_mode: int = 0, opts=None) -> KernelCall:
    """Order the wavefront of bounce `step` (reflected rays re-sorted within
    their `tile_rays` groups), cull per tile, and assemble trace_slots'
    arguments, with the exit mode of the Pallas kernel the JAX dispatch
    would run for this capacity.  window_mode 1 / 2: split-far's near / far
    pass over the rays' split distances `t_split` [R] (canonical order), as
    kernel_call takes them."""
    near = znear if step == 0 else 0.0
    inv_order = None
    if step > 0:
        sort = far_order if window_mode == 2 else secondary_order
        order, inv_order = sort(rays_o, rays_d, alive, scene_lo, scene_hi,
                                tile_rays)
        rays_o, rays_d, alive = rays_o[order], rays_d[order], alive[order]
        if t_split is not None:
            t_split = t_split[order]
    cull_near, cull_far = window_bounds(near, zfar, t_split, window_mode,
                                        cull_tile)
    cands, cnear, _n, _ovf, tdrop = select_candidates(
        rays_o, rays_d, bounds, cull_near, cull_far, tile=cull_tile,
        max_clusters=max_clusters)
    tdrop_ray = tdrop.repeat_interleave(cull_tile)
    if inv_order is not None:
        tdrop_ray = tdrop_ray[inv_order]
    exit_mode, check_every = exit_mode_for(n_capacity)
    args = (rays_o.contiguous(), rays_d.contiguous(), gpack, table, ftable,
            cands, cnear, near, zfar, exp_power_static,
            1.0 if step > 0 else 0.0, settings.backfacing_max_dist,
            settings.backfacing_invalid_normal_threshold)
    kwargs = dict(
        transmittance_threshold=settings.transmittance_threshold,
        max_hits=max_hits, cluster=cull_cluster, tile=cull_tile, alive=alive,
        secondary_static=1 if step > 0 else 0, exit_mode=exit_mode,
        check_every=check_every, opts=opts)
    if window_mode:
        kwargs.update(t_split=t_split.contiguous(), window_mode=window_mode)
    return KernelCall(trace_slots, args, kwargs, inv_order, tdrop_ray)


def far_hits(max_hits: int, max_hits_far: int = 0) -> int:
    """Split-far's far-pass slots a ray in the training step: max_hits_far,
    or max(8, max_hits // 2) for 0 (JAX raytracer.py:431)."""
    return max_hits_far or max(8, max_hits // 2)


def traced_slots(call: KernelCall):
    """A slots call's (slots, acc), rows in canonical ray order."""
    slots, acc = call.kernel(*call.args, **call.kwargs)
    if call.inv_order is not None:
        # everything downstream is row-local: back to canonical order
        slots, acc = slots[call.inv_order], acc[call.inv_order]
    return slots, acc


def fused_forward(
    rays_o, rays_d, settings: RenderSettings, znear: float, zfar: float,
    us: torch.Tensor, num_bounces: int, max_hits: int, *, gpack, table,
    ftable, bounds: ClusterBounds, cull_tile: int, cull_cluster: int,
    max_clusters: int, n_capacity: int, exp_power_static: float = 3.0,
    tile_rays: int | None = None, split_far: bool = False,
    mc_far: int = 32, max_hits_far: int = 0,
    split_radius_scale: float = 1.5, opts=None,
):
    """The training forward: per bounce one trace_slots launch, then the
    composite and the GGX epilogue on the [R, K] slots, all rows in
    canonical order.  split_far (where slots_resident_fits holds, as in
    JAX; else one pass) makes every bounce two launches, the near pass
    (window 1, K slots) and the far pass of the rays it left unsaturated
    (window 2, `mc_far` candidates, far_hits(K, max_hits_far) slots),
    merged into K + K_far slots a ray (merge_slots), which the composite
    and the backward take as they are (JAX raytracer.py:397-603).  Returns
    (StepOutputs [S, R, ...], final rgb [R, 3], per-bounce residuals
    (hits, comp, attrs, frames), per-bounce KernelCalls: SplitCalls
    where split)."""
    R = rays_o.shape[0]
    K = max_hits
    dev = rays_o.device
    scene_lo, scene_hi = scene_box(bounds)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    thr = settings.transmittance_threshold
    split = (split_sphere_from_bounds(bounds, split_radius_scale)
             if split_far and slots_resident_fits(n_capacity) else None)
    Kf = far_hits(K, max_hits_far) if split is not None else 0
    outs, residuals, calls = [], [], []
    for step in range(num_bounces + 1):
        kw = dict(max_hits=K, cull_tile=cull_tile, cull_cluster=cull_cluster,
                  max_clusters=max_clusters, n_capacity=n_capacity,
                  exp_power_static=exp_power_static, tile_rays=tile_rays,
                  opts=opts)
        common = (step, gpack, table, ftable, bounds, scene_lo, scene_hi,
                  settings, znear, zfar)
        if split is None:
            call = slots_call(rays_o, rays_d, alive, *common, **kw)
            slots, acc = traced_slots(call)
        else:
            ts = split_exit_t(rays_o, rays_d, split)
            call_n = slots_call(rays_o, rays_d, alive, *common, t_split=ts,
                                window_mode=1, **kw)
            slots_n, acc_n = traced_slots(call_n)
            T_near = rounded(torch.exp, acc_n[:, 0])
            alive_far = alive & (T_near > thr)
            call_f = slots_call(rays_o, rays_d, alive_far, *common,
                                t_split=ts, window_mode=2,
                                **dict(kw, max_hits=Kf, max_clusters=mc_far))
            slots_f, acc_f = traced_slots(call_f)
            slots, acc = merge_slots(slots_n, acc_n, slots_f, acc_f, K, Kf)
        hits_d, attrs_d, frames_d = unpack_slots(slots, acc, K + Kf, rays_o,
                                                 rays_d)
        hits = RayHits(**hits_d)
        comp = composite(hits, attrs_d["rgb"], attrs_d["normal"],
                         attrs_d["f0"], attrs_d["roughness"],
                         settings.transmittance_threshold,
                         settings.eps_forward_normalization)
        residuals.append((hits, comp, attrs_d, frames_d))

        if split is None:
            starved = _starved(call.tdrop_ray, zfar, comp.full_T, alive, thr)
        else:
            # the near pass's window ends at each ray's own split distance
            call = SplitCalls(
                call_n, call_f,
                _starved(call_n.tdrop_ray, ts, T_near, alive, thr),
                _starved(call_f.tdrop_ray, zfar, comp.full_T, alive_far,
                         thr))
            starved = torch.maximum(call.starved_near, call.starved_far)
        calls.append(call)
        rgb_step = comp.rgb if step == 0 else comp.rgb * throughput
        next_origin, next_dir, next_throughput, next_alive = next_wavefront(
            comp.normal, comp.roughness, comp.depth, comp.f0, rays_o, rays_d,
            throughput, alive, us[step], settings)
        outs.append(dict(
            rgb=rgb_step, normal=comp.normal, f0=comp.f0,
            roughness=comp.roughness, depth=comp.depth,
            transmittance=comp.T_final, total_transmittance=comp.full_T,
            throughput=next_throughput, alive=alive.to(torch.float32),
            overflow=starved))
        rays_o, rays_d = next_origin, next_dir
        throughput, alive = next_throughput, next_alive

    steps = StepOutputs(**{k: torch.stack([o[k] for o in outs], dim=0)
                           for k in outs[0]})
    return steps, steps.rgb.sum(dim=0), residuals, calls


def hit_grads(steps: StepOutputs, residuals: list, targets: RayTargets,
              settings: RenderSettings, num_bounces: int, n_capacity: int):
    """The loss-fused backward of every bounce: (payload [S*R*K,
    SCATTER_COLS] f32, ids [S*R*K] int32, -1 for empty slots), the rows
    scatter_add takes.  Empties `residuals` as it goes."""
    dLs = loss_gradients_per_step(steps, targets, settings, num_bounces)
    hits0 = residuals[0][0]
    M = hits0.t.numel()
    dev = hits0.t.device
    num_steps = num_bounces + 1
    payload = torch.empty((num_steps * M, SCATTER_COLS), dtype=torch.float32,
                          device=dev)
    ids = torch.empty((num_steps * M,), dtype=torch.int32, device=dev)
    for step in range(num_steps):
        hits, comp, attrs_d, frames_d = residuals[step]
        residuals[step] = None
        per_hit = backward_step(
            hits, comp, attrs_d["rgb"], attrs_d["normal"], attrs_d["f0"],
            attrs_d["roughness"], frames_d["opacity"],
            frames_d["scaling_act"], frames_d["rotation_raw"],
            frames_d["rot_mat"], frames_d["inv_sizes"], frames_d["sf"],
            *dLs[step], settings.exp_power, settings.eps_scale_grad,
            n_capacity, settings.global_scale_factor)
        rows = slice(step * M, (step + 1) * M)
        pack_scatter_payload(per_hit, out=payload[rows])
        ids[rows] = torch.where(hits.valid, hits.ids,
                                torch.full_like(hits.ids, -1)).reshape(-1)
    return payload, ids


def render_tile_with_grads_fused(
    rays_o, rays_d, targets: RayTargets, settings: RenderSettings,
    znear: float, zfar: float, us: torch.Tensor, num_bounces: int,
    max_hits: int, *, gpack, table, ftable, bounds: ClusterBounds,
    cull_tile: int, cull_cluster: int, max_clusters: int, n_capacity: int,
    exp_power_static: float = 3.0, use_mxu_scatter: bool = False,
    split_far: bool = False, mc_far: int = 32, max_hits_far: int = 0,
    split_radius_scale: float = 1.5, tile_rays: int | None = None,
    grad_acc: torch.Tensor | None = None, opts=None,
):
    """Forward + loss-fused backward of a batch of rays via the slots kernel.

    Per bounce one trace_slots launch returns depth-sorted slots carrying
    t/alpha/id plus the shading attributes and frame fields of every kept
    hit; the composite, the GGX epilogue and backward_step then run on the
    [R, K] slot data directly (fused_forward, hit_grads), and one
    scatter_add launch adds every bounce's per-hit gradients into the
    float64 accumulator.

    us [num_bounces + 1, R, 2]: the GGX uniforms of each bounce, per ray.
    rays_o/rays_d may hold several of the JAX package's ray tiles back to
    back (`tile_rays` rays each): reflected rays are re-sorted only within
    their own tile, as the JAX step re-sorts each tile it traces, so every
    ray's result equals its tile-by-tile result.  The scene tables are in
    the Morton-sorted layout of prepare_render_inputs; so are the grads.

    grad_acc: the step's [N, SCATTER_COLS] float64 sums to add into; the
    caller rounds them once (grads_from_accumulator).  Without it the
    function makes its own and returns the rounded ParamGrads; with it the
    third return value is None.  `use_mxu_scatter` selects the same scatter
    kernel: the port has no separate one-hot form.  split_far, mc_far,
    max_hits_far and split_radius_scale: fused_forward's two-pass bounce;
    the scatter then takes K + K_far slots a ray.

    Returns (StepOutputs [S, R, ...], final rgb [R, 3], ParamGrads | None).
    """
    del use_mxu_scatter  # one scatter kernel serves both JAX forms
    steps, final, residuals, _calls = fused_forward(
        rays_o, rays_d, settings, znear, zfar, us, num_bounces, max_hits,
        gpack=gpack, table=table, ftable=ftable, bounds=bounds,
        cull_tile=cull_tile, cull_cluster=cull_cluster,
        max_clusters=max_clusters, n_capacity=n_capacity,
        exp_power_static=exp_power_static, tile_rays=tile_rays,
        split_far=split_far, mc_far=mc_far, max_hits_far=max_hits_far,
        split_radius_scale=split_radius_scale, opts=opts)
    payload, ids = hit_grads(steps, residuals, targets, settings,
                             num_bounces, n_capacity)
    acc = grad_acc
    if acc is None:
        acc = new_grad_accumulator(n_capacity, payload.device)
    scatter_add(acc, payload, ids)
    grads = grads_from_accumulator(acc) if grad_acc is None else None
    return steps, final, grads
