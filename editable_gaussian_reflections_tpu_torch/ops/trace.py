"""Depth-ordered hit gathering (twin of the JAX ops/trace.py): the RayHits
container and the non-fused renderer's traces.

Each trace returns a ray's K nearest hits, depth-sorted, with the exact
log-transmittance over every hit it tested (full_T = exp of it); the
truncated-tail correction of the composite accounts for hits beyond K.

  * trace_rays_brute: every Gaussian (the JAX trace_rays_pallas, through
    pallas_trace_fused), and trace_rays_culled: each ray tile's candidate
    clusters with the tile early exit (through pallas_trace_culled_fused).
    Both run the kernel of csrc/trace_hits.cu (ops/cuda/trace_hits.py),
    and on CPU tensors its plain version.
  * trace_rays: the JAX package's XLA tracer (its use_pallas=False path) in
    plain PyTorch, on any device: the Gaussians in chunks, each ray's K
    nearest kept across chunks, then the winners' payload recomputed
    (intersect_gathered).  The Gaussian-sharded modes trace with it
    (parallel/gaussian_sharded.py), as the JAX ones do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.trace_hits import trace_hits
from .gaussian_kernel import MAX_ALPHA, eval_gaussian_sq
from .intersect import GaussianFrames, intersect_block, local_ray
from .precision import WIDE, dot, rounded

# ray x Gaussian pairs one block of trace_rays holds at a time (each pair
# takes some 40 float32 temporaries, so ~670 MB)
PAIRS_PER_BLOCK = 1 << 22


class RayHits(NamedTuple):
    """Per-ray depth-sorted hit records (the flat PPLL equivalent)."""

    ids: torch.Tensor        # [R, K] int32 Gaussian index (0 where ~valid)
    t: torch.Tensor          # [R, K] sorted ascending
    alpha: torch.Tensor      # [R, K]
    gaussval: torch.Tensor   # [R, K]
    local_hit: torch.Tensor  # [R, K, 3]
    valid: torch.Tensor      # [R, K] bool
    full_T: torch.Tensor     # [R] exact product of (1-alpha) over ALL hits
    num_traversed: torch.Tensor  # [R] int32 stats (intersection tests run)


def gather_frames(frames: GaussianFrames, ids: torch.Tensor) -> GaussianFrames:
    """Every field of `frames` at the Gaussians `ids` ([R, K] -> [R, K, ...])."""
    return frames.take(ids.to(torch.int64))


def _hits(t, ids, alpha, gaussval, local_hit, log_T, traversed) -> RayHits:
    """The trace kernel's outputs as RayHits (ops/trace.py:135-146)."""
    valid = t < 1e37
    zero = torch.zeros_like(t)
    return RayHits(
        ids=torch.where(valid, ids, torch.zeros_like(ids)),
        t=torch.where(valid, t, zero),
        alpha=torch.where(valid, alpha, zero),
        gaussval=gaussval,
        local_hit=local_hit,
        valid=valid,
        full_T=rounded(torch.exp, log_T),
        num_traversed=traversed,
    )


def trace_rays_brute(rays_o, rays_d, gpack, exp_power: float, near, far,
                     secondary: float, max_hits: int = 32,
                     backfacing_max_dist=0.1,
                     backfacing_invalid_normal_threshold=0.9,
                     extract_attrs: bool = False):
    """Brute trace of every Gaussian (the JAX trace_rays_pallas).  Returns
    (RayHits, attrs | None), attrs the kept hits' shading attributes when
    `extract_attrs`.

    The JAX wrapper picks its ray tile and Gaussian chunk by a TPU VMEM
    rule; the brute result does not depend on either (apart from the order
    in which log T is summed, WIDE here), so the kernel blocks the work its
    own way (ops/cuda/trace_hits.py)."""
    t, ids, alpha, gv, lh, attrs, log_T, trav = trace_hits(
        rays_o, rays_d, gpack, None, None, near, far, exp_power, secondary,
        backfacing_max_dist, backfacing_invalid_normal_threshold,
        max_hits=max_hits, extract_attrs=extract_attrs)
    return _hits(t, ids, alpha, gv, lh, log_T, trav), attrs


def trace_rays_culled(rays_o, rays_d, gpack, candidates, cand_near,
                      exp_power: float, near, far, secondary: float,
                      transmittance_threshold=0.01, max_hits: int = 32,
                      cluster: int = 256, tile: int = 256,
                      backfacing_max_dist=0.1,
                      backfacing_invalid_normal_threshold=0.9,
                      extract_attrs: bool = False):
    """Culled trace (cluster candidates [R / tile, MC] from
    culling.select_candidates, with the in-kernel early exit).  Same
    returns as trace_rays_brute; full_T omits the hits in skipped clusters
    (behind the K kept hits or beyond saturation: the truncated-tail
    correction absorbs them, forward_pass.cu:131-134)."""
    t, ids, alpha, gv, lh, attrs, log_T, trav = trace_hits(
        rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
        secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
        transmittance_threshold=transmittance_threshold, max_hits=max_hits,
        cluster=cluster, tile=tile, extract_attrs=extract_attrs)
    return _hits(t, ids, alpha, gv, lh, log_T, trav), attrs


def intersect_gathered(rays_o, rays_d, frames_g: GaussianFrames,
                       exp_power: float):
    """The intersection quantities of gathered per-(ray, k) Gaussians
    (frames_g fields [R, K, ...]): (alpha, gaussval, local_hit, t).
    Validity was decided by the trace."""
    lo, ld = local_ray(rays_o[:, None, :], rays_d[:, None, :], frames_g.mean,
                       frames_g.rot, frames_g.inv_sizes)        # [R, K, 3]
    norm = rounded(torch.sqrt, dot(ld, ld))
    safe_norm = torch.clamp(norm, min=1e-20)
    ldn = ld / safe_norm[..., None]
    t_loc = -dot(lo, ldn)
    t_world = t_loc / safe_norm
    u = lo + t_loc[..., None] * ldn
    sq = dot(u, u)
    local_hit = u * frames_g.sf[..., None]
    sq_scaled = sq * frames_g.sf * frames_g.sf
    gaussval = eval_gaussian_sq(sq_scaled, exp_power)
    alpha = MAX_ALPHA * gaussval * frames_g.opacity
    return alpha, gaussval, local_hit, t_world


def depth_keys(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (t, id): t's float32 bits made monotonic in
    the high word, the id (< 2**31) in the low one.  Distinct ids make
    every key distinct, so the k smallest keys are the k nearest hits with
    ties taken in id order, whatever the device's top-k does with ties."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits << 32) | ids


def key_depths(keys: torch.Tensor):
    """(t, ids) of depth_keys' keys."""
    bits = keys >> 32
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int32).view(torch.float32),
            keys & 0xFFFFFFFF)


def trace_rays(rays_o, rays_d, frames: GaussianFrames, exp_power: float,
               near: float, far: float, max_hits: int = 32,
               chunk: int = 2048, secondary: bool = False,
               backfacing_max_dist: float = 0.1,
               backfacing_invalid_normal_threshold: float = 0.9) -> RayHits:
    """Each ray's K nearest hits over every Gaussian of `frames` (N padded
    to a multiple of `chunk`), in plain PyTorch: the JAX XLA tracer.

    Per chunk of Gaussians: intersect_block, the chunk's K nearest (at
    equal t the lower index, as lax.top_k), merged into the running K
    nearest (at equal t the running entry first, as the stable argsort):
    both are the K smallest (t, id) keys (depth_keys), since the running
    entries come from earlier chunks.  log T gathers log1p(-alpha) of every
    hit, each chunk summed in WIDE.  Then the winners' frames are gathered
    and their payload recomputed.

    The rays go in blocks of at most PAIRS_PER_BLOCK / chunk rays, so the
    [rays, chunk] temporaries stay bounded whatever R is (JAX holds all R
    rays at once); a ray's result depends on no other ray."""
    return trace_rays_log(
        rays_o, rays_d, frames, exp_power, near, far, max_hits, chunk,
        secondary, backfacing_max_dist, backfacing_invalid_normal_threshold)[0]


def trace_rays_log(rays_o, rays_d, frames: GaussianFrames, exp_power: float,
                   near: float, far: float, max_hits: int = 32,
                   chunk: int = 2048, secondary: bool = False,
                   backfacing_max_dist: float = 0.1,
                   backfacing_invalid_normal_threshold: float = 0.9):
    """trace_rays with its log T before the rounding: (RayHits, log_T [R]
    in WIDE).  The Gaussian-sharded trace sums the shards' log T as they
    are and rounds once, as one process does."""
    R = rays_o.shape[0]
    N = frames.mean.shape[0]
    assert N % chunk == 0, f"N={N} must be padded to a multiple of chunk={chunk}"
    K = max_hits
    dev = rays_o.device
    k_chunk = min(K, chunk)
    block = max(1, PAIRS_PER_BLOCK // chunk)
    top = torch.empty((R, K), dtype=torch.int64, device=dev)
    log_T = torch.empty((R,), dtype=WIDE, device=dev)
    for r0 in range(0, R, block):
        o, d = rays_o[r0:r0 + block], rays_d[r0:r0 + block]
        n = o.shape[0]
        bk = depth_keys(torch.full((n, K), float("inf"), device=dev),
                        torch.zeros((n, K), dtype=torch.int64, device=dev))
        blt = torch.zeros((n,), dtype=WIDE, device=dev)
        for c0 in range(0, N, chunk):
            blk = GaussianFrames(*(a[c0:c0 + chunk] for a in frames))
            hits = intersect_block(
                o, d, blk, exp_power, near, far, secondary=secondary,
                backfacing_max_dist=backfacing_max_dist,
                backfacing_invalid_normal_threshold=(
                    backfacing_invalid_normal_threshold))
            log1m = torch.log1p(-hits.alpha.to(WIDE))
            blt = blt + torch.where(hits.valid, log1m,
                                    torch.zeros_like(log1m)).sum(dim=-1)
            t_masked = torch.where(hits.valid, hits.t,
                                   torch.full_like(hits.t, float("inf")))
            ids = torch.arange(c0, c0 + t_masked.shape[1], device=dev)
            keys = depth_keys(t_masked, ids.expand_as(t_masked))
            cand = torch.topk(keys, k_chunk, dim=-1, largest=False).values
            bk = torch.topk(torch.cat([bk, cand], dim=-1), K, dim=-1,
                            largest=False).values
        top[r0:r0 + n], log_T[r0:r0 + n] = bk, blt
    # every ray tests every valid Gaussian (payload-7 stats, shaders.cu:33)
    traversed = frames.valid.sum(dtype=torch.int32).expand(R).clone()

    top_t, top_id = key_depths(top)
    valid = torch.isfinite(top_t)
    top_id = torch.where(valid, top_id, torch.zeros_like(top_id))
    alpha, gaussval, local_hit, _t = intersect_gathered(
        rays_o, rays_d, gather_frames(frames, top_id), exp_power)
    zero = torch.zeros_like(alpha)
    hits = RayHits(
        ids=top_id.to(torch.int32),
        t=torch.where(valid, top_t, zero),
        alpha=torch.where(valid, alpha, zero),
        gaussval=gaussval,
        local_hit=local_hit,
        valid=valid,
        full_T=rounded(torch.exp, log_T),
        num_traversed=traversed,
    )
    return hits, log_T
