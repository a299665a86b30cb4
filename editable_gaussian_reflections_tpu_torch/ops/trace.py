"""Depth-ordered hit gathering (twin of the JAX ops/trace.py): the RayHits
container and the non-fused renderer's traces.

Each trace returns a ray's K nearest hits, depth-sorted, with the exact
log-transmittance over every hit it tested (full_T = exp of it); the
truncated-tail correction of the composite accounts for hits beyond K.
Both traces run the kernel of csrc/trace_hits.cu (ops/cuda/trace_hits.py),
and on CPU tensors its plain version:

  * trace_rays_brute: every Gaussian (the JAX trace_rays_pallas, through
    pallas_trace_fused);
  * trace_rays_culled: each ray tile's candidate clusters with the tile
    early exit (through pallas_trace_culled_fused).

The JAX package's XLA tracer (trace_rays, its use_pallas=False path) is not
ported: the port's kernels are its only path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.trace_hits import trace_hits
from .intersect import GaussianFrames
from .precision import rounded


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
