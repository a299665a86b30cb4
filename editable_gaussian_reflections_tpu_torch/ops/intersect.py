"""Ray x anisotropic-Gaussian intersection at the max-response point (twin
of the JAX ops/intersect.py).

The reference traverses a BVH and calls an intersection program per hit
(shaders.cu:9-75); here the closed-form test runs on dense (ray, Gaussian)
blocks, as the JAX XLA tracer does:

  * the ray goes into the Gaussian's local frame, where the alpha-threshold
    isosurface is the unit sphere: x_local = diag(1/sizes) R^T (x - mean);
  * a Gaussian whose centre projects behind the ray is rejected
    (shaders.cu:36-38), and so is one whose max-response point, the closest
    point to the centre along the ray, lies outside the unit sphere
    (shaders.cu:47-50);
  * reflected rays reject back-facing Gaussians near their origin
    (shaders.cu:53-61);
  * alpha = MAX_ALPHA * exp(-(|sf*u|^2)^p / 2p) * opacity (shaders.cu:63-66).

The kernels do the same test in CUDA (csrc/trace_hits_walk.cuh).  Here it is
plain PyTorch in float32, in the JAX operation order: every 3-term sum is
spelled out left to right, sqrt, exp and pow are rounded once
(ops/precision.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gaussian_kernel import MAX_ALPHA, eval_gaussian_sq
from .precision import dot, rounded


class GaussianFrames(NamedTuple):
    """Everything needed to map rays into each Gaussian's unit-sphere frame."""

    mean: torch.Tensor       # [N, 3]
    rot: torch.Tensor        # [N, 3, 3]  world = rot @ local
    inv_sizes: torch.Tensor  # [N, 3]  1 / (exp(scale) * sf * gsf); 0 if degenerate
    sf: torch.Tensor         # [N]  scaling factor (alpha-threshold clip radius)
    opacity: torch.Tensor    # [N]  sigmoid-activated
    normal: torch.Tensor     # [N, 3]  raw (identity activation)
    valid: torch.Tensor      # [N]  bool; False for degenerate/padded Gaussians

    def take(self, idx: torch.Tensor) -> "GaussianFrames":
        """Rows reordered by `idx` (every field indexed along dim 0)."""
        return GaussianFrames(*(a[idx] for a in self))


class Hits(NamedTuple):
    """Per (ray, Gaussian) intersection results, all [R, N(block)]."""

    t: torch.Tensor          # world-space distance of the max-response point
    alpha: torch.Tensor      # 0 where ~valid
    gaussval: torch.Tensor
    local_hit: torch.Tensor  # [R, N, 3] sf-scaled local hit point
    valid: torch.Tensor      # bool


def local_ray(rays_o, rays_d, mean, rot, inv_sizes):
    """(lo, ld): ray origin and direction in the Gaussian's unit-sphere
    frame, lo = Dinv R^T (o - mean), ld = Dinv R^T d.  rays_o/rays_d
    broadcast against the Gaussian fields (mean [..., 3], rot [..., 3, 3],
    inv_sizes [..., 3]); each component is the sum over world axes j of
    rot[j, i] * v[j], left to right."""
    rel = rays_o - mean
    lo = torch.stack([dot(rot[..., :, i], rel) for i in range(3)], dim=-1)
    ld = torch.stack([dot(rot[..., :, i], rays_d) for i in range(3)], dim=-1)
    return lo * inv_sizes, ld * inv_sizes


def intersect_block(rays_o, rays_d, frames: GaussianFrames, exp_power: float,
                    near: float, far: float, secondary: bool = False,
                    backfacing_max_dist: float = 0.1,
                    backfacing_invalid_normal_threshold: float = 0.9
                    ) -> Hits:
    """Every ray of rays_o/rays_d [R, 3] (directions normalized) against
    every Gaussian of the block `frames` [N]: Hits [R, N]."""
    lo, ld = local_ray(rays_o[:, None, :], rays_d[:, None, :],
                       frames.mean[None], frames.rot[None],
                       frames.inv_sizes[None])                  # [R, N, 3]
    # reject Gaussians behind the ray (shaders.cu:36-38)
    front = dot(lo, ld) <= 0.0
    norm = rounded(torch.sqrt, dot(ld, ld))
    safe_norm = torch.clamp(norm, min=1e-20)
    ldn = ld / safe_norm[..., None]
    t_loc = -dot(lo, ldn)
    t_world = t_loc / safe_norm
    u = lo + t_loc[..., None] * ldn                              # unit-sphere hit
    sq = dot(u, u)
    inside = sq <= 1.0

    valid = frames.valid[None, :] & front & inside
    valid &= (t_world > near) & (t_world < far)
    if secondary:
        # shaders.cu:53-61 - the dot is against the *local* direction
        nlen = rounded(torch.sqrt, dot(frames.normal, frames.normal))  # [N]
        ndotd = dot(frames.normal[None], ldn)
        reject = ((t_world < backfacing_max_dist)
                  & (nlen[None, :] > backfacing_invalid_normal_threshold)
                  & (ndotd > 0.0))
        valid &= ~reject

    local_hit = u * frames.sf[None, :, None]
    sq_scaled = sq * (frames.sf * frames.sf)[None, :]
    gaussval = eval_gaussian_sq(sq_scaled, exp_power)
    alpha = MAX_ALPHA * gaussval * frames.opacity[None, :]
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    return Hits(t=t_world, alpha=alpha, gaussval=gaussval,
                local_hit=local_hit, valid=valid)
