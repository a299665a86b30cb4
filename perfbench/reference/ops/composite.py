"""Front-to-back alpha compositing with truncated-tail correction (twin of
the JAX ops/composite.py), over the depth-sorted [R, K] slots of one bounce.

  * T_before_i = prod_{j<i} (1 - alpha_j)   (exclusive running product)
  * a hit is composited iff T_before_i >= transmittance_threshold (prefix-
    closed, so this is the reference's early-out, forward_pass.cu:131-134);
  * w_i = T_before_i * alpha_i weights every attribute;
  * the truncated tail redistributes (T_composited - T_exact) with the
    normalized accumulated values (forward_pass.cu:142-155).

Numerics (ops/precision.py): the running products are spelled out slot by
slot in float32, the JAX operation order; the sums over the K slots are
taken in WIDE and rounded once.  A GPU scan or reduction would otherwise
round differently from the CPU's, and a cuda step would part from a cpu
step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .precision import WIDE
from .trace import RayHits


class CompositeOut(NamedTuple):
    """Per-ray outputs of one bounce step plus backward residuals."""

    rgb: torch.Tensor          # [R, 3]  (pre-throughput-multiplication)
    normal: torch.Tensor       # [R, 3]  unnormalized accumulated normal
    f0: torch.Tensor           # [R, 3]
    roughness: torch.Tensor    # [R]
    depth: torch.Tensor        # [R]
    # residuals for the hand-written backward:
    remaining_rgb: torch.Tensor        # [R, 3]
    remaining_normal: torch.Tensor     # [R, 3]
    remaining_f0: torch.Tensor         # [R, 3]
    remaining_roughness: torch.Tensor  # [R]
    remaining_depth: torch.Tensor      # [R]
    T_final: torch.Tensor      # [R] transmittance after composited hits
    full_T: torch.Tensor       # [R] exact transmittance over all hits
    T_after: torch.Tensor      # [R, K] transmittance after each hit
    weight: torch.Tensor       # [R, K] per-hit composite weight T_before*alpha
    comp_mask: torch.Tensor    # [R, K] bool - hit actually composited
    num_accumulated: torch.Tensor  # [R] int32 stats


def running_product(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product along the last axis, left to right in x's dtype."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] * x[..., i])
    return torch.stack(cols, dim=-1)


def slot_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum over the slot axis in WIDE, rounded once to x's dtype."""
    return torch.sum(x.to(WIDE), dim=dim).to(x.dtype)


def _exclusive(T_after: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(T_after[:, :1]), T_after[:, :-1]],
                     dim=-1)


def composite(
    hits: RayHits,
    g_rgb: torch.Tensor,        # [R, K, 3] activated attributes of the hits
    g_normal: torch.Tensor,     # [R, K, 3]
    g_f0: torch.Tensor,         # [R, K, 3]
    g_roughness: torch.Tensor,  # [R, K]
    transmittance_threshold: float,
    eps_forward_normalization: float,
) -> CompositeOut:
    zero = torch.zeros_like(hits.alpha)
    alpha = torch.where(hits.valid, hits.alpha, zero)
    T_before = _exclusive(running_product(1.0 - alpha))

    comp_mask = hits.valid & (T_before >= transmittance_threshold)
    alpha_c = torch.where(comp_mask, alpha, zero)
    # transmittances over composited hits only; inside the composited prefix
    # they agree with the ones above (the mask is prefix-closed)
    T_after = running_product(1.0 - alpha_c)
    T_before = _exclusive(T_after)
    weight = T_before * alpha_c                                     # [R, K]

    w3 = weight[..., None]
    rgb = slot_sum(g_rgb * w3)
    normal = slot_sum(g_normal * w3)
    f0 = slot_sum(g_f0 * w3)
    roughness = slot_sum(g_roughness * weight)
    depth = slot_sum(hits.t * weight)
    T_final = T_after[:, -1]

    # truncated-tail correction (forward_pass.cu:142-155)
    remaining_T = T_final - hits.full_T
    normalization = torch.clamp(1.0 - T_final, min=eps_forward_normalization)
    remaining_rgb = rgb / normalization[:, None]
    remaining_normal = normal / normalization[:, None]
    remaining_f0 = f0 / normalization[:, None]
    remaining_roughness = roughness / normalization
    remaining_depth = depth / normalization

    rgb = rgb + remaining_T[:, None] * remaining_rgb
    normal = normal + remaining_T[:, None] * remaining_normal
    f0 = f0 + remaining_T[:, None] * remaining_f0
    roughness = roughness + remaining_T * remaining_roughness
    depth = depth + remaining_T * remaining_depth

    return CompositeOut(
        rgb=rgb, normal=normal, f0=f0, roughness=roughness, depth=depth,
        remaining_rgb=remaining_rgb, remaining_normal=remaining_normal,
        remaining_f0=remaining_f0, remaining_roughness=remaining_roughness,
        remaining_depth=remaining_depth,
        T_final=T_final, full_T=hits.full_T, T_after=T_after, weight=weight,
        comp_mask=comp_mask,
        num_accumulated=comp_mask.sum(dim=-1, dtype=torch.int32),
    )
