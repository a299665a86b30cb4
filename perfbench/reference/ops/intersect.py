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
