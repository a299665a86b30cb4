"""Generalized-Gaussian kernel math (twin of the JAX ops/gaussian_kernel.py).

The reference uses a generalized Gaussian of power ``p`` (default 3),
G(x) = exp(-(|x|^2)^p / (2p)), clipped at the alpha-threshold isosurface:
    sf(o, tau, p) = (2p * ln(o / tau))^(1/(2p)),  0 if o <= tau.
"""

from __future__ import annotations

import numpy as np
import torch

# flags.h:8 - "Essential for stability, can't remove"
MAX_ALPHA = 0.9999
# flags.h (ROUGHNESS_DOWNWEIGHT_GRAD, on): the specular loss gradient of
# bounce b >= 1 is scaled by (1 - roughness of bounce b-1)^POWER
ROUGHNESS_DOWNWEIGHT_GRAD_POWER = 3.0
# the JAX package floors opacity/alpha_threshold at the float32 constant
# 1.0 + 1e-12, which rounds to 1.0; the port keeps that floor in any dtype
RATIO_FLOOR = float(np.float32(1.0 + 1e-12))


def compute_scaling_factor(opacity: torch.Tensor, alpha_threshold: float,
                           exp_power: float) -> torch.Tensor:
    """Zero when opacity <= alpha_threshold."""
    k = 2.0 * exp_power
    safe_ratio = torch.clamp(opacity / alpha_threshold, min=RATIO_FLOOR)
    sf = torch.pow(k * torch.log(safe_ratio), 1.0 / k)
    return torch.where(opacity <= alpha_threshold, torch.zeros_like(sf), sf)
