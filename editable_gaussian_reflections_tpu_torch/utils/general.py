"""General helpers (the numpy-only part of the JAX package's
utils/general.py, copied so the port never imports that package, and
set_seeds)."""

from __future__ import annotations

import random

import numpy as np
import torch


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1000000):
    """Plenoxels log-lerp schedule (general_utils.py:31-60)."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper


def set_seeds(seed: int = 0):
    """general_utils.py:115-119: seed Python's, numpy's and torch's global
    generators (the render's own samples come from explicit generators)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
