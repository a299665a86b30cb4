"""General helpers (the numpy-only part of the JAX package's
utils/general.py, copied so the port never imports that package, set_seeds
and mean_dist2_knn3)."""

from __future__ import annotations

import random

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


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


def mean_dist2_knn3(points: np.ndarray, chunk: int = 2048,
                    device: torch.device | str = DEFAULT_DEVICE
                    ) -> np.ndarray:
    """Mean squared distance of each point to its 3 nearest neighbours
    (the simple-knn `distCUDA2` the reference sizes initial scales with,
    reference scene/gaussian_model.py:197-201), as float32 numpy.

    Brute force on `device` in chunks of `chunk` query rows ([chunk, N] at
    a time), as the JAX package does: the squared distances summed x + y + z
    in separate float32 operations (ops/precision.py: no cdist, no FMA),
    the 4 smallest kept and the first (the point itself) dropped, the mean
    of the other 3 as XLA computes it."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    n = pts.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32)
    cols = [pts[:, i] for i in range(3)]
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=dev)
    out = []
    for c0 in range(0, n, chunk):
        q = pts[c0:c0 + chunk]
        d2 = (q[:, 0, None] - cols[0]).square()
        d2 += (q[:, 1, None] - cols[1]).square()
        d2 += (q[:, 2, None] - cols[2]).square()
        near = torch.topk(d2, 4, dim=1, largest=False).values
        del d2
        # XLA's mean: the sum times float32(1/3)
        out.append((near[:, 1] + near[:, 2] + near[:, 3]) * third)
    return torch.cat(out).cpu().numpy()
