"""Hit records (frozen copy of the port's ops/trace.py, its RayHits
and gather_frames)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import GaussianFrames

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
