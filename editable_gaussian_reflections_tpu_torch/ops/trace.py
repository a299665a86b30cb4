"""Per-ray hit records (twin of the JAX ops/trace.py RayHits).

Only the container is ported: the training step fills it from the slots
kernel's output (ops/cuda/layout.py unpack_slots).  The brute-force
trace_rays of the non-fused path is not ported yet (ROADMAP.md Queue 1,
item 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
