"""Quaternion utilities (Hamilton, scalar-first: q = (r, x, y, z))."""

from __future__ import annotations

import torch

from .precision import norm


def normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / (norm(q, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) normalized quaternion -> (..., 3, 3) rotation matrix.

    Columns are the images of the local basis vectors: world = R @ local."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
         2.0 * (x * z + r * y)], dim=-1)
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
         2.0 * (y * z - r * x)], dim=-1)
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
         1.0 - 2.0 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


