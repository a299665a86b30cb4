"""Quaternion utilities (Hamilton, scalar-first: q = (r, x, y, z))."""

from __future__ import annotations

import torch

from .precision import norm, rounded


def normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / (norm(q, keepdim=True) + eps)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, scalar-first."""
    ar, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    br, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        ar * br - ax * bx - ay * by - az * bz,
        ar * bx + ax * br + ay * bz - az * by,
        ar * by - ax * bz + ay * br + az * bx,
        ar * bz + ax * by - ay * bx + az * br,
    ], dim=-1)


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


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit scalar-first quaternion (Shepperd's
    method: the branch of the largest of the trace and the diagonal), in
    the JAX package's operation order; sqrt through `rounded`."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return rounded(torch.sqrt, torch.clamp(x, min=1e-12)) * 2.0

    s = s_of(tr + 1.0)
    case0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                         (m10 - m01) / s], dim=-1)
    s = s_of(1.0 + m00 - m11 - m22)
    case1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                         (m02 + m20) / s], dim=-1)
    s = s_of(1.0 + m11 - m00 - m22)
    case2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                         (m12 + m21) / s], dim=-1)
    s = s_of(1.0 + m22 - m00 - m11)
    case3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s,
                         (m12 + m21) / s, 0.25 * s], dim=-1)
    q = torch.where(
        (tr > 0.0)[..., None], case0,
        torch.where(((m00 >= m11) & (m00 >= m22))[..., None], case1,
                    torch.where((m11 >= m22)[..., None], case2, case3)))
    return normalize(q)
