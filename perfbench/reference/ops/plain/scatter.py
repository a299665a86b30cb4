"""The gradient scatter in plain PyTorch: the contract of the port's
scatter_grads kernel (a frozen copy of its plain version,
ops/cuda/scatter.py): acc[ids[i]] += payload[i] in float64, for ids >= 0."""

from __future__ import annotations

import torch


def scatter_add(acc: torch.Tensor, payload: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """acc [N, C] float64 += payload [M, C] float32 rows by ids [M] int32
    (-1 = skip).  In place; returns acc."""
    keep = ids >= 0
    acc.index_add_(0, ids[keep].to(torch.int64), payload[keep].to(acc.dtype))
    return acc
