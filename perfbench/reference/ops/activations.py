"""Parameter activations and the backward twins training uses (twin of the
JAX ops/activations.py).

The backward twins follow the reference's hand-written backward
(activations.cu): they take the *activated* value, which is why the
loss-fused backward leaves the relu/clipped-relu gradients as a pass-through
(ops/render_grads.py calls no backward for them, as the reference does).
The softplus, exp, identity and normalize pairs are kept for parity with
the JAX module; no render or training path calls them.
"""

from __future__ import annotations

import torch

from .precision import dot, norm


def sigmoid_act(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def backward_sigmoid_act(dL_dy: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """y is the activated value (activations.cu:8)."""
    return dL_dy * y * (1.0 - y)


def relu_act(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def clipped_relu_act(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def backward_normalize_act(dL_dy: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of x/|x| evaluated at the raw x (activations.cu:76-78).

    ``y`` (the normalized value) is accepted for signature parity; the
    reference recomputes everything from ``x``.  The 4-vector sums are
    spelled out (ops/precision.py), so every device rounds alike."""
    n = norm(x, keepdim=True)
    d = dot(dL_dy, x)[..., None]
    return d * (-x) / (n * n * n) + dL_dy / n
