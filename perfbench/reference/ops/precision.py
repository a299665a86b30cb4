"""The port's float policy, held in one place.

The render takes hard decisions on float values: a hit counts when sq <= 1,
a tile stops when log T <= log threshold, the K-th hit wins, a ray dies
below a normal length.  Near-mirror bounces multiply a difference about 10x
per bounce.  So one ulp between two implementations does not stay small.

The port computes in float32, in the JAX package's operation order, as the
TPU kernels do.  Single float32 operations round alike on every device.
Three things would still round differently on a CPU and a GPU, and this
module handles them:

* Transcendental functions (exp, log, tan, sin, cos, pow, sigmoid) and
  sqrt: each device's math library has its own last-bit errors (PyTorch's
  float32 sqrt on a GPU is not correctly rounded).  `rounded` evaluates
  them in float64 and rounds once to float32.  That is the correctly
  rounded value almost always, on any device.
* Division by a host scalar: a GPU multiplies by the scalar's reciprocal,
  which is not the rounded quotient.  `div` divides by a tensor instead.
* Sums whose order a device picks: `dot`, `norm` and `cross3` spell out
  their order in separate float32 operations, which a GPU kernel cannot
  contract into FMAs.  The culling's reductions over clusters and tiles
  accumulate in `WIDE` and round once.

The render kernel keeps the same rules (csrc/render_culled.cu).
"""

from __future__ import annotations

import torch

WIDE = torch.float64


def rounded(fn, *args, **kwargs) -> torch.Tensor:
    """`fn` evaluated in WIDE on the tensor arguments, rounded once to
    float32."""
    wide = [a.to(WIDE) if isinstance(a, torch.Tensor) else a for a in args]
    return fn(*wide, **kwargs).to(torch.float32)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one IEEE division on every device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the (short) last axis, summed left to right."""
    s = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i] * b[..., i]
    return s


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the (short) last axis."""
    n = rounded(torch.sqrt, dot(v, v))
    return n[..., None] if keepdim else n


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (size 3)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


