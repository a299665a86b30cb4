"""Primary-ray generation (twin of the JAX ops/camera_rays.py).

A pinhole camera parameterized by vertical FoV + aspect, NDC computed from
pixel centers, rotated to world with the columns of c2w:

    dir_world = normalize(c2w @ [x_ndc, y_ndc, -1])
"""

from __future__ import annotations

import torch

from .precision import div, norm, rounded


def primary_ray_directions(width: int, height: int, vertical_fov_radians,
                           c2w_rotation: torch.Tensor,
                           jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel world-space ray directions, shape (H, W, 3), normalized.

    c2w_rotation: (3, 3) camera-to-world rotation (its device and dtype are
      the output's).
    jitter: optional (H, W, 2) sub-pixel offsets in [-0.5, 0.5), x then y
      (the caller draws them; the JAX package draws them from a key).
    """
    dev, dtype = c2w_rotation.device, c2w_rotation.dtype
    # the FoV is held in float32, as in the JAX package
    fov = torch.as_tensor(vertical_fov_radians, dtype=dtype, device=dev)
    view_size = rounded(torch.tan, fov / 2.0).to(dtype)
    aspect_ratio = width / height

    iy = torch.arange(height, dtype=dtype, device=dev)[:, None].expand(
        height, width)
    ix = torch.arange(width, dtype=dtype, device=dev)[None, :].expand(
        height, width)
    if jitter is not None:
        ix = ix + jitter[..., 0]
        iy = iy + jitter[..., 1]

    y = view_size * (1.0 - div(2.0 * (iy + 0.5), height))
    x = aspect_ratio * view_size * (div(2.0 * (ix + 0.5), width) - 1.0)

    # dir = c2w_col0 * x + c2w_col1 * y - c2w_col2  (camera.h:35)
    c2w = c2w_rotation
    d = c2w[:, 0] * x[..., None] + c2w[:, 1] * y[..., None] - c2w[:, 2]
    return d / norm(d, keepdim=True)
