"""GaussianScene - the raw parameter store (twin of the JAX
scene/gaussian_scene.py).

Activations: scaling exp, opacity sigmoid, rotation normalize, diffuse relu,
normal identity, f0/roughness clipped relu.  Dynamic Gaussian counts are
handled with a padded capacity + live mask, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.activations import clipped_relu_act, relu_act, sigmoid_act
from ..ops.gaussian_kernel import compute_scaling_factor
from ..ops.intersect import GaussianFrames
from ..ops.precision import norm, rounded
from ..ops.quaternion import quat_to_rotmat


class GaussianScene(NamedTuple):
    """Raw parameters; leading dim N (possibly padded - see live_mask)."""

    xyz: torch.Tensor        # [N, 3]
    scaling: torch.Tensor    # [N, 3] log-scale
    rotation: torch.Tensor   # [N, 4] unnormalized quaternion (r, x, y, z)
    opacity: torch.Tensor    # [N] logit
    diffuse: torch.Tensor    # [N, 3] raw rgb (relu-activated)
    normal: torch.Tensor     # [N, 3] world-space (identity activation)
    f0: torch.Tensor         # [N, 3] raw (clipped-relu)
    roughness: torch.Tensor  # [N] raw (clipped-relu)
    live_mask: torch.Tensor  # [N] bool - False for padded/pruned slots

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


class SceneAttributes(NamedTuple):
    """Activated per-Gaussian shading attributes."""

    rgb: torch.Tensor        # [N, 3]
    normal: torch.Tensor     # [N, 3]
    f0: torch.Tensor         # [N, 3]
    roughness: torch.Tensor  # [N]

    def take(self, idx: torch.Tensor) -> "SceneAttributes":
        return SceneAttributes(*(a[idx] for a in self))


def build_frames(scene: GaussianScene, alpha_threshold: float,
                 exp_power: float, global_scale_factor: float = 1.0):
    """Activated geometry for tracing + activated shading attributes.

    Degenerate Gaussians (sf == 0 or zero sizes) get valid=False.  The
    activations' transcendentals follow ops/precision.py, so a CPU and a GPU
    render of one scene trace bit-identical Gaussians."""
    opacity = rounded(sigmoid_act, scene.opacity)
    sf = rounded(compute_scaling_factor, opacity, alpha_threshold, exp_power)
    s = rounded(torch.exp, scene.scaling)
    sizes = s * (sf * global_scale_factor)[:, None]
    degenerate = (sf <= 0.0) | torch.all(sizes <= 0.0, dim=-1)
    valid = scene.live_mask & ~degenerate
    inv_sizes = torch.where(sizes > 0.0,
                            1.0 / torch.clamp(sizes, min=1e-30),
                            torch.zeros_like(sizes))
    q = scene.rotation
    rot = quat_to_rotmat(q / norm(q, keepdim=True))
    frames = GaussianFrames(mean=scene.xyz, rot=rot, inv_sizes=inv_sizes,
                            sf=sf, opacity=opacity, normal=scene.normal,
                            valid=valid)
    attrs = SceneAttributes(
        rgb=relu_act(scene.diffuse),
        normal=scene.normal,
        f0=clipped_relu_act(scene.f0),
        roughness=clipped_relu_act(scene.roughness),
    )
    return frames, attrs
