"""GaussianScene - the raw parameter store (twin of the JAX
scene/gaussian_scene.py).

Activations: scaling exp, opacity sigmoid, rotation normalize, diffuse relu,
normal identity, f0/roughness clipped relu.  Dynamic Gaussian counts are
handled with a padded capacity + live mask, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
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


def pad_to(scene: GaussianScene, capacity: int) -> GaussianScene:
    """Grow the padded capacity with dead rows (as the JAX pad_to fills)."""
    n = scene.capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current {n}")
    if capacity == n:
        return scene
    extra = capacity - n

    def pad(a, fill=0.0):
        tail = torch.full((extra,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail], dim=0)

    rotation = pad(scene.rotation)
    rotation[n:, 0] = 1.0
    return GaussianScene(
        xyz=pad(scene.xyz),
        scaling=pad(scene.scaling, fill=-10.0),
        rotation=rotation,
        opacity=pad(scene.opacity, fill=-10.0),
        diffuse=pad(scene.diffuse),
        normal=pad(scene.normal),
        f0=pad(scene.f0),
        roughness=pad(scene.roughness),
        live_mask=pad(scene.live_mask, fill=False),
    )


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def from_arrays(xyz, scaling, rotation, opacity, diffuse, normal, f0,
                roughness, pad_multiple: int = 2048,
                device: torch.device | str = DEFAULT_DEVICE) -> GaussianScene:
    """Build a scene from numpy arrays, padding N to a chunk multiple (on
    the card unless `device` says otherwise)."""
    device = resolve_device(device)
    n = xyz.shape[0]

    def f32(a, shape=None):
        t = torch.as_tensor(np.asarray(a, np.float32), device=device)
        return t if shape is None else t.reshape(shape)

    scene = GaussianScene(
        xyz=f32(xyz), scaling=f32(scaling), rotation=f32(rotation),
        opacity=f32(opacity, (n,)), diffuse=f32(diffuse), normal=f32(normal),
        f0=f32(f0), roughness=f32(roughness, (n,)),
        live_mask=torch.ones((n,), dtype=torch.bool, device=device),
    )
    return pad_to(scene, round_up(n, pad_multiple))


def from_numpy(params: dict[str, np.ndarray],
               device: torch.device | str = DEFAULT_DEVICE) -> GaussianScene:
    """Carry a scene across field by field, padded rows and live_mask
    included (e.g. ``{f: np.asarray(getattr(jax_scene, f)) for f in
    GaussianScene._fields}``)."""
    device = resolve_device(device)
    fields = {}
    for name in GaussianScene._fields:
        a = np.asarray(params[name])
        dtype = torch.bool if name == "live_mask" else torch.float32
        fields[name] = torch.tensor(a, dtype=dtype, device=device)
    return GaussianScene(**fields)


def num_live(scene: GaussianScene) -> int:
    """How many slots hold a live Gaussian."""
    return int(scene.live_mask.sum().item())
