"""Learned kernel-predicting denoiser for the GGX specular residual (twin
of the JAX package's renderer/denoise_net.py).

A small dilated-conv network (9 -> 32 -> 32 -> 32 -> 32 -> 25 channels,
dilations 1, 2, 4, 8, 1) predicts a per-pixel 5x5 filter kernel,
softmax-normalized, applied to the demodulated specular pass (final -
diffuse) and guided by the noise-free primary G-buffer: the analog of the
reference's OptiX HDR ML denoiser (cuda/csrc/optix/denoiser_wrapper.h).

Images are [H, W, C] tensors on any device.  The weights are data: the
JAX package's `assets/denoise_kpn_v1.npz` (HWIO, as JAX stores them), read
by path.  The convolutions are `F.conv2d` (JAX computes them outside any
kernel of its own) with TF32 off (`full_f32_matmuls`).  Feature windows
wrap around the image as JAX's `roll` does; the 5x5 kernel clamps at the
edges as JAX's edge padding does.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import norm
from .raytracer import full_f32_matmuls

# layer widths: 9 -> 32 -> 32 -> 32 -> 32 -> 25 (5x5 kernel logits)
_CHANNELS = (9, 32, 32, 32, 32, 25)
_DILATIONS = (1, 2, 4, 8, 1)
KSIZE = 5
WEIGHTS_ENV = "EGR_DENOISE_WEIGHTS"
_DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "editable_gaussian_reflections_tpu", "assets", "denoise_kpn_v1.npz")


def init_params(generator: torch.Generator) -> dict:
    """He-initialized weights [3, 3, cin, cout] (HWIO) and zero biases, on
    the generator's device."""
    dev = generator.device
    params = {}
    for i in range(len(_CHANNELS) - 1):
        cin, cout = _CHANNELS[i], _CHANNELS[i + 1]
        scale = float(np.sqrt(2.0 / (cin * 9)))
        params[f"w{i}"] = torch.randn((3, 3, cin, cout), generator=generator,
                                      device=dev) * scale
        params[f"b{i}"] = torch.zeros((cout,), device=dev)
    return params


def _conv(x, w, b, dilation):
    """SAME 3x3 convolution of [H, W, Cin] by HWIO weights."""
    out = F.conv2d(x.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1),
                   padding=dilation, dilation=dilation)[0]
    return out.permute(1, 2, 0) + b[None, None, :]


def _mad(lum):
    """3x3 box mean and mean absolute deviation of [H, W] luminance, the
    window wrapping around the image."""
    box = torch.zeros_like(lum)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            box = box + torch.roll(lum, (-dy, -dx), dims=(0, 1))
    box = box / 9.0
    mad = torch.zeros_like(lum)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            mad = mad + torch.abs(torch.roll(lum, (-dy, -dx), dims=(0, 1))
                                  - box)
    return box, mad / 9.0


def unit_normals(normal):
    """normal / max(|normal|, 1e-6) over the last axis."""
    return normal / torch.clamp(norm(normal, keepdim=True), min=1e-6)


def features(spec, normal, depth, rough):
    """[H,W,9] feature stack from the noisy specular + primary G-buffer."""
    _box, mad = _mad(spec.mean(-1))
    return torch.cat([
        torch.log1p(torch.clamp(spec, min=0.0)),     # compressed HDR radiance
        unit_normals(normal),
        (1.0 / (1.0 + torch.clamp(depth, min=0.0)))[..., None],
        torch.clamp(rough, 0.0, 1.0)[..., None],
        torch.log1p(mad)[..., None],
    ], dim=-1)


def apply_net(params, feat):
    """[H,W,9] -> [H,W,25] kernel logits."""
    x = feat
    for i, dil in enumerate(_DILATIONS):
        x = _conv(x, params[f"w{i}"], params[f"b{i}"], dil)
        if i < len(_DILATIONS) - 1:
            x = torch.relu(x)
    return x


def apply_kernel(spec, logits):
    """Apply per-pixel softmax(5x5) kernels to the specular image, the
    neighbours clamped at the image's edges."""
    H, W, _ = spec.shape
    r = KSIZE // 2
    pad = F.pad(spec.permute(2, 0, 1)[None], (r, r, r, r),
                mode="replicate")[0].permute(1, 2, 0)
    k = torch.softmax(logits, dim=-1)
    out = torch.zeros_like(spec)
    idx = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = pad[r + dy:r + dy + H, r + dx:r + dx + W]
            out = out + nb * k[..., idx:idx + 1]
            idx += 1
    return out


def denoise_specular_learned(params, spec, normal, depth, rough, spp=1.0):
    """Filtered specular residual, with the SPP-aware back-off of the
    a-trous path, and mirror-like pixels (roughness below 0.02, full filter
    from 0.08) kept raw."""
    full_f32_matmuls()
    feat = features(spec, normal, depth, rough)
    logits = apply_net(params, feat)
    filtered = apply_kernel(spec, logits)
    s = torch.tensor(spp, dtype=torch.float32)
    w_spp = (1.0 / (1.0 + (s / 24.0) ** 2)).to(spec.device)
    w_rough = torch.clamp((torch.clamp(rough, 0.0, 1.0) - 0.02) / 0.06,
                          0.0, 1.0)[..., None]
    return spec + (w_spp * w_rough) * (filtered - spec)


def save_params(params, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_params(path=None, device: torch.device | str = "cpu"):
    """The shipped weights (or `path`, or $EGR_DENOISE_WEIGHTS) as float32
    tensors on `device`; None when the file is absent."""
    path = path or os.environ.get(WEIGHTS_ENV) or _DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: torch.tensor(data[k], dtype=torch.float32, device=device)
                for k in data.files}
