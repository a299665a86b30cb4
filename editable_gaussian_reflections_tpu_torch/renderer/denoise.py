"""Edge-aware denoising of the GGX specular passes (twin of the JAX
package's renderer/denoise.py, the port's stand-in for the reference's
OptiX HDR denoiser, cuda/csrc/optix/denoiser_wrapper.h).

The Monte-Carlo noise at low spp lives only in the specular bounces: the
diffuse pass and the primary G-buffer are noise-free.  So the filter
demodulates, final = diffuse + filtered(final - diffuse), guided by the
primary G-buffer:
  * the learned KPN (renderer/denoise_net.py) when its weights are there
    and spp <= 4 (or `learned=True`);
  * else a separable a-trous filter with normal, depth, roughness and
    color edge-stopping, backed off by an SPP-aware blend (<1% at the
    reference's 128-spp eval point).
`learned=True` without weights falls back to the a-trous filter with a
warning, as in the JAX package.  Images are tensors on any device (numpy
arrays go to the CPU); the result is a float32 tensor on that device.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from . import denoise_net
from .denoise_net import _mad, unit_normals

_KERNEL = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def _atrous_specular(spec, normal, depth, rough, iterations=4,
                     sigma_normal=0.25, sigma_depth=0.5, spp=1.0):
    """`iterations` a-trous passes (steps 1, 2, 4, ...) over the [H, W, 3]
    specular image, windows wrapping around the image as JAX's `roll`
    does, then the noisy/filtered blend."""
    H, W, _ = spec.shape
    out = spec
    nrm = unit_normals(normal)
    rough = torch.clamp(rough, 0.0, 1.0)

    # the per-pixel noise estimate on the specular luminance: its 3x3 mean
    # absolute deviation drives the color sigma and the final blend
    box, mad = _mad(spec.mean(-1))
    # rough surfaces tolerate larger color deltas; mirror-like ones keep a
    # tight sigma so sharp reflected edges survive
    sigma_color = torch.clamp((1.0 + 7.0 * rough) * mad, min=1e-3)[..., None]

    def shift(a, sy, sx):
        return torch.roll(a, (-sy, -sx), dims=(0, 1))

    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wacc = torch.zeros((H, W, 1), dtype=out.dtype, device=out.device)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                k = float(_KERNEL[dy + 2] * _KERNEL[dx + 2])
                sy, sx = dy * step, dx * step
                sh_rgb = shift(out, sy, sx)
                sh_nrm = shift(nrm, sy, sx)
                sh_dep = shift(depth, sy, sx)
                sh_rgh = shift(rough, sy, sx)

                w_n = torch.exp(
                    -torch.clamp(1.0 - (nrm * sh_nrm).sum(-1), min=0.0)
                    / sigma_normal)
                w_d = torch.exp(-torch.abs(depth - sh_dep) / sigma_depth)
                # reflection sharpness changes across material edges
                w_r = torch.exp(-torch.abs(rough - sh_rgh) / 0.2)
                w_c = torch.exp(
                    -torch.abs(out - sh_rgb).sum(-1, keepdim=True)
                    / sigma_color)[..., 0]
                w = (k * w_n * w_d * w_r * w_c)[..., None]
                acc = acc + sh_rgb * w
                wacc = wacc + w
        out = acc / torch.clamp(wacc, min=1e-8)

    # full filtering only where the local noise is large against the signal
    # and the surface is rough enough for the GGX estimator to be noisy;
    # the SPP-aware prior backs off as the residual noise ~ 1/sqrt(spp)
    s = torch.tensor(spp, dtype=torch.float32)
    w_spp = (1.0 / (1.0 + (s / 6.0) ** 2)).to(spec.device)
    w_rough = torch.clamp(rough / 0.15, 0.0, 1.0)
    blend = (w_spp * w_rough * (mad / (mad + 0.02 * (1.0 + box))))[..., None]
    return spec + blend * (out - spec)


_LEARNED_PARAMS = "unset"
_PATH_LOGGED = False


def _learned_params():
    """The shipped KPN weights on the CPU, loaded once; None -> a-trous."""
    global _LEARNED_PARAMS
    if _LEARNED_PARAMS == "unset":
        _LEARNED_PARAMS = denoise_net.load_params()
    return _LEARNED_PARAMS


def _f32(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def denoise_specular(final_hwc, diffuse_hwc, normal_hwc, depth_hw,
                     rough_hw, iterations: int = 4,
                     spp: int = 1, learned: bool | None = None
                     ) -> torch.Tensor:
    """Demodulated denoise: final = diffuse + filtered(final - diffuse).

    `diffuse_hwc` is the primary-bounce radiance (steps.rgb[0]); the guides
    are the primary-hit G-buffer; all on `final_hwc`'s device.  The KPN
    runs when its weights exist, unless spp > 4 (out of its training
    domain it can hurt) or `learned=False` forces the a-trous path."""
    final = _f32(final_hwc)
    dev = final.device
    diffuse = _f32(diffuse_hwc, dev)
    spec = final - diffuse
    params = _learned_params() if learned in (None, True) else None
    # the KPN trains on 1-spp noise; route by sample count unless the
    # caller explicitly forces the learned path
    if learned is None and spp > 4:
        params = None
    if learned is True and params is None:
        # an explicit request for the learned path must not degrade silently
        warnings.warn(
            "denoise_specular(learned=True) but no KPN weights found "
            "(assets/denoise_kpn_v1.npz) - falling back to a-trous",
            stacklevel=2)
    global _PATH_LOGGED
    if not _PATH_LOGGED:
        _PATH_LOGGED = True
        logging.getLogger(__name__).info(
            "denoiser path: %s",
            "learned KPN" if params is not None else "a-trous")
    guides = (_f32(normal_hwc, dev), _f32(depth_hw, dev), _f32(rough_hw, dev))
    if params is not None:
        out = denoise_net.denoise_specular_learned(
            {k: v.to(dev) for k, v in params.items()}, spec, *guides,
            spp=float(spp))
    else:
        out = _atrous_specular(spec, *guides, iterations=iterations,
                               spp=float(spp))
    return diffuse + out


def atrous_denoise(rgb_hwc, normal_hwc, depth_hw, iterations: int = 3,
                   spp: int = 1) -> torch.Tensor:
    """The whole-image filter (kept for A/B in tools/denoiser_eval.py): the
    a-trous filter against a zero diffuse with roughness 1 everywhere."""
    rgb = _f32(rgb_hwc)
    dev = rgb.device
    depth = _f32(depth_hw, dev)
    return _atrous_specular(rgb, _f32(normal_hwc, dev), depth,
                            torch.ones_like(depth), iterations=iterations,
                            spp=float(spp))
