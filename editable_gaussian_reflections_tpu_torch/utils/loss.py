"""Loss helpers (twin of the JAX package's utils/loss.py; reference
utils/loss_utils.py: l1/l2/ssim).

As in the reference these serve evaluation only; the training loss lives
fused inside the render backward (ops/render_grads.py).  Images are HWC
tensors; the SSIM's blur is a separable Gaussian, two depthwise
convolutions with zero padding, as the JAX package's lax.conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.precision import WIDE, rounded


def l1_loss(network_output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(network_output - gt).mean()


def l2_loss(network_output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((network_output - gt) ** 2).mean()


def gaussian_window(window_size: int, sigma: float,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    x = (torch.arange(window_size, dtype=torch.float32, device=device)
         - window_size // 2)
    g = rounded(torch.exp, -(x ** 2) / (2 * sigma ** 2))
    return (g.to(WIDE) / g.to(WIDE).sum()).to(torch.float32)


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur over HWC via depthwise convolutions."""
    k = w.shape[0]
    c = x.shape[-1]
    img = x.movedim(-1, 0)[None]                       # [1, C, H, W]
    kh = w.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = w.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    out = F.conv2d(img, kh, padding=(k // 2, 0), groups=c)
    out = F.conv2d(out, kw, padding=(0, k // 2), groups=c)
    return out[0].movedim(0, -1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, C1: float = 0.01 ** 2,
         C2: float = 0.03 ** 2) -> torch.Tensor:
    """SSIM over HWC [0, 1] images (Gaussian window, torchmetrics
    defaults)."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    w = gaussian_window(window_size, sigma, img1.device)
    mu1, mu2 = _blur(img1, w), _blur(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _blur(img1 * img1, w) - mu1_sq
    s2 = _blur(img2 * img2, w) - mu2_sq
    s12 = _blur(img1 * img2, w) - mu12
    num = (2 * mu12 + C1) * (2 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return (num / den).mean()
