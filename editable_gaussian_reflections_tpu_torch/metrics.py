"""Metrics CLI - twin of the root metrics.py (reference metrics.py:31-73).

    python -m editable_gaussian_reflections_tpu_torch.metrics -m <model_path> \\
        [--metrics psnr ssim msssim lpips] [--render_passes ...] \\
        [--split test] [--iteration 8000] [--num_frames 100] [--device cpu]

PSNR, SSIM and MS-SSIM (scipy, as the root file) and LPIPS over the saved
render/diffuse/specular PNGs, read with utils/image.read_png (no imaging
package); writes metrics.json in the root file's schema.  LPIPS is the
published VGG LPIPS when its two checkpoints are on disk
(PretrainedVGGLPIPS; nothing is downloaded), else the seed-0 random-VGG
substitute, reported as "lpips_rand".  Both networks run on the card
unless `--device cpu`, through F.conv2d / F.max_pool2d with TF32 off: the
JAX package computes them with lax.conv outside any Pallas kernel.
Without a card and without `--device cpu` the CLI exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dataset.image_utils import pil_samples
from .device import DEFAULT_DEVICE, resolve_device
from .utils.image import read_png


def psnr_metric(pred, gt):
    m = np.mean((pred - gt) ** 2)
    return 100.0 if m == 0 else float(20.0 * np.log10(1.0 / np.sqrt(m)))


def ssim_metric(pred, gt, C1=0.01**2, C2=0.03**2, win=11, sigma=1.5):
    """Gaussian-windowed SSIM (matches torchmetrics defaults)."""
    from scipy.ndimage import gaussian_filter

    def chan(p, g):
        mu_p = gaussian_filter(p, sigma, truncate=(win // 2) / sigma)
        mu_g = gaussian_filter(g, sigma, truncate=(win // 2) / sigma)
        mu_p2, mu_g2, mu_pg = mu_p**2, mu_g**2, mu_p * mu_g
        sp = gaussian_filter(p * p, sigma, truncate=(win // 2) / sigma) - mu_p2
        sg = gaussian_filter(g * g, sigma, truncate=(win // 2) / sigma) - mu_g2
        spg = gaussian_filter(p * g, sigma, truncate=(win // 2) / sigma) - mu_pg
        num = (2 * mu_pg + C1) * (2 * spg + C2)
        den = (mu_p2 + mu_g2 + C1) * (sp + sg + C2)
        return np.mean(num / den)

    return float(np.mean([chan(pred[..., c], gt[..., c]) for c in range(pred.shape[-1])]))


def _ssim_cs(pred, gt, C1=0.01**2, C2=0.03**2, win=11, sigma=1.5):
    """Per-channel mean (ssim, contrast-structure) pair for MS-SSIM."""
    from scipy.ndimage import gaussian_filter

    tr = (win // 2) / sigma
    s_vals, cs_vals = [], []
    for c in range(pred.shape[-1]):
        p, g = pred[..., c], gt[..., c]
        mu_p = gaussian_filter(p, sigma, truncate=tr)
        mu_g = gaussian_filter(g, sigma, truncate=tr)
        mu_p2, mu_g2, mu_pg = mu_p**2, mu_g**2, mu_p * mu_g
        sp = gaussian_filter(p * p, sigma, truncate=tr) - mu_p2
        sg = gaussian_filter(g * g, sigma, truncate=tr) - mu_g2
        spg = gaussian_filter(p * g, sigma, truncate=tr) - mu_pg
        cs = (2 * spg + C2) / (sp + sg + C2)
        lum = (2 * mu_pg + C1) / (mu_p2 + mu_g2 + C1)
        s_vals.append(np.mean(lum * cs))
        cs_vals.append(np.mean(cs))
    return float(np.mean(s_vals)), float(np.mean(cs_vals))


MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)  # Wang et al. 2003


def msssim_metric(pred, gt):
    """Multi-scale SSIM, the standard 5-scale protocol: contrast-structure
    at every scale, luminance only at the coarsest, 2x average-pool between
    scales."""
    vals = []
    p, g = pred, gt
    for i, w in enumerate(MSSSIM_WEIGHTS):
        s, cs = _ssim_cs(p, g)
        vals.append(max(s if i == len(MSSSIM_WEIGHTS) - 1 else cs, 1e-6))
        if i < len(MSSSIM_WEIGHTS) - 1:
            h, wd = (p.shape[0] // 2) * 2, (p.shape[1] // 2) * 2
            p = p[:h, :wd].reshape(h // 2, 2, wd // 2, 2, -1).mean((1, 3))
            g = g[:h, :wd].reshape(h // 2, 2, wd // 2, 2, -1).mean((1, 3))
    return float(np.prod([v**w for v, w in zip(vals, MSSSIM_WEIGHTS)]))


def _unit_channels(x: torch.Tensor) -> torch.Tensor:
    """Features divided by their channel norm (NCHW), as LPIPS does."""
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-10)


class _LPIPSBase(nn.Module):
    """What both LPIPS networks share: [H, W, 3] numpy images in [0, 1] to
    one float, on the module's device, convolutions without TF32."""

    def _images(self, pred, gt):
        dev = self.shift.device
        return [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                .permute(2, 0, 1)[None] for a in (pred, gt)]

    def __call__(self, pred, gt) -> float:
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            return float(self.forward(*self._images(pred, gt)))


class RandomVGGLPIPS(_LPIPSBase):
    """Offline-capable LPIPS substitute (metrics.py:82-154 of the root file;
    reference metrics.py:31-73 uses torchmetrics LPIPS with pretrained VGG
    weights, which are not fetched here).

    A VGG-16-topology feature stack with deterministic He-initialized random
    weights (seed 0, drawn with numpy exactly as the root file draws them)
    and LPIPS-style scoring: per-layer unit-normalized channel features,
    squared differences averaged over space and summed over channels and
    layers.  Absolute values are NOT comparable to pretrained-LPIPS numbers,
    so metrics.json labels the field "lpips_rand"."""

    CHANNELS = (64, 128, 256, 512, 512)
    BLOCKS = (2, 2, 3, 3, 3)

    def __init__(self, seed: int = 0,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.weights = []          # HWIO numpy, as the root file keeps them
        convs = []
        cin = 3
        for cout, blocks in zip(self.CHANNELS, self.BLOCKS):
            layer = []
            for _ in range(blocks):
                w = rng.normal(
                    0.0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout)
                ).astype(np.float32)
                layer.append(w)
                convs.append(nn.Parameter(torch.from_numpy(
                    np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                    requires_grad=False))
                cin = cout
            self.weights.append(layer)
        self.convs = nn.ParameterList(convs)
        self.register_buffer("shift", torch.tensor(
            [0.485, 0.456, 0.406]).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(
            [0.229, 0.224, 0.225]).view(1, 3, 1, 1))
        self.to(resolve_device(device))

    def features(self, x):
        x = (x - self.shift) / self.scale
        feats, i = [], 0
        for bi, blocks in enumerate(self.BLOCKS):
            if bi:
                # the root file also pools after the last block, unused
                x = F.max_pool2d(x, 2)
            for _ in range(blocks):
                x = F.relu(F.conv2d(x, self.convs[i], padding=1))
                i += 1
            feats.append(x)
        return feats

    def forward(self, a, b):
        total = 0.0
        for xa, xb in zip(self.features(a), self.features(b)):
            d = (_unit_channels(xa) - _unit_channels(xb)) ** 2
            total = total + torch.mean(torch.sum(d, dim=1))
        return total


class PretrainedVGGLPIPS(_LPIPSBase):
    """The published LPIPS (Zhang et al. 2018) in the reference's
    torchmetrics-VGG configuration, from two checkpoint files on disk:

      - the torchvision VGG16 backbone state_dict (``vgg16-397923af.pth``;
        env LPIPS_VGG_WEIGHTS or
        ~/.cache/torch/hub/checkpoints/vgg16-397923af.pth), and
      - the LPIPS v0.1 linear heads (``vgg.pth`` from the lpips package; env
        LPIPS_LIN_WEIGHTS, <site-packages>/lpips/weights/v0.1/vgg.pth or
        ~/.cache/lpips/vgg.pth).

    Input [0,1] -> [-1,1] -> ScalingLayer -> VGG16 features at
    relu1_2/relu2_2/relu3_3/relu4_3/relu5_3 -> channel-unit-normalize ->
    squared difference -> 1x1 nonnegative linear head -> spatial mean ->
    sum over the 5 taps.  ``available()`` gates its use; metrics.json then
    keeps the field "lpips"."""

    SHIFT = (-0.030, -0.088, -0.188)
    SCALE = (0.458, 0.448, 0.450)
    BLOCKS = (2, 2, 3, 3, 3)  # convs per tap block (VGG16)

    @staticmethod
    def _vgg_path():
        p = os.environ.get("LPIPS_VGG_WEIGHTS") or os.path.expanduser(
            "~/.cache/torch/hub/checkpoints/vgg16-397923af.pth")
        return p if os.path.exists(p) else None

    @staticmethod
    def _lin_path():
        cands = [os.environ.get("LPIPS_LIN_WEIGHTS"),
                 os.path.expanduser("~/.cache/lpips/vgg.pth")]
        try:
            import lpips as _lp  # noqa: F401 - optional
            cands.append(os.path.join(os.path.dirname(_lp.__file__),
                                      "weights", "v0.1", "vgg.pth"))
        except ImportError:
            pass
        for p in cands:
            if p and os.path.exists(p):
                return p
        return None

    @classmethod
    def available(cls) -> bool:
        return cls._vgg_path() is not None and cls._lin_path() is not None

    def __init__(self, vgg_path=None, lin_path=None,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__()
        vgg_path = vgg_path or self._vgg_path()
        lin_path = lin_path or self._lin_path()
        if not vgg_path or not lin_path:
            raise FileNotFoundError(
                "LPIPS checkpoints not found (see PretrainedVGGLPIPS "
                "docstring for the expected locations)")
        vgg = torch.load(vgg_path, map_location="cpu", weights_only=True)
        lin = torch.load(lin_path, map_location="cpu", weights_only=True)
        # torchvision layout: features.<idx>.weight [out, in, 3, 3] with
        # idx skipping ReLU/MaxPool slots; collect convs in order.
        conv_ids = sorted(
            {int(k.split(".")[1]) for k in vgg if k.startswith("features.")
             and k.endswith(".weight")})
        if len(conv_ids) != sum(self.BLOCKS):
            raise ValueError(f"expected VGG16 ({sum(self.BLOCKS)} convs), "
                             f"got {len(conv_ids)}")
        self.conv_w = nn.ParameterList(
            nn.Parameter(vgg[f"features.{i}.weight"].float(),
                         requires_grad=False) for i in conv_ids)
        self.conv_b = nn.ParameterList(
            nn.Parameter(vgg[f"features.{i}.bias"].float(),
                         requires_grad=False) for i in conv_ids)
        # lpips lin heads: lin<k>.model.1.weight [1, C, 1, 1]
        lins = []
        for k in range(5):
            for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
                if key in lin:
                    lins.append(nn.Parameter(
                        lin[key].float().reshape(1, -1, 1, 1),
                        requires_grad=False))
                    break
            else:
                raise KeyError(f"lin{k} head missing from {lin_path}")
        self.lins = nn.ParameterList(lins)
        self.register_buffer("shift", torch.tensor(self.SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(self.SCALE).view(1, 3, 1, 1))
        self.to(resolve_device(device))

    def features(self, x):
        x = (2.0 * x - 1.0 - self.shift) / self.scale
        feats, i = [], 0
        for bi, blocks in enumerate(self.BLOCKS):
            if bi:
                x = F.max_pool2d(x, 2)
            for _ in range(blocks):
                x = F.relu(F.conv2d(x, self.conv_w[i], self.conv_b[i],
                                    padding=1))
                i += 1
            feats.append(x)
        return feats

    def forward(self, a, b):
        total = 0.0
        for xa, xb, lw in zip(self.features(a), self.features(b), self.lins):
            d = (_unit_channels(xa) - _unit_channels(xb)) ** 2 * lw
            total = total + torch.mean(torch.sum(d, dim=1))
        return total


def read_rgb(path) -> np.ndarray:
    """An 8-bit PNG as float32 RGB in [0, 1], as
    np.asarray(Image.open(path).convert("RGB")) / 255 reads it."""
    a = pil_samples(read_png(path))
    if a.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit gray, not an 8-bit image")
    if a.ndim == 2:
        a = a[..., None]
    a = a[..., :1].repeat(3, -1) if a.shape[-1] in (1, 2) else a[..., :3]
    return a.astype(np.float32) / 255.0


def main(argv=None):
    p = argparse.ArgumentParser(prog="metrics", allow_abbrev=False)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--render_passes", nargs="*",
                   default=["diffuse", "specular", "render"])
    p.add_argument("--metrics", nargs="*", default=["psnr"])
    p.add_argument("--split", default="test")
    p.add_argument("--iteration", type=int, default=8000)
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="cuda or cpu: where the LPIPS network runs")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    scores = {rp: {m: 0.0 for m in args.metrics} for rp in args.render_passes}
    counts = {rp: 0 for rp in args.render_passes}
    base = os.path.join(args.model_path, args.split, f"ours_{args.iteration}")
    lpips = None
    lpips_real = False
    if "lpips" in args.metrics:
        if PretrainedVGGLPIPS.available():
            lpips, lpips_real = PretrainedVGGLPIPS(device=dev), True
        else:
            lpips = RandomVGGLPIPS(device=dev)

    for rp in args.render_passes:
        pred_dir = os.path.join(base, rp)
        gt_dir = os.path.join(base, rp + "_gt")
        if not os.path.isdir(pred_dir):
            continue
        for i in range(args.num_frames):
            pf = os.path.join(pred_dir, f"{i:05d}_{rp}.png")
            gf = os.path.join(gt_dir, f"{i:05d}_{rp}.png")
            if not (os.path.exists(pf) and os.path.exists(gf)):
                continue
            pred = read_rgb(pf)
            gt = read_rgb(gf)
            counts[rp] += 1
            if "psnr" in args.metrics:
                scores[rp]["psnr"] += psnr_metric(pred, gt)
            if "ssim" in args.metrics:
                scores[rp]["ssim"] += ssim_metric(pred, gt)
            if "msssim" in args.metrics:
                scores[rp]["msssim"] += msssim_metric(pred, gt)
            if lpips is not None:
                scores[rp]["lpips"] += lpips(pred, gt)

    for rp in args.render_passes:
        for m in list(scores[rp]):
            if counts[rp]:
                scores[rp][m] = round(scores[rp][m] / counts[rp], 4)
        if "lpips" in scores[rp] and not lpips_real:
            # random-weight substitute - flag it so numbers are never
            # mistaken for pretrained-VGG LPIPS (see RandomVGGLPIPS);
            # with the real checkpoints on disk the field stays "lpips"
            scores[rp]["lpips_rand"] = scores[rp].pop("lpips")

    print(json.dumps(scores, indent=4))
    with open(os.path.join(args.model_path, "metrics.json"), "w") as f:
        json.dump(scores, f, indent=4)
    return scores


if __name__ == "__main__":
    main()
