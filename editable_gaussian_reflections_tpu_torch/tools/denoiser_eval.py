"""Denoiser evidence: does each denoiser help at low spp? - twin of the root
tools/denoiser_eval.py.

    python -m editable_gaussian_reflections_tpu_torch.tools.denoiser_eval \\
        [--out /tmp/denoiser_eval.json] [--size 256] [--ref_spp 256] \\
        [--spp 1 8 32 128] [--device cpu]

Renders room_scene(100_000) from room_camera() (eval_scene) on the fused
k-buffer path (K 32, cluster 128, 128 candidates, at most 16 samples a
dispatch) at each `--spp` (seed 0) and at `--ref_spp` (seed 999, the
reference), and scores in tonemapped PSNR against the reference: the
plain image, the whole-image a-trous filter (legacy), the demodulated
a-trous filter (`denoise_specular(learned=False)`) and the default
denoiser (the KPN at spp <= 4).  The denoisers run on the scene's device.
Writes the JSON to `--out` (never the repository's denoiser_eval.json,
which is the JAX run's).  On the card unless `--device cpu`; without a
card and without it the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops.tonemap import tonemap
from ..renderer.denoise import atrous_denoise, denoise_specular
from ..utils.synth import camera_at, room, room_camera, room_frame

REF_SEED, SEED = 999, 0


def psnr(a, b):
    m = np.mean((a - b) ** 2)
    return float(20.0 * np.log10(1.0 / np.sqrt(max(m, 1e-12))))


def eval_scene(device: torch.device):
    """(scene, camera): room(device) seen from room_camera()."""
    scene = room(device)
    eye, c2w = room_camera()
    return scene, camera_at(eye, c2w, device)


def display(img) -> np.ndarray:
    return np.clip(tonemap(torch.as_tensor(img).float().cpu()).numpy(),
                   0, 1)


def scores(frame: dict, ref: np.ndarray, spp: int) -> dict:
    """The four PSNRs of one frame against the displayed reference."""
    img, nrm, dep = frame["final"], frame["normal"], frame["depth"]
    g = (frame["diffuse"], nrm, dep, frame["rough"])
    return dict(
        plain=psnr(display(img), ref),
        legacy=psnr(display(atrous_denoise(img, nrm, dep, spp=spp)), ref),
        atrous=psnr(display(denoise_specular(img, *g, spp=spp,
                                             learned=False)), ref),
        # the default path: the learned KPN when its weights exist and
        # spp <= 4, else the a-trous number
        den=psnr(display(denoise_specular(img, *g, spp=spp)), ref))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="denoiser_eval", allow_abbrev=False)
    p.add_argument("--out", default="/tmp/denoiser_eval.json")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--ref_spp", type=int, default=256)
    p.add_argument("--spp", type=int, nargs="*", default=[1, 8, 32, 128])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    scene, camera = eval_scene(dev)
    ref = display(room_frame(scene, camera, args.size, args.ref_spp,
                             REF_SEED)["final"])

    results = {}
    for spp in args.spp:
        s = scores(room_frame(scene, camera, args.size, spp, SEED), ref,
                   spp)
        plain, den = s["plain"], s["den"]
        results[str(spp)] = dict(
            psnr=round(plain, 2), psnr_denoised=round(den, 2),
            gain_db=round(den - plain, 2),
            atrous_gain_db=round(s["atrous"] - plain, 2),
            legacy_gain_db=round(s["legacy"] - plain, 2))
        print(f"spp={spp:4d}: psnr={plain:6.2f}  denoised={den:6.2f}  "
              f"gain={den - plain:+.2f} dB (atrous "
              f"{s['atrous'] - plain:+.2f}, legacy "
              f"{s['legacy'] - plain:+.2f})")

    with open(args.out, "w") as f:
        json.dump(dict(size=args.size, ref_spp=args.ref_spp,
                       results=results), f, indent=2)
    print(f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
