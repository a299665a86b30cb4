"""Train the learned kernel-predicting specular denoiser
(renderer/denoise_net.py) - twin of the root tools/denoise_train.py.

    python -m editable_gaussian_reflections_tpu_torch.tools.denoise_train \\
        [--data /tmp/denoise_data.npz] [--weights /tmp/denoise_kpn.npz] \\
        [--size 256] [--views 16] [--ref_spp 192] [--noisy_per_view 2] \\
        [--steps 1500] [--lr 2e-3] [--crop 128] [--gen] [--train] \\
        [--device cpu]

--gen renders `--views` random cameras inside room_scene(100_000) (from
default_rng(7); the denoiser_eval view is never among them) on the fused
k-buffer path: a `--ref_spp` reference (seed 10_000 + view) and
`--noisy_per_view` 1-spp frames (seed 17 view + frame) each, written with
np.savez_compressed.  --train fits the KPN to the demodulated specular
pass: L1 between the tonemapped recombined images on random `--crop`
crops, Adam (betas 0.9 / 0.999, eps 1e-8) under optax's cosine decay
(step i, counted from 0, takes lr (1 + cos(pi min(i, steps) / steps)) / 2),
the last eighth of the views held out, and the best validation L1 (checked
every steps // 30) kept.  Step i crops from draw_crops(i + 1); validation
crops too, once, from draw_crops(0) - the JAX tool's val_loss crops with
PRNGKey(0), though its comment says full frame.  The weights go to
`--weights` (a path inside the JAX package, whose shipped KPN lives there,
is refused); EGR_DENOISE_WEIGHTS=<path> points the port's denoiser at
them.  Neither flag: both stages.  On the card unless `--device cpu`;
without a card and without it the tool exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.tonemap import tonemap
from ..renderer import denoise_net as dn
from ..renderer.raytracer import full_f32_matmuls
from ..utils.synth import camera_at, room, room_frame

# the JAX package, whose assets/ holds the shipped KPN weights: no run of
# this tool writes there
JAX_PACKAGE = Path(__file__).resolve().parents[2] / \
    "editable_gaussian_reflections_tpu"
DEFAULT_WEIGHTS = "/tmp/denoise_kpn.npz"
FIELDS = ("final", "diffuse", "normal", "depth", "rough")


def _random_camera(rng, extent=3.0):
    """A camera at a random position in the back half of the room, looking
    at a jittered point near the object cluster (same c2w convention as
    utils/synth.room_camera)."""
    eye = np.array([
        rng.uniform(-extent * 0.7, extent * 0.7),
        rng.uniform(-extent * 0.85, -extent * 0.2),
        rng.uniform(extent * 0.6, extent * 1.2),
    ], np.float32)
    target = np.array([
        rng.uniform(-0.8, 0.8),
        rng.uniform(-0.5, 0.8),
        extent * 0.75 + rng.uniform(-0.5, 0.5),
    ], np.float32)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.stack([right, -down, -fwd], axis=1).astype(np.float32)
    return eye, c2w


def check_weights_path(path: str) -> str:
    """`path`, unless it resolves inside the JAX package (ValueError)."""
    resolved = Path(path).resolve()
    if resolved == JAX_PACKAGE or JAX_PACKAGE in resolved.parents:
        raise ValueError(
            f"--weights {path}: {resolved} is inside the JAX package "
            f"({JAX_PACKAGE}), whose shipped KPN weights this tool never "
            f"overwrites; write elsewhere (default {DEFAULT_WEIGHTS}) and "
            f"set {dn.WEIGHTS_ENV} to use them")
    return path


def generate(args, device: torch.device) -> None:
    """The training set (module docstring), written to args.data."""
    scene = room(device)
    rng = np.random.default_rng(7)

    def frame(camera, spp, seed):
        out = room_frame(scene, camera, args.size, spp, seed)
        return [out[k].cpu().numpy() for k in FIELDS]

    views = []
    for v in range(args.views):
        eye, c2w = _random_camera(rng)
        camera = camera_at(eye, c2w, device)
        t0 = time.time()
        ref = frame(camera, args.ref_spp, 10_000 + v)[0]
        noisy = [frame(camera, 1, v * 17 + s)
                 for s in range(args.noisy_per_view)]
        views.append((ref, noisy))
        print(f"view {v + 1}/{args.views}: {time.time() - t0:.1f}s",
              flush=True)

    out = dict(ref=np.stack([v[0] for v in views]))
    for j, k in enumerate(FIELDS):
        out[k] = np.stack([n[j] for v in views for n in v[1]])
    out["noisy_per_view"] = np.int32(args.noisy_per_view)
    np.savez_compressed(args.data, **out)
    print(f"-> {args.data} "
          f"({os.path.getsize(args.data) / 1e6:.1f} MB)", flush=True)


def draw_crops(seed: int, batch: int, height: int, width: int, crop: int):
    """The crop corners (rows, columns) of one batch: [batch] int64 each,
    from a torch.Generator seeded with `seed`, in [0, size - crop)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, height - crop, (batch,), generator=gen),
            torch.randint(0, width - crop, (batch,), generator=gen))


def crop_batch(batch, crops, crop: int):
    """Each image of each [B, H, W(, C)] tensor of `batch` cut to its
    crop x crop window at (crops[0][b], crops[1][b])."""
    cy, cx = (c.to(batch[0].device) for c in crops)
    ar = torch.arange(crop, device=cy.device)
    rows = (cy[:, None] + ar)[:, :, None]
    cols = (cx[:, None] + ar)[:, None, :]
    b = torch.arange(cy.shape[0], device=cy.device)[:, None, None]
    return tuple(x[b, rows, cols] for x in batch)


def loss_fn(params, batch, crops, crop: int):
    """Mean over the batch of each image's L1 between the tonemapped
    recombined images (diffuse + filtered specular against diffuse +
    reference specular), the images cut to their crops first when `crop`."""
    if crop:
        batch = crop_batch(batch, crops, crop)
    losses = []
    for s, r, n, d, g, f in zip(*batch):
        feat = dn.features(s, n, d, g)
        out = dn.apply_kernel(s, dn.apply_net(params, feat))
        losses.append(torch.mean(torch.abs(
            tonemap(torch.clamp(f + out, min=0.0))
            - tonemap(torch.clamp(f + r, min=0.0)))))
    return torch.stack(losses).mean()


def cosine_lr(lr: float, steps: int, i: int) -> float:
    """optax.cosine_decay_schedule(lr, steps) at count i."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))


def split_data(data, device: torch.device):
    """(train batch, validation batch): each (spec, ref_spec, normal,
    depth, rough, diffuse) as float32 tensors on `device`; the last
    max(1, views // 8) views are held out."""
    npv = int(data["noisy_per_view"])
    n_noisy = data["final"].shape[0]
    n_views = n_noisy // npv
    n_val = max(1, n_views // 8)
    spec = data["final"] - data["diffuse"]          # demodulated residual
    ref_spec = np.repeat(data["ref"], npv, axis=0) - data["diffuse"]
    val_idx = np.arange(n_noisy) // npv >= (n_views - n_val)

    def stack(idx):
        return tuple(torch.as_tensor(np.asarray(a[idx], np.float32),
                                     device=device)
                     for a in (spec, ref_spec, data["normal"],
                               data["depth"], data["rough"],
                               data["diffuse"]))

    return stack(~val_idx), stack(val_idx)


def train(args, device: torch.device, params=None) -> dict:
    """Fit the KPN (module docstring) on args.data from `params`
    (init_params from a generator seeded 0 when None); writes the best
    parameters to args.weights.  Returns the tool's report plus the
    history: each step's loss and learning rate, each check's val L1."""
    full_f32_matmuls()
    with np.load(args.data) as data:
        tr, va = split_data(data, device)
    print(f"train {tr[0].shape[0]} noisy frames / val {va[0].shape[0]}",
          flush=True)
    if params is None:
        params = dn.init_params(torch.Generator(device=device).manual_seed(0))
    params = {k: v.detach().to(device).clone().requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=args.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    H, W = tr[0].shape[1:3]
    val_crops = draw_crops(0, va[0].shape[0], H, W, args.crop)

    def val_loss():
        with torch.no_grad():
            return float(loss_fn(params, va, val_crops, args.crop))

    base = val_loss()
    # best-val checkpointing: the tiny train set overfits within a few
    # hundred steps, so the best-validation params are kept, checked often
    best_vl, best_step = base, 0
    best_params = {k: v.detach().clone() for k, v in params.items()}
    history = dict(loss=[], lr=[], val=[])
    t0 = time.time()
    check = max(1, args.steps // 30)
    for i in range(args.steps):
        lr = cosine_lr(args.lr, args.steps, i)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, tr, draw_crops(i + 1, tr[0].shape[0], H, W,
                                              args.crop), args.crop)
        loss.backward()
        opt.step()
        history["loss"].append(loss.item())
        history["lr"].append(lr)
        if (i + 1) % check == 0:
            vl = val_loss()
            history["val"].append((i + 1, vl))
            if vl < best_vl:
                best_vl, best_step = vl, i + 1
                best_params = {k: v.detach().clone()
                               for k, v in params.items()}
            if (i + 1) % max(1, args.steps // 10) == 0:
                print(f"step {i + 1}/{args.steps} "
                      f"train {history['loss'][-1]:.5f}"
                      f" val {vl:.5f} best {best_vl:.5f}@{best_step}"
                      f" ({time.time() - t0:.0f}s)", flush=True)

    dn.save_params(best_params, args.weights)
    report = dict(weights=args.weights, steps=args.steps,
                  val_l1_init=round(base, 5), val_l1=round(best_vl, 5),
                  best_step=best_step)
    print(json.dumps(report), flush=True)
    return dict(report, history=history, val_l1_init_exact=base,
                val_l1_exact=best_vl)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="denoise_train", allow_abbrev=False)
    ap.add_argument("--data", default="/tmp/denoise_data.npz")
    ap.add_argument("--weights", default=DEFAULT_WEIGHTS,
                    help="where the trained weights go (never inside the "
                    "JAX package)")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--ref_spp", type=int, default=192)
    ap.add_argument("--noisy_per_view", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--gen", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if not args.gen and not args.train:
        args.gen = args.train = True
    return args


def main(argv=None):
    args = parse_args(argv)
    check_weights_path(args.weights)
    dev = resolve_device(args.device)
    if args.gen:
        generate(args, dev)
    if args.train:
        return train(args, dev)
    return None


if __name__ == "__main__":
    main()
