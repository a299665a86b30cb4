"""Checkpoint / resume (twin of the JAX package's checkpoint.py).

The reference's checkpoint is the PLY alone (scene.py:123-125); its
optimizer state is never saved, so it cannot resume mid-training.  As in
the JAX package, the full TrainState (params, Adam moments, step count,
total_weight) is saved beside the PLY export, in the same layout:
model_path/checkpoints/step_N/.  The JAX package writes orbax there; the
port writes one `torch.save` file of the state's fields, CPU copies of
every tensor, and reads it with `weights_only=True`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .device import DEFAULT_DEVICE, resolve_device
from .scene.gaussian_scene import GaussianScene
from .training import TrainState

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state: TrainState):
    """Write a full-state checkpoint into the directory `path` (capture(),
    gaussian_model.py:77-99)."""
    os.makedirs(path, exist_ok=True)

    def host(tree):
        return {f: getattr(tree, f).detach().cpu() for f in tree._fields}

    torch.save(dict(scene=host(state.scene), mu=host(state.mu),
                    nu=host(state.nu), count=int(state.count),
                    total_weight=state.total_weight.detach().cpu()),
               os.path.join(path, STATE_FILE))


def load_train_state(path: str,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> TrainState:
    """restore() (gaussian_model.py:101-123): the state saved in `path`, on
    `device`."""
    dev = resolve_device(device)
    raw = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                     weights_only=True)

    def rebuild(d):
        return GaussianScene(**{f: d[f].to(dev)
                                for f in GaussianScene._fields})

    return TrainState(scene=rebuild(raw["scene"]), mu=rebuild(raw["mu"]),
                      nu=rebuild(raw["nu"]), count=int(raw["count"]),
                      total_weight=raw["total_weight"].to(dev))


def latest_checkpoint(model_path: str) -> Optional[str]:
    ckpt_dir = os.path.join(model_path, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    entries = [d for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    if not entries:
        return None
    latest = max(entries, key=lambda d: int(d.split("_")[-1]))
    return os.path.join(ckpt_dir, latest)


def checkpoint_path(model_path: str, iteration: int) -> str:
    return os.path.join(model_path, "checkpoints", f"step_{iteration}")
