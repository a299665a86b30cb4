"""What the traffic kinds (kinds/<kind>.py) share: the window's record,
the room and the cameras from the seed, the program's scene and settings,
and the device's synchronize, peak and cache."""

from __future__ import annotations

import gc
import math
from dataclasses import dataclass, field

import torch

from . import inputs, profile


@dataclass
class Window:
    """What the measured window and the traced stretch produced."""

    seconds: float = 0.0
    item_s: list = field(default_factory=list)    # per item, where waited
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    stretch: profile.Stretch | None = None


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def scene_fields(arrays: dict, pad_multiple: int, device) -> dict:
    """The room's fields padded to the capacity as the port's from_arrays
    pads them (dead rows: scale and opacity -10, identity rotation)."""
    n = arrays["xyz"].shape[0]
    cap = round_up(n, pad_multiple)
    extra = cap - n
    fills = dict(scaling=-10.0, opacity=-10.0)
    out = {}
    for k, a in arrays.items():
        tail = torch.full((extra,) + tuple(a.shape[1:]), fills.get(k, 0.0),
                          dtype=a.dtype, device=device)
        if k == "rotation":
            tail[:, 0] = 1.0
        out[k] = torch.cat([a, tail]).contiguous()
    live = torch.zeros(cap, dtype=torch.bool, device=device)
    live[:n] = True
    out["live_mask"] = live
    return out


def make_scene(P, fields: dict):
    """The program's (or the reference's) GaussianScene of `fields`: a
    fresh copy of every tensor, so the two sides share no storage."""
    return P.GaussianScene(**{k: v.clone() for k, v in fields.items()})


def make_room(config: dict, seed: int, device):
    """(fields, layout, poses, generator) of the configuration's room: the
    scene drawn first from the seed's generator, which the caller goes on
    drawing the targets from."""
    sc = config["scene"]
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = inputs.room_layout(device, sc["extent"])
    arrays = inputs.room_arrays(gen, sc["init_num_pts"],
                                sc["init_num_pts_farfield"], layout,
                                sc["extent"])
    fields = scene_fields(arrays, sc["pad_multiple"], device)
    poses = inputs.ring_cameras(config["views"], device)
    return fields, layout, poses, gen


def camera(P, pose):
    origin, c2w = pose
    return P.CameraParams(origin=origin, c2w=c2w, fov_y=inputs.FOV_Y,
                          znear=inputs.ZNEAR, zfar=inputs.ZFAR)


def settings(P, config: dict):
    return P.RenderSettings(**config["settings"])


def sample_seed(seed: int) -> int:
    """The seed of the samples' generator (distinct from the scene's)."""
    return (seed * 2654435761 + 1) % (2**63)


def steady_heap() -> None:
    """Collect set-up's garbage and exempt what set-up built from the
    collector's later passes, so that a full collection in the window scans
    only the window's own objects (its cost then does not depend on how
    much set-up left behind)."""
    gc.collect()
    gc.freeze()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, nearest rank."""
    s = sorted(values)
    k = max(0, math.ceil(q / 100.0 * len(s)) - 1)
    return s[k]
