"""Training/eval configuration (twin of the JAX package's config.py, itself
the twin of the reference editable_gauss_refl/config.py:7-78).

Pure Python, copied so the port never imports the JAX package: the Config
dataclass, an argparse CLI generated from it (aliases -s/-m/-r), and the
cfg.json round trip that downstream CLIs reload as defaults.  The fields
under "TPU-specific knobs" keep their names: the port reads the same
cfg.json files (cull_tile, cull_cluster, max_clusters, max_hits and
ray_tile size the port's training step too).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    viewer: bool = False
    viewer_mode: str = "local"
    val_view: int = 75
    test_iterations: List[int] = field(default_factory=lambda: [1, 750, 3000, 8000])
    save_iterations: List[int] = field(default_factory=lambda: [1, 750, 3000, 8000])
    iterations: int = 8000

    # * Dataset params
    source_path: str = ""          # alias -s
    model_path: str = ""           # alias -m
    resolution: int = 768          # alias -r
    eval: bool = False
    max_images: Optional[int] = None
    init_type: str = "dense"       # dense | sfm
    clamp_max: Optional[float] = None

    # * Model params
    white_background: bool = False
    data_device: str = "cpu"
    scene_extent_init_radius: float = 4.0
    scene_extent_multiplier: float = 5.0
    num_feat_per_gaussian_channel: int = 16
    min_opacity: float = 0.005
    min_weight: float = 0.1
    disable_znear_densif_pruning: bool = False
    znear_scaledown: float = 0.8
    zfar_scaleup: float = 1.5
    transmittance_threshold: float = 0.01
    alpha_threshold: float = 0.005
    exp_power: int = 3
    no_bounces_until_iter: int = 750

    # * Init params
    init_num_pts: int = 100_000
    init_num_pts_farfield: int = 75_000
    init_opa: float = 0.1
    init_opa_farfield: float = 0.1
    init_scale: float = 1.0
    init_scale_farfield: float = 0.1
    init_roughness: float = 0.1
    init_f0: float = 0.04
    init_diffuse_farfield: float = 0.2

    # * Loss weights
    loss_weight_diffuse: float = 5.0
    loss_weight_specular: float = 3.0
    loss_weight_depth: float = 2.5
    loss_weight_normal: float = 2.5
    loss_weight_f0: float = 1.0
    loss_weight_roughness: float = 1.0

    # * Optimization params
    xyz_lr_max_steps: int = 32_000
    xyz_lr_init: float = 0.00016
    xyz_lr_final: float = 0.0000016
    xyz_lr_delay_mult: float = 0.01
    xyz_lr: float = 0.0025
    normal_lr: float = 0.0025
    roughness_lr: float = 0.0025
    f0_lr: float = 0.0025
    diffuse_lr: float = 0.005
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    scale_decay: float = 0.9999
    pruning_interval: int = 125
    pruning_start_iter: int = 1250
    beta_1: float = 0.9
    beta_2: float = 0.999

    # * Tracer knobs (no reference equivalent; named as in the JAX package)
    backend: str = "auto"          # auto | pallas | xla (trace kernel choice)
    cull: bool = True              # cluster culling (pallas backend only)
    cull_tile: int = 256           # rays per culling tile (square pixel tiles)
    cull_cluster: int = 256        # gaussians per Morton cluster
    max_clusters: int = 192        # candidate clusters per tile
    max_clusters_secondary: int = 0  # secondary-bounce candidate cap
                                   # (0 = same as max_clusters); GGX rays
                                   # need ~2x the primary budget
    cull_tile_secondary: int = 256  # rays per secondary culling tile
                                   # (smaller = tighter cone unions)
    split_far: bool = False        # two-pass near/far split per bounce:
                                   # far-field hits (t beyond the per-ray
                                   # split-sphere exit) composite in a
                                   # direction-sorted second pass (exact)
    mc_far: int = 32               # far-pass candidate clusters per tile
    max_hits_far: int = 0          # far-pass k-buffer depth (0 = near depth
                                   # for rendering, max(8, K//2) in training)
    split_radius_scale: float = 1.5  # split sphere radius as a multiple of
                                   # the median live Gaussian distance
    composite_mode: str = "kbuffer"  # kbuffer (exact top-K, training) |
                                   # scan (drain-free streaming composite,
                                   # v6 kernel) | scanq (scan with the
                                   # quadric-form pair math, v7 kernel)
    max_hits: int = 32             # per-ray hit cap (BUFFER_SIZE*iters analog)
    trace_chunk: int = 2048        # Gaussian chunk per intersection block
    ray_tile: int = 8192           # rays per scan tile
    mesh_devices: int = 0          # 0 = all local devices (data-parallel rays)


_ALIASES = {"source_path": ["-s"], "model_path": ["-m"], "resolution": ["-r"]}


def _add_field_arg(parser: argparse.ArgumentParser, f: dataclasses.Field):
    name = "--" + f.name
    aliases = _ALIASES.get(f.name, [])
    if f.type in ("bool", bool):
        # tyro-style: --flag / --no-flag
        group = parser.add_mutually_exclusive_group()
        group.add_argument(name, dest=f.name, action="store_true", default=None)
        group.add_argument("--no-" + f.name.replace("_", "-"), dest=f.name,
                           action="store_false", default=None)
        group.add_argument("--no_" + f.name, dest=f.name,
                           action="store_false", default=None)
        return
    if f.type in ("List[int]", List[int]):
        parser.add_argument(name, *aliases, dest=f.name, type=int, nargs="*",
                            default=None)
        return
    if f.type in ("Optional[float]", Optional[float]):
        parser.add_argument(name, *aliases, dest=f.name, type=float, default=None)
        return
    if f.type in ("Optional[int]", Optional[int]):
        parser.add_argument(name, *aliases, dest=f.name, type=int, default=None)
        return
    py_type = {int: int, float: float, str: str}.get(f.type)
    if py_type is None:
        py_type = {"int": int, "float": float, "str": str}.get(str(f.type), str)
    parser.add_argument(name, *aliases, dest=f.name, type=py_type, default=None)


def build_parser(prog: str = "train") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=prog, allow_abbrev=False)
    for f in dataclasses.fields(Config):
        _add_field_arg(parser, f)
    return parser


def parse_config(argv=None, defaults: Optional[Config] = None,
                 prog: str = "train") -> Config:
    """CLI -> Config, layering explicit args over `defaults` (or Config())."""
    base = defaults if defaults is not None else Config()
    ns, _unknown = build_parser(prog).parse_known_args(argv)
    overrides = {k: v for k, v in vars(ns).items() if v is not None}
    return dataclasses.replace(base, **overrides)


def save_config(cfg: Config, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_config(path: str) -> Config:
    with open(path) as f:
        data = json.load(f)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in data.items() if k in known})


def load_model_config(model_path: str, argv=None, prog: str = "render") -> Config:
    """render.py:407-409 semantics: cfg.json as defaults, CLI overrides."""
    cfg_path = os.path.join(model_path, "cfg.json")
    defaults = load_config(cfg_path) if os.path.exists(cfg_path) else Config()
    cfg = parse_config(argv, defaults=defaults, prog=prog)
    return dataclasses.replace(cfg, model_path=model_path)
