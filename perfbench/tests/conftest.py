"""Shared fixtures of the benchmark's CPU tests: a checkout-like directory
holding BENCHMARK.json and small copies of its configurations (a 32x32
frame, 5,120 Gaussians, four views), for runs of the harness on the CPU."""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def shrink(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["scene"].update(init_num_pts=4096, init_num_pts_farfield=1024)
    cfg["width"] = cfg["height"] = 32
    cfg["views"] = 4
    if "train" in cfg:
        cfg["train"]["step"]["max_clusters"] = 16
        cfg["train"]["ray_tile"] = 1024
    cfg["render"]["max_clusters"] = 8
    if cfg["render"].get("max_clusters_secondary"):
        cfg["render"]["max_clusters_secondary"] = 16
    return cfg


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("tiny")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        dst = root / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(shrink(cfg)))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
