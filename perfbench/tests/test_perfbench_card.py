"""On the card: one short run of each cell through the command, the
result line's shape."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import registry

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the port's CUDA "
                    "kernels")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"


def test_no_card_means_no_result(tmp_path):
    """Without a card the command prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1"], cwd=registry.ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
