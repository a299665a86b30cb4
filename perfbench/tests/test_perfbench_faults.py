"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped): correct with the program as it is, and not correct
with the timed path broken underneath it - a training step that returns its
state unchanged, one that leaves half of the batch out, frames whose
answers are altered where they are produced - and with the control (the
reference in bfloat16) in the program's place."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import controls, program, registry, run

CPU = torch.device("cpu")
SEED = 2**31 + 1234
CELLS = {c["name"]: registry.traffic(c["traffic"])["kind"]
         for c in registry.benchmark()["workloads"]}


def one(root, cell, P=None, seed=SEED):
    return run.run_cell(cell, seed, 0.5, False, time.perf_counter(), CPU,
                        program=P, root=root)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(tiny_root, cell):
    res = one(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in registry.kind(CELLS[c]).FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    res = one(tiny_root, cell, controls.faulty(program.load(), fault))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(tiny_root, cell):
    res = one(tiny_root, cell, controls.reference_program(low=True))
    assert not res["correct"], res["checks"]
