"""Where trace_slots and its plain version keep different Gaussians, and
why: on the primary and first reflected pass of the training step's first
batch (chip_smoke.py phase 5, tools/fused_setup.py), the rays whose kept
ids or counters differ, and for each whether the two keep the same depths
(t, bit for bit) and differ only by Gaussians at one depth: an exact tie,
which the kernel's walk (insertion in Gaussian order) and the plain
version's drain (insertion in depth order) break differently.  Needs a CUDA
card.

    python editable_gaussian_reflections_tpu_torch/tools/slot_ties.py <tree>

<tree> is the root whose package is imported; the setup is this script's
own tree's, run on <tree>'s package, so that two trees are held to the
same launches.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def main(argv: list[str]) -> None:
    root = str(Path(argv[0]).resolve())
    sys.path.insert(0, root)
    import torch

    from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import (
        SLOT_BLOCKS, SLOT_ID, SLOT_T)
    from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_slots import (
        trace_slots, trace_slots_reference)
    if not trace_slots.__code__.co_filename.startswith(root):
        raise RuntimeError(f"imported {trace_slots.__code__.co_filename}, "
                           f"not the tree {root}")
    spec = importlib.util.spec_from_file_location(
        "fused_setup", Path(__file__).with_name("fused_setup.py"))
    fs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fs)

    t = fs.training_step(torch.device("cuda"))
    t.steps = t.residuals = t.targets_b = None
    for name, call in zip(("primary", "reflected"), t.calls):
        K = call.kwargs["max_hits"]
        slots, acc = trace_slots(*call.args, **call.kwargs)
        ref, ref_acc = trace_slots_reference(*call.args, **call.kwargs)
        s, r = slots.view(-1, SLOT_BLOCKS, K), ref.view(-1, SLOT_BLOCKS, K)
        ids_equal = (s[:, SLOT_ID] == r[:, SLOT_ID]).all(dim=1)
        counters_equal = (acc[:, :3] == ref_acc[:, :3]).all(dim=1)
        differ = torch.nonzero(~(ids_equal & counters_equal)).flatten()
        same = ~differ.new_zeros(s.shape[0], dtype=torch.bool)
        same[differ] = False
        floats_equal = bool(torch.equal(s[same], r[same]))
        print(f"{root} {name}: {differ.numel()} of {s.shape[0]} rays keep "
              f"other ids or counters; every block equal on the others: "
              f"{floats_equal} [{fs.card()}]", flush=True)
        for i in differ.tolist():
            other = s[i, SLOT_ID] != r[i, SLOT_ID]
            t_k, t_r = s[i, SLOT_T], r[i, SLOT_T]
            tie = (bool(counters_equal[i]) and torch.equal(t_k, t_r)
                   and len(set(t_k[other].tolist())) == 1)
            print(f"  ray {i}: slots {torch.nonzero(other).flatten().tolist()}"
                  f" at t {t_k[other].tolist()}: kernel ids "
                  f"{s[i, SLOT_ID][other].int().tolist()}, plain ids "
                  f"{r[i, SLOT_ID][other].int().tolist()}; exact tie: {tie}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
