"""What the comparisons that decide `correct` share.  Each traffic kind
(kinds/<kind>.py) has its own `compare`: the plain reference (reference/,
which imports nothing of the program) recomputes, from the benchmark's own
inputs, what the timed path produced, and each number it returns is held
here to the configuration's limit for that kind."""

from __future__ import annotations

import torch


def gap(p: float, r: float, scale: float) -> float:
    """|p - r| / scale, infinite where either side is not finite."""
    g = abs(p - r) / scale
    return g if g == g and g != float("inf") else float("inf")


def leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """Over the leaves (those in `keep`, where given), the largest gap
    between the program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {f: float(v) for f, v in ref.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    worst = 0.0
    for f, rn in norms.items():
        if keep is not None and f not in keep:
            continue
        worst = max(worst, gap(float(prog[f]), rn, max(rn, med, 1e-30)))
    return worst


def bad_share(bad: torch.Tensor) -> float:
    """The share of True in `bad`, in %."""
    return 100.0 * float(bad.double().mean())


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}) in the limits' order."""
    shown = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    ok = all(numbers[k] <= limits[k] for k in limits)
    return ok, shown
