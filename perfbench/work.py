"""Counted work and the card's peaks: the yardstick of every roofline share
and of both mfu metrics.

The work is a lower bound that any implementation of the same contract must
do, counted from the configuration's shapes and from what the reference
keeps, never from the program's counters, its walks or its buffers' layout:

  a walk (trace_slots, render_culled, render_scan), per pass
    flops = PAIR_FLOPS x valid pairs + COMPOSITE_FLOPS x kept hits
            (every valid ray-Gaussian pair of the processed clusters enters
            the transmittance; every kept hit is composited)
    bytes = 4 x (RAY_FLOATS x rays + GAUSS_FLOATS x Gaussians
                 + out_floats)
            out_floats: trace_slots SLOT_OUT_FLOATS a kept hit and one
            (log T) a ray; the frame kernels FRAME_OUT_FLOATS a ray
  the backward, per kept hit: GRAD_FLOPS (a multiply-add per gradient
    column of the hit's Gaussian)
  Adam, per parameter: ADAM_FLOPS

`valid pairs` and `kept hits` are the reference's counts on the steps or
frames it checks, averaged per step or frame.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), data sheet, at its 700 W power limit
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12

# the fewest operations a ray-Gaussian pair test takes in any form the port
# or the JAX package has (the direct form on a shared ray origin: 34)
PAIR_FLOPS = 34
# a composited hit: its weight times 11 lanes (rgb, normal, f0, roughness,
# depth), a multiply-add each
COMPOSITE_FLOPS = 22
# a kept hit's gradient: a multiply-add into each of its Gaussian's 21
# parameters (mean 3, scale 3, rotation 4, opacity 1, diffuse 3, normal 3,
# f0 3, roughness 1)
GRAD_FLOPS = 42
PARAMS_PER_GAUSSIAN = 21
# Adam on one parameter: two moments, their bias correction, sqrt, divide,
# update
ADAM_FLOPS = 10
RAY_FLOATS = 6            # origin and direction
GAUSS_FLOATS = 21         # mean, quaternion, scale, opacity, the 10 shading
SLOT_OUT_FLOATS = 3       # t, alpha, id of a kept hit
FRAME_OUT_FLOATS = 13     # rgb, normal, f0, roughness, depth, T, full T


def walk_work(kernel: str, counts: dict, items: int, gaussians: int,
              rays_per_item: int, passes: int) -> tuple:
    """(flops, bytes) a step or frame of `kernel`'s passes."""
    c = counts.get(kernel)
    if not c or items <= 0:
        return None
    pairs = c.get("valid_pairs", 0) / items
    kept = c.get("kept_hits", 0) / items
    flops = PAIR_FLOPS * pairs + COMPOSITE_FLOPS * kept
    rays = rays_per_item * passes
    if kernel == "trace_slots":
        out = SLOT_OUT_FLOATS * kept + rays
    else:
        out = FRAME_OUT_FLOATS * rays
    nbytes = 4 * (RAY_FLOATS * rays + GAUSS_FLOATS * gaussians * passes
                  + out)
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES)


def step_flops(counts: dict, items: int, gaussians: int) -> float | None:
    """The whole training step's counted operations: the walks, the
    backward of every kept hit and Adam."""
    c = counts.get("trace_slots")
    if not c or items <= 0:
        return None
    pairs = c.get("valid_pairs", 0) / items
    kept = c.get("kept_hits", 0) / items
    return (PAIR_FLOPS * pairs + (COMPOSITE_FLOPS + GRAD_FLOPS) * kept
            + ADAM_FLOPS * PARAMS_PER_GAUSSIAN * gaussians)


def frame_flops(counts: dict, items: int) -> float | None:
    """A frame's counted operations: its walks (either kernel)."""
    total, seen = 0.0, False
    for kernel in ("render_culled", "render_scan"):
        c = counts.get(kernel)
        if c and items > 0:
            seen = True
            total += (PAIR_FLOPS * c.get("valid_pairs", 0)
                      + COMPOSITE_FLOPS * c.get("kept_hits", 0)) / items
    return total if seen else None
