"""Time the fused training step at reference resolution, the port's twin of
tools/bench_train_step.py: seconds per iteration of train_step (the culled
fused path: trace_slots, the loss-fused backward, the gradient scatter) on
the synthetic room at the parity configuration, 768x768 on
room_scene(175_000), as tools/fused_setup.py's training_step sets it up
(train.py's Config defaults; chip_smoke.py phase 7 times the same step).

    python -m editable_gaussian_reflections_tpu_torch.tools.bench_train_step \
        [--res 768 --n 175000 --iters 3] [--device cpu]

The first step (the kernels' build included) is timed apart, then `iters`
steps, the host clock ending in torch.cuda.synchronize().  The JAX tool's
--xla-scatter and --mxu-scatter A/B has no counterpart: the port's step has
one scatter route (csrc/scatter_grads.cu).  --split_far (with --mc_far,
--max_hits_far) times the two-pass step, as the JAX tool's options do.  It
runs on the card; --device cpu runs the kernels' plain versions (small
sizes only).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench_render_sweep import synchronize
from .fused_setup import training_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=768)
    ap.add_argument("--n", type=int, default=175_000)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--split_far", action="store_true",
                    help="two passes a bounce, near and far of each ray's "
                         "split-sphere exit")
    ap.add_argument("--mc_far", type=int, default=32)
    ap.add_argument("--max_hits_far", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_train_step: no CUDA device (--device cpu "
                         "runs the plain versions)")
    split = (dict(split_far=True, mc_far=args.mc_far,
                  max_hits_far=args.max_hits_far) if args.split_far else {})
    t = training_step(device, n=args.n, side=args.res, **split)
    t0 = time.perf_counter()
    st, m = t.step(t.state)
    l1 = m["l1_diffuse"].item()
    first_s = time.perf_counter() - t0
    print(f"capacity {t.capacity} ({args.n} requested), {args.res}x"
          f"{args.res} = {args.res ** 2} rays; first step {first_s:.1f} s, "
          f"l1 {l1:.4f}", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        st, m = t.step(st)
    synchronize(device)
    dt = (time.perf_counter() - t0) / args.iters
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    result = {"metric": "fused_train_step", "res": args.res, "n": args.n,
              "scatter": "scatter_grads", "split_far": args.split_far,
              "s_per_iter": round(dt, 4),
              "l1_diffuse": round(m["l1_diffuse"].item(), 6),
              "device": name}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
