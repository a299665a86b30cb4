"""Micro-benchmark, the port's twin of tools/bench_vpu_dtype.py: does the
walks' elementwise op mix run faster in packed bf16 than in float32 on this
card?  Runs the tool's op mix (ops/cuda/bench_dtype.py: mul/add chains,
max, min and one exp, 12 operations per element and round) `reps` times
over a resident [rows, cols] block, in float32 and in bf16, and prints us
per call (CUDA events), T elementwise operations per second and the bf16
speedup.

    python -m editable_gaussian_reflections_tpu_torch.tools.bench_vpu_dtype \
        [--rows 256 --cols 512 --reps 512 --iters 20] [--device cpu]

It runs on the card; --device cpu runs the plain versions (host clock).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.cuda.bench_dtype import DTYPES, MIX_OPS, mix
from .bench_v5 import time_call


def run(rows: int, cols: int, reps: int, iters: int, device) -> dict:
    """{dtype name: (us per call, T ops/s, checksum)}; the block is drawn
    as the tool draws it (uniform in [0.1, 0.9], seed 0)."""
    x = torch.tensor(np.random.default_rng(0).uniform(0.1, 0.9, (rows, cols)),
                     dtype=torch.float32, device=device)
    ops = rows * cols * reps * MIX_OPS
    res = {}
    for name, dtype in DTYPES.items():
        ms, out = time_call(lambda: mix(x, reps, dtype), iters)
        res[name] = (ms * 1e3, ops / (ms * 1e-3) / 1e12,
                     out.to(torch.float64).sum().item())
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--reps", type=int, default=512,
                    help="rounds of the op mix over the block, in-kernel")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_vpu_dtype: no CUDA device (--device cpu "
                         "runs the plain versions)")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    res = run(args.rows, args.cols, args.reps, args.iters, device)
    for dt, (us, tops, checksum) in res.items():
        print(f"{dt}: {us:.1f} us/call  {tops:.3f} Tops elementwise  "
              f"(checksum {checksum:.3e})  [{name}]")
    speedup = res["f32"][0] / res["bf16"][0]
    print(f"bf16 speedup over f32: {speedup:.2f}x")
    result = {"device": name, "speedup": speedup,
              **{f"{dt}_us": v[0] for dt, v in res.items()},
              **{f"{dt}_tops": v[1] for dt, v in res.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
