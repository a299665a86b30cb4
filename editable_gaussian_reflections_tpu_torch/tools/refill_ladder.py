"""The refill/barrier ladder: what the k-buffer walk's per-cluster
shared-memory refill and barriers cost on the card.

grouped_walk.cu (beside this file) is render_culled's kernel as it was on
the walk of csrc/trace_tile.cuh, rewritten to stage a whole early-exit
group of `check_every` clusters per refill, with one barrier pair per
group; it equals render_culled bit for bit on the same inputs.
render_culled now walks csrc/trace_hits_walk.cuh (a cp.async ring, four
Gaussians a step), so the grouped/culled gap is no longer the refills and
barriers alone: it also holds what that walk changed.  With no exit anywhere (threshold 0, every near 0)
every variant does the same work, so on the bench_v5 room's primary rays
the ladder times

    grouped_ce8, grouped_ce1   one refill per 8 clusters / per cluster
    culled_ce8, culled_ce1     render_culled, an exit vote per 8 / per 1

at v5's shapes (K 16, tile 128, clusters 64 and 32) and at the eval
render's (K 32, tile 256, cluster 256: one 256-thread block fills an SM's
registers there, so no other block hides a barrier stall).  Each variant is
held bit for bit to grouped_ce8, and timed with CUDA events in ROUNDS
rounds of alternating order (the median is printed).  One JSON row per
shape.  Needs a CUDA card:

    python -m editable_gaussian_reflections_tpu_torch.tools.refill_ladder \
        [--n 100000 --res 800 --rays 262144 --iters 5]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops.cuda import build
from ..ops.cuda.layout import N_ROWS, OUT_LANES, OUT_TRAV
from ..ops.cuda.render_kernel import (
    _ARGTYPES,
    _check,
    _f32,
    _log_f32,
    _per_ray,
    render_culled,
)
from .bench_v5 import bench_inputs, pass_call, time_call

# (max_hits, cluster, tile, candidates per tile)
SHAPES = ((16, 64, 128, 128), (16, 32, 128, 160), (32, 256, 256, 192))
VARIANTS = ("grouped_ce8", "grouped_ce1", "culled_ce8", "culled_ce1")
ROUNDS = 3
# dynamic shared memory of one block on sm_90
MAX_SMEM = 227 * 1024
# the depths grouped_walk.cu is built for (it keeps the K hits in
# registers; the port's kernels take SUPPORTED_K)
GROUPED_K = (16, 32)
N_GEOM_ROWS = 22


@functools.cache
def _entry_point():
    fn = build.load("grouped_walk", Path(__file__).parent).egr_grouped_walk
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def grouped_walk(rays_o, rays_d, gpack, candidates, cand_near, near, far,
                 exp_power, secondary, backfacing_max_dist,
                 backfacing_invalid_normal_threshold,
                 transmittance_threshold=0.01, eps_forward_normalization=1e-12,
                 max_hits: int = 16, cluster: int = 128, tile: int = 256,
                 alive=None, check_every: int = 8, t_split=None,
                 window_mode: int = 0, secondary_static: int = -1):
    """grouped_walk.cu on CUDA tensors, with render_culled's arguments;
    [R, OUT_LANES] f32."""
    R, N = rays_o.shape[0], gpack.shape[1]
    dev = rays_o.device
    if dev.type != "cuda" or max_hits not in GROUPED_K:
        raise ValueError(f"grouped_walk: CUDA tensors and K in "
                         f"{GROUPED_K}, got {dev} and {max_hits}")
    if R % tile or not 0 < tile <= 1024 or N % cluster:
        raise ValueError(f"tile={tile} must divide R={R}, cluster={cluster} "
                         f"N={N}")
    if 4 * N_GEOM_ROWS * cluster * check_every > MAX_SMEM:
        raise ValueError(f"check_every={check_every} clusters of {cluster} "
                         f"overflow the block's shared memory")
    mc = candidates.shape[1]
    alive_f = _per_ray(alive, R, 1.0, dev).contiguous()
    t_split_f = _per_ray(t_split, R, 0.0, dev).contiguous()
    for name, x, shape, dtype in (
            ("rays_o", rays_o, (R, 3), torch.float32),
            ("rays_d", rays_d, (R, 3), torch.float32),
            ("gpack", gpack, (N_ROWS, N), torch.float32),
            ("candidates", candidates, (R // tile, mc), torch.int32),
            ("cand_near", cand_near, (R // tile, mc), torch.float32),
            ("alive", alive_f, (R,), torch.float32),
            ("t_split", t_split_f, (R,), torch.float32)):
        _check(name, x, shape, dtype, dev)
    out = torch.empty((R, OUT_LANES), dtype=torch.float32, device=dev)
    err = _entry_point()(
        rays_o.data_ptr(), rays_d.data_ptr(), alive_f.data_ptr(),
        t_split_f.data_ptr(), gpack.data_ptr(), candidates.data_ptr(),
        cand_near.data_ptr(), out.data_ptr(),
        R, N, mc, tile, cluster, max_hits, check_every,
        window_mode, secondary_static,
        _f32(near), _f32(far), _f32(secondary), _f32(backfacing_max_dist),
        _f32(backfacing_invalid_normal_threshold),
        _f32(transmittance_threshold), _f32(eps_forward_normalization),
        _log_f32(transmittance_threshold), float(exp_power),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_walk launch failed: cudaError {err}")
    return out


def ladder_row(inputs: dict, max_hits: int, cluster: int, tile: int,
               mc: int, iters: int) -> dict:
    """The four variants on one shape, with no exit anywhere."""
    _fn, args, kw = pass_call(inputs, "v4", cluster, tile, mc, "primary",
                              max_hits)
    args = list(args)
    args[4] = torch.zeros_like(args[4])             # every near 0
    kw = dict(kw, transmittance_threshold=0.0)      # no ray saturates
    calls = {}
    for name in VARIANTS:
        kern = grouped_walk if name.startswith("grouped") else render_culled
        calls[name] = functools.partial(kern, *args, **dict(
            kw, check_every=int(name[-1])))
    outs = {name: call() for name, call in calls.items()}
    for name, out in outs.items():
        if not torch.equal(out, outs["grouped_ce8"]):
            raise RuntimeError(f"{name} differs from grouped_ce8 at K "
                               f"{max_hits}, cluster {cluster}")
    times = {name: [] for name in VARIANTS}
    for r in range(ROUNDS):
        for name in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
            times[name].append(time_call(calls[name], iters)[0])
    ms = {name: statistics.median(t) for name, t in times.items()}
    pairs = outs["grouped_ce8"][:, OUT_TRAV].sum().item()
    return dict(max_hits=max_hits, cluster=cluster, tile=tile, mc=mc,
                rays=args[0].shape[0], pairs=pairs, ms=ms,
                gpairs_s={k: pairs / v / 1e6 for k, v in ms.items()},
                ms_all=times)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--rays", type=int, default=262_144)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("refill_ladder: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    inputs = bench_inputs(args.n, args.res, args.rays, torch.device("cuda"))
    rows = []
    for shape in SHAPES:
        row = dict(ladder_row(inputs, *shape, args.iters), card=smi)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
