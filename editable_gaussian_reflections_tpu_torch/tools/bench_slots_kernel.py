"""The training step's slots trace alone, the port's twin of
tools/bench_slots_kernel.py: trace_slots (csrc/trace_slots.cu) on
65,536-ray dispatches at the training configuration (room_scene(175_000),
K 32, cluster 256, 192 candidates, 256-ray cull tiles) for (a) coherent
primary rays (256x256 in 16x16 pixel tiles) and (b) direction-shuffled
rays (origins pushed 1-4 units along the primary rays, directions uniform
on the sphere: a reflected-pass proxy), each with its culling
(select_candidates) timed apart, so that the step's time
(tools/bench_train_step.py) can be split between the trace and the rest.

    python -m \
        editable_gaussian_reflections_tpu_torch.tools.bench_slots_kernel \
        [--n 175000 --max_hits 32 --cluster 256 --max_clusters 192
         --iters 5] [--res 256] [--device cpu]

One JSON row per case: cull_ms, kernel_ms (host clock around `iters`
calls, ending in torch.cuda.synchronize()) and the share of cull tiles
whose candidate list overflowed.  It runs on the card; --device cpu runs
the plain versions (small sizes only: --res shrinks the frame).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.camera_rays import primary_ray_directions
from ..ops.culling import select_candidates, tile_pixel_order
from ..ops.cuda.trace_slots import trace_slots
from ..renderer.raytracer import RenderSettings
from ..training import prepare_render_inputs
from .bench_render_sweep import synchronize
from .nonfused_setup import room

CULL_TILE = 256
EXP_POWER = 3.0


def timed(fn, iters: int, device) -> tuple:
    """(ms per call, last result) after one untimed call."""
    out = fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3, out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=175_000)
    ap.add_argument("--max_hits", type=int, default=32)
    ap.add_argument("--cluster", type=int, default=256)
    ap.add_argument("--max_clusters", type=int, default=192)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--res", type=int, default=256,
                    help="frame side: res x res rays a dispatch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_slots_kernel: no CUDA device (--device cpu "
                         "runs the plain versions)")
    settings = RenderSettings()
    scene, camera = room(args.n, device)
    _f, _a, gpack, tables, _s, _p = prepare_render_inputs(
        scene, settings, True, True, CULL_TILE, args.cluster,
        args.max_clusters)
    W = H = args.res
    ray_perm, _ = tile_pixel_order(H, W, 16, 16)
    dirs = primary_ray_directions(W, H, camera.fov_y, camera.c2w).reshape(
        -1, 3)[torch.as_tensor(ray_perm, dtype=torch.int64, device=device)]
    R = dirs.shape[0]
    rays_o = camera.origin.expand(R, 3).contiguous()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    def case(label, ro, rd, near):
        def cull():
            return select_candidates(ro, rd, tables["bounds"], near,
                                     camera.zfar, tile=CULL_TILE,
                                     max_clusters=args.max_clusters)

        cull_ms, (cands, cnear, _n, ovf, _td) = timed(cull, args.iters,
                                                       device)
        kernel_ms, _ = timed(lambda: trace_slots(
            ro, rd, gpack, tables["table"], tables["ftable"], cands, cnear,
            near, camera.zfar, EXP_POWER, 0.0, settings.backfacing_max_dist,
            settings.backfacing_invalid_normal_threshold,
            transmittance_threshold=settings.transmittance_threshold,
            max_hits=args.max_hits, cluster=args.cluster, tile=CULL_TILE),
            args.iters, device)
        row = {"case": label, "rays": R, "cull_ms": round(cull_ms, 3),
               "kernel_ms": round(kernel_ms, 3),
               "overflow": round(float(ovf.float().mean()), 4),
               "device": name}
        print(json.dumps(row), flush=True)
        return row

    rows = [case("primary", rays_o, dirs.contiguous(), camera.znear)]
    # reflected-pass proxy: origins on scene surfaces, shuffled directions
    rng = np.random.default_rng(1)
    push = torch.tensor(rng.uniform(1.0, 4.0, (R, 1)).astype(np.float32),
                        device=device)
    sd = rng.normal(size=(R, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    rows.append(case("secondary_shuffled",
                     (rays_o + dirs * push).contiguous(),
                     torch.tensor(sd, device=device), 0.0))
    return rows


if __name__ == "__main__":
    main()
