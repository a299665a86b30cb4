"""Sweep the fused render's candidate budgets on the bench scene, the
port's twin of tools/bench_render_sweep.py: for each configuration, the
full 2-bounce frame (room_scene(100_000), 800x800) through
render_frame_fused, its M frame rays/s and the per-pass starved fraction
(the share of rays whose candidate list overflowed while they were still
accumulating: dropped clusters are not corrected for).  The honest
operating point is the fastest configuration whose starved fraction is ~0
(below 0.005 on every pass) and, with a throughput cutoff, whose frame
reads at least 45 dB (tonemapped PSNR) against the same configuration
without it.

    python -m \
        editable_gaussian_reflections_tpu_torch.tools.bench_render_sweep \
        [--n 100000 --res 800 --iters 3 --max_hits 16 --cluster 128]
        [--configs 64:64,64:96,...] [--out best.json] [--device cpu]

A configuration is mcp:mcs[:tile_s[:tile_p]][:sN[:kM]][:tcN]
(parse_render_config).  One JSON row per configuration, then
{"best_honest": ...}.  With --out the best honest record (the row, K and
cluster) is written there, as bench.py reads artifacts/bench_best.json;
the tool never writes that file itself.  It runs on the card; --device cpu
runs the kernels' plain versions (small sizes only).  A split-far
configuration (sN, kM) renders each bounce in two passes (the far pass's K
is kM, or max_hits for k0).  The JAX tool's shrinking of rays_per_call to a TPU's scalar memory has no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.tonemap import tonemap
from ..renderer.raytracer import (
    RenderSettings,
    draw_samples,
    render_frame_fused,
)
from .nonfused_setup import room

DEFAULT_CONFIGS = "64:64,64:96,64:128,96:128"
# the sweep's best honest pick as bench.py reads it (the repository's
# artifacts/bench_best.json)
BEST_PATH = (Path(__file__).resolve().parents[2] / "artifacts"
             / "bench_best.json")


def parse_render_config(cfg: str) -> dict:
    """'mcp:mcs[:tile_s[:tile_p]][:sN[:kM]][:tcN]' -> render_frame_fused's
    keywords, as tools/bench_render_sweep.py parses them (bench.py reads
    the sweep's best honest pick through it): tcN is a throughput cutoff of
    10^-N (fractional N allowed), sN split-far with mc_far N, kM its far
    k-buffer depth."""
    raw = cfg.split(":")
    mc_far, k_far, tcut = 0, 0, -1.0
    if raw and raw[-1].startswith("tc"):
        tcut = 10.0 ** -float(raw.pop()[2:])
    if raw and raw[-1].startswith("k"):
        k_far = int(raw.pop()[1:])
    if raw and raw[-1].startswith("s"):
        mc_far = int(raw.pop()[1:])
    parts = [int(x) for x in raw]
    return dict(
        max_clusters=parts[0],
        max_clusters_secondary=parts[1],
        cull_tile_secondary=parts[2] if len(parts) > 2 else 256,
        cull_tile_primary=parts[3] if len(parts) > 3 else 256,
        split_far=mc_far > 0,
        mc_far=mc_far or 32,
        max_hits_far=k_far,
        throughput_cutoff=tcut,
    )


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def psnr_tonemapped(a: torch.Tensor, b: torch.Tensor) -> float:
    """Tonemapped, clamped PSNR of frame a against frame b (dB)."""
    ta = tonemap(a).clamp(0.0, 1.0).double()
    tb = tonemap(b).clamp(0.0, 1.0).double()
    mse = ((ta - tb) ** 2).mean().item()
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def run_config(scene, camera, W, H, cfg: str, max_hits: int, cluster: int,
               rays_per_call: int, iters: int, gen) -> dict:
    """One configuration's row: mc, mrays, s, starved per pass and, with a
    throughput cutoff, tc_psnr."""
    cfg_kw = parse_render_config(cfg)
    tcut = cfg_kw.pop("throughput_cutoff")
    settings = RenderSettings(secondary_throughput_threshold=tcut)
    kw = dict(cfg_kw, num_bounces=2, max_hits=max_hits,
              cull_cluster=cluster, rays_per_call=rays_per_call)
    dev = scene.xyz.device
    samples = draw_samples(gen, W, H, 3)
    steps, final = render_frame_fused(scene, camera, settings, None, W, H,
                                      samples=samples, **kw)
    starved = [round(float(o.float().mean()), 4) for o in steps.overflow]
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        render_frame_fused(scene, camera, settings, gen, W, H, **kw)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    row = dict(mc=cfg, mrays=round(W * H / dt / 1e6, 3), s=round(dt, 3),
               starved=starved)
    if tcut > 0:
        # the cutoff's honesty: the same samples without it
        _, ref = render_frame_fused(scene, camera, RenderSettings(), None, W,
                                    H, samples=samples, **kw)
        row["tc_psnr"] = round(psnr_tonemapped(final, ref), 2)
    return row


def best_honest(rows: list):
    """The fastest row starved below 0.005 on every pass whose cutoff, if
    any, keeps 45 dB."""
    return max((r for r in rows if "error" not in r
                and max(r["starved"]) < 0.005
                and r.get("tc_psnr", 99.0) >= 45.0),
               key=lambda r: r["mrays"], default=None)


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max_hits", type=int, default=16)
    ap.add_argument("--cluster", type=int, default=128)
    ap.add_argument("--configs", default=DEFAULT_CONFIGS)
    ap.add_argument("--rays_per_call", type=int, default=65536)
    ap.add_argument("--out", default=None,
                    help="write the best honest record here (JSON)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.out and Path(args.out).resolve() == BEST_PATH.resolve():
        raise SystemExit("bench_render_sweep: --out may not be "
                         "artifacts/bench_best.json")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_render_sweep: no CUDA device (--device cpu "
                         "runs the plain versions)")
    W = H = args.res
    scene, camera = room(args.n, device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for cfg in args.configs.split(","):
        row = run_config(scene, camera, W, H, cfg, args.max_hits,
                         args.cluster, args.rays_per_call, args.iters, gen)
        rows.append(row)
        print(json.dumps(row), flush=True)
    best = best_honest(rows)
    print(json.dumps({"best_honest": best}), flush=True)
    if best is not None and args.out:
        rec = dict(best, max_hits=args.max_hits, cluster=args.cluster)
        Path(args.out).write_text(json.dumps(rec))
    return best


if __name__ == "__main__":
    main()
