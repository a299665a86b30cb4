"""The fused render in the k-buffer and the scan composite modes, the port's
twin of tools/bench_scan_mode.py: the bench room (room_scene(100_000),
800x800, 2 bounces) through render_frame_fused in each configuration, with
ms per frame, M rays/s over every pass (W x H x (bounces + 1) rays), the
starved fraction (whole frame and per pass) and the tonemapped, clamped
PSNR of each frame against the first configuration's (the k-buffer
reference) on the same samples: what the scan modes' streaming order costs
at the real 16x16-pixel tiles.

    python -m editable_gaussian_reflections_tpu_torch.tools.bench_scan_mode \
        [--n 100000 --res 800 --bounces 2 --iters 5]
        [--configs kbuffer:128:16:96:192,...] [--device cpu]

A configuration is mode:cluster:max_hits:mc_prim:mc_sec[:key=val...] with
the keys tsec=N (cull_tile_secondary), tcut=F (secondary throughput
cutoff), ns=1 (kernel_stats off), ap=bf16 (scanq's bf16 attributes),
far=N and kfar=N (split-far: mc_far max(N, 32), as the JAX tool takes it,
and the far pass's K, 0 for max_hits).  One JSON row per configuration, then the
fastest honest one (starved below 1% on every pass, at least 27 dB against
the k-buffer) in parse_render_config's form ({"best_honest": ...}); the
tool writes no file.  It runs on the card; --device cpu runs the kernels'
plain versions (small sizes only).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ..renderer.raytracer import (
    RenderSettings,
    draw_samples,
    render_frame_fused,
)
from .bench_render_sweep import psnr_tonemapped, synchronize
from .nonfused_setup import room

DEFAULT_CONFIGS = ("kbuffer:128:16:96:192,scan:32:16:128:256,"
                   "scan:32:16:192:384,scan:64:16:128:256")


def parse_config(cfg: str) -> dict:
    """A configuration's fields (mode, cl, k, mcp, mcs, mc_far, tsec, tcut,
    kfar, nstats, ap), as the JAX tool reads them (a bare sixth field is
    mc_far)."""
    parts = cfg.split(":")
    extra = dict(p.split("=", 1) for p in parts[5:] if "=" in p)
    mc_far = (int(parts[5]) if len(parts) > 5 and "=" not in parts[5]
              else int(extra.get("far", 0)))
    return dict(mode=parts[0], cl=int(parts[1]), k=int(parts[2]),
                mcp=int(parts[3]), mcs=int(parts[4]), mc_far=mc_far,
                tsec=int(extra.get("tsec", 256)),
                tcut=float(extra.get("tcut", 0.0)),
                kfar=int(extra.get("kfar", 0)), nstats=int(extra.get("ns", 0)),
                ap=extra.get("ap", "highest"))


def render_config_string(p: dict) -> str:
    """A configuration in parse_render_config's form (the "mc" entry of
    artifacts/bench_best.json)."""
    mc = f"{p['mcp']}:{p['mcs']}:{p['tsec']}:256"
    if p["mc_far"]:
        mc += f":s{p['mc_far']}" + (f":k{p['kfar']}" if p["kfar"] else "")
    if p["tcut"] > 0:
        mc += f":tc{round(-math.log10(p['tcut']), 2):g}"
    return mc


def run_config(scene, camera, W, H, bounces, p, iters, samples, gen):
    """(row, final frame) of one configuration."""
    settings = RenderSettings()
    if p["tcut"] > 0:
        settings = settings._replace(secondary_throughput_threshold=p["tcut"])
    kw = dict(num_bounces=bounces, max_hits=p["k"], cull_cluster=p["cl"],
              max_clusters=p["mcp"], max_clusters_secondary=p["mcs"],
              composite_mode=p["mode"], split_far=p["mc_far"] > 0,
              mc_far=max(p["mc_far"], 32), max_hits_far=p["kfar"],
              cull_tile_secondary=p["tsec"], kernel_stats=not p["nstats"],
              attr_precision=p["ap"])
    steps, final = render_frame_fused(scene, camera, settings, None, W, H,
                                      samples=samples, **kw)
    ovf = steps.overflow.float()
    dev = scene.xyz.device
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        render_frame_fused(scene, camera, settings, gen, W, H, **kw)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / iters
    row = {"ms": round(dt * 1e3, 1),
           "mrays": round(W * H * (bounces + 1) / dt / 1e6, 3),
           "starved": round(float(ovf.mean()), 4),
           "starved_per_pass": [round(float(o.mean()), 4) for o in ovf]}
    return row, final


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--configs", default=DEFAULT_CONFIGS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_scan_mode: no CUDA device (--device cpu "
                         "runs the plain versions)")
    W = H = args.res
    scene, camera = room(args.n, device)
    gen = torch.Generator(device=device).manual_seed(0)
    samples = draw_samples(gen, W, H, args.bounces + 1)
    ref, results = None, []
    for cfg in args.configs.split(","):
        p = parse_config(cfg)
        row, final = run_config(scene, camera, W, H, args.bounces, p,
                                args.iters, samples, gen)
        row = {"cfg": cfg, **row}
        if ref is None:
            ref = final
            row["role"] = "reference"
        else:
            row["psnr_vs_kbuffer"] = round(psnr_tonemapped(final, ref), 2)
        print(json.dumps(row), flush=True)
        results.append((row, p))
    honest = [(r, p) for r, p in results
              if max(r["starved_per_pass"]) < 0.01
              and r.get("psnr_vs_kbuffer", 99.0) >= 27.0]
    best = None
    if honest:
        r, p = max(honest, key=lambda rp: rp[0]["mrays"])
        best = dict(mc=render_config_string(p),
                    mrays=round(r["mrays"] / (args.bounces + 1), 3),
                    starved=r["starved_per_pass"], max_hits=p["k"],
                    cluster=p["cl"], mode=p["mode"],
                    kernel_stats=not p["nstats"], attr_precision=p["ap"],
                    psnr_vs_kbuffer=r.get("psnr_vs_kbuffer"))
    print(json.dumps({"best_honest": best}), flush=True)
    return [r for r, _p in results]


if __name__ == "__main__":
    main()
