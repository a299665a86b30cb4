"""Head-to-head kernel bench, the port's twin of tools/bench_v5.py: the
k-buffer render at its 128-Gaussian clusters (v4: render_culled) against
the fine-cluster render (v5: render_culled_v5) and the streaming scan (v6:
render_scan with the direct pair math) on the bench room, each pass alone:
coherent primary rays (16x16 tile order) and a reflected-ray proxy
(origins pushed 2 units along the primary rays, directions shuffled, the
rays re-sorted by a 5-bit Morton code of the origin and a direction
octant).  One JSON row per configuration: ms per pass (CUDA events), the
frame proxy (1 primary + 2 secondary passes) in M rays/s and the mean
chunks a tile computed.

    python -m editable_gaussian_reflections_tpu_torch.tools.bench_v5 \
        [--n 100000 --res 800 --max_hits 16 --rays 65536 --iters 10]
        [--configs v4:128:256:96:192,...] [--device cpu]

A configuration is ver:cluster:tile:mc_primary:mc_secondary.  It runs on
the card; --device cpu runs the kernels' plain versions (small sizes only;
host clock).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.camera_rays import primary_ray_directions
from ..ops.culling import (
    cluster_bounds,
    live_bounds,
    morton_codes,
    morton_order,
    select_candidates,
    tile_pixel_order,
)
from ..ops.cuda.layout import pack_frames, pack_scan_table
from ..ops.cuda.render_fine import render_culled_v5
from ..ops.cuda.render_kernel import render_culled
from ..ops.cuda.scan_kernel import render_scan
from ..renderer.raytracer import RenderSettings
from ..scene.gaussian_scene import build_frames, from_arrays
from ..utils.synth import room_camera, room_scene

DEFAULT_CONFIGS = ("v4:128:256:96:192,v5:64:128:128:256,"
                   "v5:32:128:160:320,v5:64:128:96:192")
NEAR, FAR = 0.05, 50.0
# the tool's fixed arguments: exp_power, backfacing max distance and
# invalid-normal threshold
EXP_POWER, BF_MAX_DIST, BF_THR = 3.0, 3.0, 0.1


def bench_inputs(n: int, res: int, rays: int, device) -> dict:
    """The bench room (Morton-sorted, packed) and the two ray sets."""
    device = torch.device(device)
    scene = from_arrays(**room_scene(n), pad_multiple=2048, device=device)
    eye, c2w = room_camera()
    settings = RenderSettings()
    frames, attrs = build_frames(scene, settings.alpha_threshold,
                                 settings.exp_power,
                                 settings.global_scale_factor)
    perm = morton_order(frames)
    frames, attrs = frames.take(perm), attrs.take(perm)
    gpack = pack_frames(frames, attrs).contiguous()

    ray_perm, _ = tile_pixel_order(res, res, 16, 16)
    dirs = primary_ray_directions(
        res, res, 0.9, torch.tensor(c2w, device=device)).reshape(-1, 3)
    dirs = dirs[torch.as_tensor(ray_perm, dtype=torch.int64, device=device)]
    rays_o = torch.tensor(np.asarray(eye, np.float32),
                          device=device).expand(dirs.shape)
    rays_p = (rays_o[:rays].contiguous(), dirs[:rays].contiguous())

    shuffle = np.random.default_rng(0).permutation(dirs.shape[0])[:rays]
    sec_d = dirs[torch.as_tensor(shuffle, device=device)]
    sec_o = rays_o[:rays] + 2.0 * dirs[:rays]
    lo, hi = live_bounds(frames.mean, frames.valid)
    pos_bits = morton_codes(sec_o, lo, hi, bits=5)
    qd = torch.clamp((sec_d * 0.5 + 0.5) * 4.0, 0, 3).to(torch.int64)
    keys = (pos_bits << 6) | (qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]
    order = torch.argsort(keys, stable=True)
    rays_s = (sec_o[order].contiguous(), sec_d[order].contiguous())
    return dict(frames=frames, gpack=gpack, primary=rays_p,
                secondary=rays_s, bounds={}, scan=None)


def pass_call(inputs: dict, ver: str, cluster: int, tile: int, mc: int,
              which: str, max_hits: int):
    """(kernel, args, kwargs) of one pass of a configuration, as
    tools/bench_v5.py calls the Pallas kernel (defaults for the rest)."""
    if cluster not in inputs["bounds"]:
        inputs["bounds"][cluster] = cluster_bounds(inputs["frames"], cluster)
    ro, rd = inputs[which]
    sec = 1 if which == "secondary" else 0
    cands, cnear, num, _o, _t = select_candidates(
        ro, rd, inputs["bounds"][cluster], NEAR, FAR, tile=tile,
        max_clusters=mc)
    tail = (NEAR, FAR, EXP_POWER, float(sec), BF_MAX_DIST, BF_THR)
    kw = dict(max_hits=max_hits, cluster=cluster, tile=tile,
              secondary_static=sec)
    if ver == "v5":
        return render_culled_v5, (ro, rd, inputs["gpack"], cands, cnear,
                                  num, *tail), kw
    if ver == "v6":
        if inputs["scan"] is None:
            inputs["scan"] = pack_scan_table(inputs["gpack"], "direct")
        return render_scan, (ro, rd, inputs["scan"], cands, cnear,
                             *tail), kw
    if ver == "v4":
        return render_culled, (ro, rd, inputs["gpack"], cands, cnear,
                               *tail), kw
    raise ValueError(f"version {ver!r}: expected v4, v5 or v6")


def time_call(fn, iters: int) -> tuple:
    """(ms per call, last output) after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    out = fn()
    cuda = out.device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    if cuda:
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters, out
    return (time.perf_counter() - t0) * 1e3 / iters, out


def run_config(inputs: dict, cfg: str, max_hits: int, iters: int) -> dict:
    """One configuration's row (tools/bench_v5.py's keys)."""
    ver, cl, tl, mcp, mcs = cfg.split(":")
    cl, tl, mcp, mcs = int(cl), int(tl), int(mcp), int(mcs)
    res = {}
    for which, mc in (("primary", mcp), ("secondary", mcs)):
        fn, args, kw = pass_call(inputs, ver, cl, tl, mc, which, max_hits)
        ms, out = time_call(lambda: fn(*args, **kw), iters)
        res[which] = (ms, out[:, 15].mean().item())
    rays = inputs["primary"][0].shape[0]
    frame_ms = res["primary"][0] + 2 * res["secondary"][0]
    return {"cfg": cfg, "primary_ms": res["primary"][0],
            "secondary_ms": res["secondary"][0],
            "frame_proxy_mrays": rays / frame_ms / 1e3,
            "chunks_p": res["primary"][1], "chunks_s": res["secondary"][1]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--max_hits", type=int, default=16)
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--raise_errors", action="store_true")
    ap.add_argument("--configs", type=str, default=DEFAULT_CONFIGS,
                    help="comma list of ver:cluster:tile:mc_prim:mc_sec")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_v5: no CUDA device (--device cpu runs the "
                         "plain versions)")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    inputs = bench_inputs(args.n, args.res, args.rays, device)
    rows = []
    for cfg in args.configs.split(","):
        try:
            row = run_config(inputs, cfg, args.max_hits, args.iters)
        except Exception as e:  # noqa: BLE001 - the sweep survives one bad cfg
            if args.raise_errors:
                raise
            row = {"cfg": cfg, "error": str(e)[-200:]}
        row["device"] = name
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
