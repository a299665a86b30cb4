"""The 5M-Gaussian stretch configuration on a "gauss" mesh of ranks, the
port's twin of tools/demo_5m.py: scenes too large to replicate.

Runs one gaussian_sharded_train_step and one gaussian_sharded_trace (the
XLA tracer's twin, and the slots kernel per shard with use_pallas) on
room_scene(n) padded by shard_scene, and records each rank's parameter and
optimizer bytes, which should be about 1/S of the replicated footprint:
each rank builds the scene on its host, keeps only its [N/S] rows and moves
those to its device.  The state stays sharded end to end.

    python -m editable_gaussian_reflections_tpu_torch.tools.demo_5m \
        [--n 5000000 --rays 64 --ranks 4] [--device cpu] \
        [--backend gloo|nccl] [--out chiprun_out/demo_5m_torch.json]

On the card the ranks share cuda:0 over gloo unless --backend nccl (one
card per rank).  --device cpu runs the plain versions on CPU ranks (use a
small --n there).  K 8, as the JAX tool's.  Differences from the JAX tool:
256 trace rays (the trace with use_pallas needs whole 256-ray
cull tiles), and the two traces are held against each other (the same kept
hits on at least MIN_RAYS_EQUAL of the rays, and the same depths on those
within T_RTOL/T_ATOL).  It writes its JSON to --out, never to the JAX
tool's artifacts/demo_5m.json.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..ops.cuda import build
from ..parallel.mesh import spawn
from ..parallel.ranks import (
    host_inputs,
    random_targets,
    run_jobs,
    same_hits,
)
from ..renderer.raytracer import CameraParams, draw_tile_samples
from ..training import lr_tree, settings_from_config
from ..utils.synth import room_camera

# the JAX tool's artifact, which this one never writes
JAX_ARTIFACT = Path(__file__).resolve().parents[2] / "artifacts" / "demo_5m.json"
KERNELS = ("trace_slots", "scatter_grads")
# the share of trace rays whose kept hits both traces must agree on.  A
# hit at the clip radius flips between the walk's float32 squared distance
# (|lo|^2 - (lo.ld)^2/|ld|^2) and the XLA tracer's (|lo + t ld|^2): at 5M
# rows the Gaussians are a few mm wide, |lo| reaches ~10^3 and both round
# sq to steps of ~2^-8 near 1 (ROADMAP, Queue 3).  Every differing hit of
# 5M's shards had sq within 0.012 of 1 (96.5% of rays equal on the card).
# The kernel itself is held against its plain version (trace_slots_reference)
# on the same shard inputs by the chip smoke's phase 21 (run's check_plain)
MIN_RAYS_EQUAL = 0.95
# on the rays where both traces keep the same hits, their depths agree to
# T_RTOL relative and T_ATOL absolute (the CPU test's bounds,
# tests/test_torch_gaussian_sharded.py).  full_T is printed, not held:
# it sums every hit of the ray, and a hit beyond the K kept ones may flip
# at the clip radius as above (alpha there is the alpha threshold)
T_RTOL, T_ATOL = 1e-5, 1e-6
# K and the step's bounces (the JAX tool's), and the trace's rays (whole
# 256-ray cull tiles for the kernel trace)
MAX_HITS, NUM_BOUNCES, TRACE_RAYS = 8, 1, 256


def trace_rays_of(eye, n: int):
    """The JAX tool's fan of rays from the eye (x from -0.3 to 0.3 over a
    +z direction), n of them."""
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[:, 0] = np.linspace(-0.3, 0.3, n)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.tile(np.asarray(eye, np.float32), (n, 1)), d


def jobs(n: int, rays: int, ranks: int, check_plain: bool = False) -> list:
    """run_jobs' jobs of the demo on a "gauss" mesh of `ranks`: one
    gaussian_sharded_train_step on room_scene(n) padded by shard_scene
    (each rank builds it on its host and keeps only its rows), then the
    XLA and the slots-kernel trace of the stepped shards; with
    `check_plain`, the kernel trace's shard calls against their plain
    version."""
    eye, c2w = room_camera()
    camera = CameraParams(origin=torch.tensor(eye), c2w=torch.tensor(c2w),
                          fov_y=0.9, znear=0.05, zfar=50.0)
    cfg = Config()
    R = rays * rays
    step_in = host_inputs(
        room=(n, 2048, 0), camera=camera, targets=random_targets(R),
        settings=settings_from_config(cfg), lrs=lr_tree(cfg, 10, 3.0),
        hyper=dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                   apply_grads=1.0),
        samples=draw_tile_samples(torch.Generator().manual_seed(0), rays,
                                  rays, R, NUM_BOUNCES + 1))
    o, d = (torch.tensor(a) for a in trace_rays_of(eye, TRACE_RAYS))
    trace_in = dict(rays_o=o, rays_d=d)
    trace_kw = dict(exp_power=3.0, near=0.05, far=50.0, max_hits=MAX_HITS,
                    chunk=2048)
    # every cluster of a shard a candidate: the kernel trace drops none
    mc = -(-n // (2048 * ranks)) * 2048 // 256
    return [("gauss_step", step_in, dict(
                width=rays, height=rays, num_bounces=NUM_BOUNCES,
                max_hits=MAX_HITS, chunk=2048, gather=False)),
            ("gauss_trace", trace_in, trace_kw),
            ("gauss_trace", trace_in, dict(
                trace_kw, use_pallas=True, cull_cluster=256, cull_tile=256,
                max_clusters=mc, plain=check_plain))]


def summarise(results: list, args) -> dict:
    """The demo's JSON record from run_jobs' results (step, XLA trace,
    kernel trace)."""
    step, xla, kern = results
    ranks = step["ranks"]
    total = sum(r["state_bytes"] for r in ranks)
    biggest = max(r["state_bytes"] for r in ranks)
    a, b = xla["hits"], kern["hits"]
    same = same_hits(a, b)
    valid = a["valid"] & same[:, None]
    t_err = np.abs(a["t"] - b["t"])[valid]
    t_ok = bool((t_err <= T_RTOL * np.abs(a["t"][valid]) + T_ATOL).all())
    traces = dict(xla=xla["ranks"], pallas=kern["ranks"])
    return dict(
        n_gaussians=sum(r["rows"] for r in ranks), n_ranks=len(ranks),
        backend=args.backend, device=args.device,
        rays=args.rays ** 2, max_hits=MAX_HITS, num_bounces=NUM_BOUNCES,
        trace_rays=TRACE_RAYS,
        rows_per_rank=[r["rows"] for r in ranks],
        param_bytes_per_rank=[r["param_bytes"] for r in ranks],
        opt_bytes_per_rank=[r["opt_bytes"] for r in ranks],
        train_state_bytes_total=total,
        train_state_bytes_max_per_rank=biggest,
        sharding_ratio=total / biggest,
        step_ms_per_rank=[r["ms"] for r in ranks],
        step_peak_gb_per_rank=[r["peak_gb"] for r in ranks],
        step_launches_per_rank=[r["launches"] for r in ranks],
        step_collectives_rank0=ranks[0]["collectives"],
        trace_ms_per_rank={k: [r["ms"] for r in v]
                           for k, v in traces.items()},
        trace_peak_gb_per_rank={k: [r["peak_gb"] for r in v]
                                for k, v in traces.items()},
        trace_launches_per_rank={k: [r["launches"] for r in v]
                                 for k, v in traces.items()},
        train_l1_diffuse=float(step["metrics"]["l1_diffuse"]),
        params_moved=max(r["moved"] for r in ranks),
        trace_hits=int(a["valid"].sum()),
        trace_rays_equal=float(same.mean()),
        trace_t_max_abs_err_same_hits=float(t_err.max(initial=0.0)),
        trace_t_within_bound=t_ok,
        trace_full_T_max_abs_err_same_hits=float(np.abs(
            a["full_T"] - b["full_T"])[same].max(initial=0.0)))


def run(argv=None, check_plain: bool = False) -> tuple[dict, list | None]:
    """The demo (module docstring) on `argv`: writes and returns its record
    and, with check_plain, every rank's kernel-trace call through the
    kernel beside its plain version (ranks.gauss_trace's `plain`), for the
    caller to compare."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5_000_000)
    ap.add_argument("--rays", type=int, default=64,
                    help="side of the step's ray grid")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (ranks on the card) or cpu (CPU ranks)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--out", default="chiprun_out/demo_5m_torch.json")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if out.resolve() == JAX_ARTIFACT:
        raise SystemExit(f"demo_5m: {out} is the JAX tool's artifact")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("demo_5m: no CUDA device (--device cpu runs CPU "
                             "ranks)")
        build.build_all(KERNELS)
    results = spawn(run_jobs, args.ranks, args.backend, args.device,
                    {"gauss": args.ranks},
                    jobs(args.n, args.rays, args.ranks, check_plain))
    rec = summarise(results, args)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"demo_5m: {rec['n_gaussians']} Gaussians on {rec['n_ranks']} "
          f"{args.device} ranks ({args.backend}): state "
          f"{rec['train_state_bytes_total'] / 1e9:.3f} GB in all, "
          f"{rec['train_state_bytes_max_per_rank'] / 1e9:.3f} GB at most a "
          f"rank (ratio {rec['sharding_ratio']:.2f}); step "
          f"{max(rec['step_ms_per_rank']):.1f} ms, l1 "
          f"{rec['train_l1_diffuse']:.4f}; traces xla "
          f"{max(rec['trace_ms_per_rank']['xla']):.1f} ms, pallas "
          f"{max(rec['trace_ms_per_rank']['pallas']):.1f} ms, "
          f"{rec['trace_hits']} hits, the same ids on "
          f"{rec['trace_rays_equal']:.2%} of rays (t max abs err on those "
          f"{rec['trace_t_max_abs_err_same_hits']:.3g}, full_T "
          f"{rec['trace_full_T_max_abs_err_same_hits']:.3g}); wrote {out}")
    if not rec["sharding_ratio"] > rec["n_ranks"] * 0.9:
        raise SystemExit("demo_5m: the train state is not [N/S]-sharded")
    if rec["trace_rays_equal"] < MIN_RAYS_EQUAL:
        raise SystemExit("demo_5m: the XLA and the slots-kernel traces keep "
                         "different hits on "
                         f"{1 - rec['trace_rays_equal']:.2%} of rays")
    if not rec["trace_t_within_bound"]:
        raise SystemExit("demo_5m: where both traces keep the same hits, "
                         "their depths differ by up to "
                         f"{rec['trace_t_max_abs_err_same_hits']:.3g}")
    return rec, results[2].get("plain")


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
