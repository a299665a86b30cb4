"""Why a ray-sharded fused frame parts from the single-process frame.

sharded_render_fused re-sorts each reflected wavefront within its shard,
so a reflected ray shares its 256-ray cull tile (its candidate list and the
tile's exit vote) with other rays than in render_frame_fused.  This tool
renders the k-buffer frame whole (render_frame_fused) and as 2 contiguous
ray shards (sharded_render_fused itself, each shard in this one process,
its all-gather replaced by placing the shard's rays), on the same samples.
For every ray where the two part beyond TOL while neither starved, it takes
the first step (bounce) at which they part and replays that step for the
ray alone, in a tile of copies of it, through the same kernel with

  * "whole": the candidate list of its tile in the whole frame;
  * "shard": the candidate list of its tile in its shard;
  * "own": every cluster visible to the ray alone (no list cap);

and records which replays reproduce each frame's kept lanes (KEPT_LANES)
for the ray bit for bit, and whether a cluster visible to the ray is
missing from either list.  A few rays that do not part are replayed too,
as a control of the replay itself.  At most --max-rays of the rays that
part are replayed, evenly spaced.

    python -m editable_gaussian_reflections_tpu_torch.tools.shard_tiling \\
        [--n 100000 --side 800 --threshold 0] [--device cpu] \\
        [--max-rays 1000] [--out chiprun_out/shard_tiling.json]

The scene is bench.py's room_scene(n) and the frame the Config's
k-buffer settings (K 32, cluster 256, 192 candidates) at the given
transmittance threshold.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from unittest import mock

import torch

from ..config import Config
from ..device import resolve_device
from ..ops.cuda import build
from ..ops.cuda.layout import (
    OUT_DEPTH,
    OUT_F0,
    OUT_FULLT,
    OUT_NRM,
    OUT_RGB,
    OUT_ROUGH,
    OUT_TFINAL,
)
from ..ops.culling import select_candidates
from ..parallel import sharding
from ..parallel.mesh import Mesh
from ..renderer import raytracer as rt
from ..training import settings_from_config
from .nonfused_setup import FRAME_KW, room

TOL = 1e-5
N_CONTROL = 8
# chip_smoke.py phase 21 (b)'s frame: 2 ray shards, samples from seed 5
SHARDS, SEED = 2, 5
# the kernel's output lanes composited over the K kept hits (rgb, normal,
# f0, roughness, depth, T_final): what the frame and the next wavefront
# read.  full_T and the counters also count hits behind the K-th, which a
# ray walks on to while its tile's other rays are not done
KEPT_LANES = [*range(OUT_RGB, OUT_RGB + 3), *range(OUT_NRM, OUT_NRM + 3),
              *range(OUT_F0, OUT_F0 + 3), OUT_ROUGH, OUT_DEPTH, OUT_TFINAL]


def recorded(fn):
    """(fn(), the KernelCalls kernel_call built during it, in order)."""
    calls, real = [], rt.kernel_call

    def record(*args, **kwargs):
        calls.append(real(*args, **kwargs))
        return calls[-1]

    with mock.patch.object(rt, "kernel_call", record):
        return fn(), calls


def shard_frames(S: int, frame):
    """The frame as S ray shards: per shard (StepOutputs, final, calls),
    each in linear pixel order with the other shards' rays zero."""
    out = []
    for k in range(S):
        def placed(t, mesh, axis, dim=0, k=k):
            parts = [torch.zeros_like(t)] * S
            parts[k] = t
            return torch.cat(parts, dim=dim)

        mesh = Mesh(shape={"rays": S}, index={"rays": k}, groups={},
                    device=torch.device("cpu"))
        with mock.patch.object(sharding, "all_gather", placed):
            (steps, final), calls = recorded(lambda: frame(mesh))
        out.append((steps, final, calls))
    return out


def within(a, b):
    """Per ray (first dim): every value equal or within TOL."""
    e = (a == b) | ((a - b).abs() <= TOL * b.abs() + TOL)
    return e.reshape(e.shape[0], -1).all(dim=1)


def replay(call, row: int, cands, cnear):
    """The kept lanes of `call`'s ray at `row`, traced alone in a tile of
    copies of it with the candidate list (cands, cnear) [MC]."""
    tile = call.kwargs["tile"]
    o = call.args[0][row].expand(tile, 3).contiguous()
    d = call.args[1][row].expand(tile, 3).contiguous()
    kwargs = dict(call.kwargs,
                  alive=call.kwargs["alive"][row].expand(tile).contiguous())
    return call.kernel(o, d, call.args[2], cands[None].contiguous(),
                       cnear[None].contiguous(), *call.args[5:],
                       **kwargs)[0, KEPT_LANES]


def tile_list(call, row: int):
    t = row // call.kwargs["tile"]
    return call.args[3][t], call.args[4][t]


def own_list(call, row: int, bounds):
    """Every cluster visible to the ray at `row` alone, nearest first."""
    tile = call.kwargs["tile"]
    o = call.args[0][row].expand(tile, 3).contiguous()
    d = call.args[1][row].expand(tile, 3).contiguous()
    cands, cnear, *_ = select_candidates(o, d, bounds, call.args[5],
                                         call.args[6], tile=tile,
                                         max_clusters=bounds.radius.shape[0])
    return cands[0], cnear[0]


def ids(cands) -> set:
    return {int(c) for c in cands.tolist() if c >= 0}


def diagnose(args) -> dict:
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all(("render_culled",))
    rt.full_f32_matmuls()
    cfg = Config()
    settings = settings_from_config(cfg)._replace(
        transmittance_threshold=args.threshold)
    scene, camera = room(args.n, dev)
    side, S = args.side, SHARDS
    samples = rt.draw_samples(torch.Generator().manual_seed(SEED), side,
                              side, 3)
    samples = rt.FrameSamples(samples.jitter.to(dev), samples.us.to(dev))
    kw = dict(num_bounces=2, rays_per_call=64000, **FRAME_KW)
    (steps_w, final_w), calls_w = recorded(lambda: rt.render_frame_fused(
        scene, camera, settings, None, side, side, samples=samples, **kw))
    shards = shard_frames(S, lambda mesh: sharding.sharded_render_fused(
        mesh, scene, camera, settings, None, side, side, samples=samples,
        **kw))
    prep = rt._prepare_fused_frame(
        scene, camera, settings, samples, side, side, jitter=True,
        cull_cluster=FRAME_KW["cull_cluster"], cull_tile_primary=256,
        num_steps=3, composite_mode="kbuffer")
    R = prep["R"]
    Rs = R // S
    idx = prep["ray_inv"].to(torch.int64)     # linear pixel -> tile order
    owner = idx // Rs
    final_s = torch.zeros_like(final_w)
    steps_s = [torch.zeros_like(a) for a in steps_w]
    for k, (st, fin, _calls) in enumerate(shards):
        mine = owner == k
        final_s[mine] = fin[mine]
        for a, b in zip(steps_s, st):
            a[:, mine] = b[:, mine]
    steps_s = rt.StepOutputs(*steps_s)
    ok = ((steps_s.overflow == 0) & (steps_w.overflow == 0)).all(dim=0)
    inside = within(final_s, final_w)
    step_in = torch.stack([torch.stack([
        within(getattr(steps_s, f)[k], getattr(steps_w, f)[k])
        for f in steps_w._fields]).all(dim=0) for k in range(3)])
    outside = torch.nonzero(ok & ~inside).flatten()
    n_outside = outside.numel()
    if n_outside > args.max_rays:
        outside = outside[torch.linspace(0, n_outside - 1, args.max_rays,
                                         device=dev).long()]
    outside = outside.tolist()
    control = torch.nonzero(ok & inside).flatten()
    control = control[torch.linspace(0, control.numel() - 1, N_CONTROL,
                                     device=dev).long()].tolist()
    outs_w = {}
    outs_s = {}

    def out_of(cache, key, call):
        if key not in cache:
            cache[key] = call.kernel(*call.args, **call.kwargs)
        return cache[key]

    rays = []
    for p in outside + control:
        parted = ~step_in[:, p]
        step = int(parted.float().argmax()) if bool(parted.any()) else 2
        step = max(step, 1)
        i, k = int(idx[p]), int(owner[p])
        cw, cs = calls_w[step], shards[k][2][step]
        row_w = int(cw.inv_order[i])
        row_s = int(cs.inv_order[i - k * Rs])
        got_w = out_of(outs_w, step, cw)[row_w, KEPT_LANES]
        got_s = out_of(outs_s, (k, step), cs)[row_s, KEPT_LANES]
        lw, ls = tile_list(cw, row_w), tile_list(cs, row_s)
        lo = own_list(cw, row_w, prep["bounds"])
        rep = {name: replay(cw, row_w, *lst)
               for name, lst in (("whole", lw), ("shard", ls), ("own", lo))}
        visible = ids(lo[0])
        mc = lw[0].numel()
        rays.append(dict(
            pixel=p, control=p in control, step=step,
            outputs_equal=bool(torch.equal(got_w, got_s)),
            whole_reproduced_by=[n for n, v in rep.items()
                                 if torch.equal(v, got_w)],
            shard_reproduced_by=[n for n, v in rep.items()
                                 if torch.equal(v, got_s)],
            visible_missing_whole=len(visible - ids(lw[0])),
            visible_missing_shard=len(visible - ids(ls[0])),
            list_full_whole=len(ids(lw[0])) == mc,
            list_full_shard=len(ids(ls[0])) == mc,
            full_T_whole=float(out_of(outs_w, step, cw)[row_w, OUT_FULLT]),
            full_T_shard=float(out_of(outs_s, (k, step), cs)[row_s,
                                                              OUT_FULLT]),
            max_abs_err=float((final_s[p] - final_w[p]).abs().max())))
    part = [r for r in rays if not r["control"]]

    def count(pred) -> int:
        return sum(1 for r in part if pred(r))

    return dict(
        n=args.n, side=side, shards=S, threshold=args.threshold,
        rays_not_starved=int(ok.sum()), rays_outside=n_outside,
        rays_replayed=len(outside),
        first_parting={f"step {s}": count(lambda r, s=s: r["step"] == s)
                       for s in (1, 2)},
        # each frame's output is its tile's list alone: the exit votes of
        # the ray's tile-mates moved neither
        lists_explain_both=count(
            lambda r: "whole" in r["whole_reproduced_by"]
            and "shard" in r["shard_reproduced_by"]),
        # the ray walked on or stopped with its tile-mates in that frame
        vote_moved_whole=count(
            lambda r: "whole" not in r["whole_reproduced_by"]),
        vote_moved_shard=count(
            lambda r: "shard" not in r["shard_reproduced_by"]),
        own_list_matches_whole=count(
            lambda r: "own" in r["whole_reproduced_by"]),
        own_list_matches_shard=count(
            lambda r: "own" in r["shard_reproduced_by"]),
        visible_missing_in_either=count(
            lambda r: r["visible_missing_whole"]
            or r["visible_missing_shard"]),
        # ... from a list the cap cut (the tile overflowed), on a ray the
        # starved flag passes over: its full_T at or under the threshold
        visible_missing_from_full_list=count(
            lambda r: (r["visible_missing_whole"] and r["list_full_whole"])
            or (r["visible_missing_shard"] and r["list_full_shard"])),
        visible_missing_from_list_not_full=count(
            lambda r: (r["visible_missing_whole"]
                       and not r["list_full_whole"])
            or (r["visible_missing_shard"] and not r["list_full_shard"])),
        full_T_at_or_under_threshold=count(
            lambda r: min(r["full_T_whole"], r["full_T_shard"])
            <= args.threshold),
        controls_reproduced=sum(
            1 for r in rays if r["control"]
            and "whole" in r["whole_reproduced_by"]
            and "shard" in r["shard_reproduced_by"]),
        controls=len(control), rays=rays)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--side", type=int, default=800)
    ap.add_argument("--threshold", type=float, default=0.0,
                    help="the frame's transmittance_threshold")
    ap.add_argument("--max-rays", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/shard_tiling.json")
    args = ap.parse_args(argv)
    rec = diagnose(args)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items() if k != "rays"}))
    return rec


if __name__ == "__main__":
    main()
