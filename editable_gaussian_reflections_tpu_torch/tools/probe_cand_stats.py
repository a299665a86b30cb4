"""Per-tile candidate-cluster counts against the cull tile's size, the
port's twin of tools/probe_cand_stats.py: how far shrinking the cull tile
(256 -> 32 rays) tightens a tile's cone, on the bench room's primary rays
and on real bounce-1 rays (the hits of a 1-bounce render_frame_fused,
mirrored off the primary normal, re-sorted by origin cell and direction
bin as the renderer re-sorts them), with no cap on the lists.

Beside each count, the same tiles under the parent cull's cone test (the
JAX package's, which drops clusters that a ray of a wide cone, or of a
depth window starting beyond 0, sees: ops/culling.py cone_sphere_visible):
what the conservative cull costs, in candidates a tile.

    python -m editable_gaussian_reflections_tpu_torch.tools.probe_cand_stats \\
        [--n 100000 --res 800 --cluster 128] [--device cpu]

One JSON line per pass and tile size, then {"summary": ...} with the mean
counts.  It runs on the card; --device cpu runs the plain versions (small
sizes only).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.camera_rays import primary_ray_directions
from ..ops.culling import (
    ClusterBounds,
    cluster_bounds,
    live_bounds,
    morton_order,
    select_candidates,
    tile_cones,
    tile_pixel_order,
    _per_tile,
)
from ..ops.precision import WIDE
from ..renderer.raytracer import (
    RenderSettings,
    render_frame_fused,
    secondary_order,
)
from ..scene.gaussian_scene import build_frames
from .nonfused_setup import room

TILES = (256, 128, 64, 32)
NEAR = dict(primary=0.05, secondary=0.0)
FAR = 50.0


def parent_visible(cones, bounds, near, far) -> torch.Tensor:
    """The parent's cone test (the JAX package's ops/culling.py:134-167,
    which this repository's cull replaced): the depth window along the
    cone's axis and an angle test that wraps beyond pi."""
    near = _per_tile(near, cones.origin)
    far = _per_tile(far, cones.origin)
    rel = bounds.center[None, :, :] - cones.origin[:, None, :]
    dist = torch.linalg.vector_norm(rel, dim=-1)
    reff = bounds.radius[None, :] + cones.origin_radius[:, None]
    along = torch.sum(rel * cones.axis[:, None, :], dim=-1)
    in_window = (along + reff > near) & (along - reff < far)
    cos_to = along / torch.clamp(dist, min=1e-12)
    cos_half = cones.cos_half[:, None]
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half ** 2, min=0.0))
    sin_extra = torch.clamp(reff / torch.clamp(dist, min=1e-12), 0.0, 1.0)
    cos_limit = (cos_half * torch.sqrt(torch.clamp(1.0 - sin_extra ** 2,
                                                   min=0.0))
                 - sin_half * sin_extra)
    return bounds.any_valid[None, :] & in_window & (
        (cos_to >= cos_limit) | (dist <= reff))


def stats(num: np.ndarray) -> dict:
    num = num.astype(np.float64)
    return dict(mean=round(float(num.mean()), 1),
                p50=round(float(np.percentile(num, 50)), 1),
                p90=round(float(np.percentile(num, 90)), 1),
                p99=round(float(np.percentile(num, 99)), 1),
                max=int(num.max()))


def bounce1_rays(scene, camera, W: int, H: int):
    """The primary rays in pixel-tile order and the bounce-1 rays in the
    renderer's re-sorted order (the JAX tool's construction: the hit
    positions of a 1-bounce frame, directions mirrored off its normals)."""
    dev = scene.xyz.device
    gen = torch.Generator(device=dev).manual_seed(0)
    steps, _ = render_frame_fused(
        scene, camera, RenderSettings(), gen, W, H, num_bounces=1,
        max_hits=16, cull_cluster=128, max_clusters=96,
        max_clusters_secondary=160)
    d0 = primary_ray_directions(W, H, camera.fov_y, camera.c2w).reshape(-1, 3)
    o0 = camera.origin.expand_as(d0)
    nrm = steps.normal[0]
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1,
                                                     keepdim=True), min=1e-20)
    d1 = d0 - 2.0 * torch.sum(d0 * nrm, dim=-1, keepdim=True) * nrm
    o1 = o0 + steps.depth[0][:, None] * d0 + 1e-3 * d1
    frames, _ = build_frames(scene, 0.005, 3.0, 1.0)
    lo, hi = live_bounds(frames.mean, frames.valid)
    order, _ = secondary_order(o1, d1, steps.alive[0] > 0, lo, hi)
    perm = torch.as_tensor(tile_pixel_order(H, W, 16, 16)[0],
                           dtype=torch.int64, device=dev)
    return dict(primary=(o0[perm], d0[perm]),
                secondary=(o1[order], d1[order]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--cluster", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_cand_stats: no CUDA device (--device cpu "
                         "runs the plain versions)")
    W = H = args.res
    scene, camera = room(args.n, device)
    frames, _ = build_frames(scene, 0.005, 3.0, 1.0)
    frames = frames.take(morton_order(frames))
    bounds = cluster_bounds(frames, args.cluster)
    wide = ClusterBounds(bounds.center.to(WIDE), bounds.radius.to(WIDE),
                         bounds.any_valid)
    nc = int(bounds.any_valid.shape[0])
    out = {}
    for name, (ro, rd) in bounce1_rays(scene, camera, W, H).items():
        rows = {}
        for tile in TILES:
            _c, _n, num, _o, _t = select_candidates(
                ro, rd, bounds, NEAR[name], FAR, tile=tile, max_clusters=nc)
            cones = tile_cones(ro.to(WIDE), rd.to(WIDE), tile)
            parent = parent_visible(cones, wide, NEAR[name], FAR).sum(dim=1)
            rows[tile] = dict(stats(num.cpu().numpy()),
                              parent=stats(parent.cpu().numpy()))
            print(json.dumps({name: {tile: rows[tile]}}), flush=True)
        out[name] = rows
    summary = {k: {t: dict(mean=r["mean"], parent_mean=r["parent"]["mean"])
                   for t, r in v.items()} for k, v in out.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return out


if __name__ == "__main__":
    main()
