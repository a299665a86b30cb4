"""Spatial acceleration: Morton clustering + per-tile cone/sphere culling.

Twin of the JAX ops/culling.py.  Gaussians are sorted by the Morton code of
their means and grouped into fixed-size clusters with bounding spheres; a
ray tile is bounded by a cone, and a cluster survives culling iff its sphere
meets the cone within [near, far].  The per-tile candidate lists, nearest
first, feed the render kernel.

Parity rules: every sort is stable (jnp.argsort is), and lax.top_k's
tie-break toward the lower index is a stable ascending sort.  Morton codes
are int64 - the dead key 0xFFFFFFFF and the liveness bit 1 << 26 fit.

Cluster bounds and the cone tests accumulate in ops/precision.py's WIDE
float (results rounded once to float32): the candidate lists then do not
depend on the device's reduction order, so CPU and GPU renders cull
identically.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .intersect import GaussianFrames
from .precision import WIDE, dot

DEAD_KEY = 0xFFFFFFFF


def morton_codes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 bits: int = 10) -> torch.Tensor:
    """Quantize points into a [0, 2^bits)^3 grid and interleave bits (int64)."""
    q = torch.clamp(
        (points - lo) / torch.clamp(hi - lo, min=1e-12) * (2**bits - 1),
        0, 2**bits - 1,
    ).to(torch.int64)

    def spread(x):
        # spread 10 bits to every 3rd position
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def live_bounds(points: torch.Tensor, live: torch.Tensor):
    """Per-axis min and max of the live points."""
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
    lo = torch.where(live[:, None], points, inf).amin(dim=0)
    hi = torch.where(live[:, None], points, -inf).amax(dim=0)
    return lo, hi


def morton_order(frames: GaussianFrames) -> torch.Tensor:
    """Permutation sorting live Gaussians by Morton code (dead ones last)."""
    live = frames.valid
    lo, hi = live_bounds(frames.mean, live)
    codes = morton_codes(frames.mean, lo, hi)
    key = torch.where(live, codes, torch.full_like(codes, DEAD_KEY))
    return torch.sort(key, stable=True).indices


def sort_within_clusters(frames: GaussianFrames, view_dir: torch.Tensor,
                         cluster: int) -> torch.Tensor:
    """Permutation depth-sorting the Gaussians of each `cluster`-sized group
    along `view_dir`, keeping cluster membership (cluster_bounds and the
    candidate lists are unchanged).  The scan composite follows table order
    within a chunk, so this brings it closer to per-ray depth order.  The
    depth dot is spelled out (ops/precision.py) and the sort is stable, as
    jnp.argsort is, so ties break alike on every device."""
    n = frames.mean.shape[0]
    if n % cluster:
        raise ValueError(f"capacity {n} is not a multiple of cluster {cluster}")
    depth = dot(frames.mean, view_dir.to(frames.mean.dtype)[None, :])
    order = torch.sort(depth.reshape(n // cluster, cluster), dim=1,
                       stable=True).indices
    base = torch.arange(0, n, cluster, device=order.device)[:, None]
    return (order + base).reshape(-1)


class ClusterBounds(NamedTuple):
    center: torch.Tensor     # [NC, 3]
    radius: torch.Tensor     # [NC]
    any_valid: torch.Tensor  # [NC] bool


def cluster_bounds(frames: GaussianFrames, cluster: int = 256) -> ClusterBounds:
    """Bounding sphere per cluster of `cluster` consecutive Gaussians.

    Radius covers each member's ellipsoid: |mean - c| + max(sizes) where
    sizes = exp(scale)*sf (the alpha-threshold clip extent)."""
    n = frames.mean.shape[0]
    if n % cluster:
        raise ValueError(f"capacity {n} is not a multiple of cluster {cluster}")
    nc = n // cluster
    mean = frames.mean.to(WIDE).reshape(nc, cluster, 3)
    valid = frames.valid.reshape(nc, cluster)
    inv_sizes = frames.inv_sizes.to(WIDE)
    sizes = torch.where(inv_sizes > 0,
                        1.0 / torch.clamp(inv_sizes, min=1e-30),
                        torch.zeros_like(inv_sizes))
    extent = sizes.amax(dim=-1).reshape(nc, cluster)

    w = valid[..., None].to(WIDE)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    center = torch.sum(mean * w, dim=1) / cnt
    dist = torch.linalg.vector_norm(mean - center[:, None, :], dim=-1)
    radius = torch.where(valid, dist + extent,
                         torch.zeros_like(dist)).amax(dim=1)
    center, radius = center.to(torch.float32), radius.to(torch.float32)
    return ClusterBounds(center=center, radius=radius,
                         any_valid=valid.any(dim=1))


class TileCones(NamedTuple):
    origin: torch.Tensor         # [T, 3] apex (mean ray origin)
    origin_radius: torch.Tensor  # [T] max distance of any ray origin to apex
    axis: torch.Tensor           # [T, 3] mean direction (normalized)
    cos_half: torch.Tensor       # [T] cos of the cone half-angle


def tile_cones(rays_o: torch.Tensor, rays_d: torch.Tensor,
               tile: int) -> TileCones:
    """Bounding cone of each tile of `tile` consecutive rays."""
    R = rays_o.shape[0]
    if R % tile:
        raise ValueError(f"{R} rays is not a multiple of tile {tile}")
    T = R // tile
    o = rays_o.reshape(T, tile, 3)
    d = rays_d.reshape(T, tile, 3)
    origin = torch.mean(o, dim=1)
    origin_radius = torch.linalg.vector_norm(
        o - origin[:, None, :], dim=-1).amax(dim=1)
    axis = torch.mean(d, dim=1)
    axis = axis / torch.clamp(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    cos_half = torch.sum(d * axis[:, None, :], dim=-1).amin(dim=1)
    return TileCones(origin, origin_radius, axis,
                     torch.clamp(cos_half, -1.0, 1.0))


def _per_tile(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-tile [T] depth bound as a [T or 1, 1] tensor."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x[:, None] if x.ndim == 1 else x


def cone_sphere_visible(cones: TileCones, bounds: ClusterBounds,
                        near, far) -> torch.Tensor:
    """[T, NC] conservative visibility: does the cluster sphere intersect the
    tile's (expanded) cone within the depth window?  `near` / `far` may be
    scalars or per-tile [T] tensors.

    Conservative for every ray of the tile (unit direction within the cone,
    origin within origin_radius of the apex), whatever the cone's width and
    `near`: a ray meets the sphere only at t <= |c - o| + r <= dist + reff,
    and where the cone is narrower than 90 degrees also at t <= (along +
    reff) / cos_half (its direction's component along the axis is at least
    cos_half); it meets it at t >= along - reff.  The JAX package tests
    along + reff > near, which drops clusters a slanted ray hits beyond
    near, and its angle test wraps once half + extra passes pi; both are
    repaired here, and the lists are a superset of JAX's, equal to them for
    the narrow cones of primary passes."""
    near = _per_tile(near, cones.origin)
    far = _per_tile(far, cones.origin)
    rel = bounds.center[None, :, :] - cones.origin[:, None, :]   # [T, NC, 3]
    dist = torch.linalg.vector_norm(rel, dim=-1)                 # [T, NC]
    reff = bounds.radius[None, :] + cones.origin_radius[:, None]
    cos_half = cones.cos_half[:, None]

    # depth window: the deepest t at which a ray of the tile can meet the
    # sphere against near, the shallowest against far
    along = torch.sum(rel * cones.axis[:, None, :], dim=-1)
    deepest = torch.where(
        cos_half > 0,
        torch.minimum(dist + reff,
                      (along + reff) / torch.clamp(cos_half, min=1e-30)),
        dist + reff)
    in_window = (deepest > near) & (along - reff < far)

    # angle test: angle(rel, axis) <= half_angle + asin(reff/dist)
    cos_to = along / torch.clamp(dist, min=1e-12)
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half**2, min=0.0))
    sin_extra = torch.clamp(reff / torch.clamp(dist, min=1e-12), 0.0, 1.0)
    # cos(a+b) = cos a cos b - sin a sin b ; visible iff cos_to >= cos(a+b)
    cos_limit = (cos_half * torch.sqrt(torch.clamp(1.0 - sin_extra**2, min=0.0))
                 - sin_half * sin_extra)
    # ... while a + b < pi: cos is not monotonic beyond, where every
    # direction passes (a >= pi/2 and b >= pi - a, i.e. sin b >= sin a)
    wraps = (cos_half <= 0) & (sin_extra >= sin_half)
    in_cone = (cos_to >= cos_limit) | wraps
    inside = dist <= reff  # apex inside the sphere

    return bounds.any_valid[None, :] & in_window & (in_cone | inside)


def select_candidates(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      bounds: ClusterBounds, near, far, tile: int = 256,
                      max_clusters: int = 64):
    """Per-tile candidate cluster lists, nearest-first along the tile axis.

    Overflow beyond max_clusters drops the FARTHEST clusters; their hits are
    absent and not tail-corrected (the renderer's starved metric reports
    the rays that could have seen them).  Returns (candidates int32 [T, MC]
    (-1 = empty), cand_near f32 [T, MC] conservative near distance
    (3e38 when empty), num [T], overflow [T], t_drop f32 [T] - near distance
    of the first dropped cluster, +inf when none were dropped)."""
    cones = tile_cones(rays_o.to(WIDE), rays_d.to(WIDE), tile)
    bounds = ClusterBounds(bounds.center.to(WIDE), bounds.radius.to(WIDE),
                           bounds.any_valid)
    vis = cone_sphere_visible(cones, bounds, near, far)      # [T, NC]

    rel = bounds.center[None] - cones.origin[:, None]
    along = torch.sum(rel * cones.axis[:, None, :], dim=-1)  # [T, NC]
    near_dist = along - (bounds.radius[None] + cones.origin_radius[:, None])
    near_dist = near_dist.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=near_dist.dtype,
                       device=near_dist.device)
    key = torch.where(vis, near_dist, inf)
    # one extra entry: the first dropped cluster's near distance t_drop
    kk = min(max_clusters + 1, key.shape[1])
    nearest, idx = torch.sort(key, dim=1, stable=True)
    nearest, idx = nearest[:, :kk], idx[:, :kk]
    got = torch.isfinite(nearest[:, :max_clusters])
    candidates = torch.where(got, idx[:, :max_clusters],
                             torch.full_like(idx[:, :max_clusters], -1)
                             ).to(torch.int32)
    cand_near = torch.where(got, nearest[:, :max_clusters],
                            torch.full_like(nearest[:, :max_clusters], 3e38))
    num = got.to(torch.int32).sum(dim=1, dtype=torch.int32)
    overflow = vis.sum(dim=1) > max_clusters
    if kk > max_clusters:
        last = nearest[:, max_clusters]
        t_drop = torch.where(torch.isfinite(last), last, inf)
    else:
        t_drop = torch.full(key.shape[:1], float("inf"), dtype=key.dtype,
                            device=key.device)
    return candidates, cand_near, num, overflow, t_drop


def tile_pixel_order(height: int, width: int, th: int = 8, tw: int = 8):
    """Permutation grouping pixels into th x tw screen tiles (square tiles
    give tight cones).  Returns (perm, inv_perm) numpy int32 arrays:
    rays_tiled = rays[perm], outputs_linear = outputs_tiled[inv_perm]."""
    if height % th or width % tw:
        raise ValueError(f"{height}x{width} does not tile by {th}x{tw}")
    idx = np.arange(height * width, dtype=np.int32).reshape(height, width)
    tiles = (idx.reshape(height // th, th, width // tw, tw)
             .transpose(0, 2, 1, 3).reshape(-1))
    inv = np.empty_like(tiles)
    inv[tiles] = np.arange(tiles.size, dtype=np.int32)
    return tiles, inv
