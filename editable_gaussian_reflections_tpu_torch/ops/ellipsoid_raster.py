"""Screen-space instanced ellipsoid rasterizer (twin of the JAX package's
ops/ellipsoid_raster.py; the reference's OpenGL EllipsoidViewer widget,
viewer/widgets/ellipsoid_viewer.py:1-426).

The GL widget draws one instanced box per Gaussian and ray-intersects the
exact ellipsoid in the fragment shader, with a z-buffer and two stages:

  stage 0 (solid):    alpha >= alpha_limit, depth-tested opaque,
                      color = max(0.5, dot(-dir, n)) * (rgb + 0.05) * 3
  stage 1 (floaters): alpha < alpha_limit, additive blend at 0.05 weight,
                      depth-tested against the solid z-buffer, no depth write

As in the JAX package this is a screen-tile z-buffer pass: each
ellipsoid's bounding sphere is tested against every 16x16-pixel tile's view
cone, each tile keeps its nearest ``max_per_tile`` candidates (a streaming
top-k over chunks of ``select_chunk`` ellipsoids, so memory stays bounded),
then each tile's pixels are resolved against its list with the fragment
shader's exact ray-ellipsoid quadratic.

Plain PyTorch: the JAX version is plain XLA (lax.scan and lax.top_k), not a
Pallas kernel.  The candidate order is lax.top_k's: nearest first, and among
equal priorities the lower id first (lax.top_k keeps the lower position,
which the streaming merge turns into the lower id); torch.topk promises no
order on ties, so it runs on an integer key (priority bits, id) that has
none.  The shading's z-test is strict, so the first candidate in that order
wins an exact depth tie, as in the JAX package.  Short sums are spelled out
and reductions summed in float64 (ops/precision.py), so a CPU and a GPU
rasterize alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .camera_rays import primary_ray_directions
from .precision import WIDE, dot, norm, rounded
from .quaternion import quat_to_rotmat

# a priority key's top half: float32 bits of +inf, above any overlap's
_NO_CANDIDATE = 0x7F800000


class RasterOutput(NamedTuple):
    rgb: torch.Tensor     # [H, W, 3] clamped display color (black background)
    depth: torch.Tensor   # [H, W] view-axis depth of the solid hit (0 = none)
    gid: torch.Tensor     # [H, W] int32 Gaussian index of the solid hit (-1)
    normal: torch.Tensor  # [H, W, 3] world-space surface normal of the hit


def _tile_pixels(arr, th, tw, tile):
    """[H, W, ...] -> [T, tile*tile, ...] row-major tiles."""
    lead = (th, tile, tw, tile) + tuple(arr.shape[2:])
    x = arr.reshape(lead).movedim(2, 1)  # [th, tw, tile, tile, ...]
    return x.reshape((th * tw, tile * tile) + tuple(arr.shape[2:]))


def _untile_pixels(arr, th, tw, tile, height, width):
    """[T, tile*tile, ...] -> [H, W, ...]."""
    x = arr.reshape((th, tw, tile, tile) + tuple(arr.shape[2:]))
    return x.movedim(2, 1).reshape((height, width) + tuple(arr.shape[2:]))


def _select_candidates(centers, r_bound, cam_center, dirs_t, mask,
                       max_per_tile, chunk):
    """Per-tile nearest-``max_per_tile`` candidate ids via a streaming top-k
    (the JAX docstring's tile-cone vs bounding-sphere test; priority is the
    nearest possible hit, dist - r).  Returns (ids [T, M] int64 with 0 in
    empty entries, valid [T, M] bool)."""
    n = centers.shape[0]
    dev = centers.device
    axis = (dirs_t.to(WIDE).sum(1) / dirs_t.shape[1]).to(dirs_t.dtype)
    axis = axis / torch.clamp(norm(axis, keepdim=True), min=1e-12)
    cos_half = torch.clamp(
        torch.amin(dot(dirs_t, axis[:, None, :]), dim=1), -1.0, 1.0)
    sin_half = rounded(torch.sqrt,
                       torch.clamp(1.0 - cos_half * cos_half, min=0.0))

    best = torch.full((dirs_t.shape[0], max_per_tile),
                      _NO_CANDIDATE << 32, dtype=torch.int64, device=dev)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        to_c = centers[start:stop] - cam_center[None, :]       # [C, 3]
        dist = norm(to_c)
        dirn = to_c / torch.clamp(dist, min=1e-12)[:, None]
        cosg = (axis[:, None, 0] * dirn[None, :, 0]
                + axis[:, None, 1] * dirn[None, :, 1]
                + axis[:, None, 2] * dirn[None, :, 2])          # [T, C]
        r = r_bound[start:stop]
        # angle(axis, center) <= half + asin(r/dist), in cosine space
        sin_r = torch.clamp(r / torch.clamp(dist, min=1e-12), 0.0, 1.0)
        cos_r = rounded(torch.sqrt, torch.clamp(1.0 - sin_r * sin_r,
                                                min=0.0))
        cos_sum = (cos_half[:, None] * cos_r[None, :]
                   - sin_half[:, None] * sin_r[None, :])
        overlap = (((cosg >= cos_sum) | (dist <= r)[None, :])
                   & mask[start:stop][None, :])
        prio = torch.clamp(dist - r, min=0.0)
        # non-negative float32 bits order as the floats do
        key = (prio.view(torch.int32).to(torch.int64) << 32) | torch.arange(
            start, stop, dtype=torch.int64, device=dev)
        key = torch.where(overlap, key[None, :],
                          (_NO_CANDIDATE << 32) | key[None, :] & 0xFFFFFFFF)
        best = torch.topk(torch.cat([best, key], dim=1), max_per_tile,
                          dim=1, largest=False, sorted=True).values
    valid = (best >> 32) < _NO_CANDIDATE
    ids = torch.where(valid, best & 0xFFFFFFFF, 0)
    return ids, valid


def _shade_pass(cand_ids, cand_valid, dirs_t, dv_t, centers, quats, radii,
                colors, cam_center, znear, zfar, tmin_init,
                write_depth=True):
    """Resolve one stage's candidate lists against tile pixels, candidate by
    candidate in list order.

    Returns (tmin [T,P] view depth of nearest hit or inf, rgb [T,P,3],
    gid [T,P], nrm [T,P,3], add [T,P,3] accumulated 0.05-weight shaded
    color).  ``write_depth=False`` makes the z-buffer read-only (stage 1)."""
    t_count, p_count = dirs_t.shape[:2]
    dev = dirs_t.device
    tmin = tmin_init
    rgb = torch.zeros((t_count, p_count, 3), device=dev)
    gid = torch.full((t_count, p_count), -1, dtype=torch.int32, device=dev)
    nrm = torch.zeros((t_count, p_count, 3), device=dev)
    add = torch.zeros((t_count, p_count, 3), device=dev)
    for j in range(cand_ids.shape[1]):
        ids = cand_ids[:, j]
        ok = cand_valid[:, j]
        c = centers[ids]                   # [T, 3]
        rot = quat_to_rotmat(quats[ids])   # [T, 3, 3] world = R @ local
        rad = radii[ids]                   # [T, 3]
        col = colors[ids]                  # [T, 3]

        # exact ray-ellipsoid quadratic in the unit-sphere frame
        rel = cam_center[None, :] - c
        o_l = dot(rot.transpose(1, 2), rel[:, None, :]) / rad        # [T, 3]
        d_l = (dot(rot.transpose(1, 2)[:, None, :, :],
                   dirs_t[:, :, None, :])
               / rad[:, None, :])                                    # [T,P,3]
        a = dot(d_l, d_l)
        b = 2.0 * dot(o_l[:, None, :], d_l)
        cc = (dot(o_l, o_l) - 1.0)[:, None]
        disc = b * b - 4.0 * a * cc
        sq = rounded(torch.sqrt, torch.clamp(disc, min=0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        t = torch.where(t1 * dv_t >= znear, t1, t2)  # camera inside: far root
        depth = t * dv_t
        hit = ((disc >= 0.0) & (depth >= znear) & (depth <= zfar)
               & ok[:, None])

        u = o_l[:, None, :] + t[..., None] * d_l   # |u| = 1 at the surface
        n_l = u / rad[:, None, :]
        n_w = dot(rot[:, None, :, :], n_l[:, :, None, :])
        n_w = n_w / torch.clamp(norm(n_w, keepdim=True), min=1e-12)
        align = torch.clamp(-dot(dirs_t, n_w), min=0.5)
        shade = align[..., None] * (col[:, None, :] + 0.05) * 3.0

        front = hit & (depth < tmin)
        if write_depth:
            tmin = torch.where(front, depth, tmin)
        f3 = front[..., None]
        rgb = torch.where(f3, shade, rgb)
        gid = torch.where(front, ids[:, None].to(torch.int32), gid)
        nrm = torch.where(f3, n_w, nrm)
        add = add + torch.where(f3, 0.05 * shade, 0.0)
    return tmin, rgb, gid, nrm, add


def rasterize_ellipsoids(centers, rotations, radii, colors, alphas, valid,
                         c2w_rotation, camera_center, fovy, width, height,
                         znear=0.01, zfar=1e6, alpha_limit=0.2,
                         render_floaters=False, max_per_tile=64, tile=16,
                         select_chunk=4096):
    """Rasterize N solid ellipsoids into an [H, W] frame (RasterOutput).

    centers [N,3], rotations [N,4] (unnormalized quats, scalar-first),
    radii [N,3] (final half-axes - the caller applies the widget's
    2 * scale * scaling_modifier), colors [N,3], alphas [N] (activated),
    valid [N] bool, all float32 on one device.  Camera as in
    ops.camera_rays.  width/height must be multiples of ``tile``."""
    if width % tile or height % tile:
        raise ValueError(f"width/height must be multiples of tile={tile}")
    th, tw = height // tile, width // tile
    rotations = rotations / torch.clamp(norm(rotations, keepdim=True),
                                        min=1e-12)
    # host scalars meet float32 values as float32 (as under jax.jit)
    znear, zfar, alpha_limit = (float(np.float32(v))
                                for v in (znear, zfar, alpha_limit))

    dirs = primary_ray_directions(width, height, fovy, c2w_rotation)
    dirs_t = _tile_pixels(dirs, th, tw, tile)                # [T, P, 3]
    view = -c2w_rotation[:, 2]
    dv_t = dot(dirs_t, view)                                 # [T, P]

    # bounding sphere per ellipsoid; basic depth eligibility (the cone test
    # inside _select_candidates does the per-tile visibility)
    rel = centers - camera_center[None, :]
    zdepth = -dot(rel, c2w_rotation[:, 2])
    r_bound = torch.amax(radii, dim=-1)
    base_mask = (valid & ((zdepth + r_bound) > znear)
                 & ((zdepth - r_bound) < zfar))

    solid_ids, solid_ok = _select_candidates(
        centers, r_bound, camera_center, dirs_t,
        base_mask & (alphas >= alpha_limit), max_per_tile, select_chunk)
    t_count, p_count = dirs_t.shape[:2]
    inf_z = torch.full((t_count, p_count), float("inf"),
                       device=dirs_t.device)
    tmin, rgb, gid, nrm, _ = _shade_pass(
        solid_ids, solid_ok, dirs_t, dv_t, centers, rotations, radii,
        colors, camera_center, znear, zfar, inf_z)

    if render_floaters:
        # stage 1: additive 0.05-weight blend, depth-tested against the
        # solid z-buffer, no depth write (GL_SRC_ALPHA/GL_ONE, depth mask
        # off): order-independent up to the per-tile candidate cap
        flt_ids, flt_ok = _select_candidates(
            centers, r_bound, camera_center, dirs_t,
            base_mask & (alphas < alpha_limit), max_per_tile, select_chunk)
        _, _, _, _, add = _shade_pass(
            flt_ids, flt_ok, dirs_t, dv_t, centers, rotations, radii,
            colors, camera_center, znear, zfar, tmin, write_depth=False)
        rgb = rgb + add

    hit = torch.isfinite(tmin)
    rgb = torch.clamp(torch.where(hit[..., None], rgb, 0.0), 0.0, 1.0)
    depth = torch.where(hit, tmin, 0.0)
    return RasterOutput(
        rgb=_untile_pixels(rgb, th, tw, tile, height, width),
        depth=_untile_pixels(depth, th, tw, tile, height, width),
        gid=_untile_pixels(gid, th, tw, tile, height, width),
        normal=_untile_pixels(nrm, th, tw, tile, height, width),
    )


def rasterize_scene(scene, colors, c2w_rotation, camera_center, fovy,
                    width, height, scaling_modifier=0.5, **kwargs):
    """Widget-parameter convenience wrapper over a GaussianScene: half-axes
    2 * exp(scaling) * scaling_modifier (default 0.5, the 1-sigma
    ellipsoid), alpha = sigmoid(opacity), valid = live_mask."""
    from .activations import sigmoid_act

    radii = 2.0 * rounded(torch.exp, scene.scaling) * scaling_modifier
    return rasterize_ellipsoids(
        scene.xyz, scene.rotation, radii, colors,
        rounded(sigmoid_act, scene.opacity), scene.live_mask,
        c2w_rotation, camera_center, fovy, width, height, **kwargs)
