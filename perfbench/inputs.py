"""The benchmark's inputs, made from the seed on the device: the synthetic
room's Gaussians, the ring of cameras around it, the training targets and
the random numbers each step or frame consumes.

These generators are the benchmark's own and stay as they are, so that no
change to the program moves what it is measured on.

- `room_arrays` follows the port's utils/synth.py room_scene (a box of six
  walls, three spherical objects of surface points, a far-field shell), with
  the surface and far-field counts given apart, torch's generator on the
  device in place of numpy's, and the objects' layout the same for every
  seed (`room_layout`).
- `ring_cameras` places `n` cameras on a ring around room_camera's pose,
  +-0.25 rad about the vertical axis, as the port's tools/fused_setup.py
  orbit_views does.
- `analytic_targets` are G-buffers of the room's box and objects computed
  by ray intersection: the targets a synthetic ground-truth dataset would
  hold, not rendered by the program.
"""

from __future__ import annotations

import math

import torch

EXTENT = 3.0
ZNEAR, ZFAR = 0.05, 50.0
FOV_Y = 0.9
# the room's wall and object materials (the walls are rough, the floor and
# the objects shiny, as in room_scene)
WALL_ROUGHNESS, SHINY_ROUGHNESS, DIELECTRIC_F0 = 0.6, 0.08, 0.04
# the seed of the room's fixed layout (room_layout)
LAYOUT_SEED = 0


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def room_layout(device, extent: float = EXTENT):
    """The objects' centres [3, 3] and radii [3] and the shiny f0: one
    fixed room for every seed (drawn once from LAYOUT_SEED on the host), so
    that a seed changes which points, scales and colours the room gets and
    not how much of it a frame sees."""
    gen = torch.Generator().manual_seed(LAYOUT_SEED)
    centers = _uniform(gen, (3, 3), -extent * 0.5, extent * 0.5, "cpu")
    centers[:, 2] = extent * 0.75
    radii = _uniform(gen, (3,), 0.3, 0.7, "cpu")
    shiny_f0 = float(_uniform(gen, (1,), 0.3, 0.9, "cpu"))
    return centers.to(device), radii.to(device), shiny_f0


def room_arrays(gen: torch.Generator, n_surface: int, n_farfield: int,
                layout, extent: float = EXTENT) -> dict:
    """The room's raw Gaussian parameters (float32 on gen's device), the
    fields of the program's GaussianScene without live_mask."""
    dev = gen.device
    centers, radii, shiny_f0 = layout
    per_wall = n_surface // 8
    pts, nrm = [], []
    for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)):
        p = _uniform(gen, (per_wall, 3), -extent, extent, dev)
        p[:, 2] = p[:, 2] * 0.25 + extent * 0.75
        p[:, axis] = sign * extent
        if axis == 2:
            p[:, 2] = extent * (0.5 if sign < 0 else 1.5)
        normal = torch.zeros((per_wall, 3), device=dev)
        normal[:, axis] = -sign
        pts.append(p)
        nrm.append(normal)
    n_obj = n_surface - 6 * per_wall
    per_obj = n_obj // 3
    for i in range(3):
        cnt = per_obj if i < 2 else n_obj - 2 * per_obj
        v = torch.randn((cnt, 3), generator=gen, device=dev)
        v = v / v.norm(dim=1, keepdim=True)
        pts.append(centers[i] + radii[i] * v)
        nrm.append(v)
    v = torch.randn((n_farfield, 3), generator=gen, device=dev)
    v = v / v.norm(dim=1, keepdim=True)
    pts.append(v * extent * 4.0)
    nrm.append(torch.zeros((n_farfield, 3), device=dev))
    xyz = torch.cat(pts)
    normal = torch.cat(nrm)
    n = xyz.shape[0]
    base_scale = extent * 2.0 / math.sqrt(max(n_surface, 1)) * 2.0
    scaling = torch.log(_uniform(gen, (n, 3), 0.5, 1.5, dev) * base_scale)
    scaling[n - n_farfield:] = math.log(base_scale * 4.0)
    rotation = torch.randn((n, 4), generator=gen, device=dev)
    opacity = torch.full((n,), inverse_sigmoid(0.5), device=dev)
    opacity[n - n_farfield:] = inverse_sigmoid(0.1)
    diffuse = _uniform(gen, (n, 3), 0.1, 0.9, dev)
    f0 = torch.full((n, 3), DIELECTRIC_F0, device=dev)
    index = torch.arange(n, device=dev)
    shiny = (normal[:, 2] > 0.9) | ((index >= 6 * per_wall)
                                    & (index < n_surface))
    f0[shiny] = shiny_f0
    roughness = _uniform(gen, (n,), 0.3, 0.9, dev)
    roughness[shiny] = SHINY_ROUGHNESS
    return dict(xyz=xyz, scaling=scaling, rotation=rotation,
                opacity=opacity, diffuse=diffuse, normal=normal, f0=f0,
                roughness=roughness)


def room_camera(extent: float = EXTENT):
    """The room camera's eye [3] and camera-to-world rotation [3, 3]
    (columns right, up, backward; directions are c2w @ [x, y, -1])."""
    eye = torch.tensor([0.0, -extent * 0.8, extent * 0.9], dtype=torch.float64)
    target = torch.tensor([0.0, 0.0, extent * 0.75], dtype=torch.float64)
    fwd = target - eye
    fwd = fwd / fwd.norm()
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    right = torch.linalg.cross(fwd, up)
    right = right / right.norm()
    down = torch.linalg.cross(fwd, right)
    c2w = torch.stack([right, -down, -fwd], dim=1)
    return eye.to(torch.float32), c2w.to(torch.float32)


def ring_cameras(n: int, device) -> list:
    """`n` (origin [3], c2w [3, 3]) poses circling the vertical axis around
    room_camera's pose, +-0.25 rad, float32 on `device`."""
    eye, c2w = room_camera()
    poses = []
    for i in range(n):
        a = -0.25 + 0.5 * i / max(1, n - 1)
        rz = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                           [math.sin(a), math.cos(a), 0.0],
                           [0.0, 0.0, 1.0]], dtype=torch.float32)
        poses.append(((rz @ eye).to(device), (rz @ c2w).to(device)))
    return poses


def cameras_extent(poses) -> float:
    """The scene extent a dataset of these cameras gets (3DGS's
    getNerfppNorm: 1.1 x the largest distance of a camera centre from their
    mean), which scales the xyz learning rate."""
    centers = torch.stack([o.double().cpu() for o, _ in poses])
    mean = centers.mean(dim=0)
    return float((centers - mean).norm(dim=1).max()) * 1.1


def pixel_directions(width: int, height: int, c2w: torch.Tensor,
                     fov_y: float = FOV_Y) -> torch.Tensor:
    """Unit directions [H*W, 3] through the pixel centres, linear pixel
    order (row-major, y down)."""
    dev = c2w.device
    tan_y = math.tan(fov_y / 2.0)
    tan_x = tan_y * width / height
    x = ((torch.arange(width, device=dev) + 0.5) / width * 2.0 - 1.0) * tan_x
    y = (1.0 - (torch.arange(height, device=dev) + 0.5) / height * 2.0) * tan_y
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    local = torch.stack([xx, yy, -torch.ones_like(xx)], dim=-1).reshape(-1, 3)
    d = local @ c2w.T
    return d / d.norm(dim=1, keepdim=True)


def _nearest_surface(o, d, layout, extent):
    """(t, normal, surface id) of each ray's nearest hit on the box's
    inside or an object (ids 0-5 walls, 6-8 objects; rays start inside)."""
    centers, radii, _f0 = layout
    lo = torch.tensor([-extent, -extent, 0.5 * extent], device=o.device)
    hi = torch.tensor([extent, extent, 1.5 * extent], device=o.device)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t_far_axes = torch.where(d > 0, (hi - o) * inv, (lo - o) * inv)
    t, axis = t_far_axes.min(dim=1)
    sign = torch.gather(torch.sign(d), 1, axis[:, None])[:, 0]
    normal = torch.zeros_like(o)
    normal.scatter_(1, axis[:, None], -sign[:, None])
    surface = axis * 2 + (sign > 0).to(torch.int64)
    for i in range(3):
        oc = o - centers[i]
        b = (oc * d).sum(dim=1)
        c = (oc * oc).sum(dim=1) - radii[i] ** 2
        disc = b * b - c
        ts = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (ts > 1e-4) & (ts < t)
        t = torch.where(hit, ts, t)
        p = o + ts[:, None] * d
        n_s = (p - centers[i]) / radii[i]
        normal = torch.where(hit[:, None], n_s, normal)
        surface = torch.where(hit, torch.full_like(surface, 6 + i), surface)
    return t, normal, surface


def analytic_targets(gen: torch.Generator, poses, width: int, height: int,
                     layout, extent: float = EXTENT) -> list:
    """Per camera, the G-buffers of the room's nearest surface through each
    pixel centre (float32 on gen's device, [H*W, ...] in linear pixel
    order): diffuse (a colour per surface, drawn from `gen`), specular (the
    f0-weighted diffuse of the mirror reflection's surface), depth, normal,
    roughness and f0 - the fields of the program's RayTargets."""
    dev = gen.device
    colors = _uniform(gen, (9, 3), 0.1, 0.9, dev)
    _c, _r, shiny_f0 = layout
    shiny = torch.zeros(9, dtype=torch.bool, device=dev)
    shiny[4] = True                      # the floor (z = 0.5 extent)
    shiny[6:] = True                     # the objects
    f0_of = torch.where(shiny, shiny_f0, DIELECTRIC_F0)
    rough_of = torch.where(shiny, SHINY_ROUGHNESS, WALL_ROUGHNESS)
    out = []
    for eye, c2w in poses:
        d = pixel_directions(width, height, c2w)
        o = eye.expand_as(d)
        t, normal, surf = _nearest_surface(o, d, layout, extent)
        p = o + t[:, None] * d
        r = d - 2.0 * (d * normal).sum(dim=1, keepdim=True) * normal
        _t2, _n2, surf2 = _nearest_surface(p + 1e-3 * r, r, layout, extent)
        f0 = f0_of[surf][:, None].expand(-1, 3).contiguous()
        out.append(dict(
            diffuse=colors[surf], specular=f0 * colors[surf2], depth=t,
            normal=normal, roughness=rough_of[surf], f0=f0))
    return out


def frame_samples(gen: torch.Generator, width: int, height: int,
                  num_steps: int):
    """One frame's (jitter [H, W, 2] in [-0.5, 0.5), us [S, H*W, 2]): the
    fields of the program's FrameSamples."""
    dev = gen.device
    jit = torch.rand((height, width, 2), generator=gen, device=dev) - 0.5
    us = torch.rand((num_steps, height * width, 2), generator=gen, device=dev)
    return jit, us


def tile_samples(gen: torch.Generator, width: int, height: int, tile: int,
                 num_steps: int):
    """One training step's (jitter [H, W, 2], us [T, S, tile, 2]): the
    fields of the program's TileSamples."""
    dev = gen.device
    jit = torch.rand((height, width, 2), generator=gen, device=dev) - 0.5
    T = -(-(width * height) // tile)
    us = torch.rand((T, num_steps, tile, 2), generator=gen, device=dev)
    return jit, us
