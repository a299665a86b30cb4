"""Hand-written, loss-fused render backward (twin of the JAX
ops/render_grads.py, itself the twin of the reference's backward_pass.cu).

The reference's training gradients are deliberately not autograd: L1-sign
loss gradients with per-attribute weights, no pixel averaging, truncated-
tail correction terms, roughness downweighting, and no gradient through the
bounce chain.  This module writes the same algebra by hand over the [R, K]
hit records; torch.autograd is not used.

The back-to-front "weighted deltas" accumulators (backward_pass.cu:17-148)
telescope into wd_i = c_i * T_i - sum_{j>i} w_j c_j, evaluated with reverse
cumulative sums along the hit axis.

Numerics (ops/precision.py): float32 in the JAX operation order, with
  * the [.., 3, 3] products written per element, so no [R, K, 3, 3] tensor
    is materialised and every 3- and 4-term sum runs in a spelled-out order;
  * the reverse cumulative sums along K in WIDE, rounded once;
  * pow and the quaternion norm from WIDE, rounded once.
The per-Gaussian scatter (backward_pass.cu:209-220) is a float64
accumulation rounded once (ops/cuda/scatter.py), so its sums do not depend
on the order the hits arrive in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .activations import backward_normalize_act, backward_sigmoid_act
from .composite import CompositeOut
from .plain.scatter import scatter_add
from .gaussian_kernel import MAX_ALPHA
from .precision import WIDE, dot, norm, rounded
from .trace import RayHits


class ParamGrads(NamedTuple):
    """Gradients w.r.t. the raw (pre-activation) Gaussian parameters."""

    mean: torch.Tensor       # [N, 3]
    scale: torch.Tensor      # [N, 3]
    rotation: torch.Tensor   # [N, 4]
    opacity: torch.Tensor    # [N]
    rgb: torch.Tensor        # [N, 3]
    normal: torch.Tensor     # [N, 3]
    f0: torch.Tensor         # [N, 3]
    roughness: torch.Tensor  # [N]
    total_weight: torch.Tensor  # [N]

    def __add__(self, other):
        return ParamGrads(*(a + b for a, b in zip(self, other)))

    def take(self, idx: torch.Tensor) -> "ParamGrads":
        """Rows reordered by `idx`."""
        return ParamGrads(*(a[idx] for a in self))


# the scatter's 22 columns, in the JAX package's _SCATTER_FIELDS order
SCATTER_FIELDS = (("mean", 3), ("scale", 3), ("rotation", 4),
                  ("opacity", 1), ("rgb", 3), ("normal", 3), ("f0", 3),
                  ("roughness", 1), ("total_weight", 1))
SCATTER_COLS = sum(n for _, n in SCATTER_FIELDS)


def sign(x: torch.Tensor) -> torch.Tensor:
    """misc.cu sign: -1/0/+1."""
    return torch.sign(x)


def _rev_cumsum_inclusive(x: torch.Tensor) -> torch.Tensor:
    """sum_{j>=i} x_j along axis 1, in WIDE and rounded once."""
    w = torch.flip(x.to(WIDE), dims=(1,))
    return torch.flip(torch.cumsum(w, dim=1), dims=(1,)).to(x.dtype)


def _weighted_deltas(c, w, T_after):
    """wd_i = c_i * T_i - sum_{j>i} w_j c_j  (module docstring).

    c: [R, K] or [R, K, 3]; w, T_after: [R, K]."""
    if c.ndim == 3:
        w = w[..., None]
        T_after = T_after[..., None]
    wc = w * c
    s = _rev_cumsum_inclusive(wc)
    return c * T_after - (s - wc)


def backward_step(
    hits: RayHits,
    comp: CompositeOut,
    # per-(ray, hit) Gaussian data
    g_rgb, g_normal, g_f0, g_roughness,   # activated, [R,K,3] / [R,K]
    g_opacity,                            # activated (sigmoid), [R,K]
    g_scaling,                            # activated exp(scale), [R,K,3]
    g_rotation_raw,                       # raw quaternion, [R,K,4]
    g_rot,                                # rotation matrix, [R,K,3,3]
    g_inv_sizes,                          # 1/(exp(scale)*sf*gsf), [R,K,3]
    g_sf,                                 # scaling factor, [R,K]
    # per-ray upstream loss gradients (already weighted/signed)
    dL_drgb,                              # [R, 3]
    dL_dnormal, dL_df0,                   # [R, 3]
    dL_droughness, dL_ddepth,             # [R]
    exp_power: float,
    eps_scale_grad: float,
    num_gaussians: int,
    global_scale_factor: float = 1.0,
) -> dict:
    """One bounce step of the loss-fused backward; returns per-hit grads
    (the fields of ParamGrads, each [R, K, ...]), zero where not
    composited."""
    mask = comp.comp_mask
    w = comp.weight                                   # [R, K] = T_before*alpha
    T_after = comp.T_after
    alpha = torch.where(mask, hits.alpha, torch.zeros_like(hits.alpha))
    one_minus = torch.clamp(1.0 - alpha, min=1e-6)    # alpha <= MAX_ALPHA

    # color-like attribute gradients (backward_pass.cu:110-115); relu and
    # clipped-relu backward are a pass-through on activated values, as in
    # the reference
    dL_dg_rgb = dL_drgb[:, None, :] * w[..., None]
    dL_dg_normal = dL_dnormal[:, None, :] * w[..., None]
    dL_dg_f0 = dL_df0[:, None, :] * w[..., None]
    dL_dg_roughness = dL_droughness[:, None] * w

    # weighted deltas -> alpha gradient (backward_pass.cu:117-135)
    wd_rgb = _weighted_deltas(g_rgb, w, T_after)
    wd_normal = _weighted_deltas(g_normal, w, T_after)
    wd_f0 = _weighted_deltas(g_f0, w, T_after)
    wd_rough = _weighted_deltas(g_roughness, w, T_after)
    wd_depth = _weighted_deltas(hits.t, w, T_after)

    inv1m = 1.0 / one_minus
    dL_dalpha = (
        dot(wd_rgb, dL_drgb[:, None, :])
        + dot(wd_normal, dL_dnormal[:, None, :])
        + dot(wd_f0, dL_df0[:, None, :])
        + wd_rough * dL_droughness[:, None]
        + wd_depth * dL_ddepth[:, None]
    ) * inv1m

    # truncated-tail term (backward_pass.cu:137-148)
    tmp2 = -((comp.T_final - comp.full_T)[:, None]) * inv1m
    tail_dot = (
        dot(comp.remaining_rgb, dL_drgb)
        + dot(comp.remaining_normal, dL_dnormal)
        + dot(comp.remaining_f0, dL_df0)
        + comp.remaining_roughness * dL_droughness
        + comp.remaining_depth * dL_ddepth
    )
    dL_dalpha = dL_dalpha + tmp2 * tail_dot[:, None]

    # opacity gradient (backward_pass.cu:150-152)
    dL_dg_opacity = backward_sigmoid_act(
        MAX_ALPHA * dL_dalpha * hits.gaussval, g_opacity)

    # transform gradients (backward_pass.cu:154-207)
    dL_dgaussval = MAX_ALPHA * dL_dalpha * g_opacity
    sq_norm = dot(hits.local_hit, hits.local_hit)
    dL_dsq = hits.gaussval * rounded(
        torch.pow, torch.clamp(sq_norm, min=1e-20), exp_power - 1.0)
    dL_dx_local = -hits.local_hit * (dL_dsq * dL_dgaussval)[..., None]

    # dL_dx_world = sf * R @ (inv_sizes * dL_dx_local)
    scaled_local = g_inv_sizes * dL_dx_local
    sf = g_sf

    def rot(r, c):
        return g_rot[..., r, c]

    dxw = [(rot(r, 0) * scaled_local[..., 0]
            + rot(r, 1) * scaled_local[..., 1]
            + rot(r, 2) * scaled_local[..., 2]) * sf for r in range(3)]
    dL_dg_mean = -torch.stack(dxw, dim=-1)

    # local-to-world rows l2w[r, c] = sizes[c] * R[r, c];
    # dL_dl2w[r, c] = -dL_dx_world[r] * local_hit[c]
    sizes = g_scaling * (sf[..., None] * global_scale_factor)
    lh = hits.local_hit
    d = [[-dxw[r] * lh[..., c] for c in range(3)] for r in range(3)]

    # scaling gradient (backward_pass.cu:181-187): sum over rows r
    denom = g_scaling * sf[..., None] + eps_scale_grad
    dscale = []
    for c in range(3):
        terms = [d[r][c] * ((rot(r, c) * sizes[..., c]) / denom[..., c])
                 for r in range(3)]
        dscale.append(terms[0] + terms[1] + terms[2])
    dL_dg_scale = torch.stack(dscale, dim=-1) * g_scaling  # backward exp

    # rotation gradient (backward_pass.cu:189-207): dL_drot = dL_dl2w*scaling
    dr = [[d[r][c] * g_scaling[..., c] for c in range(3)] for r in range(3)]
    q = g_rotation_raw / norm(g_rotation_raw, keepdim=True)
    r_, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    dL_dr = (2.0 * x * (dr[2][1] - dr[1][2])
             + 2.0 * y * (dr[0][2] - dr[2][0])
             + 2.0 * z * (dr[1][0] - dr[0][1]))
    dL_dx = (-4.0 * x * (dr[1][1] + dr[2][2])
             + 2.0 * y * (dr[0][1] + dr[1][0])
             + 2.0 * z * (dr[0][2] + dr[2][0])
             + 2.0 * r_ * (dr[2][1] - dr[1][2]))
    dL_dy = (2.0 * x * (dr[0][1] + dr[1][0])
             - 4.0 * y * (dr[0][0] + dr[2][2])
             + 2.0 * z * (dr[1][2] + dr[2][1])
             + 2.0 * r_ * (dr[0][2] - dr[2][0]))
    dL_dz = (2.0 * x * (dr[0][2] + dr[2][0])
             + 2.0 * y * (dr[1][2] + dr[2][1])
             - 4.0 * z * (dr[0][0] + dr[1][1])
             + 2.0 * r_ * (dr[1][0] - dr[0][1]))
    dL_dquat = torch.stack([dL_dr, dL_dx, dL_dy, dL_dz], dim=-1)
    dL_dg_rotation = backward_normalize_act(dL_dquat, g_rotation_raw, q)

    m = mask.to(dL_dalpha.dtype)
    m3 = m[..., None]
    return dict(
        mean=dL_dg_mean * m3,
        scale=dL_dg_scale * m3,
        rotation=dL_dg_rotation * m3,
        opacity=dL_dg_opacity * m,
        rgb=dL_dg_rgb * m3,
        normal=dL_dg_normal * m3,
        f0=dL_dg_f0 * m3,
        roughness=dL_dg_roughness * m,
        total_weight=w * m,
    )


def pack_scatter_payload(per_hit: dict, out: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """[R, K] per-hit grad dict -> [R*K, SCATTER_COLS] rows, columns in
    SCATTER_FIELDS order (written into `out` when given)."""
    cols = []
    for name, n in SCATTER_FIELDS:
        v = per_hit[name]
        cols.append(v.reshape(-1, n) if v.ndim == 3 else v.reshape(-1, 1))
    if out is None:
        return torch.cat(cols, dim=1)
    return torch.cat(cols, dim=1, out=out)


def new_grad_accumulator(num_gaussians: int, device) -> torch.Tensor:
    """The float64 [N, SCATTER_COLS] sums the scatter adds into."""
    return torch.zeros((num_gaussians, SCATTER_COLS), dtype=WIDE,
                       device=device)


def grads_from_accumulator(acc: torch.Tensor) -> ParamGrads:
    """Round the float64 sums once to float32 and split them into
    ParamGrads fields."""
    out = acc.to(torch.float32)
    pieces = {}
    off = 0
    for name, n in SCATTER_FIELDS:
        pieces[name] = out[:, off:off + n] if n > 1 else out[:, off]
        off += n
    return ParamGrads(**pieces)


def scatter_grads(per_hit: dict, ids: torch.Tensor, num_gaussians: int,
                  valid: torch.Tensor | None = None) -> ParamGrads:
    """Scatter-add per-hit grads into [N] buffers (the reference's
    atomicAddX flush, backward_pass.cu:209-220).  Hits where `valid` is
    False are skipped (the JAX package adds their zero rows at id 0, which
    changes no sum)."""
    payload = pack_scatter_payload(per_hit)
    flat_ids = ids.reshape(-1).to(torch.int32)
    if valid is not None:
        flat_ids = torch.where(valid.reshape(-1), flat_ids,
                               torch.full_like(flat_ids, -1))
    acc = new_grad_accumulator(num_gaussians, payload.device)
    scatter_add(acc, payload, flat_ids)
    return grads_from_accumulator(acc)


