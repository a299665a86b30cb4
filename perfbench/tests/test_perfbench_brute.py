"""The reference's k-buffer walk against a brute-force evaluation that
shares none of its code: every ray against every Gaussian in float64, no
Morton order, no cull, no candidate lists, no early exit.  On the rays it
can judge (unsaturated, with at most K hits, no pair near the isosurface
or the near plane) the reference's first-bounce G-buffers equal it to
float32 rounding.  This is the reference's witness that is not a copy of
the port."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import controls, drivers, inputs

W = H = 32
K = 32
SEED = 2**31 + 77
THR = 0.01            # RenderSettings' transmittance_threshold
ALPHA_THR = 0.005     # RenderSettings' alpha_threshold
P_EXP = 3.0           # RenderSettings' exp_power
MAX_ALPHA = 0.9999    # the contract's alpha cap
MARGIN = 1e-3         # a pair this close to a validity edge is not judged


def brute(fields: dict, origin, dirs, near, far):
    """Per ray, the G-buffers of every valid hit composited front to back
    (float64), the full transmittance, the hit count and the distance of
    the nearest pair to a validity edge."""
    live = fields["live_mask"]
    f = {k: v[live].double() for k, v in fields.items() if k != "live_mask"}
    opacity = 1.0 / (1.0 + torch.exp(-f["opacity"]))
    k2 = 2.0 * P_EXP
    sf = torch.where(opacity > ALPHA_THR,
                     (k2 * torch.log(opacity / ALPHA_THR)).clamp(min=0.0)
                     ** (1.0 / k2), torch.zeros_like(opacity))
    sizes = torch.exp(f["scaling"]) * sf[:, None]
    q = f["rotation"] / f["rotation"].norm(dim=1, keepdim=True)
    r, x, y, z = q.unbind(1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)   # world = rot @ local
    good = (sf > 0) & (sizes > 0).all(dim=1)
    o = origin.double()
    d = dirs.double()                                          # [R, 3]
    lo = torch.einsum("nji,nj->ni", rot, o[None] - f["xyz"]) / sizes
    ld = torch.einsum("nji,rj->rni", rot, d) / sizes[None]     # [R, N, 3]
    dot_ll = (ld * ld).sum(-1)
    dot_ol = (lo[None] * ld).sum(-1)
    t = -dot_ol / dot_ll
    sq = (lo * lo).sum(-1)[None] - dot_ol * dot_ol / dot_ll
    valid = good[None] & (sq <= 1.0) & (t > near) & (t < far)
    edge = torch.minimum((sq - 1.0).abs(), (t - near).abs())
    edge = torch.where(good[None] & (t < far), edge, torch.full_like(t, 1e9))
    alpha = MAX_ALPHA * torch.exp(-(sq.clamp(min=0) * sf[None] ** 2) ** P_EXP
                                  / k2) * opacity[None]
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    tt = torch.where(valid, t, torch.full_like(t, math.inf))
    order = tt.argsort(dim=1)
    a = alpha.gather(1, order)
    ts = torch.where(valid.gather(1, order), tt.gather(1, order),
                     torch.zeros_like(tt))
    T_before = torch.cumprod(torch.cat([torch.ones_like(a[:, :1]),
                                        1.0 - a[:, :-1]], 1), 1)
    w = T_before * a                                           # [R, N]
    attrs = dict(rgb=f["diffuse"].clamp(min=0), normal=f["normal"],
                 f0=f["f0"].clamp(0, 1), roughness=f["roughness"].clamp(0, 1))
    out = {}
    for name, v in attrs.items():
        vs = v[order] if v.ndim == 1 else v[order.reshape(-1)].reshape(
            *order.shape, 3)
        out[name] = (w[..., None] * vs).sum(1) if v.ndim == 2 else \
            (w * vs).sum(1)
    out["depth"] = (w * ts).sum(1)
    full_T = torch.prod(1.0 - alpha, dim=1)
    return out, full_T, valid.sum(1), edge.min(dim=1).values


@pytest.fixture(scope="module")
def room():
    gen = torch.Generator().manual_seed(SEED)
    layout = inputs.room_layout("cpu")
    arrays = inputs.room_arrays(gen, 4096, 1024, layout)
    fields = drivers.scene_fields(arrays, 2048, "cpu")
    # fainter Gaussians, so that most rays stay unsaturated and the walk
    # keeps every hit they have
    fields["opacity"] = fields["opacity"] - 3.0
    return fields, inputs.ring_cameras(2, "cpu")


def test_the_reference_walk_equals_a_brute_force_evaluation(room):
    fields, poses = room
    R = controls.reference_program()
    cam = drivers.camera(R, poses[1])
    steps, _final = R.dispatch_render_frame(
        drivers.make_scene(R, fields), cam, R.RenderSettings(), None, W, H,
        num_bounces=0, jitter=False, max_hits=K, cull_cluster=256,
        max_clusters=24, composite_mode="kbuffer",
        samples=R.FrameSamples(jitter=None, us=torch.zeros(1, W * H, 2)))
    dirs = inputs.pixel_directions(W, H, cam.c2w, cam.fov_y)
    want, full_T, hits, edge = brute(fields, cam.origin, dirs, cam.znear,
                                     cam.zfar)
    judged = (full_T > 2 * THR) & (hits <= K) & (edge > MARGIN) & (hits > 0)
    assert int(judged.sum()) >= 150, int(judged.sum())
    for name in ("rgb", "normal", "f0", "roughness", "depth"):
        got = getattr(steps, name)[0][judged].double()
        ref = want[name][judged]
        scale = 1.0 if name != "depth" else float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-4 * scale, name
    assert torch.allclose(steps.total_transmittance[0][judged].double(),
                          full_T[judged], rtol=0.0, atol=1e-4)
