"""The k-buffer walk and composite of one bounce in plain PyTorch: the
contract of the port's render_culled and trace_slots kernels, a frozen copy
of the port's plain versions (ops/cuda/render_kernel.py) with one change of
schedule: `walk_tiles` takes a whole exit group of clusters at once and
keeps the K nearest hits by one top-K merge per group, where the port's
plain walk inserts hits one cluster and one hit at a time.  The kept set
and the exit are the same: the walk exits only between groups, and the K
nearest of a group's hits and the slots do not depend on the order in
which they are inserted (exact depth ties at the K-th slot aside).

Per ray tile, the candidate clusters are walked nearest first; each ray
keeps its K nearest hits, accumulates the log-transmittance of every valid
hit in the processed clusters, and finally composites its K hits front to
back with the truncated-tail correction.  Every `check_every` clusters the
tile stops when each ray is saturated (log T <= log thr) or has all further
candidates behind its K-th hit, or when the whole tile is dead.  That exit
is part of the result.

`opts` (WalkOptions) carries the control's lower precision (`low`: the
pair math in bfloat16, the attributes rounded to it) and a `counts` dict
that each walk adds its rays, valid pairs and kept hits to.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..gaussian_kernel import MAX_ALPHA
from ..precision import WIDE, div, rounded
from .layout import (
    ATTR_ROWS,
    INF,
    N_ROWS,
    OUT_LANES,
    ROW_INV,
    ROW_MEAN,
    ROW_NLEN,
    ROW_NRM,
    ROW_OPACITY,
    ROW_ROT,
    ROW_SF2,
    ROW_VALID,
)

RESIDENT_LIMIT = 96 * 1024 * 1024
# ray x Gaussian pairs one step of a walk holds (its float32 temporaries
# take some 20 x 4 bytes a pair)
PAIRS_PER_STEP = 1 << 26


@dataclass
class WalkOptions:
    """The reference's options: `low` computes the pair math in bfloat16
    and rounds the attributes to it (the control); `counts` sums, per
    kernel name, rays, valid pairs and kept hits over the walks."""

    low: bool = False
    counts: dict = field(default_factory=dict)

    def add(self, kernel: str, **vals) -> None:
        row = self.counts.setdefault(kernel, {})
        for k, v in vals.items():
            row[k] = row.get(k, 0) + int(v)


def lowered(x: torch.Tensor, opts: WalkOptions | None) -> torch.Tensor:
    """x rounded to bfloat16 and back where `opts` asks for the control."""
    if opts is not None and opts.low:
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _f32(x) -> float:
    """A scalar (python or 0-d tensor) rounded to float32."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def _log_f32(x) -> float:
    return float(torch.log(torch.tensor(float(x), dtype=torch.float32)))


def _per_ray(x, R, fill, device) -> torch.Tensor:
    if x is None:
        return torch.full((R,), fill, dtype=torch.float32, device=device)
    return x.reshape(R).to(torch.float32)


def _pair_math(o, d, alive, t_split, g, *, near, far, secondary, bf_max_dist,
               bf_thr, exp_power, window_mode, secondary_static):
    """Closed-form max-response intersection of rays [A, tile, 3] with
    cluster blocks g [A, N_ROWS, C]: returns t, alpha, valid [A, tile, C]
    and the Gaussians' valid flags [A, C] (render_kernel.py:_pair_math)."""
    def row(i):
        return g[:, i, None, :]                                  # [A, 1, C]

    o = [o[..., j:j + 1] for j in range(3)]                      # [A, tile, 1]
    d = [d[..., j:j + 1] for j in range(3)]
    rel = [o[j] - row(ROW_MEAN + j) for j in range(3)]
    lo = [row(ROW_INV + i) * (row(ROW_ROT + i) * rel[0]
                              + row(ROW_ROT + 3 + i) * rel[1]
                              + row(ROW_ROT + 6 + i) * rel[2])
          for i in range(3)]
    ld = [row(ROW_INV + i) * (row(ROW_ROT + i) * d[0]
                              + row(ROW_ROT + 3 + i) * d[1]
                              + row(ROW_ROT + 6 + i) * d[2])
          for i in range(3)]
    dot_ol = lo[0] * ld[0] + lo[1] * ld[1] + lo[2] * ld[2]
    dot_ll = ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2]
    dot_oo = lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2]
    gvalid = g[:, ROW_VALID, :]
    t, alpha, valid = pair_tail(
        dot_ll, dot_ol, dot_oo, gvalid, row(ROW_NLEN),
        lambda: (row(ROW_NRM) * ld[0] + row(ROW_NRM + 1) * ld[1]
                 + row(ROW_NRM + 2) * ld[2]),
        row(ROW_SF2), row(ROW_OPACITY), alive, t_split, near=near, far=far,
        secondary=secondary, bf_max_dist=bf_max_dist, bf_thr=bf_thr,
        exp_power=exp_power, window_mode=window_mode,
        secondary_static=secondary_static)
    return t, alpha, valid, gvalid


def pair_tail(dot_ll, dot_ol, dot_oo, gvalid, nlen, ndotd, sf2, opacity,
              alive, t_split, *, near, far, secondary, bf_max_dist, bf_thr,
              exp_power, window_mode, secondary_static):
    """From a pair's three ray-frame dots to (t, alpha, valid) [A, tile, C]:
    closest approach, validity and the generalized-Gaussian opacity, shared
    by the direct and the quadric pair math.  gvalid is [A, C]; nlen, sf2
    and opacity [A, 1, C]; ndotd() gives the normal's component along the
    ray, needed on reflected passes only."""
    inv_ll = 1.0 / torch.clamp(dot_ll, min=1e-30)
    t = -dot_ol * inv_ll
    sq = dot_oo - dot_ol * dot_ol * inv_ll

    valid = (gvalid[:, None, :] > 0.0) & (dot_ol <= 0.0) & (sq <= 1.0)
    valid &= (t > near) & (t < far)
    if window_mode == 1:
        valid &= t < t_split[..., None]
    elif window_mode == 2:
        valid &= t > t_split[..., None]
    if secondary_static != 0:
        reject = (t < bf_max_dist) & (nlen > bf_thr) & (ndotd() > 0.0)
        if secondary_static == 1:
            valid &= ~reject
        else:
            valid &= (secondary <= 0.0) | ~reject
    valid &= alive[..., None] > 0.0

    # the opacity of the valid pairs only (the others' is never read): the
    # same operations on the same values as over every pair
    k2 = 2.0 * exp_power
    sqs = torch.clamp(sq[valid] * sf2.expand_as(sq)[valid], min=0.0)
    if float(exp_power).is_integer() and 1 <= exp_power <= 8:
        powered = sqs
        for _ in range(int(exp_power) - 1):
            powered = powered * sqs
    else:
        powered = rounded(torch.pow, sqs, exp_power)
    gaussval = rounded(torch.exp, div(-powered, k2))
    alpha_v = MAX_ALPHA * gaussval * opacity.expand_as(sq)[valid]
    alpha = torch.zeros(sq.shape, dtype=alpha_v.dtype, device=sq.device)
    alpha[valid] = alpha_v
    return t, alpha, valid


def _seqsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in index order - the kernel's order (a CPU
    cumsum runs sequentially)."""
    return torch.cumsum(x, dim=-1)[..., -1]


def _composite(st, sa, sid, log_t, attr_rows, thr, eps_norm):
    """Depth-sorted front-to-back composite of the slots [R, K] plus the
    truncated-tail correction (render_kernel_v3.py:154-204), the shading
    attributes read by id from attr_rows [NUM_ATTR, N].  Slots are sorted
    by (t, id); the Pallas kernels' order-free form equals this except on
    exact depth ties.  WIDE accumulation, as in the kernel."""
    st, sa, sid = sort_slots(st, sa, sid)
    valid = st < INF
    la = torch.log1p((-sa).to(WIDE))
    la = torch.where(valid, la, torch.zeros_like(la))
    front = torch.cumsum(la, dim=-1)
    front = torch.cat([torch.zeros_like(front[:, :1]), front[:, :-1]], dim=-1)
    T_before = torch.exp(front).to(torch.float32)

    cmask = valid & (T_before >= thr)   # prefix-closed: T only falls
    zero = torch.zeros_like(la)
    w = torch.where(cmask, T_before.to(WIDE) * sa.to(WIDE), zero)
    T_final = torch.exp(_seqsum(torch.where(cmask, la, zero))).to(
        torch.float32)
    depth = _seqsum(w * st.to(WIDE))
    num_acc = cmask.sum(dim=-1).to(torch.float32)

    full_T = torch.exp(log_t).to(torch.float32)
    factor = 1.0 + ((T_final.to(WIDE) - full_T.to(WIDE))
                    / torch.clamp(1.0 - T_final.to(WIDE), min=eps_norm))
    attrs = attr_rows[:, sid].to(WIDE)                           # [10, R, K]
    cols = _seqsum(w[None] * attrs) * factor[None]               # [10, R]
    return torch.cat([cols.T.to(torch.float32),
                      (depth * factor).to(torch.float32)[:, None],
                      T_final[:, None], full_T[:, None], num_acc[:, None]],
                     dim=1)


def sort_slots(st, sa, sid):
    """The kept hits [R, K] ordered by (t, id), as the kernels sort them.
    The Pallas kernels' order (t, slot index) equals this except on exact
    depth ties."""
    order = torch.sort(sid, dim=-1, stable=True).indices
    st, sa, sid = (x.gather(-1, order) for x in (st, sa, sid))
    order = torch.sort(st, dim=-1, stable=True).indices
    return tuple(x.gather(-1, order) for x in (st, sa, sid))


def check_every_for(capacity: int) -> int:
    """Early-exit group size of the JAX kernel the renderer reproduces: the
    JAX renderer runs pallas_render_culled_v4 (groups of 8) when the packed
    scene fits its resident budget and pallas_render_culled_v3 (groups of 4)
    otherwise (raytracer.py:1080-1082, render_kernel_v3.py:490)."""
    return 8 if (capacity + 128) * N_ROWS * 4 <= RESIDENT_LIMIT else 4




def walk_tiles(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, max_hits: int = 16, cluster: int = 128,
    tile: int = 256, alive=None, check_every: int = 8, t_split=None,
    window_mode: int = 0, secondary_static: int = -1, exit_mode: int = 0,
    opts: WalkOptions | None = None, kernel: str = "render_culled"):
    """The k-buffer kernels' walk (exit_mode 0: the v4 group exit, 1:
    pallas_trace_slots' pairs with per-ray dead), a group of `check_every`
    clusters a step over as many tiles as PAIRS_PER_STEP allows.  Yields,
    per batch of tiles, (rows, st, sa, sid [B*tile, K] as kept (unsorted),
    log_t [B*tile] WIDE, trav [B], chunks [B]) and the padded gpack (a zero
    cluster appended) as the last element."""
    R = rays_o.shape[0]
    N = gpack.shape[1]
    K = max_hits
    dev = rays_o.device
    if N % cluster or R % tile:
        raise ValueError(f"N={N} % cluster={cluster} or R={R} % tile={tile}")
    if exit_mode not in (0, 1):
        raise ValueError(f"exit_mode={exit_mode}")
    n_tiles = R // tile
    CE = check_every
    mc0 = candidates.shape[1]
    mc = (mc0 + CE - 1) // CE * CE
    cand = torch.full((n_tiles, mc), -1, dtype=torch.int64, device=dev)
    cand[:, :mc0] = candidates
    cnear = torch.full((n_tiles, mc), 3.0e38, dtype=torch.float32, device=dev)
    cnear[:, :mc0] = cand_near
    listed = cand >= 0
    gp = torch.cat([gpack, torch.zeros((N_ROWS, cluster), dtype=gpack.dtype,
                                       device=dev)], dim=1)
    gp = lowered(gp, opts)
    cand = torch.where(listed, cand, N // cluster)
    alive = _per_ray(alive, R, 1.0, dev).reshape(n_tiles, tile)
    t_split = _per_ray(t_split, R, 0.0, dev).reshape(n_tiles, tile)
    o = rays_o.to(torch.float32).reshape(n_tiles, tile, 3)
    d = rays_d.to(torch.float32).reshape(n_tiles, tile, 3)
    low = opts is not None and opts.low
    pair_dtype = torch.bfloat16 if low else torch.float32
    log_thr = _log_f32(transmittance_threshold)
    pair_kw = dict(near=_f32(near), far=_f32(far), secondary=_f32(secondary),
                   bf_max_dist=_f32(backfacing_max_dist),
                   bf_thr=_f32(backfacing_invalid_normal_threshold),
                   exp_power=float(exp_power), window_mode=window_mode,
                   secondary_static=secondary_static)
    lane = torch.arange(CE * cluster, device=dev) % cluster
    per_batch = max(1, PAIRS_PER_STEP // (tile * CE * cluster))
    n_valid = 0

    for t0 in range(0, n_tiles, per_batch):
        tb = slice(t0, min(n_tiles, t0 + per_batch))
        B = tb.stop - tb.start
        st = torch.full((B, tile, K), INF, dtype=torch.float32, device=dev)
        sa = torch.zeros((B, tile, K), dtype=torch.float32, device=dev)
        sid = torch.zeros((B, tile, K), dtype=torch.int64, device=dev)
        log_t = torch.zeros((B, tile), dtype=WIDE, device=dev)
        trav = torch.zeros((B,), dtype=torch.float32, device=dev)
        chunks = torch.zeros((B,), dtype=torch.float32, device=dev)
        dead = alive[tb] <= 0.0
        done = dead.all(dim=1)
        for base in range(0, mc, CE):
            finished = (log_t <= log_thr) | (st.amax(dim=-1)
                                             < cnear[tb, base, None])
            if exit_mode == 1:
                finished |= dead
            done |= finished.all(dim=1)
            act = torch.nonzero(~done).squeeze(1)
            A = act.numel()
            if A == 0:
                break
            ta = act + t0
            c = cand[ta, base:base + CE]                          # [A, CE]
            gid = (c[:, :, None] * cluster
                   + lane.reshape(CE, cluster)).reshape(A, CE * cluster)
            g = gp[:, gid].permute(1, 0, 2)              # [A, N_ROWS, CE*C]
            t, alpha, valid, gvalid = _pair_math(
                o[ta].to(pair_dtype), d[ta].to(pair_dtype), alive[ta],
                t_split[ta], g.to(pair_dtype), **pair_kw)
            t, alpha = t.to(torch.float32), alpha.to(torch.float32)
            vi = valid.nonzero(as_tuple=True)
            lt = torch.zeros((A, tile), dtype=WIDE, device=dev)
            lt.index_put_(vi[:2], torch.log1p((-alpha[vi]).to(WIDE)),
                          accumulate=True)
            log_t[act] += lt
            gvalid = gvalid.to(torch.float32)
            trav[act] += gvalid.sum(-1)
            if exit_mode == 1:
                chunks[act] += listed[ta, base:base + CE].to(
                    torch.float32).sum(-1)
            else:
                chunks[act] += gvalid.reshape(A, CE, cluster).amax(-1).sum(-1)
            n_valid += vi[0].numel()
            # the K nearest of the slots and the group's valid hits: the
            # group's k1 nearest (k1 its most valid hits a ray, at most K),
            # then the K nearest of those and the slots
            k1 = min(K, int(valid.sum(-1).max()))
            if k1 == 0:
                continue
            tm = torch.where(valid, t, torch.full_like(t, INF))
            t1, p1 = torch.topk(tm, k1, dim=-1, largest=False, sorted=False)
            all_t = torch.cat([st[act], t1], dim=-1)
            all_a = torch.cat([sa[act], alpha.gather(-1, p1)], dim=-1)
            all_i = torch.cat([sid[act], gid[:, None, :].expand(-1, tile, -1)
                               .gather(-1, p1)], dim=-1)
            kt, pos = torch.topk(all_t, K, dim=-1, largest=False, sorted=False)
            kept = kt < INF
            st[act] = kt
            sa[act] = torch.where(kept, all_a.gather(-1, pos),
                                  torch.zeros_like(kt))
            sid[act] = torch.where(kept, all_i.gather(-1, pos),
                                   torch.zeros_like(pos))
        rows = slice(tb.start * tile, tb.stop * tile)
        yield (rows, st.reshape(-1, K), sa.reshape(-1, K), sid.reshape(-1, K),
               log_t.reshape(-1), trav, chunks, gp)
    if opts is not None:
        opts.add(kernel, rays=int((alive > 0).sum()), valid_pairs=n_valid)


def render_culled(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, eps_forward_normalization=1e-12,
    max_hits: int = 16, cluster: int = 128, tile: int = 256, alive=None,
    check_every: int = 8, t_split=None, window_mode: int = 0,
    secondary_static: int = -1, opts: WalkOptions | None = None,
) -> torch.Tensor:
    """The render_culled kernel's contract (module docstring): walk_tiles,
    then the composite; [R, OUT_LANES] f32."""
    R = rays_o.shape[0]
    out = torch.empty((R, OUT_LANES), dtype=torch.float32,
                      device=rays_o.device)
    walk = walk_tiles(
        rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
        secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
        transmittance_threshold=transmittance_threshold, max_hits=max_hits,
        cluster=cluster, tile=tile, alive=alive, check_every=check_every,
        t_split=t_split, window_mode=window_mode,
        secondary_static=secondary_static, exit_mode=0, opts=opts)
    kept = 0
    for rows, st, sa, sid, log_t, trav, chunks, gp in walk:
        out[rows, :14] = _composite(
            st, sa, sid, log_t, gp[list(ATTR_ROWS)],
            _f32(transmittance_threshold),
            _f32(eps_forward_normalization))
        out[rows, 14] = trav.repeat_interleave(tile)
        out[rows, 15] = chunks.repeat_interleave(tile)
        kept += int((st < INF).sum())
    if opts is not None:
        opts.add("render_culled", kept_hits=kept)
    return out
