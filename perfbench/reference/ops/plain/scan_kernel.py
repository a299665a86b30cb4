"""The streaming scan composite of one bounce in plain PyTorch: the
contract of the port's render_scan kernel, a frozen copy of the port's
plain version (ops/cuda/scan_kernel.py) that computes the pair math of a
whole exit group of clusters at once and then composites its chunks in
list order, as the port's plain version does chunk by chunk.

There is no K cap: per ray tile, the candidate clusters are walked in list
order and each one's Gaussians in table order; every valid hit composites
front to back while the transmittance before it is at least the threshold.
Per chunk:

    T_before = T_comp(chunk start) * ex     ex: exclusive in-chunk product
    w        = T_before * alpha             of (1 - alpha) over valid hits
    T_comp   = min over composited hits of T_before * (1 - alpha)
    full_T  *= the whole chunk's product

Every `check_every` candidates the tile stops when every ray is saturated
(T_comp <= threshold; a dead ray never is), when every ray is dead, or when
the group's first candidate is empty.  full_T, and through the tail factor
every composited lane, count only the processed chunks.
"""

from __future__ import annotations

import torch

from ..precision import WIDE
from .layout import (
    NUM_ATTR,
    OUT_CHUNKS,
    OUT_DEPTH,
    OUT_FULLT,
    OUT_LANES,
    OUT_NUMACC,
    OUT_TFINAL,
    OUT_TRAV,
    Q_C,
    Q_ND,
    Q_NLEN,
    Q_NQ,
    Q_OPACITY,
    Q_S,
    Q_SF2,
    Q_VALID,
    SCAN_ATTR,
    SCAN_COLS,
    ScanTable,
)
from .render_kernel import (
    PAIRS_PER_STEP,
    WalkOptions,
    _f32,
    _pair_math,
    _per_ray,
    lowered,
    pair_tail,
)

ATTR_PRECISIONS = ("highest", "bf16")


# the JAX scan kernels' exit group (pallas_render_culled_v6/_v7's default)
SCAN_CHECK_EVERY = 8


# the JAX package runs its scan kernels only while the transposed scan pack
# fits a TPU core's VMEM (render_kernel_v5.py RESIDENT_TPACK_LIMIT, 128
# lanes of f32 per Gaussian, the dummy cluster included)
SCAN_RESIDENT_LIMIT = 96 * 1024 * 1024


SCAN_PACK_ROW_BYTES = 128 * 4


def scan_fits(capacity: int, cluster: int) -> bool:
    """Whether the JAX renderer would run its scan kernel for this scene:
    (capacity + cluster) * 128 * 4 bytes within its 96 MiB resident budget
    (render_kernel_v5.py:373-377; N <= 196,352 at cluster 256).  Above it
    the JAX frame composites with the k-buffer kernel instead
    (raytracer.py:1035-1082).  The budget was a TPU's VMEM, but it decides
    which composite produces the pixels, so the port keeps it."""
    return (capacity + cluster) * SCAN_PACK_ROW_BYTES <= SCAN_RESIDENT_LIMIT


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (nearest even) and back: a TPU's one-pass bf16 dot
    rounds both operands so."""
    return x.to(torch.bfloat16).to(torch.float32)


def _pair_quadric(o, d, alive, t_split, g, center, **kw):
    """Quadric twin of render_kernel._pair_math (render_kernel_v7.py:
    _pair_math_q) on table blocks g [A, C, SCAN_COLS]: the ray's monomials of
    o' = o - centre and d, dotted with the table's weights, each dot summed
    left to right."""
    def col(i):
        return g[:, None, :, i]                                  # [A, 1, C]

    o = [o[..., j:j + 1] - center[j] for j in range(3)]          # [A, tile, 1]
    d = [d[..., j:j + 1] for j in range(3)]
    s00, s11, s22, s01, s02, s12 = (col(Q_S + i) for i in range(6))
    t01, t02, t12 = 2.0 * s01, 2.0 * s02, 2.0 * s12
    q = [col(Q_NQ + i) for i in range(3)]
    dot_ll = (s00 * (d[0] * d[0]) + s11 * (d[1] * d[1]) + s22 * (d[2] * d[2])
              + t01 * (d[0] * d[1]) + t02 * (d[0] * d[2])
              + t12 * (d[1] * d[2]))
    dot_ol = (s00 * (o[0] * d[0]) + s11 * (o[1] * d[1]) + s22 * (o[2] * d[2])
              + s01 * (o[0] * d[1] + o[1] * d[0])
              + s02 * (o[0] * d[2] + o[2] * d[0])
              + s12 * (o[1] * d[2] + o[2] * d[1])
              + q[0] * d[0] + q[1] * d[1] + q[2] * d[2])
    dot_oo = (s00 * (o[0] * o[0]) + s11 * (o[1] * o[1]) + s22 * (o[2] * o[2])
              + t01 * (o[0] * o[1]) + t02 * (o[0] * o[2])
              + t12 * (o[1] * o[2])
              + (2.0 * q[0]) * o[0] + (2.0 * q[1]) * o[1]
              + (2.0 * q[2]) * o[2] + col(Q_C))
    gvalid = g[:, :, Q_VALID]
    t, alpha, valid = pair_tail(
        dot_ll, dot_ol, dot_oo, gvalid, col(Q_NLEN),
        lambda: col(Q_ND) * d[0] + col(Q_ND + 1) * d[1] + col(Q_ND + 2) * d[2],
        col(Q_SF2), col(Q_OPACITY), alive, t_split, **kw)
    return t, alpha, valid, gvalid


def render_scan(
    rays_o, rays_d, scan: ScanTable, candidates, cand_near, near, far,
    exp_power, secondary, backfacing_max_dist,
    backfacing_invalid_normal_threshold, transmittance_threshold=0.01,
    eps_forward_normalization=1e-12, max_hits: int = 16, cluster: int = 128,
    tile: int = 256, alive=None, check_every: int = SCAN_CHECK_EVERY,
    t_split=None, window_mode: int = 0, secondary_static: int = -1,
    stats: bool = True, attr_precision: str = "highest",
    opts: WalkOptions | None = None,
) -> torch.Tensor:
    """The render_scan kernel's contract (module docstring); [R, OUT_LANES]
    f32.  cand_near and max_hits are accepted for render_culled's contract
    and unused: the scan has no K cap, and its exit reads only the
    candidate ids."""
    del cand_near, max_hits
    if attr_precision not in ATTR_PRECISIONS:
        raise ValueError(f"attr_precision={attr_precision!r}")
    R = rays_o.shape[0]
    table = lowered(scan.table, opts)
    N = table.shape[0]
    dev = rays_o.device
    if N % cluster or R % tile:
        raise ValueError(f"N={N} % cluster={cluster} or R={R} % tile={tile}")
    n_tiles = R // tile
    mc = candidates.shape[1]
    CE = check_every
    blocks = torch.cat([table, torch.zeros((cluster, SCAN_COLS),
                                           dtype=table.dtype, device=dev)]
                       ).reshape(N // cluster + 1, cluster, SCAN_COLS)
    cand = candidates.to(torch.int64)
    pad = -mc % CE
    cand = torch.nn.functional.pad(cand, (0, pad), value=-1)
    empty = cand < 0
    cand = torch.where(cand >= 0, cand, N // cluster)
    alive = _per_ray(alive, R, 1.0, dev).reshape(n_tiles, tile)
    t_split = _per_ray(t_split, R, 0.0, dev).reshape(n_tiles, tile)
    o = rays_o.to(torch.float32).reshape(n_tiles, tile, 3)
    d = rays_d.to(torch.float32).reshape(n_tiles, tile, 3)
    low = opts is not None and opts.low
    pair_dtype = torch.bfloat16 if low else torch.float32
    center = scan.center.to(pair_dtype)
    thr = _f32(transmittance_threshold)
    eps = _f32(eps_forward_normalization)
    pair_kw = dict(near=_f32(near), far=_f32(far), secondary=_f32(secondary),
                   bf_max_dist=_f32(backfacing_max_dist),
                   bf_thr=_f32(backfacing_invalid_normal_threshold),
                   exp_power=float(exp_power), window_mode=window_mode,
                   secondary_static=secondary_static)
    bf16 = attr_precision == "bf16"
    out = torch.zeros((R, OUT_LANES), dtype=torch.float32, device=dev)
    per_batch = max(1, PAIRS_PER_STEP // (tile * CE * cluster))
    n_valid = torch.zeros((), dtype=torch.int64, device=dev)
    n_comp = torch.zeros((), dtype=torch.int64, device=dev)

    for t0 in range(0, n_tiles, per_batch):
        tb = slice(t0, min(n_tiles, t0 + per_batch))
        B = tb.stop - tb.start
        f32 = dict(dtype=torch.float32, device=dev)
        t_comp = torch.ones((B, tile), **f32)
        full_t = torch.ones((B, tile), **f32)
        depth = torch.zeros((B, tile), **f32)
        attr = torch.zeros((B, tile, NUM_ATTR), **f32)
        num = torch.zeros((B, tile), **f32)
        trav = torch.zeros((B,), **f32)
        chunks = torch.zeros((B,), **f32)
        done = (alive[tb] <= 0.0).all(dim=1)
        for base in range(0, mc, CE):
            done |= (t_comp <= thr).all(dim=1) | empty[tb, base]
            act = torch.nonzero(~done).squeeze(1)
            A = act.numel()
            if A == 0:
                break
            ta = act + t0
            nc = min(CE, mc - base)
            g = blocks[cand[ta, base:base + nc]].reshape(A, nc * cluster,
                                                         SCAN_COLS)
            if scan.pair_math == "direct":
                t, alpha, valid, gvalid = _pair_math(
                    o[ta].to(pair_dtype), d[ta].to(pair_dtype), alive[ta],
                    t_split[ta], g.transpose(1, 2).to(pair_dtype), **pair_kw)
            else:
                t, alpha, valid, gvalid = _pair_quadric(
                    o[ta].to(pair_dtype), d[ta].to(pair_dtype), alive[ta],
                    t_split[ta], g.to(pair_dtype), center, **pair_kw)
            t, alpha = t.to(torch.float32), alpha.to(torch.float32)
            n_valid += valid.sum()
            shape = (A, tile, nc, cluster)
            t, alpha, valid = (x.reshape(shape) for x in (t, alpha, valid))
            gvalid = gvalid.to(torch.float32).reshape(A, nc, cluster)
            oma = torch.where(valid, 1.0 - alpha, torch.ones_like(alpha))
            incl = torch.cumprod(oma.to(WIDE), dim=-1)
            ex = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]],
                           dim=-1).to(torch.float32)
            vals = g[:, :, SCAN_ATTR:SCAN_ATTR + NUM_ATTR].reshape(
                A, nc, cluster, NUM_ATTR)
            if bf16:
                vals = _bf16(vals)
            vals = vals.to(WIDE)
            tc = t_comp[act]
            ft = full_t[act]
            dep = depth[act]
            att = attr[act]
            nm = num[act]
            for j in range(nc):
                t_before = tc[..., None] * ex[:, :, j]
                cmask = valid[:, :, j] & (t_before >= thr)
                w = torch.where(cmask, t_before * alpha[:, :, j],
                                torch.zeros_like(t_before))
                after = torch.where(cmask, t_before * oma[:, :, j],
                                    torch.full_like(t_before, float("inf")))
                tc = torch.minimum(tc, after.amin(dim=-1))
                ft = ft * incl[:, :, j, -1].to(torch.float32)
                wt = torch.where(cmask, w.to(WIDE) * t[:, :, j].to(WIDE),
                                 torch.zeros_like(incl[:, :, j]))
                dep = dep + wt.sum(-1).to(torch.float32)
                wa = (_bf16(w) if bf16 else w).to(WIDE)
                att = att + torch.einsum("atc,acn->atn", wa,
                                         vals[:, j]).to(torch.float32)
                nm = nm + cmask.sum(dim=-1).to(torch.float32)
            t_comp[act], full_t[act], depth[act] = tc, ft, dep
            attr[act], num[act] = att, nm
            trav[act] += gvalid.sum(dim=(1, 2))
            chunks[act] += gvalid.amax(dim=-1).sum(dim=-1)
        factor = 1.0 + (t_comp - full_t) / torch.clamp(
            1.0 - t_comp, min=eps)
        rows = slice(tb.start * tile, tb.stop * tile)
        out[rows, :NUM_ATTR] = (attr * factor[..., None]).reshape(-1, NUM_ATTR)
        out[rows, OUT_DEPTH] = (depth * factor).reshape(-1)
        out[rows, OUT_TFINAL] = t_comp.reshape(-1)
        out[rows, OUT_FULLT] = full_t.reshape(-1)
        n_comp += num.sum().to(torch.int64)
        if stats:
            out[rows, OUT_NUMACC] = num.reshape(-1)
            out[rows, OUT_TRAV] = trav.repeat_interleave(tile)
            out[rows, OUT_CHUNKS] = chunks.repeat_interleave(tile)
    if opts is not None:
        opts.add("render_scan", rays=int((alive > 0).sum()),
                 valid_pairs=n_valid, kept_hits=n_comp)
    return out
