"""Culled trace + streaming scan composite for one bounce: the CUDA kernel's
wrapper (`render_scan`) and its plain PyTorch version
(`render_scan_reference`).

Counterpart of the JAX ops/pallas/render_kernel_v6.py
(pallas_render_culled_v6, direct pair math, composite_mode "scan") and
render_kernel_v7.py (pallas_render_culled_v7, quadric-form pair math and an
optional bf16 attribute dot, "scanq"), which share one contract.  There is
no K cap: per ray tile, the candidate clusters are walked in list order and
each one's Gaussians in table order; every valid hit composites front to
back while the transmittance before it is at least the threshold.  Per
chunk (render_kernel_v6.py:106-144):

    T_before = T_comp(chunk start) * ex     ex: exclusive in-chunk product
    w        = T_before * alpha             of (1 - alpha) over valid hits
    T_comp   = min over composited hits of T_before * (1 - alpha)
    full_T  *= the whole chunk's product

Every `check_every` candidates the tile stops when every ray is saturated
(T_comp <= threshold; a dead ray never is), when every ray is dead, or when
the group's first candidate is empty.  full_T, and through the tail factor
1 + (T_final - full_T) / max(1 - T_final, eps) every composited lane, count
only the processed chunks, so the exit is part of the result.  Output:
[R, OUT_LANES] f32, lanes in ops/cuda/layout.py; lanes 13-15 are the
counters (composited hits, valid Gaussians traversed, chunks holding any),
zero when `stats` is off.

Numerics shared by the kernel and the plain version (ops/precision.py), so
the two agree bit for bit: float32 pair math with every product rounded,
exp/pow in WIDE rounded once, the in-chunk product formed in WIDE and
rounded once where it is used, the chunk's attribute and depth sums in WIDE
in table order, rounded once and added to float32 accumulators.  The JAX
kernels build the product with a Hillis-Steele tree and sum in float32, so
against JAX the port agrees to a stated tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..precision import WIDE
from . import build
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
    SHAPES_REFUSED,
    _check,
    _f32,
    _pair_math,
    _per_ray,
    _seqsum,
    pair_tail,
)

ATTR_PRECISIONS = ("highest", "bf16")
# the JAX scan kernels' exit group (pallas_render_culled_v6/_v7's default)
SCAN_CHECK_EVERY = 8
# the kernel stages two clusters' rows in shared memory (<= 135 KB), and
# runs blocks of at most 512 rays (csrc/render_scan.cu, scan_shape_ok)
MAX_CLUSTER = 512
MAX_TILE = 512
# the JAX package runs its scan kernels only while the transposed scan pack
# fits a TPU core's VMEM (render_kernel_v5.py RESIDENT_TPACK_LIMIT, 128
# lanes of f32 per Gaussian, the dummy cluster included)
SCAN_RESIDENT_LIMIT = 96 * 1024 * 1024
SCAN_PACK_ROW_BYTES = 128 * 4

_ARGTYPES = (
    [ctypes.c_void_p] * 8          # rays_o, rays_d, alive, t_split, table,
                                   # center, cand, out
    + [ctypes.c_int] * 11          # n_rays, n_gauss, mc, tile, cluster,
                                   # check_every, window_mode,
                                   # secondary_static, pair_math, stats,
                                   # attr_bf16
    + [ctypes.c_float] * 8         # near, far, secondary, bf_max_dist,
                                   # bf_thr, thr, eps_norm, exp_power
    + [ctypes.c_void_p]            # stream
)


@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("render_scan").egr_render_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_info(pair_math: str = "quadric", stats: bool = False,
                attr_precision: str = "highest", cube: bool = True,
                backfacing: bool = False, tile: int = 256,
                cluster: int = 256) -> dict:
    """What the card's runtime reports of the compiled kernel for these
    options (pair math "direct" or "quadric", counters, bf16 attributes,
    exp_power 3 or not, the backfacing test of reflected passes) launched
    with `tile`-ray blocks at `cluster`: registers and spilled (local) bytes
    per thread, dynamic shared memory per block and resident blocks per SM.
    Needs a CUDA device."""
    if pair_math not in ("direct", "quadric"):
        raise ValueError(f"pair_math={pair_math!r}")
    fn = build.load("render_scan").egr_render_scan_info
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(0 if pair_math == "direct" else 1, int(stats),
             int(attr_precision == "bf16"), int(cube), int(backfacing), tile,
             cluster, ctypes.addressof(out))
    if err == SHAPES_REFUSED:
        raise ValueError(f"render_scan: no kernel for tile={tile}, "
                         f"cluster={cluster}")
    if err != 0:
        raise RuntimeError(f"render_scan kernel info failed: cudaError "
                           f"{err}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3])


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


def render_scan_reference(
    rays_o, rays_d, scan: ScanTable, candidates, cand_near, near, far,
    exp_power, secondary, backfacing_max_dist,
    backfacing_invalid_normal_threshold, transmittance_threshold=0.01,
    eps_forward_normalization=1e-12, max_hits: int = 16, cluster: int = 128,
    tile: int = 256, alive=None, check_every: int = SCAN_CHECK_EVERY,
    t_split=None, window_mode: int = 0, secondary_static: int = -1,
    stats: bool = True, attr_precision: str = "highest",
    tiles_per_batch: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (module docstring),
    vectorised over up to `tiles_per_batch` ray tiles at a time, looping
    over candidate groups with a per-tile `done` mask.  Runs on any device;
    the CPU tests and the comparison in chip_smoke.py use it.  cand_near and
    max_hits are accepted for render_culled's contract and unused: the scan
    has no K cap, and its exit reads only the candidate ids."""
    del cand_near, max_hits
    if attr_precision not in ATTR_PRECISIONS:
        raise ValueError(f"attr_precision={attr_precision!r}")
    R = rays_o.shape[0]
    table = scan.table
    N = table.shape[0]
    dev = rays_o.device
    if N % cluster or R % tile:
        raise ValueError(f"N={N} % cluster={cluster} or R={R} % tile={tile}")
    n_tiles = R // tile
    mc = candidates.shape[1]
    # empty entries read an all-zero (all-invalid) dummy cluster appended
    # to the table: it composites nothing and counts nothing
    blocks = torch.cat([table, torch.zeros((cluster, SCAN_COLS),
                                           dtype=table.dtype, device=dev)]
                       ).reshape(N // cluster + 1, cluster, SCAN_COLS)
    cand = candidates.to(torch.int64)
    cand = torch.where(cand >= 0, cand, N // cluster)
    empty = candidates < 0
    alive = _per_ray(alive, R, 1.0, dev).reshape(n_tiles, tile)
    t_split = _per_ray(t_split, R, 0.0, dev).reshape(n_tiles, tile)
    o = rays_o.to(torch.float32).reshape(n_tiles, tile, 3)
    d = rays_d.to(torch.float32).reshape(n_tiles, tile, 3)
    thr = _f32(transmittance_threshold)
    eps = _f32(eps_forward_normalization)
    pair_kw = dict(near=_f32(near), far=_f32(far), secondary=_f32(secondary),
                   bf_max_dist=_f32(backfacing_max_dist),
                   bf_thr=_f32(backfacing_invalid_normal_threshold),
                   exp_power=float(exp_power), window_mode=window_mode,
                   secondary_static=secondary_static)
    bf16 = attr_precision == "bf16"
    out = torch.zeros((R, OUT_LANES), dtype=torch.float32, device=dev)

    for t0 in range(0, n_tiles, tiles_per_batch):
        tb = slice(t0, min(n_tiles, t0 + tiles_per_batch))
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
        for base in range(0, mc, check_every):
            done |= (t_comp <= thr).all(dim=1) | empty[tb, base]
            act = torch.nonzero(~done).squeeze(1)
            if act.numel() == 0:
                break
            ta = act + t0
            for ci in range(base, min(base + check_every, mc)):
                g = blocks[cand[ta, ci]]                     # [A, C, COLS]
                if scan.pair_math == "direct":
                    t, alpha, valid, gvalid = _pair_math(
                        o[ta], d[ta], alive[ta], t_split[ta],
                        g.transpose(1, 2), **pair_kw)
                else:
                    t, alpha, valid, gvalid = _pair_quadric(
                        o[ta], d[ta], alive[ta], t_split[ta], g, scan.center,
                        **pair_kw)
                oma = torch.where(valid, 1.0 - alpha, torch.ones_like(alpha))
                incl = torch.cumprod(oma.to(WIDE), dim=-1)
                ex = torch.cat([torch.ones_like(incl[..., :1]),
                                incl[..., :-1]], dim=-1).to(torch.float32)
                tc = t_comp[act]
                t_before = tc[..., None] * ex
                cmask = valid & (t_before >= thr)
                w = torch.where(cmask, t_before * alpha,
                                torch.zeros_like(alpha))
                after = torch.where(cmask, t_before * oma,
                                    torch.full_like(alpha, float("inf")))
                t_comp[act] = torch.minimum(tc, after.amin(dim=-1))
                full_t[act] = full_t[act] * incl[..., -1].to(torch.float32)
                wt = torch.where(cmask, w.to(WIDE) * t.to(WIDE),
                                 torch.zeros_like(incl))
                depth[act] += _seqsum(wt).to(torch.float32)
                wa = (_bf16(w) if bf16 else w).to(WIDE)
                vals = g[:, :, SCAN_ATTR:SCAN_ATTR + NUM_ATTR]
                if bf16:
                    vals = _bf16(vals)
                vals = vals.to(WIDE)
                attr[act] += torch.stack(
                    [_seqsum(wa * vals[:, None, :, a]) for a in
                     range(NUM_ATTR)], dim=-1).to(torch.float32)
                if stats:
                    num[act] += cmask.sum(dim=-1).to(torch.float32)
                    trav[act] += gvalid.sum(dim=-1)
                    chunks[act] += gvalid.amax(dim=-1)
        factor = 1.0 + (t_comp - full_t) / torch.clamp(
            1.0 - t_comp, min=eps)
        rows = slice(tb.start * tile, tb.stop * tile)
        out[rows, :NUM_ATTR] = (attr * factor[..., None]).reshape(-1, NUM_ATTR)
        out[rows, OUT_DEPTH] = (depth * factor).reshape(-1)
        out[rows, OUT_TFINAL] = t_comp.reshape(-1)
        out[rows, OUT_FULLT] = full_t.reshape(-1)
        if stats:
            out[rows, OUT_NUMACC] = num.reshape(-1)
            out[rows, OUT_TRAV] = trav.repeat_interleave(tile)
            out[rows, OUT_CHUNKS] = chunks.repeat_interleave(tile)
    return out


def render_scan(
    rays_o, rays_d, scan: ScanTable, candidates, cand_near, near, far,
    exp_power, secondary, backfacing_max_dist,
    backfacing_invalid_normal_threshold, transmittance_threshold=0.01,
    eps_forward_normalization=1e-12, max_hits: int = 16, cluster: int = 128,
    tile: int = 256, alive=None, check_every: int = SCAN_CHECK_EVERY,
    t_split=None, window_mode: int = 0, secondary_static: int = -1,
    stats: bool = True, attr_precision: str = "highest",
) -> torch.Tensor:
    """Culled trace + streaming scan composite for one bounce; [R,
    OUT_LANES] f32.  The arguments are render_culled's, with the frame's
    ScanTable (pack_scan_table) in place of the gpack - its pair_math,
    "direct" (JAX v6) or "quadric" (v7), comes with the table, whose layout
    it decides - plus `stats` (the counter lanes; off compiles them out)
    and `attr_precision` ("bf16": w and the attributes rounded to bf16
    before their product, quadric only, as the JAX v7 takes it).

    CUDA tensors launch the kernel of csrc/render_scan.cu on the current
    stream (it is built at first use) and count the launch in
    `render_scan.launches` (and in `render_scan.launches_by_window
    [window_mode]`); CPU tensors take render_scan_reference.
    Anything else raises."""
    kw = dict(transmittance_threshold=transmittance_threshold,
              eps_forward_normalization=eps_forward_normalization,
              max_hits=max_hits, cluster=cluster, tile=tile, alive=alive,
              check_every=check_every, t_split=t_split,
              window_mode=window_mode, secondary_static=secondary_static,
              stats=stats, attr_precision=attr_precision)
    args = (rays_o, rays_d, scan, candidates, cand_near, near, far,
            exp_power, secondary, backfacing_max_dist,
            backfacing_invalid_normal_threshold)
    if attr_precision not in ATTR_PRECISIONS:
        raise ValueError(f"attr_precision={attr_precision!r}: expected one "
                         f"of {ATTR_PRECISIONS}")
    if attr_precision == "bf16" and scan.pair_math != "quadric":
        raise ValueError("attr_precision='bf16' comes with the quadric pair "
                         "math (scanq) only, as in the JAX package")
    dev = rays_o.device
    if dev.type == "cpu":
        return render_scan_reference(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"render_scan: no kernel for device {dev}")

    R = rays_o.shape[0]
    N = scan.table.shape[0]
    if R % tile or not 0 < tile <= MAX_TILE:
        raise ValueError(f"tile={tile} must divide R={R} and be <= "
                         f"{MAX_TILE}")
    if N % cluster or not 0 < cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster={cluster} must divide N={N}, <= "
                         f"{MAX_CLUSTER}")
    if window_mode not in (0, 1, 2) or secondary_static not in (-1, 0, 1):
        raise ValueError(f"window_mode={window_mode}, "
                         f"secondary_static={secondary_static}")
    n_tiles = R // tile
    mc = candidates.shape[1]
    _check("rays_o", rays_o, (R, 3), torch.float32, dev)
    _check("rays_d", rays_d, (R, 3), torch.float32, dev)
    _check("table", scan.table, (N, SCAN_COLS), torch.float32, dev)
    _check("candidates", candidates, (n_tiles, mc), torch.int32, dev)
    alive_f = _per_ray(alive, R, 1.0, dev).contiguous()
    t_split_f = _per_ray(t_split, R, 0.0, dev).contiguous()
    _check("alive", alive_f, (R,), torch.float32, dev)
    _check("t_split", t_split_f, (R,), torch.float32, dev)
    _check("center", scan.center, (3,), torch.float32, dev)

    out = torch.empty((R, OUT_LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(
            rays_o.data_ptr(), rays_d.data_ptr(), alive_f.data_ptr(),
            t_split_f.data_ptr(), scan.table.data_ptr(),
            scan.center.data_ptr(), candidates.data_ptr(), out.data_ptr(),
            R, N, mc, tile, cluster, check_every, window_mode,
            secondary_static, 0 if scan.pair_math == "direct" else 1,
            int(bool(stats)), int(attr_precision == "bf16"),
            _f32(near), _f32(far), _f32(secondary),
            _f32(backfacing_max_dist),
            _f32(backfacing_invalid_normal_threshold),
            _f32(transmittance_threshold), _f32(eps_forward_normalization),
            float(exp_power), stream)
    if err == SHAPES_REFUSED:
        raise ValueError(f"render_scan: no kernel for tile={tile}, "
                         f"cluster={cluster}")
    if err != 0:
        raise RuntimeError(f"render_scan kernel launch failed: cudaError "
                           f"{err}")
    render_scan.launches += 1
    render_scan.launches_by_window[window_mode] += 1
    return out


render_scan.launches = 0
render_scan.launches_by_window = [0, 0, 0]
