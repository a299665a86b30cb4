"""Brute or culled trace returning each ray's K nearest hits, depth-sorted,
with their per-hit payload, for one bounce of the non-fused renderer: the
CUDA kernel's wrapper (`trace_hits`) and its plain PyTorch version
(`trace_hits_reference`).

Counterpart of the JAX pallas_trace_fused (brute) and
pallas_trace_culled_fused (culled), ops/pallas/trace_kernel.py, which share
one contract (_unpack_fused):

  t         [R, K] f32  kept hits' depths, ascending; INF where empty
  ids       [R, K] i32  Gaussian index (0 where empty)
  alpha     [R, K] f32  MAX_ALPHA * gaussval * opacity (0 where empty)
  gaussval  [R, K] f32  exp(-(sq sf^2)^p / 2p)          (0 where empty)
  local_hit [R, K, 3]   sf * (lo + t ld), the hit in the Gaussian's
                        sf-scaled unit frame, sf = sqrt(ROW_SF2) (0 where
                        empty)
  attrs     dict of the kept hits' shading attributes (rgb, normal, f0
            [R, K, 3], roughness [R, K]) with `extract_attrs`, else None
  log_T     [R] f32     sum of log1p(-alpha) over every valid hit of the
                        processed clusters
  traversed [R] i32     valid Gaussians in the processed clusters (the same
                        for every ray of a tile)

`candidates=None` is the brute mode: every Gaussian is tested and nothing
exits.  Its result does not depend on how the Gaussians are blocked, so the
rays are padded to a multiple of BRUTE_TILE (the padded rows are dropped)
and gpack to a multiple of BRUTE_CLUSTER with invalid columns.  Otherwise
the culled mode: per `tile` rays, the candidate clusters of
culling.select_candidates (near-ascending, -1 = empty), and before each one
the tile stops once every ray is saturated (log T <= log threshold) or has
its K-th hit before the candidate's near distance.  Dead rays are traced
like live ones (the Pallas kernels take no alive mask; the renderer masks
their hits afterwards), so they hold their tile's exit as on the TPU.

Shading attributes are gathered by id from gpack's attribute rows, which is
the value copy the Pallas drain makes in-kernel with extract_attrs.

Numerics shared by the kernel and the plain version (ops/precision.py), so
the two agree bit for bit: the walk of ops/cuda/render_kernel.py (float32
pair math, every product rounded, exp/pow in WIDE rounded once, log1p terms
and their sum in WIDE), hits sorted by (t, id), and gaussval and local_hit
recomputed per kept hit with the walk's float operations.  The Pallas
kernels sum log T in float32 per chunk and test saturation on that sum, so
against JAX the port agrees to a stated tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..precision import div, rounded
from . import build
from .layout import (
    ATTR_ROWS,
    INF,
    N_ROWS,
    ROW_INV,
    ROW_MEAN,
    ROW_ROT,
    ROW_SF2,
)
from .render_kernel import (
    SHAPES_REFUSED,
    SUPPORTED_K,
    _check,
    _f32,
    _log_f32,
    sort_slots,
    walk_tiles,
)

# the brute mode's blocking: rays per block and Gaussians per staged cluster
BRUTE_TILE = 256
BRUTE_CLUSTER = 256
# the kernels that walk csrc/trace_hits_walk.cuh, each with an
# egr_<name>_info entry point
WALK_KERNELS = ("trace_hits", "render_culled", "trace_slots")

_ARGTYPES = (
    [ctypes.c_void_p] * 13         # rays_o, rays_d, alive, gpack, cand,
                                   # cand_near, t, ids, alpha, gaussval,
                                   # local_hit, log_t, traversed
    + [ctypes.c_int] * 7           # n_rays, n_gauss, mc, tile, cluster,
                                   # max_hits, check_every
    + [ctypes.c_float] * 7         # near, far, secondary, bf_max_dist,
                                   # bf_thr, log_thr, exp_power
    + [ctypes.c_void_p]            # stream
)


@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("trace_hits").egr_trace_hits
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_info(max_hits: int, cube: bool = True, backfacing: bool = False,
                tile: int = BRUTE_TILE, cluster: int = BRUTE_CLUSTER,
                kernel: str = "trace_hits", exit_mode: int = 0) -> dict:
    """What the card's runtime reports of the compiled kernel of one of
    WALK_KERNELS (csrc/<kernel>.cu) for (max_hits, exp_power 3 or not,
    backfacing test or not: reflected passes, exit mode) at (tile,
    cluster): registers and spilled (local) bytes per thread, dynamic
    shared memory per block and resident blocks per SM (trace_slots:
    exit_mode 2 is exit mode 0's split-far windowed kernel).  Needs a CUDA
    device."""
    if kernel not in WALK_KERNELS:
        raise ValueError(f"kernel={kernel!r}: one of {WALK_KERNELS}")
    fn = getattr(build.load(kernel), f"egr_{kernel}_info")
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(max_hits, int(cube), int(backfacing), exit_mode, tile, cluster,
             ctypes.addressof(out))
    if err == SHAPES_REFUSED:
        raise ValueError(f"{kernel}: no kernel for max_hits={max_hits}, "
                         f"exit_mode={exit_mode}, tile={tile}, "
                         f"cluster={cluster}")
    if err != 0:
        raise RuntimeError(f"{kernel} kernel info failed: cudaError {err}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def walk_inputs(rays_o, rays_d, gpack, candidates, cand_near,
                transmittance_threshold, cluster: int, tile: int):
    """What the walk traces in either mode: (rays_o, rays_d, gpack,
    candidates, cand_near, transmittance threshold, cluster, tile,
    check_every).  Brute mode (candidates None): rays padded with zero rays
    to a multiple of BRUTE_TILE, gpack with zero (invalid) columns to a
    multiple of BRUTE_CLUSTER, every cluster listed for every tile at near
    distance -INF and threshold 0 (log -INF), all in one group, so no tile
    ever stops.  Culled mode: the inputs as given, checked before every
    candidate."""
    rays_o = rays_o.to(torch.float32).contiguous()
    rays_d = rays_d.to(torch.float32).contiguous()
    if candidates is not None:
        return (rays_o, rays_d, gpack, candidates, cand_near,
                transmittance_threshold, cluster, tile, 1)
    dev = rays_o.device
    R, N = rays_o.shape[0], gpack.shape[1]
    Rp = _round_up(max(R, 1), BRUTE_TILE)
    Np = _round_up(max(N, 1), BRUTE_CLUSTER)
    if Rp != R:
        pad = torch.zeros((Rp - R, 3), dtype=torch.float32, device=dev)
        rays_o = torch.cat([rays_o, pad])
        rays_d = torch.cat([rays_d, pad])
    if Np != N:
        gpack = torch.cat([gpack, torch.zeros((N_ROWS, Np - N),
                                              dtype=gpack.dtype, device=dev)],
                          dim=1).contiguous()
    nc, T = Np // BRUTE_CLUSTER, Rp // BRUTE_TILE
    cands = torch.arange(nc, dtype=torch.int32, device=dev).expand(
        T, nc).contiguous()
    cnear = torch.full((T, nc), float("-inf"), dtype=torch.float32,
                       device=dev)
    return (rays_o, rays_d, gpack, cands, cnear, 0.0, BRUTE_CLUSTER,
            BRUTE_TILE, nc)


def hit_payload(rays_o, rays_d, gpack, t, ids, exp_power):
    """gaussval [R, K] and local_hit [R, K, 3] of each kept hit (t < INF),
    recomputed from its gpack column with the walk's float operations; 0
    where the slot is empty."""
    valid = t < INF
    g = gpack[:, ids.to(torch.int64)]                             # [32, R, K]
    o = [rays_o[:, j:j + 1] for j in range(3)]                   # [R, 1]
    d = [rays_d[:, j:j + 1] for j in range(3)]
    rel = [o[j] - g[ROW_MEAN + j] for j in range(3)]
    lo = [g[ROW_INV + i] * (g[ROW_ROT + i] * rel[0]
                            + g[ROW_ROT + 3 + i] * rel[1]
                            + g[ROW_ROT + 6 + i] * rel[2]) for i in range(3)]
    ld = [g[ROW_INV + i] * (g[ROW_ROT + i] * d[0] + g[ROW_ROT + 3 + i] * d[1]
                            + g[ROW_ROT + 6 + i] * d[2]) for i in range(3)]
    dot_ol = lo[0] * ld[0] + lo[1] * ld[1] + lo[2] * ld[2]
    dot_ll = ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2]
    dot_oo = lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2]
    inv_ll = 1.0 / torch.clamp(dot_ll, min=1e-30)
    sq = dot_oo - dot_ol * dot_ol * inv_ll
    sf2 = g[ROW_SF2]
    sqs = torch.clamp(sq * sf2, min=0.0)
    if float(exp_power).is_integer() and 1 <= exp_power <= 8:
        powered = sqs
        for _ in range(int(exp_power) - 1):
            powered = powered * sqs
    else:
        powered = rounded(torch.pow, sqs, exp_power)
    gaussval = rounded(torch.exp, div(-powered, 2.0 * exp_power))
    sf = rounded(torch.sqrt, torch.clamp(sf2, min=0.0))
    local_hit = torch.stack([sf * (lo[i] + t * ld[i]) for i in range(3)],
                            dim=-1)
    zero = torch.zeros_like(gaussval)
    return (torch.where(valid, gaussval, zero),
            torch.where(valid[..., None], local_hit,
                        torch.zeros_like(local_hit)))


def slot_attributes(gpack, ids, valid) -> dict:
    """The kept hits' shading attributes by id from gpack's attribute rows
    (rgb, normal, f0 [R, K, 3], roughness [R, K]); 0 where empty."""
    a = gpack[list(ATTR_ROWS)][:, ids.to(torch.int64)]           # [10, R, K]
    a = torch.where(valid[None], a, torch.zeros_like(a))
    vec = a.permute(1, 2, 0)
    return dict(rgb=vec[..., 0:3], normal=vec[..., 3:6], f0=vec[..., 6:9],
                roughness=a[9])


def trace_hits_reference(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, max_hits: int = 32, cluster: int = 256,
    tile: int = 256,
):
    """Plain PyTorch version of the kernel's contract (module docstring),
    without the attributes: (t, ids, alpha, gaussval, local_hit, log_T,
    traversed).  The walk of ops/cuda/render_kernel.py with an all-ones
    alive mask, then the kept hits sorted by (t, id) and their payload."""
    R = rays_o.shape[0]
    K = max_hits
    o, d, gp, cands, cnear, thr, cluster, tile, check_every = walk_inputs(
        rays_o, rays_d, gpack, candidates, cand_near,
        transmittance_threshold, cluster, tile)
    Rp, dev = o.shape[0], o.device
    t = torch.empty((Rp, K), dtype=torch.float32, device=dev)
    ids = torch.empty((Rp, K), dtype=torch.int32, device=dev)
    alpha = torch.empty_like(t)
    gaussval = torch.empty_like(t)
    local_hit = torch.empty((Rp, K, 3), dtype=torch.float32, device=dev)
    log_T = torch.empty((Rp,), dtype=torch.float32, device=dev)
    traversed = torch.empty((Rp,), dtype=torch.int32, device=dev)
    walk = walk_tiles(
        o, d, gp, cands, cnear, near, far, exp_power, secondary,
        backfacing_max_dist, backfacing_invalid_normal_threshold,
        transmittance_threshold=thr, max_hits=K, cluster=cluster, tile=tile,
        check_every=check_every, secondary_static=-1, exit_mode=0)
    for rows, st, sa, sid, log_t, trav, _chunks, _gp in walk:
        st, sa, sid = sort_slots(st, sa, sid)
        valid = st < INF
        t[rows] = st
        ids[rows] = torch.where(valid, sid, torch.zeros_like(sid)).to(
            torch.int32)
        alpha[rows] = torch.where(valid, sa, torch.zeros_like(sa))
        gaussval[rows], local_hit[rows] = hit_payload(
            o[rows], d[rows], gp, st, sid, exp_power)
        log_T[rows] = log_t.to(torch.float32)
        traversed[rows] = trav.repeat_interleave(tile).to(torch.int32)
    return (t[:R], ids[:R], alpha[:R], gaussval[:R], local_hit[:R],
            log_T[:R], traversed[:R])


def _launch(rays_o, rays_d, gpack, candidates, cand_near, near, far,
            exp_power, secondary, backfacing_max_dist,
            backfacing_invalid_normal_threshold, transmittance_threshold,
            max_hits: int, cluster: int, tile: int):
    """The kernel of csrc/trace_hits.cu on the current stream."""
    dev = rays_o.device
    R = rays_o.shape[0]
    if max_hits not in SUPPORTED_K:
        raise ValueError(f"max_hits={max_hits}: the kernel is built for "
                         f"{SUPPORTED_K}")
    if candidates is not None and (tile <= 0 or R % tile):
        raise ValueError(f"tile={tile} must divide R={R}")
    o, d, gp, cands, cnear, thr, cluster, tile, check_every = walk_inputs(
        rays_o, rays_d, gpack, candidates, cand_near,
        transmittance_threshold, cluster, tile)
    Rp, N = o.shape[0], gp.shape[1]
    n_tiles, mc = Rp // tile, cands.shape[1]
    _check("rays_o", o, (Rp, 3), torch.float32, dev)
    _check("rays_d", d, (Rp, 3), torch.float32, dev)
    _check("gpack", gp, (N_ROWS, N), torch.float32, dev)
    _check("candidates", cands, (n_tiles, mc), torch.int32, dev)
    _check("cand_near", cnear, (n_tiles, mc), torch.float32, dev)
    alive = torch.ones((Rp,), dtype=torch.float32, device=dev)

    K = max_hits
    t = torch.empty((Rp, K), dtype=torch.float32, device=dev)
    ids = torch.empty((Rp, K), dtype=torch.int32, device=dev)
    alpha = torch.empty_like(t)
    gaussval = torch.empty_like(t)
    local_hit = torch.empty((Rp, K, 3), dtype=torch.float32, device=dev)
    log_T = torch.empty((Rp,), dtype=torch.float32, device=dev)
    traversed = torch.empty((Rp,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(
            o.data_ptr(), d.data_ptr(), alive.data_ptr(), gp.data_ptr(),
            cands.data_ptr(), cnear.data_ptr(), t.data_ptr(), ids.data_ptr(),
            alpha.data_ptr(), gaussval.data_ptr(), local_hit.data_ptr(),
            log_T.data_ptr(), traversed.data_ptr(),
            Rp, N, mc, tile, cluster, K, check_every,
            _f32(near), _f32(far), _f32(secondary), _f32(backfacing_max_dist),
            _f32(backfacing_invalid_normal_threshold), _log_f32(thr),
            float(exp_power), stream)
    if err == SHAPES_REFUSED:
        raise ValueError(f"trace_hits: the kernel refused max_hits={K}, "
                         f"tile={tile}, cluster={cluster} for {Rp} rays and "
                         f"{N} Gaussians (hits_shape_ok, init_hits_params: "
                         f"csrc/trace_hits_walk.cuh)")
    if err != 0:
        raise RuntimeError(f"trace_hits kernel launch failed: cudaError "
                           f"{err}")
    trace_hits.launches += 1
    trace_hits.launches_by_k[K] += 1
    return (t[:R], ids[:R], alpha[:R], gaussval[:R], local_hit[:R],
            log_T[:R], traversed[:R])


def trace_hits(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, max_hits: int = 32, cluster: int = 256,
    tile: int = 256, extract_attrs: bool = False,
):
    """Brute (candidates None) or culled trace for one bounce: (t, ids,
    alpha, gaussval, local_hit, attrs, log_T, traversed), module docstring.

    CUDA tensors launch the kernel of csrc/trace_hits.cu on the current
    stream (it is built at first use) and count the launch in
    `trace_hits.launches` (and in `trace_hits.launches_by_k[max_hits]`);
    CPU tensors take trace_hits_reference.  Anything else raises."""
    args = (rays_o, rays_d, gpack, candidates, cand_near, near, far,
            exp_power, secondary, backfacing_max_dist,
            backfacing_invalid_normal_threshold, transmittance_threshold)
    dev = rays_o.device
    if dev.type == "cpu":
        out = trace_hits_reference(*args, max_hits=max_hits,
                                   cluster=cluster, tile=tile)
    elif dev.type == "cuda":
        out = _launch(*args, max_hits, cluster, tile)
    else:
        raise ValueError(f"trace_hits: no kernel for device {dev}")
    attrs = (slot_attributes(gpack, out[1], out[0] < INF) if extract_attrs
             else None)
    return (*out[:5], attrs, *out[5:])


trace_hits.launches = 0
trace_hits.launches_by_k = dict.fromkeys(SUPPORTED_K, 0)
