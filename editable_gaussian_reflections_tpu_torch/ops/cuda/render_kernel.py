"""Culled trace + k-buffer composite for one bounce: the CUDA kernel's
wrapper (`render_culled`) and its plain PyTorch version
(`render_culled_reference`).

Counterpart of the JAX ops/pallas/render_kernel_v3.py
(pallas_render_culled_v4 and pallas_render_culled_v3, which share one
contract).  Per ray tile, the candidate clusters are walked nearest first;
each ray keeps its K nearest hits (exact top-K with a replace-max insertion),
accumulates the log-transmittance of every valid hit in the processed
clusters, and finally composites its K hits front to back with the
truncated-tail correction.  Every `check_every` clusters the tile stops when
each ray is saturated (log T <= log thr) or has all further candidates behind
its K-th hit, or when the whole tile is dead.  That exit is part of the
result: full_T, and through the tail factor every composited lane, only
count the processed clusters.

Candidate lists must be near-ascending, -1 marks an empty entry, and a list
is padded to a multiple of `check_every` with empty entries (cand_near
3e38).  Output: [R, OUT_LANES] f32, lanes in ops/cuda/layout.py.  JAX's
pallas_render_culled_v3 groups by 4 where v4 groups by 8; the caller passes
the group size of the kernel it reproduces.

Numerics shared by the kernel and the plain version, so that the two agree
bit for bit (the rules of ops/precision.py): float32 pair math with every
product rounded (no FMA), exp/pow in WIDE rounded once, the
log-transmittance terms log1p(-alpha) and every sum in WIDE, summed in lane
and slot order, and a composite over the K hits sorted by (t, id).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..gaussian_kernel import MAX_ALPHA
from ..precision import WIDE, div, rounded
from . import build
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

# the k-buffer depths K (max_hits) every k-buffer kernel and the slot sort
# are built for, the one definition of the set: the JAX package takes any
# static K, the port builds these (ROADMAP, "Divergences kept by decision"),
# and a wrapper raises a ValueError naming them for any other
SUPPORTED_K = (8, 16, 32, 64)
# the plain version processes this many ray tiles at once (bounds memory:
# its [tiles, tile, cluster] intermediates are ~16 MB each at 256 x 256)
REFERENCE_TILES_PER_BATCH = 64
# the JAX package keeps a scene resident in a TPU core's VMEM up to this many
# bytes (render_kernel_v3.py RESIDENT_GPACK_LIMIT); which Pallas kernel it
# runs, and so which early exit the port reproduces, follows from it
RESIDENT_LIMIT = 96 * 1024 * 1024
# what the C entry points of the k-buffer kernels return when they refuse
# the shapes: the limits (K, rays per block, Gaussians per cluster, shared
# memory) are checked there only, in hits_shape_ok
# (csrc/trace_hits_walk.cuh)
SHAPES_REFUSED = -1

_ARGTYPES = (
    [ctypes.c_void_p] * 8          # rays_o, rays_d, alive, t_split, gpack,
                                   # cand, cand_near, out
    + [ctypes.c_int] * 9           # n_rays, n_gauss, mc, tile, cluster,
                                   # max_hits, check_every, window_mode,
                                   # secondary_static
    + [ctypes.c_float] * 9         # near, far, secondary, bf_max_dist,
                                   # bf_thr, thr, eps_norm, log_thr,
                                   # exp_power
    + [ctypes.c_void_p]            # stream
)


@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("render_culled").egr_render_culled
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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

    k2 = 2.0 * exp_power
    sqs = torch.clamp(sq * sf2, min=0.0)
    if float(exp_power).is_integer() and 1 <= exp_power <= 8:
        powered = sqs
        for _ in range(int(exp_power) - 1):
            powered = powered * sqs
    else:
        powered = rounded(torch.pow, sqs, exp_power)
    gaussval = rounded(torch.exp, div(-powered, k2))
    alpha = MAX_ALPHA * gaussval * opacity
    return t, alpha, valid


def _drain(st, sa, sid, t, alpha, valid, first_id, K):
    """Insert one cluster's hits into the slots [A, tile, K] in ascending
    (t, lane) order, each replacing the first slot holding the K-th depth
    while t < K-th depth (the Pallas drain's order; at most K inserts)."""
    kth = st.amax(dim=-1)
    tmask = torch.where(valid & (t < kth[..., None]), t,
                        torch.full_like(t, INF))
    srt, lane = torch.sort(tmask, dim=-1, stable=True)
    slot_idx = torch.arange(K, device=st.device)
    for i in range(min(K, t.shape[-1])):
        tmin = srt[..., i]
        ins = tmin < kth
        if not bool(ins.any()):
            break
        ln = lane[..., i:i + 1]
        win = (st >= kth[..., None]).to(torch.int8).argmax(dim=-1)
        put = (slot_idx == win[..., None]) & ins[..., None]
        st = torch.where(put, tmin[..., None], st)
        sa = torch.where(put, alpha.gather(-1, ln), sa)
        sid = torch.where(put, first_id[:, None, None] + ln, sid)
        kth = st.amax(dim=-1)
    return st, sa, sid


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


def walk_tiles(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, max_hits: int = 16, cluster: int = 128,
    tile: int = 256, alive=None, check_every: int = 8, t_split=None,
    window_mode: int = 0, secondary_static: int = -1, exit_mode: int = 0):
    """Plain version of the k-buffer kernels' walk (csrc/trace_hits_walk.cuh):
    the culled walk over each ray tile's candidates with the early exit of
    `exit_mode` (0: the v4 group exit, 1: pallas_trace_slots' pairs with
    per-ray dead; see the header).

    Vectorised over ray tiles, looping over candidate groups with a per-tile
    `done` mask.  Yields, per batch of up to REFERENCE_TILES_PER_BATCH
    tiles, (rows, st, sa, sid [B*tile, K] as kept (unsorted), log_t
    [B*tile] WIDE, trav [B], chunks [B]) and the padded gpack (a zero
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
    # empty entries read an all-invalid dummy cluster appended to gpack
    gp = torch.cat([gpack, torch.zeros((N_ROWS, cluster), dtype=gpack.dtype,
                                       device=dev)], dim=1)
    cand = torch.where(listed, cand, N // cluster)
    alive = _per_ray(alive, R, 1.0, dev).reshape(n_tiles, tile)
    t_split = _per_ray(t_split, R, 0.0, dev).reshape(n_tiles, tile)
    o = rays_o.to(torch.float32).reshape(n_tiles, tile, 3)
    d = rays_d.to(torch.float32).reshape(n_tiles, tile, 3)
    log_thr = _log_f32(transmittance_threshold)
    pair_kw = dict(near=_f32(near), far=_f32(far), secondary=_f32(secondary),
                   bf_max_dist=_f32(backfacing_max_dist),
                   bf_thr=_f32(backfacing_invalid_normal_threshold),
                   exp_power=float(exp_power), window_mode=window_mode,
                   secondary_static=secondary_static)
    lane = torch.arange(cluster, device=dev)

    for t0 in range(0, n_tiles, REFERENCE_TILES_PER_BATCH):
        tb = slice(t0, min(n_tiles, t0 + REFERENCE_TILES_PER_BATCH))
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
            if act.numel() == 0:
                break
            ta = act + t0
            for ci in range(base, base + CE):
                c = cand[ta, ci]
                g = gp[:, c[:, None] * cluster + lane].permute(1, 0, 2)
                t, alpha, valid, gvalid = _pair_math(
                    o[ta], d[ta], alive[ta], t_split[ta], g, **pair_kw)
                la = torch.log1p((-alpha).to(WIDE))
                log_t[act] += _seqsum(torch.where(valid, la,
                                                  torch.zeros_like(la)))
                trav[act] += gvalid.sum(-1)
                if exit_mode == 1:
                    chunks[act] += listed[ta, ci].to(torch.float32)
                else:
                    chunks[act] += gvalid.amax(-1)
                st[act], sa[act], sid[act] = _drain(
                    st[act], sa[act], sid[act], t, alpha, valid,
                    c * cluster, K)
        rows = slice(tb.start * tile, tb.stop * tile)
        yield (rows, st.reshape(-1, K), sa.reshape(-1, K), sid.reshape(-1, K),
               log_t.reshape(-1), trav, chunks, gp)


def sort_slots(st, sa, sid):
    """The kept hits [R, K] ordered by (t, id), as the kernels sort them.
    The Pallas kernels' order (t, slot index) equals this except on exact
    depth ties."""
    order = torch.sort(sid, dim=-1, stable=True).indices
    st, sa, sid = (x.gather(-1, order) for x in (st, sa, sid))
    order = torch.sort(st, dim=-1, stable=True).indices
    return tuple(x.gather(-1, order) for x in (st, sa, sid))


def render_culled_reference(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, eps_forward_normalization=1e-12,
    max_hits: int = 16, cluster: int = 128, tile: int = 256, alive=None,
    check_every: int = 8, t_split=None, window_mode: int = 0,
    secondary_static: int = -1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (module docstring):
    walk_tiles, then the composite.  Runs on any device; the CPU tests and
    the comparison in chip_smoke.py use it."""
    R = rays_o.shape[0]
    out = torch.empty((R, OUT_LANES), dtype=torch.float32,
                      device=rays_o.device)
    walk = walk_tiles(
        rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
        secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
        transmittance_threshold=transmittance_threshold, max_hits=max_hits,
        cluster=cluster, tile=tile, alive=alive, check_every=check_every,
        t_split=t_split, window_mode=window_mode,
        secondary_static=secondary_static, exit_mode=0)
    for rows, st, sa, sid, log_t, trav, chunks, gp in walk:
        out[rows, :14] = _composite(
            st, sa, sid, log_t, gp[list(ATTR_ROWS)],
            _f32(transmittance_threshold),
            _f32(eps_forward_normalization))
        out[rows, 14] = trav.repeat_interleave(tile)
        out[rows, 15] = chunks.repeat_interleave(tile)
    return out


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def render_culled(
    rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, eps_forward_normalization=1e-12,
    max_hits: int = 16, cluster: int = 128, tile: int = 256, alive=None,
    check_every: int = 8, t_split=None, window_mode: int = 0,
    secondary_static: int = -1,
) -> torch.Tensor:
    """Culled trace + composite for one bounce; [R, OUT_LANES] f32.

    CUDA tensors launch the kernel of csrc/render_culled.cu on the current
    stream (it is built at first use) and count the launch in
    `render_culled.launches` (and in `render_culled.launches_by_window
    [window_mode]` and `render_culled.launches_by_k[max_hits]`); CPU
    tensors take render_culled_reference.
    Anything else raises."""
    kw = dict(transmittance_threshold=transmittance_threshold,
              eps_forward_normalization=eps_forward_normalization,
              max_hits=max_hits, cluster=cluster, tile=tile, alive=alive,
              check_every=check_every, t_split=t_split,
              window_mode=window_mode, secondary_static=secondary_static)
    args = (rays_o, rays_d, gpack, candidates, cand_near, near, far,
            exp_power, secondary, backfacing_max_dist,
            backfacing_invalid_normal_threshold)
    dev = rays_o.device
    if dev.type == "cpu":
        return render_culled_reference(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"render_culled: no kernel for device {dev}")

    R = rays_o.shape[0]
    N = gpack.shape[1]
    if max_hits not in SUPPORTED_K:
        raise ValueError(f"max_hits={max_hits}: the kernel is built for "
                         f"{SUPPORTED_K}")
    if tile <= 0 or R % tile:
        raise ValueError(f"tile={tile} must divide R={R}")
    if cluster <= 0 or N % cluster:
        raise ValueError(f"cluster={cluster} must divide N={N}")
    if window_mode not in (0, 1, 2) or secondary_static not in (-1, 0, 1):
        raise ValueError(f"window_mode={window_mode}, "
                         f"secondary_static={secondary_static}")
    n_tiles = R // tile
    mc = candidates.shape[1]
    _check("rays_o", rays_o, (R, 3), torch.float32, dev)
    _check("rays_d", rays_d, (R, 3), torch.float32, dev)
    _check("gpack", gpack, (N_ROWS, N), torch.float32, dev)
    _check("candidates", candidates, (n_tiles, mc), torch.int32, dev)
    _check("cand_near", cand_near, (n_tiles, mc), torch.float32, dev)
    alive_f = _per_ray(alive, R, 1.0, dev).contiguous()
    t_split_f = _per_ray(t_split, R, 0.0, dev).contiguous()
    _check("alive", alive_f, (R,), torch.float32, dev)
    _check("t_split", t_split_f, (R,), torch.float32, dev)

    out = torch.empty((R, OUT_LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(
            rays_o.data_ptr(), rays_d.data_ptr(), alive_f.data_ptr(),
            t_split_f.data_ptr(), gpack.data_ptr(), candidates.data_ptr(),
            cand_near.data_ptr(), out.data_ptr(),
            R, N, mc, tile, cluster, max_hits, check_every, window_mode,
            secondary_static,
            _f32(near), _f32(far), _f32(secondary), _f32(backfacing_max_dist),
            _f32(backfacing_invalid_normal_threshold),
            _f32(transmittance_threshold), _f32(eps_forward_normalization),
            _log_f32(transmittance_threshold), float(exp_power), stream)
    if err == SHAPES_REFUSED:
        raise ValueError(f"render_culled: the kernel refused max_hits="
                         f"{max_hits}, tile={tile}, cluster={cluster} "
                         f"(hits_shape_ok: csrc/trace_hits_walk.cuh)")
    if err != 0:
        raise RuntimeError(f"render_culled kernel launch failed: cudaError "
                           f"{err}")
    render_culled.launches += 1
    render_culled.launches_by_window[window_mode] += 1
    render_culled.launches_by_k[max_hits] += 1
    return out


render_culled.launches = 0
render_culled.launches_by_window = [0, 0, 0]
render_culled.launches_by_k = dict.fromkeys(SUPPORTED_K, 0)


def check_every_for(capacity: int) -> int:
    """Early-exit group size of the JAX kernel the renderer reproduces: the
    JAX renderer runs pallas_render_culled_v4 (groups of 8) when the packed
    scene fits its resident budget and pallas_render_culled_v3 (groups of 4)
    otherwise (raytracer.py:1080-1082, render_kernel_v3.py:490)."""
    return 8 if (capacity + 128) * N_ROWS * 4 <= RESIDENT_LIMIT else 4



# pallas_render_culled_v5's candidate preparation (render_kernel_v5.py:
# 402-431), taken by its port (ops/cuda/render_fine.py).  Each of the three
# changes where the walk may exit, and so full_T and the counters.
V5_SPAN = 128


def v5_check_every(check_every: int, cluster: int, span: int = V5_SPAN) -> int:
    """v5's early-exit group size: at least one drain span of `span //
    cluster` clusters, rounded down to whole spans (render_kernel_v5.py:
    405-409)."""
    span = max(span, cluster)
    if span % cluster:
        raise ValueError(f"span={span} is not a multiple of cluster="
                         f"{cluster}")
    per_span = span // cluster
    return max(check_every, per_span) // per_span * per_span


def pad_candidates(candidates, cand_near, multiple: int):
    """Candidate lists [T, MC] padded with empty entries (-1, near 3e38) to
    a multiple of `multiple` (render_kernel_v5.py:414-420)."""
    mc = candidates.shape[1]
    pad = -mc % multiple
    if pad == 0:
        return candidates, cand_near
    return (torch.nn.functional.pad(candidates, (0, pad), value=-1),
            torch.nn.functional.pad(cand_near, (0, pad), value=3.0e38))


def truncate_near(candidates, cand_near) -> torch.Tensor:
    """v5's packed near distances as float32 (render_kernel_v5.py:425-431):
    an empty candidate's 3e38, any other max(near, 0), truncated toward
    zero to bf16 (the float's bits & 0xFFFF0000), so never above the true
    near and the exit stays conservative.  v5 tests `behind` on the int32
    bits (:347-351), which order non-negative floats as the floats do: the
    walks' float test on these values decides the same."""
    near = torch.where(candidates < 0, torch.full_like(cand_near, 3.0e38),
                       torch.clamp(cand_near, min=0.0))
    return (near.contiguous().view(torch.int32) & -65536).view(torch.float32)
