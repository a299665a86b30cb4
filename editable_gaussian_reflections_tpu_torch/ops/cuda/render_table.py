"""The round-2 fused render - culled trace + k-buffer composite for one
bounce with the shading attributes in a separate [N, TABLE_A] table: the
CUDA kernel's wrapper (`render_culled_table`) and its plain PyTorch version
(`render_culled_table_reference`).

Counterpart of the JAX ops/pallas/render_kernel.py pallas_render_culled,
which only the JAX package's tests run.  The walk is render_culled's
(ops/cuda/render_kernel.py) with pallas_render_culled's early exit: groups
of two candidate clusters (the Pallas grid step), a group skipped when
every ray of the tile is saturated, has its K-th hit before the group's
first candidate, or is dead; every computed cluster counts in the chunks
lane.  The candidate list needs no padding to an even length: a missing
second entry is an empty one.  The composite is render_culled's with the
attributes read by id from the table (columns 0-9: rgb, normal, f0,
roughness; layout.pack_attr_table).  No window mode.

Numerics: render_culled's, so the kernel and the plain version agree bit
for bit.  Against the Pallas kernel (float32 log-transmittance and sums,
an order-free composite with ties by slot index), to a tolerance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .layout import N_ROWS, NUM_ATTR, OUT_LANES, TABLE_A
from .render_kernel import (
    SHAPES_REFUSED,
    SUPPORTED_K,
    _check,
    _composite,
    _f32,
    _log_f32,
    _per_ray,
    walk_tiles,
)

# pallas_render_culled's grid step: two candidate clusters
CHECK_EVERY = 2

_ARGTYPES = (
    [ctypes.c_void_p] * 8          # rays_o, rays_d, alive, gpack, table,
                                   # cand, cand_near, out
    + [ctypes.c_int] * 7           # n_rays, n_gauss, mc, tile, cluster,
                                   # max_hits, secondary_static
    + [ctypes.c_float] * 9         # near, far, secondary, bf_max_dist,
                                   # bf_thr, thr, eps_norm, log_thr,
                                   # exp_power
    + [ctypes.c_void_p]            # stream
)


@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("render_table").egr_render_table
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def render_culled_table_reference(
    rays_o, rays_d, gpack, table, candidates, cand_near, near, far,
    exp_power, secondary, backfacing_max_dist,
    backfacing_invalid_normal_threshold, transmittance_threshold=0.01,
    eps_forward_normalization=1e-12, max_hits: int = 32, cluster: int = 256,
    tile: int = 256, alive=None, secondary_static: int = -1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract (module docstring):
    walk_tiles in exit mode 1 with groups of two, then the composite with
    the table's attributes.  Runs on any device."""
    R = rays_o.shape[0]
    out = torch.empty((R, OUT_LANES), dtype=torch.float32,
                      device=rays_o.device)
    attr_rows = table[:, :NUM_ATTR].T
    walk = walk_tiles(
        rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
        secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
        transmittance_threshold=transmittance_threshold, max_hits=max_hits,
        cluster=cluster, tile=tile, alive=alive, check_every=CHECK_EVERY,
        secondary_static=secondary_static, exit_mode=1)
    for rows, st, sa, sid, log_t, trav, chunks, _gp in walk:
        out[rows, :14] = _composite(
            st, sa, sid, log_t, attr_rows, _f32(transmittance_threshold),
            _f32(eps_forward_normalization))
        out[rows, 14] = trav.repeat_interleave(tile)
        out[rows, 15] = chunks.repeat_interleave(tile)
    return out


def render_culled_table(
    rays_o, rays_d, gpack, table, candidates, cand_near, near, far,
    exp_power, secondary, backfacing_max_dist,
    backfacing_invalid_normal_threshold, transmittance_threshold=0.01,
    eps_forward_normalization=1e-12, max_hits: int = 32, cluster: int = 256,
    tile: int = 256, alive=None, secondary_static: int = -1,
) -> torch.Tensor:
    """Culled trace + composite for one bounce, attributes from `table`
    [N, TABLE_A]; [R, OUT_LANES] f32.  The arguments are
    pallas_render_culled's (without `interpret`).

    CUDA tensors launch the kernel of csrc/render_table.cu on the current
    stream (it is built at first use) and count the launch in
    `render_culled_table.launches` (and in
    `render_culled_table.launches_by_k[max_hits]`); CPU tensors take
    render_culled_table_reference.  Anything else raises."""
    kw = dict(transmittance_threshold=transmittance_threshold,
              eps_forward_normalization=eps_forward_normalization,
              max_hits=max_hits, cluster=cluster, tile=tile, alive=alive,
              secondary_static=secondary_static)
    args = (rays_o, rays_d, gpack, table, candidates, cand_near, near, far,
            exp_power, secondary, backfacing_max_dist,
            backfacing_invalid_normal_threshold)
    dev = rays_o.device
    if dev.type == "cpu":
        return render_culled_table_reference(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"render_culled_table: no kernel for device {dev}")

    R = rays_o.shape[0]
    N = gpack.shape[1]
    if max_hits not in SUPPORTED_K:
        raise ValueError(f"max_hits={max_hits}: the kernel is built for "
                         f"{SUPPORTED_K}")
    if R % tile or not 0 < tile <= 512:
        raise ValueError(f"tile={tile} must divide R={R} and be <= 512")
    if N % cluster or not 0 < cluster <= 512:
        raise ValueError(f"cluster={cluster} must divide N={N}, <= 512")
    if secondary_static not in (-1, 0, 1):
        raise ValueError(f"secondary_static={secondary_static}")
    n_tiles = R // tile
    mc = candidates.shape[1]
    _check("rays_o", rays_o, (R, 3), torch.float32, dev)
    _check("rays_d", rays_d, (R, 3), torch.float32, dev)
    _check("gpack", gpack, (N_ROWS, N), torch.float32, dev)
    _check("table", table, (N, TABLE_A), torch.float32, dev)
    _check("candidates", candidates, (n_tiles, mc), torch.int32, dev)
    _check("cand_near", cand_near, (n_tiles, mc), torch.float32, dev)
    alive_f = _per_ray(alive, R, 1.0, dev).contiguous()
    _check("alive", alive_f, (R,), torch.float32, dev)

    out = torch.empty((R, OUT_LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(
            rays_o.data_ptr(), rays_d.data_ptr(), alive_f.data_ptr(),
            gpack.data_ptr(), table.data_ptr(), candidates.data_ptr(),
            cand_near.data_ptr(), out.data_ptr(),
            R, N, mc, tile, cluster, max_hits, secondary_static,
            _f32(near), _f32(far), _f32(secondary), _f32(backfacing_max_dist),
            _f32(backfacing_invalid_normal_threshold),
            _f32(transmittance_threshold), _f32(eps_forward_normalization),
            _log_f32(transmittance_threshold), float(exp_power), stream)
    if err == SHAPES_REFUSED:
        raise ValueError(f"render_culled_table: no kernel for max_hits="
                         f"{max_hits}, tile={tile}, cluster={cluster}")
    if err != 0:
        raise RuntimeError(f"render_culled_table kernel launch failed: "
                           f"cudaError {err}")
    render_culled_table.launches += 1
    render_culled_table.launches_by_k[max_hits] += 1
    return out


render_culled_table.launches = 0
render_culled_table.launches_by_k = dict.fromkeys(SUPPORTED_K, 0)
