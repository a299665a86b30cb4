"""Culled trace returning depth-sorted full-payload slots for one bounce of
the training step: in plain PyTorch:
a frozen copy of the port's plain version (ops/cuda/trace_slots.py) on the
reference's walk (render_kernel.walk_tiles).

Counterpart of the JAX pallas_trace_slots_v4 (ops/pallas/render_kernel_v3.py)
and pallas_trace_slots (ops/pallas/render_kernel.py), which share one
contract: per ray tile, walk the candidate clusters nearest first, keep each
ray's K nearest valid hits, accumulate log-T over every valid hit of the
processed clusters plus the traversed count, and return

  slots [R, SLOT_BLOCKS*K] f32 in unpack_slots block order (t, alpha, id,
        10 attributes, 24 frame-table fields), depth-sorted, empty slots
        t = INF and zeros;
  acc   [R, 16] f32: log-T, traversed Gaussians, processed-cluster count.

The two Pallas kernels stop differently, and the stop is part of the result
(csrc/trace_hits_walk.cuh): `exit_mode_for(capacity)` picks the one the JAX
dispatch would run.  The kernel reads the geometry from gpack, and gathers
each kept hit's attributes from pack_attr_table's [N, TABLE_A] table and its
frame fields from pack_frame_table's [N, FTABLE_A] table, by id (the inputs
of pallas_trace_slots; pallas_trace_slots_v4 reads the same attribute
values from gpack's rows).

`t_split` [R] and `window_mode` 1 / 2 keep only the hits with t < t_split
(split-far's near pass) or t > t_split (its far pass), as
pallas_trace_slots_v4's do (render_kernel_v3.py:793-803): every far hit
then lies behind every near hit, and merge_slots (ops/cuda/layout.py)
concatenates the two passes' slots into one depth-sorted list.  Exit mode
1 (pallas_trace_slots) takes no window: the JAX step splits only where the
resident kernel runs (slots_resident_fits).
"""

from __future__ import annotations

import torch

from .layout import (
    FTABLE_A,
    INF,
    N_ROWS,
    NUM_ATTR,
    NUM_FRAME,
    SLOT_ATTR,
    SLOT_BLOCKS,
    SLOT_FRAME,
)
from .render_kernel import (
    RESIDENT_LIMIT,
    WalkOptions,
    lowered,
    sort_slots,
    walk_tiles,
)

# lanes of the acc output: log-T, traversed Gaussians, processed clusters
ACC_LANES = 16


def slots_resident_fits(n_capacity: int) -> bool:
    """The JAX dispatch's test (render_kernel_v3.py:777-779): gpack and the
    frame table both resident.  True selects pallas_trace_slots_v4, False
    pallas_trace_slots."""
    return (n_capacity + 128) * (N_ROWS + FTABLE_A) * 4 <= RESIDENT_LIMIT


def exit_mode_for(n_capacity: int) -> tuple[int, int]:
    """(exit_mode, check_every) of the Pallas kernel the JAX dispatch runs
    for this capacity: v4's groups of 8, or v1's pairs."""
    return (0, 8) if slots_resident_fits(n_capacity) else (1, 2)


def _check_window(exit_mode: int, window_mode: int) -> None:
    """Refuse what no Pallas slots kernel takes: a window other than 0/1/2,
    or one in exit mode 1 (pallas_trace_slots has none)."""
    if window_mode not in (0, 1, 2):
        raise ValueError(f"window_mode={window_mode}: expected 0, 1 or 2")
    if exit_mode == 1 and window_mode:
        raise ValueError("exit_mode=1 (pallas_trace_slots) has no split-far "
                         f"window; window_mode={window_mode} needs exit "
                         "mode 0")


def trace_slots(
    rays_o, rays_d, gpack, table, ftable, candidates, cand_near, near, far,
    exp_power, secondary, backfacing_max_dist,
    backfacing_invalid_normal_threshold, transmittance_threshold=0.01,
    max_hits: int = 32, cluster: int = 256, tile: int = 256, alive=None,
    secondary_static: int = -1, exit_mode: int = 0, check_every: int = 8,
    t_split=None, window_mode: int = 0, opts: WalkOptions | None = None,
):
    """Plain PyTorch version of the kernel's contract (module docstring):
    the walk of ops/cuda/render_kernel.py (which applies the t-window),
    then the kept hits sorted by (t, id) and their payload gathered by
    id."""
    _check_window(exit_mode, window_mode)
    R = rays_o.shape[0]
    K = max_hits
    dev = rays_o.device
    slots = torch.empty((R, SLOT_BLOCKS, K), dtype=torch.float32, device=dev)
    acc = torch.zeros((R, ACC_LANES), dtype=torch.float32, device=dev)
    walk = walk_tiles(
        rays_o, rays_d, gpack, candidates, cand_near, near, far, exp_power,
        secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
        transmittance_threshold=transmittance_threshold, max_hits=max_hits,
        cluster=cluster, tile=tile, alive=alive, check_every=check_every,
        t_split=t_split, window_mode=window_mode,
        secondary_static=secondary_static, exit_mode=exit_mode, opts=opts,
        kernel="trace_slots")
    table, ftable = lowered(table, opts), lowered(ftable, opts)
    kept = 0
    for rows, st, sa, sid, log_t, trav, chunks, _gp in walk:
        st, sa, sid = sort_slots(st, sa, sid)
        valid = st < INF
        zero = torch.zeros_like(sa)
        slots[rows, 0] = st
        slots[rows, 1] = torch.where(valid, sa, zero)
        slots[rows, 2] = torch.where(valid, sid.to(torch.float32), zero)
        v = valid[:, None, :]
        attrs = table[sid, :NUM_ATTR].permute(0, 2, 1)          # [B, 10, K]
        slots[rows, SLOT_ATTR:SLOT_ATTR + NUM_ATTR] = torch.where(
            v, attrs, torch.zeros_like(attrs))
        frame = ftable[sid, :NUM_FRAME].permute(0, 2, 1)        # [B, 24, K]
        slots[rows, SLOT_FRAME:] = torch.where(v, frame,
                                               torch.zeros_like(frame))
        acc[rows, 0] = log_t.to(torch.float32)
        acc[rows, 1] = trav.repeat_interleave(tile)
        acc[rows, 2] = chunks.repeat_interleave(tile)
        kept += int(valid.sum())
    if opts is not None:
        opts.add("trace_slots", kept_hits=kept)
    return slots.reshape(R, SLOT_BLOCKS * K), acc


