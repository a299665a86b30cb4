#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (editable_gaussian_reflections_tpu_torch)
on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build every kernel of the port
     (csrc/render_culled.cu, trace_slots.cu, scatter_grads.cu, render_scan.cu,
     trace_hits.cu, render_table.cu, bench_dtype.cu, sort_slots.cu) with
     nvcc into build/kernels/, one nvcc per source, all
     started together (timed, with the ptxas register lines);
  2. the kernel vs its plain PyTorch version on the same CUDA tensors:
     room_scene(16384) at 128x128, Config defaults (K=32, cluster 256,
     192 candidates), primary rays and reflected rays with their alive mask;
  3. one 64x64 2-bounce frame rendered on cuda and on cpu (the plain path)
     with the same samples;
  4. the eval render at full size - room_scene(100_000), 800x800, 2 bounces,
     Config defaults - through dispatch_render_frame and
     render_accumulated_chunked (4 spp in chunks of 2), with the kernel's
     launch count, ms/frame, Mrays/s and the starved fraction.  First the
     kernel and its plain version are compared (tolerances of phase 2) and
     timed at the shapes of this frame's primary and first reflected pass,
     each beside its bound and no-FMA issue floor, with the compiled
     kernel's registers, spilled bytes, shared memory and resident blocks
     per SM (K 16 and 32, primary and reflected; what the runtime reports).
     4b: render_culled in groups of 4 (pallas_render_culled_v3's exit, which
     the renderer takes above the resident capacity) on the same primary
     pass: timed, its bound, held against its plain version on the first
     CHECK_TILES tiles;
  5. the training kernels vs their plain PyTorch versions at the full-width
     step's own shapes: room_scene(175_000) (capacity 176,128), 768x768,
     the Config defaults (K=32, cluster 256, 192 candidates, 8192-ray tiles,
     2 bounces), the step's tiles in the batch the main path launches -
     trace_slots on its primary and first reflected pass, scatter_grads on
     the hits of all 3 bounces (within 1e-6 x scale, zeros equal; its
     nonzero values counted); all timed with CUDA events, trace_slots
     beside its bound and no-FMA issue floor, with what the runtime reports
     of both compiled kernels (trace_slots in both exit modes).  5b:
     trace_slots in exit mode 1 (pallas_trace_slots' pairs, check_every 2)
     on the same primary batch: timed, its bound, held against its plain
     version on the first CHECK_TILES tiles.  Phase 5 requires equal ids and counters on
     every ray (exact depth ties included); phases 4, 11 and 12 print the
     share of rays equal, and every phase lists the rays that differ;
  6. one small training step (64x64, room_scene(4096)) on cuda and on cpu
     with the same samples: new params, moments and metrics equal;
  7. the full-width training step: 1 warm-up and 3 timed train_steps from
     room_scene(175_000) (seed 1) towards the G-buffers of room_scene(175_000)
     (seed 0) rendered at 768x768 by render_frame_fused; ms/step, M rays/s,
     l1_diffuse per step, starved fraction, the kernels' launch counts
     against the expected ones, and a profiled step (each kernel's device
     time and share, device idle share).  Phases 4, 5 and 7 take their
     frame and step from tools/fused_setup.py, as tools/walk_ab.py and
     tools/fused_ab.py do;
  8. the scan kernel (render_scan) vs its plain version on the same CUDA
     tensors at 128x128, room_scene(16384): composite_mode scan (direct pair
     math) and scanq (quadric), counters on and off, bf16 attributes; then
     one 64x64 2-bounce frame in each scan mode on cuda and on cpu, equal;
     the compiled kernel's registers, spilled bytes, shared memory and
     resident blocks per SM (what the runtime reports);
  9. the inference fast path at full width, room_scene(100_000), 800x800,
     2 bounces: (a) bench.py's configuration (artifacts/bench_best.json,
     written out below: scanq, counters off, bf16 attributes, cluster 128,
     128/768 candidates, K 16, throughput cutoff 1e-3) - ms/frame, FPS,
     M frame rays/s, starved fraction, device idle share, the scan kernel's
     ms per pass (scanq and scan), each against its bound and its plain
     version, the scan (v6) frame, and the k-buffer frame with its
     tonemapped PSNR against scanq; (b) measure_fps() at the Config defaults
     (scanq, cluster 256, 192 candidates, counters off) over 8 views
     orbiting room_camera, with the kernels' launch counts and the scan
     kernel's ms per pass against its bound and no-FMA issue floor (the
     ray-independent terms counted once per Gaussian on blocks of one
     origin), primary and reflected, and what the runtime reports of the
     kernels of (a) and (b);
 10. the non-fused trace kernel (trace_hits) vs its plain version at 128x128,
     room_scene(16384), on the renderer's own passes: brute and culled,
     primary and reflected, and a brute pass of a ragged ray count (1000);
     the compiled kernel's registers, spilled bytes, shared memory and
     resident blocks per SM at K 16 and 32 (what the runtime reports);
 11. the non-fused eval render at full width: room_scene(100_000) at
     1365x768 (a 16:9 image at the default -r 768, which the fused path
     cannot take: 1365 is not a multiple of 16), 2 bounces, Config defaults
     (K 32, cluster 256, 256-ray cull tiles, 192 candidates, 8192-ray
     tiles, rays in linear order) through dispatch_render_frame ->
     render_frame, culled: ms/frame, M frame rays/s, starved share, device
     idle share, trace_hits on the first launch of the primary and first
     reflected pass (CUDA events) with its pairs, bound and no-FMA issue
     floor (the flops issued one per lane and clock), kernel vs plain
     on its first NF_CHECK_TILES cull tiles, and the tonemapped PSNR
     against the brute frame of the same samples (what culling in row
     strips costs), also over the pixels starved at no bounce;
 12. the non-fused training step at full width: train_step with train.py's
     culling rule, which at 1365x768 (ray tile 8190, not a multiple of the
     256-ray cull tile) is use_culling=False - the brute trace - on
     room_scene(175_000) (seed 1) towards the seed-0 room's G-buffers:
     1 warm-up, 2 timed and 1 profiled step; ms/step, M rays/s, l1_diffuse,
     peak GB, device idle share, the brute trace's ms, pairs, bound and
     issue floor on
     the first launch of the primary and first reflected pass, and kernel
     vs plain on its first NF_CHECK_TILES ray blocks.

 13. the round-2 render (render_culled_table, csrc/render_table.cu) at the
     eval render's shapes (room_scene(100_000), 800x800, 16x16 tile order,
     K 32, cluster 256, tile 256, 192 candidates): the primary and first
     reflected pass launched once each, timed beside render_culled on the
     same calls, held bit for bit to the plain version on the first
     CHECK_TILES tiles and to render_culled's lanes on the tiles both walk
     whole, and on every tile with no exit (threshold 0, near 0);
 14. the tools/bench_v5.py twin at its defaults (100k room, 800x800, K 16,
     65,536 rays; its four configurations and a v6 row; v4 and v5 launch
     render_culled, v6 render_scan): then V5_CFG's passes (render_culled on
     v5's prepared lists) held bit for bit to the plain version on whole
     passes, timed against their bound;
 15. the tools/bench_vpu_dtype.py twin at its defaults (256x512, 512
     rounds, 20 calls): us per call in float32 and bf16 against the
     instruction-rate bounds, the bf16 speedup; kernel vs plain, bit for
     bit with equal infinities, at MIX_CHECK_REPS rounds and at the timed
     512;
 16. the slot sort (csrc/sort_slots.cu) vs plain on the Pallas test's
     inputs and on 655,360 x 32 slots with 5 auxiliary blocks, bit for bit;
     timed against its byte bound, with what the runtime reports of the
     compiled kernel at K 16 and 32.

Then a JSON line describing the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Every measured number also goes to
chiprun_out/chip_smoke.json.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.measure_fps import measure_fps
from editable_gaussian_reflections_tpu_torch.ops.cuda import build
from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import (
    ATTR_ROWS,
    NUM_ATTR,
    OUT_CHUNKS,
    OUT_NUMACC,
    OUT_TRAV,
    ROW_VALID,
    SLOT_BLOCKS,
    SLOT_ID,
    SLOT_T,
    TABLE_A,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
    DTYPES,
    mix,
    mix_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_fine import (
    render_culled_v5_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    render_culled,
    render_culled_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_table import (
    render_culled_table,
    render_culled_table_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
    kernel_info as sort_kernel_info,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
    sort_slots_aux,
    sort_slots_aux_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.scan_kernel import (
    kernel_info as scan_kernel_info,
    render_scan,
    render_scan_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.scatter import (
    kernel_info as scatter_kernel_info,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.scatter import (
    scatter_add,
    scatter_add_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
    BRUTE_TILE,
    kernel_info,
    trace_hits,
    trace_hits_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_slots import (
    trace_slots,
    trace_slots_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.render_grads import (
    new_grad_accumulator,
)
from editable_gaussian_reflections_tpu_torch.ops.tonemap import tonemap
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    RayTargets,
    RenderSettings,
    StepOutputs,
    TileSamples,
    draw_samples,
    draw_tile_samples,
    full_f32_matmuls,
    hit_grads,
    render_accumulated_chunked,
    render_frame,
    render_frame_fused,
    tiles_per_launch_for,
)
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.tools import (
    bench_v5,
    bench_vpu_dtype,
)
from editable_gaussian_reflections_tpu_torch.tools.fused_setup import (
    BENCH_KW,
    BENCH_SETTINGS,
    N_FPS_VIEWS,
    TRAIN_H,
    TRAIN_W,
    device_time_us,
    eval_frame,
    fast_path,
    first_two_passes,
    profile_device,
    time_frames,
    time_steps,
)
from editable_gaussian_reflections_tpu_torch.tools.fused_setup import (
    training_step as fused_training_step,
)
from editable_gaussian_reflections_tpu_torch.tools.scatter_ab import (
    sort_inputs,
)
from editable_gaussian_reflections_tpu_torch.tools.nonfused_setup import (
    FRAME_KW,
    NF_H,
    NF_RENDER_N,
    NF_W,
    TRAIN_N,
    eval_render,
    first_trace_calls,
    render_trace_calls,
    room,
    step_trace_calls,
    training_step,
)

ROOT = Path(__file__).resolve().parent
SETTINGS = RenderSettings()
KERNEL_SOURCES = ("render_culled", "trace_slots", "scatter_grads",
                  "render_scan", "trace_hits", "render_table", "bench_dtype",
                  "sort_slots")
# the roofline of one H100 SXM (NVIDIA's data sheet): FP32 and FP64 outside
# the tensor cores, HBM3
PEAK_FP32, PEAK_FP64, PEAK_BYTES = 67e12, 34e12, 3.35e12
FLOPS_PER_PAIR = 60    # ray x Gaussian pair math, counted from the source
# of which the part that does not depend on the ray's direction: rel (3), lo
# (18) and |lo|^2 (5); where a tile's rays share one origin (a primary
# pass) it is needed once per Gaussian the tile tests, not once per pair
FLOPS_ORIGIN = 26
# the scan kernel's float32 work per ray x Gaussian pair and, of it, the
# part a shared origin needs once per Gaussian (scan_flops), counted from
# csrc/render_scan.cu: direct, the k-buffer walks' group_pairs (as above);
# quadric, quadric_group - the doubled weights 3, dot_ll 11, dot_ol 17,
# dot_oo 21 and the rest 6 - of which dot_oo's 21 (prepare_cluster).  Per
# composited hit only, the opacity and the float64 sums come on top
FLOPS_SCAN = {"scan": (FLOPS_PER_PAIR, FLOPS_ORIGIN), "scanq": (58, 21)}
# the kernel-vs-plain checks of the repaired rows run on this many tiles
CHECK_TILES = 256
# the fast path's frame and scene (bench.py's): 800x800, room_scene(100_000);
# its configurations are tools/fused_setup.py's (BENCH_KW, fast_path)
FAST_SIZE, FAST_N = 800, 100_000
# the training step's configuration (tools/fused_setup.py): the Config
# defaults train.py uses
N_TIMED_STEPS = 3
# the non-fused path: its frame, scenes and configurations are
# tools/nonfused_setup.py's
N_TIMED_NF_STEPS = 2
# trace_hits vs its plain version runs on this many 256-ray blocks
NF_CHECK_TILES = 16
# tools/bench_v5.py's defaults (scene, frame side, rays), and a v6 row
# beside its configurations
BENCH_V5_N, BENCH_V5_RES, BENCH_V5_RAYS = 100_000, 800, 65536
BENCH_V5_CONFIGS = bench_v5.DEFAULT_CONFIGS.split(",") + ["v6:64:128:128:256"]
BENCH_V5_ITERS = 10
# the v5 configuration whose passes are held against the plain version
V5_CFG = "v5:64:128:128:256"
# the op mix's instruction rates on one H100 SXM: the clock implied by the FP32
# peak (132 SMs x 128 lanes x 2 flops), 128 FP32 lanes (packed bf16 runs on
# the same pipe) and 16 MUFU lanes per SM and clock (Hopper white paper)
SMS = 132
CLOCK_HZ = PEAK_FP32 / (SMS * 128 * 2)
FP32_LANES_S, MUFU_LANES_S = SMS * 128 * CLOCK_HZ, SMS * 16 * CLOCK_HZ
# instructions per element and round on the FP32 pipe (bench_dtype.cu)
MIX_FP32_INSTR = {"f32": 10.0, "bf16": 5.5}
MIX_CHECK_REPS = 16
# tools/bench_vpu_dtype.py's defaults: rows, cols, rounds, timed calls
MIX_SHAPE, MIX_REPS, MIX_ITERS = (256, 512), 512, 20
# the slot sort's large case: the eval render's rays, K 32, the Pallas
# test's 5 auxiliary blocks
SORT_RAYS, SORT_K, SORT_AUX = 655_360, 32, 5


def first_tiles(call, n_tiles: int, ray_pos=(0, 1), cand_pos=(3, 4)):
    """(args, kwargs) of a kernel call cut to its first `n_tiles` ray
    tiles: the kernels treat tiles independently, so the rows of the cut
    call equal the first rows of the whole one."""
    rows = n_tiles * call.kwargs["tile"]
    args = list(call.args)
    for i in ray_pos:
        args[i] = args[i][:rows]
    for i in cand_pos:
        args[i] = args[i][:n_tiles]
    kwargs = dict(call.kwargs)
    for k in ("alive", "t_split"):
        if kwargs.get(k) is not None:
            kwargs[k] = kwargs[k][:rows]
    return args, kwargs, rows


def psnr_tonemapped(a, b, mask=None) -> float:
    """PSNR in dB of two HDR images after the filmic tonemap, in [0, 1];
    over the pixels where `mask` holds, when given."""
    ta, tb = (torch.clamp(tonemap(x.float()), 0.0, 1.0) for x in (a, b))
    if mask is not None:
        ta, tb = ta[mask], tb[mask]
    mse = ((ta - tb) ** 2).mean().item()
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def compare_lanes(out, ref) -> dict:
    """Float lanes against rtol 1e-4 / atol 1e-4*scale; counter lanes
    (accumulated, traversed, chunks) per ray."""
    f = slice(0, OUT_NUMACC)
    scale = max(1.0, ref[:, f].abs().max().item())
    err = (out[:, f] - ref[:, f]).abs()
    ok = err <= 1e-4 * ref[:, f].abs() + 1e-4 * scale
    same = (out[:, OUT_NUMACC:] == ref[:, OUT_NUMACC:]).all(dim=1)
    return dict(max_abs_err=err.max().item(), float_ok=bool(ok.all()),
                counters_equal=same.float().mean().item(),
                bit_equal=(out == ref).all(dim=1).float().mean().item(),
                finite=bool(torch.isfinite(out).all()))


def differing_lanes(out, ref) -> list:
    """The first rays (at most 10) whose output lanes are not the plain
    version's bit for bit, each with its lanes on both sides."""
    rows = torch.nonzero((out != ref).any(dim=1)).flatten()[:10].tolist()
    return [f"ray {i}: kernel {out[i].tolist()}, plain {ref[i].tolist()}"
            for i in rows]


def check_lanes(where: str, cmp: dict) -> None:
    if not (cmp["float_ok"] and cmp["finite"]
            and cmp["counters_equal"] >= 0.999):
        raise RuntimeError(f"{where}: kernel disagrees with its plain "
                           f"version: {cmp}")


def mismatch(a, b) -> float:
    scale = max(1.0, b.abs().max().item())
    ok = (a - b).abs() <= 2e-4 * b.abs() + 2e-5 * scale
    return 1.0 - ok.float().mean().item()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops: float, peak_flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the operation time at the peak
    rate and the byte time at the memory rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def walk_flops(rays_o, pairs_per_ray, tile: int, per_pair=FLOPS_PER_PAIR,
               origin=FLOPS_ORIGIN) -> float:
    """The float32 flops the k-buffer pair math needs on one pass, per tile
    of `tile` rays (the kernels' blocks; a last partial tile is counted on
    its rays alone): where the tile's origins differ, `per_pair` per pair;
    where they are one, bit for bit (the test the walks make), per_pair -
    origin per pair and `origin` per Gaussian the tile tests (its largest
    per-ray count)."""
    o = rays_o.to(torch.float32).contiguous().view(torch.int32)
    pairs = pairs_per_ray.to(torch.float64).reshape(-1)
    pad = -o.shape[0] % tile
    if pad:  # copies of the last ray that test nothing
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        pairs = torch.cat([pairs, pairs.new_zeros(pad)])
    o, pairs = o.view(-1, tile, 3), pairs.view(-1, tile)
    shared = (o == o[:, :1]).all(dim=2).all(dim=1)
    per_tile = pairs.sum(dim=1)
    flops = torch.where(
        shared, (per_pair - origin) * per_tile
        + origin * pairs.max(dim=1).values, per_pair * per_tile)
    return flops.sum().item()


def scan_flops(rays_o, pairs_per_ray, tile: int, mode: str) -> float:
    """walk_flops for the scan kernel's pair math in `mode` (FLOPS_SCAN):
    its blocks make the same shared-origin test."""
    per_pair, origin = FLOPS_SCAN[mode]
    return walk_flops(rays_o, pairs_per_ray, tile, per_pair, origin)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def compare_slots(slots, acc, ref_slots, ref_acc, K) -> dict:
    """Slots against the plain version's: ids and counters per ray (the
    share of rays where they are equal; phase 5 requires all, and lists
    the others, `differ`), and on the rays where they are equal each
    float block (t, alpha, each attribute and frame field) to rtol 1e-4 /
    atol 1e-4*scale with the scale of that block alone, as the CPU test
    takes it, and log-T likewise; empty slots are INF on both sides."""
    s = slots.reshape(-1, SLOT_BLOCKS, K)
    r = ref_slots.reshape(-1, SLOT_BLOCKS, K)
    same = ((s[:, SLOT_ID] == r[:, SLOT_ID]).all(dim=1)
            & (acc[:, 1:3] == ref_acc[:, 1:3]).all(dim=1))
    differ = [show_ray(i, s[i, SLOT_T], r[i, SLOT_T], s[i, SLOT_ID],
                       r[i, SLOT_ID])
              for i in torch.nonzero(~same).flatten()[:10].tolist()]
    if not bool(same.any()):
        return dict(max_abs_err=math.inf, float_ok=False, counters_equal=0.0,
                    finite=bool(torch.isfinite(acc).all()), differ=differ)
    a, b, acc, ref_acc = s[same], r[same], acc[same], ref_acc[same]
    valid = b[:, SLOT_T] < 1e37
    a[:, SLOT_T] = torch.where(valid, a[:, SLOT_T], 0.0)
    b[:, SLOT_T] = torch.where(valid, b[:, SLOT_T], 0.0)
    scale = b.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1.0)
    err = (a - b).abs()
    ok = bool((err <= 1e-4 * b.abs() + 1e-4 * scale).all()
              and (acc[:, 0] - ref_acc[:, 0]).abs().max().item()
              <= 1e-4 * max(1.0, ref_acc[:, 0].abs().max().item()))
    return dict(max_abs_err=max(err.max().item(),
                                (acc - ref_acc).abs().max().item()),
                float_ok=ok, counters_equal=same.float().mean().item(),
                finite=bool(torch.isfinite(acc).all()), differ=differ)


def show_ray(i: int, t, ref_t, ids, ref_ids) -> str:
    """Where a ray's kept ids differ from the plain version's (as
    tools/slot_ties.py shows them): the slots, their depths and both ids,
    and whether both keep the same depths bit for bit (an exact tie)."""
    other = ids != ref_ids
    tie = bool(torch.equal(t, ref_t))
    return (f"ray {i}: slots {torch.nonzero(other).flatten().tolist()} at t "
            f"{t[other].tolist()}: kernel ids {ids[other].int().tolist()}, "
            f"plain ids {ref_ids[other].int().tolist()}; same depths: {tie}")


def print_differing(where: str, cmp: dict) -> None:
    for line in cmp.get("differ", []):
        print(f"{where}: {line}", flush=True)


def states_equal(a, b) -> list:
    """Fields where two TrainStates differ."""
    diff = []
    for tree in ("scene", "mu", "nu"):
        for f in tr.PARAM_FIELDS:
            if not torch.equal(getattr(getattr(a, tree), f).cpu(),
                               getattr(getattr(b, tree), f).cpu()):
                diff.append(f"{tree}.{f}")
    if not torch.equal(a.total_weight.cpu(), b.total_weight.cpu()):
        diff.append("total_weight")
    return diff


def state_finite(state) -> bool:
    return all(bool(torch.isfinite(getattr(t, f)).all())
               for t in (state.scene, state.mu, state.nu)
               for f in tr.PARAM_FIELDS) and bool(
        torch.isfinite(state.total_weight).all())


def scan_pass_numbers(calls, mode: str, compare: bool) -> dict:
    """The scan kernel on a frame's primary and first reflected pass: ms
    per pass (CUDA events), the pairs it tests (a counters-on run: lane 14),
    its bound and no-FMA issue floor (scan_flops: the ray-independent terms
    once per Gaussian on blocks of one origin), and - with `compare` - its
    plain version on the whole pass, held to the kernel."""
    res = {}
    for name, call in zip(("primary", "reflected"), calls):
        ms = cuda_ms(lambda: render_scan(*call.args, **call.kwargs), reps=5)
        counted = render_scan(*call.args, **dict(call.kwargs, stats=True))
        pairs = counted[:, OUT_TRAV].sum().item()
        flops = scan_flops(call.args[0], counted[:, OUT_TRAV],
                           call.kwargs["tile"], mode)
        b_ms, b_by = bound(
            flops, PEAK_FP32,
            nbytes(call.args[0], call.args[1], call.args[2].table,
                   call.args[3], call.kwargs["alive"], counted))
        res.update({f"{name}_ms": ms, f"{name}_pairs": pairs,
                    f"{name}_flops": flops,
                    f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by,
                    f"{name}_floor_ms": flops / FP32_LANES_S * 1e3,
                    f"{name}_rays": call.args[0].shape[0]})
        if compare:
            out = render_scan(*call.args, **call.kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = render_scan_reference(*call.args, **call.kwargs,
                                        tiles_per_batch=512)
            torch.cuda.synchronize()
            res[f"{name}_plain_ms"] = (time.perf_counter() - t0) * 1e3
            cmp = compare_lanes(out, ref)
            check_lanes(f"render_scan {mode} {name}", cmp)
            res[f"{name}_compare"] = cmp
            del out, ref
        del counted
    return res


def phase_scan_small(dev, record) -> None:
    """Phase 8: render_scan vs its plain version at 128x128, every variant;
    a 64x64 frame in each scan mode on cuda and on cpu."""
    scene, camera = room(16384, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    samples = draw_samples(gen, 128, 128, 3)
    res = {}
    for mode, cluster in (("scan", 128), ("scanq", 64)):
        kw = dict(FRAME_KW, cull_cluster=cluster, max_clusters=64,
                  max_clusters_secondary=128, composite_mode=mode)
        for name, call in zip(("primary", "reflected"), first_two_passes(
                scene, camera, 128, 128, samples, kw)):
            for stats in (True, False):
                for ap in (("highest", "bf16") if mode == "scanq"
                           else ("highest",)):
                    ckw = dict(call.kwargs, stats=stats, attr_precision=ap)
                    out = render_scan(*call.args, **ckw)
                    torch.cuda.synchronize()
                    ref = render_scan_reference(*call.args, **ckw)
                    key = f"{mode} {name} stats={stats} {ap}"
                    res[key] = compare_lanes(out, ref)
                    check_lanes(f"phase 8 {key}", res[key])
    worst = max(v["max_abs_err"] for v in res.values())
    agree = min(v["counters_equal"] for v in res.values())
    print(f"phase 8: render_scan vs plain at 128x128, room_scene(16384), "
          f"{len(res)} variants (scan/scanq, primary/reflected, counters "
          f"on/off, bf16): worst max_abs_err {worst:.3g}, counters equal on "
          f">= {agree:.4%} of rays", flush=True)

    scene_c, camera_c = room(16384, "cpu")
    samples = draw_samples(torch.Generator().manual_seed(1), 64, 64, 3)
    frames = {}
    for mode in ("scan", "scanq"):
        kw = dict(FRAME_KW, cull_cluster=128, composite_mode=mode,
                  kernel_stats=mode == "scan")
        on_dev = render_frame_fused(
            scene, camera, SETTINGS, None, 64, 64, num_bounces=2,
            samples=type(samples)(samples.jitter.to(dev),
                                  samples.us.to(dev)), **kw)
        on_cpu = render_frame_fused(scene_c, camera_c, SETTINGS, None, 64,
                                    64, num_bounces=2, samples=samples, **kw)
        differ = [f for f, a, b in zip(StepOutputs._fields + ("final",),
                                       (*on_dev[0], on_dev[1]),
                                       (*on_cpu[0], on_cpu[1]))
                  if not torch.equal(a.cpu(), b)]
        if differ or not torch.isfinite(on_dev[1]).all():
            raise RuntimeError(f"phase 8: {mode} frame on cuda and cpu "
                               f"differ in {differ}")
        frames[mode] = "equal"
    record.update(phase8_kernel_vs_plain=res, phase8_frames=frames)
    print("phase 8: 64x64 2-bounce scan and scanq frames, cuda vs cpu: "
          "every output equal", flush=True)
    info = scan_info((("scan c128 counters", "scan", True, "highest", 128),
                      ("scanq c64 bf16", "scanq", False, "bf16", 64)))
    record["phase8_scan_kernel"] = info
    print_kernel_info("phase 8", "render_scan", info, "tile 256")


def phase_fast_path(dev, record, smi) -> dict:
    """Phase 9: the inference fast path at full width.  Returns the
    numbers the kernels line takes."""
    fp = fast_path(dev, str(ROOT / "chiprun_out" / "fps_model"))
    W, H, scene, camera, gen = fp.W, fp.H, fp.scene, fp.camera, fp.gen
    samples = fp.samples
    res = {"bench": {}, "fps": {}}

    # (a) bench.py's configuration: per-pass kernel numbers for both pair
    # maths, then the frames
    for mode in ("scanq", "scan"):
        res["bench"][mode] = scan_pass_numbers(fp.calls[f"bench {mode}"],
                                               mode, compare=True)
    frame_kw = dict(num_bounces=2, **BENCH_KW)
    frames = {}
    for mode in ("scanq", "scan", "kbuffer"):
        kw = dict(frame_kw, composite_mode=mode)
        if mode != "scanq":
            kw["attr_precision"] = "highest"
        dispatch_render_frame(scene, camera, BENCH_SETTINGS, gen, W, H,
                              **kw)                             # warm-up
        torch.cuda.synchronize()
        render_scan.launches = render_culled.launches = 0
        n_timed = 3
        t0 = time.perf_counter()
        for _ in range(n_timed):
            steps, final = dispatch_render_frame(scene, camera,
                                                 BENCH_SETTINGS, gen, W, H,
                                                 **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_timed * 1e3
        launches = (render_scan.launches, render_culled.launches)
        expected = ((3 * n_timed, 0) if mode != "kbuffer"
                    else (0, 3 * n_timed))
        if launches != expected:
            raise RuntimeError(f"phase 9a {mode}: render_scan/render_culled "
                               f"launched {launches}, expected {expected}")
        if not (torch.isfinite(final).all() and final.mean().item() > 0.0):
            raise RuntimeError(f"phase 9a {mode}: bad final image")
        same = dispatch_render_frame(scene, camera, BENCH_SETTINGS, None, W,
                                     H, samples=samples, **kw)[1]
        frames[mode] = dict(ms=ms, fps=1e3 / ms, launches=launches,
                            frame_mrays_s=W * H / ms / 1e3,
                            starved=steps.overflow.mean().item(),
                            final=same)
    for mode in ("scanq", "scan"):
        frames[mode]["psnr_vs_kbuffer_db"] = psnr_tonemapped(
            frames[mode]["final"], frames["kbuffer"]["final"])
    kw = dict(frame_kw, composite_mode="scanq")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch_render_frame(scene, camera, BENCH_SETTINGS, gen, W, H, **kw)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            by_kernel[e.key] = device_time_us(e) / 1e3
    device_ms = sum(by_kernel.values())
    scan_ms = sum(v for k, v in by_kernel.items()
                  if "render_scan_kernel" in k)
    for f in frames.values():
        del f["final"]
    res["bench"]["frames"] = frames
    res["bench"].update(
        profiled_frame_ms=prof_ms, profiled_device_ms=device_ms,
        profiled_scan_kernel_ms=scan_ms,
        device_idle_share=(max(0.0, 1 - device_ms / prof_ms)
                           if device_ms > 0 else None),
        profiled_top_device_ms=sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1])[:12])
    b, q = res["bench"], frames["scanq"]
    idle = ("device idle ~" + f"{b['device_idle_share']:.1%}"
            if device_ms > 0 else "device time not measured")
    print(f"phase 9a: {W}x{H}, room_scene({FAST_N}), 2 bounces, bench.py's "
          f"configuration (scanq, K 16, cluster 128, 128/768 candidates, "
          f"counters off, bf16): {q['ms']:.1f} ms/frame, {q['fps']:.2f} FPS, "
          f"{q['frame_mrays_s']:.3f} M frame rays/s, starved "
          f"{q['starved']:.4%}; render_scan {scan_ms:.1f} of "
          f"{device_ms:.1f} ms device time, {idle} [{smi}]", flush=True)
    for mode in ("scanq", "scan"):
        n = b[mode]
        print(f"phase 9a: render_scan {mode} per pass: primary "
              f"{n['primary_ms']:.3f} ms ({n['primary_pairs']:.4g} pairs, "
              f"bound {n['primary_bound_ms']:.3f} ms by "
              f"{n['primary_bound_by']}, no-FMA floor "
              f"{n['primary_floor_ms']:.3f} ms), reflected "
              f"{n['reflected_ms']:.3f} ms ({n['reflected_pairs']:.4g} "
              f"pairs, bound {n['reflected_bound_ms']:.3f} ms, floor "
              f"{n['reflected_floor_ms']:.3f} ms)"
              + (f"; plain {n['primary_plain_ms']:.1f} / "
                 f"{n['reflected_plain_ms']:.1f} ms, max_abs_err "
                 f"{n['primary_compare']['max_abs_err']:.3g} / "
                 f"{n['reflected_compare']['max_abs_err']:.3g}"
                 if "primary_compare" in n else ""), flush=True)
    print(f"phase 9a: frames: scanq {q['ms']:.1f} ms, scan "
          f"{frames['scan']['ms']:.1f} ms, kbuffer "
          f"{frames['kbuffer']['ms']:.1f} ms; tonemapped PSNR vs the "
          f"k-buffer frame: scanq {q['psnr_vs_kbuffer_db']:.2f} dB, scan "
          f"{frames['scan']['psnr_vs_kbuffer_db']:.2f} dB [{smi}]",
          flush=True)
    res["bench_kernel"] = info = scan_info((
        ("scanq c128 bf16", "scanq", False, "bf16", 128),
        ("scan c128", "scan", False, "highest", 128)))
    print_kernel_info("phase 9a", "render_scan", info, "tile 256")

    # (b) measure_fps at the Config defaults
    cfg = fp.cfg
    Path(cfg.model_path).mkdir(parents=True, exist_ok=True)
    res["fps"]["scanq"] = scan_pass_numbers(fp.calls["fps scanq"], "scanq",
                                            compare=True)
    fp.calls = None
    render_scan.launches = render_culled.launches = 0
    fps = measure_fps(cfg, fp.views, scene, fp.settings)
    launches = (render_scan.launches, render_culled.launches)
    expected = (2 * N_FPS_VIEWS * 3, 0)
    if launches != expected:
        raise RuntimeError(f"phase 9b: render_scan/render_culled launched "
                           f"{launches}, expected {expected}")
    res["fps_launches"] = launches[0]
    res["fps"].update(fps=fps, ms_per_frame=1e3 / fps,
                      frame_mrays_s=W * H * fps / 1e6)
    n = res["fps"]["scanq"]
    print(f"phase 9b: measure_fps() at the Config defaults (scanq, K 32, "
          f"cluster 256, 192 candidates, counters off), {N_FPS_VIEWS} views "
          f"at {W}x{H}: {fps:.2f} FPS ({1e3 / fps:.1f} ms/frame); "
          f"render_scan launches {launches[0]}; per pass: primary "
          f"{n['primary_ms']:.3f} ms (bound {n['primary_bound_ms']:.3f} ms "
          f"by {n['primary_bound_by']}, no-FMA floor "
          f"{n['primary_floor_ms']:.3f} ms, plain "
          f"{n['primary_plain_ms']:.1f} ms, max_abs_err "
          f"{n['primary_compare']['max_abs_err']:.3g}), reflected "
          f"{n['reflected_ms']:.3f} ms (bound "
          f"{n['reflected_bound_ms']:.3f} ms by {n['reflected_bound_by']}, "
          f"floor {n['reflected_floor_ms']:.3f} ms, plain "
          f"{n['reflected_plain_ms']:.1f} ms, max_abs_err "
          f"{n['reflected_compare']['max_abs_err']:.3g}) [{smi}]",
          flush=True)
    res["fps_kernel"] = info = scan_info((
        ("scanq c256", "scanq", False, "highest", 256),))
    print_kernel_info("phase 9b", "render_scan", info, "tile 256")
    res["max_abs_err"] = max(
        r[f"{p}_compare"]["max_abs_err"]
        for r in (res["fps"]["scanq"], res["bench"]["scanq"])
        for p in ("primary", "reflected"))
    record["phase9_fast_path"] = res
    return res


def hits_subset(args, kwargs, n_tiles: int):
    """A trace_hits call cut to its first `n_tiles` 256-ray blocks (cull
    tiles when culled): the rays of a block are traced independently of
    every other block, so the cut call's rows equal the first rows of the
    whole one."""
    rows = n_tiles * 256
    args = list(args)
    args[0], args[1] = args[0][:rows], args[1][:rows]
    if args[3] is not None:
        args[3], args[4] = args[3][:n_tiles], args[4][:n_tiles]
    return args, kwargs, rows


def compare_hits(out, ref) -> dict:
    """trace_hits' outputs against its plain version's (both without the
    attributes): ids and traversed counts per ray (the share of rays equal;
    the others listed, `differ`); on the rays where they are, t (empty
    slots as 0),
    alpha, gaussval, local hit and log T to rtol 1e-4 / atol 1e-4*scale,
    each with its own scale."""
    t, ids, alpha, gv, lh, log_t, trav = out
    rt_, rids, ralpha, rgv, rlh, rlog_t, rtrav = ref
    same = (ids == rids).all(dim=1) & (trav == rtrav)
    differ = [show_ray(i, t[i], rt_[i], ids[i], rids[i])
              for i in torch.nonzero(~same).flatten()[:10].tolist()]
    finite = all(bool(torch.isfinite(x).all()) for x in (alpha, gv, lh,
                                                         log_t))
    if not bool(same.any()):
        return dict(max_abs_err=math.inf, float_ok=False, counters_equal=0.0,
                    finite=finite, differ=differ)
    pairs = ((torch.where(t < 1e37, t, 0.0), torch.where(rt_ < 1e37, rt_,
                                                         0.0)),
             (alpha, ralpha), (gv, rgv), (lh, rlh), (log_t, rlog_t))
    worst, ok = 0.0, True
    for a, b in pairs:
        a, b = a[same], b[same]
        scale = max(1.0, b.abs().max().item())
        err = (a - b).abs()
        worst = max(worst, err.max().item())
        ok = ok and bool((err <= 1e-4 * b.abs() + 1e-4 * scale).all())
    return dict(max_abs_err=worst, float_ok=ok,
                counters_equal=same.float().mean().item(), finite=finite,
                differ=differ)


def trace_pass_numbers(calls, where: str) -> dict:
    """trace_hits on recorded launches (the primary and first reflected
    pass of the first batch of tiles): ms per launch (CUDA events), the
    pairs it tests (traversed, summed over its rays), its bound, and its
    plain version on the first NF_CHECK_TILES blocks, held to the
    kernel."""
    res = {}
    for name, (args, kwargs) in zip(("primary", "reflected"), calls):
        ms = cuda_ms(lambda: trace_hits(*args, **kwargs), reps=3)
        out = trace_hits(*args, **kwargs)
        out = out[:5] + out[6:]
        pairs = out[6].to(torch.float64).sum().item()
        tile = BRUTE_TILE if args[3] is None else kwargs["tile"]
        flops = walk_flops(args[0], out[6], tile)
        b_ms, b_by = bound(flops, PEAK_FP32,
                           nbytes(*args[:5], *out)
                           + 4 * args[0].shape[0])       # the alive mask
        # built without FMA contraction, each of the pair's flops issues on
        # its own: the FP32 pipe's floor is twice the flop bound
        floor_ms = flops / FP32_LANES_S * 1e3
        sub_args, sub_kw, rows = hits_subset(args, kwargs, NF_CHECK_TILES)
        plain_kw = {k: v for k, v in sub_kw.items() if k != "extract_attrs"}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = trace_hits_reference(*sub_args, **plain_kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = compare_hits(tuple(x[:rows] for x in out), ref)
        print_differing(f"{where} trace_hits {name}", cmp)
        check_lanes(f"{where} trace_hits {name}", cmp)
        res[name] = dict(cmp, ms=ms, pairs=pairs, flops=flops, bound_ms=b_ms,
                         bound_by=b_by, floor_ms=floor_ms,
                         rays=args[0].shape[0],
                         plain_ms=plain_ms, plain_rays=rows,
                         mode="brute" if args[3] is None else "culled")
        del out, ref
    return res


def phase_trace_small(dev, record) -> None:
    """Phase 10: trace_hits vs its plain version at 128x128,
    room_scene(16384), on the renderer's own passes."""
    scene, camera = room(16384, dev)
    W = H = 128
    samples = draw_tile_samples(torch.Generator(device=dev).manual_seed(7),
                                W, H, 8192, 2)
    res = {}
    for culled in (False, True):
        mode = "culled" if culled else "brute"
        calls = first_trace_calls(lambda: render_frame(
            scene, camera, SETTINGS, None, W, H, num_bounces=1,
            use_culling=culled, samples=samples, **FRAME_KW))
        for name, (args, kwargs) in zip(("primary", "reflected"), calls):
            out = trace_hits(*args, **kwargs)
            torch.cuda.synchronize()
            plain_kw = {k: v for k, v in kwargs.items()
                        if k != "extract_attrs"}
            ref = trace_hits_reference(*args, **plain_kw)
            res[f"{mode} {name}"] = compare_hits(out[:5] + out[6:], ref)
            check_lanes(f"phase 10 {mode} {name}", res[f"{mode} {name}"])
        if not culled:
            # a ragged brute ray count: padded to the block, padding dropped
            args, kwargs = calls[0]
            args = (args[0][:1000], args[1][:1000], *args[2:])
            out = trace_hits(*args, **kwargs)
            ref = trace_hits_reference(*args, **{
                k: v for k, v in kwargs.items() if k != "extract_attrs"})
            res["brute ragged 1000 rays"] = compare_hits(out[:5] + out[6:],
                                                         ref)
            check_lanes("phase 10 brute ragged", res["brute ragged 1000 rays"])
    worst = max(v["max_abs_err"] for v in res.values())
    agree = min(v["counters_equal"] for v in res.values())
    record["phase10_kernel_vs_plain"] = res
    print(f"phase 10: trace_hits vs plain at 128x128, room_scene(16384), "
          f"K=32, {len(res)} passes (brute/culled, primary/reflected, a "
          f"ragged brute count): worst max_abs_err {worst:.3g}, ids and "
          f"counters equal on >= {agree:.4%} of rays", flush=True)
    # what the runtime reports of the kernels the main paths launch (exp
    # power 3, 256-ray blocks, 256-Gaussian clusters; primary passes, and
    # reflected ones with the backfacing test)
    record["trace_hits_kernel"] = info = walk_kernel_info("trace_hits")
    print_kernel_info("phase 10", "trace_hits", info)


def walk_kernel_info(kernel: str, exit_modes=(0,)) -> dict:
    """What the runtime reports of a kernel on the k-buffer walk
    (kernel_info) as the main paths launch it: exp power 3, 256-ray blocks,
    256-Gaussian clusters, K 16 and 32, primary passes and reflected ones
    (the backfacing test), each exit mode."""
    return {f"K{k} {name}" + (f" exit {m}" if len(exit_modes) > 1 else ""):
            kernel_info(k, backfacing=name == "reflected", kernel=kernel,
                        exit_mode=m)
            for k in (16, 32) for name in ("primary", "reflected")
            for m in exit_modes}


def scan_info(configs) -> dict:
    """What the runtime reports of the scan kernel (render_scan's
    kernel_info) for each (name, pair math, counters, attribute precision,
    cluster) of `configs`, on primary passes and on reflected ones (the
    backfacing test), at exp power 3 and 256-ray blocks."""
    return {f"{name} {p}": scan_kernel_info(
        "direct" if mode == "scan" else "quadric", stats, ap, True,
        p == "reflected", 256, cluster)
        for name, mode, stats, ap, cluster in configs
        for p in ("primary", "reflected")}


def print_kernel_info(where: str, kernel: str, info: dict,
                      at: str = "tile 256, cluster 256") -> None:
    print(f"{where}: {kernel} kernel at {at}: " + "; ".join(
        f"{k}: {v['registers']} registers, {v['local_bytes']} B spilled, "
        f"{v['smem_bytes']} B shared, {v['blocks_per_sm']} blocks per SM"
        for k, v in info.items()), flush=True)


def phase_nonfused_render(dev, record, smi) -> dict:
    """Phase 11: the non-fused eval render at full width (culled)."""
    W, H = NF_W, NF_H
    r = eval_render(dev)
    scene, camera, gen, samples, kw = r.scene, r.camera, r.gen, r.samples, r.kw
    T = -(-(W * H) // r.tile)
    n_batches = -(-T // tiles_per_launch_for(T, r.tile, 3,
                                              FRAME_KW["max_hits"], dev))
    calls = render_trace_calls(r)
    passes = trace_pass_numbers(calls, "phase 11")
    if passes["primary"]["mode"] != "culled":
        raise RuntimeError("phase 11: the frame was not traced culled")
    del calls

    dispatch_render_frame(scene, camera, SETTINGS, gen, W, H, **kw)  # warm-up
    torch.cuda.synchronize()
    trace_hits.launches = render_culled.launches = 0
    n_timed = 3
    t0 = time.perf_counter()
    for _ in range(n_timed):
        steps, final = dispatch_render_frame(scene, camera, SETTINGS, gen, W,
                                             H, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = (trace_hits.launches, render_culled.launches)
    expected = (n_timed * n_batches * 3, 0)
    if launches != expected:
        raise RuntimeError(f"phase 11: trace_hits/render_culled launched "
                           f"{launches}, expected {expected}")
    if not (tuple(final.shape) == (W * H, 3) and torch.isfinite(final).all()
            and all(torch.isfinite(a).all() for a in steps)
            and final.mean().item() > 0.0):
        raise RuntimeError("phase 11: bad frame")
    starved = steps.overflow.mean().item()
    host_ms, by_kernel, _ = profile_device(lambda: dispatch_render_frame(
        scene, camera, SETTINGS, gen, W, H, **kw))
    device_ms = sum(by_kernel.values())
    kernel_ms = sum(v for k, v in by_kernel.items()
                    if "trace_hits_kernel" in k)
    c_steps, culled = dispatch_render_frame(scene, camera, SETTINGS, None, W,
                                            H, samples=samples, **kw)
    brute = render_frame(scene, camera, SETTINGS, None, W, H,
                         samples=samples, use_culling=False, **kw)[1]
    psnr = psnr_tonemapped(culled, brute)
    # the same over the pixels no bounce of which was starved: what is left
    # once the dropped candidates are set aside
    unstarved = c_steps.overflow.sum(dim=0) == 0
    psnr_unstarved = psnr_tonemapped(culled, brute, unstarved)
    starved_by_bounce = c_steps.overflow.mean(dim=1).tolist()
    res = dict(ms=ms, frame_mrays_s=W * H / ms / 1e3, starved=starved,
               launches=launches[0], batches=n_batches, passes=passes,
               profiled_frame_ms=host_ms, profiled_device_ms=device_ms,
               profiled_trace_hits_ms=kernel_ms,
               device_idle_share=(max(0.0, 1 - device_ms / host_ms)
                                  if device_ms > 0 else None),
               profiled_top_device_ms=sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1])[:12],
               psnr_vs_brute_db=psnr, psnr_unstarved_db=psnr_unstarved,
               unstarved_pixels=unstarved.float().mean().item(),
               starved_by_bounce=starved_by_bounce)
    record["phase11_nonfused_render"] = res
    idle = (f"device idle ~{res['device_idle_share']:.1%}" if device_ms > 0
            else "device time not measured")
    p, r = passes["primary"], passes["reflected"]
    print(f"phase 11: non-fused eval render {W}x{H}, room_scene("
          f"{NF_RENDER_N}), 2 bounces, K 32, cluster 256, 192 candidates, "
          f"culled in linear ray order: {ms:.1f} ms/frame, "
          f"{W * H / ms / 1e3:.3f} M frame rays/s, starved {starved:.4%}; "
          f"trace_hits {kernel_ms:.1f} of {device_ms:.1f} ms device time, "
          f"{idle}; launches {launches[0]} ({n_batches} batch(es) per "
          f"bounce); tonemapped PSNR vs the brute frame {psnr:.2f} dB, "
          f"{psnr_unstarved:.2f} dB over the "
          f"{res['unstarved_pixels']:.2%} of pixels starved at no bounce "
          f"(starved per bounce "
          f"{', '.join(f'{x:.2%}' for x in starved_by_bounce)}) [{smi}]",
          flush=True)
    print(f"phase 11: trace_hits culled, first launch ({p['rays']} rays) "
          f"per pass: primary {p['ms']:.3f} ms "
          f"({p['pairs']:.4g} pairs, bound {p['bound_ms']:.3f} ms by "
          f"{p['bound_by']}, no-FMA issue floor {p['floor_ms']:.3f} ms), "
          f"reflected {r['ms']:.3f} ms ({r['pairs']:.4g} pairs, bound "
          f"{r['bound_ms']:.3f} ms, floor {r['floor_ms']:.3f} ms); plain on "
          f"the first "
          f"{NF_CHECK_TILES} cull tiles {p['plain_ms']:.1f} / "
          f"{r['plain_ms']:.1f} ms, max_abs_err {p['max_abs_err']:.3g} / "
          f"{r['max_abs_err']:.3g}, ids+counters equal on "
          f"{min(p['counters_equal'], r['counters_equal']):.4%} [{smi}]",
          flush=True)
    return res


def phase_nonfused_step(dev, record, smi) -> dict:
    """Phase 12: the non-fused (brute) training step at full width."""
    W, H = NF_W, NF_H
    s = training_step(dev)
    num_bounces, K, tile, cap = s.num_bounces, s.K, s.tile, s.capacity
    state, step = s.state, s.step
    if s.use_culling:
        raise RuntimeError(f"phase 12: tile {tile} culls; expected brute")
    n_tiles = W * H // tile
    n_batches = -(-n_tiles // tiles_per_launch_for(n_tiles, tile,
                                                    num_bounces + 1, K, dev))
    calls = step_trace_calls(s)
    passes = trace_pass_numbers(calls, "phase 12")
    if passes["primary"]["mode"] != "brute":
        raise RuntimeError("phase 12: the step was not traced brute")
    del calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, _m = step(state)                                         # warm-up
    torch.cuda.synchronize()
    trace_hits.launches = scatter_add.launches = trace_slots.launches = 0
    l1s = []
    t0 = time.perf_counter()
    for _ in range(N_TIMED_NF_STEPS):
        st, m = step(st)
        l1s.append(m["l1_diffuse"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / N_TIMED_NF_STEPS * 1e3
    launches = (trace_hits.launches, scatter_add.launches,
                trace_slots.launches)
    expected = (N_TIMED_NF_STEPS * n_batches * (num_bounces + 1),
                N_TIMED_NF_STEPS * n_batches, 0)
    if launches != expected:
        raise RuntimeError(f"phase 12: trace_hits/scatter_grads/trace_slots "
                           f"launched {launches}, expected {expected}")
    l1s = [x.item() for x in l1s]
    if not (all(map(math.isfinite, l1s)) and state_finite(st)):
        raise RuntimeError(f"phase 12: non-finite step: l1 {l1s}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms, by_kernel, _ = profile_device(lambda: step(st))
    device_ms = sum(by_kernel.values())
    kernel_ms = sum(v for k, v in by_kernel.items()
                    if "trace_hits_kernel" in k)
    rays = W * H
    res = dict(step_ms=step_ms, step_mrays_s=rays / step_ms / 1e3,
               l1_diffuse=l1s, peak_gb=peak_gb, launches=launches[0],
               launches_scatter=launches[1], batches=n_batches, tile=tile,
               passes=passes, profiled_step_ms=host_ms,
               profiled_device_ms=device_ms,
               profiled_trace_hits_ms=kernel_ms,
               device_idle_share=(max(0.0, 1 - device_ms / host_ms)
                                  if device_ms > 0 else None),
               profiled_top_device_ms=sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1])[:12])
    record["phase12_nonfused_step"] = res
    idle = (f"device idle ~{res['device_idle_share']:.1%}" if device_ms > 0
            else "device time not measured")
    p, r = passes["primary"], passes["reflected"]
    print(f"phase 12: non-fused training step {W}x{H} (tile {tile}, "
          f"use_culling=False), room_scene({TRAIN_N}) (capacity {cap}), 2 "
          f"bounces, K={K}, {n_tiles} tiles in {n_batches} batch(es): "
          f"{step_ms:.1f} ms/step, {rays / step_ms / 1e3:.3f} M rays/s; "
          f"trace_hits {kernel_ms:.1f} of {device_ms:.1f} ms device time, "
          f"{idle}; l1_diffuse {', '.join(f'{x:.6f}' for x in l1s)}; peak "
          f"{peak_gb:.1f} GB; launches trace_hits {launches[0]}, "
          f"scatter_grads {launches[1]} [{smi}]", flush=True)
    print(f"phase 12: trace_hits brute, first launch ({p['rays']} rays) per "
          f"pass: primary {p['ms']:.3f} ms "
          f"({p['pairs']:.4g} pairs, bound {p['bound_ms']:.3f} ms by "
          f"{p['bound_by']}, no-FMA issue floor {p['floor_ms']:.3f} ms), "
          f"reflected {r['ms']:.3f} ms ({r['pairs']:.4g} pairs, floor "
          f"{r['floor_ms']:.3f} ms); plain on the "
          f"first {NF_CHECK_TILES} ray blocks {p['plain_ms']:.1f} / "
          f"{r['plain_ms']:.1f} ms, max_abs_err {p['max_abs_err']:.3g} / "
          f"{r['max_abs_err']:.3g}, ids+counters equal on "
          f"{min(p['counters_equal'], r['counters_equal']):.4%} [{smi}]",
          flush=True)
    for k, v in res["profiled_top_device_ms"][:6]:
        print(f"phase 12:   {v:9.2f} ms  {k[:90]}", flush=True)
    return res


def attr_table(gpack) -> torch.Tensor:
    """The [N, TABLE_A] attribute table of a gpack: its attribute rows
    (layout.ATTR_ROWS, pack_attr_table's column order) as columns."""
    n = gpack.shape[1]
    pad = torch.zeros((n, TABLE_A - NUM_ATTR), dtype=gpack.dtype,
                      device=gpack.device)
    return torch.cat([gpack[list(ATTR_ROWS)].T, pad], dim=1).contiguous()


def table_call(call, table):
    """A render_culled KernelCall as render_culled_table's call on the same
    rays and candidates (its arguments, the table after the gpack)."""
    args = (*call.args[:3], table, *call.args[3:])
    kwargs = {k: call.kwargs[k] for k in (
        "transmittance_threshold", "eps_forward_normalization", "max_hits",
        "cluster", "tile", "alive", "secondary_static")}
    return SimpleNamespace(args=args, kwargs=kwargs)


def all_listed_pairs(gpack, cands, cluster: int) -> torch.Tensor:
    """Per tile, the valid Gaussians of every listed cluster: the traversed
    lane of a tile that processed its whole list."""
    per_cluster = gpack[ROW_VALID].reshape(-1, cluster).sum(dim=1)
    listed = cands >= 0
    return torch.where(listed, per_cluster[cands.clamp(min=0).long()],
                       0.0).sum(dim=1)


def no_exit(args, kwargs, near_pos):
    """A call's arguments with threshold 0 and every near distance 0: no
    ray saturates and no candidate lies behind, so every tile walks its
    whole list."""
    args = list(args)
    args[near_pos] = torch.zeros_like(args[near_pos])
    return args, dict(kwargs, transmittance_threshold=0.0)


def exact(where: str, a, b) -> None:
    if not torch.equal(a, b):
        diff = (a != b).any(dim=-1) if a.dim() > 1 else a != b
        raise RuntimeError(f"{where}: not bit for bit equal on "
                           f"{diff.float().mean().item():.4%} of rows")


def phase_round2(dev, record, smi) -> dict:
    """Phase 13: the round-2 render (render_culled_table) at the eval
    render's shapes."""
    W = H = FAST_SIZE
    scene, camera = room(FAST_N, dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    calls = first_two_passes(scene, camera, W, H, draw_samples(gen, W, H, 3))
    table = attr_table(calls[0].args[2])
    tcalls = [table_call(c, table) for c in calls]
    # the path: one launch per pass, as tests/test_render_kernel.py runs it
    render_culled_table.launches = 0
    outs = [render_culled_table(*c.args, **c.kwargs) for c in tcalls]
    torch.cuda.synchronize()
    launches = render_culled_table.launches
    if launches != 2:
        raise RuntimeError(f"phase 13: render_culled_table launched "
                           f"{launches} times, expected 2")
    res = {}
    for name, call, tc, out in zip(("primary", "reflected"), calls, tcalls,
                                   outs):
        tile, cluster = tc.kwargs["tile"], tc.kwargs["cluster"]
        ms = cuda_ms(lambda: render_culled_table(*tc.args, **tc.kwargs),
                     reps=5)
        culled_ms = cuda_ms(lambda: render_culled(*call.args, **call.kwargs),
                            reps=5)
        args, kw, rows = first_tiles(tc, CHECK_TILES, cand_pos=(4, 5))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = render_culled_table_reference(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        exact(f"phase 13 {name} kernel vs plain", out[:rows], ref)
        # render_culled on the same candidates, on the tiles where both
        # walked the whole list
        culled = render_culled(*call.args, **call.kwargs)
        full = all_listed_pairs(call.args[2], call.args[3], cluster)
        both = ((out[::tile, OUT_TRAV] == full)
                & (culled[::tile, OUT_TRAV] == full))
        rows_both = both.repeat_interleave(tile)
        exact(f"phase 13 {name} vs render_culled (whole lists)",
              out[rows_both, :OUT_CHUNKS], culled[rows_both, :OUT_CHUNKS])
        # and with no exit anywhere: every tile walks its whole list
        na, nkw = no_exit(tc.args, tc.kwargs, 5)
        ca, ckw = no_exit(call.args, call.kwargs, 4)
        a = render_culled_table(*na, **nkw)
        b = render_culled(*ca, **ckw)
        exact(f"phase 13 {name} vs render_culled (no exit)",
              a[:, :OUT_CHUNKS], b[:, :OUT_CHUNKS])
        pairs = out[:, OUT_TRAV].sum().item()
        b_ms, b_by = bound(walk_flops(tc.args[0], out[:, OUT_TRAV], tile),
                           PEAK_FP32,
                           nbytes(*tc.args[:6], tc.kwargs["alive"], out))
        res[name] = dict(ms=ms, render_culled_ms=culled_ms, pairs=pairs,
                         bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                         plain_rays=rows, rays=tc.args[0].shape[0],
                         max_abs_err=0.0,
                         tiles_whole_list=both.float().mean().item(),
                         chunks=out[::tile, OUT_CHUNKS].mean().item(),
                         render_culled_chunks=culled[::tile, OUT_CHUNKS]
                         .mean().item())
        del a, b, culled, ref
    res["launches"] = launches
    record["phase13_round2"] = res
    p, r = res["primary"], res["reflected"]
    print(f"phase 13: round-2 render (render_culled_table) at the "
          f"{W}x{H} eval render's passes, room_scene({FAST_N}), K 32, "
          f"cluster 256, 192 candidates: primary {p['ms']:.3f} ms "
          f"(render_culled {p['render_culled_ms']:.3f} ms; {p['pairs']:.4g} "
          f"pairs, bound {p['bound_ms']:.3f} ms by {p['bound_by']}), "
          f"reflected {r['ms']:.3f} ms (render_culled "
          f"{r['render_culled_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms); "
          f"kernel = plain bit for bit on the first {CHECK_TILES} tiles "
          f"(plain {p['plain_ms']:.1f} / {r['plain_ms']:.1f} ms); lanes 0-14 "
          f"= render_culled's bit for bit on the tiles both walk whole "
          f"({p['tiles_whole_list']:.2%} / {r['tiles_whole_list']:.2%}) "
          f"and on every tile with no exit; launches {launches} [{smi}]",
          flush=True)
    del scene, calls, tcalls, outs, table
    torch.cuda.empty_cache()
    return res


def phase_bench_v5(dev, record, smi) -> dict:
    """Phase 14: the tools/bench_v5.py twin at its defaults, and V5_CFG's
    passes against their plain version."""
    inputs = bench_v5.bench_inputs(BENCH_V5_N, BENCH_V5_RES, BENCH_V5_RAYS,
                                   dev)
    render_culled.launches = render_scan.launches = 0
    rows = [bench_v5.run_config(inputs, cfg, 16, BENCH_V5_ITERS)
            for cfg in BENCH_V5_CONFIGS]
    torch.cuda.synchronize()
    launches = dict(render_culled=render_culled.launches,
                    render_scan=render_scan.launches)
    per_cfg = 2 * (1 + BENCH_V5_ITERS)
    n_cfg = {v: sum(c.startswith(v) for c in BENCH_V5_CONFIGS)
             for v in ("v4", "v5", "v6")}
    expected = dict(render_culled=per_cfg * (n_cfg["v4"] + n_cfg["v5"]),
                    render_scan=per_cfg * n_cfg["v6"])
    if launches != expected:
        raise RuntimeError(f"phase 14: launches {launches}, expected "
                           f"{expected}")
    for row in rows:
        if not all(math.isfinite(row[k]) for k in (
                "primary_ms", "secondary_ms", "chunks_p", "chunks_s")):
            raise RuntimeError(f"phase 14: bad row {row}")
    ver, cl, tl, mcp, mcs = V5_CFG.split(":")
    cl, tl = int(cl), int(tl)
    passes = {}
    for which, mc in (("primary", int(mcp)), ("secondary", int(mcs))):
        fn, args, kw = bench_v5.pass_call(inputs, ver, cl, tl, mc, which, 16)
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = render_culled_v5_reference(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        exact(f"phase 14 v5 {which} kernel vs plain", out, ref)
        ms = cuda_ms(lambda: fn(*args, **kw), reps=10)
        pairs = out[:, OUT_TRAV].sum().item()
        b_ms, b_by = bound(walk_flops(args[0], out[:, OUT_TRAV], kw["tile"]),
                           PEAK_FP32,
                           nbytes(*args[:5], out) + 4 * args[0].shape[0])
        passes[which] = dict(ms=ms, pairs=pairs, bound_ms=b_ms,
                             bound_by=b_by, plain_ms=plain_ms,
                             rays=args[0].shape[0], max_abs_err=0.0)
        del out, ref
    res = dict(rows=rows, launches=launches, passes=passes)
    record["phase14_bench_v5"] = res
    for row in rows:
        print(f"phase 14: bench_v5 {row['cfg']}: primary "
              f"{row['primary_ms']:.3f} ms, secondary "
              f"{row['secondary_ms']:.3f} ms, frame proxy "
              f"{row['frame_proxy_mrays']:.3f} M rays/s, chunks "
              f"{row['chunks_p']:.1f} / {row['chunks_s']:.1f} [{smi}]",
              flush=True)
    print(f"phase 14: launches {launches}", flush=True)
    for which, p in passes.items():
        print(f"phase 14: {V5_CFG} {which} ({p['rays']} rays): "
              f"render_culled_v5 {p['ms']:.3f} ms, {p['pairs']:.4g} pairs, "
              f"bound {p['bound_ms']:.3f} ms by {p['bound_by']}; = plain bit "
              f"for bit (plain {p['plain_ms']:.1f} ms, whole pass) [{smi}]",
              flush=True)
    del inputs
    torch.cuda.empty_cache()
    return res


def phase_dtype(dev, record, smi) -> dict:
    """Phase 15: the tools/bench_vpu_dtype.py twin at its defaults, the
    kernels against their plain versions at MIX_CHECK_REPS rounds and at
    the timed MIX_REPS, bit for bit (infinities equal)."""
    (rows, cols), reps, iters = MIX_SHAPE, MIX_REPS, MIX_ITERS
    mix.launches = 0
    run = bench_vpu_dtype.run(rows, cols, reps, iters, dev)
    launches = mix.launches
    if launches != 2 * (1 + iters):
        raise RuntimeError(f"phase 15: mix launched {launches} times")
    x = torch.tensor(np.random.default_rng(0).uniform(0.1, 0.9, (rows, cols)),
                     dtype=torch.float32, device=dev)
    res = dict(launches=launches)
    n = rows * cols
    for name, dtype in DTYPES.items():
        exact(f"phase 15 {name} kernel vs plain at {MIX_CHECK_REPS} rounds",
              mix(x, MIX_CHECK_REPS, dtype),
              mix_reference(x, MIX_CHECK_REPS, dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = mix_reference(x, reps, dtype)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        out = mix(x, reps, dtype)
        exact(f"phase 15 {name} kernel vs plain at {reps} rounds", out, ref)
        us, tops, _checksum = run[name]
        # the bound: the slower of the FP32 pipe and MUFU at their
        # instruction rates, against reading x and writing acc once
        fp32_ms = n * reps * MIX_FP32_INSTR[name] / FP32_LANES_S * 1e3
        mufu_ms = n * reps / MUFU_LANES_S * 1e3
        b_ms, b_by = bound(0.0, PEAK_FP32, 2 * 4 * n)
        if max(fp32_ms, mufu_ms) >= b_ms:
            b_ms, b_by = max(fp32_ms, mufu_ms), "operations"
        res[name] = dict(ms=us / 1e3, tops=tops, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_pipe=("FP32 pipe" if fp32_ms >= mufu_ms
                                     else "MUFU.EX2"),
                         fp32_pipe_ms=fp32_ms, mufu_ms=mufu_ms,
                         inf_share=torch.isinf(out).float().mean().item(),
                         max_abs_err=0.0)
    res["speedup"] = res["f32"]["ms"] / res["bf16"]["ms"]
    record["phase15_dtype"] = res
    f, b = res["f32"], res["bf16"]
    print(f"phase 15: bench_vpu_dtype {rows}x{cols}, {reps} rounds: f32 "
          f"{f['ms'] * 1e3:.1f} us ({f['tops']:.3f} T ops/s; bound "
          f"{f['bound_ms'] * 1e3:.1f} us by {f['bound_by']}, "
          f"{f['bound_pipe']}), bf16 {b['ms'] * 1e3:.1f} us "
          f"({b['tops']:.3f} T ops/s; bound {b['bound_ms'] * 1e3:.1f} us by "
          f"{b['bound_by']}, {b['bound_pipe']}); bf16 speedup "
          f"{res['speedup']:.2f}x; kernel = plain bit for bit at "
          f"{MIX_CHECK_REPS} and {reps} rounds in both types (infinite at "
          f"{reps}: f32 {f['inf_share']:.2%}, bf16 {b['inf_share']:.2%}); "
          f"plain {f['plain_ms']:.1f} / {b['plain_ms']:.1f} ms; launches "
          f"{launches} [{smi}]", flush=True)
    return res


def phase_sort(dev, record, smi) -> dict:
    """Phase 16: the slot-sort kernel against its plain version on the
    Pallas test's inputs and on SORT_RAYS x SORT_K slots."""
    small = sort_inputs(8, 16, 5, 7, dev)
    large = sort_inputs(SORT_RAYS, SORT_K, SORT_AUX, 11, dev)
    sort_slots_aux.launches = 0
    outs = [sort_slots_aux(*small), sort_slots_aux(*large)]
    torch.cuda.synchronize()
    launches = sort_slots_aux.launches
    if launches != 2:
        raise RuntimeError(f"phase 16: sort launched {launches} times")
    for name, inp, out in zip(("test inputs", "large"), (small, large),
                              outs):
        for a, b in zip(out, sort_slots_aux_reference(*inp)):
            exact(f"phase 16 {name}", a, b)
    ms = cuda_ms(lambda: sort_slots_aux(*large), reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sort_slots_aux_reference(*large)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b_ms, b_by = bound(SORT_RAYS * SORT_K * SORT_K / 2, PEAK_FP32,
                       nbytes(*large, *outs[1]))
    info = {f"K{k}": sort_kernel_info(k) for k in (16, 32)}
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               launches=launches, rays=SORT_RAYS, k=SORT_K, aux=SORT_AUX,
               max_abs_err=0.0, kernel_info=info)
    record["phase16_sort"] = res
    print(f"phase 16: slot sort = plain bit for bit on the Pallas test's "
          f"inputs (8x16, 5 aux) and on {SORT_RAYS}x{SORT_K} with "
          f"{SORT_AUX} aux blocks: {ms:.3f} ms (plain {plain_ms:.1f} ms, "
          f"bound {b_ms:.3f} ms by {b_by}); launches {launches} [{smi}]",
          flush=True)
    print_kernel_info("phase 16", "sort_slots", info, at="256-thread blocks")
    return res


def main() -> None:
    # the smoke drives one card: only the first visible one is made visible,
    # before CUDA initialises, so the device count it reports is the one used
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False - this "
                 "script needs a CUDA GPU")
    full_f32_matmuls()
    dev = torch.device("cuda")
    record = {}

    # -- phase 1: the card, the build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    t0 = time.perf_counter()
    libs = build.build_all(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    lib.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, lib in zip(KERNEL_SOURCES, libs)}
    record.update(card=smi, build_s=build_s, ptxas=ptxas)
    print(f"phase 1: card [{smi}]; built {len(libs)} kernels in parallel in "
          f"{build_s:.1f} s", flush=True)
    for name, lines in ptxas.items():
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in lines
                       if "Used " in ln})
        spills = sorted({ln for ln in lines if "spill" in ln})
        print(f"phase 1: {name}.cu ptxas: {'; '.join(regs)}; "
              f"{' | '.join(spills)}", flush=True)

    # -- phase 2: kernel vs plain on the card --------------------------------
    scene, camera = room(16384, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    samples = draw_samples(gen, 128, 128, 3)
    phase2 = {}
    for name, call in zip(("primary", "reflected"),
                          first_two_passes(scene, camera, 128, 128, samples)):
        out = render_culled(*call.args, **call.kwargs)
        torch.cuda.synchronize()
        ref = render_culled_reference(*call.args, **call.kwargs)
        phase2[name] = compare_lanes(out, ref)
        check_lanes(f"phase 2 {name}", phase2[name])
    record["phase2"] = phase2
    print("phase 2: kernel vs plain at 128x128, room_scene(16384), K=32: "
          + "; ".join(f"{k} max_abs_err {v['max_abs_err']:.3g}, counters "
                      f"equal on {v['counters_equal']:.4%} of rays"
                      for k, v in phase2.items()), flush=True)

    # -- phase 3: one frame on cuda and on cpu, same samples -----------------
    scene_c, camera_c = room(16384, "cpu")
    samples = draw_samples(torch.Generator().manual_seed(1), 64, 64, 3)
    on_dev = render_frame_fused(
        scene, camera, SETTINGS, None, 64, 64, num_bounces=2,
        samples=type(samples)(samples.jitter.to(dev), samples.us.to(dev)),
        **FRAME_KW)
    on_cpu = render_frame_fused(scene_c, camera_c, SETTINGS, None, 64, 64,
                                num_bounces=2, samples=samples, **FRAME_KW)
    worst, bounce0, failed = {}, {}, []
    for f in StepOutputs._fields + ("final",):
        a = (on_dev[1] if f == "final" else getattr(on_dev[0], f)).cpu()
        b = on_cpu[1] if f == "final" else getattr(on_cpu[0], f)
        if not torch.isfinite(a).all():
            failed.append(f"non-finite {f} on the card")
        if f not in ("final", "throughput"):
            # bounce 0 traces identical inputs on both devices
            scale = max(1.0, b[0].abs().max().item())
            bounce0[f] = (a[0] - b[0]).abs().max().item() / scale
            if bounce0[f] > 1e-4:
                failed.append(f"bounce 0 {f} differs by {bounce0[f]} x scale")
        worst[f] = mismatch(a if f == "final" else a[1:],
                            b if f == "final" else b[1:])
        if worst[f] > 0.005:
            failed.append(f"{f} mismatch share {worst[f]}")
    record.update(phase3_bounce0_err_over_scale=bounce0,
                  phase3_mismatch_share=worst)
    if failed:
        raise RuntimeError(f"phase 3: {failed}; bounce 0 {bounce0}; "
                           f"shares {worst}")
    print("phase 3: 64x64 2-bounce frame, cuda vs cpu: bounce 0 within "
          "1e-4*scale; worst later-bounce mismatch share "
          f"{max(worst.values()):.4%} ({max(worst, key=worst.get)})",
          flush=True)

    # -- phase 4: the eval render at full size ------------------------------
    e = eval_frame(dev)
    W, H, scene, camera = e.W, e.H, e.scene, e.camera
    call0, call1 = e.calls
    kernel_ms = cuda_ms(lambda: render_culled(*call0.args, **call0.kwargs),
                        reps=10)
    kernel_ms_reflected = cuda_ms(
        lambda: render_culled(*call1.args, **call1.kwargs), reps=10)
    # the kernel vs its plain version at the main path's own shapes (the
    # candidate lists overflow here, and the reflected tiles are wide)
    phase4 = {}
    for name, call in (("primary", call0), ("reflected", call1)):
        out = render_culled(*call.args, **call.kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = render_culled_reference(*call.args, **call.kwargs)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        phase4[name] = dict(compare_lanes(out, ref), plain_ms=plain,
                            pairs=out[:, OUT_TRAV].sum().item(),
                            flops=walk_flops(call.args[0], out[:, OUT_TRAV],
                                             call.kwargs["tile"]),
                            differ=differing_lanes(out, ref))
        print_differing(f"phase 4 {name}", phase4[name])
        check_lanes(f"phase 4 {name}", phase4[name])
    plain_ms = phase4["primary"]["plain_ms"]
    # ray x Gaussian pairs the primary pass tests: per ray, the valid
    # Gaussians of its tile's processed clusters (output lane 14)
    pairs = phase4["primary"]["pairs"]
    gpairs_s = pairs / kernel_ms / 1e6
    record.update(kernel_ms_primary=kernel_ms,
                  kernel_ms_reflected=kernel_ms_reflected,
                  plain_ms_primary=plain_ms,
                  plain_ms_reflected=phase4["reflected"]["plain_ms"],
                  pairs_primary=pairs, gpairs_per_s_primary=gpairs_s,
                  phase4_compare=phase4)
    print(f"phase 4: render_culled at the 800x800 frame's passes "
          f"({call0.args[0].shape[0]} rays, capacity {scene.capacity}): "
          f"primary {kernel_ms:.3f} ms (plain version {plain_ms:.1f} ms, "
          f"{pairs:.4g} ray x Gaussian pairs, {gpairs_s:.1f} G pairs/s)"
          f", reflected {kernel_ms_reflected:.3f} ms (plain version "
          f"{phase4['reflected']['plain_ms']:.1f} ms) [{smi}]", flush=True)
    print("phase 4: kernel vs plain at these shapes: " + "; ".join(
        f"{k} max_abs_err {v['max_abs_err']:.3g}, counters equal on "
        f"{v['counters_equal']:.4%} of rays, every lane on "
        f"{v['bit_equal']:.4%}" for k, v in phase4.items()), flush=True)

    # -- phase 4b: render_culled in groups of 4 on the same primary pass ----
    ce4_kw = dict(call0.kwargs, check_every=4)
    ce4_ms = cuda_ms(lambda: render_culled(*call0.args, **ce4_kw), reps=10)
    out4 = render_culled(*call0.args, **ce4_kw)
    args4, kw4, rows4 = first_tiles(call0, CHECK_TILES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref4 = render_culled_reference(*args4, **dict(kw4, check_every=4))
    torch.cuda.synchronize()
    ce4_plain_ms = (time.perf_counter() - t0) * 1e3
    ce4_cmp = compare_lanes(out4[:rows4], ref4)
    check_lanes("phase 4b", ce4_cmp)
    ce4_pairs = out4[:, OUT_TRAV].sum().item()
    ce4_bound_ms, ce4_bound_by = bound(
        walk_flops(call0.args[0], out4[:, OUT_TRAV], call0.kwargs["tile"]),
        PEAK_FP32,
        nbytes(*call0.args[:5], call0.kwargs["alive"], out4))
    record["phase4b_check_every_4"] = dict(
        ce4_cmp, ms=ce4_ms, plain_ms_first_tiles=ce4_plain_ms,
        check_tiles=CHECK_TILES, pairs=ce4_pairs, bound_ms=ce4_bound_ms,
        bound_by=ce4_bound_by, launches_on_main_path=0)
    print(f"phase 4b: render_culled check_every=4 (pallas_render_culled_v3's "
          f"exit; not launched at this capacity) on the 800x800 primary "
          f"pass: {ce4_ms:.3f} ms ({ce4_pairs:.4g} pairs, bound "
          f"{ce4_bound_ms:.3f} ms by {ce4_bound_by}); plain version on the "
          f"first {CHECK_TILES} tiles {ce4_plain_ms:.1f} ms, max_abs_err "
          f"{ce4_cmp['max_abs_err']:.3g}, counters equal on "
          f"{ce4_cmp['counters_equal']:.4%} of those rays [{smi}]",
          flush=True)
    del out4, ref4

    render_culled.launches = 0
    n_timed = 3
    frames = time_frames(e, n_timed)
    steps, final, frame_ms = frames.steps, frames.final, frames.ms
    acc_steps, acc_final = render_accumulated_chunked(
        scene, camera, SETTINGS, 0, W, H, spp=4, spp_chunk=2, **e.frame_kw)
    launches = render_culled.launches
    expected = 3 * (1 + n_timed + 1 + 4)
    if launches != expected:
        raise RuntimeError(f"phase 4: render_culled launched {launches} "
                           f"times, expected {expected}")
    for name, t in (("final", final), ("spp final", acc_final)):
        if tuple(t.shape) != (W * H, 3) or not torch.isfinite(t).all():
            raise RuntimeError(f"phase 4: bad {name}: {tuple(t.shape)}")
        if not t.mean().item() > 0.0:
            raise RuntimeError(f"phase 4: {name} is black")
    if not all(torch.isfinite(a).all() for a in (*steps, *acc_steps)):
        raise RuntimeError("phase 4: non-finite step outputs")

    by_kernel = frames.by_kernel  # device-side events (kernels, copies)
    device_ms = sum(by_kernel.values())
    render_ms = sum(v for k, v in by_kernel.items()
                    if "render_culled_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    traced_rays = steps.alive.sum().item()
    starved = steps.overflow.mean().item()
    record.update(frame_ms=frame_ms, launches=launches,
                  expected_launches=expected,
                  frame_mrays_s=W * H / frame_ms / 1e3,
                  traced_mrays_s=traced_rays / frame_ms / 1e3,
                  starved_fraction=starved,
                  profiled_device_ms=device_ms,
                  profiled_render_kernel_ms=render_ms,
                  profiled_top_device_ms=top)
    kernel_share = (f"{render_ms:.1f} ms of {device_ms:.1f} ms device time "
                    f"in render_culled, device idle ~"
                    f"{max(0.0, 1 - device_ms / frame_ms):.1%} of the frame"
                    if render_ms > 0
                    else "device time not measured (profiler saw none)")
    print(f"phase 4: 800x800, room_scene(100_000), 2 bounces, K=32: "
          f"{frame_ms:.1f} ms/frame, {W * H / frame_ms / 1e3:.3f} M frame "
          f"rays/s, {traced_rays / frame_ms / 1e3:.3f} M traced rays/s, "
          f"starved {starved:.4%}; {kernel_share}; 4 spp finite; "
          f"render_culled launches {launches} [{smi}]", flush=True)

    # the roofline of render_culled's primary pass: its pair math, and its
    # inputs read once and its output written once
    rc_bound_ms, rc_bound_by = bound(
        phase4["primary"]["flops"], PEAK_FP32,
        nbytes(*call0.args[:5], call0.kwargs["alive"]) + nbytes(
            torch.empty((call0.args[0].shape[0], 16))))
    # the same for the reflected pass, and the no-FMA issue floor of both:
    # built without contraction, each flop issues on its own
    rc_bound_r_ms, rc_bound_r_by = bound(
        phase4["reflected"]["flops"], PEAK_FP32,
        nbytes(*call1.args[:5], call1.kwargs["alive"]) + nbytes(
            torch.empty((call1.args[0].shape[0], 16))))
    rc_floor = {name: v["flops"] / FP32_LANES_S * 1e3
                for name, v in phase4.items()}
    record.update(render_culled_bound_ms=rc_bound_ms,
                  render_culled_reflected_bound_ms=rc_bound_r_ms,
                  render_culled_floor_ms=rc_floor)
    print(f"phase 4: render_culled's bound: primary {rc_bound_ms:.3f} ms by "
          f"{rc_bound_by}, reflected {rc_bound_r_ms:.3f} ms by "
          f"{rc_bound_r_by}; no-FMA issue floor {rc_floor['primary']:.3f} / "
          f"{rc_floor['reflected']:.3f} ms", flush=True)
    record["render_culled_kernel"] = info = walk_kernel_info("render_culled")
    print_kernel_info("phase 4", "render_culled", info)
    del e, scene, steps, final, acc_steps, acc_final, call0, call1, frames
    torch.cuda.empty_cache()

    # -- phase 5: the training kernels vs plain, at the step's shapes -------
    t = fused_training_step(dev)
    cfg, settings, num_bounces, K = t.cfg, t.settings, t.num_bounces, t.K
    tile, step_kw, cap = t.tile, t.step_kw, t.capacity
    lrs, hyper = t.lrs, t.hyper
    n_tiles, tiles_per_launch = t.n_tiles, t.tiles_per_launch
    calls = t.calls
    phase5 = {}
    for name, call in (("primary", calls[0]), ("reflected", calls[1])):
        k_ms = cuda_ms(lambda: trace_slots(*call.args, **call.kwargs),
                       reps=3)
        out, acc = trace_slots(*call.args, **call.kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_acc = trace_slots_reference(*call.args, **call.kwargs)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        cmp = compare_slots(out, acc, ref, ref_acc, K)
        print_differing(f"phase 5 trace_slots {name}", cmp)
        check_lanes(f"phase 5 trace_slots {name}", cmp)
        if cmp["counters_equal"] < 1.0:
            raise RuntimeError(f"phase 5 trace_slots {name}: ids or "
                               f"counters differ from the plain version's "
                               f"on {1.0 - cmp['counters_equal']:.6%} of "
                               f"rays")
        n_pairs = acc[:, 1].sum().item()
        flops = walk_flops(call.args[0], acc[:, 1], call.kwargs["tile"])
        b_ms, b_by = bound(flops, PEAK_FP32,
                           nbytes(*call.args[:7], call.kwargs["alive"],
                                  out, acc))
        phase5[name] = dict(cmp, ms=k_ms, plain_ms=plain, pairs=n_pairs,
                            bound_ms=b_ms, bound_by=b_by,
                            floor_ms=flops / FP32_LANES_S * 1e3,
                            rays=call.args[0].shape[0])
        del out, acc, ref, ref_acc

    # -- phase 5b: trace_slots in exit mode 1 on the same primary batch -----
    call = calls[0]
    m1_kw = dict(call.kwargs, exit_mode=1, check_every=2)
    m1_ms = cuda_ms(lambda: trace_slots(*call.args, **m1_kw), reps=3)
    out, acc = trace_slots(*call.args, **m1_kw)
    args1, kw1, rows1 = first_tiles(call, CHECK_TILES, cand_pos=(5, 6))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_acc = trace_slots_reference(*args1, **dict(kw1, exit_mode=1,
                                                        check_every=2))
    torch.cuda.synchronize()
    m1_plain_ms = (time.perf_counter() - t0) * 1e3
    m1_cmp = compare_slots(out[:rows1], acc[:rows1], ref, ref_acc, K)
    check_lanes("phase 5b", m1_cmp)
    m1_pairs = acc[:, 1].sum().item()
    m1_bound_ms, m1_bound_by = bound(
        walk_flops(call.args[0], acc[:, 1], call.kwargs["tile"]), PEAK_FP32,
        nbytes(*call.args[:7], call.kwargs["alive"], out, acc))
    phase5["exit_mode_1"] = dict(
        m1_cmp, ms=m1_ms, plain_ms_first_tiles=m1_plain_ms,
        check_tiles=CHECK_TILES, pairs=m1_pairs, bound_ms=m1_bound_ms,
        bound_by=m1_bound_by, launches_on_main_path=0)
    print(f"phase 5b: trace_slots exit mode 1 (pallas_trace_slots' pairs, "
          f"check_every=2; not launched at this capacity) on the step's "
          f"primary batch: {m1_ms:.3f} ms ({m1_pairs:.4g} pairs, bound "
          f"{m1_bound_ms:.3f} ms by {m1_bound_by}); plain version on the "
          f"first {CHECK_TILES} tiles {m1_plain_ms:.1f} ms, max_abs_err "
          f"{m1_cmp['max_abs_err']:.3g}, ids+counters equal on "
          f"{m1_cmp['counters_equal']:.4%} of those rays [{smi}]",
          flush=True)
    del out, acc, ref, ref_acc, call
    del calls
    t.calls = None
    payload, ids = hit_grads(t.steps, t.residuals, t.targets_b, settings,
                             num_bounces, cap)
    t.steps = t.residuals = t.targets_b = None
    acc_k = scatter_add(new_grad_accumulator(cap, dev), payload, ids)
    acc_r = scatter_add_reference(new_grad_accumulator(cap, dev), payload,
                                  ids)
    a32, r32 = acc_k.to(torch.float32), acc_r.to(torch.float32)
    sc_scale = max(1e-30, r32.abs().max().item())
    sc_err = (a32 - r32).abs().max().item()
    if not (sc_err <= 1e-6 * sc_scale and torch.equal(a32 == 0, r32 == 0)
            and bool(torch.isfinite(a32).all())):
        raise RuntimeError(f"phase 5: scatter_grads disagrees with its plain "
                           f"version: max abs err {sc_err}, scale {sc_scale}")
    sc_ms = cuda_ms(lambda: scatter_add(acc_k, payload, ids), reps=3)
    sc_plain_ms = cuda_ms(lambda: scatter_add_reference(acc_r, payload, ids),
                          reps=1, warmup=0)
    keep = ids >= 0
    idx, vals = ids[keep].to(torch.int64), payload[keep].to(torch.float64)
    sc_lib_ms = cuda_ms(lambda: acc_r.index_add_(0, idx, vals), reps=3)
    nnz = int(((payload != 0) & keep[:, None]).sum().item())
    # the bytes the function needs: every id, the payload of the rows with
    # a valid id only (the kernel skips the others unread), the float64
    # accumulator read and written
    n_hits = int(keep.sum().item())
    sc_bound_ms, sc_bound_by = bound(
        nnz, PEAK_FP64, n_hits * payload.shape[1] * payload.element_size()
        + nbytes(ids) + 2 * nbytes(acc_k))
    phase5["scatter"] = dict(ms=sc_ms, plain_ms=sc_plain_ms,
                             library_ms=sc_lib_ms, max_abs_err=sc_err,
                             scale=sc_scale, hits=n_hits,
                             rows=ids.shape[0], nonzero_values=nnz,
                             bound_ms=sc_bound_ms, bound_by=sc_bound_by,
                             kernel_info=scatter_kernel_info())
    del payload, ids, acc_k, acc_r, a32, r32, idx, vals, keep
    record.update(phase5=phase5, tiles_per_launch=tiles_per_launch)
    print(f"phase 5: trace_slots at the step's batch ({tiles_per_launch} of "
          f"{n_tiles} {tile}-ray tiles, capacity {cap}, K={K}, mc "
          f"{cfg.max_clusters}): " + "; ".join(
              f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.1f} ms, bound "
              f"{v['bound_ms']:.3f} ms by {v['bound_by']}, no-FMA issue "
              f"floor {v['floor_ms']:.3f} ms, max_abs_err "
              f"{v['max_abs_err']:.3g}, ids+counters equal on "
              f"{v['counters_equal']:.4%} of rays)"
              for k, v in phase5.items() if k in ("primary", "reflected"))
          + f" [{smi}]", flush=True)
    record["trace_slots_kernel"] = info = walk_kernel_info("trace_slots",
                                                           (0, 1))
    print_kernel_info("phase 5", "trace_slots", info)
    print(f"phase 5: scatter_grads on all 3 bounces' hits "
          f"({phase5['scatter']['rows']} slots, "
          f"{phase5['scatter']['hits']} hits): {sc_ms:.3f} ms (plain "
          f"{sc_plain_ms:.3f} ms, index_add_ {sc_lib_ms:.3f} ms, bound "
          f"{sc_bound_ms:.3f} ms by {sc_bound_by}), max abs err {sc_err:.3g} "
          f"of scale {sc_scale:.3g}, zeros equal; {nnz} nonzero values "
          f"[{smi}]", flush=True)
    print_kernel_info("phase 5", "scatter_grads",
                      {"kernel": phase5["scatter"]["kernel_info"]},
                      at="4096-row chunks")

    # -- phase 6: one small step on cuda and on cpu, same samples -----------
    small = {}
    samples = draw_tile_samples(torch.Generator().manual_seed(4), 64, 64,
                                1024, num_bounces + 1)
    small_kw = dict(step_kw, tile=1024)
    for d in (dev, torch.device("cpu")):
        sc6, cam6 = room(4096, d)
        R6 = 64 * 64
        rng6 = torch.Generator().manual_seed(5)
        tg6 = RayTargets(*(torch.rand(shape, generator=rng6).to(d) for shape in
                           ((R6, 3), (R6, 3), (R6,), (R6, 3), (R6,),
                            (R6, 3))))
        small[d.type] = tr.train_step(
            tr.init_train_state(sc6), cam6, tg6, settings, lrs, hyper, None,
            64, 64, samples=TileSamples(samples.jitter.to(d),
                                        samples.us.to(d)), **small_kw)
    diff = states_equal(small["cuda"][0], small["cpu"][0])
    m6 = {k: {dt: v[1][k].item() for dt, v in small.items()}
          for k in small["cuda"][1]}
    if diff or any(v["cuda"] != v["cpu"] for v in m6.values()):
        raise RuntimeError(f"phase 6: cuda and cpu steps differ in {diff}, "
                           f"metrics {m6}")
    record.update(phase6_metrics=m6)
    print(f"phase 6: 64x64 training step, room_scene(4096), K={K}, 2 "
          f"bounces, cuda vs cpu: params, moments and total_weight equal, "
          f"l1_diffuse {m6['l1_diffuse']['cuda']:.6f} on both", flush=True)
    del small

    # -- phase 7: the full-width training step -----------------------------
    def reset():
        trace_slots.launches = scatter_add.launches = 0

    run = time_steps(t, N_TIMED_STEPS, reset=reset, count=lambda: (
        trace_slots.launches, scatter_add.launches))
    step_ms, l1s, starved_fr = run.ms, run.l1s, run.starved
    launches_ts, launches_sc = run.launches
    n_batches = -(-n_tiles // tiles_per_launch)
    expected_ts = N_TIMED_STEPS * n_batches * (num_bounces + 1)
    expected_sc = N_TIMED_STEPS * n_batches
    if (launches_ts, launches_sc) != (expected_ts, expected_sc):
        raise RuntimeError(f"phase 7: trace_slots/scatter_grads launched "
                           f"{launches_ts}/{launches_sc} times, expected "
                           f"{expected_ts}/{expected_sc}")
    if not state_finite(run.timed_state):
        raise RuntimeError("phase 7: non-finite training state")
    if not all(map(math.isfinite, l1s)):
        raise RuntimeError(f"phase 7: non-finite l1_diffuse {l1s}")
    peak_gb = run.peak_gb
    by_kernel = run.by_kernel
    dev_ms = sum(by_kernel.values())
    ts_ms = sum(v for k, v in by_kernel.items() if "trace_slots_kernel" in k)
    sa_ms = sum(v for k, v in by_kernel.items() if "scatter_add_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    rays = TRAIN_W * TRAIN_H
    record.update(step_ms=step_ms, step_mrays_s=rays / step_ms / 1e3,
                  l1_diffuse=l1s, starved=starved_fr, peak_gb=peak_gb,
                  launches_trace_slots=launches_ts,
                  launches_scatter=launches_sc,
                  profiled_step_device_ms=dev_ms,
                  profiled_trace_slots_ms=ts_ms,
                  profiled_scatter_ms=sa_ms, profiled_step_top=top)
    share = (f"device {dev_ms:.1f} ms: trace_slots {ts_ms:.1f} ms "
             f"({ts_ms / dev_ms:.1%}), scatter_grads {sa_ms:.1f} ms "
             f"({sa_ms / dev_ms:.1%}), device idle ~"
             f"{max(0.0, 1 - dev_ms / step_ms):.1%} of the step"
             if ts_ms > 0 else "device time not measured (profiler saw none)")
    print(f"phase 7: training step 768x768, room_scene({TRAIN_N}) "
          f"(capacity {cap}), 2 bounces, K={K}, mc {cfg.max_clusters}, "
          f"{n_tiles} tiles of {tile} in {n_batches} launch(es) per bounce: "
          f"{step_ms:.1f} ms/step, {rays / step_ms / 1e3:.3f} M rays/s; "
          f"{share}; l1_diffuse per step "
          f"{', '.join(f'{x:.6f}' for x in l1s)}; starved "
          f"{max(starved_fr):.4%}; peak {peak_gb:.1f} GB; launches "
          f"trace_slots {launches_ts}, scatter_grads {launches_sc} (expected "
          f"{expected_ts}, {expected_sc}) [{smi}]", flush=True)
    for k, v in top[:8]:
        print(f"phase 7:   {v:9.2f} ms  {k[:90]}", flush=True)
    del t, run
    torch.cuda.empty_cache()

    phase_scan_small(dev, record)
    fast = phase_fast_path(dev, record, smi)
    phase_trace_small(dev, record)
    nf_frame = phase_nonfused_render(dev, record, smi)
    nf_step = phase_nonfused_step(dev, record, smi)
    round2 = phase_round2(dev, record, smi)
    v5 = phase_bench_v5(dev, record, smi)
    dtype = phase_dtype(dev, record, smi)
    sort = phase_sort(dev, record, smi)

    src = "editable_gaussian_reflections_tpu_torch/csrc/"
    jax_src = "editable_gaussian_reflections_tpu/ops/pallas/"
    kernels = [{
        "name": "render_culled",
        "route": "cuda",
        "source": src + "render_culled.cu",
        "replaces": jax_src + "render_kernel_v3.py:500",
        "also_replaces": [jax_src + "render_kernel_v3.py:322",
                          jax_src + "render_kernel_v5.py:386"],
        "launches": launches,
        # worst float-lane error over both passes at the main path's shapes
        "max_abs_err": max(c["max_abs_err"] for c in phase4.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": rc_bound_ms,
        "bound_by": rc_bound_by,
        "library_ms": None,
        "floor_ms": rc_floor["primary"],
        "reflected_ms": kernel_ms_reflected,
        "reflected_plain_ms": phase4["reflected"]["plain_ms"],
        "reflected_bound_ms": rc_bound_r_ms,
        "reflected_floor_ms": rc_floor["reflected"],
        # registers and blocks per SM of the launched kernel (phase 4)
        "registers": {k: v["registers"] for k, v in
                      record["render_culled_kernel"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in
                          record["render_culled_kernel"].items()},
        # the same kernel as pallas_render_culled_v5's port, on the bench_v5
        # twin's run (phase 14; v4 and v5 rows), times at V5_CFG's primary
        "bench_v5_launches": v5["launches"]["render_culled"],
        "v5_ms": v5["passes"]["primary"]["ms"],
        "v5_plain_ms": v5["passes"]["primary"]["plain_ms"],
        "v5_bound_ms": v5["passes"]["primary"]["bound_ms"],
        "v5_secondary_ms": v5["passes"]["secondary"]["ms"],
    }, {
        "name": "trace_slots",
        "route": "cuda",
        "source": src + "trace_slots.cu",
        "replaces": jax_src + "render_kernel_v3.py:787",
        "also_replaces": jax_src + "render_kernel.py:665",
        "launches": launches_ts,
        "max_abs_err": max(phase5[k]["max_abs_err"]
                           for k in ("primary", "reflected")),
        "ms": phase5["primary"]["ms"],
        "plain_ms": phase5["primary"]["plain_ms"],
        "bound_ms": phase5["primary"]["bound_ms"],
        "bound_by": phase5["primary"]["bound_by"],
        "library_ms": None,
        "floor_ms": phase5["primary"]["floor_ms"],
        "reflected_ms": phase5["reflected"]["ms"],
        "reflected_plain_ms": phase5["reflected"]["plain_ms"],
        "reflected_bound_ms": phase5["reflected"]["bound_ms"],
        "reflected_floor_ms": phase5["reflected"]["floor_ms"],
        # exit mode 1 on the primary batch (phase 5b)
        "exit_mode_1_ms": phase5["exit_mode_1"]["ms"],
        "exit_mode_1_bound_ms": phase5["exit_mode_1"]["bound_ms"],
        # registers and blocks per SM of the launched kernel (phase 5)
        "registers": {k: v["registers"] for k, v in
                      record["trace_slots_kernel"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in
                          record["trace_slots_kernel"].items()},
    }, {
        "name": "scatter_grads",
        "route": "cuda",
        "source": src + "scatter_grads.cu",
        "replaces": jax_src + "scatter_kernel.py:102",
        "launches": launches_sc,
        "max_abs_err": sc_err,
        "ms": sc_ms,
        "plain_ms": sc_plain_ms,
        "bound_ms": sc_bound_ms,
        "bound_by": sc_bound_by,
        "library_ms": sc_lib_ms,
        "registers": phase5["scatter"]["kernel_info"]["registers"],
        "blocks_per_sm": phase5["scatter"]["kernel_info"]["blocks_per_sm"],
    }, {
        "name": "render_scan",
        "route": "cuda",
        "source": src + "render_scan.cu",
        "replaces": jax_src + "render_kernel_v7.py:362",
        "also_replaces": jax_src + "render_kernel_v6.py:200",
        # measure_fps() at the Config defaults: the main path (phase 9b)
        "launches": fast["fps_launches"],
        "max_abs_err": fast["max_abs_err"],
        "ms": fast["fps"]["scanq"]["primary_ms"],
        "plain_ms": fast["fps"]["scanq"]["primary_plain_ms"],
        "bound_ms": fast["fps"]["scanq"]["primary_bound_ms"],
        "bound_by": fast["fps"]["scanq"]["primary_bound_by"],
        "library_ms": None,
        "floor_ms": fast["fps"]["scanq"]["primary_floor_ms"],
        "reflected_ms": fast["fps"]["scanq"]["reflected_ms"],
        "reflected_bound_ms": fast["fps"]["scanq"]["reflected_bound_ms"],
        "reflected_floor_ms": fast["fps"]["scanq"]["reflected_floor_ms"],
        # the same kernel at bench.py's configuration (phase 9a)
        "bench_ms": fast["bench"]["scanq"]["primary_ms"],
        "bench_reflected_ms": fast["bench"]["scanq"]["reflected_ms"],
        "direct_ms": fast["bench"]["scan"]["primary_ms"],
        "direct_reflected_ms": fast["bench"]["scan"]["reflected_ms"],
        # registers and blocks per SM of the launched kernel (phase 9b)
        "registers": {k: v["registers"]
                      for k, v in fast["fps_kernel"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"]
                          for k, v in fast["fps_kernel"].items()},
    }, {
        "name": "trace_hits",
        "route": "cuda",
        "source": src + "trace_hits.cu",
        # the brute pass of the non-fused training step (phase 12)
        "replaces": jax_src + "trace_kernel.py:435",
        "also_replaces": jax_src + "trace_kernel.py:485",
        "launches": nf_step["launches"] + nf_frame["launches"],
        "launches_step": nf_step["launches"],
        "launches_frame": nf_frame["launches"],
        "max_abs_err": max(r[p]["max_abs_err"] for r in (
            nf_step["passes"], nf_frame["passes"])
            for p in ("primary", "reflected")),
        "ms": nf_step["passes"]["primary"]["ms"],
        "plain_ms": nf_step["passes"]["primary"]["plain_ms"],
        "plain_rays": nf_step["passes"]["primary"]["plain_rays"],
        "bound_ms": nf_step["passes"]["primary"]["bound_ms"],
        "bound_by": nf_step["passes"]["primary"]["bound_by"],
        "library_ms": None,
        "floor_ms": nf_step["passes"]["primary"]["floor_ms"],
        "reflected_ms": nf_step["passes"]["reflected"]["ms"],
        # the culled passes of the non-fused eval render (phase 11)
        "culled_ms": nf_frame["passes"]["primary"]["ms"],
        "culled_plain_ms": nf_frame["passes"]["primary"]["plain_ms"],
        "culled_bound_ms": nf_frame["passes"]["primary"]["bound_ms"],
        "culled_reflected_ms": nf_frame["passes"]["reflected"]["ms"],
        # registers and blocks per SM of the launched kernel (phase 10)
        "registers": {k: v["registers"] for k, v in
                      record["trace_hits_kernel"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in
                          record["trace_hits_kernel"].items()},
    }, {
        "name": "render_table",
        "route": "cuda",
        "source": src + "render_table.cu",
        "replaces": jax_src + "render_kernel.py:354",
        # the eval render's primary and reflected pass (phase 13)
        "launches": round2["launches"],
        "max_abs_err": 0.0,
        "ms": round2["primary"]["ms"],
        "plain_ms": round2["primary"]["plain_ms"],
        "plain_rays": round2["primary"]["plain_rays"],
        "bound_ms": round2["primary"]["bound_ms"],
        "bound_by": round2["primary"]["bound_by"],
        "library_ms": None,
        "reflected_ms": round2["reflected"]["ms"],
        "render_culled_ms": round2["primary"]["render_culled_ms"],
    }, {
        "name": "bench_dtype",
        "route": "cuda",
        "source": src + "bench_dtype.cu",
        "replaces": "tools/bench_vpu_dtype.py:53",
        # the bench_vpu_dtype twin's run (phase 15): float32, and bf16 beside
        "launches": dtype["launches"],
        "max_abs_err": dtype["f32"]["max_abs_err"],
        "ms": dtype["f32"]["ms"],
        "plain_ms": dtype["f32"]["plain_ms"],
        "bound_ms": dtype["f32"]["bound_ms"],
        "bound_by": dtype["f32"]["bound_by"],
        "library_ms": None,
        "bf16_ms": dtype["bf16"]["ms"],
        "bf16_bound_ms": dtype["bf16"]["bound_ms"],
    }, {
        "name": "sort_slots",
        "route": "cuda",
        "source": src + "sort_slots.cu",
        "replaces": "tests/test_pallas_kernel.py:279",
        "launches": sort["launches"],
        "max_abs_err": 0.0,
        "ms": sort["ms"],
        "plain_ms": sort["plain_ms"],
        "bound_ms": sort["bound_ms"],
        "bound_by": sort["bound_by"],
        "library_ms": None,
        "registers": {k: v["registers"] for k, v in
                      sort["kernel_info"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in
                          sort["kernel_info"].items()},
    }]
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    # one card is visible to this process (start of main): the count is 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
