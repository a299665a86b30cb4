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
     kernel is timed at the shapes of this frame's primary and first
     reflected pass, each beside its bound and no-FMA issue floor, and held
     against its plain version (tolerances of phase 2) on each pass's
     CHECK_TILES tiles that walk the most pairs, with the compiled
     kernel's registers, spilled bytes, shared memory and resident blocks
     per SM (K 8 to 64, primary and reflected; what the runtime reports).
     4b: render_culled in groups of 4 (pallas_render_culled_v3's exit, which
     the renderer takes above the resident capacity) on the same primary
     pass: timed, its bound, held against its plain version on the first
     CHECK_TILES tiles;
  5. the training kernels vs their plain PyTorch versions at the full-width
     step's own shapes: room_scene(175_000) (capacity 176,128), 768x768,
     the Config defaults (K=32, cluster 256, 192 candidates, 8192-ray tiles,
     2 bounces), the step's tiles in the batch the main path launches -
     trace_slots on its primary and first reflected pass (the plain version
     on each pass's CHECK_TILES busiest tiles), scatter_grads on the hits
     of all 3 bounces (within 1e-6 x scale, zeros equal; its nonzero
     values counted); all timed with CUDA events, trace_slots
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
     version (on the pass's CHECK_TILES busiest tiles), the scan (v6)
     frame, and the k-buffer frame with its
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
     rounds, 20 calls), then per type the kernel's device time (profiler)
     against the bound counted from the SASS (MIX_INSTR), beside the tool's
     events time, the host's time to enqueue a call and a 0-round call's
     events time, and the bf16 speedup; kernel vs plain, bit for bit with
     equal infinities, at MIX_CHECK_REPS rounds and at the timed 512; the
     kernels' registers and blocks per SM;
 16. the slot sort (csrc/sort_slots.cu) vs plain on the Pallas test's
     inputs and on 655,360 x 32 slots with 5 auxiliary blocks, bit for bit;
     timed against its byte bound, with what the runtime reports of the
     compiled kernel at K 16 and 32;
 17. the bench.py twin (python -m editable_gaussian_reflections_tpu_torch.
     bench) at its defaults - artifacts/bench_best.json's configuration,
     the frame of phase 9a - its last line parsed and its mode's render
     kernel launched 3 times a frame; then the four tool twins once at full
     width with their iterations cut (TOOL_ARGV): bench_render_sweep,
     bench_scan_mode, bench_train_step and bench_slots_kernel, each row
     free of errors and each tool's kernels launched;
 18. the training CLI's loop (train.train_scene, through
     tools/cli_setup.py: set_seeds, prepare_output_and_logger, a Scene of
     an in-memory SceneInfo) at 768x768 on 4 train and 1 test view
     orbiting the room, their G-buffers the port's render of the seed-0
     room_scene(175_000), initialized from the seed-1 room's points (knn3
     scales), the Config defaults but CLI_KW: 3 primary-only steps, the
     far-field injection and the candidate budget's growth at 4, znear
     pruning at 4 and 8, weight pruning at 8, the denoised report at 10,
     PLY and checkpoint saves at 8 and 10; host ms per iteration by regime
     (synchronized), knn3, report, render, denoise and save times, capacity,
     live count and max_clusters, l1_diffuse and starved per step, the
     report's PSNRs and cull_overflow, each step's and the report's
     launches of trace_slots, scatter_grads and render_culled, peak GB;
     then a resume from step_8 in a fresh loop (the loaded state equal to
     the saved one, iterations 9 and 10 with 2 bounces and the re-grown
     budget, every state finite); then (b) the same loop at 64x64 on
     room_scene(16384) with 1024 far-field points on the card and on the
     CPU with the same samples: final TrainStates equal bit for bit, the
     CSV PSNRs within CLI_PSNR_DB;
 19. run.sh from disk: tools/prior_setup.py writes phase 18's views
     (768x768, 4 train + 1 test, the seed-0 room_scene(175_000)'s
     G-buffers) as a Blender-prior dataset with the port's own PNG writer
     and a COLMAP sparse model of the seed-1 room's points; get_dataset
     reads it back (BlenderPriorDataset: the RANSAC depth rescale runs),
     each buffer held to the in-memory G-buffers within its format's
     quantisation and the fit (LOAD_TOL), with the PNG read ms per file
     (also of a Paeth-filtered copy); then the CLIs in-process, each
     timed with its kernels' launches: prepare_initial_ply --mode sfm,
     train (phase 18's CLI_KW, init_type sfm), render (--spp 128
     --spp_chunk 16 --skip_video; ms and spp per view, overflow.json),
     metrics (psnr ssim msssim lpips: finite, PSNR above 0, lpips_rand at
     least 0) and tools.render_novel_views (RUN_NOVEL: 2 views at 16 spp,
     cut from 300 at 128); then (b) the same pipeline at RUN_SMALL_SIDE on
     room_scene(RUN_SMALL_N) on the card and on the CPU with the same
     samples (the render's and the novel views' spp cut to RUN_SMALL_SPP
     and RUN_SMALL_NOVEL): the trained PLYs equal, every PNG within
     RUN_PNG_SHARE / RUN_FLIP_SHARE, overflow.json equal, metrics.json
     within RUN_METRIC_TOL.
 20. the viewer from disk: tools/viewer_setup.py writes a model directory
     (the seed-0 room_scene(175_000) through save_scene_ply, cfg.json at the
     Config defaults, 768x768, transforms_train.json of phase 18's views,
     bounding_boxes.json around the room's three spheres: a box, a "cyl"
     excluding the first, an f0 filter with a zrange) and
     ViewerState.from_ply reads it; then a scripted client drives
     RenderService.tick, each tick synchronized and host-timed with its
     launches of render_culled, render_scan and trace_hits: VIEWER_SETTLED
     settled RGB ticks (the accumulated frame held to the mean of the
     ticks' frames, bit for bit), VIEWER_DRAG drag ticks at preview_scale 2
     (scan, frame_shape still 768), the other render modes (Ellipsoids
     with and without floaters, Points), compute_selections and a pick at
     each object's centre (a close-up camera) by the masks and by the
     raster gid, one edit of each kind on each object (object_centers
     moving by the translation), remove (the object's mask empty), a
     duplicate (unpadded: the capacity leaves the cluster multiple and the
     tick traces brute, as in the JAX package), inspect, goto_camera, and
     the pipelined _handle with 4 requests on a stand-in socket (12 replies
     in order); peak GB.  (b) the same session, cut in depth
     (VIEWER_SMALL_DEPTH: no remove, inspect or handler), at
     VIEWER_SMALL_SIDE on
     room_scene(VIEWER_SMALL_N) on the card and on the CPU with the same
     samples: the kernel-rendered G-buffers equal bit for bit, the raster
     frames within VIEWER_RASTER_TOL with gid equal but at VIEWER_GID_SHARE
     of the pixels, the metadata and selection masks equal.  Last, train
     --viewer: phase 18's set-up for VIEWER_TRAIN_KW's iterations with the
     service's serve replaced by a stand-in (the machine has no
     websockets): a stand-in socket ticks the viewer between steps and the
     viewer shows each iteration's state; peak GB.
 21. the parallel modes (parallel/), ranks started by mesh.spawn, all on
     the card over gloo unless said otherwise; every rank's ms, peak GB
     and kernel launches, counted in the ranks from 0.  (a) sharded_train_
     step on 2 ranks at train.py's Config defaults on phase 7's scene
     (768x768, 36 tiles of 8192 a rank), against train_step on the same
     samples (bit-equal expected; the largest delta per field printed,
     fails beyond PAR_STATE_RTOL/PAR_STATE_ATOL on any element), with the
     gradient all-reduce's ms and bytes.  (b) sharded_render_fused on 2
     ranks, the 800x800 eval frame (100k room, rays_per_call 64,000),
     against render_frame_fused: the share equal where neither starved,
     tonemapped PSNR over the rest (fails under PAR_FRAME_PSNR over all);
     that frame and the same at each of PAR_FRAME_THRESHOLDS: where
     neither starved the share within PAR_FRAME_TOL, the step at which the
     others first part and how far apart the steps before it are; fails
     unless step 0 (the same tiles in both) is within on every ray and, at
     threshold 0 (no ray saturates, so no tile's early exit moves one),
     every ray is that neither frame capped at K; sharded_render(use_pallas,
     use_culling) on phase 11's 1365x768 frame at 1 bounce on 3 ranks,
     equal to render_frame.  (c) tools/demo_5m.py at its defaults: 5M
     Gaussians padded by shard_scene on 4 ranks, one step, one trace of
     each kind at the JAX tool's K 8; bytes per rank against the
     replicated footprint.  (d) the
     rays 2 x gauss 2 mesh on 4 ranks at 64x64 on the 175k room: the
     gradients against train_step(use_pallas=False, tile R/2)'s (fails
     under 99% in the 1e-4 band, as tests/test_gaussian_sharded.py), and
     gaussian_sharded_trace(use_pallas) against trace_rays (fails under
     demo_5m.MIN_RAYS_EQUAL of rays with the same hits - hits at the clip
     radius flip between the two float32 formulas - or where depths on
     those rays part beyond demo_5m.T_RTOL/T_ATOL).  In (c) and (d) every
     rank's slots-kernel call (rows 4 and 3) also runs against its plain
     version on the same shard inputs, by phase 5's rule: ids and counters
     equal on every ray, t, alpha, payload and log T within compare_slots'
     band.  (e) one rank over
     NCCL: bit-equal
     to train_step.  (f) a DP step and a 2D-mesh step at 32x32 on card
     ranks and on CPU ranks: equal.  No failure is caught.
 22. split-far (two passes a bounce: hits before each ray's exit from the
     split sphere, then those beyond it), on scenes carrying train.py's
     far-field shell (with_shell: Config init_num_pts_farfield appended as
     phase 18's injection appends it).  (a) the fused training step at
     768x768 on the 175k room + shell, Config defaults (the candidate
     budget grown as train.py grows it at the injection), split_far with
     mc_far 32 and K_far 16: ms a step beside one pass (both timed with
     nothing patched), starved, peak GB, finite state, the slots kernel's
     launches by window and the scatter's (K + K_far slots a ray); on the
     step's first batch, starved near / far / whole (fused_forward's
     SplitCalls), every bounce's per-ray outputs against one pass within
     SPLIT_RTOL / SPLIT_ATOL where they are equal by construction
     (split_mask: neither starved, no pass's slots all full,
     unsaturated), and scatter_grads on its 48-slot payload against its
     plain version by phase 5's rule.  (b) the 800x800 eval frame of
     bench.py's room + shell, k-buffer and scanq, split and not: ms,
     starved by pass (split_bounce's per-pass flags, from an untimed
     frame), launches by window, the same per-ray check (required for the
     k-buffer; the scan composites in streaming order, so scanq's is
     reported) and PSNR.  (c) trace_slots, render_culled and render_scan
     in window modes 1 and 2 (the near and far passes of bounces 0 and 1
     of (a) and (b)) against their plain versions on each pass's
     CHECK_TILES tiles that walked the most pairs (at least
     WINDOW_MIN_PAIRS): trace_slots by phase 5's rule with max abs err 0,
     the render kernels bit for bit.  (d) the DP split step on 2
     ranks at SPLIT_DP_SIDE against train_step, by phase 21 (a)'s rule.
     (e) tools/probe_cand_stats.py at its defaults: candidates a tile by
     tile size, repaired and parent cull.
 23. the tools (python -m editable_gaussian_reflections_tpu_torch.tools.
     <name>) in-process, each with its seconds and its kernels' launches
     (counted from 0 just before it) against the counts its code implies:
     (a) make_room_dataset at its defaults (128x128, room_scene(20000),
     10 + 2 views, 4 spp: the fused route), ms a view; BlenderDataset
     reads the dataset back with imageio, cv2 and PIL blocked, every
     buffer bit for bit what was written; the training CLI on it at -r
     128 for CLI_KW's iterations (every loss finite, trace_slots 1 or 3 a
     step, scatter_grads 1), then its last step's inputs once more on the
     dataset's ground-truth scene, whose reflected rays live (the fit's
     die on its faint normals).  (b) eval_sweep on that model at its
     defaults (spp 1/16/128, denoise 0/1) on the route render.py's gate
     gives the loaded model (default_backend_kwargs, fused_path_ok):
     every PSNR finite, eval_sweep.json written.  (c) denoiser_eval at its defaults
     (256x256, reference 256 spp, spp 1/8/32/128): plain PSNR rising with
     spp, the KPN's gain at spp 1 above 0 dB; the grid printed beside the
     repository's denoiser_eval.json (the JAX run's figures).  (d)
     denoise_train --gen (256x256, reference 192 spp, 2 noisy frames a
     view) and --train (crop 128), cut in depth (TOOLS_CUTS: views 16 ->
     4, steps 1500 -> 150): the best validation L1 below its initial
     value, the weights (a temporary path) read back by load_params, the
     shipped assets/denoise_kpn_v1.npz's sha256 unchanged.  (e)
     colmap2nerf on phase 19's COLMAP sparse model: every frame's pose
     within TOOLS_POSE_TOL of the one the dataset writer was given;
     --sharpen_percent 50 on a copy of phase 19's PNG frames keeps the
     sharpest half.  (f) card against CPU with the same samples on
     room_scene(TOOLS_SMALL_N): a make_room_dataset view at
     TOOLS_SMALL_SIDE (fused forced) and at TOOLS_NF_SIDE (non-fused:
     trace_hits against the CPU's plain tracer), its 7 buffers by the
     frame rule (at most RUN_FLIP_SHARE of elements outside 2e-4*|ref| +
     2e-5*scale), the RGB ones also tonemapped to 8 bits by phase 19
     (b)'s PNG rule, and a denoiser_eval frame and its denoised image
     likewise.  At bounce 0 (primary) and at bounce 1 (reflected), the
     call with the most live rays of each kernel the route runs,
     render_culled or trace_hits in (a), (b), (c) and (f), trace_slots
     (the reflected ones come after no_bounces_until_iter) and the
     report's render_culled in (a)'s training and its ground-truth step,
     and the first scatter of each, is held against its plain version
     (phases 2 and 5's rules); a run that made none of one fails, and so
     does a ground-truth reflected trace_slots call with no live ray.
 24. the k-buffer kernels at K 8 and K 64, one line a (kernel, K) held: ms
     a pass, its work and bound (walk_flops' count), the bytes it writes,
     what the runtime reports of it (registers, local bytes, shared
     memory, blocks per SM), and its plain version on the pass's
     K_CHECK_TILES busiest tiles by phase 5's rule (ids, counters and
     payload equal, max abs err 0; the render kernels bit for bit).  (a)
     train.py's Config defaults at --max_hits 8: phase 7's step
     (trace_slots at both passes, scatter_grads on its payload), the
     800x800 eval frame's passes
     (render_culled, render_table on the primary pass) and the training
     CLI at CLI_SMALL_SIDE (its report's render_culled).  (b) split-far
     at bench.py's fused configuration (K 16, cluster 128, 96 candidates,
     grown for the shell) with the shell: the step, its far passes at the
     default K_far 8, against one pass by phase 22's per-ray check, and
     the eval frame at max_hits_far 8 against one pass at K 32 by the same
     check (a ray with at most 16 near and 8 far hits keeps every hit on
     both sides; at K 16 the one pass leaves no ray to compare); the near
     and far pass of bounces 0 and 1 of each held.  (d) K
     64: trace_slots on (a)'s first batch at the Config's 256-ray tiles
     and 256-Gaussian clusters (its epilogue in two parts a slot block),
     the CLI at --max_hits 64, the 800x800 eval frame at cluster 128 (its
     bounce 0's tonemapped PSNR against the scan frames'), and trace_hits
     at K 8 and 64 on phase 11's culled frame; the slot sort at both on
     phase 16's rays.  ((c), demo_5m at K 8, runs in phase 21.)  Every
     kernel of the set is launched at K 8 and K 64 on a driven path
     (counted by K from 0 just before each, comparisons not counted).

Then a JSON line describing the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Every measured number also goes to
chiprun_out/chip_smoke.json.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import hashlib
import importlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

from editable_gaussian_reflections_tpu_torch import bench
from editable_gaussian_reflections_tpu_torch import metrics as tmetrics
from editable_gaussian_reflections_tpu_torch import (
    prepare_initial_ply as tprep,
)
from editable_gaussian_reflections_tpu_torch import render as trender
from editable_gaussian_reflections_tpu_torch import train as ttrain
from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.dataset.blender import (
    BlenderDataset,
)
from editable_gaussian_reflections_tpu_torch.dataset.image_utils import (
    from_png,
)
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
    unpack_composite,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
    DTYPES,
    mix,
    mix_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
    kernel_info as mix_kernel_info,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_fine import (
    render_culled_v5_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    SUPPORTED_K,
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
    slots_resident_fits,
    trace_slots,
    trace_slots_reference,
)
from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.camera_rays import (
    primary_ray_directions,
)
from editable_gaussian_reflections_tpu_torch.ops.precision import div
from editable_gaussian_reflections_tpu_torch.ops import trace as trace_mod
from editable_gaussian_reflections_tpu_torch.ops.trace import trace_rays
from editable_gaussian_reflections_tpu_torch.parallel.gaussian_sharded import (
    shard_scene,
)
from editable_gaussian_reflections_tpu_torch.parallel.mesh import spawn
from editable_gaussian_reflections_tpu_torch.parallel.ranks import (
    capped_flags,
    host_inputs,
    moved,
    random_targets,
    run_jobs,
    same_hits,
    to_numpy,
)
from editable_gaussian_reflections_tpu_torch.ops.render_grads import (
    new_grad_accumulator,
)
from editable_gaussian_reflections_tpu_torch.ops.tonemap import tonemap
from editable_gaussian_reflections_tpu_torch.utils.image import (
    read_png,
    write_png,
)
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    FrameSamples,
    RayTargets,
    RenderSettings,
    StepOutputs,
    TileSamples,
    draw_samples,
    draw_tile_samples,
    full_f32_matmuls,
    fused_path_ok,
    hit_grads,
    render_accumulated_chunked,
    render_frame,
    render_frame_fused,
    tiles_per_launch_for,
)
from editable_gaussian_reflections_tpu_torch.renderer import denoise_net as tdn
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
from editable_gaussian_reflections_tpu_torch.renderer import render as trd
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene import init as tinit
from editable_gaussian_reflections_tpu_torch.scene.gaussian_scene import (
    build_frames,
    from_arrays,
    num_live,
)
from editable_gaussian_reflections_tpu_torch.scene.dataset_readers import (
    get_dataset,
    getNerfppNorm,
)
from editable_gaussian_reflections_tpu_torch.scene.scene import Scene
from editable_gaussian_reflections_tpu_torch.utils import synth as tsynth
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from editable_gaussian_reflections_tpu_torch.viewer import service as tservice
from editable_gaussian_reflections_tpu_torch.viewer import state as tstate
from editable_gaussian_reflections_tpu_torch.viewer.service import (
    RenderService,
)
from editable_gaussian_reflections_tpu_torch.viewer.state import (
    RENDER_MODES,
    ViewerState,
)
from editable_gaussian_reflections_tpu_torch.tools import (
    bench_v5,
    bench_vpu_dtype,
    demo_5m,
)
from editable_gaussian_reflections_tpu_torch.tools import colmap2nerf as tc2n
from editable_gaussian_reflections_tpu_torch.tools import (
    denoise_train as tdt,
)
from editable_gaussian_reflections_tpu_torch.tools import (
    denoiser_eval as tde,
)
from editable_gaussian_reflections_tpu_torch.tools import eval_sweep as tsweep
from editable_gaussian_reflections_tpu_torch.tools import (
    make_room_dataset as tmrd,
)
from editable_gaussian_reflections_tpu_torch.tools import (
    probe_cand_stats as tprobe,
)
from editable_gaussian_reflections_tpu_torch.tools import prior_setup as tprior
from editable_gaussian_reflections_tpu_torch.tools import (
    render_novel_views as tnovel,
)
from editable_gaussian_reflections_tpu_torch.tools import viewer_setup as tview
from editable_gaussian_reflections_tpu_torch.tools.cli_setup import (
    cli_config,
    gbuffer_views,
    scene_info,
    train_cli,
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
    orbit_views,
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
    ZFAR,
    ZNEAR,
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
# the op mix's bound: instructions per element and round, counted from the
# SASS of csrc/bench_dtype.cu's first port (one element a thread; the
# kernel's header quotes the listing), what expf and h2exp lower to
# included: issue slots, and of them the FP32 pipe's (packed bf16 runs
# there), the ALU's and MUFU's
MIX_INSTR = {"f32": dict(issue=17, fp32=13, alu=3, mufu=1),
             "bf16": dict(issue=11.5, fp32=7, alu=3, mufu=1)}
# what one H100 SXM SM issues or runs a clock (NVIDIA's throughput table for
# compute capability 9.0): a warp instruction a scheduler (128 lanes), 128
# FP32 lanes, 64 ALU lanes, 16 MUFU lanes; at the clock implied by the FP32
# peak (132 SMs x 128 lanes x 2 flops)
MIX_RATES = dict(issue=128, fp32=128, alu=64, mufu=16)
SMS = 132
CLOCK_HZ = PEAK_FP32 / (SMS * 128 * 2)
# the no-FMA issue floor's rate: 128 FP32 lanes an SM, one flop a lane
FP32_LANES_S = SMS * 128 * CLOCK_HZ
MIX_CHECK_REPS = 16
# tools/bench_vpu_dtype.py's defaults: rows, cols, rounds, timed calls
MIX_SHAPE, MIX_REPS, MIX_ITERS = (256, 512), 512, 20
# the slot sort's large case: the eval render's rays, K 32, the Pallas
# test's 5 auxiliary blocks
SORT_RAYS, SORT_K, SORT_AUX = 655_360, 32, 5
# phase 17: the bench twin at its defaults, then each tool twin at full
# width with its iterations cut (arguments as on their command lines)
BENCH_ARGV = []
TOOL_ARGV = {"bench_render_sweep": ["--iters", "1"],
             "bench_scan_mode": ["--iters", "1"],
             "bench_train_step": ["--iters", "1"],
             "bench_slots_kernel": ["--iters", "2"]}
# phase 18: the training CLI's loop on views orbiting the room (4 train, 1
# test) at full width, and at CLI_SMALL_SIDE on the card and on the CPU;
# Config defaults but for CLI_KW (the warm-up ends at 4: injection and the
# budget's growth; znear pruning at 4 and 8, weight pruning at 8, the
# denoised report at 10, saves at 8 and 10)
CLI_SIDE, CLI_N, CLI_VIEWS = 768, 175_000, (4, 1)
CLI_KW = dict(iterations=10, no_bounces_until_iter=4, pruning_interval=4,
              pruning_start_iter=5, test_iterations=[10],
              save_iterations=[8, 10], val_view=0)
CLI_SMALL_SIDE, CLI_SMALL_N, CLI_SMALL_FAR = 64, 16384, 1024
# the CSV PSNRs of the card's and the CPU's run (cuDNN's convolutions in
# the KPN denoiser are not bit-equal to the CPU's)
CLI_PSNR_DB = 0.01
# phase 19: run.sh's CLIs on phase 18's views written to disk in the
# Blender-prior layout; the render at run.sh's 128 spp in chunks of 16, the
# novel views cut from 300 at 128 spp to 2 at 16; (b) at RUN_SMALL_SIDE on
# the card and the CPU, the spp cut further (the CPU runs plain versions)
RUN_SPP, RUN_SPP_CHUNK = 128, 16
RUN_NOVEL = ["--n_views", "2", "--spp", "16"]
RUN_METRICS = ["psnr", "ssim", "msssim", "lpips"]
RUN_SMALL_SIDE, RUN_SMALL_N, RUN_SMALL_FAR = 64, 4096, 512
RUN_SMALL_SPP = (4, 2)
RUN_SMALL_NOVEL = ["--n_views", "2", "--spp", "1"]
# the loaded views against the in-memory G-buffers: tonemapped RGB within
# half an 8-bit level, roughness and metalness-f0 within half a 16-bit
# level, poses to float64 round-off, normals within the 8-bit camera-space
# quantisation after normalising (1/255 a component, sqrt(3)x at most),
# distances within the RANSAC fit's error (median and 99th percentile of
# the relative error; the fit's pairs are within prior_setup.VISIBLE; and
# the largest error in z as a share of the view's written z range, over
# every hit pixel: the fit's error is absolute in z, so the relative
# maximum is that of the few pixels whose rendered distance is far below
# any surface's, partly covered ones the render's alpha weights towards 0),
# plus the untonemap round trip's float32 error
LOAD_TOL = dict(rgb=0.5 / 255 + 1e-4, scalar=0.5 / 65535 + 1e-6,
                pose=1e-9, normal=2 * math.sqrt(3) / 255,
                depth_median=1e-2, depth_p99=5e-2, depth_range=2e-2)
# (b): card vs CPU.  A PNG may differ by one level in RUN_PNG_SHARE of its
# values and by more in RUN_FLIP_SHARE of its pixels (the denoiser's
# convolutions: cuDNN against the CPU's); metrics.json within
# RUN_METRIC_TOL (4 decimals; psnr in dB)
RUN_PNG_SHARE, RUN_FLIP_SHARE = 0.01, 0.005
RUN_METRIC_TOL = dict(psnr=0.01, ssim=2e-4, msssim=2e-4, lpips_rand=2e-4)
# phase 20: the viewer on a model directory (tools/viewer_setup.py) at the
# Config defaults (768x768, 2 bounces); (b) at VIEWER_SMALL_SIDE card vs
# CPU: raster frames within VIEWER_RASTER_TOL where gid agrees, gid unequal
# at no more than VIEWER_GID_SHARE of the pixels (the CPU test's rule:
# tests/test_torch_ellipsoid_raster.py); display images within one 8-bit
# level (the tonemap's pow is not correctly rounded on either device)
VIEWER_N, VIEWER_VIEWS = 175_000, 5
VIEWER_SETTLED, VIEWER_DRAG = 4, 4
VIEWER_SMALL_SIDE, VIEWER_SMALL_N = 64, 4096
VIEWER_RASTER_TOL, VIEWER_GID_SHARE = 1e-5, 0.002
VIEWER_EDITS = (
    ("roughness", {"roughness_shift": 0.1, "roughness_mult": 1.2}),
    ("roughness override", {"use_roughness_override": True,
                            "roughness_override": 0.3}),
    ("diffuse", {"diffuse_override": [0.8, 0.2, 0.1, 0.5],
                 "diffuse_hue_shift": 0.5, "diffuse_saturation_mult": 1.2,
                 "diffuse_value_mult": 0.9}),
    ("specular", {"specular_override": [0.9, 0.9, 0.2, 0.3],
                  "specular_hue_shift": -0.4,
                  "specular_saturation_shift": 0.1,
                  "specular_value_shift": 0.05}),
    ("translate", {"translate_x": 0.2, "translate_y": -0.1,
                   "translate_z": 0.05}),
    ("scale", {"scale": 1.2}),
    ("rotate", {"rotate_x": 10.0, "rotate_y": 20.0, "rotate_z": 30.0}),
)
# (b) runs the session cut in depth (the CPU runs the plain versions, ~2.7
# s a 64x64 frame on the card's host): 2 settled ticks and 1 drag tick, the
# raster modes, the picks at the first object, every edit kind in one
# tick, the duplicate; not remove, inspect or the handler (more brute
# frames of the kind the duplicate's tick compares)
VIEWER_SMALL_DEPTH = dict(
    settled=2, drag=1, modes=("Ellipsoids",), picks=1, tail=False,
    edits=(("every kind", {k: v for _, fields in VIEWER_EDITS
                           for k, v in fields.items()}),))
VIEWER_TRAIN_KW = dict(CLI_KW, iterations=3, no_bounces_until_iter=2,
                       test_iterations=[], save_iterations=[], viewer=True)
VIEWER_COUNTERS = {"render_culled": render_culled,
                   "render_scan": render_scan, "trace_hits": trace_hits}
# phase 21: the parallel modes.  (a) the DP step at train.py's Config
# defaults on phase 7's scene (2 ranks); (b) the fused eval frame (2 ranks)
# and phase 11's culled frame at PAR_NF_BOUNCES bounces (PAR_NF_RANKS ranks:
# 1365x768 splits into whole 256-ray cull tiles 3 ways, not 2); (c)
# tools/demo_5m.py at DEMO_ARGV (its defaults); (d) the rays 2 x gauss 2
# step and the kernel's shard trace at PAR_MESH_SIDE; (f) card against CPU
# ranks at PAR_SMALL_SIDE
PAR_STEP_SIDE, PAR_STEP_N = TRAIN_W, TRAIN_N
PAR_FRAME_SIDE, PAR_FRAME_N, PAR_RPC = 800, 100_000, 64_000
PAR_FRAME_PSNR = 30.0        # dB, sharded against single-process frame
# the frame again at these transmittance thresholds, against the single
# process within PAR_FRAME_TOL (rtol and atol; the CPU test's rule,
# tests/test_torch_sharding.py) where neither starved.  The primary pass
# (step 0) runs the same tiles in both and must be within on every ray.
# The reflected passes' tiles are re-sorted per shard, and which rays
# share a tile moves a ray (tools/shard_tiling.py replays them): a tile
# votes to exit once all its rays are saturated, a saturated ray is not
# flagged starved when the cap cut its list, and the tile-cone cull drops
# clusters a ray of the tile sees (repaired: ops/culling.py).  The
# Config's threshold and 1e-8 are printed; at 0 no ray saturates, and
# every ray must be within that neither frame capped at K: a ray whose K
# slots filled composites a truncated tail from full_T, which counts hits
# up to where its tile's walk stops, and its tile's members decide that
# (ranks.capped_flags marks them)
PAR_FRAME_THRESHOLDS, PAR_FRAME_TOL = (1e-8, 0.0), 1e-5
# the DP state against train_step's, per element (float32 resolution)
PAR_STATE_RTOL, PAR_STATE_ATOL = 1e-6, 1e-12
PAR_NF_RANKS, PAR_NF_BOUNCES = 3, 1
PAR_MESH_SIDE, PAR_MESH_N = 64, TRAIN_N
PAR_SMALL_SIDE, PAR_SMALL_N = 32, 4096
DEMO_ARGV = []
# the kernels the parallel modes launch (rows 1, 3, 4, 10, 11)
PAR_KERNELS = ("render_culled", "trace_slots_mode0", "trace_slots_mode1",
               "trace_hits", "scatter_add")


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


def scatter_numbers(where: str, payload, ids, cap: int, dev) -> dict:
    """scatter_add on (payload, ids) against scatter_add_reference: max abs
    err within 1e-6 of the reference's largest value, the same zeros,
    finite (fails otherwise); the kernel's, the plain version's and
    index_add_'s ms, and the bound."""
    acc_k = scatter_add(new_grad_accumulator(cap, dev), payload, ids)
    acc_r = scatter_add_reference(new_grad_accumulator(cap, dev), payload,
                                  ids)
    a32, r32 = acc_k.to(torch.float32), acc_r.to(torch.float32)
    scale = max(1e-30, r32.abs().max().item())
    err = (a32 - r32).abs().max().item()
    if not (err <= 1e-6 * scale and torch.equal(a32 == 0, r32 == 0)
            and bool(torch.isfinite(a32).all())):
        raise RuntimeError(f"{where}: scatter_grads disagrees with its plain "
                           f"version: max abs err {err}, scale {scale}")
    ms = cuda_ms(lambda: scatter_add(acc_k, payload, ids), reps=3)
    plain_ms = cuda_ms(lambda: scatter_add_reference(acc_r, payload, ids),
                       reps=1, warmup=0)
    keep = ids >= 0
    idx, vals = ids[keep].to(torch.int64), payload[keep].to(torch.float64)
    lib_ms = cuda_ms(lambda: acc_r.index_add_(0, idx, vals), reps=3)
    nnz = int(((payload != 0) & keep[:, None]).sum().item())
    # the bytes the function needs: every id, the payload of the rows with
    # a valid id only (the kernel skips the others unread), the float64
    # accumulator read and written
    n_hits = int(keep.sum().item())
    bound_ms, bound_by = bound(
        nnz, PEAK_FP64, n_hits * payload.shape[1] * payload.element_size()
        + nbytes(ids) + 2 * nbytes(acc_k))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                max_abs_err=err, scale=scale, hits=n_hits,
                rows=ids.shape[0], nonzero_values=nnz, bound_ms=bound_ms,
                bound_by=bound_by)


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
    plain version on the pass's CHECK_TILES tiles that test the most pairs,
    held to the kernel's whole pass there."""
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
            work = counted[:, OUT_TRAV].reshape(-1, call.kwargs["tile"]).sum(
                dim=1)
            ref, rows, res[f"{name}_plain_ms"], keep = busiest_reference(
                call, render_scan_reference, work, tiles_per_batch=512)
            res[f"{name}_plain_tiles"] = len(keep)
            cmp = compare_lanes(out[rows], ref)
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
              + (f"; plain on each pass's {CHECK_TILES} busiest tiles "
                 f"{n['primary_plain_ms']:.1f} / "
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
          f"{n['primary_floor_ms']:.3f} ms, plain on its {CHECK_TILES} "
          f"busiest tiles {n['primary_plain_ms']:.1f} ms, max_abs_err "
          f"{n['primary_compare']['max_abs_err']:.3g}), reflected "
          f"{n['reflected_ms']:.3f} ms (bound "
          f"{n['reflected_bound_ms']:.3f} ms by {n['reflected_bound_by']}, "
          f"floor {n['reflected_floor_ms']:.3f} ms, plain on its "
          f"{CHECK_TILES} busiest tiles {n['reflected_plain_ms']:.1f} ms, "
          f"max_abs_err "
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


def trace_pass_numbers(calls, where: str, busiest: bool = False) -> dict:
    """trace_hits on recorded launches (the primary and first reflected
    pass of the first batch of tiles): ms per launch (CUDA events), the
    pairs it tests (traversed, summed over its rays), its bound, the bytes
    it writes, and its plain version on the first NF_CHECK_TILES blocks
    (`busiest`: the culled blocks that test the most pairs), held to the
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
        plain_kw = {k: v for k, v in kwargs.items() if k != "extract_attrs"}
        if busiest:
            ref, rows, plain_ms, _keep = busiest_reference(
                SimpleNamespace(args=args, kwargs=plain_kw),
                trace_hits_reference,
                out[6].reshape(-1, tile).sum(dim=1).double(),
                n_tiles=NF_CHECK_TILES)
        else:
            sub_args, sub_kw, n = hits_subset(args, plain_kw,
                                              NF_CHECK_TILES)
            rows = slice(0, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = trace_hits_reference(*sub_args, **sub_kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        cmp = compare_hits(tuple(x[rows] for x in out), ref)
        print_differing(f"{where} trace_hits {name}", cmp)
        check_lanes(f"{where} trace_hits {name}", cmp)
        res[name] = dict(cmp, ms=ms, pairs=pairs, flops=flops, bound_ms=b_ms,
                         bound_by=b_by, floor_ms=floor_ms,
                         rays=args[0].shape[0],
                         written_gb=nbytes(*out) / 1e9,
                         plain_ms=plain_ms,
                         plain_rays=NF_CHECK_TILES * 256,
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
    256-Gaussian clusters, every built K, primary passes and reflected ones
    (the backfacing test), each exit mode."""
    return {f"K{k} {name}" + (f" exit {m}" if len(exit_modes) > 1 else ""):
            kernel_info(k, backfacing=name == "reflected", kernel=kernel,
                        exit_mode=m)
            for k in SUPPORTED_K for name in ("primary", "reflected")
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


def mix_bound(name: str, elements: int, reps: int) -> dict:
    """The op mix's bound in `name` ("f32", "bf16"): the slowest of its
    pipes at MIX_RATES over MIX_INSTR's counts, against reading the block
    and writing the result once."""
    pipes = {pipe: elements * reps * count / (SMS * MIX_RATES[pipe]
                                             * CLOCK_HZ) * 1e3
             for pipe, count in MIX_INSTR[name].items()}
    pipe = max(pipes, key=pipes.get)
    b_ms, b_by = bound(0.0, PEAK_FP32, 2 * 4 * elements)
    if pipes[pipe] >= b_ms:
        b_ms, b_by = pipes[pipe], "operations"
    return dict(bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                pipes_ms=pipes)


def device_ms_per_launch(fn, name_part: str) -> tuple:
    """(median device ms, launches seen) of the kernels named like
    `name_part` that fn() launches, from the profiler's trace (the median:
    a launch the profiler's start delays does not move it).  The profiler
    dropped a whole trace once on the card: a trace with none of them is
    taken once more, and a second empty one raises."""
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if name_part in e.name
                    and e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return statistics.median(us) / 1e3, len(us)
    raise RuntimeError(f"the profiler saw no {name_part} kernel, twice")


def phase_dtype(dev, record, smi) -> dict:
    """Phase 15: the tools/bench_vpu_dtype.py twin at its defaults, then
    per type the kernel's own device time (profiler) beside the tool's
    events time and a 0-round call's, and the kernels against their plain
    versions at MIX_CHECK_REPS rounds and at the timed MIX_REPS, bit for
    bit (infinities equal)."""
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

        def calls():
            for _ in range(iters):
                mix(x, reps, dtype)

        # the kernel's own time, and what the host takes to enqueue a call
        dev_ms, profiled = device_ms_per_launch(calls, "mix_")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        reps0_ms, _ = bench_v5.time_call(lambda: mix(x, 0, dtype), iters)
        res[name] = dict(ms=dev_ms, profiled_launches=profiled,
                         events_ms=us / 1e3, host_ms=host_ms,
                         reps0_ms=reps0_ms, tops=tops, plain_ms=plain_ms,
                         **mix_bound(name, n, reps),
                         kernel=mix_kernel_info(dtype),
                         inf_share=torch.isinf(out).float().mean().item(),
                         max_abs_err=0.0)
    res["speedup"] = res["f32"]["ms"] / res["bf16"]["ms"]
    res["events_speedup"] = res["f32"]["events_ms"] / res["bf16"]["events_ms"]
    record["phase15_dtype"] = res

    def line(v):
        by_host = ("; the events time is the host's enqueue rate"
                   if v["host_ms"] >= 0.9 * v["events_ms"] else "")
        return (f"device {v['ms'] * 1e3:.2f} us, {v['bound_ms'] / v['ms']:.1%}"
                f" of the {v['bound_ms'] * 1e3:.2f} us bound ({v['bound_by']}"
                f", {v['bound_pipe']}); events {v['events_ms'] * 1e3:.2f} us "
                f"a call of the tool, host {v['host_ms'] * 1e3:.2f} us a call"
                f"{by_host}, 0 rounds {v['reps0_ms'] * 1e3:.2f} us; "
                f"{v['kernel']['registers']} registers, "
                f"{v['kernel']['blocks_per_sm']} blocks/SM of "
                f"{v['kernel']['threads']} x {v['kernel']['per_thread']}")

    f, b = res["f32"], res["bf16"]
    print(f"phase 15: bench_vpu_dtype {rows}x{cols}, {reps} rounds: f32 "
          f"{line(f)}; bf16 {line(b)}; bf16 speedup {res['speedup']:.2f}x "
          f"on the device ({res['events_speedup']:.2f}x in the tool's "
          f"events); kernel = plain bit for bit at {MIX_CHECK_REPS} and "
          f"{reps} rounds in both types (infinite at {reps}: f32 "
          f"{f['inf_share']:.2%}, bf16 {b['inf_share']:.2%}); plain "
          f"{f['plain_ms']:.1f} / {b['plain_ms']:.1f} ms; launches "
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
    info = {f"K{k}": sort_kernel_info(k) for k in SUPPORTED_K}
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


def phase_bench(dev, record, smi) -> dict:
    """Phase 17: the bench.py twin at its defaults (its last line parsed,
    the render kernel of its configuration's mode launched 3 times a frame),
    then each tool twin once with TOOL_ARGV (every row without an error,
    its kernels launched)."""
    counters = {"render_culled": render_culled, "render_scan": render_scan,
                "trace_slots": trace_slots, "scatter_grads": scatter_add}

    def run_counted(fn, argv):
        for c in counters.values():
            c.launches = 0
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                ret = fn(argv)
            torch.cuda.synchronize()
        finally:
            sys.stdout.write(buf.getvalue())
        return (ret, buf.getvalue(),
                {k: c.launches for k, c in counters.items()})

    ret, out, launches = run_counted(bench.main, BENCH_ARGV)
    last = json.loads(out.strip().splitlines()[-1])
    keys = {"metric", "value", "unit", "vs_baseline", "device"}
    if set(last) != keys or not (math.isfinite(last["value"])
                                 and last["value"] > 0):
        raise RuntimeError(f"phase 17: bench's last line {last}")
    mode = ret["config"].get("composite_mode", "kbuffer")
    kernel = "render_culled" if mode == "kbuffer" else "render_scan"
    other = "render_scan" if kernel == "render_culled" else "render_culled"
    if (launches[kernel], launches[other]) != (3 * ret["frames"], 0):
        raise RuntimeError(f"phase 17: bench launched {launches} in "
                           f"{ret['frames']} frames of mode {mode}")
    res = dict(bench=dict(last, frames=ret["frames"], ms=ret["ms"],
                          starved=ret["starved"], launches=launches,
                          mode=mode))
    # the kernels each tool must launch
    needs = {"bench_render_sweep": ("render_culled",),
             "bench_scan_mode": ("render_culled", "render_scan"),
             "bench_train_step": ("trace_slots", "scatter_grads"),
             "bench_slots_kernel": ("trace_slots",)}
    for name, argv in TOOL_ARGV.items():
        t0 = time.perf_counter()
        _ret, out, launches = run_counted(
            importlib.import_module(
                f"editable_gaussian_reflections_tpu_torch.tools.{name}").main,
            argv)
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        bad = [ln for ln in lines if "error" in ln]
        if bad or not all(launches[k] > 0 for k in needs[name]):
            raise RuntimeError(f"phase 17: {name} {argv}: errors {bad}, "
                               f"launches {launches}")
        res[name] = dict(argv=argv, rows=lines, launches=launches,
                         s=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    record["phase17_bench"] = res
    b = res["bench"]
    sweep_best = res["bench_render_sweep"]["rows"][-1]["best_honest"]
    scan_rows = [r for r in res["bench_scan_mode"]["rows"] if "cfg" in r]
    step = res["bench_train_step"]["rows"][-1]
    slots = res["bench_slots_kernel"]["rows"]
    print(f"phase 17: bench twin ({mode}) {b['value']} Mrays/s "
          f"({b['ms']:.1f} ms/frame, starved {b['starved']:.4f}, "
          f"vs_baseline {b['vs_baseline']}; {kernel} launched "
          f"{b['launches'][kernel]} times in {b['frames']} frames); "
          f"bench_render_sweep best honest {sweep_best and sweep_best['mc']}; "
          f"bench_scan_mode "
          + ", ".join(f"{r['cfg']} {r['ms']} ms" for r in scan_rows)
          + f"; bench_train_step {step['s_per_iter']} s/iter; "
          f"bench_slots_kernel "
          + ", ".join(f"{r['case']} {r['kernel_ms']} ms" for r in slots)
          + f" [{smi}]", flush=True)
    return res


CLI_COUNTERS = {"trace_slots": trace_slots, "scatter_grads": scatter_add,
                "render_culled": render_culled, "trace_hits": trace_hits}


def launch_counts() -> dict:
    return {k: c.launches for k, c in CLI_COUNTERS.items()}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def probe_cli(dev, step_samples=None, render_samples=None):
    """Wrappers around what the CLI's loop calls (its train_step, render,
    training_report, far-field injection, saves, checkpoint load, the
    denoiser and the init's knn3), each synchronized and host-timed, with
    the kernels' launches per step and report.  `step_samples(i, kw)` and
    `render_samples(scene, kw)` replace the steps' and the renders' draws.
    Yields the record."""
    rec = dict(steps=[], renders=[], reports=[], saves=[], knn3=[],
               denoise=[], injections=[], saved={}, loaded=[])
    real = dict(step=ttrain.train_step, render=ttrain.render,
                report=ttrain.training_report,
                append=ttrain.append_with_opt_state,
                save_state=ttrain.save_train_state,
                load_state=ttrain.load_train_state, save_ply=Scene.save,
                knn3=tinit.mean_dist2_knn3, denoise=trd.denoise_specular)

    def timed(name, fn, *args, **kw):
        sync(dev)
        before, t0 = launch_counts(), time.perf_counter()
        out = fn(*args, **kw)
        sync(dev)
        rec[name].append(dict(t0=t0, ms=(time.perf_counter() - t0) * 1e3,
                              launches={k: v - before[k] for k, v in
                                        launch_counts().items()}))
        return out

    def step(state, cp, targets, settings, lrs, hyper, **kw):
        if step_samples is not None:
            kw = dict(kw, generator=None,
                      samples=step_samples(len(rec["steps"]), kw))
        rec["last_step"] = (cp, targets, settings, lrs, hyper, kw)
        new, m = timed("steps", real["step"], state, cp, targets, settings,
                       lrs, hyper, **kw)
        rec["steps"][-1].update(
            bounces=kw["num_bounces"], apply=hyper["apply_grads"],
            mc=kw["max_clusters"], culled=kw["use_culling"],
            capacity=state.scene.capacity, live=num_live(state.scene),
            l1=m["l1_diffuse"].item(), starved=m["starved"].item(),
            finite=state_finite(new))
        return new, m

    def render(camera, scene, settings, *args, **kw):
        if render_samples is not None:
            kw = dict(kw, samples=render_samples(scene, kw))
        pkg = timed("renders", real["render"], camera, scene, settings,
                    *args, **kw)
        rec["renders"][-1]["overflow"] = pkg.overflow_frac
        return pkg

    def append(state, new, **kw):
        out = timed("injections", real["append"], state, new, **kw)
        rec["injections"][-1].update(before=state.scene.capacity,
                                     after=out.scene.capacity,
                                     live=num_live(out.scene))
        return out

    def save_state(path, state):
        rec["saved"][os.path.basename(path)] = state
        return timed("saves", real["save_state"], path, state)

    def load_state(path, device):
        state = real["load_state"](path, device)
        rec["loaded"].append((os.path.basename(path), state))
        return state

    with contextlib.ExitStack() as stack:
        for obj, name, fn in (
                (ttrain, "train_step", step), (ttrain, "render", render),
                (ttrain, "training_report",
                 lambda *a, **k: timed("reports", real["report"], *a, **k)),
                (ttrain, "append_with_opt_state", append),
                (ttrain, "save_train_state", save_state),
                (ttrain, "load_train_state", load_state),
                (Scene, "save",
                 lambda *a, **k: timed("saves", real["save_ply"], *a, **k)),
                (tinit, "mean_dist2_knn3",
                 lambda *a, **k: timed("knn3", real["knn3"], *a, **k)),
                (trd, "denoise_specular",
                 lambda *a, **k: timed("denoise", real["denoise"], *a,
                                       **k))):
            stack.enter_context(mock.patch.object(obj, name, fn))
        yield rec


def iteration_ms(rec, end: float) -> list:
    """Each iteration's host ms (from its step's start to the next one's,
    synchronized), less the report and saves that ran in it."""
    starts = [s["t0"] for s in rec["steps"]] + [end]
    out = []
    for i in range(len(rec["steps"])):
        t0, t1 = starts[i], starts[i + 1]
        extra = sum(e["ms"] for k in ("reports", "saves") for e in rec[k]
                    if t0 <= e["t0"] < t1)
        out.append((t1 - t0) * 1e3 - extra)
    return out


def csv_scores(model: Path) -> dict:
    return {split: np.loadtxt(model / f"{split}_validation_scores.csv",
                              delimiter=",", ndmin=2)
            for split in ("train", "test")}


def phase_cli(dev, record, smi) -> dict:
    """Phase 18: the training CLI's loop (train.train_scene through
    tools/cli_setup.py) at CLI_SIDE on the card, resumed from step 8; then
    at CLI_SMALL_SIDE on the card and on the CPU with the same samples."""
    out_dir = ROOT / "build" / "cli_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    n_train, n_test = CLI_VIEWS
    t0 = time.perf_counter()
    views = gbuffer_views(CLI_N, CLI_SIDE, n_train, n_test, dev)
    info = scene_info(CLI_N, *views)
    setup_s = time.perf_counter() - t0
    cfg = cli_config(str(out_dir / "model"), CLI_SIDE, **CLI_KW)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in CLI_COUNTERS.values():
        c.launches = 0
    with probe_cli(dev) as rec:
        state, _ = train_cli(cfg, info, dev)
        sync(dev)
        end = time.perf_counter()
    launches = launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    steps = rec["steps"]
    it_ms = iteration_ms(rec, end)
    warm = cfg.no_bounces_until_iter
    grown = steps[warm]["mc"]
    failed = []
    if [s["bounces"] for s in steps] != [0] * warm + [2] * (
            cfg.iterations - warm):
        failed.append("bounces")
    prunes = [i + 1 for i, s in enumerate(steps) if s["apply"] == 0.0]
    if prunes != [4, 8]:
        failed.append(f"prune iterations {prunes}")
    if not all(s["culled"] for s in steps):
        failed.append("an unculled step")
    inj = rec["injections"]
    if len(inj) != 1 or inj[0]["after"] <= inj[0]["before"]:
        failed.append(f"injection {inj}")
    if not (grown > cfg.max_clusters and all(
            s["mc"] == (cfg.max_clusters if i < warm else grown)
            for i, s in enumerate(steps))):
        failed.append(f"budget {[s['mc'] for s in steps]}")
    if not steps[8]["live"] < steps[7]["live"]:
        failed.append("weight pruning at 8 killed nothing")
    if not all(s["finite"] for s in steps) or not state_finite(state):
        failed.append("a non-finite state")
    if not all(math.isfinite(s["l1"]) for s in steps):
        failed.append("a non-finite l1_diffuse")
    model = Path(cfg.model_path)
    for it in cfg.save_iterations:
        for f in (f"point_cloud/iteration_{it}/point_cloud.ply",
                  f"checkpoints/step_{it}/train_state.pt"):
            if not (model / f).is_file():
                failed.append(f"missing {f}")
    scores = csv_scores(model)
    if not all(np.isfinite(v[:, 1:]).all() for v in scores.values()):
        failed.append(f"scores {scores}")
    for k in ("trace_slots", "scatter_grads", "render_culled"):
        if launches[k] == 0:
            failed.append(f"{k} not launched")
    if len(rec["reports"]) != 1 or len(rec["renders"]) != 1 + n_test:
        failed.append(f"reports {len(rec['reports'])}, renders "
                      f"{len(rec['renders'])}")
    if failed:
        raise RuntimeError(f"phase 18: {failed}")

    # resume from step 8 in a fresh loop: iterations 9 and 10
    resumed_dir = out_dir / "resumed"
    shutil.copytree(model, resumed_dir, ignore=shutil.ignore_patterns(
        "step_10", "iteration_10"))
    cfg_r = cli_config(str(resumed_dir), CLI_SIDE, **CLI_KW)
    with probe_cli(dev) as rec_r:
        state_r, _ = train_cli(cfg_r, info, dev, resume=True)
        sync(dev)
    loaded = rec_r["loaded"]
    cap = loaded[0][1].scene.capacity if loaded else 0
    expect_mc = max(cfg.max_clusters, ttrain.grown_budget(
        cfg.max_clusters, cap, cap - cfg.init_num_pts_farfield))
    if [n for n, _ in loaded] != ["step_8"] or states_equal(
            loaded[0][1], rec["saved"]["step_8"]):
        failed.append("the loaded state is not the one saved at 8")
    if [s["bounces"] for s in rec_r["steps"]] != [2, 2]:
        failed.append(f"resumed steps {rec_r['steps']}")
    if not all(s["mc"] == expect_mc > cfg.max_clusters
               for s in rec_r["steps"]):
        failed.append(f"resumed budget {[s['mc'] for s in rec_r['steps']]}"
                      f", expected {expect_mc}")
    if not (all(s["finite"] for s in rec_r["steps"])
            and state_finite(state_r)):
        failed.append("a non-finite resumed state")
    if failed:
        raise RuntimeError(f"phase 18 resume: {failed}")
    del state, state_r, rec["saved"], rec_r["saved"], loaded
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) the card against the CPU, the same samples
    small = gbuffer_views(CLI_SMALL_N, CLI_SMALL_SIDE, n_train, n_test, dev)
    info_s = scene_info(CLI_SMALL_N, *small)

    def step_samples(d):
        def draw(i, kw):
            s = draw_tile_samples(torch.Generator().manual_seed(100 + i),
                                  kw["width"], kw["height"], kw["tile"],
                                  kw["num_bounces"] + 1)
            return TileSamples(s.jitter.to(d), s.us.to(d))
        return draw

    def render_samples(d):
        def draw(scene, kw):
            side, nb = CLI_SMALL_SIDE, kw["num_bounces"] + 1
            gen = torch.Generator().manual_seed(7)
            if kw.get("use_culling") and fused_path_ok(
                    scene, side, side, kw["cull_cluster"],
                    kw.get("composite_mode", "kbuffer")):
                s = draw_samples(gen, side, side, nb)
            else:
                s = draw_tile_samples(gen, side, side, kw["tile"], nb)
            return type(s)(s.jitter.to(d), s.us.to(d))
        return draw

    runs = {}
    for d in (dev, torch.device("cpu")):
        cfg_s = cli_config(str(out_dir / f"small_{d.type}"), CLI_SMALL_SIDE,
                           **dict(CLI_KW,
                                  init_num_pts_farfield=CLI_SMALL_FAR))
        t0 = time.perf_counter()
        with probe_cli(d, step_samples(d), render_samples(d)) as r:
            st, _ = train_cli(cfg_s, info_s, d)
        runs[d.type] = dict(state=st, rec=r, s=time.perf_counter() - t0,
                            scores=csv_scores(Path(cfg_s.model_path)))
    diff = states_equal(runs[dev.type]["state"], runs["cpu"]["state"])
    psnr_gap = max(float(np.abs(runs[dev.type]["scores"][k][:, 1:]
                                - runs["cpu"]["scores"][k][:, 1:]).max())
                   for k in ("train", "test"))
    l1s = {k: [s["l1"] for s in v["rec"]["steps"]] for k, v in runs.items()}
    if diff or psnr_gap > CLI_PSNR_DB or l1s[dev.type] != l1s["cpu"]:
        raise RuntimeError(f"phase 18 (b): the card's and the CPU's runs "
                           f"differ in {diff}; PSNR gap {psnr_gap} dB; l1 "
                           f"{l1s}")

    def regime(idx):
        return statistics.mean(it_ms[i - 1] for i in idx)

    res = dict(
        setup_s=setup_s, iteration_ms=it_ms,
        primary_only_ms=regime((2, 3)), injection_ms=it_ms[warm - 1],
        steady_ms=regime((5, 6, 7, 9)), prune_ms=it_ms[7],
        first_ms=it_ms[0], knn3_ms=[e["ms"] for e in rec["knn3"]],
        report_ms=rec["reports"][0]["ms"],
        render_ms=[e["ms"] for e in rec["renders"]],
        denoise_ms=[e["ms"] for e in rec["denoise"]],
        save_ms=[e["ms"] for e in rec["saves"]],
        injection=dict(before=inj[0]["before"], after=inj[0]["after"],
                       live=inj[0]["live"], ms=inj[0]["ms"]),
        capacity=[s["capacity"] for s in steps],
        live=[s["live"] for s in steps],
        max_clusters=[s["mc"] for s in steps], resumed_mc=expect_mc,
        l1_diffuse=[s["l1"] for s in steps],
        starved=[s["starved"] for s in steps],
        step_launches=[s["launches"] for s in steps],
        report_launches=rec["reports"][0]["launches"], launches=launches,
        overflow=[e["overflow"] for e in rec["renders"]],
        scores={k: v.tolist() for k, v in scores.items()}, peak_gb=peak_gb,
        resumed_l1=[s["l1"] for s in rec_r["steps"]],
        small=dict(s={k: v["s"] for k, v in runs.items()},
                   psnr_gap_db=psnr_gap, l1=l1s[dev.type]))
    record["phase18_cli"] = res
    ls = [(x["trace_slots"], x["scatter_grads"], x["render_culled"])
          for x in res["step_launches"]]
    print(f"phase 18: training CLI at {CLI_SIDE}x{CLI_SIDE}, room_scene("
          f"{CLI_N}) G-buffers in {n_train} train + {n_test} test views "
          f"(set up in {setup_s:.1f} s), Config defaults + {CLI_KW}: ms per "
          f"iteration {', '.join(f'{x:.1f}' for x in it_ms)}; primary-only "
          f"{res['primary_only_ms']:.1f}, injection {res['injection_ms']:.1f}"
          f", steady 2-bounce {res['steady_ms']:.1f}, prune "
          f"{res['prune_ms']:.1f} ms; knn3 "
          f"{', '.join(f'{x:.1f}' for x in res['knn3_ms'])} ms; report "
          f"{res['report_ms']:.1f} ms (renders "
          f"{', '.join(f'{x:.1f}' for x in res['render_ms'])}, denoise "
          f"{', '.join(f'{x:.1f}' for x in res['denoise_ms'])}); saves "
          f"{', '.join(f'{x:.1f}' for x in res['save_ms'])} ms; capacity "
          f"{inj[0]['before']} -> {inj[0]['after']} (live after injection "
          f"{inj[0]['live']}), live {res['live']}; max_clusters "
          f"{cfg.max_clusters} -> {grown} (resumed {expect_mc}); l1_diffuse "
          f"{', '.join(f'{x:.6f}' for x in res['l1_diffuse'])}; starved "
          f"{', '.join(f'{x:.4f}' for x in res['starved'])}; report PSNR "
          f"{res['scores']}, cull_overflow "
          f"{', '.join(f'{x:.4f}' for x in res['overflow'])}; launches a "
          f"step (trace_slots/scatter_grads/render_culled) "
          f"{ls}, a report {res['report_launches']}; peak {peak_gb:.1f} GB; "
          f"resumed at 9 from step_8 (state bit-equal), 2 bounces, "
          f"l1_diffuse {res['resumed_l1']} [{smi}]", flush=True)
    print(f"phase 18 (b): the CLI at {CLI_SMALL_SIDE}x{CLI_SMALL_SIDE}, "
          f"room_scene({CLI_SMALL_N}), {CLI_SMALL_FAR} far-field points, "
          f"card vs CPU with the same samples: final TrainStates equal bit "
          f"for bit, l1_diffuse equal at every step, CSV PSNRs within "
          f"{psnr_gap:.2f} dB; {runs[dev.type]['s']:.1f} s on the card, "
          f"{runs['cpu']['s']:.1f} s on the CPU", flush=True)
    return res


def check_loaded(data: Path, meta: dict, side: int) -> dict:
    """The dataset on disk read back by get_dataset, view by view, against
    the G-buffers it was written from (LOAD_TOL); returns the worst
    errors."""
    err = dict(rgb=0.0, scalar=0.0, pose=0.0, normal=0.0, f0_colour=0.0,
               depth_median=0.0, depth_p99=0.0, depth_max=0.0,
               depth_range=0.0)
    kinds = []
    z_ranges = iter(meta["depth"])
    for split, views in zip(("train", "test"), meta["views"]):
        ds = get_dataset(Config(resolution=side), str(data), split)
        kinds.append(type(ds).__name__)
        if len(ds) != len(views):
            raise RuntimeError(f"phase 19: {split} has {len(ds)} views, "
                               f"{len(views)} written")
        for k, view in enumerate(views):
            ci = ds[k]
            if (ci.FovX, ci.FovY) != (view.FoVx, view.FoVy):
                raise RuntimeError(f"phase 19: {split} {k} fov")
            err["pose"] = max(err["pose"],
                              float(np.abs(ci.R - view.R).max()),
                              float(np.abs(ci.T - view.T).max()))
            for a, b in ((ci.image, view.original_image),
                         (ci.diffuse_image, view.diffuse_image),
                         (ci.specular_image, view.specular_image)):
                ta, tb = (tonemap(torch.from_numpy(np.asarray(
                    x, np.float32))).numpy() for x in (a, b))
                err["rgb"] = max(err["rgb"], float(np.abs(
                    ta - np.clip(tb, 0, 1)).max()))
            m = tprior.metalness(view.f0_image)
            err["scalar"] = max(
                err["scalar"],
                float(np.abs(ci.roughness_image[..., 0] - np.clip(
                    view.roughness_image[..., 0], 0, 1)).max()),
                float(np.abs(ci.f0_image[..., 0]
                             - (0.04 * (1.0 - m) + m)).max()))
            err["f0_colour"] = max(err["f0_colour"], float(np.abs(
                ci.f0_image - view.f0_image).max()))
            n = view.normal_image
            lit = np.linalg.norm(n, axis=-1) >= 0.5
            err["normal"] = max(err["normal"], float(np.abs(
                ci.normal_image - tprior.unit(n))[lit].max()))
            t = view.depth_image[..., 0]
            hit = t > 0
            rel = np.abs(ci.depth_image[..., 0][hit] - t[hit]) / t[hit]
            err["depth_median"] = max(err["depth_median"],
                                      float(np.median(rel)))
            err["depth_p99"] = max(err["depth_p99"],
                                   float(np.percentile(rel, 99)))
            err["depth_max"] = max(err["depth_max"], float(rel.max()))
            # the fit's error is absolute in z: as a share of the view's
            # written z range, over every hit pixel
            zr = next(z_ranges)
            dz = np.abs(ci.depth_image[..., 0][hit] - t[hit]) / \
                tprior.ray_length(view)[hit]
            err["depth_range"] = max(err["depth_range"], float(
                dz.max() / (zr["z_hi"] - zr["z_lo"])))
    failed = {k: v for k, v in err.items()
              if k in LOAD_TOL and not v <= LOAD_TOL[k]}
    if failed or kinds != ["BlenderPriorDataset"] * 2:
        raise RuntimeError(f"phase 19: the loaded views {kinds} differ "
                           f"from the written ones: {failed} (bounds "
                           f"{LOAD_TOL})")
    return err


def png_read_ms(data: Path, name: str, tmp: Path) -> dict:
    """ms to read one view's buffers (the best of 3 reads each, by kind),
    and a Paeth-filtered copy of its render and depth files (the filter
    PIL's writer often picks; the port writes filter None)."""
    out = {}
    for buf in tprior.BUFFERS:
        path = data / "train" / buf / f"{buf}_{name.split('_')[-1]}.png"
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            from_png(str(path))
            ts.append((time.perf_counter() - t0) * 1e3)
        out[buf] = min(ts)
        if buf in ("render", "depth"):
            copy = tmp / f"paeth_{buf}.png"
            write_png(str(copy), read_png(str(path)), "paeth")
            t0 = time.perf_counter()
            read_png(str(copy))
            out[f"paeth_{buf}"] = (time.perf_counter() - t0) * 1e3
    return out


@contextlib.contextmanager
def cpu_drawn_samples():
    """Every frame the renderer draws for itself takes its samples from a
    CPU generator seeded as the frame's own, moved to the scene's device:
    the card and the CPU render the same samples."""
    real_fused, real_frame = rt.render_frame_fused, rt.render_frame

    def cpu_gen(generator):
        return torch.Generator().manual_seed(generator.initial_seed())

    def fused(scene, camera, settings, generator, width, height, **kw):
        if kw.get("samples") is None:
            s = draw_samples(cpu_gen(generator), width, height,
                             kw.get("num_bounces", 2) + 1,
                             kw.get("jitter", True))
            kw["samples"] = FrameSamples(*(
                None if a is None else a.to(scene.xyz.device) for a in s))
        return real_fused(scene, camera, settings, None, width, height,
                          **kw)

    def frame(scene, camera, settings, generator, width, height, **kw):
        if kw.get("samples") is None:
            s = draw_tile_samples(
                cpu_gen(generator), width, height,
                min(kw.get("tile", 8192), width * height),
                kw.get("num_bounces", 2) + 1, kw.get("jitter", True))
            kw["samples"] = TileSamples(*(
                None if a is None else a.to(scene.xyz.device) for a in s))
        return real_frame(scene, camera, settings, None, width, height, **kw)

    with contextlib.ExitStack() as stack:
        for mod in (rt, trd):
            stack.enter_context(mock.patch.object(mod, "render_frame_fused",
                                                  fused))
            stack.enter_context(mock.patch.object(mod, "render_frame",
                                                  frame))
        yield


def kw_argv(kw: dict) -> list:
    out = []
    for k, v in kw.items():
        out += [f"--{k}"] + ([str(x) for x in v] if isinstance(v, list)
                             else [str(v)])
    return out


def run_pipeline(dev, data: Path, model: Path, side: int, train_kw: dict,
                 spp: tuple, novel: list, step_samples=None) -> dict:
    """run.sh's CLIs in this process on `dev`: prepare_initial_ply (sfm),
    train, render, metrics, render_novel_views; each stage's seconds and
    its kernels' launches, the render's ms per view, the training probe's
    record, metrics.json and overflow.json."""
    device = ["--device", dev.type]
    stages, view_ms = {}, []
    iteration = train_kw["iterations"]

    def stage(name, fn, argv):
        sync(dev)
        before, t0 = launch_counts(), time.perf_counter()
        fn(argv + device)
        sync(dev)
        stages[name] = dict(
            s=time.perf_counter() - t0,
            launches={k: v - before[k] for k, v in launch_counts().items()})

    real_view = trender.render_view

    def render_view(*args, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = real_view(*args, **kw)
        sync(dev)
        view_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    stage("prepare_initial_ply", tprep.main,
          ["-s", str(data), "--mode", "sfm"])
    with probe_cli(dev, step_samples) as rec:
        stage("train", ttrain.cli,
              ["-s", str(data), "-m", str(model), "-r", str(side),
               "--init_type", "sfm"] + kw_argv(train_kw))
    with mock.patch.object(trender, "render_view", render_view):
        stage("render", trender.main,
              ["-m", str(model), "--spp", str(spp[0]), "--spp_chunk",
               str(spp[1]), "--skip_video"])
    stage("metrics", tmetrics.main,
          ["-m", str(model), "--iteration", str(iteration), "--metrics"]
          + RUN_METRICS)
    stage("render_novel_views", tnovel.main, ["-m", str(model)] + novel)
    base = model / "test" / f"ours_{iteration}"
    return dict(stages=stages, view_ms=view_ms, rec=rec,
                metrics=json.loads((model / "metrics.json").read_text()),
                overflow=json.loads((base / "overflow.json").read_text()))


def compare_runs(a: Path, b: Path, iteration: int) -> dict:
    """The card's and the CPU's model directories: PLY bytes, every PNG,
    overflow.json and metrics.json."""
    worst = dict(png_share=0.0, flip_share=0.0, metrics={})
    failed = []
    ply = Path("point_cloud") / f"iteration_{iteration}" / "point_cloud.ply"
    if (a / ply).read_bytes() != (b / ply).read_bytes():
        failed.append("trained PLYs differ")
    pngs = sorted(p.relative_to(a) for d in ("test", "novel_views")
                  for p in (a / d).rglob("*.png"))
    if pngs != sorted(p.relative_to(b) for d in ("test", "novel_views")
                      for p in (b / d).rglob("*.png")) or not pngs:
        failed.append("the PNG trees differ")
    for rel in pngs:
        x = read_png(str(a / rel)).astype(np.int16)
        y = read_png(str(b / rel)).astype(np.int16)
        d = np.abs(x - y)
        worst["png_share"] = max(worst["png_share"], float((d > 0).mean()))
        worst["flip_share"] = max(worst["flip_share"],
                                  float((d > 1).any(-1).mean()))
    if (worst["png_share"] > RUN_PNG_SHARE
            or worst["flip_share"] > RUN_FLIP_SHARE):
        failed.append(f"PNGs {worst}")
    base = Path("test") / f"ours_{iteration}" / "overflow.json"
    if (a / base).read_text() != (b / base).read_text():
        failed.append("overflow.json differs")
    ma, mb = (json.loads((m / "metrics.json").read_text()) for m in (a, b))
    for rp in mb:
        for k, tol in RUN_METRIC_TOL.items():
            gap = abs(ma[rp][k] - mb[rp][k])
            worst["metrics"][k] = max(worst["metrics"].get(k, 0.0), gap)
            if not gap <= tol + 1e-9:
                failed.append(f"{rp} {k} {ma[rp][k]} vs {mb[rp][k]}")
    if failed:
        raise RuntimeError(f"phase 19 (b): the card's and the CPU's runs "
                           f"differ: {failed}")
    return worst


def phase_run(dev, record, smi) -> dict:
    """Phase 19: run.sh from disk at CLI_SIDE (tools/prior_setup.py's
    Blender-prior dataset of phase 18's views), then at RUN_SMALL_SIDE on
    the card and on the CPU with the same samples."""
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "run_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    data, model = out_dir / "data", out_dir / "model"
    n_train, n_test = CLI_VIEWS
    t0 = time.perf_counter()
    meta = tprior.write_prior_dataset(str(data), CLI_N, CLI_SIDE, n_train,
                                      n_test, dev)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_err = check_loaded(data, meta, CLI_SIDE)
    load_s = time.perf_counter() - t0
    read_ms = png_read_ms(data, meta["names"][0], out_dir)
    del meta
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = run_pipeline(dev, data, model, CLI_SIDE, CLI_KW,
                       (RUN_SPP, RUN_SPP_CHUNK), RUN_NOVEL)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    st = run["stages"]
    failed = []
    for name, kernels in (("train", ("trace_slots", "scatter_grads")),
                          ("render", ("render_culled",)),
                          ("render_novel_views", ("trace_hits",))):
        for k in kernels:
            if not st[name]["launches"][k]:
                failed.append(f"{k} not launched by {name}")
    steps = run["rec"]["steps"]
    if len(steps) != CLI_KW["iterations"] or not all(
            s["finite"] and math.isfinite(s["l1"]) for s in steps):
        failed.append(f"training steps {len(steps)}, finite "
                      f"{[s['finite'] for s in steps]}")
    for rp, vals in run["metrics"].items():
        if sorted(vals) != sorted(["psnr", "ssim", "msssim", "lpips_rand"]) \
                or not all(math.isfinite(v) for v in vals.values()) \
                or not vals["psnr"] > 0 or not vals["lpips_rand"] >= 0:
            failed.append(f"metrics {rp} {vals}")
    if failed:
        raise RuntimeError(f"phase 19: {failed}")
    full_s = time.perf_counter() - t_phase

    # (b) the card against the CPU, the same samples
    t0 = time.perf_counter()
    small = out_dir / "small"
    tprior.write_prior_dataset(str(small / "data"), RUN_SMALL_N,
                               RUN_SMALL_SIDE, n_train, n_test, dev)
    small_kw = dict(CLI_KW, init_num_pts_farfield=RUN_SMALL_FAR)

    def step_samples(d):
        def draw(i, kw):
            s = draw_tile_samples(torch.Generator().manual_seed(100 + i),
                                  kw["width"], kw["height"], kw["tile"],
                                  kw["num_bounces"] + 1)
            return TileSamples(s.jitter.to(d), s.us.to(d))
        return draw

    small_s = {}
    for d in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        with cpu_drawn_samples():
            run_pipeline(d, small / "data", small / f"model_{d.type}",
                         RUN_SMALL_SIDE, small_kw, RUN_SMALL_SPP,
                         RUN_SMALL_NOVEL, step_samples(d))
        small_s[d.type] = time.perf_counter() - t1
    gaps = compare_runs(small / f"model_{dev.type}", small / "model_cpu",
                        CLI_KW["iterations"])
    small_total = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase

    res = dict(
        write_s=write_s, load_s=load_s, load_err=load_err, read_ms=read_ms,
        stages=st, view_ms=run["view_ms"], spp=RUN_SPP,
        iteration_ms=iteration_ms(run["rec"], run["rec"]["steps"][-1]["t0"]
                                  + run["rec"]["steps"][-1]["ms"] / 1e3),
        l1_diffuse=[s["l1"] for s in steps],
        starved=[s["starved"] for s in steps],
        overflow=run["overflow"], metrics=run["metrics"], peak_gb=peak_gb,
        full_s=full_s, small=dict(s=small_s, gaps=gaps, total_s=small_total),
        phase_s=phase_s)
    record["phase19_run"] = res
    print(f"phase 19: run.sh from disk at {CLI_SIDE}x{CLI_SIDE} "
          f"(room_scene({CLI_N}), {n_train} train + {n_test} test views, "
          f"Blender-prior layout written in {write_s:.1f} s, read back and "
          f"checked in {load_s:.1f} s: worst rgb "
          f"{load_err['rgb']:.2e}, roughness/f0 {load_err['scalar']:.2e}, "
          f"pose {load_err['pose']:.1e}, normal {load_err['normal']:.4f}, "
          f"distance relative median {load_err['depth_median']:.2e} / p99 "
          f"{load_err['depth_p99']:.2e} / max {load_err['depth_max']:.2e}"
          f", z error over the z range max {load_err['depth_range']:.2e}"
          f", f0 colour lost {load_err['f0_colour']:.3f}); PNG read ms per "
          f"file " + ", ".join(f"{k} {v:.1f}" for k, v in read_ms.items())
          + f" [{smi}]", flush=True)
    print("phase 19: stages " + "; ".join(
        f"{k} {v['s']:.1f} s (launches " + ", ".join(
            f"{n} {c}" for n, c in v["launches"].items() if c) + ")"
        for k, v in st.items())
        + f"; render {', '.join(f'{x:.1f}' for x in run['view_ms'])} ms "
        f"a view at {RUN_SPP} spp ({RUN_SPP_CHUNK} a chunk); train ms per "
        f"iteration {', '.join(f'{x:.1f}' for x in res['iteration_ms'])}; "
        f"l1_diffuse {', '.join(f'{x:.6f}' for x in res['l1_diffuse'])}; "
        f"overflow.json {run['overflow']}; metrics.json "
        f"{json.dumps(run['metrics'])}; peak {peak_gb:.1f} GB; full run "
        f"{full_s:.1f} s [{smi}]", flush=True)
    print(f"phase 19 (b): the pipeline at {RUN_SMALL_SIDE}x{RUN_SMALL_SIDE}"
          f", room_scene({RUN_SMALL_N}), {RUN_SMALL_FAR} far-field points, "
          f"render {RUN_SMALL_SPP[0]} spp, novel {RUN_SMALL_NOVEL}, card vs "
          f"CPU with the same samples: trained PLYs equal, overflow.json "
          f"equal, PNG values differing {gaps['png_share']:.4%} (by more "
          f"than a level: {gaps['flip_share']:.4%} of pixels), metrics.json"
          f" gaps {gaps['metrics']}; {small_s[dev.type]:.1f} s on the card, "
          f"{small_s['cpu']:.1f} s on the CPU; phase 19 {phase_s:.1f} s "
          f"[{smi}]", flush=True)
    return res


def viewer_counts() -> dict:
    return {k: c.launches for k, c in VIEWER_COUNTERS.items()}


class StandInSocket:
    """A websocket client for RenderService._handle: sends `requests`, then
    hangs up; keeps what the service sends."""

    def __init__(self, requests):
        self.requests = [json.dumps(r) for r in requests]
        self.sent = []

    async def recv(self):
        if not self.requests:
            raise ConnectionError("client done")
        return self.requests.pop(0)

    async def send(self, payload):
        self.sent.append(payload)

    async def close(self):
        pass


def check_replies(sent, n, side) -> list:
    """What is wrong with _handle's replies to n requests."""
    failed = []
    if len(sent) != 3 * n:
        return [f"{len(sent)} replies to {n} requests"]
    for i in range(n):
        meta, kind, frame = sent[3 * i:3 * i + 3]
        if not (isinstance(meta, str) and "viewer" in json.loads(meta)
                and json.loads(kind) == ["viewer"]
                and isinstance(frame, (bytes, bytearray))
                and len(frame) == side * side * 3):
            failed.append(f"reply {i} out of order")
    return failed


def cpu_viewer_samples(dev):
    """A ViewerState.samples hook: each frame's samples drawn from a CPU
    generator seeded as the frame's own, moved to `dev`."""
    def hook(seed, width, height, num_steps, fused, tile, jitter):
        gen = torch.Generator().manual_seed(seed)
        s = (draw_samples(gen, width, height, num_steps, jitter) if fused
             else draw_tile_samples(gen, width, height, tile, num_steps,
                                    jitter))
        return type(s)(*(None if a is None else a.to(dev) for a in s))
    return hook


def viewer_session(dev, model: Path, objects: dict, samples=None,
                   keep=False, settled=VIEWER_SETTLED, drag=VIEWER_DRAG,
                   modes=tuple(RENDER_MODES[1:]), picks=None,
                   edits=VIEWER_EDITS, tail=True) -> dict:
    """Phase 20's scripted client on ViewerState.from_ply(model) on `dev`:
    each step's tick synchronized and timed with its kernels' launches;
    returns dict(steps, failed, load_s, state, masks).  With `keep`, each
    step also keeps its G-buffers, display image and metadata on the
    host."""
    t0 = time.perf_counter()
    st = ViewerState.from_ply(str(model), device=dev)
    load_s = time.perf_counter() - t0
    st.samples = samples
    svc = RenderService(st)
    side = st.width
    mid = [side // 2, side // 2]
    room = tview.room_view()
    steps, failed = [], []
    ell = RENDER_MODES.index("Ellipsoids")

    def tick(label, request, camera=room):
        req = dict(request, camera=camera)
        sync(dev)
        before, t1 = viewer_counts(), time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            meta, rgb8 = svc.tick(req)
        sync(dev)
        rec = dict(label=label, ms=(time.perf_counter() - t1) * 1e3,
                   launches={k: v - before[k] for k, v in
                             viewer_counts().items()},
                   warned=[str(w.message)[:60] for w in caught])
        img = np.frombuffer(rgb8, np.uint8).reshape(side, side, 3)
        if meta["frame_shape"] != [side, side, 3]:
            failed.append(f"{label}: frame_shape {meta['frame_shape']}")
        if keep:
            meta = dict(meta)
            meta.pop("perf")
            rec.update(meta=meta, image=img.copy(), frame={
                k: v.cpu() for k, v in st._last_frame.items()})
        steps.append(rec)
        return meta, img

    # settled RGB ticks accumulate; the average against the ticks' frames
    frames = []
    real_dispatch = tstate.dispatch_render_frame

    def dispatch(*args, **kwargs):
        out = real_dispatch(*args, **kwargs)
        frames.append(out[1].clone())
        return out

    with mock.patch.object(tstate, "dispatch_render_frame", dispatch):
        for k in range(settled):
            tick(f"settled {k + 1}", {"viewer": {
                "render_mode": 0, "num_bounces": 2, "preview_scale": 1,
                "accumulate_samples": True}})
            if st._accum_count != k + 1:
                failed.append(f"settled {k + 1}: count {st._accum_count}")
    total = frames[0]
    for f in frames[1:]:
        total = total + f
    mean = div(total, float(len(frames))).reshape(side, side, 3)
    if len(frames) != settled or not torch.equal(
            st._last_frame["rgb"], mean) or torch.equal(frames[0],
                                                        frames[1]):
        failed.append("the accumulated frame is not the ticks' mean")
    # drag ticks: the camera moves, the preview renders scan at half size
    eye, target = np.asarray(room["camera_center"]), np.array(
        [0.0, 0.0, 2.25])
    for k in range(drag):
        a = 0.02 * (k + 1)
        rz = np.array([[math.cos(a), -math.sin(a), 0.0],
                       [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
        _, img = tick(f"drag {k + 1}", {"viewer": {"preview_scale": 2}},
                      camera=tview.look_at(rz @ eye, target))
        if not np.array_equal(img[0::2, 0::2], img[1::2, 1::2]):
            failed.append(f"drag {k + 1}: not a 2x nearest upscale")
    for name in modes:
        _, img = tick(name, {"viewer": {
            "render_mode": RENDER_MODES.index(name), "preview_scale": 1}})
        if name != "Points" and not img.any():
            failed.append(f"{name} rendered black")
    tick("Ellipsoids with floaters", {"viewer": {"render_mode": ell,
                                                 "render_floaters": True}})
    tick("Points x8", {"viewer": {"render_mode": RENDER_MODES.index(
        "Points"), "render_floaters": False, "scaling_modifier": 8.0}})
    # selections: a pick at each object's centre, by the masks and the gid
    for name, (c, r) in list(objects.items())[:picks]:
        cam = tview.object_view(c, r)
        meta, _ = tick(f"select {name}", {"viewer": {
            "render_mode": 0, "scaling_modifier": 1.0},
            "compute_selections": True, "pick": mid}, camera=cam)
        if meta["picked_object"] != name:
            failed.append(f"mask pick at {name}: {meta['picked_object']}")
        meta, _ = tick(f"raster pick {name}", {"viewer": {
            "render_mode": ell}, "pick": mid}, camera=cam)
        if meta["picked_object"] != name:
            failed.append(f"gid pick at {name}: {meta['picked_object']}")
    masks = {k: v.cpu() for k, v in st.selection_masks.items()}
    # one edit of each kind on every object; object_centers follow the
    # translation
    edited = {name: {} for name in objects}
    before = st.get_state()["object_centers"]
    for kind, fields in edits:
        for name in edited:
            edited[name].update(fields)
        meta, _ = tick(f"edit {kind}", {"viewer": {
            "render_mode": 0, "edits": copy.deepcopy(edited)}})
        if "translate_x" in fields:
            t = [fields["translate_x"], fields["translate_y"],
                 fields["translate_z"]]
            moved = {k: np.subtract(meta["object_centers"][k], before[k])
                     for k in objects}
            if not all(np.allclose(v, t, rtol=0, atol=1e-6)
                       for v in moved.values()):
                failed.append(f"object_centers moved {moved}, not {t}")
    if tail:  # remove: the object's mask comes back empty
        gone = list(objects)[-1]
        st.gaussians.remove_object(gone)
        meta, _ = tick(f"remove {gone}", {"viewer": {},
                                          "compute_selections": True,
                                          "pick": mid},
                       camera=tview.object_view(*objects[gone]))
        if meta["picked_object"] == gone or bool(
                st.selection_masks[gone].any()):
            failed.append(f"{gone} still visible after remove_object")
    # duplicate: the copies are appended unpadded, as in the JAX package
    cap = st.gaussians.base.capacity
    dup = list(objects)[0]
    n_dup = int(st.gaussians.selections[dup].sum())
    meta, _ = tick(f"duplicate {dup}", {"viewer": {}, "duplicate": dup})
    if (st.gaussians.base.capacity != cap + n_dup
            or meta["objects"] != list(objects) + [dup + "_copy"]):
        failed.append(f"duplicate: capacity {cap} -> "
                      f"{st.gaussians.base.capacity}, {meta['objects']}")
    if tail:
        meta, _ = tick("inspect + goto_camera", {
            "viewer": {}, "inspect": mid, "goto_camera": 1})
        if not (meta["inspect"] and "depth" in meta["inspect"]
                and meta["camera_jump"] == st.dataset_cameras[1]):
            failed.append(f"inspect {meta.get('inspect')}, jump "
                          f"{meta.get('camera_jump')}")
        # the pipelined handler: 4 requests, 12 replies in order
        sock = StandInSocket([{"viewer": {"render_mode": 0},
                               "camera": room} for _ in range(4)])
        sync(dev)
        before_h, t1 = viewer_counts(), time.perf_counter()
        asyncio.run(svc._handle(sock))
        sync(dev)
        steps.append(dict(label="_handle x4",
                          ms=(time.perf_counter() - t1) * 1e3,
                          launches={k: v - before_h[k] for k, v in
                                    viewer_counts().items()}, warned=[]))
        failed += check_replies(sock.sent, 4, side)
    return dict(steps=steps, failed=failed, load_s=load_s, state=st,
                masks=masks)


def compare_sessions(a: dict, b: dict) -> dict:
    """Phase 20 (b): the card's session against the CPU's."""
    worst = dict(raster=0.0, gid_share=0.0, display_levels=0)
    failed = []
    for x, y in zip(a["steps"], b["steps"]):
        if "frame" not in x:
            continue
        where = x["label"]
        raster = "gid" in y["frame"]
        for k, ref in y["frame"].items():
            got = x["frame"][k]
            if raster and k == "gid":
                share = float((got != ref).float().mean())
                worst["gid_share"] = max(worst["gid_share"], share)
                if share > VIEWER_GID_SHARE:
                    failed.append(f"{where}: gid differs at {share:.4%}")
            elif raster:
                same = (x["frame"]["gid"] == y["frame"]["gid"])[..., 0]
                d = (got - ref).abs()[same]
                err = float(d.max()) if d.numel() else 0.0
                worst["raster"] = max(worst["raster"], err)
                if err > VIEWER_RASTER_TOL:
                    failed.append(f"{where}: {k} off by {err}")
            elif not torch.equal(got, ref):
                failed.append(f"{where}: {k} not bit-equal")
        levels = int(np.abs(x["image"].astype(np.int16)
                            - y["image"]).max())
        worst["display_levels"] = max(worst["display_levels"], levels)
        if levels > 1:
            failed.append(f"{where}: display off by {levels} levels")
        mx, my = json.dumps(x["meta"], sort_keys=True), json.dumps(
            y["meta"], sort_keys=True)
        if mx != my:
            cx = x["meta"].pop("object_centers")
            cy = y["meta"].pop("object_centers")
            if json.dumps(x["meta"], sort_keys=True) != json.dumps(
                    y["meta"], sort_keys=True) or not all(
                        np.allclose(cx[k], cy[k], rtol=1e-6, atol=1e-6)
                        for k in cy):
                failed.append(f"{where}: metadata differs")
    for k, m in b["masks"].items():
        if not torch.equal(a["masks"][k], m):
            failed.append(f"selection mask {k} differs")
    if failed:
        raise RuntimeError(f"phase 20 (b): the card's and the CPU's "
                           f"sessions differ: {failed}")
    return worst


def phase_viewer_train(dev) -> dict:
    """Phase 20's train --viewer: phase 18's set-up for VIEWER_TRAIN_KW's
    iterations; the service's serve is a stand-in (this machine has no
    websockets) and a stand-in socket ticks the viewer between steps."""
    out_dir = ROOT / "build" / "viewer_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    n_train, n_test = CLI_VIEWS
    views = gbuffer_views(CLI_N, CLI_SIDE, n_train, n_test, dev)
    info = scene_info(CLI_N, *views)
    cfg = cli_config(str(out_dir / "model"), CLI_SIDE, **VIEWER_TRAIN_KW)
    services, started = [], threading.Event()
    shown, ticks = [], []
    real_step = ttrain.train_step

    def serve(self, *args, **kwargs):  # the viewer's thread
        services.append(self)
        started.set()

    def step(state, *args, **kw):
        if not started.wait(60):
            raise RuntimeError("phase 20: the viewer thread did not start")
        svc = services[0]
        shown.append(svc.state.gaussians.base is state.scene)
        sock = StandInSocket([{"viewer": {"render_mode": 0}}])
        sync(dev)
        t0 = time.perf_counter()
        asyncio.run(svc._handle(sock))
        sync(dev)
        ticks.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          failed=check_replies(sock.sent, 1,
                                               svc.state.width)))
        return real_step(state, *args, **kw)

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(tservice, "require_websockets", lambda: None), \
            mock.patch.object(RenderService, "serve", serve), \
            mock.patch.object(ttrain, "train_step", step):
        state, _ = train_cli(cfg, info, dev)
    sync(dev)
    s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    failed = [f for t in ticks for f in t["failed"]]
    if shown != [True] * cfg.iterations or not (
            services and services[0].state.gaussians.base is state.scene):
        failed.append(f"the viewer did not show each iteration: {shown}")
    if not state_finite(state):
        failed.append("a non-finite state")
    if failed:
        raise RuntimeError(f"phase 20 train --viewer: {failed}")
    return dict(s=s, tick_ms=[t["ms"] for t in ticks], peak_gb=peak_gb,
                side=services[0].state.width)


def phase_viewer(dev, record, smi) -> dict:
    """Phase 20: the viewer from disk at the Config defaults; (b) at
    VIEWER_SMALL_SIDE card vs CPU; train --viewer."""
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "viewer_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    made = tview.write_viewer_model(str(out_dir / "model"), VIEWER_N,
                                    CLI_SIDE, VIEWER_VIEWS, dev)
    write_s = time.perf_counter() - t0
    objects = {k: (c, r) for k, c, r in zip(tview.OBJECTS, made["centers"],
                                            made["radii"])}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for c in VIEWER_COUNTERS.values():
        c.launches = 0
    run = viewer_session(dev, out_dir / "model", objects)
    launches = viewer_counts()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    st, failed = run.pop("state"), run["failed"]
    sels = {k: int(v.sum()) for k, v in st.gaussians.selections.items()}
    if st.width != CLI_SIDE or len(st.dataset_cameras) != VIEWER_VIEWS \
            or not all(sels[k] for k in objects):
        failed.append(f"the model read back: {st.width}, "
                      f"{len(st.dataset_cameras)} cameras, selections {sels}")
    by = {s["label"]: s for s in run["steps"]}

    def expect(label, **counts):
        got = by[label]["launches"]
        if dev.type == "cuda" and any(got[k] != counts.get(k, 0)
                                      for k in got):
            failed.append(f"{label}: launches {got}, expected {counts}")

    for k in range(VIEWER_SETTLED):
        expect(f"settled {k + 1}", render_culled=3)
    for k in range(VIEWER_DRAG):
        expect(f"drag {k + 1}", render_scan=3)
    for mode in RENDER_MODES[1:5]:
        expect(mode, render_culled=3)
    for mode in RENDER_MODES[5:] + ["Ellipsoids with floaters", "Points x8"]:
        expect(mode)
    for name in objects:
        expect(f"select {name}", render_culled=3, trace_hits=len(objects))
        expect(f"raster pick {name}")
    dup = f"duplicate {tview.OBJECTS[0]}"
    expect(dup, trace_hits=3)
    if not any("culling disabled" in w for w in by[dup]["warned"]):
        failed.append(f"{dup}: no brute-path warning")
    if failed:
        raise RuntimeError(f"phase 20: {failed}")
    del st, run["masks"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    full_s = time.perf_counter() - t_phase

    # (b) the card against the CPU, the same samples
    t0 = time.perf_counter()
    small = out_dir / "small"
    made_s = tview.write_viewer_model(str(small), VIEWER_SMALL_N,
                                      VIEWER_SMALL_SIDE, VIEWER_VIEWS, dev)
    objects_s = {k: (c, r) for k, c, r in zip(
        tview.OBJECTS, made_s["centers"], made_s["radii"])}
    sessions, small_s = {}, {}
    for d in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        sessions[d.type] = viewer_session(d, small, objects_s,
                                          cpu_viewer_samples(d), keep=True,
                                          **VIEWER_SMALL_DEPTH)
        small_s[d.type] = time.perf_counter() - t1
        if sessions[d.type]["failed"]:
            raise RuntimeError(f"phase 20 (b) on {d.type}: "
                               f"{sessions[d.type]['failed']}")
    gaps = compare_sessions(sessions[dev.type], sessions["cpu"])
    small_total = time.perf_counter() - t0
    del sessions

    train = phase_viewer_train(dev)
    phase_s = time.perf_counter() - t_phase
    res = dict(write_s=write_s, load_s=run["load_s"], steps=run["steps"],
               launches=launches, peak_gb=peak_gb, selections=sels,
               full_s=full_s, small=dict(s=small_s, gaps=gaps,
                                         total_s=small_total),
               train=train, phase_s=phase_s)
    record["phase20_viewer"] = res
    print(f"phase 20: viewer from disk at {CLI_SIDE}x{CLI_SIDE}, "
          f"room_scene({VIEWER_N}) (model written in {write_s:.1f} s, "
          f"from_ply {run['load_s']:.1f} s; selections {sels}); ms a tick "
          f"(render_culled/render_scan/trace_hits launches): " + "; ".join(
              f"{s['label']} {s['ms']:.1f} ("
              + "/".join(str(s["launches"][k]) for k in VIEWER_COUNTERS)
              + ")" for s in run["steps"])
          + f"; launches in all {launches}; peak {peak_gb:.1f} GB; "
          f"{full_s:.1f} s [{smi}]", flush=True)
    print(f"phase 20 (b): the session at {VIEWER_SMALL_SIDE}x"
          f"{VIEWER_SMALL_SIDE}, room_scene({VIEWER_SMALL_N}), card vs CPU "
          f"with the same samples: kernel G-buffers, metadata and selection "
          f"masks equal, raster frames within {gaps['raster']:.2e} where "
          f"gid agrees, gid unequal at {gaps['gid_share']:.4%} of pixels, "
          f"display images within {gaps['display_levels']} level(s); "
          f"{small_s[dev.type]:.1f} s on the card, {small_s['cpu']:.1f} s on "
          f"the CPU", flush=True)
    print(f"phase 20: train --viewer, phase 18's set-up for "
          f"{VIEWER_TRAIN_KW['iterations']} iterations, the viewer at "
          f"{train['side']}x{train['side']} ticked between steps in "
          f"{', '.join(f'{x:.1f}' for x in train['tick_ms'])} ms, the viewer "
          f"showing each iteration's state; {train['s']:.1f} s, peak "
          f"{train['peak_gb']:.1f} GB; phase 20 {phase_s:.1f} s [{smi}]",
          flush=True)
    return res


# -- phase 21: the parallel modes --------------------------------------------


def fmt_list(xs, spec: str) -> str:
    return ", ".join(format(x, spec) for x in xs)


def rank_table(ranks: list, key: str = "ms") -> str:
    return fmt_list([r[key] for r in ranks], ".1f")


def peak_list(ranks: list) -> str:
    return ", ".join("n/a" if r["peak_gb"] is None else f"{r['peak_gb']:.2f}"
                     for r in ranks)


def rank_launches(ranks: list, *names) -> list:
    return [{n: r["launches"][n] for n in names} for r in ranks]


def total_launches(*runs) -> dict:
    """Every rank's launches over the runs, summed per kernel."""
    out = {}
    for ranks in runs:
        for r in ranks:
            for k, v in r["launches"].items():
                out[k] = out.get(k, 0) + v
    return out


def np_state_delta(a: dict, b) -> dict:
    """Largest |a - b| per field of a numpy TrainState dict `a` against a
    TrainState `b`."""
    out = {}
    for tree in ("scene", "mu", "nu"):
        for f in tr.PARAM_FIELDS:
            d = np.abs(a[tree][f].astype(np.float64)
                       - getattr(getattr(b, tree), f).cpu().numpy())
            out[f"{tree}.{f}"] = float(d.max(initial=0.0))
    out["total_weight"] = float(np.abs(
        a["total_weight"].astype(np.float64)
        - b.total_weight.cpu().numpy()).max(initial=0.0))
    return out


def why_not_equal(delta: dict) -> str:
    """np_state_delta's largest delta, its fields, and why a DP step may
    part from train_step by it."""
    top = max(delta.values())
    fields = ", ".join(k for k, v in delta.items() if v == top)
    return (f" (largest delta {top:.3g} in {fields}: the scatter's float64 "
            "atomics add in no fixed order, so a near-zero sum may round to "
            "another float32)")


def state_outside(a: dict, b) -> dict:
    """Per field of a numpy TrainState dict `a` against a TrainState `b`,
    the elements beyond PAR_STATE_RTOL * |b| + PAR_STATE_ATOL (fields with
    none left out)."""
    out = {}
    for tree in ("scene", "mu", "nu"):
        for f in tr.PARAM_FIELDS:
            ref = getattr(getattr(b, tree), f).cpu().numpy().astype(np.float64)
            d = np.abs(a[tree][f].astype(np.float64) - ref)
            n = int((d > PAR_STATE_RTOL * np.abs(ref) + PAR_STATE_ATOL).sum())
            if n:
                out[f"{tree}.{f}"] = n
    return out


def check_shard_calls(where: str, plain: list) -> list:
    """Each rank's slots-kernel call of gaussian_sharded_trace against its
    plain version on the same shard inputs (ranks.gauss_trace's `plain`),
    by phase 5's rule; per rank the comparison and the plain ms."""
    out = []
    for r, p in enumerate(plain):
        cmp = compare_slots(p["slots"], p["acc"], p["ref_slots"],
                            p["ref_acc"], p["K"])
        print_differing(f"{where} rank {r}", cmp)
        check_lanes(f"{where} rank {r}", cmp)
        if cmp["counters_equal"] < 1.0:
            raise RuntimeError(f"{where} rank {r}: ids or counters differ "
                               "from the plain version's on "
                               f"{1.0 - cmp['counters_equal']:.6%} of rays")
        out.append(dict(cmp, **{k: p[k] for k in (
            "plain_ms", "exit_mode", "candidates", "rows", "K")}))
    return out


def shard_calls_line(checks: list) -> str:
    c = checks[0]
    return (f"each rank's shard call (exit mode {c['exit_mode']}, "
            f"{c['rows']} rows, {c['candidates']} candidates) = plain "
            f"version (ids and counters equal on every ray, max abs err "
            f"{max(x['max_abs_err'] for x in checks):.3g}; plain ms per rank "
            f"{fmt_list([x['plain_ms'] for x in checks], '.0f')})")


def frame_parts(sharded: dict, steps, final, settings,
                capped=None) -> dict:
    """A sharded fused frame (numpy, from the ranks) against the single
    process's (StepOutputs, final) on the same samples, where neither
    starved: the share of rays whose final is within PAR_FRAME_TOL, bit
    for bit, the largest error; and per step (bounce) the share within
    PAR_FRAME_TOL on every output, and for the rays outside, the step at
    which they first part ("final" if no step does) and the largest
    difference of any output in the steps before it.  With `capped` [R]
    (the rays either frame capped at K: capped_flags), the rays outside
    that neither capped."""
    dev = final.device
    sf = torch.tensor(sharded["final"], device=dev)
    s_steps = {k: torch.tensor(v, device=dev)
               for k, v in sharded["steps"].items()}
    ok = ((s_steps["overflow"] == 0) & (steps.overflow == 0)).all(dim=0)

    def diff(a, b):  # per ray, the largest |a - b| (equal infinities: 0)
        d = torch.where(a == b, 0.0, (a - b).abs().float())
        return d.reshape(d.shape[0], -1).amax(dim=1)

    def within(a, b):
        e = (a == b) | ((a - b).abs() <= PAR_FRAME_TOL * b.abs()
                        + PAR_FRAME_TOL)
        return e.reshape(e.shape[0], -1).all(dim=1)

    inside = within(sf, final)
    S = steps.rgb.shape[0]
    fields = steps._fields
    step_in = torch.stack([torch.stack([
        within(s_steps[f][k], getattr(steps, f)[k]) for f in fields
    ]).all(dim=0) for k in range(S)])                          # [S, R]
    step_d = torch.stack([torch.stack([
        diff(s_steps[f][k], getattr(steps, f)[k]) for f in fields
    ]).amax(dim=0) for k in range(S)])                         # [S, R]
    out_rays = ok & ~inside
    parted = ~step_in[:, out_rays]
    first = torch.where(parted.any(dim=0), parted.float().argmax(dim=0),
                        torch.full_like(parted[0], S, dtype=torch.int64))
    before = (torch.arange(S, device=dev)[:, None] < first[None]).float()
    prior = (step_d[:, out_rays] * before).amax(dim=0)
    err = (sf - final).abs()[ok]
    n_ok = max(1, int(ok.sum()))

    def share(mask) -> float:  # of the rays not starved, counted exactly
        return int((mask & ok).sum()) / n_ok

    return dict(
        threshold=settings.transmittance_threshold,
        share_not_starved=int(ok.sum()) / ok.numel(),
        within_tol=share(inside),
        equal=share((sf == final).all(dim=1)),
        max_abs_err=float(err.max()) if err.numel() else 0.0,
        finite=bool(torch.isfinite(sf).all()),
        first_step_outside=int((ok & ~step_in[0]).sum()),
        first_step_equal=share(step_d[0] == 0),
        outside=int(out_rays.sum()),
        outside_first_parting={
            ("final" if k == S else f"step {k}"): int((first == k).sum())
            for k in range(S + 1) if int((first == k).sum())},
        outside_prior_max_diff=float(prior.max()) if prior.numel() else 0.0,
        outside_prior_equal=int((prior == 0).sum()),
        capped=None if capped is None else int((ok & capped).sum()),
        outside_uncapped=(None if capped is None
                          else int((out_rays & ~capped).sum())))


def parts_line(x: dict) -> str:
    return (f"at transmittance_threshold {x['threshold']:g} "
            f"({x['share_not_starved']:.4%} of rays not starved): within "
            f"{PAR_FRAME_TOL:g} on {x['within_tol']:.4%}, bit-equal on "
            f"{x['equal']:.4%}, max abs err {x['max_abs_err']:.3g}; step 0 "
            f"outside on {x['first_step_outside']} rays (bit-equal on "
            f"{x['first_step_equal']:.4%}); the {x['outside']} rays outside "
            f"first part at {x['outside_first_parting']}, the steps before "
            f"it at most {x['outside_prior_max_diff']:.3g} apart (bit-equal "
            f"for {x['outside_prior_equal']})"
            + ("" if x["capped"] is None else
               f"; {x['capped']} rays not starved kept K hits in either "
               f"frame, {x['outside_uncapped']} outside among the others"))


def small_jobs(cfg, settings) -> tuple:
    """(f)'s two steps at PAR_SMALL_SIDE on room_scene(PAR_SMALL_N): a DP
    step (fused, 4 ray shards) and a rays 2 x gauss 2 step."""
    side = PAR_SMALL_SIDE
    R = side * side
    scene, camera = room(PAR_SMALL_N, "cpu", seed=1)
    tg = random_targets(R, "cpu")
    lrs = tr.lr_tree(cfg, 1, 1.0)
    hyper = dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0)
    dp_samples = draw_tile_samples(torch.Generator().manual_seed(11), side,
                                   side, R // 4, 3)
    mesh_samples = draw_tile_samples(torch.Generator().manual_seed(12), side,
                                     side, R // 2, 3)
    common = dict(camera=camera, targets=tg, settings=settings, lrs=lrs,
                  hyper=hyper)
    dp = ("dp_step", host_inputs(state=tr.init_train_state(scene),
                                 samples=dp_samples, **common),
          dict(mesh={"rays": 4}, width=side, height=side, tile=R // 4,
               num_bounces=2, max_hits=cfg.max_hits, chunk=cfg.trace_chunk,
               use_pallas=True, use_culling=True, cull_tile=cfg.cull_tile,
               cull_cluster=cfg.cull_cluster,
               max_clusters=cfg.max_clusters))
    mesh2d = ("gauss_step", host_inputs(room=(PAR_SMALL_N, 2048, 1),
                                        samples=mesh_samples, **common),
              dict(mesh={"rays": 2, "gauss": 2}, width=side, height=side,
                   num_bounces=2, max_hits=cfg.max_hits, chunk=2048,
                   ray_axis="rays"))
    return dp, mesh2d


def phase_parallel(dev, record, smi) -> dict:
    """Phase 21: the parallel modes, ranks spawned on the card (all on
    cuda:0 over gloo, one rank over NCCL in (e)); module docstring."""
    t_phase = time.perf_counter()
    cfg = Config()
    settings = tr.settings_from_config(cfg)
    cpu = torch.device("cpu")
    res = {}
    t_part = [t_phase]

    def lap() -> str:
        now = time.perf_counter()
        took, t_part[0] = now - t_part[0], now
        return f"{took:.1f} s"

    # (a) the DP step and (b) the fused render, 2 ranks
    side = PAR_STEP_SIDE
    R = side * side
    tile = tr.pick_tile_size(R, cfg.ray_tile)
    step_kw = dict(num_bounces=2, max_hits=cfg.max_hits,
                   chunk=cfg.trace_chunk, tile=tile, use_pallas=True,
                   exp_power_static=float(cfg.exp_power), use_culling=True,
                   cull_tile=cfg.cull_tile, cull_cluster=cfg.cull_cluster,
                   max_clusters=cfg.max_clusters)
    scene_t, camera = room(PAR_STEP_N, dev, seed=0)
    gb, _ = render_frame_fused(scene_t, camera, settings,
                               torch.Generator(device=dev).manual_seed(3),
                               side, side, num_bounces=2, **FRAME_KW)
    targets = RayTargets(diffuse=gb.rgb[0], specular=gb.rgb[1] + gb.rgb[2],
                         depth=gb.depth[0], normal=gb.normal[0],
                         roughness=gb.roughness[0], f0=gb.f0[0])
    del scene_t, gb
    state = tr.init_train_state(room(PAR_STEP_N, dev, seed=1)[0])
    lrs = tr.lr_tree(cfg, 1, 1.0)
    hyper = dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0)
    samples = draw_tile_samples(torch.Generator().manual_seed(4), side, side,
                                tile, 3)
    step_in = host_inputs(state=state, camera=camera, targets=targets,
                          settings=settings, lrs=lrs, hyper=hyper,
                          samples=samples)
    fside = PAR_FRAME_SIDE
    frame_scene, frame_cam = room(PAR_FRAME_N, dev)
    frame_samples = draw_samples(torch.Generator().manual_seed(5), fside,
                                 fside, 3)
    frame_kw = dict(num_bounces=2, rays_per_call=PAR_RPC, **FRAME_KW)
    frame_in = host_inputs(room=(PAR_FRAME_N, 2048, 0), camera=frame_cam,
                           settings=settings, samples=frame_samples)
    settings_lo = [settings._replace(transmittance_threshold=thr)
                   for thr in PAR_FRAME_THRESHOLDS]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dp, fused, *fused_lo = spawn(run_jobs, 2, "gloo", dev, {"rays": 2}, [
        ("dp_step", step_in, dict(width=side, height=side, repeat=2,
                                  **step_kw)),
        ("render_fused", frame_in, dict(width=fside, height=fside, repeat=2,
                                        **frame_kw))] + [
        ("render_fused", dict(frame_in, settings=st),
         dict(width=fside, height=fside, **frame_kw,
              **({"capped_at": frame_kw["max_hits"]}
                 if st.transmittance_threshold == 0.0 else {})))
        for st in settings_lo])
    spawn_ab_s = time.perf_counter() - t0
    del step_in, frame_in
    one = tr.train_step(state, camera, targets, settings, lrs, hyper, None,
                        side, side, samples=moved(samples, dev), **step_kw)
    sync(dev)
    t0 = time.perf_counter()
    tr.train_step(state, camera, targets, settings, lrs, hyper, None, side,
                  side, samples=moved(samples, dev), **step_kw)
    sync(dev)
    single_ms = (time.perf_counter() - t0) * 1e3
    delta = np_state_delta(dp["state"], one[0])
    l1_single = one[1]["l1_diffuse"].item()
    if not state_finite(one[0]) or not all(
            np.isfinite(dp["state"][t][f]).all()
            for t in ("scene", "mu", "nu") for f in tr.PARAM_FIELDS):
        raise RuntimeError("phase 21 (a): non-finite state")
    if abs(float(dp["metrics"]["l1_diffuse"]) - l1_single) > 1e-6 * max(
            1e-30, abs(l1_single)):
        raise RuntimeError(f"phase 21 (a): l1 {dp['metrics']} against the "
                           f"single-process step's {l1_single}")
    outside = state_outside(dp["state"], one[0])
    if outside:
        raise RuntimeError(f"phase 21 (a): the DP state parts from "
                           f"train_step's beyond {PAR_STATE_RTOL:g} relative "
                           f"+ {PAR_STATE_ATOL:g} (elements per field "
                           f"{outside}; largest delta per field {delta})")
    ar = [r["collectives"]["all_reduce"] for r in dp["ranks"]]
    res["a"] = dict(ranks=dp["ranks"], single_ms=single_ms,
                    bit_equal=max(delta.values()) == 0.0,
                    max_delta=delta, l1=float(dp["metrics"]["l1_diffuse"]),
                    l1_single=l1_single, spawn_s=spawn_ab_s,
                    tiles_per_rank=R // tile // 2)
    del state, targets, one
    print(f"phase 21 (a): DP train step {side}x{side}, room_scene("
          f"{PAR_STEP_N}), Config defaults (K {cfg.max_hits}, cluster "
          f"{cfg.cull_cluster}, {cfg.max_clusters} candidates, tile {tile}: "
          f"{R // tile // 2} tiles a rank), 2 ranks on one card (gloo): ms a "
          f"step per rank {rank_table(dp['ranks'])} (single process "
          f"{single_ms:.1f}); all-reduce ms per rank "
          f"{fmt_list([a['ms'] for a in ar], '.1f')}, "
          f"{ar[0]['bytes'] / 1e6:.2f} MB a rank; peak GB per rank "
          f"{peak_list(dp['ranks'])}; launches per rank "
          f"{rank_launches(dp['ranks'], 'trace_slots_mode0', 'scatter_add')}"
          f"; against train_step: bit-equal {res['a']['bit_equal']}"
          f"{'' if res['a']['bit_equal'] else why_not_equal(delta)}, l1 "
          f"{res['a']['l1']:.6f}; (a) "
          f"and the fused frame's ranks {lap()} [{smi}]", flush=True)

    steps1, final1 = render_frame_fused(
        frame_scene, frame_cam, settings, None, fside, fside,
        samples=moved(frame_samples, dev), **frame_kw)
    sync(dev)
    t0 = time.perf_counter()
    render_frame_fused(frame_scene, frame_cam, settings, None, fside, fside,
                       samples=moved(frame_samples, dev), **frame_kw)
    sync(dev)
    frame_single_ms = (time.perf_counter() - t0) * 1e3
    sf = torch.tensor(fused["final"], device=dev)
    s_over = torch.tensor(fused["steps"]["overflow"], device=dev)
    ok = ((s_over == 0) & (steps1.overflow == 0)).all(dim=0)
    psnr_all = psnr_tonemapped(sf, final1)
    psnr_rest = psnr_tonemapped(sf, final1, ~ok) if (~ok).any() else math.inf
    if not bool(torch.isfinite(sf).all()) or psnr_all < PAR_FRAME_PSNR:
        raise RuntimeError(f"phase 21 (b): the sharded frame reads "
                           f"{psnr_all:.1f} dB against the single-process "
                           "frame")
    starved = [float((s_over > 0).float().mean()),
               float((steps1.overflow > 0).float().mean())]
    res["b_fused"] = dict(
        ranks=fused["ranks"], single_ms=frame_single_ms,
        psnr_all=psnr_all, psnr_starved=psnr_rest,
        starved_sharded=starved[0], starved_single=starved[1],
        thresholds=[frame_parts(fused, steps1, final1, settings)])
    ray_inv = torch.as_tensor(culling.tile_pixel_order(fside, fside, 16,
                                                       16)[1],
                              dtype=torch.int64, device=dev)
    for st, sharded in zip(settings_lo, fused_lo):
        capped = None
        (steps_lo, final_lo), caps = capped_flags(
            lambda: render_frame_fused(
                frame_scene, frame_cam, st, None, fside, fside,
                samples=moved(frame_samples, dev), **frame_kw),
            frame_kw["max_hits"])
        if "capped" in sharded:
            # the rays either frame capped at K, in linear pixel order
            n = fside * fside
            caps = caps[:, :n] | torch.tensor(
                np.concatenate(sharded["capped"], axis=1)[:, :n], device=dev)
            capped = caps.any(dim=0)[ray_inv]
        res["b_fused"]["thresholds"].append(
            frame_parts(sharded, steps_lo, final_lo, st, capped))
        del steps_lo, final_lo, caps
    parts = res["b_fused"]["thresholds"]
    bad = [x for x in parts if not x["finite"] or x["first_step_outside"]
           or (x["threshold"] == 0.0 and x["outside_uncapped"])]
    if bad:
        raise RuntimeError(
            f"phase 21 (b): the sharded frame parts from render_frame_fused's "
            f"beyond {PAR_FRAME_TOL:g} where neither starved: {bad}")
    del steps1, final1, sf, s_over, frame_scene
    print(f"phase 21 (b): sharded_render_fused {fside}x{fside}, room_scene("
          f"{PAR_FRAME_N}), k-buffer, Config defaults, rays_per_call "
          f"{PAR_RPC}, 2 ranks: ms a frame per rank "
          f"{rank_table(fused['ranks'])} (single process "
          f"{frame_single_ms:.1f}); starved (slots) sharded {starved[0]:.4%}"
          f", single {starved[1]:.4%}; tonemapped PSNR {psnr_all:.1f} dB "
          f"over all, {psnr_rest:.1f} dB over the starved; against the "
          f"single process where neither starved, "
          + "; ".join(parts_line(x) for x in parts)
          + f"; all-gather ms per rank "
          f"{fmt_list([r['collectives']['all_gather']['ms'] for r in fused['ranks']], '.1f')}"
          f" ({fused['ranks'][0]['collectives']['all_gather']['bytes'] / 1e6:.1f}"
          f" MB a rank); peak GB per rank {peak_list(fused['ranks'])}; "
          f"render_culled "
          f"launches per rank "
          f"{[r['launches']['render_culled'] for r in fused['ranks']]}; "
          f"{lap()} [{smi}]", flush=True)

    # (b) the non-fused culled render, PAR_NF_RANKS ranks
    nw, nh = NF_W, NF_H
    nR = nw * nh
    nf_scene, nf_cam = room(NF_RENDER_N, dev)
    nf_samples = draw_tile_samples(torch.Generator().manual_seed(6), nw, nh,
                                   nR // PAR_NF_RANKS, PAR_NF_BOUNCES + 1)
    nf_kw = dict(num_bounces=PAR_NF_BOUNCES, use_pallas=True,
                 use_culling=True, cull_tile=256, jitter=True, **FRAME_KW)
    nf = spawn(run_jobs, PAR_NF_RANKS, "gloo", dev,
               {"rays": PAR_NF_RANKS}, [
                   ("render", host_inputs(room=(NF_RENDER_N, 2048, 0),
                                          camera=nf_cam, samples=nf_samples),
                    dict(width=nw, height=nh, **nf_kw))])[0]
    _, nf_final = render_frame(nf_scene, nf_cam, settings, None, nw, nh,
                               tile=nR // PAR_NF_RANKS,
                               samples=moved(nf_samples, dev), **nf_kw)
    nf_equal = bool(np.array_equal(nf["final"], nf_final.cpu().numpy()))
    if not nf_equal:
        raise RuntimeError(f"phase 21 (b): sharded_render differs from "
                           f"render_frame, max abs err "
                           f"{np.abs(nf['final'] - nf_final.cpu().numpy()).max()}")
    res["b_nonfused"] = dict(ranks=nf["ranks"], equal=nf_equal)
    del nf_scene, nf_final
    print(f"phase 21 (b): sharded_render(use_pallas, use_culling) {nw}x{nh}, "
          f"room_scene({NF_RENDER_N}), {PAR_NF_BOUNCES} bounce (reduced from "
          f"phase 11's 2), {PAR_NF_RANKS} ranks of {nR // PAR_NF_RANKS} rays: "
          f"equal to render_frame; ms per rank {rank_table(nf['ranks'])}; "
          f"peak GB per rank {peak_list(nf['ranks'])}; trace_hits launches "
          f"per rank {[r['launches']['trace_hits'] for r in nf['ranks']]}; "
          f"{lap()} [{smi}]", flush=True)

    # (c) demo_5m at its defaults, 4 ranks on "gauss"
    out_dir = ROOT / "chiprun_out"
    t0 = time.perf_counter()
    demo, demo_plain = demo_5m.run(
        DEMO_ARGV + ["--device", dev.type, "--out",
                     str(out_dir / "demo_5m_torch.json")], check_plain=True)
    c_checks = check_shard_calls("phase 21 (c) trace_slots", demo_plain)
    del demo_plain
    res["c"] = dict(demo, wall_s=time.perf_counter() - t0,
                    shard_calls=c_checks)
    replicated = demo["train_state_bytes_total"]
    print(f"phase 21 (c): demo_5m, {demo['n_gaussians']} Gaussians on "
          f"{demo['n_ranks']} ranks (gloo, one card), {demo['rays']} rays, K "
          f"{demo['max_hits']}: parameter bytes per rank "
          f"{demo['param_bytes_per_rank']}, optimizer bytes per rank "
          f"{demo['opt_bytes_per_rank']}, state "
          f"{demo['train_state_bytes_max_per_rank'] / 1e9:.3f} GB at most a "
          f"rank against {replicated / 1e9:.3f} GB replicated (ratio "
          f"{demo['sharding_ratio']:.2f}); step ms per rank "
          f"{fmt_list(demo['step_ms_per_rank'], '.0f')}, peak "
          f"GB {demo['step_peak_gb_per_rank']}; traces ms per rank xla "
          f"{fmt_list(demo['trace_ms_per_rank']['xla'], '.0f')}"
          f", kernel "
          f"{fmt_list(demo['trace_ms_per_rank']['pallas'], '.0f')}"
          f", same hits on {demo['trace_rays_equal']:.2%} of rays (t max abs "
          f"err on those {demo['trace_t_max_abs_err_same_hits']:.3g}, full_T "
          f"{demo['trace_full_T_max_abs_err_same_hits']:.3g}); "
          f"{shard_calls_line(c_checks)}; launches per rank: scatter_grads "
          f"{[x['scatter_add'] for x in demo['step_launches_per_rank']]}, "
          f"trace_slots mode 1 "
          f"{[x['trace_slots_mode1'] for x in demo['trace_launches_per_rank']['pallas']]}"
          f"; {lap()} [{smi}]", flush=True)

    # (d) the 2D mesh and (f)'s card half, 4 ranks
    mside = PAR_MESH_SIDE
    mR = mside * mside
    m_scene, m_cam = room(PAR_MESH_N, dev, seed=1)
    m_scene = shard_scene(m_scene, 2)
    m_tg = random_targets(mR, dev)
    m_samples = moved(draw_tile_samples(torch.Generator().manual_seed(7),
                                        mside, mside, mR // 2, 3), dev)
    m_lrs = tr.lr_tree(cfg, 10, 3.0)
    m_hyper = dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                   apply_grads=1.0)
    m_in = host_inputs(room=(PAR_MESH_N, 2048, 1), camera=m_cam,
                       targets=m_tg, settings=settings, lrs=m_lrs,
                       hyper=m_hyper, samples=m_samples)
    dirs = primary_ray_directions(mside, mside, m_cam.fov_y, m_cam.c2w
                                  ).reshape(-1, 3)
    t_in = host_inputs(room=(PAR_MESH_N, 2048, 1), camera=m_cam,
                       rays_o=m_cam.origin.expand(mR, 3), rays_d=dirs)
    mc_all = m_scene.capacity // 2 // 256
    small_dp, small_mesh = small_jobs(cfg, settings)
    mesh2d = {"rays": 2, "gauss": 2}
    card4 = spawn(run_jobs, 4, "gloo", dev, mesh2d, [
        ("gauss_step", m_in, dict(width=mside, height=mside, num_bounces=2,
                                  max_hits=cfg.max_hits, chunk=2048,
                                  ray_axis="rays")),
        ("gauss_trace", t_in, dict(exp_power=3.0, near=ZNEAR, far=ZFAR,
                                   max_hits=cfg.max_hits, chunk=2048,
                                   use_pallas=True, cull_cluster=256,
                                   cull_tile=256, max_clusters=mc_all,
                                   plain=True)),
        small_dp, small_mesh])
    m_step, m_trace = card4[0], card4[1]
    ref_state = tr.init_train_state(m_scene)
    prep = tr.prepare_step(ref_state, m_cam, m_tg, settings, None, mside,
                           mside, 2, mR // 2, samples=m_samples)
    ref_grads, ref_l1, _ = tr.grads_over_tiles(
        m_cam.origin, prep["dirs_t"], prep["targets_t"], settings, m_cam,
        prep["us_t"], 2, cfg.max_hits, 3.0, None, None, m_scene.capacity,
        frames=prep["frames"], attrs=prep["attrs"],
        scene_for_bwd=prep["scene_for_bwd"], use_pallas=False, chunk=2048)
    del prep
    grad_cmp = {}
    for f in ref_grads._fields:
        a, b = m_step["grads"][f], getattr(ref_grads, f).cpu().numpy()
        scale = max(1e-6, float(np.abs(b).max()))
        band = np.abs(a - b) <= 1e-4 * np.abs(b) + 1e-5 * scale
        grad_cmp[f] = dict(equal=float((a == b).mean()),
                           in_band=float(band.mean()),
                           max_abs_err=float(np.abs(a - b).max()))
    l1_ref = float(ref_l1) / mR
    if (min(v["in_band"] for v in grad_cmp.values()) < 0.99
            or abs(float(m_step["metrics"]["l1_diffuse"]) - l1_ref)
            > 1e-5 * abs(l1_ref)):
        raise RuntimeError(f"phase 21 (d): the 2D-mesh step parts from the "
                           f"single-process step: {grad_cmp}, l1 "
                           f"{m_step['metrics']} vs {l1_ref}")
    frames_ref, _ = build_frames(m_scene, settings.alpha_threshold, 3.0)
    h1 = trace_rays(m_cam.origin.expand(mR, 3), dirs, frames_ref, 3.0,
                    ZNEAR, ZFAR, max_hits=cfg.max_hits, chunk=2048)
    h, h1 = m_trace["hits"], to_numpy(h1)
    d_checks = check_shard_calls("phase 21 (d) trace_slots", m_trace["plain"])
    rays_same = same_hits(h, h1)
    kept = h1["valid"] & rays_same[:, None]
    t_err = float(np.abs(h["t"] - h1["t"])[kept].max(initial=0.0))
    t_ok = bool((np.abs(h["t"] - h1["t"])[kept]
                 <= demo_5m.T_RTOL * np.abs(h1["t"][kept])
                 + demo_5m.T_ATOL).all())
    if rays_same.mean() < demo_5m.MIN_RAYS_EQUAL or not t_ok:
        raise RuntimeError(f"phase 21 (d): the kernel trace keeps other hits "
                           f"than trace_rays on {1 - rays_same.mean():.2%} "
                           f"of rays, or their depths part (t max abs err "
                           f"{t_err:.3g} on the rays with the same hits)")
    res["d"] = dict(step_ranks=m_step["ranks"], trace_ranks=m_trace["ranks"],
                    grads=grad_cmp, l1=float(m_step["metrics"]["l1_diffuse"]),
                    l1_single=l1_ref, trace_rays_equal=float(rays_same.mean()),
                    shard_calls=d_checks,
                    trace_t_max_abs_err=t_err,
                    trace_full_T_max_abs_err=float(np.abs(
                        h["full_T"] - h1["full_T"])[rays_same].max(
                            initial=0.0)))
    print(f"phase 21 (d): 2D mesh rays 2 x gauss 2 on 4 ranks, room_scene("
          f"{PAR_MESH_N}) at {mside}x{mside}, 2 bounces, K {cfg.max_hits}: "
          f"gradients against train_step(use_pallas=False, tile {mR // 2})'s "
          f"bit-equal on "
          f"{min(v['equal'] for v in grad_cmp.values()):.4%} of entries "
          f"(worst field), in the 1e-4 band on "
          f"{min(v['in_band'] for v in grad_cmp.values()):.4%}; l1 "
          f"{res['d']['l1']:.6f} vs {l1_ref:.6f}; step ms per rank "
          f"{rank_table(m_step['ranks'])}, peak GB {peak_list(m_step['ranks'])}"
          f", scatter_grads launches "
          f"{[r['launches']['scatter_add'] for r in m_step['ranks']]}; "
          f"gaussian_sharded_trace(use_pallas) vs trace_rays: same hits on "
          f"{rays_same.mean():.4%} of rays (t max abs err on those "
          f"{t_err:.3g}, full_T {res['d']['trace_full_T_max_abs_err']:.3g}); "
          f"{shard_calls_line(d_checks)}; ms "
          f"per rank {rank_table(m_trace['ranks'])}, trace_slots mode 0 "
          f"launches "
          f"{[r['launches']['trace_slots_mode0'] for r in m_trace['ranks']]}"
          f"; (d) and (f)'s card ranks {lap()} [{smi}]", flush=True)

    # (e) one rank over NCCL
    e_scene, e_cam = room(4096, dev, seed=1)
    e_tg = random_targets(64 * 64, dev, seed=2)
    e_samples = draw_tile_samples(torch.Generator().manual_seed(13), 64, 64,
                                  1024, 3)
    e_kw = dict(step_kw, tile=1024)
    backend_e = "nccl" if dev.type == "cuda" else "gloo"
    e = spawn(run_jobs, 1, backend_e, dev, {"rays": 1}, [
        ("dp_step", host_inputs(state=tr.init_train_state(e_scene),
                                camera=e_cam, targets=e_tg,
                                settings=settings, lrs=lrs, hyper=hyper,
                                samples=e_samples),
         dict(width=64, height=64, **e_kw))])[0]
    e_one = tr.train_step(tr.init_train_state(e_scene), e_cam, e_tg,
                          settings, lrs, hyper, None, 64, 64,
                          samples=moved(e_samples, dev), **e_kw)
    e_delta = np_state_delta(e["state"], e_one[0])
    if max(e_delta.values()) != 0.0:
        raise RuntimeError(f"phase 21 (e): the {backend_e} rank's step "
                           f"differs from train_step: {e_delta}")
    res["e"] = dict(backend=backend_e, ranks=e["ranks"], bit_equal=True)
    print(f"phase 21 (e): sharded_train_step on 1 rank over {backend_e} "
          f"(64x64, room_scene(4096), tile 1024): bit-equal to train_step; "
          f"ms {rank_table(e['ranks'])}; {lap()} [{smi}]", flush=True)

    # (f) card against CPU ranks at PAR_SMALL_SIDE
    cpu4 = spawn(run_jobs, 4, "gloo", cpu, mesh2d, [small_dp, small_mesh])
    f_cmp = {}
    for name, c, k in (("dp", card4[2], cpu4[0]),
                       ("mesh2d", card4[3], cpu4[1])):
        diff = []
        for tree in ("scene", "mu", "nu"):
            for f in tr.PARAM_FIELDS:
                if not np.array_equal(c["state"][tree][f], k["state"][tree][f]):
                    diff.append(f"{tree}.{f}")
        if not np.array_equal(c["state"]["total_weight"],
                              k["state"]["total_weight"]):
            diff.append("total_weight")
        f_cmp[name] = dict(differ=diff,
                           l1=[float(c["metrics"]["l1_diffuse"]),
                               float(k["metrics"]["l1_diffuse"])])
    res["f"] = f_cmp
    bad = {k: v for k, v in f_cmp.items() if v["differ"]
           or v["l1"][0] != v["l1"][1]}
    if bad:
        raise RuntimeError(f"phase 21 (f): card and CPU ranks differ: {bad}")
    phase_s = time.perf_counter() - t_phase
    res["phase_s"] = phase_s
    demo_ranks = [{"launches": x} for x in (
        demo["step_launches_per_rank"]
        + demo["trace_launches_per_rank"]["xla"]
        + demo["trace_launches_per_rank"]["pallas"])]
    res["launches"] = launches = total_launches(
        dp["ranks"], fused["ranks"], nf["ranks"], m_step["ranks"],
        m_trace["ranks"], e["ranks"], card4[2]["ranks"], card4[3]["ranks"],
        demo_ranks)
    record["phase21_parallel"] = res
    if dev.type == "cuda":
        idle = [k for k in PAR_KERNELS if launches[k] == 0]
        if idle:
            raise RuntimeError(f"phase 21: {idle} never launched in the "
                               f"parallel modes: {launches}")
    print(f"phase 21 (f): {PAR_SMALL_SIDE}x{PAR_SMALL_SIDE} DP step (4 ray "
          f"shards, fused) and rays 2 x gauss 2 step on card ranks and on CPU "
          f"ranks: states and l1 equal (CPU ranks {lap()}); phase 21 "
          f"{phase_s:.1f} s; launches "
          f"over the phase (every rank) {res['launches']} [{smi}]",
          flush=True)
    return res


# -- phase 22: split-far ----------------------------------------------------

# the scenes carry train.py's far-field shell (Config init_num_pts_farfield,
# appended as phase 18's injection appends it); the step at TRAIN_W, the
# eval frame at SPLIT_FRAME_SIDE; split-far at the far pass's Config budget
# (mc_far 32, max_hits_far 0: K 16 a far pass of the step, the near K a
# far pass of the frame)
SPLIT_FRAME_SIDE, SPLIT_FRAME_N = 800, 100_000
N_TIMED_SPLIT = 2
# the per-ray check of split against one pass: rtol, atol, and the fewest
# rays it must compare (split_mask) for the check to count
SPLIT_RTOL, SPLIT_ATOL = 1e-5, 1e-6
SPLIT_MIN_RAYS = 1000
# the fields of StepOutputs it compares (each bounce) beside the final
SPLIT_FIELDS = ("rgb", "normal", "f0", "roughness", "depth", "transmittance",
                "total_transmittance")
# (c): the fewest (ray, Gaussian) pairs the checked tiles of a windowed
# pass must walk (the busiest CHECK_TILES tiles of every pass walk 5.4e8
# (far) to 5.4e9 (near, bounce 1) on H100 80GB HBM3, 700 W)
WINDOW_MIN_PAIRS = 2.5e8
# (d): the DP split step on 2 ranks at this side
SPLIT_DP_SIDE = 256


def with_shell(scene, cfg: Config, dev, seed: int = 0):
    """`scene` with train.py's far-field shell appended: farfield_arrays on
    the orbit views (4 train + 1 test at TRAIN_W, phase 18's), their extent
    and znears, padded to lcm(trace_chunk, cull_cluster) as the culled loop
    pads it.  Returns (scene, shell rows)."""
    views = orbit_views(5, TRAIN_W, TRAIN_H)
    extent = float(getNerfppNorm(views)["radius"])
    centers = [v.camera_center for v in views[:4]]
    znears = [v.znear for v in views[:4]]
    new = tinit.farfield_arrays(cfg, extent, centers, znears,
                                np.random.default_rng(seed), device=dev)
    pad = math.lcm(cfg.trace_chunk, cfg.cull_cluster)
    return tinit.append_points(scene, new, pad_multiple=pad), len(new["xyz"])


def split_mask(single, split, capped, thr) -> torch.Tensor:
    """[R] the rays on which the split equals the single pass by
    construction: neither starved at any bounce, no pass kept as many hits
    as it has slots (`capped`: a pass dropped hits the other kept), and the
    single pass unsaturated at every bounce it ran (a saturated ray stops
    compositing at the combined transmittance in one pass and at the far
    pass's own in two, and its full_T counts hits up to its tile's exit)."""
    ok = ((single.overflow == 0) & (split.overflow == 0)).all(dim=0)
    ok &= ~capped
    live = single.alive > 0
    ok &= ((single.transmittance > thr) | ~live).all(dim=0)
    return ok


def split_parts(single, split, final_1, final_2, mask) -> dict:
    """The share of rays compared (`mask`), and on them every field of
    every bounce and the final within SPLIT_RTOL / SPLIT_ATOL: the rays
    outside (at most 10 listed) and the largest difference."""
    bad = torch.zeros_like(mask)
    worst = 0.0
    for f in SPLIT_FIELDS:
        a, b = getattr(split, f), getattr(single, f)
        d = (a - b).abs()
        far = d > SPLIT_ATOL + SPLIT_RTOL * b.abs()
        bad |= far.reshape(far.shape[0], far.shape[1], -1).any(dim=2).any(0)
        worst = max(worst, float(d[:, mask].max()) if mask.any() else 0.0)
    d = (final_2 - final_1).abs()
    bad |= (d > SPLIT_ATOL + SPLIT_RTOL * final_1.abs()).any(dim=1)
    bad &= mask
    return dict(compared=float(mask.float().mean()),
                compared_rays=int(mask.sum()), outside=int(bad.sum()),
                outside_rays=torch.nonzero(bad).flatten()[:10].tolist(),
                max_abs_diff=worst)


def timed(fn, n: int) -> tuple:
    """(ms per call over n calls after one warm-up, the last result, peak
    GB), synchronized."""
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n * 1e3, out,
            torch.cuda.max_memory_allocated() / 1e9)


def window_counts() -> list:
    """[trace_slots, render_culled, render_scan] launches by window mode."""
    return [k.launches_by_window[:]
            for k in (trace_slots, render_culled, render_scan)]


def reset_window_counts() -> None:
    for k in (trace_slots, render_culled, render_scan):
        k.launches_by_window[:] = [0, 0, 0]


def tile_rows(keep, tile: int):
    """The ray rows of the ray tiles `keep` of `tile` rays each."""
    return (keep[:, None] * tile
            + torch.arange(tile, device=keep.device)).flatten()


def busiest_tiles(call, n_tiles: int, work, cand_pos=(3, 4)):
    """(args, kwargs) of a kernel call cut to the `n_tiles` ray tiles with
    the most `work` [tiles] (in call order), and the tiles kept: the kernels
    treat tiles independently, so the rows of the cut call equal those
    tiles' rows of the whole one."""
    keep = torch.topk(work, min(n_tiles, work.numel())).indices.sort().values
    rows = tile_rows(keep, call.kwargs["tile"])
    args = list(call.args)
    for i in (0, 1):
        args[i] = args[i][rows]
    for i in cand_pos:
        args[i] = args[i][keep]
    kwargs = dict(call.kwargs)
    for k in ("alive", "t_split"):
        if kwargs.get(k) is not None:
            kwargs[k] = kwargs[k][rows]
    return args, kwargs, keep


def busiest_reference(call, reference, work, cand_pos=(3, 4),
                      n_tiles=CHECK_TILES, **extra):
    """`reference`, a kernel's plain version, on the n_tiles tiles of
    `call` with the most `work` [tiles]: (its output, those tiles' rows in
    the whole call, its ms, the tiles)."""
    args, kw, keep = busiest_tiles(call, n_tiles, work, cand_pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = reference(*args, **kw, **extra)
    torch.cuda.synchronize()
    return (ref, tile_rows(keep, call.kwargs["tile"]),
            (time.perf_counter() - t0) * 1e3, keep)


def check_window_pass(kernel, reference, call, what, K=None,
                      where="phase 22 (c)", min_pairs=WINDOW_MIN_PAIRS,
                      n_tiles=CHECK_TILES) -> dict:
    """A windowed pass's kernel against its plain version on the n_tiles
    tiles of the pass that walked the most (ray, Gaussian) pairs (phase
    5's rule for trace_slots: ids and counters equal on every ray, max abs
    err 0; bit for bit for the render kernels), with the whole pass timed.
    Fails unless those tiles walked min_pairs."""
    ms = cuda_ms(lambda: kernel(*call.args, **call.kwargs), reps=2)
    tile = call.kwargs["tile"]
    is_slots = kernel is trace_slots
    whole = kernel(*call.args, **call.kwargs)
    trav = whole[1][:, 1] if is_slots else whole[:, OUT_TRAV]
    work = trav.reshape(-1, tile).sum(dim=1)
    flops = walk_flops(call.args[0], trav, tile)
    ref, rows, plain_ms, keep = busiest_reference(
        call, reference, work, cand_pos=(5, 6) if is_slots else (3, 4),
        n_tiles=n_tiles)
    pairs = float(work[keep].sum())
    if is_slots:
        cmp = compare_slots(whole[0][rows], whole[1][rows], ref[0], ref[1],
                            K)
        print_differing(f"{where} {what}", cmp)
        if cmp["counters_equal"] < 1.0 or cmp["max_abs_err"] != 0.0:
            raise RuntimeError(f"{where} {what}: the kernel parts "
                               f"from its plain version: {cmp}")
    else:
        cmp = compare_lanes(whole[rows], ref)
        if cmp["bit_equal"] < 1.0:
            for line in differing_lanes(whole[rows], ref):
                print(f"{where} {what}: {line}", flush=True)
            raise RuntimeError(f"{where} {what}: the kernel parts "
                               f"from its plain version: {cmp}")
    if pairs < min_pairs:
        raise RuntimeError(f"{where} {what}: the checked tiles walked "
                           f"{pairs:.4g} pairs, under {min_pairs:g}")
    return dict(cmp, ms=ms, plain_ms=plain_ms, plain_rays=len(keep) * tile,
                window=call.kwargs["window_mode"],
                rays=call.args[0].shape[0], checked_pairs=pairs,
                pass_pairs=float(work.sum()), flops=flops)


def split_batch(where, state, camera, targets, settings, side, samples,
                step_kw, split_kw):
    """fused_forward split and not on the first batch of tiles a split
    training step launches (the main path's own launch), on the same rays:
    `parts`, the split's per-ray outputs against one pass where both keep
    every hit (split_parts on split_mask; fails if any ray parts or fewer
    than SPLIT_MIN_RAYS compare), each pass's starved share on the batch
    (`by_pass`), the split run's slots calls (`calls`, SplitCalls a bounce)
    and its steps, residuals and targets for the backward."""
    dev = camera.origin.device
    K, tile, mc = (step_kw[k] for k in ("max_hits", "tile", "max_clusters"))
    Kf = rt.far_hits(K, split_kw.get("max_hits_far", 0))
    prep = tr.prepare_step(state, camera, targets, settings, None, side,
                           side, 2, tile, True, True, True,
                           step_kw["cull_tile"], step_kw["cull_cluster"], mc,
                           samples=samples, **split_kw)
    n_tiles = prep["dirs_t"].shape[0]
    tpl = tr.tiles_per_launch_for(n_tiles, tile, 3, K + Kf, dev)
    rays_o, rays_d, tg, us = tr.tile_batch(
        camera.origin, prep["dirs_t"], prep["targets_t"], prep["us_t"], 0,
        tpl)
    cull = prep["culling"]
    fkw = dict(gpack=prep["gpack"], table=cull["table"],
               ftable=cull["ftable"], bounds=cull["bounds"],
               cull_tile=step_kw["cull_tile"],
               cull_cluster=step_kw["cull_cluster"], max_clusters=mc,
               n_capacity=state.scene.capacity,
               exp_power_static=step_kw["exp_power_static"], tile_rays=tile)
    del prep
    s1, f1, r1, _c1 = rt.fused_forward(rays_o, rays_d, settings, ZNEAR, ZFAR,
                                       us, 2, K, **fkw)
    s2, f2, r2, calls2 = rt.fused_forward(rays_o, rays_d, settings, ZNEAR,
                                          ZFAR, us, 2, K, **fkw, **split_kw)
    # each pass's starved share on this batch, over its bounces
    by_pass = dict(
        near=float(np.mean([float(c.starved_near.float().mean())
                            for c in calls2])),
        far=float(np.mean([float(c.starved_far.float().mean())
                           for c in calls2])),
        whole=float(s2.overflow.float().mean()))
    capped = torch.zeros(rays_o.shape[0], dtype=torch.bool, device=dev)
    for (h1, *_), (h2, *_) in zip(r1, r2):
        capped |= h1.valid[:, :K].all(dim=1)
        capped |= h2.valid[:, :K].all(dim=1) | h2.valid[:, K:].all(dim=1)
    del r1
    parts = split_parts(s1, s2, f1, f2, split_mask(
        s1, s2, capped, settings.transmittance_threshold))
    if parts["outside"] or parts["compared_rays"] < SPLIT_MIN_RAYS:
        raise RuntimeError(f"{where}: the split step parts from the single "
                           f"pass: {parts}")
    return SimpleNamespace(parts=parts, by_pass=by_pass, calls=calls2,
                           steps=s2, residuals=r2, targets=tg, K_far=Kf,
                           rays_o=rays_o)


def split_frame(where, scene, camera, settings, side, kw, split_kw,
                n_timed, required=True, single_hits=None):
    """An eval frame (dispatch_render_frame's keywords `kw`, samples
    included) split-far (`split_kw`) and in one pass (at `single_hits`
    slots where given, else kw's K): ms of each over n_timed frames, peak
    GB, starved shares (each pass's over the split bounces), the kernel's
    launches by window, and the split's per-ray outputs against one pass
    where both keep every hit (split_parts on split_mask; with `required`,
    fails if any ray parts or fewer than SPLIT_MIN_RAYS compare), its
    tonemapped PSNR against one pass; and the busiest call of each
    (kernel, bounce, window) of a split frame (busiest_calls)."""
    dev = camera.origin.device
    mode = kw.get("composite_mode", "kbuffer")
    kernel = render_culled if mode == "kbuffer" else render_scan
    K = kw["max_hits"]
    Kf = split_kw.get("max_hits_far") or K
    Ks = single_hits or K
    single_caps, split_caps, pass_starved = [], [], []
    real_epi, real_split = rt.bounce_epilogue, rt.split_bounce

    def epi(out, call, *a, **k):
        comp = unpack_composite(rt.canonical(out, call))
        single_caps.append(comp["num_accumulated"] >= Ks)
        return real_epi(out, call, *a, **k)

    def spl(*a, **k):
        comp, starved, (cn, cf) = real_split(*a, **k)
        split_caps.append((cn["num_accumulated"] >= K)
                          | (cf["num_accumulated"] >= Kf))
        pass_starved.append((float(cn["starved"].float().mean()),
                             float(cf["starved"].float().mean())))
        return comp, starved, (cn, cf)

    def frame(**extra):
        return dispatch_render_frame(scene, camera, settings, None, side,
                                     side, **{**kw, **extra})

    def single():
        return frame(max_hits=Ks)

    ms1, (fs1, ff1), _ = timed(single, n_timed)
    reset_window_counts()
    kernel.launches = 0
    ms2, (fs2, ff2), peak = timed(lambda: frame(**split_kw), n_timed)
    wc = window_counts()[1 if mode == "kbuffer" else 2]
    if wc[1] == 0 or wc[2] == 0 or wc[0]:
        raise RuntimeError(f"{where}: the split frame launched its kernel "
                           f"by window {wc}")
    with mock.patch.object(rt, "bounce_epilogue", epi):
        single()
    with mock.patch.object(rt, "split_bounce", spl), \
            busiest_calls() as seen:
        frame(**split_kw)
    ray_inv = torch.as_tensor(culling.tile_pixel_order(side, side, 16, 16)[1],
                              dtype=torch.int64, device=dev)
    capped = torch.zeros(side * side, dtype=torch.bool, device=dev)
    for c in single_caps + split_caps:
        capped |= c[:side * side][ray_inv]
    parts = split_parts(fs1, fs2, ff1, ff2, split_mask(
        fs1, fs2, capped, settings.transmittance_threshold))
    if required and (parts["outside"]
                     or parts["compared_rays"] < SPLIT_MIN_RAYS):
        raise RuntimeError(f"{where}: the split frame parts from the single "
                           f"pass: {parts}")
    res = dict(ms=ms2, single_ms=ms1, peak_gb=peak,
               starved=float(fs2.overflow.mean()),
               single_starved=float(fs1.overflow.mean()),
               starved_near=float(np.mean([n for n, _ in pass_starved])),
               starved_far=float(np.mean([f for _, f in pass_starved])),
               psnr=psnr_tonemapped(ff2, ff1), kernel=kernel.__name__,
               launches_near=wc[1], launches_far=wc[2], K=K, K_far=Kf,
               single_K=Ks, **parts)
    return res, seen


def phase_split(dev, record, smi) -> dict:
    """Phase 22: split-far on the card (module docstring)."""
    t_phase = time.perf_counter()
    cfg = Config()
    settings = tr.settings_from_config(cfg)
    res = {}

    # (a) the fused training step on the 175k room with the shell
    side = TRAIN_W
    R = side * side
    tile = tr.pick_tile_size(R, cfg.ray_tile)
    scene_t, camera = room(TRAIN_N, dev, seed=0)
    gb, _ = render_frame_fused(scene_t, camera, settings,
                               torch.Generator(device=dev).manual_seed(3),
                               side, side, num_bounces=2, **FRAME_KW)
    targets = RayTargets(diffuse=gb.rgb[0], specular=gb.rgb[1] + gb.rgb[2],
                         depth=gb.depth[0], normal=gb.normal[0],
                         roughness=gb.roughness[0], f0=gb.f0[0])
    del scene_t, gb
    base = room(TRAIN_N, dev, seed=1)[0]
    scene0, n_shell = with_shell(base, cfg, dev)
    cap = scene0.capacity
    if not slots_resident_fits(cap):
        raise RuntimeError(f"phase 22: capacity {cap} is not resident: the "
                           "step would not split")
    mc = ttrain.grown_budget(cfg.max_clusters, cap, base.capacity)
    del base
    state = tr.init_train_state(scene0)
    lrs = tr.lr_tree(cfg, 1, 1.0)
    hyper = dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0)
    K = cfg.max_hits
    Kf = rt.far_hits(K, cfg.max_hits_far)
    split_kw = dict(split_far=True, mc_far=cfg.mc_far,
                    max_hits_far=cfg.max_hits_far,
                    split_radius_scale=cfg.split_radius_scale)
    step_kw = dict(num_bounces=2, max_hits=K, chunk=cfg.trace_chunk,
                   tile=tile, use_pallas=True,
                   exp_power_static=float(cfg.exp_power), use_culling=True,
                   cull_tile=cfg.cull_tile, cull_cluster=cfg.cull_cluster,
                   max_clusters=mc)
    samples = draw_tile_samples(torch.Generator().manual_seed(4), side, side,
                                tile, 3)
    s_dev = moved(samples, dev)

    def step(**kw):
        return tr.train_step(state, camera, targets, settings, lrs, hyper,
                             None, side, side, samples=s_dev,
                             **dict(step_kw, **kw))

    reset_window_counts()
    trace_slots.launches = scatter_add.launches = 0
    split_ms, (st2, m2), split_peak = timed(lambda: step(**split_kw),
                                            N_TIMED_SPLIT)
    counts = window_counts()
    sc_launches = scatter_add.launches
    if counts[0][1] == 0 or counts[0][2] == 0 or counts[0][0] or \
            sc_launches == 0:
        raise RuntimeError(f"phase 22 (a): the split step launched "
                           f"trace_slots by window {counts[0]}, "
                           f"scatter_grads {sc_launches} times")
    single_ms, (st1, m1), single_peak = timed(lambda: step(), N_TIMED_SPLIT)
    if not (state_finite(st2) and state_finite(st1)):
        raise RuntimeError("phase 22 (a): non-finite state")

    # the per-ray check on the step's first batch of tiles
    sb = split_batch("phase 22 (a)", state, camera, targets, settings, side,
                     s_dev, step_kw, split_kw)
    parts_a, by_pass, calls2 = sb.parts, sb.by_pass, sb.calls
    rays_o = sb.rays_o
    # the scatter on this batch's split payload (K + K_far slots a ray)
    # against its plain version, by phase 5's rule
    payload, ids = rt.hit_grads(sb.steps, sb.residuals, sb.targets,
                                settings, 2, cap)
    sc = scatter_numbers("phase 22 (a)", payload, ids, cap, dev)
    del payload, ids, sb
    res["a"] = dict(
        ms=split_ms, single_ms=single_ms, peak_gb=split_peak,
        single_peak_gb=single_peak, starved=float(m2["starved"]),
        single_starved=float(m1["starved"]),
        batch_starved_near=by_pass["near"], batch_starved_far=by_pass["far"],
        batch_starved=by_pass["whole"], l1=float(m2["l1_diffuse"]),
        l1_single=float(m1["l1_diffuse"]), capacity=cap, shell=n_shell,
        max_clusters=mc, K=K, K_far=Kf, launches_near=counts[0][1],
        launches_far=counts[0][2], scatter_launches=sc_launches,
        batch_rays=rays_o.shape[0], scatter=sc, **parts_a)
    print(f"phase 22 (a): split-far training step {side}x{side}, "
          f"room_scene({TRAIN_N}) + the far-field shell ({n_shell} rows, "
          f"capacity {cap}), Config defaults, candidates {mc} (grown as "
          f"train.py grows them at the injection), mc_far {cfg.mc_far}, K "
          f"{K} + K_far {Kf}: {split_ms:.1f} ms/step (one pass "
          f"{single_ms:.1f}); starved {float(m2['starved']):.4%} (one pass "
          f"{float(m1['starved']):.4%}); peak {split_peak:.1f} GB (one pass "
          f"{single_peak:.1f}); state finite; launches trace_slots near "
          f"{counts[0][1]}, far {counts[0][2]}, scatter_grads {sc_launches}"
          f" (K + K_far = {K + Kf} slots a ray); on the first batch "
          f"({rays_o.shape[0]} rays) starved near {by_pass['near']:.4%}, far "
          f"{by_pass['far']:.4%}, whole {by_pass['whole']:.4%}; against one "
          f"pass there: {parts_a['compared']:.2%} compared (not starved, no "
          f"pass full, unsaturated), {parts_a['outside']} outside "
          f"{SPLIT_RTOL:g} rel + {SPLIT_ATOL:g}, largest difference "
          f"{parts_a['max_abs_diff']:.3g}; scatter_grads on its "
          f"{sc['rows']} slots ({sc['hits']} hits) {sc['ms']:.3f} ms (plain "
          f"{sc['plain_ms']:.3f}, index_add_ {sc['library_ms']:.3f}, bound "
          f"{sc['bound_ms']:.3f} by {sc['bound_by']}), max abs err "
          f"{sc['max_abs_err']:.3g} of scale {sc['scale']:.3g}, zeros "
          f"equal [{smi}]", flush=True)

    # (c) trace_slots in window modes 1 and 2 against its plain version:
    # the near and far pass of bounces 0 and 1 of that batch
    res["c"] = {}
    for b in (0, 1):
        for call, name in ((calls2[b].near, "near"), (calls2[b].far, "far")):
            k = call.kwargs["max_hits"]
            res["c"][f"trace_slots {name} {b}"] = check_window_pass(
                trace_slots, trace_slots_reference, call,
                f"trace_slots {name} pass, bounce {b}", K=k)
    del calls2, state, st1, st2, targets
    torch.cuda.empty_cache()

    # (b) the eval frame (bench.py's room + the shell), k-buffer and scanq
    fside = SPLIT_FRAME_SIDE
    fscene, fcam = room(SPLIT_FRAME_N, dev)
    fscene, fshell = with_shell(fscene, cfg, dev)
    fsamples = draw_samples(torch.Generator(device=dev).manual_seed(5),
                            fside, fside, 3)
    res["b"] = {}
    frame_calls = {}
    split_kw = dict(split_far=True, mc_far=cfg.mc_far,
                    max_hits_far=cfg.max_hits_far,
                    split_radius_scale=cfg.split_radius_scale)
    for mode in ("kbuffer", "scanq"):
        kw = dict(num_bounces=2, samples=fsamples, composite_mode=mode,
                  **FRAME_KW)
        res["b"][mode], frame_calls[mode] = split_frame(
            f"phase 22 (b) {mode}", fscene, fcam, settings, fside, kw,
            split_kw, N_TIMED_SPLIT, required=mode == "kbuffer")
        r = res["b"][mode]
        print(f"phase 22 (b): split-far eval frame {fside}x{fside} {mode}, "
              f"room_scene({SPLIT_FRAME_N}) + the shell ({fshell} rows, "
              f"capacity {fscene.capacity}), K {FRAME_KW['max_hits']}, "
              f"cluster {FRAME_KW['cull_cluster']}, "
              f"{FRAME_KW['max_clusters']} candidates, mc_far {cfg.mc_far}: "
              f"{r['ms']:.1f} ms/frame (one pass {r['single_ms']:.1f}); "
              f"starved near {r['starved_near']:.4%}, far "
              f"{r['starved_far']:.4%}, whole {r['starved']:.4%} (one pass "
              f"{r['single_starved']:.4%}); peak {r['peak_gb']:.1f} GB; "
              f"{r['kernel']} launches near {r['launches_near']}, far "
              f"{r['launches_far']}; against one pass: "
              f"{r['compared']:.2%} compared, {r['outside']} outside "
              f"{SPLIT_RTOL:g} rel + {SPLIT_ATOL:g}"
              + (" (the scan composites in streaming order: reported, not "
                 "required)" if mode == "scanq" else "")
              + f", tonemapped PSNR {r['psnr']:.1f} dB [{smi}]", flush=True)

    # (c) the render kernels in window modes 1 and 2 against their plain
    # versions: each frame's near and far pass of bounces 0 and 1
    for mode, seen in frame_calls.items():
        kernel, reference = ((render_culled, render_culled_reference)
                             if mode == "kbuffer" else
                             (render_scan, render_scan_reference))
        for bounce in (0, 1):
            for window, name in ((1, "near"), (2, "far")):
                _live, call = seen[(kernel.__name__, bounce, window)]
                res["c"][f"{kernel.__name__} {name} {bounce}"] = \
                    check_window_pass(kernel, reference, call,
                                      f"{kernel.__name__} {name} pass, "
                                      f"bounce {bounce}")
    del frame_calls, fscene
    torch.cuda.empty_cache()
    print("phase 22 (c): window modes 1/2 against the plain versions on "
          f"each pass's {CHECK_TILES} busiest tiles, ms a whole pass (the "
          "plain version's ms on those tiles; the pairs they walked of the "
          "pass's): "
          + "; ".join(f"{k} {v['ms']:.2f} ({v['plain_ms']:.0f}; "
                      f"{v['checked_pairs']:.3g} of {v['pass_pairs']:.3g}) "
                      f"max abs err {v['max_abs_err']:g}"
                      for k, v in res["c"].items())
          + f" [{smi}]", flush=True)

    # (d) the DP split step on 2 ranks against one process
    dside = SPLIT_DP_SIDE
    # tiles that divide a rank's shard
    dtile = tr.pick_tile_size(dside * dside // 2, cfg.ray_tile)
    dscene, _ = with_shell(room(TRAIN_N, dev, seed=1)[0], cfg, dev)
    dstate = tr.init_train_state(dscene)
    gb, _ = render_frame_fused(room(TRAIN_N, dev, seed=0)[0], camera,
                               settings,
                               torch.Generator(device=dev).manual_seed(3),
                               dside, dside, num_bounces=2, **FRAME_KW)
    dtargets = RayTargets(diffuse=gb.rgb[0], specular=gb.rgb[1] + gb.rgb[2],
                          depth=gb.depth[0], normal=gb.normal[0],
                          roughness=gb.roughness[0], f0=gb.f0[0])
    del gb
    dsamples = draw_tile_samples(torch.Generator().manual_seed(6), dside,
                                 dside, dtile, 3)
    dkw = dict(step_kw, tile=dtile, **split_kw)
    d_in = host_inputs(state=dstate, camera=camera, targets=dtargets,
                       settings=settings, lrs=lrs, hyper=hyper,
                       samples=dsamples)
    torch.cuda.empty_cache()
    (dp,) = spawn(run_jobs, 2, "gloo", dev, {"rays": 2}, [
        ("dp_step", d_in, dict(width=dside, height=dside, **dkw))])
    one = tr.train_step(dstate, camera, dtargets, settings, lrs, hyper, None,
                        dside, dside, samples=moved(dsamples, dev), **dkw)
    outside = state_outside(dp["state"], one[0])
    delta = np_state_delta(dp["state"], one[0])
    if dev.type == "cuda" and not all(
            r["launches"]["trace_slots_near"] and r["launches"][
                "trace_slots_far"] for r in dp["ranks"]):
        raise RuntimeError(f"phase 22 (d): a rank launched no windowed "
                           f"slots pass: {dp['ranks']}")
    if outside:
        raise RuntimeError(f"phase 22 (d): the DP split state parts from "
                           f"train_step's beyond {PAR_STATE_RTOL:g} relative"
                           f" + {PAR_STATE_ATOL:g}: {outside}; {delta}")
    res["d"] = dict(ranks=dp["ranks"], bit_equal=max(delta.values()) == 0.0,
                    max_delta=delta)
    print(f"phase 22 (d): DP split-far step {dside}x{dside} on 2 ranks "
          f"(gloo, one card) against train_step: bit-equal "
          f"{res['d']['bit_equal']}"
          f"{'' if res['d']['bit_equal'] else why_not_equal(delta)}; ms a "
          f"step per rank {rank_table(dp['ranks'])}; launches per rank "
          f"{rank_launches(dp['ranks'], 'trace_slots_near', 'trace_slots_far', 'scatter_add')}"
          f" [{smi}]", flush=True)
    del dstate, dscene, dtargets, one, d_in
    torch.cuda.empty_cache()

    # (e) the probe_cand_stats twin at its defaults
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        probe = tprobe.main([])
    res["e"] = probe
    print("phase 22 (e): probe_cand_stats (100k room, 800x800, cluster "
          "128, lists uncapped): mean candidates a tile, repaired / parent "
          "cull: " + "; ".join(
              f"{p} " + ", ".join(
                  f"{t}-ray {r['mean']:.1f} / {r['parent']['mean']:.1f}"
                  for t, r in rows.items())
              for p, rows in probe.items())
          + f" [{smi}]", flush=True)
    res["s"] = time.perf_counter() - t_phase
    record["phase22"] = res
    print(f"phase 22: {res['s']:.1f} s", flush=True)
    return res


# -- phase 23: the tools ------------------------------------------------------

# each tool at its defaults unless said: make_room_dataset (128x128, the
# 20k room, 10 + 2 views, 4 spp), eval_sweep (spp 1/16/128) on the model the
# training CLI fits to that dataset for CLI_KW's iterations at -r 128,
# denoiser_eval (256x256, reference 256 spp, spp 1/8/32/128),
# denoise_train (--gen and --train, cut: TOOLS_GEN_ARGV's views 16 -> 4,
# TOOLS_TRAIN_ARGV's steps 1500 -> 150), colmap2nerf on phase 19's COLMAP
# sparse model
TOOLS_ROOM_ARGV = []
TOOLS_TRAIN_KW = CLI_KW
TOOLS_SWEEP_ARGV = []
TOOLS_EVAL_ARGV = []
TOOLS_GEN_ARGV = ["--views", "4"]
TOOLS_TRAIN_ARGV = ["--steps", "150"]
TOOLS_CUTS = "views 16 -> 4, steps 1500 -> 150"
# (f): card against CPU at this side on a room of this many rows; the
# non-fused route (trace_hits) at a side the fused path refuses
TOOLS_SMALL_SIDE, TOOLS_SMALL_N, TOOLS_NF_SIDE, TOOLS_SMALL_SPP = 64, 4096, 60, 2
# colmap2nerf's poses against the dataset writer's
TOOLS_POSE_TOL = 1e-6
ASSET_KPN = (ROOT / "editable_gaussian_reflections_tpu" / "assets"
             / "denoise_kpn_v1.npz")
BLOCKED_IMAGING = {"imageio": None, "imageio.v3": None, "cv2": None,
                   "PIL": None, "PIL.Image": None}
# BlenderDataset's CameraInfo field of each buffer make_room_dataset writes
LOADED_FIELD = {"render": "image", "diffuse": "diffuse_image",
                "specular": "specular_image", "depth": "depth_image",
                "normal": "normal_image", "roughness": "roughness_image",
                "f0": "f0_image"}


def tool_run(dev, fn, argv) -> tuple:
    """fn(argv) with every kernel's count set to 0 just before and read
    just after: (its return value, the launches, seconds)."""
    for c in CLI_COUNTERS.values():
        c.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    out = fn(argv)
    sync(dev)
    return out, launch_counts(), time.perf_counter() - t0


# the (kernel, bounce) pairs a tool's run must call, the busiest call of
# each held against its plain version: a fused frame's k-buffer passes, a
# non-fused frame's traces, a training step's slots passes and scatter
FUSED_CALLS = (("render_culled", 0), ("render_culled", 1))
TRACE_CALLS = (("trace_hits", 0), ("trace_hits", 1))
STEP_CALLS = (("trace_slots", 0), ("trace_slots", 1), ("scatter_grads", None))
BOUNCE_NAMES = ("primary", "reflected")


@contextlib.contextmanager
def busiest_calls():
    """Records, of each kernel at each bounce and window mode, the call
    with the most live rays (the first among equals) under (kernel, bounce,
    window), as (live rays, call), to be held against the plain versions
    after the run: the KernelCalls that rt.kernel_call and rt.slots_call
    assemble (render_culled, render_scan, trace_slots; the bounce is their
    `step`, the live rays their `alive`), trace_hits' (args, kwargs)
    (bounce 0 for a primary trace, 1 for the first secondary one: a tile's
    bounces run in order; every ray live) and the first scatter's
    (payload, ids, capacity) under ("scatter_grads", None, 0)."""
    rec = {}
    real_k, real_s = rt.kernel_call, rt.slots_call
    real_h, real_sc = trace_mod.trace_hits, rt.scatter_add

    def assembled(real):
        def wrapper(*a, **k):
            call = real(*a, **k)
            step = a[3] if len(a) > 3 else k["step"]
            key = (call.kernel.__name__, int(step), k.get("window_mode", 0))
            alive = call.kwargs.get("alive")
            live = (call.args[0].shape[0] if alive is None
                    else int(alive.sum()))
            if key not in rec or live > rec[key][0]:
                rec[key] = (live, call)
            return call
        return wrapper

    def hits(*a, **k):
        secondary = a[8] if len(a) > 8 else k["secondary"]
        rec.setdefault(("trace_hits", int(float(secondary) > 0), 0),
                       (a[0].shape[0], (a, k)))
        return real_h(*a, **k)

    def scatter(acc, payload, ids):
        key = ("scatter_grads", None, 0)
        if key not in rec:
            rec[key] = (ids.shape[0], (payload.clone(), ids.clone(),
                                       acc.shape[0]))
        return real_sc(acc, payload, ids)

    with mock.patch.object(rt, "kernel_call", assembled(real_k)), \
            mock.patch.object(rt, "slots_call", assembled(real_s)), \
            mock.patch.object(trace_mod, "trace_hits", hits), \
            mock.patch.object(rt, "scatter_add", scatter):
        yield rec


def check_tool_calls(where: str, rec: dict, want: tuple, dev) -> dict:
    """The call of each (kernel, bounce) of `want` that busiest_calls
    recorded, held against its plain version on the card (phase 2's rule
    for render_culled and trace_hits, phase 5's for trace_slots and the
    scatter), with the kernel's and the plain version's ms and the live
    rays.  Raises when the run made one of them not."""
    missing = [w for w in want if (*w, 0) not in rec]
    if missing:
        raise RuntimeError(f"{where}: no call of {missing} was recorded "
                           f"(recorded {sorted(map(str, rec))})")
    out = {}
    for kernel, bounce in want:
        live, call = rec[(kernel, bounce, 0)]
        name = kernel if bounce is None else f"{kernel} {BOUNCE_NAMES[bounce]}"
        if kernel == "scatter_grads":
            out[name] = scatter_numbers(f"{where} {name}", *call, dev)
            continue
        if kernel == "trace_hits":
            args, kwargs = call
            run = lambda: trace_hits(*args, **kwargs)  # noqa: E731
            plain = lambda: trace_hits_reference(*args, **{  # noqa: E731
                k: v for k, v in kwargs.items() if k != "extract_attrs"})
        else:
            args, kwargs = call.args, call.kwargs
            fn, ref = ((render_culled, render_culled_reference)
                       if kernel == "render_culled"
                       else (trace_slots, trace_slots_reference))
            run = lambda: fn(*args, **kwargs)  # noqa: E731
            plain = lambda: ref(*args, **kwargs)  # noqa: E731
        ms = cuda_ms(run, reps=3)
        got = run()
        sync(dev)
        t0 = time.perf_counter()
        want_out = plain()
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if kernel == "render_culled":
            cmp = compare_lanes(got, want_out)
        elif kernel == "trace_hits":
            cmp = compare_hits(got[:5] + got[6:], want_out)
        else:
            cmp = compare_slots(*got, *want_out, kwargs["max_hits"])
        check_lanes(f"{where} {name}", cmp)
        if kernel == "trace_slots" and cmp["counters_equal"] < 1.0:
            raise RuntimeError(f"{where} {name}: ids or counters differ on "
                               f"{1 - cmp['counters_equal']:.6%} of rays: "
                               f"{cmp['differ']}")
        out[name] = dict(cmp, ms=ms, plain_ms=plain_ms,
                         rays=args[0].shape[0], live=live)
    return out


def calls_line(checks: dict) -> str:
    return "; ".join(f"{k} ({v.get('rays', v.get('rows'))} rays"
                     + (f", {v['live']} live" if "live" in v else "") + ") "
                     f"{v['ms']:.3f} ms, plain {v['plain_ms']:.1f} ms, "
                     f"max_abs_err {v['max_abs_err']:.3g}"
                     for k, v in checks.items())


def expect(where: str, got: dict, want: dict, dev) -> None:
    """Every kernel's launches as its code implies (0 where not named); on
    the card only (the CPU runs the plain versions, which count none)."""
    full = {k: want.get(k, 0) for k in got}
    if dev.type == "cuda" and got != full:
        raise RuntimeError(f"{where}: launches {got}, expected {full}")


def sha256_of(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def share_rule(a: np.ndarray, b: np.ndarray, image: bool) -> dict:
    """Card against CPU: a float buffer by the frame rule (the share of
    elements outside 2e-4*|b| + 2e-5*scale); an RGB image also tonemapped
    to 8 bits by phase 19 (b)'s PNG rule."""
    out = dict(frame_share=mismatch(torch.from_numpy(np.asarray(a)),
                                    torch.from_numpy(np.asarray(b))),
               png_share=0.0, flip_share=0.0)
    if image:
        d = np.abs(tprior.tonemapped8(a).astype(np.int16)
                   - tprior.tonemapped8(b).astype(np.int16))
        out.update(png_share=float((d > 0).mean()),
                   flip_share=float((d > 1).any(-1).mean()))
    return out


def rule_fails(name: str, r: dict) -> list:
    return ([f"{name} {r}"] if r["frame_share"] > RUN_FLIP_SHARE
            or r["png_share"] > RUN_PNG_SHARE
            or r["flip_share"] > RUN_FLIP_SHARE else [])


def tools_card_vs_cpu(dev) -> dict:
    """(f): a make_room_dataset view (fused forced, and the non-fused route
    at TOOLS_NF_SIDE: trace_hits on the card, the plain tracer on the
    CPU) and a denoiser_eval frame with its default denoise, on the card
    and on the CPU with the same samples, a small room; the share rules."""
    side, spp = TOOLS_SMALL_SIDE, TOOLS_SMALL_SPP
    eye = tmrd.orbit_eye(0, 3, 3.0)
    c2w = tmrd.look_at_blender_c2w(eye, np.array([0.0, 0.0, 2.25]))
    arrs = room_scene(TOOLS_SMALL_N, farfield_fraction=0.25)
    out, failed = dict(launches={}), []
    views, frames = {}, {}
    cpu = torch.device("cpu")
    with cpu_drawn_samples():
        for d in (dev, cpu):
            scene = from_arrays(**arrs, pad_multiple=2048, device=d)
            for fused, s in ((True, side), (False, TOOLS_NF_SIDE)):
                key = (d.type, fused)
                with busiest_calls() as rec:
                    (views[key], launches, _s) = tool_run(
                        d, lambda _: tmrd.render_view(
                            scene, c2w, eye, 1000, s, spp, fused, d), None)
                if d.type == dev.type:
                    out["launches"]["fused" if fused else "nonfused"] = \
                        launches
                    if not fused:
                        # the CPU's non-fused route is the plain tracer
                        out["calls"] = check_tool_calls(
                            "phase 23 (f)", rec,
                            TRACE_CALLS if d.type == "cuda" else (), dev)
            escene, ecam = tsynth.room(d, TOOLS_SMALL_N), tsynth.camera_at(
                *room_camera(), d)
            fr = tsynth.room_frame(escene, ecam, side, spp, tde.SEED)
            frames[d.type] = dict(
                final=fr["final"].cpu().numpy(),
                denoised=tde.denoise_specular(
                    fr["final"], fr["diffuse"], fr["normal"], fr["depth"],
                    fr["rough"], spp=spp).cpu().numpy())
    expect("phase 23 (f) fused view", out["launches"]["fused"],
           dict(render_culled=3 * spp), dev)
    expect("phase 23 (f) non-fused view", out["launches"]["nonfused"],
           dict(trace_hits=3 * spp), dev)
    rules = {}
    for fused in (True, False):
        a, b = views[(dev.type, fused)], views[("cpu", fused)]
        for buf in tmrd.BUFFERS:
            name = f"room {'fused' if fused else 'non-fused'} {buf}"
            rules[name] = share_rule(a[buf], b[buf], buf in (
                "render", "diffuse", "specular"))
            failed += rule_fails(name, rules[name])
    for k in ("final", "denoised"):
        name = f"denoiser_eval {k}"
        rules[name] = share_rule(frames[dev.type][k], frames["cpu"][k],
                                 True)
        failed += rule_fails(name, rules[name])
    if failed:
        raise RuntimeError(f"phase 23 (f): card and CPU differ: {failed}")
    out["rules"] = rules
    out["worst"] = {k: max(r[k] for r in rules.values())
                    for k in ("frame_share", "png_share", "flip_share")}
    return out


def phase_tools(dev, record, smi) -> dict:
    """Phase 23: the five tools, in-process on the card (docstring)."""
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "tools_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    res = {}
    on = ["--device", dev.type]

    # (a) make_room_dataset at its defaults, read back, trained on
    data, model = out_dir / "room", out_dir / "room_model"
    room_args = tmrd.parse_args(TOOLS_ROOM_ARGV)
    written, view_ms, route, gt = {}, [], [], {}
    real_write, real_view = tmrd.write_tiff, tmrd.render_view
    real_route = tmrd.use_fused

    def use_fused(*a, **k):
        route.append(real_route(*a, **k))
        return route[-1]

    def write(path, arr):
        written[os.path.basename(path)] = arr.copy()
        real_write(path, arr)

    def view(*a, **k):
        gt.setdefault("scene", a[0])
        sync(dev)
        t0 = time.perf_counter()
        bufs = real_view(*a, **k)
        view_ms.append((time.perf_counter() - t0) * 1e3)
        return bufs

    with mock.patch.object(tmrd, "write_tiff", write), \
            mock.patch.object(tmrd, "render_view", view), \
            mock.patch.object(tmrd, "use_fused", use_fused), \
            busiest_calls() as rec_a:
        _, launches_a, s_a = tool_run(
            dev, tmrd.main, ["--out", str(data)] + TOOLS_ROOM_ARGV + on)
    n_views = room_args.n_train + room_args.n_test
    fused = route == [True]
    frames_a = n_views * room_args.spp
    expect("phase 23 (a)", launches_a,
           dict(render_culled=3 * frames_a) if fused
           else dict(trace_hits=3 * frames_a), dev)
    t0 = time.perf_counter()
    loaded = 0
    with mock.patch.dict(sys.modules, BLOCKED_IMAGING):
        for split in ("train", "test"):
            ds = BlenderDataset(str(data), split)
            for i in range(len(ds)):
                ci = ds[i]
                for buf, field in LOADED_FIELD.items():
                    a = np.asarray(getattr(ci, field))
                    b = written[f"{split}_{buf}_{i:03d}.tiff"]
                    if a.dtype != np.float32 or a.reshape(b.shape).tobytes() \
                            != b.tobytes():
                        raise RuntimeError(f"phase 23 (a): {split} {i} {buf}"
                                           " read back differs from what "
                                           "was written")
                    loaded += 1
    load_s = time.perf_counter() - t0
    if loaded != n_views * len(LOADED_FIELD):
        raise RuntimeError(f"phase 23 (a): {loaded} buffers read back")
    checks_a = check_tool_calls("phase 23 (a)", rec_a,
                                FUSED_CALLS if fused else TRACE_CALLS, dev)
    del rec_a, written
    with probe_cli(dev) as rec_t, busiest_calls() as rec_tc:
        _, launches_t, s_t = tool_run(
            dev, ttrain.cli, ["-s", str(data), "-m", str(model), "-r",
                              str(room_args.size)]
            + kw_argv(TOOLS_TRAIN_KW) + on)
    steps = rec_t["steps"]
    failed = []
    if len(steps) != TOOLS_TRAIN_KW["iterations"] or not all(
            s["finite"] and math.isfinite(s["l1"]) for s in steps):
        failed.append(f"steps {[(s['l1'], s['finite']) for s in steps]}")
    # a step: one trace_slots launch a bounce (both 8192-ray tiles in one
    # launch), one scatter; the report's renders launch render_culled
    step_slots = sum(s["launches"]["trace_slots"] for s in steps)
    report = sum(e["launches"]["render_culled"] for e in rec_t["reports"])
    if dev.type == "cuda" and (
            step_slots != sum(1 if s["bounces"] == 0 else 3 for s in steps)
            or [s["launches"]["scatter_grads"] for s in steps]
            != [1] * len(steps)
            or launches_t != dict(trace_slots=step_slots,
                                  scatter_grads=len(steps),
                                  render_culled=report, trace_hits=0)):
        failed.append(f"launches {launches_t}, a step "
                      f"{[s['launches'] for s in steps]}")
    if failed:
        raise RuntimeError(f"phase 23 (a) training CLI: {failed}")
    checks_t = check_tool_calls("phase 23 (a) training", rec_tc,
                                STEP_CALLS + FUSED_CALLS, dev)
    del rec_tc
    # the training's last step again, its own inputs (camera, targets,
    # learning rates, the Config's kernel options at -r 128), on the
    # dataset's ground-truth scene: the fit's faint normals kill every
    # reflected ray of its steps, the ground truth's keep them live
    *step_args, step_kw = rec_t.pop("last_step")
    with busiest_calls() as rec_gt:
        tr.train_step(tr.init_train_state(gt.pop("scene")), *step_args,
                      **step_kw)
    checks_gt = check_tool_calls("phase 23 (a) ground truth", rec_gt,
                                 STEP_CALLS, dev)
    del rec_gt
    if not checks_gt["trace_slots reflected"]["live"]:
        raise RuntimeError("phase 23 (a): the ground-truth step's reflected "
                           "trace_slots call has no live ray")
    res["a"] = dict(
        s=s_a, view_ms=view_ms, fused=fused, launches=launches_a,
        load_s=load_s, buffers=loaded, calls=checks_a,
        train=dict(s=s_t, launches=launches_t,
                   l1=[s["l1"] for s in steps],
                   iteration_ms=[s["ms"] for s in steps], calls=checks_t,
                   ground_truth_calls=checks_gt))
    print(f"phase 23 (a): make_room_dataset at its defaults "
          f"({room_args.size}x{room_args.size}, room_scene("
          f"{room_args.n_gaussians}), {room_args.n_train} + "
          f"{room_args.n_test} views, {room_args.spp} spp, "
          f"{'fused' if fused else 'non-fused'} route) {s_a:.1f} s: ms a "
          f"view {fmt_list(view_ms, '.1f')}; launches {launches_a}; "
          f"{loaded} buffers read back by BlenderDataset with imageio, cv2 "
          f"and PIL blocked, equal bit for bit ({load_s:.2f} s); kernel vs "
          f"plain: {calls_line(checks_a)} [{smi}]", flush=True)
    print(f"phase 23 (a): the training CLI on it at -r {room_args.size} "
          f"({TOOLS_TRAIN_KW['iterations']} iterations) {s_t:.1f} s: ms a "
          f"step {fmt_list(res['a']['train']['iteration_ms'], '.1f')}; "
          f"l1_diffuse {fmt_list(res['a']['train']['l1'], '.6f')}; launches "
          f"{launches_t}; kernel vs plain: {calls_line(checks_t)}; its last "
          f"step's inputs on the dataset's ground-truth scene: "
          f"{calls_line(checks_gt)} [{smi}]", flush=True)

    # (b) eval_sweep on that model at its defaults
    sweep_args, _ = tsweep.parse_args(["-m", str(model)] + TOOLS_SWEEP_ARGV)
    with mock.patch.object(tsweep, "render_sweep_view",
                           wraps=tsweep.render_sweep_view) as sweep_views, \
            busiest_calls() as rec_b:
        sweep, launches_b, s_b = tool_run(
            dev, tsweep.main, ["-m", str(model)] + TOOLS_SWEEP_ARGV + on)
    n_test = sweep_views.call_count // (2 * len(sweep_args.spp))
    frames_b = 2 * n_test * sum(sweep_args.spp)
    # the route render.py's gate gives the loaded model: its Config and
    # scene as the tool handed them to its first view
    cfg_b, scene_b, *_, W_b, H_b, _spp = sweep_views.call_args_list[0].args
    fused_b = bool(trd.default_backend_kwargs(cfg_b)["use_culling"]
                   and fused_path_ok(scene_b, W_b, H_b, cfg_b.cull_cluster))
    del scene_b, sweep_views
    expect("phase 23 (b)", launches_b,
           {"render_culled" if fused_b else "trace_hits": 3 * frames_b}, dev)
    checks_b = check_tool_calls("phase 23 (b)", rec_b,
                                FUSED_CALLS if fused_b else TRACE_CALLS, dev)
    del rec_b
    sweep_json = json.loads((model / "eval_sweep.json").read_text())
    if sweep_json["results"] != sweep or not all(
            math.isfinite(v) for row in sweep.values() for v in row.values()):
        raise RuntimeError(f"phase 23 (b): eval_sweep.json {sweep_json}")
    res["b"] = dict(s=s_b, launches=launches_b, results=sweep,
                    n_views=n_test, fused=fused_b, calls=checks_b)
    print(f"phase 23 (b): eval_sweep at its defaults (spp "
          f"{sweep_args.spp}, denoise 0/1, {n_test} test views, "
          f"{'fused' if fused_b else 'non-fused'} route) {s_b:.1f} s; "
          f"launches {launches_b}; eval_sweep.json " + "; ".join(
              f"{k} {v}" for k, v in sweep.items())
          + f"; kernel vs plain: {calls_line(checks_b)} [{smi}]", flush=True)

    # (c) denoiser_eval at its defaults, beside the JAX run's figures
    eval_args = tde.parse_args(TOOLS_EVAL_ARGV)
    with busiest_calls() as rec_c:
        grid, launches_c, s_c = tool_run(
            dev, tde.main, ["--out", str(out_dir / "denoiser_eval.json")]
            + TOOLS_EVAL_ARGV + on)
    frames_c = eval_args.ref_spp + sum(eval_args.spp)
    expect("phase 23 (c)", launches_c, dict(render_culled=3 * frames_c),
           dev)
    plain = [grid[str(s)]["psnr"] for s in eval_args.spp]
    if not all(b > a for a, b in zip(plain, plain[1:])) or not (
            grid[str(eval_args.spp[0])]["gain_db"] > 0):
        raise RuntimeError(f"phase 23 (c): plain PSNR {plain} must rise with"
                           f" spp and the KPN gain at spp "
                           f"{eval_args.spp[0]} be above 0: {grid}")
    checks_c = check_tool_calls("phase 23 (c)", rec_c, FUSED_CALLS, dev)
    del rec_c
    jax_grid = json.loads((ROOT / "denoiser_eval.json").read_text())[
        "results"]
    res["c"] = dict(s=s_c, launches=launches_c, results=grid,
                    jax_results=jax_grid, calls=checks_c)
    print(f"phase 23 (c): denoiser_eval at its defaults ({eval_args.size}x"
          f"{eval_args.size}, reference {eval_args.ref_spp} spp) "
          f"{s_c:.1f} s; launches {launches_c}; spp: psnr / KPN gain / "
          f"a-trous gain / legacy gain, here and [the JAX run's "
          f"denoiser_eval.json]: " + "; ".join(
              f"{s}: {r['psnr']} / {r['gain_db']:+} / "
              f"{r['atrous_gain_db']:+} / {r['legacy_gain_db']:+} ["
              + (" / ".join(str(jax_grid[s][k]) for k in (
                  "psnr", "gain_db", "atrous_gain_db", "legacy_gain_db"))
                 if s in jax_grid else "-") + "]"
              for s, r in grid.items())
          + f"; kernel vs plain: {calls_line(checks_c)} [{smi}]", flush=True)

    # (d) denoise_train --gen, then --train, cut in depth (TOOLS_CUTS)
    gen_npz, weights = out_dir / "denoise_data.npz", out_dir / "kpn.npz"
    sha = sha256_of(ASSET_KPN)
    gen_args = tdt.parse_args(["--gen"] + TOOLS_GEN_ARGV)
    train_args = tdt.parse_args(["--train"] + TOOLS_TRAIN_ARGV)
    _, launches_g, s_g = tool_run(
        dev, tdt.main, ["--gen", "--data", str(gen_npz)] + TOOLS_GEN_ARGV
        + on)
    frames_d = gen_args.views * (gen_args.ref_spp + gen_args.noisy_per_view)
    expect("phase 23 (d) --gen", launches_g,
           dict(render_culled=3 * frames_d), dev)
    fit, launches_tr, s_tr = tool_run(
        dev, tdt.main, ["--train", "--data", str(gen_npz), "--weights",
                        str(weights)] + TOOLS_TRAIN_ARGV + on)
    expect("phase 23 (d) --train", launches_tr, {}, dev)
    back = tdn.load_params(str(weights))
    if not fit["val_l1_exact"] < fit["val_l1_init_exact"] or back is None \
            or sorted(back) != sorted(tdn.init_params(
                torch.Generator().manual_seed(0))):
        raise RuntimeError(f"phase 23 (d): val L1 {fit['val_l1_init_exact']}"
                           f" -> {fit['val_l1_exact']}, weights read back "
                           f"{None if back is None else sorted(back)}")
    if sha256_of(ASSET_KPN) != sha:
        raise RuntimeError("phase 23 (d): the shipped KPN weights changed")
    res["d"] = dict(gen_s=s_g, train_s=s_tr, launches_gen=launches_g,
                    cuts=TOOLS_CUTS, report={k: v for k, v in fit.items()
                                             if k != "history"},
                    loss=fit["history"]["loss"], val=fit["history"]["val"])
    print(f"phase 23 (d): denoise_train --gen ({gen_args.size}x"
          f"{gen_args.size}, reference {gen_args.ref_spp} spp, "
          f"{gen_args.noisy_per_view} noisy frames a view) {s_g:.1f} s, "
          f"launches {launches_g}; --train (crop {train_args.crop}, "
          f"{train_args.steps} steps) "
          f"{s_tr:.1f} s; cut: {TOOLS_CUTS}; best val L1 "
          f"{fit['val_l1_init_exact']:.6f} -> {fit['val_l1_exact']:.6f} at "
          f"step {fit['best_step']}; weights read back by load_params; the "
          f"shipped KPN's sha256 unchanged [{smi}]", flush=True)

    # (e) colmap2nerf on phase 19's COLMAP sparse model and PNG frames
    run_data = ROOT / "build" / "run_smoke" / "data"
    t0 = time.perf_counter()
    tf = tc2n.main(["--colmap_path", str(run_data), "--out",
                    str(out_dir / "transforms.json")] + on)
    written_poses = {}
    for split in ("train", "test"):
        meta = json.loads((run_data / f"transforms_{split}.json").read_text())
        for fr in meta["frames"]:
            written_poses[os.path.basename(fr["file_path"])] = np.asarray(
                fr["transform_matrix"])
    pose_err = max(float(np.abs(np.asarray(fr["transform_matrix"])
                                - written_poses[Path(fr["file_path"]).stem])
                         .max()) for fr in tf["frames"])
    if len(tf["frames"]) != len(written_poses) or not (
            pose_err <= TOOLS_POSE_TOL):
        raise RuntimeError(f"phase 23 (e): {len(tf['frames'])} frames, pose "
                           f"error {pose_err}")
    frames_dir = out_dir / "frames"
    frames_dir.mkdir()
    for png in sorted(run_data.glob("*/render/*.png")):
        shutil.copy(png, frames_dir / png.name)
    scores = {p.name: tc2n.sharpness(str(p)) for p in frames_dir.iterdir()}
    tc2n.main(["--images", str(frames_dir), "--sharpen_percent", "50"] + on)
    kept = sorted(p.name for p in frames_dir.iterdir())
    n_keep = max(1, int(len(scores) * 0.5))
    if kept != sorted(sorted(scores, key=scores.get, reverse=True)[:n_keep]):
        raise RuntimeError(f"phase 23 (e): kept {kept} of {scores}")
    res["e"] = dict(s=time.perf_counter() - t0, frames=len(tf["frames"]),
                    pose_err=pose_err, sharpness=scores, kept=kept)
    print(f"phase 23 (e): colmap2nerf on phase 19's sparse model: "
          f"{len(tf['frames'])} frames, poses within {pose_err:.2e} of the "
          f"writer's; --sharpen_percent 50 on {len(scores)} PNG frames kept "
          f"the {len(kept)} sharpest (variance of the Laplacian "
          f"{fmt_list(sorted(scores.values()), '.1f')}); "
          f"{res['e']['s']:.2f} s", flush=True)

    # (f) the card against the CPU
    res["f"] = tools_card_vs_cpu(dev)
    res["launches"] = dict(
        make_room_dataset=launches_a, train=launches_t,
        eval_sweep=launches_b, denoiser_eval=launches_c,
        denoise_train=launches_g, card_vs_cpu=res["f"]["launches"])
    res["s"] = time.perf_counter() - t_phase
    record["phase23"] = res
    print(f"phase 23 (f): card vs CPU, the same samples, room_scene("
          f"{TOOLS_SMALL_N}), {TOOLS_SMALL_SPP} spp: a make_room_dataset "
          f"view at {TOOLS_SMALL_SIDE}x{TOOLS_SMALL_SIDE} (fused, forced) and"
          f" at {TOOLS_NF_SIDE}x{TOOLS_NF_SIDE} (non-fused: trace_hits "
          f"against the plain tracer), its 7 buffers, and a denoiser_eval "
          f"frame and its denoised image: worst share outside the frame "
          f"bound {res['f']['worst']['frame_share']:.4%}, 8-bit values "
          f"differing {res['f']['worst']['png_share']:.4%}, by more than a "
          f"level {res['f']['worst']['flip_share']:.4%}; trace_hits vs plain"
          f": {calls_line(res['f']['calls'])}; phase 23 {res['s']:.1f} s "
          f"[{smi}]", flush=True)
    return res


def tools_entry(tools: dict, kernel: str, check: str) -> dict:
    """The kernels line's phase 23 keys of `kernel`: its launches by tool,
    and the tools' calls of it (`check`: their name in the checks) held
    against its plain version."""
    launches = {}
    for tool, counts in tools["launches"].items():
        if tool == "card_vs_cpu":
            for route, c in counts.items():
                launches[f"card_vs_cpu_{route}"] = c[kernel]
        else:
            launches[tool] = counts[kernel]
    calls = {f"{where} {k}": {f: v[f] for f in ("ms", "plain_ms",
                                                 "max_abs_err", "rays",
                                                 "live") if f in v}
             for where, checks in (
                 ("make_room_dataset", tools["a"]["calls"]),
                 ("train", tools["a"]["train"]["calls"]),
                 ("train_ground_truth",
                  tools["a"]["train"]["ground_truth_calls"]),
                 ("eval_sweep", tools["b"]["calls"]),
                 ("denoiser_eval", tools["c"]["calls"]),
                 ("card_vs_cpu", tools["f"]["calls"]))
             for k, v in checks.items() if k.startswith(check)}
    return dict(tools_launches=launches, tools_calls=calls,
                tools_max_abs_err=max((v["max_abs_err"]
                                       for v in calls.values()),
                                      default=None))


# -- phase 24: the k-buffer kernels at K 8 and K 64 ---------------------------

# (a) train.py's Config defaults at --max_hits K_SMALL: phase 7's step, the
# 800x800 eval frame (phase 4's room) and the training CLI at
# CLI_SMALL_SIDE; (b) split-far at bench.py's fused configuration (SPLIT_K:
# K 16, cluster 128, 96 candidates, grown as train.py grows them at the
# injection) with train.py's shell, the step's far passes at the default
# K_far (8) and the frame's at max_hits_far 8, the frame held against one
# pass at K 32; (c) tools/demo_5m.py at K 8
# runs in phase 21; (d) K_LARGE: the 800x800 eval frame at cluster 128
# (K64_FRAME), against the scan frames' bounce 0, trace_hits on phase 11's
# culled frame, trace_slots on (a)'s first batch at the Config's tile and
# cluster; the slot sort at both depths on phase 16's rays
K_SMALL, K_LARGE = 8, 64
SPLIT_K = dict(max_hits=16, cull_cluster=128, max_clusters=96,
               max_clusters_secondary=192)
K64_FRAME = dict(max_hits=K_LARGE, cull_cluster=128, max_clusters=192)
# phase 24 holds each pass against its plain version on this many of its
# busiest tiles; the checked tiles of a windowed pass of (b) must walk at
# least K_WINDOW_MIN_PAIRS (cluster 128 and 96 candidates walk fewer than
# phase 22's passes)
K_CHECK_TILES = 64
K_WINDOW_MIN_PAIRS = 2.5e7
# the wrappers of the kernels built per K, each counting its launches by K
K_COUNTERS = {"render_culled": render_culled, "trace_slots": trace_slots,
              "trace_hits": trace_hits, "render_table": render_culled_table,
              "sort_slots": sort_slots_aux}


@contextlib.contextmanager
def driven(tally: dict, dev):
    """Every K_COUNTERS count by K at 0 before the block (a path phase 24
    drives), and the counts read after it added to tally[kernel][K]."""
    for c in K_COUNTERS.values():
        c.launches_by_k.update(dict.fromkeys(SUPPORTED_K, 0))
    yield
    sync(dev)
    for name, c in K_COUNTERS.items():
        for K, n in c.launches_by_k.items():
            tally[name][K] += n


def walk_k_info(kernel: str, call) -> dict:
    """What the runtime reports of the kernel a call launches (kernel_info
    at its K, tile, cluster, backfacing test and exit mode, or trace_slots'
    windowed kernel)."""
    kw = call.kwargs
    exit_mode = (2 if kernel == "trace_slots" and kw.get("window_mode", 0)
                 else kw.get("exit_mode", 0))
    return kernel_info(kw["max_hits"],
                       backfacing=kw.get("secondary_static", 0) != 0,
                       tile=kw["tile"], cluster=kw["cluster"], kernel=kernel,
                       exit_mode=exit_mode)


def walk_work(call, work) -> str:
    """A walk's work as phase 24 prints it."""
    kw = call.kwargs
    return (f"{call.args[0].shape[0]} rays, tile {kw['tile']}, cluster "
            f"{kw['cluster']}, {float(work.sum()):.4g} pairs")


def render_k(where: str, call, table: dict | None = None) -> dict:
    """render_culled on a pass, or with `table` (a tally) render_culled_table
    on its rays and candidates (table_call; one launch a pass, as phase 13
    runs it, counted in the tally): ms (CUDA events), pairs, bound and the
    bytes it writes; held against its plain version on the pass's
    K_CHECK_TILES busiest tiles bit for bit; what the runtime reports of
    it."""
    if table is None:
        kernel, reference, n_in, cand_pos = (render_culled,
                                             render_culled_reference, 5,
                                             (3, 4))
        out = render_culled(*call.args, **call.kwargs)
    else:
        call = table_call(call, attr_table(call.args[2]))
        kernel, reference, n_in, cand_pos = (render_culled_table,
                                             render_culled_table_reference,
                                             6, (4, 5))
        with driven(table, call.args[0].device):
            out = kernel(*call.args, **call.kwargs)
    ms = cuda_ms(lambda: kernel(*call.args, **call.kwargs), reps=3)
    tile = call.kwargs["tile"]
    work = out[:, OUT_TRAV].reshape(-1, tile).sum(dim=1)
    ref, rows, plain_ms, keep = busiest_reference(
        call, reference, work, cand_pos=cand_pos, n_tiles=K_CHECK_TILES)
    cmp = compare_lanes(out[rows], ref)
    if cmp["bit_equal"] < 1.0:
        for line in differing_lanes(out[rows], ref):
            print(f"{where}: {line}", flush=True)
        raise RuntimeError(f"{where}: {kernel.__name__} parts from its "
                           f"plain version: {cmp}")
    b_ms, b_by = bound(walk_flops(call.args[0], out[:, OUT_TRAV], tile),
                       PEAK_FP32, nbytes(*call.args[:n_in],
                                         call.kwargs.get("alive"), out))
    return dict(kernel="render_culled" if table is None else "render_table",
                K=call.kwargs["max_hits"], ms=ms, work=walk_work(call, work),
                checked=f"its {len(keep)} busiest tiles",
                pairs=work.sum().item(),
                bound_ms=b_ms, bound_by=b_by, written_gb=nbytes(out) / 1e9,
                plain_ms=plain_ms, plain_tiles=len(keep),
                max_abs_err=cmp["max_abs_err"], rays=call.args[0].shape[0],
                tile=tile, cluster=call.kwargs["cluster"],
                info=(walk_k_info("render_culled", call) if table is None
                      else None))


def slots_k(where: str, call, K: int = 0) -> dict:
    """trace_slots on a call (at K in place of its own, when given): ms a
    pass, pairs, bound and the bytes it writes (37 K floats a ray and the
    counters); held against its plain version on the pass's K_CHECK_TILES
    busiest tiles by phase 5's rule (ids and counters equal on every ray,
    max abs err 0); what the runtime reports of it."""
    call = SimpleNamespace(args=call.args, kwargs=dict(
        call.kwargs, max_hits=K or call.kwargs["max_hits"]))
    kw = call.kwargs
    ms = cuda_ms(lambda: trace_slots(*call.args, **kw), reps=2)
    out, acc = trace_slots(*call.args, **kw)
    tile = kw["tile"]
    work = acc[:, 1].reshape(-1, tile).sum(dim=1)
    (ref, ref_acc), rows, plain_ms, keep = busiest_reference(
        call, trace_slots_reference, work, cand_pos=(5, 6),
        n_tiles=K_CHECK_TILES)
    cmp = compare_slots(out[rows], acc[rows], ref, ref_acc, kw["max_hits"])
    print_differing(where, cmp)
    if cmp["counters_equal"] < 1.0 or cmp["max_abs_err"] != 0.0:
        raise RuntimeError(f"{where}: trace_slots parts from its plain "
                           f"version: {cmp}")
    b_ms, b_by = bound(walk_flops(call.args[0], acc[:, 1], tile), PEAK_FP32,
                       nbytes(*call.args[:7], kw.get("alive"), out, acc))
    res = dict(kernel="trace_slots", K=kw["max_hits"], ms=ms,
               work=walk_work(call, work),
               checked=f"its {len(keep)} busiest tiles",
               pairs=work.sum().item(), bound_ms=b_ms, bound_by=b_by,
               written_gb=nbytes(out, acc) / 1e9, plain_ms=plain_ms,
               plain_tiles=len(keep), max_abs_err=cmp["max_abs_err"],
               rays=call.args[0].shape[0], tile=tile, cluster=kw["cluster"],
               info=walk_k_info("trace_slots", call))
    del out, acc, ref, ref_acc
    return res


def window_k(where: str, kernel, reference, call) -> dict:
    """A windowed pass of (b) by check_window_pass, with what the runtime
    reports of its kernel and the bytes it writes."""
    r = check_window_pass(kernel, reference, call,
                          f"{kernel.__name__} K {call.kwargs['max_hits']}",
                          K=call.kwargs["max_hits"], where=where,
                          min_pairs=K_WINDOW_MIN_PAIRS,
                          n_tiles=K_CHECK_TILES)
    name = kernel.__name__
    K, R = call.kwargs["max_hits"], call.args[0].shape[0]
    lanes = SLOT_BLOCKS * K + 16 if kernel is trace_slots else 16
    n_in = 7 if kernel is trace_slots else 5
    b_ms, b_by = bound(r["flops"], PEAK_FP32,
                       nbytes(*call.args[:n_in], call.kwargs.get("alive"),
                              call.kwargs.get("t_split")) + 4 * R * lanes)
    return dict(r, kernel=name, K=K, bound_ms=b_ms, bound_by=b_by,
                work=(f"{R} rays, tile {call.kwargs['tile']}, cluster "
                      f"{call.kwargs['cluster']}, window {r['window']}, "
                      f"{r['pass_pairs']:.4g} pairs"),
                written_gb=4 * R * lanes / 1e9,
                checked=f"its {K_CHECK_TILES} busiest tiles",
                info=walk_k_info(name, call))


def k_line(where: str, r: dict, smi: str) -> None:
    """One (kernel, K) line of phase 24: ms, the work and bound, the bytes
    written, what the runtime reports of the kernel, the plain check."""
    info = r.get("info")
    kinfo = (f"{info['registers']} registers, {info['local_bytes']} B local, "
             f"{info['smem_bytes']} B shared, {info['blocks_per_sm']} blocks "
             f"per SM" if info else "no kernel_info entry point")
    print(f"{where}: {r['kernel']} K {r['K']}: {r['ms']:.3f} ms ("
          f"{r['work']}; bound {r['bound_ms']:.3f} ms by {r['bound_by']}), "
          f"writes {r['written_gb']:.3f} GB; {kinfo}; = plain on "
          f"{r['checked']} ({r['plain_ms']:.0f} ms), max abs err "
          f"{r['max_abs_err']:g} [{smi}]", flush=True)


def cli_k(where: str, K: int, small, tally: dict, dev, smi) -> tuple:
    """The training CLI at CLI_SMALL_SIDE at --max_hits K (phase 18 (b)'s
    set-up), a driven path; its launches, the report's, and its busiest
    calls."""
    out_dir = ROOT / "build" / "cli_smoke" / f"k{K}"
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = cli_config(str(out_dir), CLI_SMALL_SIDE, **dict(
        CLI_KW, init_num_pts_farfield=CLI_SMALL_FAR, max_hits=K))
    for c in CLI_COUNTERS.values():
        c.launches = 0
    t0 = time.perf_counter()
    with driven(tally, dev), probe_cli(dev) as rec, busiest_calls() as seen:
        st, _ = train_cli(cfg, scene_info(CLI_SMALL_N, *small), dev)
    s = time.perf_counter() - t0
    cl = launch_counts()
    report = rec["reports"][0]["launches"]
    if not (cl["trace_slots"] and cl["scatter_grads"]
            and report["render_culled"] and state_finite(st)
            and all(math.isfinite(x["l1"]) for x in rec["steps"])):
        raise RuntimeError(f"{where}: the CLI at --max_hits {K}: launches "
                           f"{cl}, its report's {report}")
    print(f"{where}: training CLI at {CLI_SMALL_SIDE}x{CLI_SMALL_SIDE} "
          f"--max_hits {K} ({cfg.iterations} iterations) {s:.1f} s: "
          f"launches {cl}, its report's {report} [{smi}]", flush=True)
    return dict(s=s, launches=cl, report_launches=report), seen


def phase_kbuffer_k(dev, record, smi) -> dict:
    """Phase 24: the k-buffer kernels at K 8 and K 64 (module docstring)."""
    t_phase = time.perf_counter()
    tally = {name: dict.fromkeys(SUPPORTED_K, 0) for name in K_COUNTERS}
    res = {"lines": []}

    def line(where, r):
        k_line(where, r, smi)
        res["lines"].append(dict({k: v for k, v in r.items()
                                  if k != "differ"}, where=where))

    # (a) the training step at --max_hits 8: one step counted and its
    # calls recorded, then one warm-up and N_TIMED_STEPS timed
    t8 = fused_training_step(dev, max_hits=K_SMALL)
    n_batches = -(-t8.n_tiles // t8.tiles_per_launch)
    trace_slots.launches = scatter_add.launches = 0
    with driven(tally, dev), busiest_calls() as seen:
        state, metrics = t8.step(t8.state)
    launches = (trace_slots.launches, scatter_add.launches)
    step_ms, _, step_peak = timed(lambda: t8.step(t8.state), N_TIMED_STEPS)
    if launches != (3 * n_batches, n_batches):
        raise RuntimeError(f"phase 24 (a): trace_slots/scatter_grads "
                           f"launched {launches}, expected "
                           f"{(3 * n_batches, n_batches)}")
    if not (state_finite(state) and math.isfinite(
            float(metrics["l1_diffuse"]))):
        raise RuntimeError("phase 24 (a): non-finite state or l1_diffuse")
    del state
    res["a"] = dict(step_ms=step_ms, peak_gb=step_peak, launches=launches,
                    l1=float(metrics["l1_diffuse"]),
                    starved=float(metrics["starved"]))
    print(f"phase 24 (a): training step {TRAIN_W}x{TRAIN_H}, room_scene("
          f"{TRAIN_N}), Config defaults at --max_hits {K_SMALL}: "
          f"{step_ms:.1f} ms/step (host clock, {N_TIMED_STEPS} after a "
          f"warm-up), peak {step_peak:.1f} GB, l1_diffuse "
          f"{res['a']['l1']:.6f}, starved {res['a']['starved']:.4%}; "
          f"launches trace_slots {launches[0]}, scatter_grads "
          f"{launches[1]} [{smi}]", flush=True)
    for b in (0, 1):
        line("phase 24 (a) step", slots_k(
            f"phase 24 (a) trace_slots bounce {b}",
            seen[("trace_slots", b, 0)][1]))
    payload, ids, cap = seen[("scatter_grads", None, 0)][1]
    res["a"]["scatter"] = sc = scatter_numbers("phase 24 (a)", payload, ids,
                                               cap, dev)
    print(f"phase 24 (a): scatter_grads on the K {K_SMALL} step's first "
          f"batch ({sc['rows']} slots, {sc['hits']} hits): {sc['ms']:.3f} "
          f"ms (plain {sc['plain_ms']:.3f}, index_add_ "
          f"{sc['library_ms']:.3f}, bound {sc['bound_ms']:.3f} by "
          f"{sc['bound_by']}), max abs err {sc['max_abs_err']:.3g} of scale "
          f"{sc['scale']:.3g}, zeros equal [{smi}]", flush=True)
    del payload, ids
    # (d) trace_slots at K 64 on the same batch, the Config's tile and
    # cluster: its epilogue stages each slot block in two parts
    line("phase 24 (d) step", slots_k("phase 24 (d) trace_slots K 64",
                                      seen[("trace_slots", 0, 0)][1],
                                      K=K_LARGE))
    del seen, t8
    torch.cuda.empty_cache()

    # (a) and (d): the training CLI at --max_hits 8 and 64, its report's
    # eval renders and its slots passes held
    n_train, n_test = CLI_VIEWS
    small = gbuffer_views(CLI_SMALL_N, CLI_SMALL_SIDE, n_train, n_test, dev)
    res["cli"] = {}
    for K in (K_SMALL, K_LARGE):
        where = f"phase 24 ({'a' if K == K_SMALL else 'd'}) CLI"
        res["cli"][K], seen = cli_k(where, K, small, tally, dev, smi)
        line(where, render_k(f"{where} report render_culled",
                             seen[("render_culled", 0, 0)][1]))
        line(where, slots_k(f"{where} trace_slots",
                            seen[("trace_slots", 0, 0)][1]))
        del seen
    del small

    # (a) and (d): the 800x800 eval frame at K 8 (the Config's cluster and
    # candidates) and at K 64 (cluster 128), each pass held; render_table
    # on their primary passes; the scan frames against K 64's bounce 0
    W = H = FAST_SIZE
    scene, camera = room(FAST_N, dev)
    samples = draw_samples(torch.Generator(device=dev).manual_seed(2), W, H,
                           3)
    frames = {}
    for K, fkw in ((K_SMALL, dict(FRAME_KW, max_hits=K_SMALL)),
                   (K_LARGE, K64_FRAME)):
        where = f"phase 24 ({'a' if K == K_SMALL else 'd'}) frame"
        render_culled.launches = 0
        with driven(tally, dev), busiest_calls() as seen:
            steps, final = dispatch_render_frame(
                scene, camera, SETTINGS, None, W, H, num_bounces=2,
                samples=samples, **fkw)
        if render_culled.launches != 3 or not (
                torch.isfinite(final).all() and final.mean() > 0):
            raise RuntimeError(f"{where}: render_culled launched "
                               f"{render_culled.launches} times, or a bad "
                               f"frame")
        frames[K] = dict(rgb0=steps.rgb[0], starved=float(
            steps.overflow.mean()))
        for b in (0, 1):
            line(where, render_k(f"{where} render_culled bounce {b}",
                                 seen[("render_culled", b, 0)][1]))
        line(where, render_k(f"{where} render_table",
                             seen[("render_culled", 0, 0)][1], table=tally))
        del seen, steps, final
    psnr = {}
    for mode in ("scan", "scanq"):
        steps, _ = dispatch_render_frame(
            scene, camera, SETTINGS, None, W, H, num_bounces=2,
            samples=samples, composite_mode=mode, **K64_FRAME)
        psnr[mode] = psnr_tonemapped(steps.rgb[0], frames[K_LARGE]["rgb0"])
    res["d"] = dict(psnr_scan_vs_k64=psnr, starved={
        k: v["starved"] for k, v in frames.items()})
    print(f"phase 24 (d): {W}x{H} eval frame at K {K_LARGE}, cluster 128, "
          f"{K64_FRAME['max_clusters']} candidates (the exact reference of "
          f"JAX's scan-kernel tests): starved "
          f"{frames[K_LARGE]['starved']:.4%} (K {K_SMALL}: "
          f"{frames[K_SMALL]['starved']:.4%}); bounce 0's tonemapped PSNR "
          f"against it: scan {psnr['scan']:.2f} dB, scanq "
          f"{psnr['scanq']:.2f} dB [{smi}]", flush=True)
    del scene, frames, steps
    torch.cuda.empty_cache()

    # (d) trace_hits at K 8 and K 64 on phase 11's culled 1365x768 frame
    r = eval_render(dev)
    for K in (K_SMALL, K_LARGE):
        r.kw = dict(r.kw, max_hits=K)
        with driven(tally, dev):
            calls = render_trace_calls(r)
        passes = trace_pass_numbers(calls, f"phase 24 (d) K {K}",
                                    busiest=True)
        for name, p in passes.items():
            if p["max_abs_err"] != 0.0 or p["counters_equal"] < 1.0:
                raise RuntimeError(f"phase 24 (d) trace_hits K {K} {name}: "
                                   f"parts from its plain version: {p}")
            line("phase 24 (d) nonfused frame", dict(
                p, kernel="trace_hits", K=K,
                work=(f"{p['rays']} rays, culled, cluster "
                      f"{FRAME_KW['cull_cluster']}, {p['pairs']:.4g} "
                      f"pairs"),
                checked=f"its {NF_CHECK_TILES} busiest blocks",
                info=kernel_info(K, backfacing=name == "reflected",
                                 tile=256, cluster=FRAME_KW["cull_cluster"],
                                 kernel="trace_hits")))
        del calls
    del r
    torch.cuda.empty_cache()

    # (b) split-far at K 16: the step (its far passes at the default K_far)
    # and the eval frame (max_hits_far 8), both with train.py's shell
    cfg = Config()
    settings = tr.settings_from_config(cfg)
    side = TRAIN_W
    tile = tr.pick_tile_size(side * side, cfg.ray_tile)
    scene_t, camera = room(TRAIN_N, dev, seed=0)
    gb, _ = render_frame_fused(scene_t, camera, settings,
                               torch.Generator(device=dev).manual_seed(3),
                               side, side, num_bounces=2, **FRAME_KW)
    targets = RayTargets(diffuse=gb.rgb[0], specular=gb.rgb[1] + gb.rgb[2],
                         depth=gb.depth[0], normal=gb.normal[0],
                         roughness=gb.roughness[0], f0=gb.f0[0])
    del scene_t, gb
    base = room(TRAIN_N, dev, seed=1)[0]
    scene0, n_shell = with_shell(base, cfg, dev)
    mc = ttrain.grown_budget(SPLIT_K["max_clusters"], scene0.capacity,
                             base.capacity)
    del base
    state = tr.init_train_state(scene0)
    step_kw = dict(num_bounces=2, max_hits=SPLIT_K["max_hits"],
                   chunk=cfg.trace_chunk, tile=tile, use_pallas=True,
                   exp_power_static=float(cfg.exp_power), use_culling=True,
                   cull_tile=cfg.cull_tile,
                   cull_cluster=SPLIT_K["cull_cluster"], max_clusters=mc)
    split_kw = dict(split_far=True, mc_far=cfg.mc_far,
                    split_radius_scale=cfg.split_radius_scale)
    s_dev = moved(draw_tile_samples(torch.Generator().manual_seed(4), side,
                                    side, tile, 3), dev)
    reset_window_counts()
    trace_slots.launches = scatter_add.launches = 0
    with driven(tally, dev):
        t0 = time.perf_counter()
        st2, m2 = tr.train_step(
            state, camera, targets, settings, tr.lr_tree(cfg, 1, 1.0),
            dict(beta_1=cfg.beta_1, beta_2=cfg.beta_2,
                 scale_decay=cfg.scale_decay, apply_grads=1.0),
            None, side, side, samples=s_dev, **step_kw, **split_kw)
        sync(dev)
        split_ms = (time.perf_counter() - t0) * 1e3
    counts = window_counts()[0]
    if counts[1] == 0 or counts[2] == 0 or counts[0] or \
            scatter_add.launches == 0 or not state_finite(st2):
        raise RuntimeError(f"phase 24 (b): the split step launched "
                           f"trace_slots by window {counts}, scatter_grads "
                           f"{scatter_add.launches} times, or its state is "
                           f"not finite")
    del st2
    sb = split_batch("phase 24 (b)", state, camera, targets, settings, side,
                     s_dev, step_kw, split_kw)
    res["b"] = dict(step_ms=split_ms, launches=counts, K=SPLIT_K["max_hits"],
                    K_far=sb.K_far, max_clusters=mc, shell=n_shell,
                    starved=float(m2["starved"]), by_pass=sb.by_pass,
                    **sb.parts)
    print(f"phase 24 (b): split-far training step {side}x{side}, room_scene("
          f"{TRAIN_N}) + the shell ({n_shell} rows), bench.py's fused "
          f"configuration (K {SPLIT_K['max_hits']}, cluster "
          f"{SPLIT_K['cull_cluster']}, {SPLIT_K['max_clusters']} candidates "
          f"grown to {mc}), mc_far {cfg.mc_far}, K_far {sb.K_far} (the "
          f"default): {split_ms:.1f} ms (one step); trace_slots launches "
          f"near {counts[1]}, far {counts[2]}; on the first batch starved "
          f"near {sb.by_pass['near']:.4%}, far {sb.by_pass['far']:.4%}; "
          f"against one pass: {sb.parts['compared']:.2%} compared, "
          f"{sb.parts['outside']} outside {SPLIT_RTOL:g} rel + "
          f"{SPLIT_ATOL:g} [{smi}]", flush=True)
    for b in (0, 1):
        for name in ("near", "far"):
            line("phase 24 (b) step", window_k(
                f"phase 24 (b) step {name} {b}", trace_slots,
                trace_slots_reference, getattr(sb.calls[b], name)))
    del sb, state, targets
    torch.cuda.empty_cache()
    fbase, fcam = room(SPLIT_FRAME_N, dev)
    fscene, fshell = with_shell(fbase, cfg, dev)
    fside = SPLIT_FRAME_SIDE
    # the candidates grown for the shell as the step's; the one pass at
    # K 32, so that a ray with at most 16 near and 8 far hits keeps every
    # hit on both sides (at K 16 a ray that stays unsaturated fills the one
    # pass's 16 slots, and split_mask leaves no ray to compare)
    fmc = ttrain.grown_budget(SPLIT_K["max_clusters"], fscene.capacity,
                              fbase.capacity)
    fkw = dict(num_bounces=2, composite_mode="kbuffer", samples=draw_samples(
        torch.Generator(device=dev).manual_seed(5), fside, fside, 3),
        **dict(SPLIT_K, max_clusters=fmc))
    del fbase
    with driven(tally, dev):
        fres, seen = split_frame(
            "phase 24 (b) frame", fscene, fcam, settings, fside, fkw,
            dict(split_kw, max_hits_far=K_SMALL), 1, single_hits=32)
    res["b"]["frame"] = fres
    print(f"phase 24 (b): split-far eval frame {fside}x{fside} k-buffer, "
          f"room_scene({SPLIT_FRAME_N}) + the shell ({fshell} rows), "
          f"bench.py's fused configuration ({SPLIT_K['max_clusters']} "
          f"candidates grown to {fmc}), K {fres['K']} + K_far "
          f"{fres['K_far']}: {fres['ms']:.1f} ms/frame (one pass at K "
          f"{fres['single_K']} {fres['single_ms']:.1f}); render_culled "
          f"launches near {fres['launches_near']}, far "
          f"{fres['launches_far']}; against one pass: "
          f"{fres['compared_rays']} rays compared, {fres['outside']} outside "
          f"{SPLIT_RTOL:g} rel + {SPLIT_ATOL:g}, tonemapped PSNR "
          f"{fres['psnr']:.1f} dB [{smi}]", flush=True)
    for b in (0, 1):
        for window, name in ((1, "near"), (2, "far")):
            line("phase 24 (b) frame", window_k(
                f"phase 24 (b) frame {name} {b}", render_culled,
                render_culled_reference,
                seen[("render_culled", b, window)][1]))
    del seen, fscene
    torch.cuda.empty_cache()

    # (d) the slot sort at K 8 and K 64 on phase 16's rays
    for K in (K_SMALL, K_LARGE):
        inp = sort_inputs(SORT_RAYS, K, SORT_AUX, 11, dev)
        with driven(tally, dev):
            out = sort_slots_aux(*inp)
        for a, b in zip(out, sort_slots_aux_reference(*inp)):
            exact(f"phase 24 (d) sort K {K}", a, b)
        ms = cuda_ms(lambda: sort_slots_aux(*inp), reps=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sort_slots_aux_reference(*inp)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        b_ms, b_by = bound(SORT_RAYS * K * K / 2, PEAK_FP32,
                           nbytes(*inp, *out))
        line("phase 24 (d) sort", dict(
            kernel="sort_slots", K=K, ms=ms,
            work=f"{SORT_RAYS} rays x {K} slots, {SORT_AUX} aux blocks",
            bound_ms=b_ms, bound_by=b_by, written_gb=nbytes(*out) / 1e9,
            checked="every ray", plain_ms=plain_ms, max_abs_err=0.0,
            info=sort_kernel_info(K)))
        del inp, out

    missing = [(name, K) for name, by_k in tally.items()
               for K in (K_SMALL, K_LARGE) if not by_k[K]]
    if missing:
        raise RuntimeError(f"phase 24: no launch on a driven path of "
                           f"{missing}: {tally}")
    res.update(launches=tally, s=time.perf_counter() - t_phase)
    record["phase24"] = res
    print(f"phase 24: launches on the driven paths by K (comparisons not "
          f"counted): {tally}; {res['s']:.1f} s", flush=True)
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
    # candidate lists overflow here, and the reflected tiles are wide), on
    # the CHECK_TILES tiles of each pass that walked the most pairs
    phase4 = {}
    for name, call in (("primary", call0), ("reflected", call1)):
        out = render_culled(*call.args, **call.kwargs)
        ctile = call.kwargs["tile"]
        work = out[:, OUT_TRAV].reshape(-1, ctile).sum(dim=1)
        ref, rows, plain, keep = busiest_reference(
            call, render_culled_reference, work)
        phase4[name] = dict(compare_lanes(out[rows], ref), plain_ms=plain,
                            plain_tiles=len(keep),
                            checked_pairs=work[keep].sum().item(),
                            pairs=out[:, OUT_TRAV].sum().item(),
                            flops=walk_flops(call.args[0], out[:, OUT_TRAV],
                                             ctile),
                            differ=differing_lanes(out[rows], ref))
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
          f"primary {kernel_ms:.3f} ms (plain version on its {CHECK_TILES} "
          f"busiest tiles {plain_ms:.1f} ms, {pairs:.4g} ray x Gaussian "
          f"pairs, {gpairs_s:.1f} G pairs/s), reflected "
          f"{kernel_ms_reflected:.3f} ms (plain version on its "
          f"{CHECK_TILES} busiest tiles "
          f"{phase4['reflected']['plain_ms']:.1f} ms) [{smi}]", flush=True)
    print("phase 4: kernel vs plain at these shapes, on each pass's "
          f"{CHECK_TILES} busiest tiles: " + "; ".join(
              f"{k} max_abs_err {v['max_abs_err']:.3g}, counters equal on "
              f"{v['counters_equal']:.4%} of rays, every lane on "
              f"{v['bit_equal']:.4%} ({v['checked_pairs']:.4g} of "
              f"{v['pairs']:.4g} pairs)" for k, v in phase4.items()),
          flush=True)

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
        # the plain version on the CHECK_TILES tiles that walked the most
        # pairs
        work = acc[:, 1].reshape(-1, call.kwargs["tile"]).sum(dim=1)
        (ref, ref_acc), rows, plain, keep = busiest_reference(
            call, trace_slots_reference, work, cand_pos=(5, 6))
        cmp = compare_slots(out[rows], acc[rows], ref, ref_acc, K)
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
                            plain_tiles=len(keep),
                            checked_pairs=work[keep].sum().item(),
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
    sc5 = scatter_numbers("phase 5", payload, ids, cap, dev)
    phase5["scatter"] = dict(sc5, kernel_info=scatter_kernel_info())
    sc_ms, sc_plain_ms, sc_lib_ms, sc_err, sc_scale, nnz = (
        sc5[k] for k in ("ms", "plain_ms", "library_ms", "max_abs_err",
                         "scale", "nonzero_values"))
    sc_bound_ms, sc_bound_by = sc5["bound_ms"], sc5["bound_by"]
    del payload, ids
    record.update(phase5=phase5, tiles_per_launch=tiles_per_launch)
    print(f"phase 5: trace_slots at the step's batch ({tiles_per_launch} of "
          f"{n_tiles} {tile}-ray tiles, capacity {cap}, K={K}, mc "
          f"{cfg.max_clusters}): " + "; ".join(
              f"{k} {v['ms']:.3f} ms (plain on the {CHECK_TILES} busiest "
              f"tiles {v['plain_ms']:.1f} ms, bound "
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
    phase_bench(dev, record, smi)
    cli = phase_cli(dev, record, smi)
    run = phase_run(dev, record, smi)
    viewer = phase_viewer(dev, record, smi)
    par = phase_parallel(dev, record, smi)
    par_l = par["launches"]
    split = phase_split(dev, record, smi)
    win = split["c"]
    tools = phase_tools(dev, record, smi)
    kk = phase_kbuffer_k(dev, record, smi)

    def k_entry(name: str) -> dict:
        """Phase 24's launches of a kernel by K on its driven paths and
        its worst error against the plain version there."""
        return dict(k_launches=kk["launches"][name], k_max_abs_err=max(
            x["max_abs_err"] for x in kk["lines"] if x["kernel"] == name))

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
        # the training CLI's run (phase 18): its report's eval renders
        "cli_launches": cli["launches"]["render_culled"],
        # the render CLI's run (phase 19): 1 view at 128 spp
        "eval_cli_launches": run["stages"]["render"]["launches"][
            "render_culled"],
        # the viewer's session (phase 20): settled ticks and selection ticks
        "viewer_launches": viewer["launches"]["render_culled"],
        # the parallel modes (phase 21): the sharded fused frame's ranks
        "parallel_launches": par_l["render_culled"],
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
        # split-far (phase 22): the eval frame's near (window 1) and far
        # (window 2) passes, held bit for bit to the plain version
        "split_launches_near": split["b"]["kbuffer"]["launches_near"],
        "split_launches_far": split["b"]["kbuffer"]["launches_far"],
        "split_max_abs_err": max(v["max_abs_err"] for k, v in win.items()
                                 if k.startswith("render_culled")),
        "split_ms": {k: v["ms"] for k, v in win.items()
                     if k.startswith("render_culled")},
        "split_checked_pairs": {k: v["checked_pairs"] for k, v in win.items()
                                if k.startswith("render_culled")},
        "split_plain_ms": {k: v["plain_ms"] for k, v in win.items()
                           if k.startswith("render_culled")},
        # the tools (phase 23): launches by tool, and their calls at the
        # tools' own shapes against the plain version
        **tools_entry(tools, "render_culled", "render_culled"),
        # phase 24: K 8 and K 64 on their driven paths
        **k_entry("render_culled"),
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
        # the training CLI's run (phase 18): its culled steps
        "cli_launches": cli["launches"]["trace_slots"],
        # the parallel modes (phase 21), every rank: exit mode 0 (row 3:
        # the DP steps and the 2D mesh's shard trace) and exit mode 1 (row
        # 4: demo_5m's 1.25M-row shards)
        "parallel_launches": par_l["trace_slots_mode0"]
        + par_l["trace_slots_mode1"],
        "parallel_launches_mode0": par_l["trace_slots_mode0"],
        "parallel_launches_mode1": par_l["trace_slots_mode1"],
        "floor_ms": phase5["primary"]["floor_ms"],
        "reflected_ms": phase5["reflected"]["ms"],
        "reflected_plain_ms": phase5["reflected"]["plain_ms"],
        "reflected_bound_ms": phase5["reflected"]["bound_ms"],
        "reflected_floor_ms": phase5["reflected"]["floor_ms"],
        # exit mode 1 on the primary batch (phase 5b)
        "exit_mode_1_ms": phase5["exit_mode_1"]["ms"],
        "exit_mode_1_bound_ms": phase5["exit_mode_1"]["bound_ms"],
        # split-far (phase 22): the step's near (window 1) and far (window
        # 2) passes; ids and counters equal to the plain version's on
        # every ray of the checked tiles
        "split_launches_near": split["a"]["launches_near"],
        "split_launches_far": split["a"]["launches_far"],
        "split_max_abs_err": max(v["max_abs_err"] for k, v in win.items()
                                 if k.startswith("trace_slots")),
        "split_ms": {k: v["ms"] for k, v in win.items()
                     if k.startswith("trace_slots")},
        "split_checked_pairs": {k: v["checked_pairs"] for k, v in win.items()
                                if k.startswith("trace_slots")},
        "split_plain_ms": {k: v["plain_ms"] for k, v in win.items()
                           if k.startswith("trace_slots")},
        # the tools (phase 23): the training CLI on make_room_dataset's
        # output
        **tools_entry(tools, "trace_slots", "trace_slots"),
        # registers and blocks per SM of the launched kernel (phase 5)
        "registers": {k: v["registers"] for k, v in
                      record["trace_slots_kernel"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in
                          record["trace_slots_kernel"].items()},
        # phase 24: K 8 and K 64 on their driven paths
        **k_entry("trace_slots"),
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
        # the training CLI's run (phase 18): one a step
        "cli_launches": cli["launches"]["scatter_grads"],
        # the parallel modes (phase 21), every rank: DP and
        # Gaussian-sharded steps
        "parallel_launches": par_l["scatter_add"],
        # split-far (phase 22): the split step's launches, K + K_far slots
        # a ray, and the scatter on its first batch's payload against its
        # plain version
        "split_launches": split["a"]["scatter_launches"],
        "split_slots": split["a"]["scatter"]["rows"],
        "split_ms": split["a"]["scatter"]["ms"],
        "split_plain_ms": split["a"]["scatter"]["plain_ms"],
        "split_library_ms": split["a"]["scatter"]["library_ms"],
        "split_bound_ms": split["a"]["scatter"]["bound_ms"],
        "split_max_abs_err": split["a"]["scatter"]["max_abs_err"],
        # the tools (phase 23): the training CLI on make_room_dataset's
        # output
        **tools_entry(tools, "scatter_grads", "scatter_grads"),
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
        # the viewer's session (phase 20): its drag-time preview ticks
        "viewer_launches": viewer["launches"]["render_scan"],
        # split-far (phase 22): the scanq eval frame's near (window 1) and
        # far (window 2) passes, held bit for bit to the plain version
        "split_launches_near": split["b"]["scanq"]["launches_near"],
        "split_launches_far": split["b"]["scanq"]["launches_far"],
        "split_max_abs_err": max(v["max_abs_err"] for k, v in win.items()
                                 if k.startswith("render_scan")),
        "split_ms": {k: v["ms"] for k, v in win.items()
                     if k.startswith("render_scan")},
        "split_checked_pairs": {k: v["checked_pairs"] for k, v in win.items()
                                if k.startswith("render_scan")},
        "split_plain_ms": {k: v["plain_ms"] for k, v in win.items()
                           if k.startswith("render_scan")},
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
        # render_novel_views' run (phase 19): 2 views at 16 spp, culled
        "eval_cli_launches": run["stages"]["render_novel_views"][
            "launches"]["trace_hits"],
        # the viewer's session (phase 20): selection masks (brute, 0
        # bounces) and every tick after the duplicate (brute)
        "viewer_launches": viewer["launches"]["trace_hits"],
        # the parallel modes (phase 21): sharded_render's culled ranks (row
        # 10)
        "parallel_launches": par_l["trace_hits"],
        # the tools (phase 23): eval_sweep's and make_room_dataset's
        # non-fused route
        **tools_entry(tools, "trace_hits", "trace_hits"),
        # registers and blocks per SM of the launched kernel (phase 10)
        "registers": {k: v["registers"] for k, v in
                      record["trace_hits_kernel"].items()},
        "blocks_per_sm": {k: v["blocks_per_sm"] for k, v in
                          record["trace_hits_kernel"].items()},
        # phase 24: K 8 and K 64 on their driven paths
        **k_entry("trace_hits"),
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
        # phase 24: K 8 and K 64 on their driven paths
        **k_entry("render_table"),
    }, {
        "name": "bench_dtype",
        "route": "cuda",
        "source": src + "bench_dtype.cu",
        "replaces": "tools/bench_vpu_dtype.py:53",
        # the bench_vpu_dtype twin's run (phase 15): float32, and bf16
        # beside; ms is the kernel's device time (profiler), events_ms the
        # tool's reading, host_ms what the host takes to enqueue a call
        "launches": dtype["launches"],
        "max_abs_err": dtype["f32"]["max_abs_err"],
        "ms": dtype["f32"]["ms"],
        "plain_ms": dtype["f32"]["plain_ms"],
        "bound_ms": dtype["f32"]["bound_ms"],
        "bound_by": dtype["f32"]["bound_by"],
        "library_ms": None,
        "events_ms": dtype["f32"]["events_ms"],
        "host_ms": dtype["f32"]["host_ms"],
        "reps0_ms": dtype["f32"]["reps0_ms"],
        "bf16_ms": dtype["bf16"]["ms"],
        "bf16_events_ms": dtype["bf16"]["events_ms"],
        "bf16_bound_ms": dtype["bf16"]["bound_ms"],
        "registers": {k: dtype[k]["kernel"]["registers"]
                      for k in ("f32", "bf16")},
        "blocks_per_sm": {k: dtype[k]["kernel"]["blocks_per_sm"]
                          for k in ("f32", "bf16")},
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
        # phase 24: K 8 and K 64 on their driven paths
        **k_entry("sort_slots"),
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
