"""Time the gradient scatter (csrc/scatter_grads.cu) and the slot sort
(csrc/sort_slots.cu) of this tree against another tree's, in turns, in one
process on one card, on the inputs chip_smoke.py times them on:

  scatter  phase 5's: the payload and ids of every bounce of the training
           step's first batch (768x768, room_scene(175_000), all 72 tiles,
           K 32: 3 x 589,824 x 32 rows), as tools/fused_setup.py makes them;
  sort     phase 16's: sort_inputs(SORT_RAYS, SORT_K, SORT_AUX, 11), the
           Pallas test's inputs at 655,360 rays x 32 slots, 5 aux blocks.

    python editable_gaussian_reflections_tpu_torch/tools/scatter_ab.py <other tree>

Both trees' kernels are built from their own csrc/ (build.load with the
other tree's directory) and called through their C entry points, whose
signatures the two trees share.  Each round times the other tree's kernel,
this tree's, the rungs and cuts below, then the same in reverse order (CUDA
events, after a warm-up), so that each side is timed before and after the
other.  Every kernel timed is first held to the plain version (the scatter
within 1e-6 x scale with equal zeros, the sort bit for bit).

The scatter's ladder, each rung timed in the same turns:
  one_row      scatter_grads.cu with its first sums: a warp a span, a lane a
               column, one row a warp instruction;
  match        tools/scatter_match.cu: equal ids summed within a warp by
               __match_any_sync over one slot of 32 neighbouring rays, no
               block sort;
  hash         tools/scatter_hash.cu: the chunk's rows grouped by a
               counting sort on a hash of the id (shared-memory atomics)
               in place of the bitonic sort, with the first form of the
               sums (a warp a span, a lane a column);
  chunk8192    scatter_grads.cu with 512-thread blocks of 8192 rows (a
               whole 256-ray cull tile at K 32);
  threads512   scatter_grads.cu with 512-thread blocks of 4096 rows (8 keys
               a thread in the sort, 16 warps' spans);
  threads512_loads4  the same, reading 4 rows ahead a half-warp, not 8;
  chunk2048    scatter_grads.cu with 128-thread blocks of 2048 rows;
  loads4, loads16  scatter_grads.cu reading 4 or 16 rows ahead a half-warp
               in its sums, not 8;
  prefetch     scatter_grads.cu asking L2 for each valid row's payload as it
               reads the ids, before the sort;
  contiguous_flush  scatter_grads.cu moving each half-warp's sums to
               contiguous columns before its atomics (not a 16-byte stride);
  min_blocks5, min_blocks6  scatter_grads.cu with registers capped for 5
               or 6 resident blocks an SM (__launch_bounds__).
Each rung and this tree's kernel are also built with a counter of the
atomics they issue (their EGR_SCATTER_COUNT entry point), which the output
sets against the nonzero values (one atomic each in the kernel that sums
nothing ahead, a thread per value).  Three
cuts of scatter_grads.cu, timed but not checked, show where its time goes:
no_payload (every value read as 1.0: no payload bytes), no_atomics (the
sums computed, none added) and sort_twice (the bitonic sort run twice).
Prints `SCATTER_AB {json}` lines with the card's name, power limit and SM
clock.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SORT_RAYS, SORT_K, SORT_AUX = 655_360, 32, 5
CHUNK_ROWS = 4096
# Edits that build the ladder's rungs and cuts from copies of the sources:
# the lines they replace
SORT_LINE = "  block_sort(s.keys, n_valid, n);"
PAYLOAD_LINES = (("if (has0) v0[u] = p[0];", "if (has0) v0[u] = 1.0f;"),
                 ("if (has1) v1[u] = p[1];", "if (has1) v1[u] = 1.0f;"))
IDS_LINE = "    s.ids[row] = id[q];"
BOUNDS = "__launch_bounds__(THREADS)"
THREADS_512 = ("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")
KEYS_8 = ("constexpr int PER_THREAD = 16;", "constexpr int PER_THREAD = 8;")
LOADS_4 = ("constexpr int LOADS = 8;", "constexpr int LOADS = 4;")
# the first form of the sums: a warp a span, a lane a column, one row a warp
# instruction (the flush and the sums' loop replaced whole)
ONE_ROW_FLUSH = """// Add a run's sum of one column into the accumulator.  Warp-uniform.
template <bool COUNT>
__device__ __forceinline__ void flush(double* acc, int id, double sum,
                                      int width, int col, bool has_col,
                                      unsigned long long* n_atomics) {
  const bool add = id >= 0 && has_col && sum != 0.0;
  if (add) atomicAdd(acc + (size_t)id * width + col, sum);
  if (COUNT) {
    const unsigned adds = __ballot_sync(FULL, add);
    if ((threadIdx.x & 31) == 0 && adds) atomicAdd(n_atomics, __popc(adds));
  }
}

"""
ONE_ROW_SUMS = """  // segmented sums: warp `warp` walks sorted rows [begin, end)
  const int span = (n_valid + WARPS - 1) / WARPS;
  const int begin = min(warp * span, n_valid);
  const int end = min(begin + span, n_valid);
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int col = c0 + lane;
    const bool has_col = col < width;
    int cur = -1;
    double sum = 0.0;
    for (int pos = begin; pos < end; pos += LOADS) {
      int gid[LOADS];
      float val[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        gid[u] = -1;
        val[u] = 0.0f;
        if (pos + u < end) {
          const int row = (int)(s.keys[padded(pos + u)] & (CHUNK - 1));
          gid[u] = s.ids[row];
          if (has_col) val[u] = payload[(base + row) * width + col];
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (gid[u] < 0) break;  // past the span's end
        if (gid[u] != cur) {
          flush<COUNT>(acc, cur, sum, width, col, has_col, n_atomics);
          cur = gid[u];
          sum = 0.0;
        }
        sum += (double)val[u];
      }
    }
    flush<COUNT>(acc, cur, sum, width, col, has_col, n_atomics);
  }
}
"""
# the flush with its sums moved to contiguous columns first (four float64
# shuffles), so that each atomic instruction covers columns c0 + c and
# c0 + 16 + c of a half-warp's row, not two at a 16-byte stride
STRIDED_FLUSH = """  const bool add0 = ends && id >= 0 && col < width && s0 != 0.0;
  const bool add1 = ends && id >= 0 && col + 1 < width && s1 != 0.0;
  if (add0) atomicAdd(acc + (size_t)id * width + col, s0);
  if (add1) atomicAdd(acc + (size_t)id * width + col + 1, s1);"""
CONTIGUOUS_FLUSH = """  const int c = threadIdx.x & 15, half = threadIdx.x & 16, c0 = col - 2 * c;
  const double a0 = __shfl_sync(FULL, s0, half + (c >> 1));
  const double a1 = __shfl_sync(FULL, s1, half + (c >> 1));
  const double b0 = __shfl_sync(FULL, s0, half + 8 + (c >> 1));
  const double b1 = __shfl_sync(FULL, s1, half + 8 + (c >> 1));
  const double lo = (c & 1) ? a1 : a0, hi = (c & 1) ? b1 : b0;
  const bool add0 = ends && id >= 0 && c0 + c < width && lo != 0.0;
  const bool add1 = ends && id >= 0 && c0 + 16 + c < width && hi != 0.0;
  if (add0) atomicAdd(acc + (size_t)id * width + c0 + c, lo);
  if (add1) atomicAdd(acc + (size_t)id * width + c0 + 16 + c, hi);"""
# name: (source, edits); "change" is this tree's kernel
RUNGS = {
    "change": ("scatter_grads", ()),
    "one_row": ("scatter_grads", (
        (re.compile(r"// On the lanes whose run `ends`.*?(?=template <bool "
                    r"COUNT>\n__global__)", re.S), ONE_ROW_FLUSH),
        (re.compile(r"  // segmented sums:.*?\n}\n(?=\ntemplate <bool "
                    r"COUNT>\nint launch)", re.S), ONE_ROW_SUMS))),
    "hash": ("scatter_hash", ()),
    "chunk8192": ("scatter_grads", (
        THREADS_512,
        ("constexpr int ROW_BITS = 12;", "constexpr int ROW_BITS = 13;"))),
    "chunk2048": ("scatter_grads", (
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 128;"),
        ("constexpr int ROW_BITS = 12;", "constexpr int ROW_BITS = 11;"))),
    "threads512": ("scatter_grads", (THREADS_512, KEYS_8)),
    "threads512_loads4": ("scatter_grads", (THREADS_512, KEYS_8, LOADS_4)),
    "loads4": ("scatter_grads", (LOADS_4,)),
    "loads16": ("scatter_grads", (
        ("constexpr int LOADS = 8;", "constexpr int LOADS = 16;"),)),
    "prefetch": ("scatter_grads", ((IDS_LINE, IDS_LINE + """
    if (id[q] >= 0) {
      const float* p = payload + (base + row) * width;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p + width - 1));
    }"""),)),
    "contiguous_flush": ("scatter_grads", ((STRIDED_FLUSH,
                                            CONTIGUOUS_FLUSH),)),
    "min_blocks5": ("scatter_grads", ((BOUNDS,
                                       "__launch_bounds__(THREADS, 5)"),)),
    "min_blocks6": ("scatter_grads", ((BOUNDS,
                                       "__launch_bounds__(THREADS, 6)"),)),
}
CUTS = {
    "no_payload": ("scatter_grads", PAYLOAD_LINES),
    "no_atomics": ("scatter_grads", tuple(
        (f"if ({a}) atomicAdd(",
         f"if ({a} && (id ^ width) == 0x7fffffff) atomicAdd(")
        for a in ("add0", "add1"))),
    "sort_twice": ("scatter_grads", ((SORT_LINE,
                                      SORT_LINE + "\n" + SORT_LINE),)),
}
COUNTING = '#define EGR_SCATTER_COUNT\n#include "{name}.cu"\n'

SCATTER_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                + [ctypes.c_int] * 2)
SORT_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def sort_inputs(R: int, K: int, A: int, seed: int, dev) -> list:
    """tests/test_pallas_kernel.py's slot-sort inputs at R x K: exact ties
    (t[:, 3] = t[:, 5]), empty slots in front and interleaved."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 10, (R, K)).astype(np.float32)
    t[:, 3] = t[:, 5]
    t[0, :4] = 3.0e38
    t[1, ::2] = 3.0e38
    ids = rng.integers(0, 1000, (R, K)).astype(np.int32)
    aux = rng.normal(size=(R, A * K)).astype(np.float32)
    return [torch.tensor(a, device=dev) for a in (t, ids, aux)]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rung_dir(rung: str, source: str, edits) -> Path:
    """build/scatter_ab/<rung>: a copy of this tree's csrc/ and tools/*.cu
    with `edits` made to <source>.cu and a counting build of it beside it
    (scatter_count.cu)."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build

    dst = ROOT / "build" / "scatter_ab" / rung
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    for f in HERE.glob("*.cu"):
        shutil.copy(f, dst / f.name)
    f = dst / f"{source}.cu"
    text = f.read_text()
    for old, new in edits:  # a string, or a pattern of one region
        found = (len(old.findall(text)) if isinstance(old, re.Pattern)
                 else text.count(old))
        if found != 1:
            raise RuntimeError(f"{f}: {old!r} is not there once")
        text = (old.sub(lambda _m: new, text) if isinstance(old, re.Pattern)
                else text.replace(old, new))
    f.write_text(text)
    (dst / "scatter_count.cu").write_text(COUNTING.format(name=source))
    return dst


def entry(src_dir: Path, name: str, symbol: str, argtypes):
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build

    fn = getattr(build.load(name, src_dir), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    log = build.library_path(name, src_dir).with_suffix(".log").read_text()
    regs = [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]
    return fn, regs


def call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: cudaError {err}")


def scatter_input(dev):
    """Phase 5's scatter input: (payload, ids, capacity)."""
    spec = importlib.util.spec_from_file_location(
        "fused_setup", HERE / "fused_setup.py")
    fs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fs)
    from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
        hit_grads)

    t = fs.training_step(dev)
    t.calls = None
    payload, ids = hit_grads(t.steps, t.residuals, t.targets_b, t.settings,
                             t.num_bounces, t.capacity)
    return payload, ids, t.capacity, fs.card


def chunk_stats(ids, n_gauss: int) -> dict:
    """Valid rows and distinct Gaussians per CHUNK_ROWS-row chunk, per
    bounce (the rows are [bounce][ray][slot])."""
    M = ids.shape[0]
    per_bounce = M // 3
    out = {}
    for b in range(3):
        part = ids[b * per_bounce:(b + 1) * per_bounce].to(torch.int64)
        chunk = torch.arange(part.shape[0], device=part.device) // CHUNK_ROWS
        keep = part >= 0
        distinct = torch.unique(chunk[keep] * n_gauss + part[keep]).numel()
        out[f"bounce {b}"] = dict(valid=int(keep.sum()), distinct=distinct,
                                  repeat=int(keep.sum()) / max(distinct, 1))
    return out


def main(argv: list[str]) -> None:
    other = Path(argv[0]).resolve()
    sys.path.insert(0, str(ROOT))
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build
    from editable_gaussian_reflections_tpu_torch.ops.cuda.scatter import (
        kernel_info,
        scatter_add_reference,
    )
    from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
        kernel_info as sort_info,
    )
    from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
        sort_slots_aux_reference,
    )

    dev = torch.device("cuda")
    other_csrc = other / "editable_gaussian_reflections_tpu_torch" / "csrc"
    dirs = {name: rung_dir(name, source, edits)
            for name, (source, edits) in {**RUNGS, **CUTS}.items()}
    # every library at once, one nvcc each
    jobs = [(other_csrc, "scatter_grads"), (other_csrc, "sort_slots"),
            (build.CSRC, "sort_slots"), (HERE, "scatter_match")]
    for name, d in dirs.items():
        source = {**RUNGS, **CUTS}[name][0]
        jobs += [(d, source)] + ([(d, "scatter_count")] if name in RUNGS
                                 else [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build.build(job[1], job[0]), jobs))

    plain_args = SCATTER_ARGS + [ctypes.c_void_p]
    count_args = SCATTER_ARGS + [ctypes.c_void_p] * 2
    match_args = SCATTER_ARGS + [ctypes.c_int] + [ctypes.c_void_p] * 2
    scatters, counted, logs = {}, {}, {}
    scatters["parent"], logs["parent"] = entry(
        other_csrc, "scatter_grads", "egr_scatter_add", plain_args)
    match, logs["match"] = entry(HERE, "scatter_match", "egr_scatter_match",
                                 match_args)
    for name, d in dirs.items():
        source = {**RUNGS, **CUTS}[name][0]
        scatters[name], logs[name] = entry(d, source, "egr_scatter_add",
                                           plain_args)
        if name in RUNGS:
            counted[name], _ = entry(d, "scatter_count",
                                     "egr_scatter_add_counted", count_args)
    sorts = {}
    sorts["parent"], logs["sort parent"] = entry(
        other_csrc, "sort_slots", "egr_sort_slots", SORT_ARGS)
    sorts["change"], logs["sort change"] = entry(
        build.CSRC, "sort_slots", "egr_sort_slots", SORT_ARGS)

    payload, ids, cap, card = scatter_input(dev)
    M, C = payload.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    K = 32

    def run_scatter(name, acc, n_atomics=None):
        if name == "match":
            call(match, payload.data_ptr(), ids.data_ptr(), acc.data_ptr(),
                 M, C, cap, K, n_atomics, stream)
        elif n_atomics is not None:
            call(counted[name], payload.data_ptr(), ids.data_ptr(),
                 acc.data_ptr(), M, C, cap, n_atomics, stream)
        else:
            call(scatters[name], payload.data_ptr(), ids.data_ptr(),
                 acc.data_ptr(), M, C, cap, stream)

    ref = scatter_add_reference(
        torch.zeros(cap, C, dtype=torch.float64, device=dev), payload, ids)
    r32 = ref.to(torch.float32)
    scale = max(1e-30, r32.abs().max().item())
    keep = ids >= 0
    nnz = int(((payload != 0) & keep[:, None]).sum().item())
    checked = ["parent", "match", *RUNGS]
    errors, atomics = {}, {"parent": nnz}
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    for name in checked:
        for counting in (False, True):
            if counting and name == "parent":
                continue
            acc = torch.zeros(cap, C, dtype=torch.float64, device=dev)
            n.zero_()
            run_scatter(name, acc, n.data_ptr() if counting else None)
            a32 = acc.to(torch.float32)
            err = (a32 - r32).abs().max().item()
            if not (err <= 1e-6 * scale and torch.equal(a32 == 0, r32 == 0)):
                raise RuntimeError(f"scatter {name} (counting {counting}) "
                                   f"disagrees with the plain version: {err} "
                                   f"of scale {scale}")
            errors[name] = max(err, errors.get(name, 0.0))
            if counting:
                atomics[name] = int(n.item())
    print("SCATTER_AB " + json.dumps(dict(
        what="scatter input", card=card(), rows=M, hits=int(keep.sum()),
        nonzero_values=nnz, scale=scale, max_abs_err=errors,
        atomics=atomics, chunks=chunk_stats(ids, cap),
        change_info=kernel_info(), ptxas=logs)), flush=True)

    sort_in = sort_inputs(SORT_RAYS, SORT_K, SORT_AUX, 11, dev)
    sort_out = [torch.empty_like(x) for x in sort_in]
    sort_ref = sort_slots_aux_reference(*sort_in)

    def run_sort(name):
        call(sorts[name], *(x.data_ptr() for x in (*sort_in, *sort_out)),
             SORT_RAYS, SORT_K, SORT_AUX, stream)

    for name in sorts:
        run_sort(name)
        if not all(torch.equal(a, b) for a, b in zip(sort_out, sort_ref)):
            raise RuntimeError(f"sort {name} differs from the plain version")

    order = checked + list(CUTS)
    times = {name: [] for name in order}
    sort_times = {name: [] for name in sorts}
    acc = torch.zeros(cap, C, dtype=torch.float64, device=dev)
    for rnd in range(2):
        for name in order + order[::-1]:
            times[name].append(round(cuda_ms(
                lambda: run_scatter(name, acc), 10), 4))
        for name in ["parent", "change", "change", "parent"]:
            sort_times[name].append(round(cuda_ms(lambda: run_sort(name),
                                                  10), 4))
        print("SCATTER_AB " + json.dumps(dict(
            what=f"round {rnd}", card=card(), scatter_ms=times,
            sort_ms=sort_times)), flush=True)
    print("SCATTER_AB " + json.dumps(dict(
        what="summary", card=card(),
        scatter_mean_ms={k: sum(v) / len(v) for k, v in times.items()},
        sort_mean_ms={k: sum(v) / len(v) for k, v in sort_times.items()},
        sort_info={k: sort_info(k) for k in (16, 32)},
        scatter_info=kernel_info())), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
