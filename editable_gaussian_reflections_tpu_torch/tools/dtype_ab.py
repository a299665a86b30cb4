"""Time the dtype micro-benchmark's kernels (csrc/bench_dtype.cu) of this
tree against another tree's, in turns, in one process on one card, on the
block tools/bench_vpu_dtype.py times (256 x 512 floats, uniform in [0.1,
0.9], seed 0, 512 rounds), and count their instructions from the SASS.

    python editable_gaussian_reflections_tpu_torch/tools/dtype_ab.py <tree>

Both trees' kernels are built from their own csrc/ (build.load with the
other tree's directory) and called through their C entry points, whose
signatures the two trees share.  The ladder's rungs are this tree's kernels
built from edited copies under build/dtype_ab/<rung>/: eEtT_pPtU carries E
float32 elements a thread in blocks of T threads and P bf16 pairs a thread
in blocks of U; _skew runs the second half of a thread's chains half a
round behind the first (SKEWED).  Every
kernel is first held to the plain version bit for bit (infinities equal)
at 16 and at 512 rounds.

Times, each per launch on the card:
  kernel   CUDA events around LAUNCHES launches of the C entry point into
           one output (no Python between them but the ctypes call), in
           turns: the other tree, this tree, the rungs, then the same in
           reverse order, ROUNDS times;
  profiler the kernel's device time from torch.profiler (key_averages)
           over 20 launches, both trees;
  reps0    events around LAUNCHES launches of a 0-round kernel (what a
           launch, its load and its store cost), both trees;
  wrapper  events around the tool's 20 calls of `mix` (this tree), as
           tools/bench_vpu_dtype.py times them, and the host's time for
           them (no synchronisation): where it reaches the events time,
           the events time is the host's enqueue rate;
  scaling  both trees' kernels on the block repeated SCALES times, per
           element: where the time grows less than the work, the tool's
           size leaves the kernel short of parallel work.

SASS: `cuobjdump -sass` of each library goes to chiprun_out/dtype_ab/;
for each kernel, the mnemonics of the loop that holds its MUFU.EX2 are
counted and divided by the MUFU count (one per element and round in both
types), i.e. per element and round.  Prints `DTYPE_AB {json}` lines with
the card's name, power limit and SM clock.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
ROWS, COLS, REPS, CHECK_REPS = 256, 512, 512, 16
LAUNCHES, ROUNDS = 200, 3
CONSTANTS = ("constexpr int E = {};", "constexpr int F32_THREADS = {};",
             "constexpr int P = {};", "constexpr int BF16_THREADS = {};")
# this tree's kernels: E 2 and P 1 in blocks of 256
CHANGE = (2, 256, 1, 256)
# run_rounds with the second half of a thread's chains half a round behind
# the first, so that one group's exp meets the other's arithmetic
SKEWED = """template <int N, typename V>
__device__ __forceinline__ void run_rounds(V (&acc)[N], const V (&xv)[N],
                                           V half, int reps) {
  constexpr int EARLY = N - N / 2;
  if (reps == 0) return;
  V d[N];
#pragma unroll
  for (int e = 0; e < EARLY; ++e) d[e] = mix_half(acc[e], xv[e], half);
  for (int k = 1; k < reps; ++k) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (e < EARLY)
        acc[e] = exp_half(d[e], half);
      else
        d[e] = mix_half(acc[e], xv[e], half);
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (e < EARLY)
        d[e] = mix_half(acc[e], xv[e], half);
      else
        acc[e] = exp_half(d[e], half);
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e >= EARLY) d[e] = mix_half(acc[e], xv[e], half);
    acc[e] = exp_half(d[e], half);
  }
}
"""
ROUNDS_RE = re.compile(r"template <int N, typename V>\n__device__ "
                       r"__forceinline__ void run_rounds.*?\n}\n", re.S)


def rung_name(e, tf, p, tb, skew=False) -> str:
    return f"e{e}t{tf}_p{p}t{tb}" + ("_skew" if skew else "")


RUNGS = {rung_name(*v): v for v in (
    (1, 256, 2, 128), (1, 128, 1, 128), (2, 128, 2, 256), (4, 128, 4, 64),
    (8, 128, 4, 128), (2, 256, 2, 128, True))}
# the scaling probe: the tool's block repeated this many times
SCALES = (1, 4, 16)
F32_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                           ctypes.c_void_p]
BF16_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_ushort,
                                                            ctypes.c_void_p]
# the pipes an instruction issues to, by its opcode (NVIDIA's throughput
# table for compute capability 9.0: 128 results per SM and clock for 32-bit
# and packed 16-bit floating-point add, multiply and fused multiply-add,
# 64 for 32-bit integer and logical operations, shifts, min and max, 16
# for exp2 and the other special functions)
PIPES = {"FFMA": "fp32", "FMUL": "fp32", "FADD": "fp32", "HFMA2": "fp32",
         "HMUL2": "fp32", "HADD2": "fp32", "IMAD": "fp32",
         "FMNMX": "alu", "HMNMX2": "alu", "SHF": "alu", "LOP3": "alu",
         "PRMT": "alu", "IADD3": "alu", "ISETP": "alu", "FSETP": "alu",
         "SEL": "alu", "FSEL": "alu", "MOV": "alu", "MUFU": "mufu",
         "F2FP": "conversion", "F2F": "conversion"}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def rung_dir(name: str, values) -> Path:
    """build/dtype_ab/<name>: a copy of this tree's csrc/ with bench_dtype.cu's
    constants set to `values` (E, F32_THREADS, P, BF16_THREADS) and, where
    a fifth value is true, run_rounds skewed (SKEWED)."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build

    dst = ROOT / "build" / "dtype_ab" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    f = dst / "bench_dtype.cu"
    text = f.read_text()
    for template, old, new in zip(CONSTANTS, CHANGE, values):
        line = template.format(old)
        if text.count(line) != 1:
            raise RuntimeError(f"{f}: {line!r} is not there once")
        text = text.replace(line, template.format(new))
    if len(values) > 4 and values[4]:
        if len(ROUNDS_RE.findall(text)) != 1:
            raise RuntimeError(f"{f}: run_rounds is not there once")
        text = ROUNDS_RE.sub(lambda _m: SKEWED, text)
    f.write_text(text)
    return dst


def sass_counts(lib: Path, out_dir: Path, name: str) -> dict:
    """{kernel: per element and round, {opcode: count}} from the SASS of the
    innermost loop holding most of the kernel's MUFU.EX2s."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.sass").write_text(text)
    res = {}
    for part in text.split("Function : ")[1:]:
        kernel = "bf16" if "mix_bf16" in part.splitlines()[0] else "f32"
        instrs = []   # (address, instruction without its predicate)
        for line in part.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                instrs.append((int(m.group(1), 16),
                               re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))
        loops = []    # (start, end) of each backward branch
        for addr, ins in instrs:
            m = re.match(r"BRA\s+(?:`\()?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
        best = None
        for start, end in loops:
            if any(start <= a and b < end for a, b in loops
                   if (a, b) != (start, end)):
                continue  # not innermost
            body = [b for a, b in instrs if start <= a <= end]
            n_mufu = sum(b.startswith("MUFU") for b in body)
            if n_mufu and (best is None or n_mufu > best[0]):
                best = (n_mufu, body)
        if best is None:
            continue
        n_mufu, body = best
        ops = Counter(b.split()[0] for b in body)
        pipes = Counter()
        for op, c in ops.items():
            pipes[PIPES.get(op.split(".")[0], "other")] += c
        res[kernel] = dict(
            mufu_in_loop=n_mufu, loop_instructions=len(body),
            per_element_round={k: v / n_mufu for k, v in sorted(ops.items())},
            pipes_per_element_round={k: v / n_mufu for k, v in pipes.items()})
    return res


def call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: cudaError {err}")


def events_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main(argv: list[str]) -> None:
    other = Path(argv[0]).resolve()
    sys.path.insert(0, str(ROOT))
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build
    from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
        HALF,
        HALF_BF16_BITS,
        kernel_info,
        mix,
        mix_reference,
    )
    from editable_gaussian_reflections_tpu_torch.tools.bench_v5 import (
        time_call,
    )
    from editable_gaussian_reflections_tpu_torch.tools.fused_setup import (
        device_time_us,
    )

    dev = torch.device("cuda")
    dirs = {"parent": other / "editable_gaussian_reflections_tpu_torch"
            / "csrc", "change": build.CSRC}
    dirs.update({name: rung_dir(name, v) for name, v in RUNGS.items()})
    with ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: build.build("bench_dtype", d), dirs.values()))
    out_dir = ROOT / "chiprun_out" / "dtype_ab"
    fns, info = {}, {}
    for name, d in dirs.items():
        lib = build.load("bench_dtype", d)
        f32, bf16 = lib.egr_mix_f32, lib.egr_mix_bf16
        f32.argtypes, bf16.argtypes = F32_ARGS, BF16_ARGS
        f32.restype = bf16.restype = ctypes.c_int
        fns[name] = {"f32": f32, "bf16": bf16}
        path = build.library_path("bench_dtype", d)
        log = path.with_suffix(".log").read_text()
        info[name] = dict(
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln],
            sass=sass_counts(path, out_dir, name))
        if hasattr(lib, "egr_mix_info"):
            fn = lib.egr_mix_info
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for kind in (0, 1):
                out = (ctypes.c_int * 6)()
                call(fn, kind, ctypes.addressof(out))
                info[name][("bf16" if kind else "f32") + "_info"] = dict(
                    registers=out[0], local_bytes=out[1],
                    blocks_per_sm=out[2], threads=out[3], per_thread=out[4],
                    sms=out[5])
    print("DTYPE_AB " + json.dumps(dict(what="kernels", card=card(),
                                        info=info)), flush=True)

    x = torch.tensor(np.random.default_rng(0).uniform(0.1, 0.9, (ROWS, COLS)),
                     dtype=torch.float32, device=dev)
    n = x.numel()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(name, kind, reps):
        if kind == "f32":
            call(fns[name]["f32"], x.data_ptr(), out.data_ptr(), n, reps,
                 HALF, stream)
        else:
            call(fns[name]["bf16"], x.data_ptr(), out.data_ptr(), n // 2,
                 reps, HALF_BF16_BITS, stream)

    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for reps in (CHECK_REPS, REPS):
            ref = mix_reference(x, reps, dtype)
            for name in dirs:
                out.fill_(float("nan"))
                launch(name, kind, reps)
                if not torch.equal(out, ref):
                    raise RuntimeError(f"{name} {kind} at {reps} rounds "
                                       f"differs from the plain version")

    order = list(dirs)
    times = {kind: {name: [] for name in order} for kind in ("f32", "bf16")}
    for rnd in range(ROUNDS):
        for name in order + order[::-1]:
            for kind in ("f32", "bf16"):
                times[kind][name].append(round(events_ms(
                    lambda: launch(name, kind, REPS), LAUNCHES), 5))
        print("DTYPE_AB " + json.dumps(dict(what=f"round {rnd}", card=card(),
                                            kernel_ms=times)), flush=True)

    extra = {}
    for name in ("parent", "change", "parent", "change"):
        for kind in ("f32", "bf16"):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    launch(name, kind, REPS)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if "mix_" in e.key]
            dev_ms = (sum(device_time_us(e) for e in ev) / 1e3
                      / max(1, sum(e.count for e in ev)))
            r = extra.setdefault(f"{name} {kind}", {})
            r.setdefault("profiler_ms", []).append(round(dev_ms, 5))
            r.setdefault("reps0_ms", []).append(round(events_ms(
                lambda: launch(name, kind, 0), LAUNCHES), 5))
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ms, _ = time_call(lambda: mix(x, REPS, dtype), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            mix(x, REPS, dtype)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        extra[f"change {kind}"].update(
            wrapper_events_ms=round(ms, 5), wrapper_host_ms=round(host_ms, 5),
            kernel_info=kernel_info(dtype))
    scaling = {}
    for k in SCALES:
        xk = x.reshape(-1).repeat(k)
        outk = torch.empty_like(xk)
        for name in ("parent", "change", "change", "parent"):
            for kind in ("f32", "bf16"):
                ms = events_ms(lambda: call(
                    fns[name][kind], xk.data_ptr(), outk.data_ptr(),
                    xk.numel() // (2 if kind == "bf16" else 1), REPS,
                    HALF if kind == "f32" else HALF_BF16_BITS, stream),
                    max(10, LAUNCHES // k))
                scaling.setdefault(f"{name} {kind} x{k}", []).append(
                    round(ms * 1e6 / xk.numel(), 4))
    print("DTYPE_AB " + json.dumps(dict(
        what="summary", card=card(),
        kernel_mean_ms={kind: {k: sum(v) / len(v) for k, v in t.items()}
                        for kind, t in times.items()},
        extra=extra, scaling_ns_per_element=scaling)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
