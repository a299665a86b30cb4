"""The dtype micro-benchmark's op mix: the CUDA kernels' wrapper (`mix`)
and its plain PyTorch version (`mix_reference`).

Counterpart of the inline Pallas kernel of tools/bench_vpu_dtype.py: each
element x of a float32 block runs `reps` rounds of

    a = acc * x + half;  b = a * a - x;  c = b * acc + a
    d = max(c, half);    acc = d * exp(-min(d, half))

(acc starting at x; the tool's lines 38-47) in float32 or in bfloat16,
every operation rounded to that type, and returns acc as float32.  The
tool counts MIX_OPS elementwise operations per element and round.  The
kernels (csrc/bench_dtype.cu) carry several elements a thread (bf16 in
packed pairs) on a grid sized on the card; `kernel_info` reports what the
card's runtime says of them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .render_kernel import _check

MIX_OPS = 12
HALF = 0.5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _bf16_bits(v: float) -> int:
    """The bits of v rounded to bf16 (to nearest, ties to even)."""
    u = int(np.float32(v).view(np.uint32))
    return (u + 0x7FFF + ((u >> 16) & 1)) >> 16


# the bf16 kernel takes half as its bits, computed here once, not per call
HALF_BF16_BITS = _bf16_bits(HALF)


@functools.cache
def _entry_points():
    """The kernels' C entry points, built and loaded at first use."""
    lib = build.load("bench_dtype")
    f32, bf16 = lib.egr_mix_f32, lib.egr_mix_bf16
    f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_ushort, ctypes.c_void_p]
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


def kernel_info(dtype: torch.dtype) -> dict:
    """What the card's runtime reports of the kernel for `dtype`: registers
    and spilled (local) bytes per thread, resident blocks per SM, threads a
    block, chains a thread (float32 elements or bf16 pairs) and the SMs.
    Needs a CUDA device."""
    if dtype not in DTYPES.values():
        raise ValueError(f"dtype={dtype}: expected one of {list(DTYPES)}")
    fn = build.load("bench_dtype").egr_mix_info
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(int(dtype == torch.bfloat16), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"bench_dtype kernel info failed: cudaError {err}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                threads=out[3], per_thread=out[4], sms=out[5])


def mix_reference(x: torch.Tensor, reps: int, dtype: torch.dtype):
    """The op mix in PyTorch on tensors of `dtype` (each operation rounded
    to it; exp of a bf16 tensor is taken in float and rounded)."""
    xv = x.to(dtype)
    half = torch.tensor(HALF, dtype=dtype, device=x.device)
    acc = xv
    for _ in range(reps):
        a = acc * xv + half
        b = a * a - xv
        c = b * acc + a
        d = torch.maximum(c, half)
        acc = d * torch.exp(-torch.minimum(d, half))
    return acc.to(torch.float32)


def mix(x: torch.Tensor, reps: int, dtype: torch.dtype) -> torch.Tensor:
    """The op mix on the float32 block x in `dtype` (torch.float32 or
    torch.bfloat16); float32 result of x's shape.

    CUDA tensors launch the kernel of csrc/bench_dtype.cu on the current
    stream (built at first use) and count the launch in `mix.launches`;
    CPU tensors take mix_reference.  Anything else raises."""
    if dtype not in DTYPES.values():
        raise ValueError(f"dtype={dtype}: expected one of {list(DTYPES)}")
    dev = x.device
    if dev.type == "cpu":
        return mix_reference(x, reps, dtype)
    if dev.type != "cuda":
        raise ValueError(f"mix: no kernel for device {dev}")
    _check("x", x, tuple(x.shape), torch.float32, dev)
    n = x.numel()
    if dtype == torch.bfloat16 and n % 2:
        raise ValueError(f"bf16 takes element pairs: {n} elements")
    out = torch.empty_like(x)
    f32, bf16 = _entry_points()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dtype == torch.float32:
            err = f32(x.data_ptr(), out.data_ptr(), n, reps, HALF, stream)
        else:
            err = bf16(x.data_ptr(), out.data_ptr(), n // 2, reps,
                       HALF_BF16_BITS, stream)
    if err != 0:
        raise RuntimeError(f"bench_dtype kernel launch failed: cudaError "
                           f"{err}")
    mix.launches += 1
    return out


mix.launches = 0
