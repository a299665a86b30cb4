"""Gradient scatter of the training step: the CUDA kernel's wrapper
(`scatter_add`) and its plain PyTorch version (`scatter_add_reference`).

Counterpart of the JAX ops/pallas/scatter_kernel.py (pallas_scatter_grads_t)
and of the XLA segment-sum in ops/render_grads.py (scatter_grads): both add
each hit's row of gradient columns into the row of its Gaussian.  Here the
sums go into a float64 accumulator [N, C] that the caller rounds to float32
once, after the last scatter of a step (csrc/scatter_grads.cu says why).
Rows with id -1 are skipped.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_ARGTYPES = ([ctypes.c_void_p] * 3        # payload, ids, acc
             + [ctypes.c_longlong]        # n_hits
             + [ctypes.c_int] * 2         # width, n_gauss
             + [ctypes.c_void_p])         # stream


@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("scatter_grads").egr_scatter_add
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(acc, payload, ids):
    if acc.dtype != torch.float64 or acc.ndim != 2:
        raise ValueError(f"acc must be float64 [N, C], got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if payload.dtype != torch.float32 or payload.ndim != 2 \
            or payload.shape[1] != acc.shape[1]:
        raise ValueError(f"payload must be float32 [M, {acc.shape[1]}], got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != payload.shape[:1]:
        raise ValueError(f"ids must be int32 [{payload.shape[0]}], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    for name, x in (("acc", acc), ("payload", payload), ("ids", ids)):
        if x.device != acc.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{acc.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def scatter_add_reference(acc: torch.Tensor, payload: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain version: acc[ids[i]] += payload[i] in float64, for ids >= 0.
    In place; returns acc."""
    _check_inputs(acc, payload, ids)
    keep = ids >= 0
    acc.index_add_(0, ids[keep].to(torch.int64), payload[keep].to(acc.dtype))
    return acc


def scatter_add(acc: torch.Tensor, payload: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """acc [N, C] float64 += payload [M, C] float32 rows by ids [M] int32
    (-1 = skip).  In place; returns acc.

    CUDA tensors launch the kernel of csrc/scatter_grads.cu on the current
    stream (built at first use) and count the launch in
    `scatter_add.launches`; CPU tensors take scatter_add_reference.
    Anything else raises."""
    dev = acc.device
    if dev.type == "cpu":
        return scatter_add_reference(acc, payload, ids)
    if dev.type != "cuda":
        raise ValueError(f"scatter_add: no kernel for device {dev}")
    _check_inputs(acc, payload, ids)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(payload.data_ptr(), ids.data_ptr(),
                             acc.data_ptr(), payload.shape[0],
                             payload.shape[1], acc.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: cudaError "
                           f"{err}")
    scatter_add.launches += 1
    return acc


scatter_add.launches = 0
