"""The k-buffer's slot sort as a kernel of its own: per ray, K slots (t,
id) and A auxiliary blocks of K values ordered by (t, id), each auxiliary
value moving with its slot.  The CUDA kernel's wrapper (`sort_slots_aux`)
and its plain PyTorch version (`sort_slots_aux_reference`).

Counterpart of the inline Pallas kernel of tests/test_pallas_kernel.py
(test_sort_slots_orders_by_depth_with_aux) around trace_kernel.py's
_sort_slots.  That sort orders by (t, slot index); this one, like every
k-buffer walk of the port (csrc/trace_tile.cuh sort_slots), by (t, id).
The two differ only in the order of slots with equal t: within such a
group, ids and auxiliary values are a permutation of _sort_slots'.

Layout (the Pallas test's): t [R, K] f32, ids [R, K] int32, aux [R, A*K]
f32 with block a in columns a*K .. a*K+K-1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .render_kernel import _check, sort_slots

SUPPORTED_K = (16, 32)

_ARGTYPES = (
    [ctypes.c_void_p] * 6          # t, ids, aux, t_out, ids_out, aux_out
    + [ctypes.c_int] * 3           # n_rays, k, n_aux
    + [ctypes.c_void_p]            # stream
)


@functools.cache
def _entry_point():
    """The kernel's C entry point, built and loaded at first use."""
    fn = build.load("sort_slots").egr_sort_slots
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def sort_slots_aux_reference(t, ids, aux):
    """Plain PyTorch version: render_kernel.sort_slots with each slot's
    index riding along, then the auxiliary blocks gathered through it."""
    R, K = t.shape
    A = aux.shape[1] // K
    slot = torch.arange(K, device=t.device).expand(R, K)
    st, perm, sid = sort_slots(t, slot, ids)
    blocks = aux.reshape(R, A, K).gather(2, perm[:, None, :].expand(R, A, K))
    return st, sid, blocks.reshape(R, A * K)


def sort_slots_aux(t, ids, aux):
    """(t, ids, aux) sorted per ray by (t, id).

    CUDA tensors launch the kernel of csrc/sort_slots.cu on the current
    stream (it is built at first use) and count the launch in
    `sort_slots_aux.launches`; CPU tensors take sort_slots_aux_reference.
    Anything else raises."""
    dev = t.device
    if dev.type == "cpu":
        return sort_slots_aux_reference(t, ids, aux)
    if dev.type != "cuda":
        raise ValueError(f"sort_slots_aux: no kernel for device {dev}")
    R, K = t.shape
    if K not in SUPPORTED_K:
        raise ValueError(f"K={K}: the kernel is built for {SUPPORTED_K}")
    if aux.shape[1] % K:
        raise ValueError(f"aux has {aux.shape[1]} columns, not a multiple "
                         f"of K={K}")
    A = aux.shape[1] // K
    _check("t", t, (R, K), torch.float32, dev)
    _check("ids", ids, (R, K), torch.int32, dev)
    _check("aux", aux, (R, A * K), torch.float32, dev)
    t_out, ids_out, aux_out = (torch.empty_like(x) for x in (t, ids, aux))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry_point()(
            t.data_ptr(), ids.data_ptr(), aux.data_ptr(), t_out.data_ptr(),
            ids_out.data_ptr(), aux_out.data_ptr(), R, K, A, stream)
    if err != 0:
        raise RuntimeError(f"sort_slots kernel launch failed: cudaError "
                           f"{err}")
    sort_slots_aux.launches += 1
    return t_out, ids_out, aux_out


sort_slots_aux.launches = 0
