"""The k-buffer's slot sort as a kernel of its own: per ray, K slots (t,
id) and A auxiliary blocks of K values ordered by (t, id), each auxiliary
value moving with its slot.  The CUDA kernel's wrapper (`sort_slots_aux`)
and its plain PyTorch version (`sort_slots_aux_reference`).

Counterpart of the inline Pallas kernel of tests/test_pallas_kernel.py
(test_sort_slots_orders_by_depth_with_aux) around trace_kernel.py's
_sort_slots.  That sort orders by (t, slot index); this one, like every
k-buffer walk of the port, by (t, id), and slots with equal (t, id) keep
their input order (the kernel's last key is the slot index).  The two
differ only in the order of slots with equal t and different ids: within
such a group, ids and auxiliary values are a permutation of _sort_slots'.

Layout (the Pallas test's): t [R, K] f32, ids [R, K] int32, aux [R, A*K]
f32 with block a in columns a*K .. a*K+K-1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .render_kernel import SHAPES_REFUSED, SUPPORTED_K, _check, sort_slots

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


def kernel_info(k: int) -> dict:
    """What the card's runtime reports of the compiled kernel at K = k:
    registers and spilled (local) bytes per thread, static shared memory
    per block and resident blocks per SM.  Needs a CUDA device."""
    if k not in SUPPORTED_K:
        raise ValueError(f"K={k}: the kernel is built for {SUPPORTED_K}")
    fn = build.load("sort_slots").egr_sort_slots_info
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(k, ctypes.addressof(out))
    if err == SHAPES_REFUSED:
        raise ValueError(f"sort_slots: no kernel for K={k}")
    if err != 0:
        raise RuntimeError(f"sort_slots kernel info failed: cudaError {err}")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3])


def sort_slots_aux_reference(t, ids, aux):
    """Plain PyTorch version: render_kernel.sort_slots (two stable sorts, by
    id and then by t) with each slot's index riding along, then the
    auxiliary blocks gathered through it."""
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
    `sort_slots_aux.launches` (and in `sort_slots_aux.launches_by_k[K]`);
    CPU tensors take sort_slots_aux_reference.  Anything else raises."""
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
    if err == SHAPES_REFUSED:
        raise ValueError(f"sort_slots: the kernel refused K={K}")
    if err != 0:
        raise RuntimeError(f"sort_slots kernel launch failed: cudaError "
                           f"{err}")
    sort_slots_aux.launches += 1
    sort_slots_aux.launches_by_k[K] += 1
    return t_out, ids_out, aux_out


sort_slots_aux.launches = 0
sort_slots_aux.launches_by_k = dict.fromkeys(SUPPORTED_K, 0)
