"""The slot-sort kernel (csrc/sort_slots.cu) and the dtype micro-benchmark
kernels (csrc/bench_dtype.cu) against their plain PyTorch versions, on the
same CUDA tensors.  Needs a CUDA card and nvcc; every test here skips
without a card.  Imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_sort_dtype_cuda.py

The sort and both mixes agree bit for bit (infinities equal), the mixes at
16 rounds and at the tool's 512.  PyTorch takes a bf16 product or sum in
float32 and rounds it to bf16, which for two bf16 operands gives the
correctly rounded result that the packed instruction gives; the exp is
discussed in csrc/bench_dtype.cu.
"""

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
    mix,
    mix_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
    sort_slots_aux,
    sort_slots_aux_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("K", [16, 32])
def test_sort_matches_reference(K, cuda):
    rng = np.random.default_rng(K)
    R, A = 4096, 5
    t = rng.uniform(0, 10, (R, K)).astype(np.float32)
    t[:, 3] = t[:, 5]
    t[::7, ::3] = 3.0e38
    ids = rng.integers(0, 50, (R, K)).astype(np.int32)
    aux = rng.normal(size=(R, A * K)).astype(np.float32)
    args = [torch.tensor(a, device=cuda) for a in (t, ids, aux)]
    before = sort_slots_aux.launches
    out = sort_slots_aux(*args)
    assert sort_slots_aux.launches == before + 1
    ref = sort_slots_aux_reference(*args)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mix_matches_reference(cuda):
    x = torch.tensor(np.random.default_rng(0).uniform(0.1, 0.9, (64, 128)),
                     dtype=torch.float32, device=cuda)
    before = mix.launches
    for reps in (16, 512):
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(mix(x, reps, dtype),
                               mix_reference(x, reps, dtype)), (reps, dtype)
    assert mix.launches == before + 4
