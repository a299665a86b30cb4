"""The slot-sort kernel (csrc/sort_slots.cu) and the dtype micro-benchmark
kernels (csrc/bench_dtype.cu) against their plain PyTorch versions, on the
same CUDA tensors.  Needs a CUDA card and nvcc; every test here skips
without a card.  Imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_sort_dtype_cuda.py

The sort and both mixes agree bit for bit (infinities equal), the sort on
exact (t, id) ties, whole rays of one empty (3e38, id) slot, and ray counts
that leave a block or a warp part-filled; the mixes at 16 rounds and at the
tool's 512, and on the shapes the kernels' grid and element groups meet at
their edges: 0 rounds, one element pair, a ragged n (the last group of E
elements or P pairs part-filled), an n that makes the grid stride more than
once, and a block not aligned for 16-byte loads.  PyTorch takes a bf16
product or sum in float32 and rounds it to bf16, which for two bf16
operands gives the correctly rounded result that the packed instruction
gives; the exp is discussed in csrc/bench_dtype.cu.
"""

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
    kernel_info,
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


# (K, rays, case): the kernel takes 8 rays a block at K 32 and 16 at K 16,
# a ray on a warp (K 32) or a half-warp (K 16)
SORT_CASES = [(16, 4096, "ties"), (32, 4096, "ties"),
              (32, 4096, "empty_rays"), (16, 4096, "empty_rays"),
              (32, 4099, "ties"), (16, 4097, "ties")]


@pytest.mark.parametrize("K, R, case", SORT_CASES)
def test_sort_matches_reference(K, R, case, cuda):
    rng = np.random.default_rng(K)
    A = 5
    t = rng.uniform(0, 10, (R, K)).astype(np.float32)
    t[:, 3] = t[:, 5]
    t[::7, ::3] = 3.0e38
    ids = rng.integers(0, 50, (R, K)).astype(np.int32)
    if case == "empty_rays":    # every slot (3e38, one id): input order
        t[::5] = 3.0e38
        ids[::5] = 9
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


def _mix_case(case, device):
    """(x, reps) of a case of test_mix_edges."""
    def draw(n):
        return torch.tensor(np.random.default_rng(n).uniform(0.1, 0.9, n),
                            dtype=torch.float32, device=device)

    if case == "reps0":
        return draw(8192), 0
    if case == "one_pair":
        return draw(2), 16
    if case == "ragged":     # not a multiple of E x threads x SMs, nor of 4
        return draw(2 * 67_589), 16
    if case == "unaligned":  # 4 bytes past a 16-byte boundary
        return draw(4098)[1:-1], 16
    # more elements than the resident threads carry in one pass
    once = 0
    for dtype in (torch.float32, torch.bfloat16):
        info = kernel_info(dtype)
        once = max(once, info["sms"] * info["blocks_per_sm"] * info["threads"]
                   * info["per_thread"] * (2 if dtype == torch.bfloat16
                                           else 1))
    return draw(2 * once + 6), 16


@pytest.mark.parametrize("case", ["reps0", "one_pair", "ragged", "unaligned",
                                  "strides"])
def test_mix_edges(case, cuda):
    x, reps = _mix_case(case, cuda)
    for dtype in (torch.float32, torch.bfloat16):
        out = mix(x, reps, dtype)
        assert out.shape == x.shape
        assert torch.equal(out, mix_reference(x, reps, dtype)), dtype
