"""The fine-cluster (v5) render on the card against its plain PyTorch
version, and the refill/barrier ladder's grouped walk against
render_culled, on the same CUDA tensors.  Needs a CUDA card and nvcc; every
test here skips without a card.  Imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_render_fine_cuda.py

Bit for bit: render_culled_v5 is render_culled's kernel on v5's prepared
lists, and the grouped walk (tools/grouped_walk.cu) stages a whole exit
group of clusters at once but exits per group only, so it equals
render_culled at the same cluster, tile, check_every and near distances.
"""

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_fine import (
    prepare_v5,
    render_culled_v5,
    render_culled_v5_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    render_culled,
)
from editable_gaussian_reflections_tpu_torch.tools.refill_ladder import (
    grouped_walk,
)
from test_torch_render_kernel_cuda import _room, _rays

pytestmark = pytest.mark.cuda

FAR = 50.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (K, cluster, tile, rays, secondary_static, window_mode, alive, mc,
#  check_every, Gaussian scale)
CASES = {
    "k16_c64_primary": (16, 64, 128, "primary", 0, 0, False, 24, 8, 1.0),
    "k16_c32_secondary_alive": (16, 32, 128, "secondary", 1, 0, True, 40, 8,
                                1.0),
    "k32_c64_near_window_dynamic_gate": (32, 64, 128, "secondary", -1, 1,
                                         False, 20, 4, 1.0),
    "k16_c32_far_window": (16, 32, 128, "secondary", 1, 2, True, 33, 8, 1.0),
    "k16_c64_early_exit": (16, 64, 128, "primary", 0, 0, False, 32, 8, 3.0),
    # 16 clusters of 64 staged at once by the grouped walk: 90 KB of shared
    # memory
    "k16_c64_ce16_large_group": (16, 64, 128, "primary", 0, 0, False, 32, 16,
                                 3.0),
}


def _inputs(case, device):
    K, cluster, tile, kind, ss, wmode, with_alive, mc, ce, scale = case
    gpack, bounds = _room(scale, cluster, device)
    o, d = _rays(kind, device)
    R = o.shape[0]
    near = 0.05 if kind == "primary" else 0.0
    cands, cnear, num, _o, _t = culling.select_candidates(
        o, d, bounds, near, FAR, tile=tile, max_clusters=mc)
    alive = t_split = None
    if with_alive:
        alive = (torch.arange(R, device=device) % 3) != 0
        alive[-tile:] = False
    if wmode:
        t_split = torch.tensor(np.random.default_rng(7).uniform(
            1.0, 4.0, R).astype(np.float32), device=device)
    args = (o, d, gpack, cands, cnear, num, near, FAR, 3.0,
            1.0 if ss else 0.0, 0.1, 0.9)
    kw = dict(max_hits=K, cluster=cluster, tile=tile, alive=alive,
              check_every=ce, t_split=t_split, window_mode=wmode,
              secondary_static=ss)
    return args, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference_and_render_culled(case, cuda):
    args, kw = _inputs(CASES[case], cuda)
    before = render_culled.launches
    out = render_culled_v5(*args, **kw)
    torch.cuda.synchronize()
    assert render_culled.launches == before + 1
    ref = render_culled_v5_reference(*args, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert torch.isfinite(out).all()
    # the grouped walk on v5's prepared lists, at the same group size
    cands, near_t, ce = prepare_v5(args[3], args[4], kw["cluster"],
                                   kw["check_every"])
    grouped = grouped_walk(*args[:3], cands, near_t, *args[6:],
                           **dict(kw, check_every=ce))
    torch.testing.assert_close(out, grouped, rtol=0, atol=0)


def test_early_exit_fired(cuda):
    args, kw = _inputs(CASES["k16_c64_early_exit"], cuda)
    out = render_culled_v5(*args, **kw)
    listed = (args[3] >= 0).sum(dim=1)
    processed = out[::kw["tile"], layout.OUT_CHUNKS]
    assert (processed < listed).any()


def test_wrapper_checks_inputs(cuda):
    args, kw = _inputs(CASES["k16_c64_primary"], cuda)
    with pytest.raises(ValueError, match="debug_mode"):
        render_culled_v5(*args, **dict(kw, debug_mode=1))
    with pytest.raises(ValueError, match="max_hits"):
        render_culled_v5(*args, **dict(kw, max_hits=24))
    with pytest.raises(ValueError, match="shared memory"):
        grouped_walk(*args[:5], *args[6:], **dict(kw, check_every=64))
    with pytest.raises(ValueError, match="candidates"):
        render_culled(*args[:3], args[3].long(), *args[4:5], *args[6:], **kw)
