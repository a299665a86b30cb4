"""The round-2 render kernel (csrc/render_table.cu) against its plain
PyTorch version, on the same CUDA tensors.  Needs a CUDA card and nvcc;
every test here skips without a card.  Imports neither jax nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_render_table_cuda.py

Kernel and plain version agree bit for bit (the port's float rules,
ops/precision.py).  Where no exit fires, the kernel's lanes also equal
render_culled's on the same candidates (both walk every listed cluster in
the same order); only the chunks lane counts differently (every computed
cluster here, clusters holding a valid Gaussian there).
"""

import functools

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    render_culled,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_table import (
    render_culled_table,
    render_culled_table_reference,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as gs
from editable_gaussian_reflections_tpu_torch.utils.synth import room_scene
from test_torch_render_kernel_cuda import _rays
from test_torch_trace_hits_cuda import (
    TIE_RAYS,
    boundary_tie_tensors,
    tie_stress_inputs,
)

pytestmark = pytest.mark.cuda

FAR = 50.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@functools.cache
def _room(scale, cluster, device):
    params = room_scene(2048)
    params["scaling"] = params["scaling"] + np.float32(np.log(scale))
    scene = gs.from_arrays(**params, pad_multiple=512, device=device)
    frames, attrs = gs.build_frames(scene, 0.005, 3.0, 1.0)
    perm = culling.morton_order(frames)
    frames, attrs = frames.take(perm), attrs.take(perm)
    return (layout.pack_frames(frames, attrs).contiguous(),
            layout.pack_attr_table(attrs).contiguous(),
            culling.cluster_bounds(frames, cluster))


# (K, cluster, tile, rays, secondary_static, alive, mc, Gaussian scale)
CASES = {
    "k32_c256_primary": (32, 256, 256, "primary", 0, False, 8, 1.0),
    "k16_c256_secondary_alive": (16, 256, 256, "secondary", 1, True, 8, 1.0),
    "k32_c128_dynamic_gate_odd_list": (32, 128, 128, "secondary", -1, False,
                                       7, 1.0),
    "k16_c128_early_exit": (16, 128, 256, "primary", 0, False, 16, 3.0),
}


def _call(case, device, fn, zero_near=False, **over):
    K, cluster, tile, kind, ss, with_alive, mc, scale = case
    gpack, table, bounds = _room(scale, cluster, device)
    o, d = _rays(kind, device)
    R = o.shape[0]
    near = 0.05 if kind == "primary" else 0.0
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, near, FAR, tile=tile, max_clusters=mc)
    if zero_near:
        cnear = torch.zeros_like(cnear)
    alive = None
    if with_alive:
        alive = (torch.arange(R, device=device) % 3) != 0
        alive[-tile:] = False
    kw = dict(max_hits=K, cluster=cluster, tile=tile, alive=alive,
              secondary_static=ss)
    kw.update(over)
    if fn is render_culled:
        return fn(o, d, gpack, cands, cnear, near, FAR, 3.0,
                  1.0 if ss else 0.0, 0.1, 0.9, **kw)
    return fn(o, d, gpack, table, cands, cnear, near, FAR, 3.0,
              1.0 if ss else 0.0, 0.1, 0.9, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference(case, cuda):
    before = render_culled_table.launches
    out = _call(CASES[case], cuda, render_culled_table)
    torch.cuda.synchronize()
    assert render_culled_table.launches == before + 1
    ref = _call(CASES[case], cuda, render_culled_table_reference)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("K,shared", [(16, True), (32, False)])
def test_boundary_tie(K, shared, cuda):
    """test_torch_trace_hits_cuda.boundary_tie_case through the round-2
    render (trace_tile.cuh's walk): the kernel composites what the plain
    version does, bit for bit."""
    (o, d, gpack, table, _f, cands, cnear), _a, _b = boundary_tie_tensors(
        cuda, K=K, shared=shared)
    args = (o, d, gpack, table, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    kw = dict(max_hits=K, cluster=128, tile=TIE_RAYS)
    out = render_culled_table(*args, **kw)
    ref = render_culled_table_reference(*args, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (ref[:, layout.OUT_NUMACC] == K).all()


@pytest.mark.parametrize("K,rays,seed", [(16, "primary", 0),
                                         (32, "reflected", 1)])
def test_tie_stress(K, rays, seed, cuda):
    """test_torch_trace_hits_cuda.tie_stress_inputs through the round-2
    render: bit for bit the plain version's lanes."""
    o, d, gpack, table, _f, cands, cnear, kw = tie_stress_inputs(cuda, rays,
                                                                 seed)
    args = (o, d, gpack, table, cands, cnear, 0.0, FAR, 3.0, 0.0, 0.1, 0.9)
    out = render_culled_table(*args, max_hits=K, **kw)
    ref = render_culled_table_reference(*args, max_hits=K, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_lanes_equal_render_culled_where_nothing_exits(cuda):
    # a zero threshold never saturates, and near distances of 0 put every
    # candidate ahead of any hit: both kernels walk every listed cluster
    case = CASES["k16_c256_secondary_alive"]
    a = _call(case, cuda, render_culled_table, zero_near=True,
              transmittance_threshold=0.0)
    b = _call(case, cuda, render_culled, zero_near=True,
              transmittance_threshold=0.0)
    torch.testing.assert_close(a[:, :layout.OUT_CHUNKS],
                               b[:, :layout.OUT_CHUNKS], rtol=0, atol=0)


def test_wrapper_checks_inputs(cuda):
    o, d = _rays("primary", cuda)
    gpack, table, bounds = _room(1.0, 256, cuda)
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, 0.05, FAR, tile=256, max_clusters=8)
    args = [o, d, gpack, table, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9]
    with pytest.raises(ValueError, match="table"):
        render_culled_table(*args[:3], table[:, :10].contiguous(), *args[4:])
    with pytest.raises(ValueError, match="max_hits"):
        render_culled_table(*args, max_hits=24)
    with pytest.raises(ValueError, match="candidates"):
        render_culled_table(*args[:4], cands.long(), *args[5:])
