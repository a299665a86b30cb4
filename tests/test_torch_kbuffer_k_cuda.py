"""The k-buffer kernels at K 8 and K 64 on the card, against their plain
PyTorch versions on the same CUDA tensors: render_culled, trace_slots (exit
modes 0 and 1, the split-far windows), trace_hits (brute and culled),
render_table and the slot sort, at the shapes of the K 16 / K 32 cases of
the kernels' own card tests.  Needs a CUDA card and nvcc; every test here
skips without a card.  Imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_kbuffer_k_cuda.py

(--noconftest: the suite's conftest imports jax.)  The tests carry the
`cuda` marker.

Beside those cases:
  * slot 63 on a cluster's list: at K 64 a ray whose 64th kept hit comes
    from a cluster that already holds others, so that the cluster's next
    hit joins its list behind slot 63 (the list code's sentinel lies above
    every slot of K 64, csrc/trace_hits_walk.cuh);
  * trace_slots at K 64 with the Config's 256-ray tiles and 256-Gaussian
    clusters, whose epilogue stages each slot block in two parts;
  * K 24, which no kernel is built for: every wrapper raises a ValueError
    naming the built set, and every C entry point, reached with the
    wrapper's check lifted, returns SHAPES_REFUSED instead of running
    another K's kernel.

Every output equal, bit for bit (the kernels and the plain versions share
the numerics of ops/precision.py).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda import (
    render_kernel as rk,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import (
    render_table as rtab,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import (
    sort_slots as ss,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import (
    trace_hits as th,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import (
    trace_slots as ts,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as gs
from test_torch_render_kernel_cuda import _call as render_call
from test_torch_render_table_cuda import _call as table_call
from test_torch_trace_hits_cuda import OUTPUTS, _trace
from test_torch_train_cuda import _rays as slots_rays
from test_torch_train_cuda import _slots, _tables

# every test here needs the card; each decides in the `cuda` fixture
pytestmark = pytest.mark.cuda

FAR = 50.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(a, b, name=""):
    assert a.shape == b.shape, name
    torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# render_culled: (K, cluster, tile, rays, secondary_static, window_mode,
# alive, mc, check_every, Gaussian scale), test_torch_render_kernel_cuda's
RENDER_CASES = {
    "k8_c256_primary": (8, 256, 256, "primary", 0, 0, False, 8, 8, 1.0),
    "k8_c128_dynamic_gate_near_window_ce4": (8, 128, 128, "secondary", -1, 1,
                                             False, 8, 4, 1.0),
    "k64_c128_primary": (64, 128, 256, "primary", 0, 0, False, 16, 8, 1.0),
    "k64_c128_far_window_alive": (64, 128, 256, "secondary", 1, 2, True, 12,
                                  8, 1.0),
    "k64_c128_early_exit_ce4": (64, 128, 256, "primary", 0, 0, False, 16, 4,
                                3.0),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_culled_matches_reference(case, cuda):
    before = rk.render_culled.launches
    out = render_call(RENDER_CASES[case], cuda, rk.render_culled)
    torch.cuda.synchronize()
    assert rk.render_culled.launches == before + 1
    ref = render_call(RENDER_CASES[case], cuda, rk.render_culled_reference)
    _equal(out, ref)
    assert (out[:, layout.OUT_NUMACC] > 0).any()


# trace_slots: (K, cluster, rays, exit_mode, check_every, mc),
# test_torch_train_cuda's; K 64 at cluster 256 stages its epilogue in two
# parts in the stage ring, at cluster 128 after the slot columns
SLOTS_CASES = {
    "k8_c256_primary_v4": (8, 256, "primary", 0, 8, 8),
    "k8_c128_secondary_dead_v1": (8, 128, "secondary", 1, 2, 16),
    "k64_c256_primary_v4": (64, 256, "primary", 0, 8, 8),
    "k64_c256_secondary_dead_v1": (64, 256, "secondary", 1, 2, 8),
    "k64_c128_secondary_dead_v4": (64, 128, "secondary", 0, 8, 16),
}


@pytest.mark.parametrize("case", sorted(SLOTS_CASES))
def test_trace_slots_matches_reference(case, cuda):
    before = ts.trace_slots.launches
    slots, acc = _slots(SLOTS_CASES[case], cuda, ts.trace_slots)
    torch.cuda.synchronize()
    assert ts.trace_slots.launches == before + 1
    ref_slots, ref_acc = _slots(SLOTS_CASES[case], cuda,
                                ts.trace_slots_reference)
    _equal(acc, ref_acc, "acc")
    _equal(slots, ref_slots, "slots")
    K = SLOTS_CASES[case][0]
    t = slots.reshape(slots.shape[0], layout.SLOT_BLOCKS, K)[:, layout.SLOT_T]
    assert (t < layout.INF).any()


# split-far's passes: (K, cluster, window_mode, mc)
WINDOW_CASES = {"k8_c256_far": (8, 256, 2, 16),
                "k64_c128_near": (64, 128, 1, 16)}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_trace_slots_window_matches_reference(case, cuda):
    """The windowed kernel (window_mode 1 near, 2 far) on reflected rays,
    culled over the window as the step culls them."""
    K, cluster, wmode, mc = WINDOW_CASES[case]
    gpack, table, ftable, bounds = _tables(cluster, cuda)
    o, d, alive = slots_rays("secondary", cuda)
    t_split = torch.tensor(np.random.default_rng(7).uniform(
        1.0, 6.0, o.shape[0]).astype(np.float32), device=cuda)
    cull_near, cull_far = rt.window_bounds(0.0, FAR, t_split, wmode, 256)
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, cull_near, cull_far, tile=256, max_clusters=mc)
    args = (o, d, gpack, table, ftable, cands, cnear, 0.0, FAR, 3.0, 1.0,
            0.1, 0.9)
    kw = dict(max_hits=K, cluster=cluster, tile=256, alive=alive,
              secondary_static=1, t_split=t_split, window_mode=wmode)
    slots, acc = ts.trace_slots(*args, **kw)
    ref_slots, ref_acc = ts.trace_slots_reference(*args, **kw)
    _equal(acc, ref_acc, "acc")
    _equal(slots, ref_slots, "slots")


# trace_hits: (mode, rays, K, cluster, candidates, ray count),
# test_torch_trace_hits_cuda's
TRACE_CASES = {
    "brute_primary_k8": ("brute", "primary", 8, 256, 0, 1280),
    "culled_reflected_k8_c128": ("culled", "reflected", 8, 128, 24, 1280),
    "brute_reflected_k64_ragged": ("brute", "reflected", 64, 256, 0, 1000),
    "culled_primary_k64": ("culled", "primary", 64, 256, 12, 1280),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_hits_matches_reference(case, cuda):
    before = th.trace_hits.launches
    out = _trace(TRACE_CASES[case], cuda, th.trace_hits)
    torch.cuda.synchronize()
    assert th.trace_hits.launches == before + 1
    ref = _trace(TRACE_CASES[case], cuda, th.trace_hits_reference)
    out = out[:5] + out[6:]
    for name, a, b in zip(OUTPUTS[:5] + OUTPUTS[6:], out, ref):
        _equal(a, b, name)
    assert (out[0] < 1e37).any()


# render_table: (K, cluster, tile, rays, secondary_static, alive, mc,
# Gaussian scale), test_torch_render_table_cuda's
TABLE_CASES = {
    "k8_c256_primary": (8, 256, 256, "primary", 0, False, 8, 1.0),
    "k64_c128_secondary_alive": (64, 128, 256, "secondary", 1, True, 8, 1.0),
    "k64_c128_early_exit": (64, 128, 256, "primary", 0, False, 16, 3.0),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_render_table_matches_reference(case, cuda):
    before = rtab.render_culled_table.launches
    out = table_call(TABLE_CASES[case], cuda, rtab.render_culled_table)
    torch.cuda.synchronize()
    assert rtab.render_culled_table.launches == before + 1
    ref = table_call(TABLE_CASES[case], cuda,
                     rtab.render_culled_table_reference)
    _equal(out, ref)


# the slot sort: (K, rays, case); at K 8 a ray on 8 lanes (32 rays a
# block), at K 64 on a warp holding two slots a lane (8 rays a block); the
# ray counts leave a partial last block
SORT_CASES = [(8, 4099, "ties"), (8, 4096, "empty_rays"),
              (64, 4097, "ties"), (64, 4096, "empty_rays")]


@pytest.mark.parametrize("K, R, case", SORT_CASES)
def test_sort_matches_reference(K, R, case, cuda):
    """test_torch_sort_dtype_cuda's inputs at K 8 and K 64: exact ties,
    empty slots, rays whose every slot is (3e38, one id)."""
    rng = np.random.default_rng(K)
    A = 5
    t = rng.uniform(0, 10, (R, K)).astype(np.float32)
    t[:, 3] = t[:, 5]
    t[::7, ::3] = 3.0e38
    ids = rng.integers(0, 50, (R, K)).astype(np.int32)
    if case == "empty_rays":
        t[::5] = 3.0e38
        ids[::5] = 9
    aux = rng.normal(size=(R, A * K)).astype(np.float32)
    args = [torch.tensor(a, device=cuda) for a in (t, ids, aux)]
    before = ss.sort_slots_aux.launches
    out = ss.sort_slots_aux(*args)
    assert ss.sort_slots_aux.launches == before + 1
    ref = ss.sort_slots_aux_reference(*args)
    for name, a, b in zip(("t", "ids", "aux"), out, ref):
        _equal(a, b, name)


# -- slot 63 on a cluster's list ----------------------------------------------

RAYS63, CLUSTER63, HITS63 = 256, 128, 40


def slot63_inputs(device, shared: bool):
    """Two clusters of 128 Gaussians, HITS63 of each on the rays' axis (the
    rest far off it): cluster 0's hits at depths 10-11, cluster 1's at 1-2,
    each cluster's in shuffled depth order, listed [0, 1] at near distance
    0 for one tile of RAYS63 rays along +z.  At K 64 cluster 0 fills slots
    0-39 and cluster 1 slots 40-63; cluster 1's 25th hit then replaces
    cluster 0's deepest and joins cluster 1's list behind slot 63, and so do
    the rest.  shared: every ray starts at the origin (one origin, the
    walk's shared terms), else each a little further back along the axis.
    Returns (gpack, attribute table, frame table, candidates, cand_near,
    rays_o, rays_d)."""
    rng = np.random.default_rng(63)
    n = 2 * CLUSTER63
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = 50.0                      # off the axis: never hit
    for c, depth in ((0, 10.0), (1, 1.0)):
        on = c * CLUSTER63 + np.arange(HITS63)
        xyz[on, 0] = 0.0
        xyz[on, 2] = depth + rng.permutation(HITS63) / HITS63
    params = dict(
        xyz=xyz, scaling=np.full((n, 3), np.log(0.05), np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full(n, -3.0, np.float32),
        diffuse=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        normal=np.tile(np.array([0, 0, -1], np.float32), (n, 1)),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=np.full(n, 0.5, np.float32))
    scene = gs.from_arrays(**params, pad_multiple=CLUSTER63, device=device)
    frames, attrs = gs.build_frames(scene, 0.005, 3.0, 1.0)
    o = np.zeros((RAYS63, 3), np.float32)
    if not shared:
        o[:, 2] = -1e-3 * np.arange(RAYS63)
    d = np.tile(np.array([0, 0, 1], np.float32), (RAYS63, 1))
    return (layout.pack_frames(frames, attrs).contiguous(),
            layout.pack_attr_table(attrs).contiguous(),
            layout.pack_frame_table(frames, scene).contiguous(),
            torch.tensor([[0, 1]], dtype=torch.int32, device=device),
            torch.zeros((1, 2), dtype=torch.float32, device=device),
            torch.tensor(o, device=device), torch.tensor(d, device=device))


KERNELS63 = ("render_culled", "trace_slots", "trace_hits", "render_table")


def _slot63_call(kernel, inputs, plain: bool):
    gpack, table, ftable, cands, cnear, o, d = inputs
    kw = dict(max_hits=64, cluster=CLUSTER63, tile=RAYS63)
    if kernel == "render_culled":
        fn = rk.render_culled_reference if plain else rk.render_culled
        return fn(o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9,
                  transmittance_threshold=1e-4, **kw)
    if kernel == "trace_slots":
        fn = ts.trace_slots_reference if plain else ts.trace_slots
        return fn(o, d, gpack, table, ftable, cands, cnear, 0.05, FAR, 3.0,
                  0.0, 0.1, 0.9, transmittance_threshold=1e-4, **kw)
    if kernel == "trace_hits":
        if plain:
            return th.trace_hits_reference(
                o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9,
                transmittance_threshold=1e-4, **kw)
        out = th.trace_hits(o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0,
                            0.1, 0.9, transmittance_threshold=1e-4, **kw)
        return out[:5] + out[6:]       # the attributes are not asked for
    fn = rtab.render_culled_table_reference if plain \
        else rtab.render_culled_table
    return fn(o, d, gpack, table, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1,
              0.9, transmittance_threshold=1e-4, **kw)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "apart"])
@pytest.mark.parametrize("kernel", KERNELS63)
def test_slot_63_on_a_cluster_list(kernel, shared, cuda):
    inputs = slot63_inputs(cuda, shared)
    gpack, table, ftable, cands, cnear, o, d = inputs
    # the construction: the plain version keeps all of cluster 1's hits and
    # cluster 0's 24 nearest on every ray, so more than 24 of cluster 1's
    # hits arrived after the ray's 64 slots had filled
    slots, _acc = _slot63_call("trace_slots", inputs, plain=True)
    ids = slots.reshape(RAYS63, layout.SLOT_BLOCKS, 64)[:, layout.SLOT_ID]
    in1 = (ids >= CLUSTER63).sum(dim=1)
    assert (in1 == HITS63).all() and ((ids < CLUSTER63).sum(dim=1)
                                      == 64 - HITS63).all()
    out = _slot63_call(kernel, inputs, plain=False)
    torch.cuda.synchronize()
    ref = _slot63_call(kernel, inputs, plain=True)
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    for i, (a, b) in enumerate(zip(out, ref)):
        _equal(a, b, f"output {i}")


# -- K 24: refused everywhere --------------------------------------------------

# the modules that read SUPPORTED_K
K_MODULES = (rk, ts, rtab, th, ss)


def _k24_calls(cuda):
    """Each wrapper's call at K 24 on inputs its K 16 case takes."""
    case = (24, 256, 256, "primary", 0, 0, False, 8, 8, 1.0)
    return {
        "render_culled": lambda: render_call(case, cuda, rk.render_culled),
        "trace_slots": lambda: _slots((24, 256, "primary", 0, 8, 8), cuda,
                                      ts.trace_slots),
        "trace_hits": lambda: _trace(("culled", "primary", 24, 256, 12,
                                      1280), cuda, th.trace_hits),
        "render_table": lambda: table_call(
            (24, 256, 256, "primary", 0, False, 8, 1.0), cuda,
            rtab.render_culled_table),
        "sort_slots": lambda: ss.sort_slots_aux(
            torch.zeros((64, 24), device=cuda),
            torch.zeros((64, 24), dtype=torch.int32, device=cuda),
            torch.zeros((64, 24), device=cuda)),
        "trace_hits_info": lambda: th.kernel_info(24),
        "render_culled_info": lambda: th.kernel_info(24,
                                                     kernel="render_culled"),
        "trace_slots_info": lambda: th.kernel_info(24, kernel="trace_slots"),
        "sort_slots_info": lambda: ss.kernel_info(24),
    }


ENTRIES = ("render_culled", "trace_slots", "trace_hits", "render_table",
           "sort_slots")


@pytest.mark.parametrize("entry", ENTRIES)
def test_k24_raises_in_the_wrapper(entry, cuda):
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64\)"):
        _k24_calls(cuda)[entry]()


@pytest.mark.parametrize("entry", ENTRIES + ("trace_hits_info",
                                             "render_culled_info",
                                             "trace_slots_info",
                                             "sort_slots_info"))
def test_k24_is_refused_by_the_c_entry_point(entry, cuda):
    """With the wrappers' check lifted, K 24 reaches the C entry point,
    which returns SHAPES_REFUSED (the wrapper's ValueError), and no kernel
    is launched."""
    launches = {m: m.__dict__.get(n) for m, n in (
        (rk, "render_culled"), (ts, "trace_slots"), (th, "trace_hits"),
        (rtab, "render_culled_table"), (ss, "sort_slots_aux"))}
    before = {m: f.launches for m, f in launches.items()}
    lifted = (8, 16, 24, 32, 64)
    with mock.patch.multiple(rk, SUPPORTED_K=lifted), \
            mock.patch.multiple(ts, SUPPORTED_K=lifted), \
            mock.patch.multiple(rtab, SUPPORTED_K=lifted), \
            mock.patch.multiple(th, SUPPORTED_K=lifted), \
            mock.patch.multiple(ss, SUPPORTED_K=lifted):
        with pytest.raises(ValueError, match="refused|no kernel"):
            _k24_calls(cuda)[entry]()
    torch.cuda.synchronize()
    assert {m: f.launches for m, f in launches.items()} == before
