"""The training kernels on the card: the slots trace (csrc/trace_slots.cu)
and the gradient scatter (csrc/scatter_grads.cu) against their plain
PyTorch versions on the same CUDA tensors, and the training step on the
card against itself (batched tiles vs one tile per launch) and against the
CPU.  Needs a CUDA card and nvcc; every test here skips without a card.
Imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest tests/test_torch_train_cuda.py

(--noconftest: the suite's conftest imports jax.)  The tests carry the
`cuda` marker.

The slots trace is held to its plain version on cases of the step's own
passes (both exit modes) and on design cases aimed at the walk it shares
with trace_hits and render_culled (csrc/trace_hits_walk.cuh): clusters of
50 (padded to 52, staged with 4-byte copies), empty list entries and an
all-invalid cluster, exact depth ties, blocks of one origin beside blocks
of several, Gaussians thin enough that |ld|^2 passes 2^126 (the walk's
division), the backfacing test gated on `secondary`, and saturation exits
before every position of a list in exit modes 0 and 1, with dead rays.

Tolerances: slots and counters equal (the kernel and the plain version
share float32 pair math without FMA, float64 exp/log1p and float64 sums,
and sort the kept hits by (t, id)); the scatter's float64 sums rounded once
to float32 equal to 1e-6 * scale with exact zeros equal; the training
steps equal bit for bit (ops/precision.py: every reduction whose order a
device picks runs in float64 and is rounded once).
"""

import functools

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.camera_rays import (
    primary_ray_directions,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.scatter import (
    scatter_add,
    scatter_add_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_slots import (
    trace_slots,
    trace_slots_reference,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as gs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from test_torch_trace_hits_cuda import (
    TIE_RAYS,
    boundary_tie_tensors,
    exit_tile_chunks,
    exit_tile_inputs,
    mixed_alive,
    tie_stress_inputs,
    walk_design_inputs,
)

# every test here needs the card; each decides in the `cuda` fixture
pytestmark = pytest.mark.cuda

FAR = 50.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@functools.cache
def _tables(cluster, device):
    scene = gs.from_arrays(**room_scene(2048), pad_multiple=512,
                           device=device)
    _f, _a, gpack, cull, _s, _p = tr.prepare_render_inputs(
        scene, rt.RenderSettings(), True, True, 256, cluster, 16)
    return gpack, cull["table"], cull["ftable"], cull["bounds"]


def _rays(kind, device, H=32, W=32):
    eye, c2w = room_camera()
    perm, _ = culling.tile_pixel_order(H, W, 16, 16)
    d = primary_ray_directions(W, H, 0.9, torch.tensor(c2w)).reshape(-1, 3)
    d = d[torch.as_tensor(perm, dtype=torch.int64)].numpy()
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    alive = None
    if kind == "secondary":
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        alive = (torch.arange(H * W, device=device) % 3) != 0
        alive[-256:] = False
    return (torch.tensor(np.ascontiguousarray(o), device=device),
            torch.tensor(np.ascontiguousarray(d), device=device), alive)


# (K, cluster, rays, exit_mode, check_every, mc)
CASES = {
    "k16_c256_primary_v4": (16, 256, "primary", 0, 8, 8),
    "k32_c256_secondary_dead_v4": (32, 256, "secondary", 0, 8, 16),
    "k16_c128_primary_v1": (16, 128, "primary", 1, 2, 16),
    "k32_c256_secondary_dead_v1": (32, 256, "secondary", 1, 2, 8),
}


def _slots(case, device, fn):
    K, cluster, kind, exit_mode, ce, mc = case
    gpack, table, ftable, bounds = _tables(cluster, device)
    o, d, alive = _rays(kind, device)
    near = 0.05 if kind == "primary" else 0.0
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, near, FAR, tile=256, max_clusters=mc)
    ss = 1 if kind == "secondary" else 0
    return fn(o, d, gpack, table, ftable, cands, cnear, near, FAR, 3.0,
              float(ss), 0.1, 0.9, max_hits=K, cluster=cluster, tile=256,
              alive=alive, secondary_static=ss, exit_mode=exit_mode,
              check_every=ce)


# (rays, K, cluster, tile, ray count, Gaussian count, exp_power, lists,
# special, secondary_static, secondary, exit_mode, alive, check_every):
# walk_design_inputs' rays, lists and special; lists "exits" are
# exit_tile_inputs' tiles of 64 rays (the other shape fields unused)
DESIGN = {
    "walk_k32_c50_tile100_hand_v4": ("primary", 32, 50, 100, 1000, 4050, 3.0,
                                     "hand", "invalid_cluster", 0, 0.0, 0,
                                     False, 8),
    "walk_k16_c50_reflected_pow2_hand_v1": ("reflected", 16, 50, 200, 1000,
                                            4050, 2.0, "hand",
                                            "invalid_cluster", -1, 1.0, 1,
                                            True, 2),
    "walk_k16_ties_all_v1": ("primary", 16, 256, 256, 512, 4096, 2.0, "all",
                             "ties", 0, 0.0, 1, False, 2),
    "walk_k32_mixed_origin_pow2_5_v4": ("mixed", 32, 128, 128, 1024, 4096,
                                        2.5, "select", "", 0, 0.0, 0, False,
                                        8),
    "walk_k16_thin_all_v4": ("primary", 16, 256, 256, 768, 4096, 3.0, "all",
                             "thin", 0, 0.0, 0, False, 8),
    "walk_k32_reflected_gate_off_v4": ("reflected", 32, 128, 128, 1024, 4096,
                                       3.0, "select", "", -1, 0.0, 0, True,
                                       8),
    "walk_k16_exits_v4": ("primary", 16, 256, 64, 0, 0, 3.0, "exits", "", 0,
                          0.0, 0, True, 1),
    "walk_k32_exits_v1": ("primary", 32, 256, 64, 0, 0, 3.0, "exits", "", 0,
                          0.0, 1, True, 2),
}


def _design_slots(case, device, fn):
    (kind, K, cluster, tile, n_rays, n_gauss, exp_power, lists, special, ss,
     secondary, exit_mode, with_alive, ce) = DESIGN[case]
    thr = 0.01
    if lists == "exits":
        o, d, gpack, table, ftable, cands, cnear, alive, thr = (
            exit_tile_inputs(device, tile))
        near = 0.05
    else:
        o, d, gpack, table, ftable, cands, cnear, near = walk_design_inputs(
            device, kind, cluster, tile, n_rays, n_gauss, lists, special)
        alive = mixed_alive(n_rays, tile, device) if with_alive else None
    return fn(o, d, gpack, table, ftable, cands, cnear, near, FAR, exp_power,
              secondary, 10.0 if ss else 0.1, 0.9,
              transmittance_threshold=thr, max_hits=K, cluster=cluster,
              tile=tile, alive=alive, secondary_static=ss,
              exit_mode=exit_mode, check_every=ce)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(DESIGN))
def test_trace_slots_kernel_matches_reference(case, cuda):
    call = _design_slots if case in DESIGN else (
        lambda c, dev, fn: _slots(CASES[c], dev, fn))
    before = trace_slots.launches
    slots, acc = call(case, cuda, trace_slots)
    torch.cuda.synchronize()
    assert trace_slots.launches == before + 1
    ref_slots, ref_acc = call(case, cuda, trace_slots_reference)
    torch.testing.assert_close(acc, ref_acc, rtol=0, atol=0)
    torch.testing.assert_close(slots, ref_slots, rtol=0, atol=0)
    K = DESIGN[case][1] if case in DESIGN else CASES[case][0]
    t = slots.reshape(-1, layout.SLOT_BLOCKS, K)[:, layout.SLOT_T]
    assert (t < 1e37).any()
    if case in DESIGN and DESIGN[case][7] == "exits":
        chunks = ref_acc[::64, 2].tolist()
        assert chunks == exit_tile_chunks(DESIGN[case][11],
                                          DESIGN[case][13])


# the boundary-tie case on trace_slots: (K, rays share the origin, exit
# mode, check_every)
TIE_CASES = {
    "k16_shared_v4": (16, True, 0, 8),
    "k32_apart_v1": (32, False, 1, 2),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_trace_slots_boundary_tie(case, cuda):
    """test_torch_trace_hits_cuda.boundary_tie_case through trace_slots:
    the kernel keeps the plain version's Gaussians, A and not B, and every
    slot block and counter equals the plain version's."""
    K, shared, exit_mode, ce = TIE_CASES[case]
    (o, d, gpack, table, ftable, cands, cnear), a, b = boundary_tie_tensors(
        cuda, K=K, shared=shared)
    args = (o, d, gpack, table, ftable, cands, cnear, 0.05, FAR, 3.0, 0.0,
            0.1, 0.9)
    kw = dict(max_hits=K, cluster=128, tile=TIE_RAYS, exit_mode=exit_mode,
              check_every=ce)
    slots, acc = trace_slots(*args, **kw)
    ref_slots, ref_acc = trace_slots_reference(*args, **kw)
    torch.testing.assert_close(acc, ref_acc, rtol=0, atol=0)
    torch.testing.assert_close(slots, ref_slots, rtol=0, atol=0)
    ids = ref_slots.reshape(-1, layout.SLOT_BLOCKS, K)[:, layout.SLOT_ID]
    assert (ids == a).any(dim=1).all() and not (ids == b).any()


def test_trace_slots_tie_stress(cuda):
    """test_torch_trace_hits_cuda.tie_stress_inputs through trace_slots
    (K 32, reflected rays): every slot block and counter equals the plain
    version's."""
    o, d, gpack, table, ftable, cands, cnear, kw = tie_stress_inputs(
        cuda, "reflected", 1)
    args = (o, d, gpack, table, ftable, cands, cnear, 0.0, FAR, 3.0, 0.0,
            0.1, 0.9)
    slots, acc = trace_slots(*args, max_hits=32, **kw)
    ref_slots, ref_acc = trace_slots_reference(*args, max_hits=32, **kw)
    torch.testing.assert_close(acc, ref_acc, rtol=0, atol=0)
    torch.testing.assert_close(slots, ref_slots, rtol=0, atol=0)


def test_trace_slots_wrapper_checks_inputs(cuda):
    case = CASES["k16_c256_primary_v4"]
    gpack, table, ftable, bounds = _tables(256, cuda)
    o, d, _ = _rays("primary", cuda)
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, 0.05, FAR, tile=256, max_clusters=8)
    args = (o, d, gpack, table, ftable, cands, cnear, 0.05, FAR, 3.0, 0.0,
            0.1, 0.9)
    kw = dict(max_hits=case[0], cluster=256, tile=256)
    with pytest.raises(ValueError, match="ftable"):
        trace_slots(*args[:4], ftable[:, :16].contiguous(), *args[5:], **kw)
    with pytest.raises(ValueError, match="max_hits"):
        trace_slots(*args, **dict(kw, max_hits=8))
    with pytest.raises(ValueError, match="exit_mode"):
        trace_slots(*args, **dict(kw, exit_mode=2))


def _random_ids_case(g):
    """The first case: heavy duplicates, empty slots, exact cancellations,
    a nonzero start (zero in its first rows)."""
    M, N, C = 200_000, 1000, 22
    payload = torch.randn(M, C, generator=g)
    payload[torch.rand(M, C, generator=g) < 0.3] = 0.0
    ids = torch.randint(-1, N, (M,), generator=g, dtype=torch.int32)
    payload[1::2][:1000] = -payload[0::2][:1000]
    ids[1::2][:1000] = ids[0::2][:1000]
    start = torch.randn(N, C, generator=g, dtype=torch.float64)
    start[:10] = 0.0
    return payload, ids, start


def _coherent_ids(g, side=64, K=32, n_gauss=600, radius=6.0):
    """Ids as the fused step lays them out: rays in 16x16 pixel tiles, each
    ray's K slots the Gaussians whose disc covers its pixel, nearest first,
    then -1.  Gaussians are numbered along x in bands of 8 pixel rows, so
    that neighbours have near ids."""
    rng = np.random.default_rng(int(torch.randint(1 << 30, (1,),
                                                  generator=g)))
    centers = rng.uniform(0, side, (n_gauss, 2))
    centers = centers[np.lexsort((centers[:, 0], centers[:, 1] // 8))]
    depth = rng.uniform(1, 2, n_gauss)
    ys, xs = np.mgrid[0:side, 0:side]
    tiles = [(ty, tx) for ty in range(0, side, 16)
             for tx in range(0, side, 16)]
    order = np.concatenate([(ys[ty:ty + 16, tx:tx + 16] * side
                             + xs[ty:ty + 16, tx:tx + 16]).ravel()
                            for ty, tx in tiles])
    pix = np.stack([xs.ravel(), ys.ravel()], 1)[order] + 0.5
    ids = np.full((side * side, K), -1, np.int32)
    for r, p in enumerate(pix):
        hit = np.flatnonzero(((centers - p) ** 2).sum(1) < radius ** 2)
        hit = hit[np.argsort(depth[hit], kind="stable")][:K]
        ids[r, :len(hit)] = hit
    return torch.tensor(ids.ravel()), n_gauss


def _scatter_case(name, g):
    """(payload, ids, start) of one case of the scatter test.  The kernel's
    blocks take 4096-row chunks, and each of its 8 warps a span of the
    chunk's sorted valid rows."""
    C = 22
    if name == "random":
        return _random_ids_case(g)
    if name == "one_id":        # every chunk one Gaussian, a run per span
        M, N = 3 * 4096 + 17, 50
        ids = torch.full((M,), 7, dtype=torch.int32)
        ids[::5] = -1
    elif name == "all_distinct":  # no two rows of a chunk alike
        M, N = 2 * 4096, 10_000
        ids = torch.randperm(N, generator=g)[:M].to(torch.int32)
    elif name == "straddle":    # runs of 700 rows across chunks and spans
        M, N = 3 * 4096 + 100, 20
        ids = (torch.arange(M) // 700).to(torch.int32)
    elif name == "below_one_chunk":
        M, N = 37, 5
        ids = torch.randint(-1, N, (M,), generator=g, dtype=torch.int32)
    elif name == "ragged":      # M not a multiple of the chunk
        M, N = 5 * 4096 + 1234, 300
        ids = torch.randint(-1, N, (M,), generator=g, dtype=torch.int32)
    elif name == "all_invalid":
        M, N = 3 * 4096 + 5, 40
        ids = torch.full((M,), -1, dtype=torch.int32)
    elif name == "coherent":    # a 16x16-tiled pass's K slots
        ids, N = _coherent_ids(g)
        M = ids.shape[0]
    elif name == "ids_above_2_20":  # ids that share their low 20 bits
        M, N = 3 * 4096, (1 << 21) + 64
        low = torch.randint(-1, 64, (M,), generator=g, dtype=torch.int32)
        high = torch.randint(0, 3, (M,), generator=g, dtype=torch.int32)
        ids = torch.where(low >= 0, low + high * (1 << 20), low)
    else:
        raise ValueError(name)
    payload = torch.randn(M, C, generator=g)
    payload[torch.rand(M, C, generator=g) < 0.3] = 0.0
    start = torch.randn(N, C, generator=g, dtype=torch.float64)
    return payload, ids, start


SCATTER_CASES = ("random", "one_id", "all_distinct", "straddle",
                 "below_one_chunk", "ragged", "all_invalid", "coherent",
                 "ids_above_2_20")


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_kernel_matches_reference(case, cuda):
    g = torch.Generator().manual_seed(3)
    payload, ids, start = _scatter_case(case, g)
    payload, ids = payload.to(cuda), ids.to(cuda)
    before = scatter_add.launches
    got = scatter_add(start.to(cuda), payload, ids)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    ref = scatter_add_reference(start.to(cuda), payload, ids)
    a, b = got.to(torch.float32).cpu(), ref.to(torch.float32).cpu()
    scale = float(b.abs().max())
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)
    assert torch.equal(a == 0.0, b == 0.0)
    # only valid ids receive anything: a zero-payload run adds nothing
    zero = torch.zeros_like(start).to(cuda)
    scatter_add(zero, torch.zeros_like(payload), ids)
    assert not zero.any()


def _step_inputs(device, W=64, H=64):
    scene = gs.from_arrays(**room_scene(4096), pad_multiple=1024,
                           device=device)
    state = tr.init_train_state(scene)
    eye, c2w = room_camera()
    camera = rt.CameraParams(torch.tensor(eye, device=device),
                             torch.tensor(c2w, device=device), 0.9, 0.05,
                             FAR)
    rng = np.random.default_rng(2)
    R = W * H
    targets = rt.targets_from_numpy(dict(
        diffuse=rng.uniform(0, 1, (R, 3)), specular=rng.uniform(0, .3, (R, 3)),
        depth=rng.uniform(1, 5, R), normal=rng.normal(size=(R, 3)),
        roughness=rng.uniform(0, 1, R), f0=rng.uniform(0, 1, (R, 3))),
        device=device)
    return state, camera, targets


STEP_KW = dict(num_bounces=2, max_hits=16, chunk=0, tile=1024,
               use_pallas=True, use_culling=True, cull_tile=256,
               cull_cluster=256, max_clusters=16)
LRS = dict(xyz=1e-4, scaling=5e-3, rotation=1e-3, opacity=2.5e-2,
           diffuse=5e-3, normal=2.5e-3, f0=2.5e-3, roughness=2.5e-3)
HYPER = dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999, apply_grads=1.0)


def _step(device, samples):
    state, camera, targets = _step_inputs(device)
    s = rt.TileSamples(samples.jitter.to(device), samples.us.to(device))
    new, metrics = tr.train_step(state, camera, targets, rt.RenderSettings(),
                                 LRS, HYPER, None, 64, 64, samples=s,
                                 **STEP_KW)
    return new, {k: v.item() for k, v in metrics.items()}


def _assert_states_equal(a, b):
    for tree in ("scene", "mu", "nu"):
        for f in tr.PARAM_FIELDS:
            torch.testing.assert_close(
                getattr(getattr(a, tree), f).cpu(),
                getattr(getattr(b, tree), f).cpu(), rtol=0, atol=0,
                msg=f"{tree}.{f}")
    torch.testing.assert_close(a.total_weight.cpu(), b.total_weight.cpu(),
                               rtol=0, atol=0)


def _samples():
    return rt.draw_tile_samples(torch.Generator().manual_seed(4), 64, 64,
                                1024, 3)


def test_batched_step_equals_tile_by_tile(cuda):
    """The step's own batch (all 4 tiles in one launch per bounce) and one
    tile per launch: the same gradients, l1 and starved sums, so the same
    step (apply_updates reads nothing else of the tiles)."""
    samples = _samples()
    state, camera, targets = _step_inputs(cuda)
    nb, K = STEP_KW["num_bounces"], STEP_KW["max_hits"]
    prep = tr.prepare_step(
        state, camera, targets, rt.RenderSettings(), None, 64, 64, nb,
        STEP_KW["tile"], True, True, True, STEP_KW["cull_tile"],
        STEP_KW["cull_cluster"], STEP_KW["max_clusters"],
        samples=rt.TileSamples(samples.jitter.to(cuda),
                               samples.us.to(cuda)))

    def grads(tiles_per_launch):
        before = (trace_slots.launches, scatter_add.launches)
        out = tr.grads_over_tiles(
            camera.origin, prep["dirs_t"], prep["targets_t"],
            rt.RenderSettings(), camera, prep["us_t"], nb, K, 3.0,
            prep["gpack"], prep["culling"], state.scene.capacity,
            tiles_per_launch)
        return out, (trace_slots.launches - before[0],
                     scatter_add.launches - before[1])

    ((ga, l1a, sa), na), ((gb, l1b, sb), nb1) = grads(None), grads(1)
    assert (na, nb1) == ((3, 1), (12, 4))
    assert l1a.item() == l1b.item() and sa.item() == sb.item()
    for f in ga._fields:
        torch.testing.assert_close(getattr(ga, f), getattr(gb, f), rtol=0,
                                   atol=0, msg=f)


def test_cuda_step_equals_cpu_step(cuda):
    samples = _samples()
    a, ma = _step(cuda, samples)
    b, mb = _step(torch.device("cpu"), samples)
    assert ma == mb
    _assert_states_equal(a, b)
    assert ma["l1_diffuse"] > 0.0
