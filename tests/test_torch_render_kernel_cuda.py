"""The render kernel (csrc/render_culled.cu) against its plain PyTorch
version, on the same CUDA tensors.  Needs a CUDA card and nvcc; every test
here skips without a card.  Imports neither jax nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_render_kernel_cuda.py

(--noconftest: the suite's conftest imports jax.)  The tests carry the
`cuda` marker.

Every lane equal, bit for bit: the kernel and the plain version share
float32 pair math without FMA, float64 exp/pow/log1p and sums, and sort
the kept hits by (t, id).  Beside the cases of the render's own passes,
design cases aimed at the walk the kernel shares with trace_hits and
trace_slots (csrc/trace_hits_walk.cuh: four Gaussians a step, clusters
padded to 4, a two-stage copy ring, slots in shared memory, the
ray-independent terms once per Gaussian on blocks whose rays share an
origin): clusters of 50 (padded to 52, staged with 4-byte copies), empty
list entries and an all-invalid cluster, exact depth ties, blocks of one
origin beside blocks of several, Gaussians thin enough that |ld|^2 passes
2^126 (the walk's division), the split-far windows with the backfacing
test gated on `secondary` (on and off), and saturation exits before
every position of a list, with dead rays.
"""

import functools

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops import culling, ggx
from editable_gaussian_reflections_tpu_torch.ops.camera_rays import (
    primary_ray_directions,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    render_culled,
    render_culled_reference,
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
            culling.cluster_bounds(frames, cluster))


def _rays(kind, device, H=32, W=32):
    eye, c2w = room_camera()
    perm, _ = culling.tile_pixel_order(H, W, 16, 16)
    d = primary_ray_directions(W, H, 0.9, torch.tensor(c2w)).reshape(-1, 3)
    d = d[torch.as_tensor(perm, dtype=torch.int64)].numpy()
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    if kind == "secondary":
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.tensor(np.ascontiguousarray(o), device=device),
            torch.tensor(np.ascontiguousarray(d), device=device))


# (K, cluster, tile, rays, secondary_static, window_mode, alive, mc,
#  check_every, Gaussian scale)
CASES = {
    "k16_c256_primary": (16, 256, 256, "primary", 0, 0, False, 8, 8, 1.0),
    "k32_c128_primary_ce4": (32, 128, 256, "primary", 0, 0, False, 16, 4,
                             1.0),
    "k16_c128_secondary_alive": (16, 128, 256, "secondary", 1, 0, True, 16,
                                 8, 1.0),
    "k32_c256_dynamic_gate_near_window": (32, 256, 128, "secondary", -1, 1,
                                          False, 8, 4, 1.0),
    "k16_c128_far_window_tile64": (16, 128, 64, "secondary", 1, 2, True, 12,
                                   8, 1.0),
    "k16_c128_early_exit": (16, 128, 256, "primary", 0, 0, False, 16, 8, 3.0),
    "k32_c128_early_exit_ce4": (32, 128, 256, "primary", 0, 0, False, 16, 4,
                                3.0),
}


def _call(case, device, fn):
    K, cluster, tile, kind, ss, wmode, with_alive, mc, ce, scale = case
    gpack, bounds = _room(scale, cluster, device)
    o, d = _rays(kind, device)
    R = o.shape[0]
    near = 0.05 if kind == "primary" else 0.0
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, near, FAR, tile=tile, max_clusters=mc)
    alive = None
    if with_alive:
        alive = (torch.arange(R, device=device) % 3) != 0
        alive[-tile:] = False
    t_split = None
    if wmode:
        t_split = torch.tensor(np.random.default_rng(7).uniform(
            1.0, 4.0, R).astype(np.float32), device=device)
    return fn(o, d, gpack, cands, cnear, near, FAR, 3.0, 1.0 if ss else 0.0,
              0.1, 0.9, max_hits=K, cluster=cluster, tile=tile, alive=alive,
              check_every=ce, t_split=t_split, window_mode=wmode,
              secondary_static=ss)


# (rays, K, cluster, tile, ray count, Gaussian count, exp_power, lists,
# special, secondary_static, secondary, window_mode, alive, check_every):
# walk_design_inputs' rays, lists and special; lists "exits" are
# exit_tile_inputs' tiles of 64 rays (the other shape fields unused)
DESIGN = {
    "walk_k32_c50_tile100_hand": ("primary", 32, 50, 100, 1000, 4050, 3.0,
                                  "hand", "invalid_cluster", 0, 0.0, 0,
                                  False, 8),
    "walk_k16_c50_reflected_pow2_hand": ("reflected", 16, 50, 200, 1000,
                                         4050, 2.0, "hand",
                                         "invalid_cluster", 1, 1.0, 0, True,
                                         4),
    "walk_k16_ties_all": ("primary", 16, 256, 256, 512, 4096, 2.0, "all",
                          "ties", 0, 0.0, 0, False, 8),
    "walk_k32_mixed_origin_pow2_5": ("mixed", 32, 128, 128, 1024, 4096, 2.5,
                                     "select", "", 0, 0.0, 0, False, 8),
    "walk_k16_thin_all": ("primary", 16, 256, 256, 768, 4096, 3.0, "all",
                          "thin", 0, 0.0, 0, False, 8),
    "walk_k32_near_window_gate_on": ("reflected", 32, 128, 128, 1024, 4096,
                                     3.0, "select", "", -1, 1.0, 1, True, 4),
    "walk_k16_far_window_gate_off": ("reflected", 16, 128, 64, 1024, 4096,
                                     3.0, "select", "", -1, 0.0, 2, True, 8),
    "walk_k16_exits_ce1": ("primary", 16, 256, 64, 0, 0, 3.0, "exits", "",
                           0, 0.0, 0, True, 1),
    "walk_k32_exits_ce4": ("primary", 32, 256, 64, 0, 0, 3.0, "exits", "",
                           0, 0.0, 0, True, 4),
}


def _design_call(case, device, fn):
    (kind, K, cluster, tile, n_rays, n_gauss, exp_power, lists, special, ss,
     secondary, wmode, with_alive, ce) = DESIGN[case]
    thr = 0.01
    if lists == "exits":
        o, d, gpack, _t, _f, cands, cnear, alive, thr = exit_tile_inputs(
            device, tile)
        near = 0.05
    else:
        o, d, gpack, _t, _f, cands, cnear, near = walk_design_inputs(
            device, kind, cluster, tile, n_rays, n_gauss, lists, special)
        alive = mixed_alive(n_rays, tile, device) if with_alive else None
    t_split = None
    if wmode:
        t_split = torch.tensor(np.random.default_rng(7).uniform(
            1.0, 4.0, o.shape[0]).astype(np.float32), device=device)
    return fn(o, d, gpack, cands, cnear, near, FAR, exp_power, secondary,
              10.0 if ss else 0.1, 0.9, transmittance_threshold=thr,
              max_hits=K, cluster=cluster, tile=tile, alive=alive,
              check_every=ce, t_split=t_split, window_mode=wmode,
              secondary_static=ss)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(DESIGN))
def test_kernel_matches_reference(case, cuda):
    call = _design_call if case in DESIGN else (
        lambda c, dev, fn: _call(CASES[c], dev, fn))
    before = render_culled.launches
    out = call(case, cuda, render_culled)
    torch.cuda.synchronize()
    assert render_culled.launches == before + 1
    ref = call(case, cuda, render_culled_reference)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (ref[:, layout.OUT_NUMACC] > 0).any()
    if case in DESIGN and DESIGN[case][7] == "exits":
        chunks = ref[::64, layout.OUT_CHUNKS].tolist()
        assert chunks == exit_tile_chunks(0, DESIGN[case][13])


@pytest.mark.parametrize("K,shared", [(16, True), (32, False)])
def test_boundary_tie(K, shared, cuda):
    """test_torch_trace_hits_cuda.boundary_tie_case through render_culled:
    A (red) and B (blue) tie at the K-th slot until D evicts one; the
    kernel composites what the plain version does, bit for bit."""
    (o, d, gpack, _t, _f, cands, cnear), _a, _b = boundary_tie_tensors(
        cuda, K=K, shared=shared)
    args = (o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    kw = dict(max_hits=K, cluster=128, tile=TIE_RAYS)
    out = render_culled(*args, **kw)
    ref = render_culled_reference(*args, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (ref[:, layout.OUT_NUMACC] == K).all()


def test_tie_stress(cuda):
    """test_torch_trace_hits_cuda.tie_stress_inputs through render_culled
    (K 16, primary rays): bit for bit the plain version's lanes."""
    o, d, gpack, _t, _f, cands, cnear, kw = tie_stress_inputs(
        cuda, "primary", 2)
    args = (o, d, gpack, cands, cnear, 0.0, FAR, 3.0, 0.0, 0.1, 0.9)
    out = render_culled(*args, max_hits=16, **kw)
    ref = render_culled_reference(*args, max_hits=16, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_wrapper_checks_inputs(cuda):
    o, d = _rays("primary", cuda)
    gpack, bounds = _room(1.0, 256, cuda)
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, 0.05, FAR, tile=256, max_clusters=8)
    args = (o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    kw = dict(max_hits=16, cluster=256, tile=256)
    with pytest.raises(ValueError, match="candidates"):
        render_culled(*args[:3], cands.long(), *args[4:], **kw)
    with pytest.raises(ValueError, match="max_hits"):
        render_culled(*args, **dict(kw, max_hits=24))
    with pytest.raises(ValueError, match="gpack"):
        render_culled(*args[:2], gpack.cpu(), *args[3:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        render_culled(o.t().contiguous().t(), *args[1:], **kw)


def test_frame_is_the_same_on_cuda_and_cpu(cuda):
    """ops/precision.py's promise: a cuda and a cpu render of one frame,
    with the same samples, are equal at every bounce."""
    eye, c2w = room_camera()
    samples = rt.draw_samples(torch.Generator().manual_seed(1), 32, 32, 3)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        scene = gs.from_arrays(**room_scene(2048), pad_multiple=512,
                               device=dev)
        camera = rt.CameraParams(torch.tensor(eye, device=dev),
                                 torch.tensor(c2w, device=dev), 0.9, 0.05,
                                 FAR)
        steps, final = rt.render_frame_fused(
            scene, camera, rt.RenderSettings(), None, 32, 32, num_bounces=2,
            samples=rt.FrameSamples(samples.jitter.to(dev),
                                    samples.us.to(dev)),
            max_hits=32, cull_cluster=256, max_clusters=16)
        outs.append([t.cpu() for t in (*steps, final)])
    for name, a, b in zip(rt.StepOutputs._fields + ("final",), *outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_ggx_sample_is_the_same_on_cuda_and_cpu(cuda):
    g = torch.Generator().manual_seed(5)
    n, v = (torch.nn.functional.normalize(
        torch.randn(65536, 3, generator=g), dim=-1) for _ in range(2))
    rough = torch.rand(65536, generator=g) * 0.5 + 0.05
    u = torch.rand(65536, 2, generator=g)
    f0 = torch.rand(65536, 3, generator=g)
    on_cpu = ggx.sample_cook_torrance(n, v, rough, u)
    on_dev = ggx.sample_cook_torrance(n.to(cuda), v.to(cuda), rough.to(cuda),
                                      u.to(cuda))
    torch.testing.assert_close(on_dev.cpu(), on_cpu, rtol=0, atol=0)
    w_cpu = ggx.cook_torrance_weight(n, v, on_cpu, rough, f0)
    w_dev = ggx.cook_torrance_weight(n.to(cuda), v.to(cuda), on_dev,
                                     rough.to(cuda), f0.to(cuda))
    torch.testing.assert_close(w_dev.cpu(), w_cpu, rtol=0, atol=0)
