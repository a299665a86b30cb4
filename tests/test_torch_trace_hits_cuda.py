"""The non-fused trace kernel on the card: csrc/trace_hits.cu against its
plain PyTorch version on the same CUDA tensors, in brute and culled mode,
primary and reflected, with a ragged brute ray count; and the non-fused
frame and training step on the card against the CPU.  Needs a CUDA card and
nvcc; every test here skips without a card.  Imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_trace_hits_cuda.py

(--noconftest: the suite's conftest imports jax.)  The tests carry the
`cuda` marker.

Tolerances: the kernel and the plain version share float32 pair math
without FMA, float64 exp/pow/log1p and sums, and sort the kept hits by
(t, id), so every output is equal; frames and steps on cuda and cpu are
equal bit for bit (ops/precision.py).
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as tr
from editable_gaussian_reflections_tpu_torch.ops import culling
from editable_gaussian_reflections_tpu_torch.ops.camera_rays import (
    primary_ray_directions,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
    trace_hits,
    trace_hits_reference,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as gs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)

# every test here needs the card; each decides in the `cuda` fixture
pytestmark = pytest.mark.cuda

FAR = 50.0
OUTPUTS = ("t", "ids", "alpha", "gaussval", "local_hit", "attrs", "log_T",
           "traversed")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@functools.cache
def _scene(device, n=4096):
    return gs.from_arrays(**room_scene(n), pad_multiple=2048, device=device)


@functools.cache
def _gpack(device, cluster):
    _f, _a, gpack, cull, _s, _p = tr.prepare_render_inputs(
        _scene(device), rt.RenderSettings(), True, True, 256, cluster, 16)
    return gpack, cull["bounds"]


def _rays(kind, device, n_rays, W=40):
    """Primary rays of a W-wide frame in linear order, or reflected rays
    (random origins and directions inside the room)."""
    eye, c2w = room_camera()
    H = -(-n_rays // W)
    d = primary_ray_directions(W, H, 0.9, torch.tensor(c2w)).reshape(-1, 3)
    d = d[:n_rays].numpy()
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    if kind == "reflected":
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.tensor(np.ascontiguousarray(o), device=device),
            torch.tensor(np.ascontiguousarray(d), device=device))


# (mode, rays, K, cluster, candidates, ray count)
CASES = {
    "brute_primary_k32": ("brute", "primary", 32, 256, 0, 1280),
    "brute_reflected_k16_ragged": ("brute", "reflected", 16, 256, 0, 1000),
    "culled_primary_k32": ("culled", "primary", 32, 256, 12, 1280),
    "culled_reflected_k16_c128": ("culled", "reflected", 16, 128, 24, 1280),
}


def _trace(case, device, fn):
    mode, kind, K, cluster, mc, n_rays = case
    gpack, bounds = _gpack(device, cluster)
    o, d = _rays(kind, device, n_rays)
    near = 0.05 if kind == "primary" else 0.0
    secondary = 0.0 if kind == "primary" else 1.0
    cands = cnear = None
    if mode == "culled":
        cands, cnear, _n, _o, _t = culling.select_candidates(
            o, d, bounds, near, FAR, tile=256, max_clusters=mc)
    return fn(o, d, gpack, cands, cnear, near, FAR, 3.0, secondary, 0.1,
              0.9, max_hits=K, cluster=cluster, tile=256)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_hits_kernel_matches_reference(case, cuda):
    before = trace_hits.launches
    out = _trace(CASES[case], cuda, trace_hits)
    torch.cuda.synchronize()
    assert trace_hits.launches == before + 1
    ref = _trace(CASES[case], cuda, trace_hits_reference)
    out = out[:5] + out[6:]
    for name, a, b in zip(OUTPUTS[:5] + OUTPUTS[6:], out, ref):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert (out[0] < 1e37).any()


def test_trace_hits_wrapper_checks_inputs(cuda):
    gpack, bounds = _gpack(cuda, 256)
    o, d = _rays("primary", cuda, 1280)
    cands, cnear, _n, _o, _t = culling.select_candidates(
        o, d, bounds, 0.05, FAR, tile=256, max_clusters=8)
    args = (o, d, gpack, cands, cnear, 0.05, FAR, 3.0, 0.0, 0.1, 0.9)
    with pytest.raises(ValueError, match="max_hits"):
        trace_hits(*args, max_hits=8)
    with pytest.raises(ValueError, match="tile"):
        trace_hits(o[:1000], d[:1000], *args[2:], max_hits=16)
    with pytest.raises(ValueError, match="candidates"):
        trace_hits(*args[:3], cands[:, :4].contiguous().to(torch.int64),
                   *args[4:], max_hits=16)


# (W, H, frame kwargs): culled in linear order with a padded last tile, and
# the brute fallback
FRAMES = {
    "culled_linear_padded": (40, 32, dict(max_hits=32, tile=512,
                                          max_clusters=16)),
    "brute_fallback": (36, 30, dict(max_hits=16, tile=512)),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_cuda_frame_equals_cpu_frame(frame, cuda):
    W, H, kw = FRAMES[frame]
    eye, c2w = room_camera()
    samples = rt.draw_tile_samples(torch.Generator().manual_seed(2), W, H,
                                   kw["tile"], 3)
    frames = {}
    for dev in (cuda, torch.device("cpu")):
        cam = rt.CameraParams(origin=torch.tensor(eye, device=dev),
                              c2w=torch.tensor(c2w, device=dev), fov_y=0.9,
                              znear=0.05, zfar=FAR)
        before = trace_hits.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            frames[dev.type] = dispatch_render_frame(
                _scene(dev), cam, rt.RenderSettings(), None, W, H,
                num_bounces=2, samples=rt.TileSamples(
                    samples.jitter.to(dev), samples.us.to(dev)), **kw)
        if dev.type == "cuda":
            assert trace_hits.launches == before + 3
    (sa, fa), (sb, fb) = frames["cuda"], frames["cpu"]
    for f, a, b in zip(rt.StepOutputs._fields + ("final",), (*sa, fa),
                       (*sb, fb)):
        assert torch.isfinite(a).all(), f
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0, msg=f)
    assert fb.mean() > 0.0


def test_cuda_nonfused_step_equals_cpu_step(cuda):
    W = H = 32
    samples = rt.draw_tile_samples(torch.Generator().manual_seed(4), W, H,
                                   512, 3)
    eye, c2w = room_camera()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene = _scene(dev, 2048)
        cam = rt.CameraParams(origin=torch.tensor(eye, device=dev),
                              c2w=torch.tensor(c2w, device=dev), fov_y=0.9,
                              znear=0.05, zfar=FAR)
        rng = torch.Generator().manual_seed(5)
        R = W * H
        targets = rt.RayTargets(*(
            torch.rand(shape, generator=rng).to(dev)
            for shape in ((R, 3), (R, 3), (R,), (R, 3), (R,), (R, 3))))
        out[dev.type] = tr.train_step(
            tr.init_train_state(scene), cam, targets, rt.RenderSettings(),
            tr.lr_tree(tr.Config(), 1, 1.0),
            dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                 apply_grads=1.0), None, W, H, num_bounces=2, max_hits=16,
            chunk=2048, tile=512, use_pallas=True, use_culling=False,
            samples=rt.TileSamples(samples.jitter.to(dev),
                                   samples.us.to(dev)))
    (sa, ma), (sb, mb) = out["cuda"], out["cpu"]
    for tree in ("scene", "mu", "nu"):
        for f in tr.PARAM_FIELDS:
            a = getattr(getattr(sa, tree), f)
            torch.testing.assert_close(a.cpu(), getattr(getattr(sb, tree), f),
                                       rtol=0, atol=0, msg=f"{tree}.{f}")
    torch.testing.assert_close(sa.total_weight.cpu(), sb.total_weight,
                               rtol=0, atol=0)
    for k in ma:
        assert ma[k].item() == mb[k].item(), k
    assert (sb.total_weight > 0).any()
