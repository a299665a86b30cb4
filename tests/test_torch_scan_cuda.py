"""The streaming scan kernel (csrc/render_scan.cu) against its plain PyTorch
version, on the same CUDA tensors - on the renderer's own passes, and on
cases aimed at the kernel's design (blocks of one origin beside blocks whose
origins differ by one ulp, clusters that are not a multiple of 4, all-dead
tiles, empty list entries, saturation exits in the first, a middle and the
last group, Gaussians thin enough to take the division, a non-integer
exp_power, counters and bf16 attributes on and off) - and a scan frame on
cuda against the same frame on the cpu.  Needs a CUDA card and nvcc; every test here skips without
a card.  Imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_scan_cuda.py

The tests carry the `cuda` marker.  Kernel and plain version follow one
float policy (ops/precision.py): float lanes to rtol 1e-4 / atol 5e-5 (the
plain version's float64 scans on the card may order a sum differently; a
cpu frame is compared exactly), counter lanes exactly.
"""

import functools

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.scan_kernel import (
    render_scan,
    render_scan_reference,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as gs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from test_torch_trace_hits_cuda import (
    exit_tile_chunks,
    exit_tile_inputs,
    mixed_alive,
    walk_design_inputs,
)

pytestmark = pytest.mark.cuda

FAR = 50.0
SETTINGS = rt.RenderSettings()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(device, n=4096):
    scene = gs.from_arrays(**room_scene(n), pad_multiple=512, device=device)
    eye, c2w = room_camera()
    camera = rt.CameraParams(torch.tensor(eye, device=device),
                             torch.tensor(c2w, device=device), 0.9, 0.05, FAR)
    return scene, camera


@functools.cache
def _passes(mode, cluster, device):
    """The render_scan calls of bounces 0 and 1 of a 64x64 frame, built by
    the renderer's own helpers (bounce 1: reflected rays, alive mask)."""
    scene, camera = _scene(device)
    W = H = 64
    samples = rt.draw_samples(torch.Generator(device=device).manual_seed(0),
                              W, H, 2)
    prep = rt._prepare_fused_frame(
        scene, camera, SETTINGS, samples, W, H, jitter=True,
        cull_cluster=cluster, cull_tile_primary=256, num_steps=2,
        composite_mode=mode)
    R = prep["R"]
    o = camera.origin.expand(R, 3)
    alive = torch.ones((R,), dtype=torch.bool, device=device)
    kw = dict(capacity=scene.capacity, max_hits=16, exp_power_static=3.0,
              cull_cluster=cluster, max_clusters=32,
              max_clusters_secondary=64, cull_tile_secondary=128,
              cull_tile_primary=256, scan=prep["scan"])
    common = (prep["gpack"], prep["bounds"], prep["scene_lo"],
              prep["scene_hi"], SETTINGS, 0.05, FAR)
    call0 = rt.kernel_call(o, prep["dirs"], alive, 0, *common, **kw)
    assert call0.kernel is render_scan
    out0 = render_scan_reference(*call0.args, **call0.kwargs)
    _, (o1, d1, _t, al1) = rt.bounce_epilogue(
        out0, call0, o, prep["dirs"], torch.ones((R, 3), device=device),
        alive, prep["us"][0], 0, SETTINGS, FAR)
    assert not bool(al1.all())   # some reflected rays are dead
    return call0, rt.kernel_call(o1, d1, al1, 1, *common, **kw)


# (composite mode, cluster, stats, attr_precision)
CASES = {
    "scan_c64_stats": ("scan", 64, True, "highest"),
    "scan_c256_no_stats": ("scan", 256, False, "highest"),
    "scanq_c32_stats": ("scanq", 32, True, "highest"),
    "scanq_c128_no_stats_bf16": ("scanq", 128, False, "bf16"),
    "scanq_c256_stats_bf16": ("scanq", 256, True, "bf16"),
}


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference(case, bounce, cuda):
    mode, cluster, stats, ap = CASES[case]
    call = _passes(mode, cluster, cuda)[bounce]
    kw = dict(call.kwargs, stats=stats, attr_precision=ap)
    before = render_scan.launches
    out = render_scan(*call.args, **kw)
    torch.cuda.synchronize()
    assert render_scan.launches == before + 1
    ref = render_scan_reference(*call.args, **kw)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    f = slice(0, layout.OUT_NUMACC)
    np.testing.assert_allclose(out[:, f], ref[:, f], rtol=1e-4, atol=5e-5)
    np.testing.assert_array_equal(out[:, layout.OUT_NUMACC:],
                                  ref[:, layout.OUT_NUMACC:])
    assert (out[:, layout.OUT_TRAV].max() > 0) == stats


# (pair math, rays, cluster, tile, ray count, Gaussian count, exp_power,
# lists, special, alive, check_every, stats, bf16): walk_design_inputs'
# rays, lists and special; lists "exits" are exit_tile_inputs' tiles of 64
# rays (their heavy cluster in each position of 8, check_every 2: exits
# after the first, second and third group, none in the last), alive
# mixed_alive's (every third ray dead and the last tile wholly dead)
DESIGN = {
    "direct_ulp_origin_hand": ("direct", "ulp", 256, 128, 1024, 4096, 3.0,
                               "hand", "", True, 8, True, False),
    "quadric_ulp_origin_c50_pow2_5_bf16": ("quadric", "ulp", 50, 100, 1000,
                                           4050, 2.5, "hand", "", True, 4,
                                           False, True),
    "direct_c50_reflected_backfacing": ("direct", "reflected", 50, 200,
                                        1000, 4050, 2.0, "hand",
                                        "invalid_cluster", True, 8, True,
                                        False),
    "quadric_reflected_c64_select_bf16": ("quadric", "reflected", 64, 128,
                                          1024, 4096, 3.0, "select", "",
                                          False, 8, True, True),
    "direct_thin_all": ("direct", "primary", 256, 256, 768, 4096, 3.0,
                        "all", "thin", False, 8, True, False),
    "quadric_thin_all_pow2_5": ("quadric", "primary", 256, 256, 768, 4096,
                                2.5, "all", "thin", False, 8, True, False),
    "direct_exits": ("direct", "primary", 256, 64, 0, 0, 3.0, "exits", "",
                     True, 2, True, False),
    "quadric_exits_bf16": ("quadric", "primary", 256, 64, 0, 0, 3.0,
                           "exits", "", True, 2, True, True),
}


def _design_scan(case, device, fn):
    (math, kind, cluster, tile, n_rays, n_gauss, exp_power, lists, special,
     with_alive, ce, stats, bf16) = DESIGN[case]
    thr = 0.01
    if lists == "exits":
        o, d, gpack, _t, _f, cands, cnear, alive, thr = exit_tile_inputs(
            device, tile)
        near = 0.05
    else:
        o, d, gpack, _t, _f, cands, cnear, near = walk_design_inputs(
            device, kind, cluster, tile, n_rays, n_gauss, lists, special)
        alive = mixed_alive(n_rays, tile, device) if with_alive else None
    reflected = kind == "reflected"
    return fn(o, d, layout.pack_scan_table(gpack, math), cands, cnear, near,
              FAR, exp_power, 1.0 if reflected else 0.0,
              10.0 if reflected else 0.1, 0.9, transmittance_threshold=thr,
              cluster=cluster, tile=tile, alive=alive, check_every=ce,
              secondary_static=1 if reflected else 0, stats=stats,
              attr_precision="bf16" if bf16 else "highest")


@pytest.mark.parametrize("case", sorted(DESIGN))
def test_kernel_design_cases(case, cuda):
    before = render_scan.launches
    out = _design_scan(case, cuda, render_scan)
    torch.cuda.synchronize()
    assert render_scan.launches == before + 1
    ref = _design_scan(case, cuda, render_scan_reference)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    f = slice(0, layout.OUT_NUMACC)
    np.testing.assert_allclose(out[:, f], ref[:, f], rtol=1e-4, atol=5e-5)
    np.testing.assert_array_equal(out[:, layout.OUT_NUMACC:],
                                  ref[:, layout.OUT_NUMACC:])
    stats = DESIGN[case][11]
    assert (ref[:, layout.OUT_NUMACC].max() > 0) == stats
    assert (ref[:, :layout.OUT_DEPTH] != 0).any()
    if DESIGN[case][7] == "exits":
        # a tile stops at the first vote after its heavy cluster; one with
        # dead rays (never saturated) walks its whole list
        chunks = ref[::64, layout.OUT_CHUNKS].tolist()
        assert chunks == exit_tile_chunks(0, DESIGN[case][10])


def test_wrapper_checks_inputs(cuda):
    call = _passes("scanq", 64, cuda)[0]
    args, kw = call.args, call.kwargs
    with pytest.raises(ValueError, match="candidates"):
        render_scan(*args[:3], args[3].long(), *args[4:], **kw)
    with pytest.raises(ValueError, match="cluster"):
        render_scan(*args, **dict(kw, cluster=1024))
    direct = _passes("scan", 64, cuda)[0].args[2]
    with pytest.raises(ValueError, match="bf16"):
        render_scan(*args[:2], direct, *args[3:],
                    **dict(kw, attr_precision="bf16"))
    with pytest.raises(ValueError, match="table"):
        render_scan(*args[:2], args[2]._replace(table=args[2].table.cpu()),
                    *args[3:], **kw)


@pytest.mark.parametrize("mode", ["scan", "scanq"])
def test_frame_is_the_same_on_cuda_and_cpu(mode, cuda):
    """ops/precision.py's promise for the scan modes: a cuda and a cpu
    render of one frame, with the same samples, are equal at every
    bounce."""
    samples = rt.draw_samples(torch.Generator().manual_seed(1), 32, 32, 3)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        scene, camera = _scene(dev, n=2048)
        steps, final = rt.render_frame_fused(
            scene, camera, SETTINGS, None, 32, 32, num_bounces=2,
            samples=rt.FrameSamples(samples.jitter.to(dev),
                                    samples.us.to(dev)),
            cull_cluster=64, max_clusters=32, composite_mode=mode,
            kernel_stats=mode == "scan")
        outs.append([t.cpu() for t in (*steps, final)])
    for name, a, b in zip(rt.StepOutputs._fields + ("final",), *outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
