"""PyTorch port vs JAX package: the inference fast path, composite_mode
"scan" (the v6 kernel's direct pair math) and "scanq" (v7's quadric form).

render_frame_fused of both packages renders room_scene(512) at 32x32 with
cluster 32 and 2 GGX bounces; the port gets JAX's own jitter and GGX
uniforms (tests/test_torch_render_frame.py's jax_samples).  The JAX frames
are rendered in a child process whose XLA is capped at AVX (no FMA
contraction; test_torch_render_frame.py says why).

Bounce 0 is held to the kernel tolerance of test_torch_scan_kernel.py
(rtol 1e-3, atol 2e-5 for scan, 1e-4 for scanq).  Bounces 1-2 and the final
image are held by tonemapped PSNR: the streaming composite follows the
order of the candidate lists, which the reflected rays' re-sort derives
from their origins, so an ulp in an origin may reorder a tile's chunks
(ROADMAP.md Queue 3).  Measured: 127.0 dB or more on every bounce and on
the final image of both modes; the test asks for 60 dB.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils.synth import (
    room_camera,
    room_scene,
)
from editable_gaussian_reflections_tpu_torch.ops.tonemap import tonemap
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.renderer import render
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from tests.test_torch_render_frame import jax_samples

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

SETTINGS = jrt.RenderSettings()
W = H = 32
KEY = 3
FRAME_KW = dict(max_hits=16, cull_cluster=32, max_clusters=16)
BOUNCE0_TOL = {"scan": dict(rtol=1e-3, atol=2e-5),
               "scanq": dict(rtol=1e-3, atol=1e-4)}
MIN_PSNR_DB = 60.0


@functools.cache
def _scene_and_camera(n=512, pad_multiple=512):
    jscene = jgs.from_arrays(**room_scene(n), pad_multiple=pad_multiple)
    eye, c2w = room_camera()
    jcam = jrt.CameraParams(
        origin=jnp.asarray(eye), c2w=jnp.asarray(c2w),
        fov_y=jnp.asarray(0.9), znear=jnp.asarray(0.05),
        zfar=jnp.asarray(50.0))
    tscene = tgs.from_numpy({f: np.asarray(getattr(jscene, f))
                             for f in jgs.GaussianScene._fields},
                            device="cpu")
    tcam = trt.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()}, device="cpu")
    return jscene, jcam, tscene, tcam


def render_jax_frames(path):
    """JAX render_frame_fused (Pallas in interpret mode) in both scan modes,
    saved to `path` as npz.  Run by jax_frames in a child process."""
    jscene, jcam, _, _ = _scene_and_camera()
    arrays = {}
    for mode in ("scan", "scanq"):
        steps, final = jrt.render_frame_fused(
            jscene, jcam, SETTINGS, jax.random.PRNGKey(KEY), W, H,
            num_bounces=2, jitter=True, interpret=True, composite_mode=mode,
            **FRAME_KW)
        for f in jrt.StepOutputs._fields:
            arrays[f"{mode}/{f}"] = np.asarray(getattr(steps, f))
        arrays[f"{mode}/final"] = np.asarray(final)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_scan_frames") / "frames.npz"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, __file__, str(path)], env=env, check=True,
                   timeout=600)
    with np.load(path) as data:
        return dict(data)


def _port_frame(mode, **kw):
    _, _, tscene, tcam = _scene_and_camera()
    return trt.render_frame_fused(
        tscene, tcam, trt.render_settings_from_numpy(SETTINGS._asdict()),
        None, W, H, num_bounces=2, jitter=True,
        samples=jax_samples(jax.random.PRNGKey(KEY), W, H, 3),
        composite_mode=mode, **FRAME_KW, **kw)


def psnr_tonemapped(a, b) -> float:
    """PSNR in dB of two HDR images after the filmic tonemap, in [0, 1]."""
    ta, tb = (torch.clamp(tonemap(torch.as_tensor(x)), 0.0, 1.0)
              for x in (a, b))
    mse = float(((ta - tb) ** 2).mean())
    return float("inf") if mse == 0.0 else 10.0 * np.log10(1.0 / mse)


@pytest.mark.parametrize("mode", ["scan", "scanq"])
def test_render_frame_fused_scan_matches_jax(mode, jax_frames):
    steps, final = _port_frame(mode)
    assert final.shape == (W * H, 3)
    for f in trt.StepOutputs._fields:
        a = getattr(steps, f).numpy()
        b = jax_frames[f"{mode}/{f}"].astype(np.float32)
        assert a.shape == b.shape, f
        assert np.isfinite(a).all(), f
        if f != "throughput":
            np.testing.assert_allclose(a[0], b[0], err_msg=f"bounce 0 {f}",
                                       **BOUNCE0_TOL[mode])
    for bounce in (1, 2):
        db = psnr_tonemapped(steps.rgb[bounce].numpy(),
                             jax_frames[f"{mode}/rgb"][bounce])
        assert db >= MIN_PSNR_DB, f"bounce {bounce}: {db} dB"
        np.testing.assert_array_equal(steps.alive[bounce].numpy(),
                                      jax_frames[f"{mode}/alive"][bounce])
    db = psnr_tonemapped(final.numpy(), jax_frames[f"{mode}/final"])
    assert db >= MIN_PSNR_DB, f"final: {db} dB"


def test_dispatch_renders_the_scan_modes_with_kernel_options():
    """dispatch_render_frame forwards composite_mode, kernel_stats and
    attr_precision: stats off zeroes the counters and nothing else; bf16
    moves only the shading lanes of scanq."""
    _, _, tscene, tcam = _scene_and_camera()
    samples = jax_samples(jax.random.PRNGKey(KEY), W, H, 2)
    kw = dict(num_bounces=1, samples=samples, **FRAME_KW)

    def run(**extra):
        return dispatch_render_frame(tscene, tcam, trt.RenderSettings(),
                                     None, W, H, **kw, **extra)

    on, final_on = run(composite_mode="scanq")
    off, final_off = run(composite_mode="scanq", kernel_stats=False)
    bf, final_bf = run(composite_mode="scanq", kernel_stats=False,
                       attr_precision="bf16")
    for f in trt.StepOutputs._fields:
        torch.testing.assert_close(getattr(off, f), getattr(on, f), rtol=0,
                                   atol=0, msg=f)
    torch.testing.assert_close(final_off, final_on, rtol=0, atol=0)
    # bounce 0: the weights and depths are unchanged, the shading lanes move
    # by bf16 rounding (relative 2^-8 per product; measured at most 2.2e-3);
    # later bounces follow the moved normals
    for f in ("depth", "transmittance", "total_transmittance"):
        torch.testing.assert_close(getattr(bf, f)[0], getattr(on, f)[0],
                                   rtol=0, atol=0, msg=f)
    assert not torch.equal(bf.rgb[0], on.rgb[0])
    for f in ("rgb", "normal", "f0", "roughness"):
        torch.testing.assert_close(getattr(bf, f)[0], getattr(on, f)[0],
                                   rtol=0, atol=1e-2, msg=f)


def test_padded_ray_count_follows_the_mode():
    # bench.py's configuration at 800x800: 4 bytes a candidate for the scan
    # kernels' packed word, 8 for the k-buffer kernels' pair
    args = (640_000, 128, 768, 256, 256)
    assert trt.padded_ray_count(*args, composite_mode="scanq") == 661_504
    assert trt.padded_ray_count(*args, composite_mode="scan") == 661_504
    assert trt.padded_ray_count(*args, composite_mode="kbuffer") == 644_096


def test_fused_path_ok_follows_the_mode():
    _, _, tscene, _ = _scene_and_camera()              # capacity 512
    assert trt.fused_path_ok(tscene, 32, 32, 32, "scan")
    assert trt.fused_path_ok(tscene, 32, 32, 32, "scanq")
    assert not trt.fused_path_ok(tscene, 32, 32, 32, "kbuffer")
    assert not trt.fused_path_ok(tscene, 40, 32, 32, "scan")
    big = tgs.pad_to(tscene, 196_608)                  # beyond scan_fits
    assert not trt.fused_path_ok(big, 32, 32, 32, "scanq")
    assert trt.fused_path_ok(big, 32, 32, 128, "scanq")
    # beyond scan_fits a cluster of 32 leaves the fused path: the dispatch
    # falls back to the non-fused render_frame, as JAX's does
    gen = torch.Generator().manual_seed(0)
    with mock.patch.object(render, "render_frame_fused",
                           side_effect=AssertionError("fused path")):
        _, final = dispatch_render_frame(big, _scene_and_camera()[3],
                                         trt.RenderSettings(), gen, 32, 32,
                                         num_bounces=0, max_hits=16,
                                         cull_cluster=32,
                                         composite_mode="scan")
    assert torch.isfinite(final).all() and final.mean() > 0.0


def test_scan_falls_back_to_the_kbuffer_kernel_above_the_resident_size(
        monkeypatch):
    """Above scan_fits the JAX renderer composites scan frames with the
    k-buffer kernel (raytracer.py:1079-1082); so does the port, on the
    within-cluster sorted table, giving the k-buffer frame."""
    _, _, tscene, tcam = _scene_and_camera()
    big = tgs.pad_to(tscene, 196_608)                  # dead padding rows
    calls = []
    for name in ("render_scan", "render_culled"):
        fn = getattr(trt, name)
        monkeypatch.setattr(
            trt, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                          _fn(*a, **k))[1])
    samples = jax_samples(jax.random.PRNGKey(KEY), W, H, 2)
    kw = dict(num_bounces=1, samples=samples, max_hits=16, cull_cluster=128,
              max_clusters=8)
    scan = trt.render_frame_fused(big, tcam, trt.RenderSettings(), None, W,
                                  H, composite_mode="scanq", **kw)
    assert calls == ["render_culled"] * 2
    kbuf = trt.render_frame_fused(big, tcam, trt.RenderSettings(), None, W,
                                  H, composite_mode="kbuffer", **kw)
    # the scan modes renumber the Gaussians (the within-cluster sort), and
    # the k-buffer composites hits at exactly equal depth in id order: such
    # ties may swap their shading (measured: 3 of 3072 rgb and normal
    # elements of bounce 0); depths and transmittances do not move
    for f in trt.StepOutputs._fields:
        a, b = getattr(scan[0], f), getattr(kbuf[0], f)
        if f in ("rgb", "normal"):
            assert (a != b).float().mean() <= 0.005, f
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    calls.clear()
    trt.render_frame_fused(tscene, tcam, trt.RenderSettings(), None, W, H,
                           composite_mode="scanq", **kw)
    assert calls == ["render_scan"] * 2


if __name__ == "__main__":
    render_jax_frames(sys.argv[1])
