"""PyTorch port vs JAX package: the whole eval-render slice.

render_frame_fused of both packages renders the 2048-Gaussian room with 2
GGX bounces; the port gets JAX's own jitter and GGX uniforms, rebuilt here
from the JAX key.

Bounce 0 is held to the kernel tolerance (rtol 1e-4, atol 5e-5).  Bounces
1-2 and `final` must have >= 99.5% of their elements within
2e-4*|ref| + 2e-5*scale.

The JAX frames are rendered in a child process whose XLA is capped at the
AVX instruction set (--xla_cpu_max_isa=AVX).  On a host with FMA units, XLA
on the CPU contracts multiply-adds into FMAs, while the port rounds every
product, as the TPU kernels and the CUDA kernel do.  Each bounce off the
near-mirror surfaces (roughness 0.08) multiplies such ulp differences ~10x.
Measured over keys 3/5/11 and both frames: against JAX without FMA, at most
0.1% of any field's elements exceed the bound at bounce 2 (0% at bounce 1);
against JAX with FMA, up to 0.8% at bounce 1 and 1.7% at bounce 2.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

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
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

SETTINGS = jrt.RenderSettings()


@functools.cache
def _scene_and_camera():
    jscene = jgs.from_arrays(**room_scene(2048), pad_multiple=512)
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


def jax_samples(key, W, H, num_steps):
    """The jitter and GGX uniforms JAX's render_frame_fused draws from
    `key` (raytracer.py:869-873 and :906-911), in linear pixel order."""
    key_jit, key_b = jax.random.split(key)
    jitter = jax.random.uniform(key_jit, (H, W, 2), jnp.float32) - 0.5
    key_t = jax.random.fold_in(key_b, 0)
    us = []
    for _ in range(num_steps):
        key_t, kstep = jax.random.split(key_t)
        us.append(np.asarray(jax.random.uniform(kstep, (H * W, 2),
                                                jnp.float32)))
    return trt.FrameSamples(jitter=torch.tensor(np.asarray(jitter)),
                            us=torch.tensor(np.stack(us)))


# (W, H, frame kwargs)
FRAMES = {
    # Config defaults: K=32, cluster 256, 192 candidates, one ray call
    "config_defaults": (32, 32, dict(max_hits=32, cull_cluster=256,
                                     max_clusters=192)),
    # 1536 rays in calls of 1024: padded to 2048 by duplicating leading
    # rays; 8 primary candidates overflow (starved rays), small secondary
    # tiles
    "padded_overflow": (48, 32, dict(max_hits=16, cull_cluster=128,
                                     max_clusters=8,
                                     max_clusters_secondary=16,
                                     cull_tile_secondary=64,
                                     rays_per_call=1024)),
}


# allowed share of elements outside the bound at bounces 1 and 2, and in
# the final image
MISMATCH_BY_BOUNCE = {1: 0.005, 2: 0.005}
MISMATCH_FINAL = 0.005
KEY = 3


def render_jax_frames(path):
    """JAX render_frame_fused (Pallas in interpret mode) of every FRAMES
    entry, saved to `path` as npz.  Run by jax_frames in a child process."""
    jscene, jcam, _, _ = _scene_and_camera()
    arrays = {}
    for frame, (W, H, kw) in FRAMES.items():
        steps, final = jrt.render_frame_fused(
            jscene, jcam, SETTINGS, jax.random.PRNGKey(KEY), W, H,
            num_bounces=2, jitter=True, interpret=True, **kw)
        for f in jrt.StepOutputs._fields:
            arrays[f"{frame}/{f}"] = np.asarray(getattr(steps, f))
        arrays[f"{frame}/final"] = np.asarray(final)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    """The JAX frames, rendered by XLA without FMA contraction (module
    docstring) in a child process: XLA reads its flags once per process."""
    path = tmp_path_factory.mktemp("jax_frames") / "frames.npz"
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


def _mismatch(a, b):
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    ok = np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale
    return 1.0 - ok.mean()


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_render_frame_fused_matches_jax(frame, jax_frames):
    W, H, kw = FRAMES[frame]
    _, _, tscene, tcam = _scene_and_camera()
    steps_t, final_t = trt.render_frame_fused(
        tscene, tcam, trt.render_settings_from_numpy(SETTINGS._asdict()),
        None, W, H, num_bounces=2, jitter=True,
        samples=jax_samples(jax.random.PRNGKey(KEY), W, H, 3), **kw)
    assert final_t.shape == (W * H, 3)
    for f in trt.StepOutputs._fields:
        a = getattr(steps_t, f).numpy()
        b = jax_frames[f"{frame}/{f}"].astype(np.float32)
        assert a.shape == b.shape, f
        assert np.isfinite(a).all(), f
        if f != "throughput":
            np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=5e-5,
                                       err_msg=f"bounce 0 {f}")
        for bounce, allowed in MISMATCH_BY_BOUNCE.items():
            bad = _mismatch(a[bounce], b[bounce])
            assert bad <= allowed, f"bounce {bounce} {f}: {bad}"
    bad = _mismatch(final_t.numpy(), jax_frames[f"{frame}/final"])
    assert bad <= MISMATCH_FINAL, f"final: {bad}"
    if frame == "padded_overflow":
        # starved rays seen
        assert jax_frames[f"{frame}/overflow"].max() == 1.0


def test_padded_ray_count_follows_the_jax_rule():
    # 800x800 at the Config defaults: ten calls of 65536 rays
    assert trt.padded_ray_count(640_000, 192, None, 256, 256) == 655_360
    assert trt.padded_ray_count(1536, 8, 16, 256, 64, 1024) == 2048
    assert trt.padded_ray_count(1024, 192, None, 256, 256) == 1024


def test_dispatch_matches_render_frame_fused():
    _, _, tscene, tcam = _scene_and_camera()
    settings = trt.RenderSettings()
    samples = trt.draw_samples(torch.Generator().manual_seed(1), 32, 32, 2)
    kw = dict(max_hits=16, num_bounces=1)
    a = dispatch_render_frame(tscene, tcam, settings, None, 32, 32,
                              samples=samples, cull_cluster=256,
                              max_clusters=8, **kw)
    b = trt.render_frame_fused(tscene, tcam, settings, None, 32, 32,
                               samples=samples, cull_cluster=256,
                               max_clusters=8, **kw)
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_chunked_spp_matches_single_dispatch():
    """Host-chunked SPP reproduces the single-call sample stream: each
    sample's generator is seeded from (seed, sample index)."""
    _, _, tscene, tcam = _scene_and_camera()
    settings = trt.RenderSettings()
    kw = dict(num_bounces=1, max_hits=16, cull_cluster=256, max_clusters=8)
    steps_1, final_1 = trt.render_accumulated_fused(
        tscene, tcam, settings, 7, 32, 32, spp=4, **kw)
    steps_c, final_c = trt.render_accumulated_chunked(
        tscene, tcam, settings, 7, 32, 32, spp=4, spp_chunk=3, **kw)
    for f in trt.StepOutputs._fields:
        torch.testing.assert_close(getattr(steps_c, f), getattr(steps_1, f),
                                   rtol=0, atol=1e-5, msg=f)
    torch.testing.assert_close(final_c, final_1, rtol=0, atol=1e-5)
    # the samples differ from one another: spp 1 is not the mean
    _, one = trt.render_accumulated_fused(tscene, tcam, settings, 7, 32, 32,
                                          spp=1, **kw)
    assert not torch.allclose(one, final_1)


@pytest.mark.parametrize("call", ["render_frame_fused", "dispatch"])
def test_unported_modes_raise(call):
    _, _, tscene, tcam = _scene_and_camera()
    settings = trt.RenderSettings()
    gen = torch.Generator().manual_seed(0)

    def run(**kw):
        fn = (trt.render_frame_fused if call == "render_frame_fused"
              else dispatch_render_frame)
        return fn(tscene, tcam, settings, gen, 32, 32, num_bounces=0, **kw)

    with pytest.raises(ValueError, match="composite_mode"):
        run(composite_mode="kbufer")
    # the streaming scan modes render (tests/test_torch_scan_frame.py holds
    # them against JAX), and so does the two-pass split-far bounce, which
    # raised before it was ported, in every composite mode
    # (tests/test_torch_split_far.py holds it against JAX)
    for mode in ("scan", "scanq"):
        steps, final = run(composite_mode=mode)
        assert final.shape == (32 * 32, 3)
        assert torch.isfinite(final).all() and final.mean() > 0.0
    # against the single pass on the same samples: the split keeps up to K
    # + K_far hits a ray where the single pass keeps K (and the scan's
    # streaming order moves with the passes), so on this dense room they
    # differ by what the single pass cuts (measured 79.4 dB k-buffer, 52.3
    # dB scanq)
    samples = trt.draw_samples(torch.Generator().manual_seed(1), 32, 32, 1)
    for mode, db in (("kbuffer", 60.0), ("scanq", 40.0)):
        steps, final = run(composite_mode=mode, split_far=True,
                           samples=samples)
        _, single = run(composite_mode=mode, samples=samples)
        assert torch.isfinite(final).all() and final.mean() > 0.0
        assert float(steps.overflow.mean()) == 0.0
        mse = float(((tonemap(final).clamp(0, 1)
                      - tonemap(single).clamp(0, 1)) ** 2).double().mean())
        assert 10 * np.log10(1.0 / max(mse, 1e-12)) > db, mode


def test_dispatch_raises_where_jax_falls_back():
    """Where the JAX dispatch falls back to its non-fused render_frame, so
    does the port's (it raised before that path was ported): a width that
    is not a multiple of 16 and a cluster below 128 render through
    render_frame, never render_frame_fused, and so does the non-fused SPP
    accumulation (tests/test_torch_render_tile.py holds them against
    JAX)."""
    from unittest import mock

    from editable_gaussian_reflections_tpu_torch.renderer import render

    _, _, tscene, tcam = _scene_and_camera()
    gen = torch.Generator().manual_seed(0)
    settings = trt.RenderSettings()
    with mock.patch.object(render, "render_frame_fused",
                           side_effect=AssertionError("fused path")):
        for W, kw in ((40, {}), (32, dict(cull_cluster=64))):
            steps, final = dispatch_render_frame(
                tscene, tcam, settings, gen, W, 32, num_bounces=1,
                max_hits=16, **kw)
            assert final.shape == (W * 32, 3) and steps.rgb.shape[0] == 2
            assert torch.isfinite(final).all() and final.mean() > 0.0
    _, final = trt.render_accumulated_chunked(
        tscene, tcam, settings, 0, 32, 32, spp=1, fused=False,
        num_bounces=0, max_hits=16)
    assert final.shape == (32 * 32, 3) and torch.isfinite(final).all()


if __name__ == "__main__":
    render_jax_frames(sys.argv[1])
