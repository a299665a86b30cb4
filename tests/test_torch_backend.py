"""PyTorch port vs JAX package: cfg.backend.

A Config with backend "xla" renders, through the port's
default_backend_kwargs and dispatch_render_frame (what measure_fps calls),
unculled through the k-buffer composite: the brute trace_hits.  JAX renders
the same Config through its XLA path (use_pallas=False, trace_rays).  The
frame is 32x32 on the 2048-Gaussian room of tests/test_torch_render_tile.py,
K 16, 2 bounces, one 1024-ray tile, with JAX's jitter and GGX uniforms
rebuilt from the JAX key; the fused path would take this frame if it were
culled.  "auto" and "pallas" still cull, as cfg.cull says, and measure_fps
passes what default_backend_kwargs gives.  The JAX side runs in a child
process whose XLA is capped at the AVX instruction set (see
test_torch_render_frame.py).

Tolerances: test_torch_render_tile.py's.  Each frame is rendered by the
port on JAX's scene tables and on its own: on JAX's tables bounce 0 within
rtol 1e-4 / atol 5e-5, and every bounce and the final image with at most
0.5% of elements outside 2e-4*|ref| + 2e-5*scale; on its own tables at
most 0.5% outside that bound at every bounce.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import measure_fps as tfps
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.ops.intersect import (
    GaussianFrames,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.renderer import render as trd
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from tests.test_torch_render_tile import (
    KEY,
    MISMATCH,
    ZFAR,
    ZNEAR,
    _mismatch,
    _room,
    _samples,
    _tables,
)

torch.set_num_threads(1)

W, H, NB, K, TILE = 32, 32, 2, 16, 1024


def jax_reference(path):
    """JAX's frame of a backend="xla" Config and the scene tables it
    traced, saved to `path` as npz.  Run by the jax_ref fixture in a child
    process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.config import Config as JConfig
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.renderer.render import (
        default_backend_kwargs,
        dispatch_render_frame,
    )
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    out = {}
    settings = jrt.RenderSettings()
    scene = jgs.from_arrays(**room_scene(2048), pad_multiple=512)
    eye, c2w = room_camera()
    camera = jrt.CameraParams(
        origin=jnp.asarray(eye), c2w=jnp.asarray(c2w),
        fov_y=jnp.asarray(0.9), znear=jnp.asarray(ZNEAR),
        zfar=jnp.asarray(ZFAR))
    frames, attrs = jax.jit(lambda s: jgs.build_frames(
        s, settings.alpha_threshold, settings.exp_power,
        settings.global_scale_factor))(scene)
    for f in GaussianFrames._fields:
        out[f"tables/frames/{f}"] = np.asarray(getattr(frames, f))
    for f in tgs.SceneAttributes._fields:
        out[f"tables/attrs/{f}"] = np.asarray(getattr(attrs, f))
    kw = default_backend_kwargs(dataclasses.replace(JConfig(),
                                                    backend="xla"))
    assert kw == dict(use_pallas=False), kw
    steps, final = dispatch_render_frame(
        scene, camera, settings, jax.random.PRNGKey(KEY), W, H,
        num_bounces=NB, max_hits=K, tile=TILE, **kw)
    for f in jrt.StepOutputs._fields:
        out[f"xla/{f}"] = np.asarray(getattr(steps, f))
    out["xla/final"] = np.asarray(final)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process."""
    path = tmp_path_factory.mktemp("jax_backend") / "ref.npz"
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


def _xla_frame(ref=None):
    """The port's frame of a backend="xla" Config with JAX's samples, on
    JAX's scene tables when `ref` is given; asserts that it took neither
    the fused path nor the culled trace."""
    scene, camera = _room()
    assert trt.fused_path_ok(scene, W, H, 256, "kbuffer")
    kw = trd.default_backend_kwargs(Config(backend="xla"))
    fused = mock.patch.object(trd, "render_frame_fused",
                              side_effect=AssertionError("fused path"))
    culled = mock.patch.object(trt, "trace_rays_culled",
                               side_effect=AssertionError("culled trace"))
    tables = (mock.patch.object(trt, "build_frames",
                                return_value=_tables(ref, "tables"))
              if ref is not None else contextlib.nullcontext())
    with fused, culled, tables:
        return trd.dispatch_render_frame(
            scene, camera, trt.RenderSettings(), None, W, H, num_bounces=NB,
            max_hits=K, tile=TILE, samples=_samples(W, H, TILE, NB + 1),
            **kw)


def test_xla_backend_renders_the_jax_xla_frame(jax_ref):
    steps_j, final_j = _xla_frame(jax_ref)
    steps_o, final_o = _xla_frame()
    for f in trt.StepOutputs._fields:
        b = jax_ref[f"xla/{f}"].astype(np.float32)
        for name, steps in (("jax tables", steps_j), ("own tables", steps_o)):
            a = getattr(steps, f).numpy()
            assert a.shape == b.shape and np.isfinite(a).all(), (name, f)
            for bounce in range(a.shape[0]):
                bad = _mismatch(a[bounce], b[bounce])
                assert bad <= MISMATCH, f"{name} bounce {bounce} {f}: {bad}"
        if f != "throughput":
            np.testing.assert_allclose(getattr(steps_j, f).numpy()[0], b[0],
                                       rtol=1e-4, atol=5e-5,
                                       err_msg=f"bounce 0 {f}")
    for final in (final_j, final_o):
        assert _mismatch(final.numpy(), jax_ref["xla/final"]) <= MISMATCH
    assert float(jax_ref["xla/final"].mean()) > 0.0
    assert float(steps_o.overflow.max()) == 0.0        # brute: none starved


@pytest.mark.parametrize("backend,cull,culled", [
    ("xla", True, False), ("auto", True, True), ("pallas", True, True),
    ("auto", False, False), ("pallas", False, False)])
def test_default_backend_kwargs_culls_as_the_backend_says(backend, cull,
                                                          culled, tmp_path):
    cfg = Config(backend=backend, cull=cull, composite_mode="scanq",
                 split_far=False)
    kw = trd.default_backend_kwargs(cfg)
    assert kw["use_culling"] is culled
    if backend == "xla":
        # the JAX XLA path: no split-far, the k-buffer composite
        assert kw == dict(use_culling=False, split_far=False,
                          composite_mode="kbuffer")
    else:
        assert kw["composite_mode"] == "scanq"
        assert kw["cull_cluster"] == cfg.cull_cluster
    # measure_fps renders with these options
    seen = []

    def record(*args, **kwargs):
        seen.append(kwargs)
        return None, torch.zeros(1)

    view = SimpleNamespace(image_height=4, image_width=4, znear=0.1,
                           zfar=10.0)
    scene = SimpleNamespace(xyz=torch.zeros(1, 3))
    with mock.patch.object(tfps, "dispatch_render_frame", record), \
            mock.patch.object(tfps, "camera_params", return_value=None):
        tfps.measure_fps(dataclasses.replace(cfg, model_path=str(tmp_path)),
                         [view], scene, None)
    assert seen and all(s["use_culling"] is culled for s in seen)
    assert all(s["composite_mode"] == kw["composite_mode"] for s in seen)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
