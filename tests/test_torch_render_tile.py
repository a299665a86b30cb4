"""PyTorch port vs JAX package: the non-fused path.

dispatch_render_frame of both packages renders frames the fused path cannot
take, through the non-fused render_frame (render_tile per ray tile; JAX:
use_pallas=True, use_culling=True, Pallas kernels in interpret mode) on the
2048-Gaussian room, with JAX's jitter and per-tile GGX uniforms rebuilt
from the JAX key:
  * culled_linear_padded: 40x32 (40 is not a multiple of 16), culled with
    the rays in linear order, ray tiles of 512 (the last one padded with
    256 copies of the leading rays), K 16, 2 bounces;
  * brute_fallback: 36x30 (1080 rays do not divide into 256-ray cull
    tiles): culling disabled with a warning, the brute trace, K 8,
    1 bounce;
  * small_cluster: 32x32 with 64-Gaussian clusters (below the fused path's
    128) and 24 candidates per tile (some tiles overflow), square pixel
    tiles, K 8, 1 bounce.
Then the non-fused train_step (use_culling=False: the brute trace,
render_tile_with_grads) against JAX's on tests/test_torch_train_step.py's
48-Gaussian scene, and the port's own invariants: render(), SPP chunked =
unchunked, batched tiles = tile by tile.  The JAX side runs in a child
process whose XLA is capped at the AVX instruction set (see
test_torch_render_frame.py).

Each frame is rendered twice by the port: on the scene tables JAX built
(its build_frames output swapped in) and on its own.  The port's tables
take exp/log/pow correctly rounded, XLA's float32 ones do not; at that ulp
level a hit at the clip radius (alpha ~ alpha_threshold) flips, and with
K slots a flipped hit lets the next one in: measured, 1 ray of the 1280 of
culled_linear_padded moves its bounce-0 depth by 0.13.  Tolerances:
  * on JAX's tables, bounce 0 within rtol 1e-4 / atol 5e-5 everywhere
    (measured: at most 1.9e-6 beyond the 1e-4 relative band); bounces 1-2
    and the final image with at most 0.5% of elements outside
    2e-4*|ref| + 2e-5*scale (measured 0.09%);
  * on its own tables, at most 0.5% of elements outside that bound at
    every bounce (measured 0.10%).
The train step: l1_diffuse within 1e-5 relative, and moments and params to
tests/test_torch_train_step.py's rules, on JAX's tables everywhere, on its
own tables except the Gaussians whose sums move when the tables are
swapped (at most MAX_FLIPPED, within 2e-3 * scale).
"""

import contextlib
import os
import subprocess
import sys
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as ttr
from editable_gaussian_reflections_tpu_torch.ops.intersect import (
    GaussianFrames,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.renderer import render as trd
from editable_gaussian_reflections_tpu_torch.renderer.denoise import (
    denoise_specular,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.scene.cameras import Camera
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

KEY = 3
ZNEAR, ZFAR = 0.05, 50.0
# (W, H, num_bounces, dispatch kwargs)
FRAMES = {
    "culled_linear_padded": (40, 32, 2, dict(max_hits=16, tile=512,
                                             cull_cluster=256,
                                             max_clusters=16)),
    "brute_fallback": (36, 30, 1, dict(max_hits=8, tile=512)),
    "small_cluster": (32, 32, 1, dict(max_hits=8, tile=1024,
                                      cull_cluster=64, max_clusters=24)),
}
MISMATCH = 0.005

# the train step (tests/test_torch_train_step.py's scene and sizes)
W_T, H_T, TILE_T = 64, 32, 256
STEP_KW = dict(num_bounces=1, max_hits=8, chunk=64, use_pallas=True,
               use_culling=False)
LRS = dict(xyz=1e-4, scaling=5e-3, rotation=1e-3, opacity=2.5e-2,
           diffuse=5e-3, normal=2.5e-3, f0=2.5e-3, roughness=2.5e-3)
HYPER = dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999, apply_grads=1.0)
MAX_FLIPPED = 6
FIELDS = ("xyz", "scaling", "rotation", "opacity", "diffuse", "normal", "f0",
          "roughness")
SCENE_FIELDS = FIELDS + ("live_mask",)


def make_scene_arrays(n=48, seed=0):
    """tests/test_sharding.py:make_scene's arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        xyz=(rng.uniform(-1.5, 1.5, (n, 3))
             + np.array([0, 0, 5])).astype(np.float32),
        scaling=rng.uniform(-2.0, -1.0, (n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.uniform(-1, 2, n).astype(np.float32),
        diffuse=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        f0=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0, 1, n).astype(np.float32))


def jax_tile_samples(key, W, H, tile, num_steps):
    """The jitter and per-tile GGX uniforms JAX's non-fused render_frame
    and train_step draw from `key` (raytracer.py:246-247, :757, :776;
    training.py:204), padded rays of the last tile included."""
    import jax
    import jax.numpy as jnp

    key_jit, key_b = jax.random.split(key)
    jitter = jax.random.uniform(key_jit, (H, W, 2), jnp.float32) - 0.5
    tile = min(tile, W * H)
    us = []
    for i in range(-(-(W * H) // tile)):
        k = jax.random.fold_in(key_b, i)
        per_tile = []
        for _ in range(num_steps):
            k, kstep = jax.random.split(k)
            per_tile.append(np.asarray(jax.random.uniform(kstep, (tile, 2),
                                                          jnp.float32)))
        us.append(np.stack(per_tile))
    return np.asarray(jitter), np.stack(us)


def jax_reference(path):
    """JAX outputs of every test here, saved to `path` as npz.  Run by the
    jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu import training as jtr
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.renderer.render import (
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
    for frame, (W, H, nb, kw) in FRAMES.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            steps, final = dispatch_render_frame(
                scene, camera, settings, jax.random.PRNGKey(KEY), W, H,
                num_bounces=nb, use_pallas=True, use_culling=True,
                interpret=True, **kw)
        out[f"{frame}/warned"] = np.asarray(
            any("culling disabled" in str(w.message) for w in caught))
        for f in jrt.StepOutputs._fields:
            out[f"{frame}/{f}"] = np.asarray(getattr(steps, f))
        out[f"{frame}/final"] = np.asarray(final)

    # the non-fused train step
    tscene = jgs.from_arrays(**make_scene_arrays(), pad_multiple=256)
    state = jtr.init_train_state(tscene)
    tcam = jrt.CameraParams(
        origin=jnp.zeros(3),
        c2w=jnp.asarray(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=jnp.asarray(0.8), znear=jnp.asarray(0.1),
        zfar=jnp.asarray(60.0))
    R = W_T * H_T
    rng = np.random.default_rng(2)
    targets = jrt.RayTargets(
        diffuse=jnp.asarray(rng.uniform(0, 1, (R, 3)), jnp.float32),
        specular=jnp.asarray(rng.uniform(0, 0.3, (R, 3)), jnp.float32),
        depth=jnp.asarray(rng.uniform(3, 7, (R,)), jnp.float32),
        normal=jnp.asarray(rng.normal(size=(R, 3)), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0, 1, (R,)), jnp.float32),
        f0=jnp.asarray(rng.uniform(0, 1, (R, 3)), jnp.float32))
    for f in targets._fields:
        out[f"targets/{f}"] = np.asarray(getattr(targets, f))
    for f in jgs.GaussianScene._fields:
        out[f"init/{f}"] = np.asarray(getattr(tscene, f))
    new, metrics = jtr.train_step(
        state, tcam, targets, settings, LRS, HYPER, jax.random.PRNGKey(1),
        W_T, H_T, tile=TILE_T, interpret=True, **STEP_KW)
    for tree in ("scene", "mu", "nu"):
        for f in jgs.GaussianScene._fields:
            out[f"step/{tree}/{f}"] = np.asarray(getattr(getattr(new, tree),
                                                         f))
    out["step/total_weight"] = np.asarray(new.total_weight)
    out["step/l1_diffuse"] = np.asarray(metrics["l1_diffuse"])
    # the tables that step traced (training.py:128-159, no culling)
    t_frames, t_attrs, gpack, _c, _s, _p = jtr.prepare_render_inputs(
        tscene, settings, True, False, 256, 256, 192)
    out["step_tables/gpack"] = np.asarray(gpack)
    for f in GaussianFrames._fields:
        out[f"step_tables/frames/{f}"] = np.asarray(getattr(t_frames, f))
    for f in tgs.SceneAttributes._fields:
        out[f"step_tables/attrs/{f}"] = np.asarray(getattr(t_attrs, f))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process."""
    path = tmp_path_factory.mktemp("jax_render_tile") / "ref.npz"
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


def _room():
    scene = tgs.from_arrays(**room_scene(2048), pad_multiple=512,
                            device="cpu")
    eye, c2w = room_camera()
    camera = trt.CameraParams(origin=torch.tensor(eye),
                              c2w=torch.tensor(c2w), fov_y=0.9, znear=ZNEAR,
                              zfar=ZFAR)
    return scene, camera


def _samples(W, H, tile, num_steps, key=KEY):
    import jax

    jitter, us = jax_tile_samples(jax.random.PRNGKey(key), W, H, tile,
                                  num_steps)
    return trt.TileSamples(jitter=torch.tensor(jitter), us=torch.tensor(us))


def _tables(ref, prefix):
    frames = GaussianFrames(**{f: torch.tensor(ref[f"{prefix}/frames/{f}"])
                               for f in GaussianFrames._fields})
    attrs = tgs.SceneAttributes(**{
        f: torch.tensor(ref[f"{prefix}/attrs/{f}"])
        for f in tgs.SceneAttributes._fields})
    return frames, attrs


def _mismatch(a, b):
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    ok = np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale
    return 1.0 - ok.mean()


def _dispatch(frame, ref=None):
    """The port's dispatch of FRAMES[frame] with JAX's samples, on JAX's
    scene tables when `ref` is given; asserts the non-fused route and the
    fallback warning where JAX warned.  Returns (steps, final)."""
    W, H, nb, kw = FRAMES[frame]
    scene, camera = _room()
    fused = mock.patch.object(trd, "render_frame_fused",
                              side_effect=AssertionError("fused path"))
    tables = (mock.patch.object(trt, "build_frames",
                                return_value=_tables(ref, "tables"))
              if ref is not None else contextlib.nullcontext())
    with fused, tables, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = trd.dispatch_render_frame(
            scene, camera, trt.RenderSettings(), None, W, H, num_bounces=nb,
            samples=_samples(W, H, kw["tile"], nb + 1), **kw)
    warned = any("culling disabled" in str(w.message) for w in caught)
    return out, warned


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_render_frame_matches_jax(frame, jax_ref):
    (steps_j, final_j), warned = _dispatch(frame, jax_ref)
    (steps_o, final_o), warned_o = _dispatch(frame)
    assert warned == warned_o == bool(jax_ref[f"{frame}/warned"])
    assert warned == (frame == "brute_fallback")
    for f in trt.StepOutputs._fields:
        b = jax_ref[f"{frame}/{f}"].astype(np.float32)
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
        assert _mismatch(final.numpy(), jax_ref[f"{frame}/final"]) <= MISMATCH
    if frame == "small_cluster":
        assert jax_ref[f"{frame}/overflow"].max() == 1.0   # starved rays


def test_dispatch_routes_like_jax():
    """The fused path where JAX's dispatch takes it, render_frame
    elsewhere: the same fused_path_ok on every shape and mode."""
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    for capacity in (512, 2048, 196_608):
        jscene = jgs.pad_to(jgs.from_arrays(**make_scene_arrays(),
                                            pad_multiple=256), capacity)
        tscene = tgs.pad_to(tgs.from_arrays(**make_scene_arrays(),
                                            pad_multiple=256, device="cpu"),
                            capacity)
        for W, H in ((32, 32), (40, 32), (1365, 768), (800, 800)):
            for cluster in (32, 64, 128, 256):
                for mode in ("kbuffer", "scan", "scanq"):
                    assert trt.fused_path_ok(tscene, W, H, cluster, mode) \
                        == jrt.fused_path_ok(jscene, W, H, cluster, mode), (
                            capacity, W, H, cluster, mode)


def test_render_facade_equals_dispatch():
    """render() returns the JAX facade's fields, [S, C, H, W] / [3, H, W],
    from the same frame as dispatch_render_frame; with denoise=True its
    final is that frame's final denoised (renderer/denoise.py), the rest
    unchanged."""
    scene, camera = _room()
    W, H, nb, kw = FRAMES["culled_linear_padded"]
    eye, c2w = room_camera()
    R = -np.asarray(c2w, np.float64)         # Camera.render_pose's inverse
    R[:, 0] = np.asarray(c2w)[:, 0]
    rng = np.random.default_rng(0)
    view = Camera(colmap_id=0, R=R, T=-R.T @ np.asarray(eye, np.float64),
                  FoVx=1.0, FoVy=0.9,
                  image=rng.uniform(size=(H, W, 3)).astype(np.float32),
                  image_name="view", uid=0,
                  diffuse_image=rng.uniform(size=(H, W, 3)).astype(
                      np.float32))
    samples = _samples(W, H, kw["tile"], 2)
    res = trd.render(view, scene, trt.RenderSettings(), num_bounces=1,
                     znear=ZNEAR, zfar=ZFAR, samples=samples, **kw)
    assert sorted(vars(res)) == sorted((
        "rgb", "final", "overflow_frac", "depth", "normal", "roughness",
        "f0", "transmittance", "target", "target_diffuse", "target_specular",
        "target_depth", "target_normal", "target_roughness", "target_f0"))
    cam = trd.camera_params(view, ZNEAR, ZFAR, device="cpu")
    steps, final = trd.dispatch_render_frame(
        scene, cam, trt.RenderSettings(), None, W, H, num_bounces=1,
        samples=samples, **kw)
    np.testing.assert_array_equal(
        res.final, final.numpy().reshape(H, W, 3).transpose(2, 0, 1))
    np.testing.assert_array_equal(
        res.rgb, steps.rgb.numpy().reshape(2, H, W, 3).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(res.depth[:, 0],
                                  steps.depth.numpy().reshape(2, H, W))
    assert res.rgb.shape == (2, 3, H, W) and res.roughness.shape == (2, 1, H,
                                                                     W)
    assert res.target.shape == (3, H, W) and res.target_specular is None
    assert res.overflow_frac == pytest.approx(float(steps.overflow.mean()))
    den = trd.render(view, scene, trt.RenderSettings(), num_bounces=1,
                     znear=ZNEAR, zfar=ZFAR, samples=samples, denoise=True,
                     **kw)
    want = denoise_specular(
        final.reshape(H, W, 3), steps.rgb[0].reshape(H, W, 3),
        steps.normal[0].reshape(H, W, 3), steps.depth[0].reshape(H, W),
        steps.roughness[0].reshape(H, W))
    np.testing.assert_array_equal(den.final, want.numpy().transpose(2, 0, 1))
    assert not np.array_equal(den.final, res.final)
    np.testing.assert_array_equal(den.rgb, res.rgb)


def test_render_accumulated_chunked_equals_unchunked():
    """render_accumulated_chunked(fused=False) reproduces the single-call
    sample stream: sample i draws from fold_in(seed, i)."""
    scene, camera = _room()
    kw = dict(num_bounces=1, max_hits=16, tile=256, use_culling=True,
              max_clusters=16)
    s1, f1 = trt.render_accumulated(scene, camera, trt.RenderSettings(), 7,
                                    16, 16, spp=3, **kw)
    sc, fc = trt.render_accumulated_chunked(scene, camera,
                                            trt.RenderSettings(), 7, 16, 16,
                                            spp=3, spp_chunk=2, fused=False,
                                            **kw)
    for f, a, b in zip(trt.StepOutputs._fields, sc, s1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=f)
    torch.testing.assert_close(fc, f1, rtol=0, atol=1e-6)
    _, one = trt.render_accumulated(scene, camera, trt.RenderSettings(), 7,
                                    16, 16, spp=1, **kw)
    assert not torch.allclose(one, f1)
    # the fused-path knobs splat in and change nothing
    _, f2 = trt.render_accumulated(scene, camera, trt.RenderSettings(), 7,
                                   16, 16, spp=1, max_clusters_secondary=8,
                                   cull_tile_secondary=64, **kw)
    torch.testing.assert_close(f2, one, rtol=0, atol=0)


def test_batched_tiles_equal_tile_by_tile():
    """Several ray tiles through one trace launch per bounce equal one tile
    per launch, culled and brute: each tile keeps its rays and samples."""
    scene, camera = _room()
    for W, H, kw in ((40, 32, dict(use_culling=True, max_clusters=16)),
                     (24, 16, dict(use_culling=False))):
        samples = trt.draw_tile_samples(torch.Generator().manual_seed(1), W,
                                        H, 256, 2)
        a = trt.render_frame(scene, camera, trt.RenderSettings(), None, W,
                             H, num_bounces=1, max_hits=16, tile=256,
                             samples=samples, **kw)
        with mock.patch.object(trt, "tiles_per_launch_for", return_value=1):
            b = trt.render_frame(scene, camera, trt.RenderSettings(), None,
                                 W, H, num_bounces=1, max_hits=16, tile=256,
                                 samples=samples, **kw)
        for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def _port_step(ref, jax_tables=False, **kw):
    """The port's non-fused train_step on the JAX step's inputs; with
    `jax_tables`, on the scene tables the JAX step built."""
    import jax

    scene = tgs.from_numpy({f: ref[f"init/{f}"] for f in SCENE_FIELDS},
                           device="cpu")
    camera = trt.CameraParams(
        origin=torch.zeros(3),
        c2w=torch.tensor(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=0.8, znear=0.1, zfar=60.0)
    targets = trt.targets_from_numpy(
        {f: ref[f"targets/{f}"] for f in trt.RayTargets._fields},
        device="cpu")
    jitter, us = jax_tile_samples(jax.random.PRNGKey(1), W_T, H_T, TILE_T,
                                  STEP_KW["num_bounces"] + 1)
    samples = trt.TileSamples(jitter=torch.tensor(jitter),
                              us=torch.tensor(us))
    real = ttr.prepare_render_inputs

    def with_jax_tables(*args, **kwargs):
        _f, _a, _g, cull, scene_s, perm = real(*args, **kwargs)
        frames, attrs = _tables(ref, "step_tables")
        return (frames, attrs, torch.tensor(ref["step_tables/gpack"]), cull,
                scene_s, perm)

    with mock.patch.object(ttr, "prepare_render_inputs",
                           with_jax_tables if jax_tables else real):
        return ttr.train_step(ttr.init_train_state(scene), camera, targets,
                              trt.RenderSettings(), LRS, HYPER, None, W_T,
                              H_T, tile=TILE_T, samples=samples,
                              **{**STEP_KW, **kw})


def _tight(a, b):
    scale = max(1e-6, float(np.abs(b).max(initial=0.0)))
    return np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale


def test_nonfused_train_step_matches_jax(jax_ref):
    own, m_own = _port_step(jax_ref)
    swapped, m_sw = _port_step(jax_ref, jax_tables=True)
    for m in (m_own, m_sw):
        np.testing.assert_allclose(m["l1_diffuse"].item(),
                                   float(jax_ref["step/l1_diffuse"]),
                                   rtol=1e-5)
        assert m["starved"].item() == 0.0        # brute: nothing dropped
    sums = {}
    for name, st in (("own", own), ("swapped", swapped)):
        sums[name] = {f"{tree}.{f}": getattr(getattr(st, tree), f).numpy()
                      for f in FIELDS for tree in ("mu", "nu")}
        sums[name]["total_weight"] = st.total_weight.numpy()
    ref = {f"{tree}.{f}": jax_ref[f"step/{tree}/{f}"]
           for f in FIELDS for tree in ("mu", "nu")}
    ref["total_weight"] = jax_ref["step/total_weight"]
    assert (ref["total_weight"] > 0).any()
    flipped = np.zeros(ref["total_weight"].shape[0], bool)
    for k, b in ref.items():
        assert _tight(sums["swapped"][k], b).all(), k
        bad = ~_tight(sums["own"][k], sums["swapped"][k])
        flipped |= bad.reshape(bad.shape[0], -1).any(axis=1)
    assert flipped.sum() <= MAX_FLIPPED, np.nonzero(flipped)[0]
    for k, b in ref.items():
        scale = max(1e-6, float(np.abs(b).max(initial=0.0)))
        loose = ~_tight(sums["own"][k], b)
        assert not (loose.reshape(loose.shape[0], -1).any(axis=1)
                    & ~flipped).any(), k
        assert (np.abs(sums["own"][k] - b) <= 2e-3 * scale).all(), k
    for st in (own, swapped):
        for f in FIELDS:
            mu = jax_ref[f"step/mu/{f}"]
            a, b = getattr(st.scene, f).numpy(), jax_ref[f"step/scene/{f}"]
            scale = max(1.0, float(np.abs(b).max()))
            ulp_level = np.abs(mu) <= 1e-6 * max(1e-30,
                                                 float(np.abs(mu).max()))
            allow = np.where(ulp_level, 2.0 * LRS[f], 0.0) + 1e-6 * scale
            assert (np.abs(a - b) <= allow).all(), f


if __name__ == "__main__":
    jax_reference(sys.argv[1])
