"""The ray-parallel modes (parallel/sharding.py) on gloo CPU ranks.

Ranks are processes started by parallel/mesh.py spawn (2 and 4 of them, one
torch thread each).  Every sharded result is held against the port's own
single-process function on the same samples, and the XLA-path step also
against JAX's sharded_train_step on the 8-device virtual mesh:
  * sharded_train_step (tests/test_sharding.py:160: 16x16, make_scene(32)
    padded to 64, 1 bounce, K 8, chunks of 64, tile = H*W/8) on 2 and 4
    ranks: parameter, moment and total_weight delta 0 against train_step
    with the same tile, and within tests/test_torch_train_step.py's bounds
    of JAX's sharded step (l1 within 1e-5 relative; moments and
    total_weight within 2e-4*|ref| + 2e-5*scale; parameters within 1e-6 *
    scale, or 2 lr where JAX's first moment is at ulp level, as Adam's
    m/sqrt(v) there is a sign);
  * the culled fused path (tests/test_sharding.py:196, split=False: 64x32,
    make_scene(48) padded to 256, clusters of 64, 4 candidates, tile 256)
    on 2 ranks: delta 0 against train_step;
  * sharded_render (XLA path, and the culled trace_hits path) against
    render_frame with tile = H*W / the ranks: equal;
  * sharded_render_fused (tests/test_sharding_fused.py:51, split=False:
    64x32, 2 bounces, K 16, clusters of 128, 8 candidates, 8x8-pixel cull
    tiles) on 2 ranks against render_frame_fused: where neither frame
    starved, every output within rtol 1e-5 / atol 1e-5 (the re-sorts of
    reflected rays become shard-local, which only moves a ray into another
    tile's candidate list);
  * split_far=True through both (the culled step and the fused frame
    above, split): the step delta 0 against train_step(split_far=True), the
    frame as above against render_frame_fused(split_far=True); and spawn
    refuses NCCL with more ranks than cards.
The JAX side runs in a child process capped at the AVX instruction set
(see test_torch_render_frame.py) with --xla_force_host_platform_device_count=8.
"""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as ttr
from editable_gaussian_reflections_tpu_torch.parallel import mesh as pmesh
from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import (
    unpack_composite,
)
from editable_gaussian_reflections_tpu_torch.parallel.ranks import (
    capped_flags,
    host_inputs,
    run_jobs,
    to_numpy,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from tests.test_torch_render_tile import (
    HYPER,
    LRS,
    _tight,
    jax_tile_samples,
    make_scene_arrays,
)

torch.set_num_threads(1)

FIELDS = ("xyz", "scaling", "rotation", "opacity", "diffuse", "normal", "f0",
          "roughness")
# the XLA-path step (tests/test_sharding.py:160)
W, H, N_DEV, KEY = 16, 16, 8, 0
TILE = W * H // N_DEV
XLA_KW = dict(num_bounces=1, max_hits=8, chunk=64)
# the culled fused step (tests/test_sharding.py:196)
WF, HF, KEY_F = 64, 32, 1
FUSED_KW = dict(num_bounces=1, max_hits=8, chunk=64, use_pallas=True,
                use_culling=True, cull_tile=256, cull_cluster=64,
                max_clusters=4)
# the fused frame (tests/test_sharding_fused.py:51)
FRAME_KW = dict(num_bounces=2, max_hits=16, jitter=True, cull_cluster=128,
                max_clusters=8, rays_per_call=256, cull_tile_primary=64,
                cull_tile_secondary=64)
# split-far on the culled step and the fused frame
SPLIT_STEP_KW = dict(FUSED_KW, split_far=True, mc_far=4, max_hits_far=8)
SPLIT_FRAME_KW = dict(FRAME_KW, split_far=True, mc_far=8)
# the frame job's capped_flags count: below max_hits, which no ray of this
# small scene fills
CAPPED_AT = 4


def camera(device="cpu"):
    return trt.CameraParams(
        origin=torch.zeros(3, device=device),
        c2w=torch.tensor(np.diag([1.0, 1.0, -1.0]).astype(np.float32),
                         device=device),
        fov_y=0.8, znear=0.1, zfar=60.0)


def targets(R):
    """tests/test_sharding.py:_train_fixture's constant targets."""
    return trt.RayTargets(
        diffuse=torch.full((R, 3), 0.3), specular=torch.zeros((R, 3)),
        depth=torch.full((R,), 5.0), normal=torch.zeros((R, 3)),
        roughness=torch.full((R,), 0.5), f0=torch.full((R, 3), 0.04))


def scene(n, pad):
    return tgs.from_arrays(**make_scene_arrays(n=n), pad_multiple=pad,
                           device="cpu")


def fused_frame_scene():
    """tests/test_sharding_fused.py:_scene(default_rng(5)) as arrays."""
    rng = np.random.default_rng(5)
    n_near, n_far = 40, 24
    shell = rng.normal(size=(n_far, 3))
    shell = shell / np.linalg.norm(shell, axis=1, keepdims=True) * 40.0
    xyz = np.concatenate([rng.normal(0, 1.5, (n_near, 3)) + [0, 0, 5],
                          shell]).astype(np.float32)
    n = n_near + n_far
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return tgs.from_arrays(
        xyz=xyz,
        scaling=rng.uniform(np.log(0.3), np.log(1.2), (n, 3)).astype(
            np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=rng.uniform(-1.5, 0.5, n).astype(np.float32),
        diffuse=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        normal=nrm.astype(np.float32), f0=np.full((n, 3), 0.04, np.float32),
        roughness=rng.uniform(0.1, 0.9, n).astype(np.float32),
        pad_multiple=128, device="cpu")


def jax_reference(path):
    """JAX's sharded_train_step on the 8-device virtual mesh (XLA path),
    saved to `path` as npz.  Run by the jax_ref fixture in a child."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu import training as jtr
    from editable_gaussian_reflections_tpu.parallel.sharding import (
        make_mesh,
        sharded_train_step as jsharded,
    )
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    assert len(jax.devices()) == N_DEV
    jscene = jgs.from_arrays(**make_scene_arrays(n=32), pad_multiple=64)
    R = W * H
    cam = jrt.CameraParams(
        origin=jnp.zeros(3),
        c2w=jnp.asarray(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=jnp.asarray(0.8), znear=jnp.asarray(0.1),
        zfar=jnp.asarray(60.0))
    tg = jrt.RayTargets(
        diffuse=jnp.full((R, 3), 0.3), specular=jnp.zeros((R, 3)),
        depth=jnp.full((R,), 5.0), normal=jnp.zeros((R, 3)),
        roughness=jnp.full((R,), 0.5), f0=jnp.full((R, 3), 0.04))
    new, metrics = jsharded(
        make_mesh(), jtr.init_train_state(jscene), cam, tg,
        jrt.RenderSettings(), LRS, HYPER, jax.random.PRNGKey(KEY), W, H,
        tile=TILE, **XLA_KW)
    out = {"l1_diffuse": np.asarray(metrics["l1_diffuse"]),
           "total_weight": np.asarray(new.total_weight)}
    for tree in ("scene", "mu", "nu"):
        for f in FIELDS:
            out[f"{tree}/{f}"] = np.asarray(getattr(getattr(new, tree), f))
    jitter, us = jax_tile_samples(jax.random.PRNGKey(KEY), W, H, TILE,
                                  XLA_KW["num_bounces"] + 1)
    out.update(jitter=jitter, us=us)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_sharding") / "ref.npz"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=("--xla_force_host_platform_device_count=8 "
                          "--xla_cpu_max_isa=AVX"),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, __file__, str(path)], env=env, check=True,
                   timeout=600)
    with np.load(path) as data:
        return dict(data)


def _xla_inputs(ref):
    samples = trt.TileSamples(jitter=torch.tensor(ref["jitter"]),
                              us=torch.tensor(ref["us"]))
    return samples, host_inputs(
        state=ttr.init_train_state(scene(32, 64)), camera=camera(),
        targets=targets(W * H), lrs=LRS, hyper=HYPER, samples=samples)


def _fused_inputs():
    samples = trt.draw_tile_samples(torch.Generator().manual_seed(KEY_F),
                                    WF, HF, WF * HF // N_DEV, 2)
    return samples, host_inputs(
        state=ttr.init_train_state(scene(48, 256)), camera=camera(),
        targets=targets(WF * HF), lrs=LRS, hyper=HYPER, samples=samples)


def _render_inputs(n_ranks):
    samples = trt.draw_tile_samples(torch.Generator().manual_seed(2), W, H,
                                    W * H // n_ranks, 2, jitter=False)
    return samples, host_inputs(scene=scene(32, 64), camera=camera(),
                                samples=samples)


def _frame_inputs():
    samples = trt.draw_samples(torch.Generator().manual_seed(3), WF, HF, 3)
    return samples, host_inputs(
        scene=fused_frame_scene(), camera=camera(),
        settings=trt.RenderSettings(transmittance_threshold=1e-8),
        samples=samples)


RENDER_KW = dict(num_bounces=1, max_hits=8, chunk=64)
CULLED_KW = dict(num_bounces=1, max_hits=16, use_pallas=True,
                 use_culling=True, cull_tile=64, cull_cluster=64,
                 max_clusters=4)


@pytest.fixture(scope="module")
def ranks2(jax_ref):
    """Every 2-rank job in one spawn: (results, inputs' samples)."""
    s_xla, in_xla = _xla_inputs(jax_ref)
    s_f, in_f = _fused_inputs()
    s_r, in_r = _render_inputs(2)
    s_fr, in_fr = _frame_inputs()
    jobs = [("dp_step", in_xla, dict(width=W, height=H, tile=TILE, **XLA_KW)),
            ("dp_step", in_f, dict(width=WF, height=HF,
                                   tile=WF * HF // N_DEV, **FUSED_KW)),
            ("render", in_r, dict(width=W, height=H, **RENDER_KW)),
            ("render", in_r, dict(width=W, height=H, **CULLED_KW)),
            ("render_fused", in_fr, dict(width=WF, height=HF,
                                         capped_at=CAPPED_AT,
                                         **FRAME_KW)),
            ("dp_step", in_f, dict(width=WF, height=HF,
                                   tile=WF * HF // N_DEV, **SPLIT_STEP_KW)),
            ("render_fused", in_fr, dict(width=WF, height=HF,
                                         **SPLIT_FRAME_KW))]
    out = pmesh.spawn(run_jobs, 2, "gloo", "cpu", {"rays": 2}, jobs)
    return out, dict(xla=s_xla, fused=s_f, render=s_r, frame=s_fr)


@pytest.fixture(scope="module")
def ranks4(jax_ref):
    _s, in_xla = _xla_inputs(jax_ref)
    return pmesh.spawn(run_jobs, 4, "gloo", "cpu", {"rays": 4}, [
        ("dp_step", in_xla, dict(width=W, height=H, tile=TILE, **XLA_KW))])


def _single_step(samples, n, pad, width, height, **kw):
    new, metrics = ttr.train_step(
        ttr.init_train_state(scene(n, pad)), camera(), targets(width * height),
        trt.RenderSettings(), LRS, HYPER, None, width, height,
        samples=samples, **kw)
    return to_numpy(new), to_numpy(metrics)


def _assert_delta_zero(sharded, single):
    for tree in ("scene", "mu", "nu"):
        for f in FIELDS:
            np.testing.assert_array_equal(sharded["state"][tree][f],
                                          single[0][tree][f],
                                          err_msg=f"{tree}.{f}")
    np.testing.assert_array_equal(sharded["state"]["total_weight"],
                                  single[0]["total_weight"])
    assert sharded["metrics"]["l1_diffuse"] == single[1]["l1_diffuse"]
    assert sharded["metrics"]["starved"] == single[1]["starved"]


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_train_step_xla_equals_train_step(n_ranks, ranks2, ranks4,
                                                  jax_ref):
    res = (ranks2[0] if n_ranks == 2 else ranks4)[0]
    samples = trt.TileSamples(jitter=torch.tensor(jax_ref["jitter"]),
                              us=torch.tensor(jax_ref["us"]))
    single = _single_step(samples, 32, 64, W, H, tile=TILE, **XLA_KW)
    _assert_delta_zero(res, single)
    moved = res["state"]["scene"]["xyz"] != to_numpy(scene(32, 64).xyz)
    assert moved.any()
    coll = res["ranks"][0]["collectives"]
    # the float64 gradient sums [64, 22], the per-tile l1 and starved
    assert coll["all_reduce"]["bytes"] == 64 * 22 * 8 + 8


def test_sharded_train_step_xla_matches_jax(ranks2, jax_ref):
    res = ranks2[0][0]
    np.testing.assert_allclose(res["metrics"]["l1_diffuse"],
                               jax_ref["l1_diffuse"], rtol=1e-5)
    for tree in ("mu", "nu"):
        for f in FIELDS:
            assert _tight(res["state"][tree][f],
                          jax_ref[f"{tree}/{f}"]).all(), (tree, f)
    assert _tight(res["state"]["total_weight"], jax_ref["total_weight"]).all()
    for f in FIELDS:
        a, b = res["state"]["scene"][f], jax_ref[f"scene/{f}"]
        mu = jax_ref[f"mu/{f}"]
        scale = max(1.0, float(np.abs(b).max()))
        ulp_level = np.abs(mu) <= 1e-6 * max(1e-30, float(np.abs(mu).max()))
        allow = np.where(ulp_level, 2.0 * LRS[f], 0.0) + 1e-6 * scale
        assert (np.abs(a - b) <= allow).all(), f


def test_sharded_train_step_culled_equals_train_step(ranks2):
    res = ranks2[0][1]
    single = _single_step(ranks2[1]["fused"], 48, 256, WF, HF,
                          tile=WF * HF // N_DEV, **FUSED_KW)
    _assert_delta_zero(res, single)


@pytest.mark.parametrize("path", ["xla", "culled"])
def test_sharded_render_equals_render_frame(path, ranks2):
    res = ranks2[0][2 if path == "xla" else 3]
    kw = RENDER_KW if path == "xla" else CULLED_KW
    _, final = trt.render_frame(scene(32, 64), camera(), trt.RenderSettings(),
                                None, W, H, tile=W * H // 2, jitter=False,
                                samples=ranks2[1]["render"],
                                **{"use_pallas": False, **kw})
    np.testing.assert_array_equal(res["final"], final.numpy())
    assert (res["final"] > 0).any()


def _assert_frames_match(res, samples, frame_kw):
    steps, final = trt.render_frame_fused(
        fused_frame_scene(), camera(),
        trt.RenderSettings(transmittance_threshold=1e-8), None, WF, HF,
        samples=samples, **frame_kw)
    ok = ((steps.overflow.numpy() == 0)
          & (res["steps"]["overflow"] == 0)).all(axis=0)
    assert ok.mean() > 0.9, ok.mean()
    np.testing.assert_allclose(res["final"][ok], final.numpy()[ok],
                               rtol=1e-5, atol=1e-5)
    for f in ("rgb", "depth", "transmittance", "total_transmittance",
              "normal", "alive"):
        np.testing.assert_allclose(res["steps"][f][:, ok],
                                   getattr(steps, f).numpy()[:, ok],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_sharded_render_fused_matches_single(ranks2):
    _assert_frames_match(ranks2[0][4], ranks2[1]["frame"], FRAME_KW)


def test_sharded_render_fused_capped_flags(ranks2):
    """The frame job's capped_at: each rank's capped_flags, [S, rays of
    the rank].  In rank order they are the single frame's on the primary
    step (the same tiles in both), where they mark the rays whose primary
    pass kept CAPPED_AT hits or more."""
    res, K = ranks2[0][4], CAPPED_AT
    S = FRAME_KW["num_bounces"] + 1
    assert [c.shape for c in res["capped"]] == [(S, WF * HF // 2)] * 2
    sharded = np.concatenate(res["capped"], axis=1)
    seen, real = [], trt.kernel_call

    def record(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    with mock.patch.object(trt, "kernel_call", record):
        _out, single = capped_flags(
            lambda: trt.render_frame_fused(
                fused_frame_scene(), camera(),
                trt.RenderSettings(transmittance_threshold=1e-8), None, WF,
                HF, samples=ranks2[1]["frame"], **FRAME_KW), K)
    assert single.shape == (S, WF * HF)
    np.testing.assert_array_equal(sharded[0], single[0].numpy())
    call = seen[0]
    comp = unpack_composite(trt.canonical(
        call.kernel(*call.args, **call.kwargs), call))
    np.testing.assert_array_equal(
        single[0].numpy(), (comp["num_accumulated"] >= K).numpy())
    assert single[0].any() and not single[0].all()


def test_split_far_raises(ranks2):
    """split_far, which raised before it was ported, runs through the
    ray-sharded step and frame on 2 gloo ranks: the DP step's delta against
    train_step(split_far=True) is 0, and the sharded split frame matches
    render_frame_fused(split_far=True) where neither starved."""
    single = _single_step(ranks2[1]["fused"], 48, 256, WF, HF,
                          tile=WF * HF // N_DEV, **SPLIT_STEP_KW)
    _assert_delta_zero(ranks2[0][5], single)
    _assert_frames_match(ranks2[0][6], ranks2[1]["frame"], SPLIT_FRAME_KW)


def test_gaussian_sharded_refuses_split_far():
    """The Gaussian-sharded step has no split-far, as JAX's has none: the
    option is refused before anything runs."""
    from editable_gaussian_reflections_tpu.parallel import (
        gaussian_sharded as jgsh,
    )
    from editable_gaussian_reflections_tpu_torch.parallel import (
        gaussian_sharded as tgsh,
    )

    mesh = pmesh.Mesh(shape={"gauss": 1}, index={"gauss": 0}, groups={},
                      device=torch.device("cpu"))
    with pytest.raises(TypeError, match="split_far"):
        tgsh.gaussian_sharded_train_step(
            mesh, ttr.init_train_state(scene(48, 256)), camera(),
            targets(WF * HF), trt.RenderSettings(), LRS, HYPER, None, WF, HF,
            split_far=True)
    with pytest.raises(TypeError, match="split_far"):
        jgsh.gaussian_sharded_train_step(None, None, None, None, None, None,
                                         None, None, WF, HF, split_far=True)


def test_spawn_refuses_nccl_beyond_the_cards():
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1):
        with pytest.raises(ValueError, match="NCCL refuses"):
            pmesh.spawn(run_jobs, 2, "nccl", "cuda", {"rays": 2}, [])
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        pmesh.spawn(run_jobs, 1, "nccl", "cpu", {"rays": 1}, [])
    with pytest.raises(ValueError, match="backend"):
        pmesh.spawn(run_jobs, 1, "mpi", "cpu", {"rays": 1}, [])


if __name__ == "__main__":
    jax_reference(sys.argv[1])
