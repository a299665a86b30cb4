"""The Gaussian-sharded modes (parallel/gaussian_sharded.py) on gloo CPU
ranks, on the meshes gauss 2, gauss 4 and rays 2 x gauss 2.

As tests/test_gaussian_sharded.py:101-159: room_scene(3800) padded to
4096, 16x16 rays from the room camera, K 8, chunks of 256, the Config's
settings and LRs.  gaussian_sharded_train_step's gradients and l1 against
  * the port's single-process step internals (grads_over_tiles with
    use_pallas=False and tile = H*W / the ray shards, the same samples):
    equal, bit for bit, at 0 and 2 bounces (the merge is exact, log T is
    summed in float64 and rounded once, and the gradient sums are float64);
  * JAX's gaussian_sharded_train_step with JAX's samples: at 0 bounces on
    rays 2 x gauss 2 within rtol 1e-4 / atol 1e-5 * scale and l1 within
    1e-5 relative (the JAX test's bounds); at 2 bounces on gauss 4 the loss
    within 1e-5 relative and at least 99% of the gradient entries within
    that band (the JAX test's bounds: XLA's collective order moves full_T
    by ulps, which the GGX resampling amplifies for a handful of rays).
gaussian_sharded_trace, XLA and use_pallas=True (the slots kernel's plain
version per shard), against the single-process trace_rays, as
tests/test_sharding.py:32 and :69 (make_scene(48) padded to 2048 x the
ranks; 8 and 256 rays, K 16, 8 candidates): the same valid hits and ids, t
within 1e-5 relative, full_T within 1e-4 (XLA) and 5e-4 (slots kernel,
whose walk sums log T per hit in float32) relative.  Each rank's state
holds N/S rows.  tools/demo_5m.py runs at a small size.
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as ttr
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.ops.trace import trace_rays
from editable_gaussian_reflections_tpu_torch.parallel import mesh as pmesh
from editable_gaussian_reflections_tpu_torch.parallel.ranks import (
    host_inputs,
    run_jobs,
    to_numpy,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.tools import demo_5m
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from tests.test_torch_render_tile import jax_tile_samples, make_scene_arrays

torch.set_num_threads(1)

W = H = 16
R = W * H
CHUNK, K, KEY = 256, 8, 7
MESHES = {"gauss2": {"gauss": 2}, "gauss4": {"gauss": 4},
          "rays2_gauss2": {"rays": 2, "gauss": 2}}
# (mesh, bounces) of the steps held against JAX
JAX_CASES = (("rays2_gauss2", 0), ("gauss4", 2))
GRAD_FIELDS = ("mean", "scale", "rotation", "opacity", "rgb", "normal", "f0",
               "roughness", "total_weight")


def n_ray(mesh):
    return MESHES[mesh].get("rays", 1)


def targets_arrays():
    rng = np.random.default_rng(0)
    return dict(
        diffuse=rng.uniform(0, 1, (R, 3)), specular=rng.uniform(0, 0.3,
                                                                (R, 3)),
        depth=rng.uniform(1, 5, (R,)), normal=rng.normal(size=(R, 3)),
        roughness=rng.uniform(0, 1, (R,)), f0=rng.uniform(0, 1, (R, 3)))


def trace_case(n_dev, n_rays, seed):
    """tests/test_sharding.py's rays: from the origin, forward."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_rays, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.8
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.zeros((n_rays, 3), np.float32), d


def jax_reference(path):
    """JAX's gaussian_sharded_train_step gradients and l1 of JAX_CASES,
    and the samples it drew, saved to `path` as npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from editable_gaussian_reflections_tpu.config import Config as JConfig
    from editable_gaussian_reflections_tpu.parallel.gaussian_sharded import (
        gaussian_sharded_train_step,
    )
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
    from editable_gaussian_reflections_tpu import training as jtr

    scene = jgs.from_arrays(**room_scene(3800), pad_multiple=4 * CHUNK)
    state = jtr.init_train_state(scene)
    eye, c2w = room_camera()
    camera = jrt.CameraParams(
        origin=jnp.asarray(eye), c2w=jnp.asarray(c2w),
        fov_y=jnp.asarray(0.9), znear=jnp.asarray(0.05),
        zfar=jnp.asarray(50.0))
    cfg = JConfig()
    settings = jtr.settings_from_config(cfg)
    tg = jrt.RayTargets(**{k: jnp.asarray(v, jnp.float32)
                           for k, v in targets_arrays().items()})
    lrs = jtr.lr_tree(cfg, 10, 3.0)
    hyper = dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                 apply_grads=1.0)
    out = {}
    for mesh_name, nb in JAX_CASES:
        shape = MESHES[mesh_name]
        devs = np.array(jax.devices()[:int(np.prod(list(shape.values())))])
        mesh = Mesh(devs.reshape(tuple(shape.values())), tuple(shape))
        # jitted whole: called eagerly, the shard_map body runs op by op
        # (~70 s a call here)
        step = jax.jit(partial(
            gaussian_sharded_train_step, mesh, width=W, height=H,
            num_bounces=nb, max_hits=K, chunk=CHUNK, gauss_axis="gauss",
            ray_axis="rays" if "rays" in shape else None))
        _, metrics, grads = step(state, camera, tg, settings, lrs, hyper,
                                 jax.random.PRNGKey(KEY))
        case = f"{mesh_name}_{nb}"
        out[f"{case}/l1"] = np.asarray(metrics["l1_diffuse"])
        for f in GRAD_FIELDS:
            out[f"{case}/{f}"] = np.asarray(getattr(grads, f))
        jitter, us = jax_tile_samples(jax.random.PRNGKey(KEY), W, H,
                                      R // n_ray(mesh_name), nb + 1)
        out[f"{case}/jitter"], out[f"{case}/us"] = jitter, us
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_gaussian_sharded") / "ref.npz"
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


def _setup():
    scene = tgs.from_arrays(**room_scene(3800), pad_multiple=4 * CHUNK,
                            device="cpu")
    eye, c2w = room_camera()
    camera = trt.CameraParams(origin=torch.tensor(eye),
                              c2w=torch.tensor(c2w), fov_y=0.9, znear=0.05,
                              zfar=50.0)
    cfg = Config()
    targets = trt.RayTargets(**{k: torch.tensor(v, dtype=torch.float32)
                                for k, v in targets_arrays().items()})
    return (ttr.init_train_state(scene), camera, ttr.settings_from_config(cfg),
            targets, ttr.lr_tree(cfg, 10, 3.0),
            dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                 apply_grads=1.0))


def _samples(ref, mesh_name, nb):
    case = f"{mesh_name}_{nb}"
    if f"{case}/us" in ref:
        return trt.TileSamples(jitter=torch.tensor(ref[f"{case}/jitter"]),
                               us=torch.tensor(ref[f"{case}/us"]))
    return trt.draw_tile_samples(torch.Generator().manual_seed(KEY), W, H,
                                 R // n_ray(mesh_name), nb + 1)


def _step_jobs(ref, mesh_names):
    state, camera, settings, targets, lrs, hyper = _setup()
    jobs = []
    for mesh_name in mesh_names:
        for nb in (0, 2):
            inputs = host_inputs(
                state=state, camera=camera, settings=settings,
                targets=targets, lrs=lrs, hyper=hyper,
                samples=_samples(ref, mesh_name, nb))
            jobs.append(("gauss_step", inputs, dict(
                mesh=MESHES[mesh_name], width=W, height=H, num_bounces=nb,
                max_hits=K, chunk=CHUNK,
                ray_axis="rays" if n_ray(mesh_name) > 1 else None)))
    return jobs


def _trace_jobs(n_dev):
    jobs = []
    arrays = make_scene_arrays(n=48)
    for use_pallas, n_rays in ((False, 8), (True, 256)):
        o, d = trace_case(n_dev, n_rays, 1 + use_pallas)
        jobs.append(("gauss_trace", dict(
            scene=tgs.from_arrays(**arrays, pad_multiple=2048 * n_dev,
                                  device="cpu"),
            rays_o=torch.tensor(o), rays_d=torch.tensor(d)), dict(
                mesh={"gauss": n_dev}, exp_power=3.0, near=0.1, far=60.0,
                max_hits=16, chunk=2048, use_pallas=use_pallas,
                cull_cluster=256, cull_tile=256, max_clusters=8)))
    return jobs


@pytest.fixture(scope="module")
def ranks2(jax_ref):
    return pmesh.spawn(run_jobs, 2, "gloo", "cpu", {"gauss": 2},
                       _step_jobs(jax_ref, ["gauss2"]) + _trace_jobs(2))


@pytest.fixture(scope="module")
def ranks4(jax_ref):
    return pmesh.spawn(run_jobs, 4, "gloo", "cpu", {"gauss": 4},
                       _step_jobs(jax_ref, ["gauss4", "rays2_gauss2"])
                       + _trace_jobs(4))


def _result(ranks2, ranks4, mesh_name, nb):
    if mesh_name == "gauss2":
        return ranks2[(0, 2).index(nb)]
    i = (["gauss4", "rays2_gauss2"].index(mesh_name) * 2 + (0, 2).index(nb))
    return ranks4[i]


def _single_grads(ref, mesh_name, nb):
    """The gradients and l1 train_step(use_pallas=False) computes with
    tile = H*W / the ray shards (its internals, before Adam)."""
    state, camera, settings, targets, _lrs, _hyper = _setup()
    tile = R // n_ray(mesh_name)
    prep = ttr.prepare_step(state, camera, targets, settings, None, W, H, nb,
                            tile, samples=_samples(ref, mesh_name, nb))
    grads, l1, _ = ttr.grads_over_tiles(
        camera.origin, prep["dirs_t"], prep["targets_t"], settings, camera,
        prep["us_t"], nb, K, 3.0, None, None, state.scene.capacity,
        frames=prep["frames"], attrs=prep["attrs"],
        scene_for_bwd=prep["scene_for_bwd"], use_pallas=False, chunk=CHUNK)
    return to_numpy(grads), float(l1) / R


@pytest.mark.parametrize("nb", [0, 2])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_gaussian_sharded_step_equals_single(mesh_name, nb, ranks2, ranks4,
                                             jax_ref):
    res = _result(ranks2, ranks4, mesh_name, nb)
    grads, l1 = _single_grads(jax_ref, mesh_name, nb)
    assert res["metrics"]["l1_diffuse"] == np.float32(l1)
    for f in GRAD_FIELDS:
        np.testing.assert_array_equal(res["grads"][f], grads[f], err_msg=f)
    assert np.abs(grads["mean"]).max() > 0
    S = MESHES[mesh_name]["gauss"]
    rows = [r["rows"] for r in res["ranks"]]
    assert rows == [4096 // S] * len(rows)
    # the state came back whole and moved
    assert res["state"]["scene"]["xyz"].shape == (4096, 3)


@pytest.mark.parametrize("mesh_name,nb", JAX_CASES)
def test_gaussian_sharded_step_matches_jax(mesh_name, nb, ranks2, ranks4,
                                           jax_ref):
    res = _result(ranks2, ranks4, mesh_name, nb)
    case = f"{mesh_name}_{nb}"
    np.testing.assert_allclose(res["metrics"]["l1_diffuse"],
                               jax_ref[f"{case}/l1"], rtol=1e-5)
    for f in GRAD_FIELDS:
        a, b = res["grads"][f], jax_ref[f"{case}/{f}"]
        scale = max(1e-6, float(np.abs(b).max()))
        if nb == 0:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=f)
        else:
            ok = np.abs(a - b) <= 1e-4 * np.abs(b) + 1e-5 * scale
            assert ok.mean() > 0.99, (f, 1 - ok.mean())


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gaussian_sharded_trace_matches_single(use_pallas, n_dev, ranks2,
                                               ranks4):
    res = (ranks2 if n_dev == 2 else ranks4)[-2 + use_pallas]
    h = res["hits"]
    scene = tgs.from_arrays(**make_scene_arrays(n=48),
                            pad_multiple=2048 * n_dev, device="cpu")
    frames, _ = tgs.build_frames(scene, 0.005, 3.0)
    o, d = trace_case(n_dev, 256 if use_pallas else 8, 1 + use_pallas)
    h1 = to_numpy(trace_rays(torch.tensor(o), torch.tensor(d), frames, 3.0,
                             0.1, 60.0, max_hits=16, chunk=2048))
    vs, v1 = h["valid"], h1["valid"]
    np.testing.assert_array_equal(vs.sum(1), v1.sum(1))
    assert v1.sum() > 0
    np.testing.assert_allclose(np.where(vs, h["t"], 0),
                               np.where(v1, h1["t"], 0), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.where(vs, h["ids"], -1),
                                  np.where(v1, h1["ids"], -1))
    np.testing.assert_allclose(h["full_T"], h1["full_T"],
                               rtol=5e-4 if use_pallas else 1e-4)
    launches = [r["launches"] for r in res["ranks"]]
    assert all(v == 0 for lc in launches for v in lc.values())  # CPU ranks


def test_demo_5m_cpu_ranks(tmp_path):
    """tools/demo_5m.py at a small size on 2 CPU ranks, with the kernel
    trace's shard calls run through the plain version as the chip smoke
    runs them: the state is [N/S]-sharded, both traces keep the same hits
    at the same depths, and every rank returns its call's two outputs."""
    out = tmp_path / "demo.json"
    rec, plain = demo_5m.run(["--n", "6000", "--rays", "16", "--ranks", "2",
                              "--device", "cpu", "--out", str(out)],
                             check_plain=True)
    assert json.loads(out.read_text()) == rec
    assert rec["rows_per_rank"] == [4096, 4096]
    assert rec["sharding_ratio"] == 2.0
    assert rec["params_moved"] > 0.0
    assert rec["trace_hits"] > 0 and rec["trace_rays_equal"] == 1.0
    assert rec["trace_t_within_bound"]
    assert rec["trace_full_T_max_abs_err_same_hits"] < 1e-4
    assert len(plain) == 2
    for p in plain:
        assert (p["rows"], p["candidates"], p["exit_mode"]) == (4096, 16, 0)
        assert torch.equal(p["slots"], p["ref_slots"])
        assert torch.equal(p["acc"], p["ref_acc"])


if __name__ == "__main__":
    jax_reference(sys.argv[1])
