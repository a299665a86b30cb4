"""PyTorch port vs JAX package: one training step, and the host operations
around it.

train_step of both packages, the fused path (JAX: use_pallas=True,
use_culling=True, interpret=True; the port: the slots kernel's plain
version on the CPU), on a 48-Gaussian scene at 64x32 rays in 256-ray tiles,
K=8, 1 bounce, clusters of 64 and 4 candidates per tile - the size of
tests/test_sharding.py:209-221.  The port gets JAX's jitter and GGX
uniforms, rebuilt from the JAX key.  The JAX step runs in a child process
whose XLA is capped at AVX (see test_torch_render_frame.py).

The port's step runs twice: on the scene tables it builds itself, and on
the tables the JAX step built (the same layout), swapped in for its own.

Tolerances:
  * l1_diffuse within 1e-5 relative;
  * mu (= 0.1 * gradient at the first step), nu and total_weight ("the
    sums"), tight rule: within 2e-4 * |b| + 2e-5 * scale (scale = max |b|
    of the field);
  * on the JAX tables, every element of the sums to the tight rule;
  * on its own tables, the tight rule except on the Gaussians whose sums
    move beyond it when the tables are swapped, and there within 2e-3 *
    scale.  The port's tables take their transcendentals (exp, log, pow)
    correctly rounded, XLA's float32 ones are not; at that ulp level a
    borderline hit (sq ~ 1) flips in a few rays and moves the sums of the
    Gaussians on those rays (at most MAX_FLIPPED of the 48 here);
  * params within 1e-6 * scale, except where the gradient is ulp-level:
    the first Adam step moves a parameter by lr * m/(sqrt(v) + 1e-15) =
    lr * sign(g) whatever |g| is, so a gradient that is a cancellation
    residue (|g| <= 1e-6 of its field's largest) moves it by up to lr
    either way, and there the allowance is +-2 lr.
apply_updates, prune_step, append_with_opt_state, lr_tree and the Config
round trip are held against JAX on seeded inputs (1e-6 relative, or
exactly).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import config as tcfg
from editable_gaussian_reflections_tpu_torch import training as ttr
from editable_gaussian_reflections_tpu_torch.ops.culling import ClusterBounds
from editable_gaussian_reflections_tpu_torch.ops.render_grads import (
    ParamGrads,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.utils.general import (
    get_expon_lr_func,
)

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

W, H, TILE = 64, 32, 256
STEP_KW = dict(num_bounces=1, max_hits=8, chunk=64, use_pallas=True,
               use_culling=True, cull_tile=256, cull_cluster=64,
               max_clusters=4)
LRS = dict(xyz=1e-4, scaling=5e-3, rotation=1e-3, opacity=2.5e-2,
           diffuse=5e-3, normal=2.5e-3, f0=2.5e-3, roughness=2.5e-3)
HYPER = dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999, apply_grads=1.0)
KEY = 1
# Gaussians whose sums move when the port traces the JAX step's tables
# instead of its own (module docstring): one more than the 5 of the 48 this
# scene gives
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


def seeded_state(n=40, seed=5):
    """A mid-training state: params, moments, count 3, some dead rows."""
    rng = np.random.default_rng(seed)
    p = make_scene_arrays(n, seed)
    live = rng.uniform(size=n) > 0.2
    mu = {f: rng.normal(scale=1e-3, size=p[f].shape).astype(np.float32)
          for f in FIELDS}
    nu = {f: rng.uniform(0, 1e-6, size=p[f].shape).astype(np.float32)
          for f in FIELDS}
    grads = dict(mean=(n, 3), scale=(n, 3), rotation=(n, 4), opacity=(n,),
                 rgb=(n, 3), normal=(n, 3), f0=(n, 3), roughness=(n,),
                 total_weight=(n,))
    grads = {k: rng.normal(scale=1e-3, size=s).astype(np.float32)
             for k, s in grads.items()}
    grads["total_weight"] = np.abs(grads["total_weight"])
    return dict(p=p, live=live, mu=mu, nu=nu, grads=grads,
                total_weight=rng.uniform(0, 1, n).astype(np.float32),
                kill=rng.uniform(size=n) < 0.3,
                new={f: rng.normal(size=(5,) + p[f].shape[1:]).astype(
                    np.float32) for f in FIELDS})


def jax_reference(path):
    """JAX outputs of every test here, saved to `path` as npz.  Run by the
    jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu import config as jcfg
    from editable_gaussian_reflections_tpu import training as jtr
    from editable_gaussian_reflections_tpu.ops.render_grads import (
        ParamGrads as JGrads,
    )
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    out = {}
    scene = jgs.from_arrays(**make_scene_arrays(), pad_multiple=256)
    state = jtr.init_train_state(scene)
    camera = jrt.CameraParams(
        origin=jnp.zeros(3),
        c2w=jnp.asarray(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=jnp.asarray(0.8), znear=jnp.asarray(0.1),
        zfar=jnp.asarray(60.0))
    R = W * H
    rng = np.random.default_rng(2)
    targets = jrt.RayTargets(
        diffuse=jnp.asarray(rng.uniform(0, 1, (R, 3)), jnp.float32),
        specular=jnp.asarray(rng.uniform(0, 0.3, (R, 3)), jnp.float32),
        depth=jnp.asarray(rng.uniform(3, 7, (R,)), jnp.float32),
        normal=jnp.asarray(rng.normal(size=(R, 3)), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0, 1, (R,)), jnp.float32),
        f0=jnp.asarray(rng.uniform(0, 1, (R, 3)), jnp.float32))
    for tree in ("scene", "mu", "nu"):
        for f in jgs.GaussianScene._fields:
            out[f"init/{tree}/{f}"] = np.asarray(getattr(getattr(state, tree),
                                                         f))
    out["init/count"] = np.asarray(state.count)
    out["init/total_weight"] = np.asarray(state.total_weight)
    for f in targets._fields:
        out[f"targets/{f}"] = np.asarray(getattr(targets, f))
    key = jax.random.PRNGKey(KEY)
    new, metrics = jtr.train_step(
        state, camera, targets, jrt.RenderSettings(), LRS, HYPER, key, W, H,
        tile=TILE, interpret=True, **STEP_KW)
    for tree in ("scene", "mu", "nu"):
        for f in jgs.GaussianScene._fields:
            out[f"step/{tree}/{f}"] = np.asarray(getattr(getattr(new, tree),
                                                         f))
    out["step/total_weight"] = np.asarray(new.total_weight)
    out["step/count"] = np.asarray(new.count)
    out["step/l1_diffuse"] = np.asarray(metrics["l1_diffuse"])
    # the scene tables that step traced (training.py:330-337)
    _f, _a, gpack, cull, _s, perm = jtr.prepare_render_inputs(
        scene, jrt.RenderSettings(), True, True, STEP_KW["cull_tile"],
        STEP_KW["cull_cluster"], STEP_KW["max_clusters"])
    out.update({"tables/gpack": np.asarray(gpack),
                "tables/table": np.asarray(cull["table"]),
                "tables/ftable": np.asarray(cull["ftable"]),
                "tables/perm": np.asarray(perm)})
    for f in cull["bounds"]._fields:
        out[f"tables/bounds/{f}"] = np.asarray(getattr(cull["bounds"], f))
    # the samples train_step draws (training.py:338-341, raytracer.py:596)
    key_jit, key_b = jax.random.split(key)
    out["jitter"] = np.asarray(
        jax.random.uniform(key_jit, (H, W, 2), jnp.float32) - 0.5)
    us = []
    for i in range(R // TILE):
        k = jax.random.fold_in(key_b, i)
        per_tile = []
        for _ in range(STEP_KW["num_bounces"] + 1):
            k, kstep = jax.random.split(k)
            per_tile.append(np.asarray(
                jax.random.uniform(kstep, (TILE, 2), jnp.float32)))
        us.append(np.stack(per_tile))
    out["us"] = np.stack(us)

    # host operations on a seeded mid-training state
    x = seeded_state()
    sc = jgs.GaussianScene(live_mask=jnp.asarray(x["live"]),
                           **{f: jnp.asarray(v) for f, v in x["p"].items()})
    st = jtr.TrainState(
        scene=sc,
        mu=sc._replace(**{f: jnp.asarray(v) for f, v in x["mu"].items()}),
        nu=sc._replace(**{f: jnp.asarray(v) for f, v in x["nu"].items()}),
        count=jnp.asarray(3, jnp.int32),
        total_weight=jnp.asarray(x["total_weight"]))
    grads = JGrads(**{k: jnp.asarray(v) for k, v in x["grads"].items()})
    for name, res in (
            ("apply", jtr.apply_updates(st, grads, LRS, HYPER)),
            ("prune", jtr.prune_step(st, jnp.asarray(x["kill"]))),
            ("append", jtr.append_with_opt_state(st, x["new"],
                                                 pad_multiple=16))):
        for tree in ("scene", "mu", "nu"):
            for f in jgs.GaussianScene._fields:
                out[f"{name}/{tree}/{f}"] = np.asarray(
                    getattr(getattr(res, tree), f))
        out[f"{name}/total_weight"] = np.asarray(res.total_weight)
        out[f"{name}/count"] = np.asarray(res.count)
    cfg = jcfg.Config()
    out["lr_tree"] = np.array([[jtr.lr_tree(cfg, it, 2.5)[f] for f in FIELDS]
                               for it in (0, 1, 100, 5000, 40_000)])
    out["pick_tile"] = np.array([jtr.pick_tile_size(n, p) for n, p in
                                 ((589_824, 8192), (1000, 300), (7, 8192))])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process: XLA reads its flags once per
    process."""
    path = tmp_path_factory.mktemp("jax_train_step") / "ref.npz"
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


def _scene(ref, prefix):
    return tgs.from_numpy({f: ref[f"{prefix}/{f}"] for f in SCENE_FIELDS},
                          device="cpu")


def _port_inputs(ref):
    """(state, camera, targets, samples) of the JAX step, carried over
    field by field."""
    state = ttr.train_state_from_numpy(dict(
        scene={f: ref[f"init/scene/{f}"] for f in SCENE_FIELDS},
        mu={f: ref[f"init/mu/{f}"] for f in SCENE_FIELDS},
        nu={f: ref[f"init/nu/{f}"] for f in SCENE_FIELDS},
        count=ref["init/count"], total_weight=ref["init/total_weight"]),
        device="cpu")
    camera = trt.CameraParams(
        origin=torch.zeros(3),
        c2w=torch.tensor(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=0.8, znear=0.1, zfar=60.0)
    targets = trt.targets_from_numpy(
        {f: ref[f"targets/{f}"] for f in trt.RayTargets._fields},
        device="cpu")
    samples = trt.TileSamples(jitter=torch.tensor(ref["jitter"]),
                              us=torch.tensor(ref["us"]))
    return state, camera, targets, samples


def _port_step(ref, jax_tables=False, **kw):
    """The port's train_step on the JAX step's inputs; with `jax_tables`,
    tracing the scene tables the JAX step built instead of its own."""
    state, camera, targets, samples = _port_inputs(ref)
    real = ttr.prepare_render_inputs

    def with_jax_tables(*args, **kwargs):
        frames, attrs, _gpack, cull, scene_s, perm = real(*args, **kwargs)
        np.testing.assert_array_equal(perm.numpy(), ref["tables/perm"])
        cull = dict(cull, table=torch.tensor(ref["tables/table"]),
                    ftable=torch.tensor(ref["tables/ftable"]),
                    bounds=ClusterBounds(*(
                        torch.tensor(ref[f"tables/bounds/{f}"])
                        for f in ClusterBounds._fields)))
        return (frames, attrs, torch.tensor(ref["tables/gpack"]), cull,
                scene_s, perm)

    with mock.patch.object(ttr, "prepare_render_inputs",
                           with_jax_tables if jax_tables else real):
        return ttr.train_step(state, camera, targets, trt.RenderSettings(),
                              LRS, HYPER, None, W, H, tile=TILE,
                              samples=samples, **{**STEP_KW, **kw})


def _tight(a, b):
    """Per element: a within 2e-4 * |b| + 2e-5 * scale of b (scale = max |b|
    of the field), as [N, ...]."""
    scale = max(1e-6, float(np.abs(b).max(initial=0.0)))
    return np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale


def _rows(mask):
    """Per Gaussian: any element of its row set."""
    return mask.reshape(mask.shape[0], -1).any(axis=1)


def _sums(state):
    """The step's gradient sums: each field's mu and nu, and total_weight."""
    out = {f"{tree}.{f}": getattr(getattr(state, tree), f).numpy()
           for f in FIELDS for tree in ("mu", "nu")}
    out["total_weight"] = state.total_weight.numpy()
    return out


def _jax_sums(ref):
    out = {f"{tree}.{f}": ref[f"step/{tree}/{f}"]
           for f in FIELDS for tree in ("mu", "nu")}
    out["total_weight"] = ref["step/total_weight"]
    return out


def _assert_params_close(new, ref):
    moved = 0
    for f in FIELDS:
        mu = ref[f"step/mu/{f}"]
        a = getattr(new.scene, f).numpy()
        b = ref[f"step/scene/{f}"]
        scale = max(1.0, float(np.abs(b).max()))
        ulp_level = np.abs(mu) <= 1e-6 * max(1e-30, float(np.abs(mu).max()))
        allow = np.where(ulp_level, 2.0 * LRS[f], 0.0) + 1e-6 * scale
        assert (np.abs(a - b) <= allow).all(), f
        moved += int((a != ref[f"init/scene/{f}"]).sum())
    assert moved > 0


def test_train_step_matches_jax(jax_ref):
    new, metrics = _port_step(jax_ref)
    swapped, metrics_s = _port_step(jax_ref, jax_tables=True)
    for m in (metrics, metrics_s):
        np.testing.assert_allclose(m["l1_diffuse"].item(),
                                   float(jax_ref["step/l1_diffuse"]),
                                   rtol=1e-5)
        assert 0.0 <= m["starved"].item() <= 1.0
    assert new.count == swapped.count == int(jax_ref["step/count"]) == 1
    _assert_params_close(new, jax_ref)
    _assert_params_close(swapped, jax_ref)
    ref, own, sw = _jax_sums(jax_ref), _sums(new), _sums(swapped)
    # on the JAX step's own tables, every element to the tight rule
    for k, b in ref.items():
        assert _tight(sw[k], b).all(), k
    # the Gaussians whose sums move when the port traces JAX's tables
    # instead of its own: their hits flip on ulp-level table differences
    flipped = np.zeros(b.shape[0], bool)
    for k in ref:
        flipped |= _rows(~_tight(own[k], sw[k]))
    assert flipped.sum() <= MAX_FLIPPED, np.nonzero(flipped)[0]
    for k, b in ref.items():
        scale = max(1e-6, float(np.abs(b).max(initial=0.0)))
        loose = ~_tight(own[k], b)
        assert not (_rows(loose) & ~flipped).any(), k
        assert (np.abs(own[k] - b) <= 2e-3 * scale).all(), k


def test_batched_step_equals_tile_by_tile(jax_ref):
    """Eight tiles through one launch per bounce (the step's own batch), and
    one tile per launch: the same gradients, l1 and starved sums, so the
    same step (apply_updates reads nothing else of the tiles)."""
    state, camera, targets, samples = _port_inputs(jax_ref)
    nb, K = STEP_KW["num_bounces"], STEP_KW["max_hits"]
    prep = ttr.prepare_step(
        state, camera, targets, trt.RenderSettings(), None, W, H, nb, TILE,
        True, True, True, STEP_KW["cull_tile"], STEP_KW["cull_cluster"],
        STEP_KW["max_clusters"], samples=samples)
    n_tiles = prep["dirs_t"].shape[0]
    assert ttr.tiles_per_launch_for(n_tiles, TILE, nb + 1, K,
                                    torch.device("cpu")) == n_tiles == 8

    def grads(tiles_per_launch):
        return ttr.grads_over_tiles(
            camera.origin, prep["dirs_t"], prep["targets_t"],
            trt.RenderSettings(), camera, prep["us_t"], nb, K, 3.0,
            prep["gpack"], prep["culling"], state.scene.capacity,
            tiles_per_launch)

    (ga, l1a, sa), (gb, l1b, sb) = grads(None), grads(1)
    assert l1a.item() == pytest.approx(l1b.item(), rel=1e-12)
    assert sa.item() == sb.item()
    for f in ParamGrads._fields:
        torch.testing.assert_close(getattr(ga, f), getattr(gb, f), rtol=0,
                                   atol=0, msg=f)


def _port_seeded():
    x = seeded_state()
    scene = tgs.GaussianScene(
        live_mask=torch.tensor(x["live"]),
        **{f: torch.tensor(v) for f, v in x["p"].items()})
    state = ttr.TrainState(
        scene=scene,
        mu=scene._replace(**{f: torch.tensor(v) for f, v in x["mu"].items()}),
        nu=scene._replace(**{f: torch.tensor(v) for f, v in x["nu"].items()}),
        count=3, total_weight=torch.tensor(x["total_weight"]))
    grads = ParamGrads(**{k: torch.tensor(v) for k, v in x["grads"].items()})
    return x, state, grads


def _assert_state(res, ref, name, exact=False):
    for tree in ("scene", "mu", "nu"):
        for f in SCENE_FIELDS:
            a = getattr(getattr(res, tree), f).numpy()
            b = ref[f"{name}/{tree}/{f}"]
            assert a.shape == b.shape, (name, tree, f)
            if exact or b.dtype == bool:
                np.testing.assert_array_equal(a, b, err_msg=f"{tree}.{f}")
            else:
                scale = max(1.0, float(np.abs(b).max()))
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           atol=1e-6 * scale,
                                           err_msg=f"{tree}.{f}")
    np.testing.assert_allclose(res.total_weight.numpy(),
                               ref[f"{name}/total_weight"], rtol=1e-6)
    assert res.count == int(ref[f"{name}/count"])


def test_apply_updates_matches_jax(jax_ref):
    _, state, grads = _port_seeded()
    _assert_state(ttr.apply_updates(state, grads, LRS, HYPER), jax_ref,
                  "apply")


def test_prune_step_matches_jax(jax_ref):
    x, state, _ = _port_seeded()
    _assert_state(ttr.prune_step(state, torch.tensor(x["kill"])), jax_ref,
                  "prune", exact=True)


def test_append_with_opt_state_matches_jax(jax_ref):
    """JAX's appended state exactly, except the padded rows' Adam moments:
    zeros in the port, pad_to's parameter fills in JAX (-10 for scaling and
    opacity, whose negative second moment turns the next Adam step's
    update NaN in those dead rows; see training.append_with_opt_state)."""
    x, state, _ = _port_seeded()
    res = ttr.append_with_opt_state(state, x["new"], pad_multiple=16)
    live = res.scene.live_mask.numpy()
    assert not live.all()                    # the case has padded rows
    ref = dict(jax_ref)
    for tree in ("mu", "nu"):
        for f in FIELDS:
            pad = getattr(getattr(res, tree), f).numpy()[~live]
            np.testing.assert_array_equal(pad, np.zeros_like(pad))
            b = ref[f"append/{tree}/{f}"].copy()
            b[~live] = 0.0
            ref[f"append/{tree}/{f}"] = b
    _assert_state(res, ref, "append", exact=True)
    # the next Adam step keeps every row finite
    n = res.scene.capacity
    shapes = dict(mean=(n, 3), scale=(n, 3), rotation=(n, 4), opacity=(n,),
                  rgb=(n, 3), normal=(n, 3), f0=(n, 3), roughness=(n,),
                  total_weight=(n,))
    nxt = ttr.apply_updates(res, ParamGrads(**{
        k: torch.zeros(v) for k, v in shapes.items()}), LRS, HYPER)
    for f in FIELDS:
        assert torch.isfinite(getattr(nxt.scene, f)).all(), f


def test_lr_tree_and_schedule_match_jax(jax_ref):
    cfg = tcfg.Config()
    got = np.array([[ttr.lr_tree(cfg, it, 2.5)[f] for f in FIELDS]
                    for it in (0, 1, 100, 5000, 40_000)])
    np.testing.assert_array_equal(got, jax_ref["lr_tree"])
    sched = get_expon_lr_func(1e-2, 1e-4, lr_delay_steps=10,
                              lr_delay_mult=0.1, max_steps=100)
    assert sched(-1) == 0.0
    assert sched(0) == pytest.approx(1e-3)
    assert sched(100) == pytest.approx(1e-4)
    assert [ttr.pick_tile_size(n, p) for n, p in
            ((589_824, 8192), (1000, 300), (7, 8192))] == list(
        jax_ref["pick_tile"])


def test_config_matches_jax_and_round_trips(tmp_path):
    from editable_gaussian_reflections_tpu import config as jcfg

    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(
        jcfg.Config())
    argv = ["-s", "data", "-r", "256", "--max_hits", "16", "--no-cull",
            "--test_iterations", "1", "5"]
    cfg = tcfg.parse_config(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jcfg.parse_config(argv))
    path = tmp_path / "model" / "cfg.json"
    tcfg.save_config(cfg, str(path))
    assert tcfg.load_config(str(path)) == cfg
    # the JAX package reads the port's cfg.json and the other way round
    assert dataclasses.asdict(jcfg.load_config(str(path))) == \
        dataclasses.asdict(cfg)
    again = tcfg.load_model_config(str(path.parent), ["--max_hits", "8"])
    assert again.max_hits == 8 and again.resolution == 256
    assert again.model_path == str(path.parent)


def test_init_state_and_targets_from_camera_match_jax(jax_ref):
    from types import SimpleNamespace

    from editable_gaussian_reflections_tpu import training as jtr

    state = ttr.init_train_state(_scene(jax_ref, "init/scene"))
    for tree in ("scene", "mu", "nu"):
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(state, tree), f).numpy(),
                jax_ref[f"init/{tree}/{f}"], err_msg=f"{tree}.{f}")
    assert state.count == int(jax_ref["init/count"]) == 0
    rng = np.random.default_rng(9)
    cam = SimpleNamespace(
        image_height=4, image_width=6,
        diffuse_image=rng.uniform(size=(4, 6, 3)), specular_image=None,
        depth_image=rng.uniform(size=(4, 6)),
        normal_image=rng.normal(size=(4, 6, 4)),
        roughness_image=rng.uniform(size=(4, 6, 1)), f0_image=None)
    got = ttr.targets_from_camera(cam, device="cpu")
    ref = jtr.targets_from_camera(cam)
    for f in trt.RayTargets._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_settings_from_config():
    cfg = tcfg.Config()
    s = ttr.settings_from_config(cfg)
    assert s.loss_weight_diffuse == cfg.loss_weight_diffuse == 5.0
    assert s.exp_power == 3.0 and isinstance(s.exp_power, float)


def test_unported_paths_raise(jax_ref):
    """Each of the paths that raised before they were ported steps: the
    split-far step (tests/test_torch_split_far.py holds it against JAX),
    the non-fused step (use_culling=False: tests/test_torch_render_tile.py)
    and the XLA tracer's step (use_pallas=False:
    tests/test_torch_trace_rays.py)."""
    for kw in (dict(split_far=True), dict(use_culling=False),
               dict(use_pallas=False)):
        new, metrics = _port_step(jax_ref, **kw)
        assert new.count == 1 and np.isfinite(metrics["l1_diffuse"].item())
        assert (new.total_weight > 0).any()


def test_entry_points_default_to_the_card():
    """Without a card, the defaults raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    params = make_scene_arrays(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgs.from_arrays(**params, pad_multiple=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.camera_from_numpy(dict(origin=np.zeros(3), c2w=np.eye(3),
                                   fov_y=0.8, znear=0.1, zfar=60.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.targets_from_numpy({f: np.zeros(3) for f in
                                trt.RayTargets._fields})
    assert tgs.from_arrays(**params, pad_multiple=16,
                           device="cpu").xyz.device.type == "cpu"


if __name__ == "__main__":
    jax_reference(sys.argv[1])
