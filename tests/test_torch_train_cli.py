"""PyTorch port vs JAX package: the training CLI and the modules it imports.

Each piece against its JAX twin on seeded inputs:
  * utils/general.mean_dist2_knn3: within 1e-6 relative;
  * scene/init.py (create_from_pcd, farfield_arrays with and without the
    book-demo environment extras, append_points, prune_mask,
    znear_prune_mask) and num_live: exactly, except the scales, which go
    through knn3: within 1e-6 relative;
  * Scene(cfg) on tests/make_synth_dataset.py's dataset: the camera order,
    extent and znear/zfar exactly, the initial Gaussians as create_from_pcd;
  * save_scene_ply: the JAX package's bytes;
  * psnr within 1e-12 relative, save_image_grid's PNG decoding to the JAX
    (PIL-written) file's pixels;
  * a JAX TrainState carried through train_state_from_numpy, saved and
    loaded: bit for bit.
The CLI itself: tests/test_train_e2e.py's run (24x24, 6 iterations, the
bounce warm-up to 2, a 576-ray tile, K 8, 128 far-field points, pruning
every 4 from 3) with backend "xla" on both sides: JAX traces with its XLA
tracer, the port with the brute trace_hits (its plain version here).  The
port's steps and report renders take JAX's samples, rebuilt from the keys
the JAX run split, through wrappers around the CLI's train_step and render.
The same artifact files, the same num_gaussians.txt, the same viewpoints
and capacities, and, step by step, the port's step on the JAX run's state
in that step within tests/test_torch_train_step.py's rules: l1_diffuse
within 1e-5 relative; moments and total_weight within 2e-4*|b| +
2e-5*scale except on at most MAX_FLIPPED Gaussians (hits flipping on the
last ulp of the tables), there within 2e-3*scale; params within 1e-6*scale
except where the gradient is ulp-level (|mu| <= 1e-6 of its field's
largest), there +-2 lr (the first Adam step moves by lr*sign(g)).  Here
also the rotation of an isotropic Gaussian (create_from_pcd and the
far-field shell make them so, until Adam parts their scales) has a zero
gradient in exact arithmetic: its sums are residues on both sides, held
within 1e-6 of the step's largest sum, and its params to +-2 lr.
The port's own run, free of JAX's states: its rotations move by lr times
the sign of those residues, so the two runs turn the isotropic Gaussians
apart (measured: up to 6.3 lr by iteration 6) and, through the frames,
their scales (up to 0.95% of an lr) and their l1_diffuse (2.1e-5 relative
at iteration 4).  It is held to l1_diffuse within 1e-4 relative at every
step, rotation and scaling within 2 lr a step (Adam's step bound), the
other params to the one-step rules summed over the steps, and its CSV
PSNRs within 0.02 dB of JAX's (two decimals each).  Resume: a culled run
to 4 with a checkpoint there, resumed to 6, takes up at iteration 5 with
both bounces and the grown candidate budget.

The JAX side runs in a child process capped at AVX (see
test_torch_render_frame.py).
"""

import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import checkpoint as tck
from editable_gaussian_reflections_tpu_torch import train as ttrain
from editable_gaussian_reflections_tpu_torch import training as ttr
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.scene import init as tinit
from editable_gaussian_reflections_tpu_torch.scene.scene import (
    Scene,
    save_scene_ply,
)
from editable_gaussian_reflections_tpu_torch.utils import image as timg
from editable_gaussian_reflections_tpu_torch.utils.general import (
    mean_dist2_knn3,
)
from editable_gaussian_reflections_tpu_torch.utils.graphics import (
    BasicPointCloud,
)
from tests.test_torch_render_tile import jax_tile_samples
from tests.test_torch_train_step import MAX_FLIPPED, _rows, _tight

torch.set_num_threads(1)

FIELDS = ttr.PARAM_FIELDS
SCENE_FIELDS = tgs.GaussianScene._fields
SIZE = 24
# tests/test_train_e2e.py's run, traced unculled on both sides
CLI_KW = dict(resolution=SIZE, iterations=6, no_bounces_until_iter=2,
              test_iterations=[6], save_iterations=[6], trace_chunk=64,
              max_hits=8, ray_tile=SIZE * SIZE, init_num_pts_farfield=128,
              pruning_interval=4, pruning_start_iter=3, val_view=0,
              backend="xla")
CENTERS = np.array([[0.5, 0.2, 0.1], [-1.0, 0.4, 2.0], [0.0, -0.7, -0.3]])
ZNEARS = [0.6, 1.1, 0.9]
# the free run's l1_diffuse against JAX's, relative, and the fields whose
# free-run params are held to Adam's step bound (module docstring)
FREE_RUN_L1 = 1e-4
COUPLED = ("rotation", "scaling")
BOOK_ENV = dict(ADD_BOOK_INIT_PTS="1", NUM_BOOK_PTS="40",
                BOOK_PTS_SCALE="0.002")


def pieces_inputs():
    rng = np.random.default_rng(11)
    n = 500
    pcd = BasicPointCloud(
        points=rng.normal(size=(n, 3)).astype(np.float32),
        colors=rng.uniform(0, 1.5, (n, 3)).astype(np.float32),
        normals=rng.normal(size=(n, 3)).astype(np.float32))
    return dict(knn_points=rng.normal(size=(3000, 3)).astype(np.float32),
                pcd=pcd, kill=rng.uniform(size=512) < 0.3,
                img_a=rng.uniform(size=(16, 12, 3)),
                img_b=rng.uniform(size=(16, 12, 3)),
                grid=[rng.uniform(-0.1, 1.1, (8, 6, 3)),
                      rng.uniform(size=(8, 6)), rng.uniform(size=(8, 6, 1)),
                      rng.uniform(size=(8, 6, 4)),
                      rng.uniform(size=(8, 6, 3))],
                total_weight=rng.uniform(size=512).astype(np.float32),
                mu=rng.normal(size=(512, 3)).astype(np.float32))


def piece_cfg(cls):
    return cls(clamp_max=1.0, init_num_pts_farfield=400)


def jax_reference(path, data_dir, model_dir):
    """JAX outputs of every test here, saved to `path` as npz.  Run by the
    jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    import train as jtrain
    from editable_gaussian_reflections_tpu import training as jtr
    from editable_gaussian_reflections_tpu.config import Config as JConfig
    from editable_gaussian_reflections_tpu.scene import init as jinit
    from editable_gaussian_reflections_tpu.scene.scene import (
        Scene as JScene,
    )
    from editable_gaussian_reflections_tpu.scene.scene import (
        save_scene_ply as jsave_scene_ply,
    )
    from editable_gaussian_reflections_tpu.utils import image as jimg
    from editable_gaussian_reflections_tpu.utils.general import (
        mean_dist2_knn3 as jknn3,
    )

    out = {}

    def put_scene(prefix, scene):
        for f in SCENE_FIELDS:
            out[f"{prefix}/{f}"] = np.asarray(getattr(scene, f))

    def put_state(prefix, state):
        for tree in ("scene", "mu", "nu"):
            put_scene(f"{prefix}/{tree}", getattr(state, tree))
        out[f"{prefix}/count"] = np.asarray(state.count)
        out[f"{prefix}/total_weight"] = np.asarray(state.total_weight)

    x = pieces_inputs()
    cfg = piece_cfg(JConfig)
    out["knn3"] = jknn3(x["knn_points"])
    scene = jinit.create_from_pcd(x["pcd"], cfg, pad_multiple=64)
    put_scene("pcd", scene)
    for name, env in (("far_book", BOOK_ENV), ("far", {})):
        with mock.patch.dict(os.environ, env):
            far = jinit.farfield_arrays(cfg, 2.5, list(CENTERS), ZNEARS,
                                        np.random.default_rng(7))
        for k, v in far.items():
            out[f"{name}/{k}"] = v
    pruned = jinit.prune_mask(scene, jnp.asarray(x["kill"]))
    put_scene("pruned", pruned)
    out["num_live"] = np.asarray(jinit.num_live(pruned))
    put_scene("append", jinit.append_points(pruned, far, pad_multiple=64))
    out["znear_kill"] = np.asarray(jinit.znear_prune_mask(
        scene, list(CENTERS), ZNEARS))
    ply = Path(model_dir).parent / "pieces.ply"
    jsave_scene_ply(str(ply), pruned)
    out["ply"] = np.frombuffer(ply.read_bytes(), np.uint8)
    out["psnr"] = np.asarray(jimg.psnr(x["img_a"], x["img_b"]))
    jimg.save_image_grid(x["grid"], str(Path(model_dir).parent / "grid.png"),
                         nrow=2)
    state = jtr.init_train_state(scene)
    put_state("ckpt", state._replace(
        count=jnp.asarray(7, jnp.int32),
        mu=state.mu._replace(xyz=state.mu.xyz + jnp.asarray(x["mu"])),
        total_weight=jnp.asarray(x["total_weight"])))

    # Scene(cfg) on the dataset, after the CLI's set_seeds()
    scfg = JConfig(source_path=data_dir, resolution=SIZE, trace_chunk=64)
    random.seed(0)
    sc = JScene(scfg)
    out["scene/names"] = np.array([c.image_name for c in
                                   sc.getTrainCameras()
                                   + sc.getTestCameras()])
    out["scene/extent"] = np.asarray(sc.cameras_extent)
    out["scene/znear_zfar"] = np.array(
        [(c.znear, c.zfar) for c in sc.getTrainCameras()
         + sc.getTestCameras()])
    put_scene("scene/gaussians", sc.gaussians)

    # the CLI run, each step and report render recorded
    real_step, real_render = jtrain.train_step, jtrain.render
    n_steps, n_renders = [0], [0]

    def step(state, cp, targets, settings, lrs, hyper, key, W, H, nb, K,
             chunk, tile, **kw):
        new, metrics = real_step(state, cp, targets, settings, lrs, hyper,
                                 key, W, H, nb, K, chunk, tile, **kw)
        p = f"step{n_steps[0]}"
        n_steps[0] += 1
        put_state(f"{p}/in", state)
        put_state(f"{p}/out", new)
        out[f"{p}/key"] = np.asarray(key)
        out[f"{p}/origin"] = np.asarray(cp.origin)
        out[f"{p}/ints"] = np.array([W, H, nb, K, chunk, tile,
                                     int(kw["use_culling"]),
                                     kw["max_clusters"]])
        out[f"{p}/apply_grads"] = np.asarray(hyper["apply_grads"])
        out[f"{p}/lrs"] = np.array([lrs[f] for f in FIELDS])
        out[f"{p}/l1_diffuse"] = np.asarray(metrics["l1_diffuse"])
        return new, metrics

    def render(camera, scene, settings, *args, **kw):
        pkg = real_render(camera, scene, settings, *args, **kw)
        p = f"render{n_renders[0]}"
        n_renders[0] += 1
        out[f"{p}/final"] = pkg.final
        out[f"{p}/rgb"] = pkg.rgb
        return pkg

    jtrain.train_step, jtrain.render = step, render
    cfg = JConfig(source_path=data_dir, model_path=model_dir, **CLI_KW)
    final = jtrain.main(cfg)
    put_state("final", final)
    out["n_steps"], out["n_renders"] = np.asarray(n_steps[0]), np.asarray(
        n_renders[0])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(__file__))
    from make_synth_dataset import make_dataset

    d = tmp_path_factory.mktemp("synth_cli")
    return make_dataset(str(d / "data"), size=SIZE, n_train=3, n_test=1,
                        n_points=64)


@pytest.fixture(scope="module")
def jax_ref(dataset, tmp_path_factory):
    """jax_reference's arrays and the JAX run's model directory, computed
    by XLA without FMA contraction (module docstring) in a child
    process."""
    tmp = tmp_path_factory.mktemp("jax_cli")
    path, model = tmp / "ref.npz", tmp / "model"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu", NO_WORKERS="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, __file__, str(path), dataset,
                    str(model)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        ref = dict(data)
    ref["model"] = model
    ref["dir"] = tmp
    return ref


def _scene_of(ref, prefix):
    return {f: ref[f"{prefix}/{f}"] for f in SCENE_FIELDS}


def _assert_scene(scene, ref, prefix, loose=("scaling",)):
    """Every field exactly, those in `loose` within 1e-6 relative."""
    for f in SCENE_FIELDS:
        a, b = getattr(scene, f).cpu().numpy(), ref[f"{prefix}/{f}"]
        assert a.shape == b.shape, f
        if f in loose:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _state_of(ref, prefix):
    return ttr.train_state_from_numpy(dict(
        scene=_scene_of(ref, f"{prefix}/scene"),
        mu=_scene_of(ref, f"{prefix}/mu"), nu=_scene_of(ref, f"{prefix}/nu"),
        count=ref[f"{prefix}/count"],
        total_weight=ref[f"{prefix}/total_weight"]), device="cpu")


def test_mean_dist2_knn3_matches_jax(jax_ref):
    x = pieces_inputs()
    got = mean_dist2_knn3(x["knn_points"], device="cpu")
    assert got.dtype == np.float32 and got.shape == (3000,)
    np.testing.assert_allclose(got, jax_ref["knn3"], rtol=1e-6)


def test_create_from_pcd_matches_jax(jax_ref):
    x = pieces_inputs()
    scene = tinit.create_from_pcd(x["pcd"], piece_cfg(Config),
                                  pad_multiple=64, device="cpu")
    _assert_scene(scene, jax_ref, "pcd")
    assert scene.diffuse.max().item() == 1.0        # clamp_max


@pytest.mark.parametrize("name,env", [("far", {}), ("far_book", BOOK_ENV)])
def test_farfield_arrays_match_jax(jax_ref, name, env):
    with mock.patch.dict(os.environ, env):
        far = tinit.farfield_arrays(piece_cfg(Config), 2.5, list(CENTERS),
                                    ZNEARS, np.random.default_rng(7),
                                    device="cpu")
    assert sorted(far) == sorted(k.split("/")[1] for k in jax_ref
                                 if k.startswith(name + "/"))
    for k, v in far.items():
        b = jax_ref[f"{name}/{k}"]
        assert v.dtype == b.dtype and v.shape == b.shape, k
        if k == "scaling":
            np.testing.assert_allclose(v, b, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, b, err_msg=k)
    n_book = 40 if env else 0
    assert 0 < far["xyz"].shape[0] - n_book < 400    # some fell in a znear


def test_append_prune_znear_and_num_live_match_jax(jax_ref):
    x = pieces_inputs()
    scene = tgs.from_numpy(_scene_of(jax_ref, "pcd"), device="cpu")
    pruned = tinit.prune_mask(scene, torch.tensor(x["kill"]))
    _assert_scene(pruned, jax_ref, "pruned", loose=())
    assert tgs.num_live(pruned) == int(jax_ref["num_live"]) < 500
    far = {k.split("/")[1]: v for k, v in jax_ref.items()
           if k.startswith("far/")}
    _assert_scene(tinit.append_points(pruned, far, pad_multiple=64), jax_ref,
                  "append", loose=())
    kill = tinit.znear_prune_mask(scene, list(CENTERS), ZNEARS)
    np.testing.assert_array_equal(kill.numpy(), jax_ref["znear_kill"])
    assert 0 < kill.sum().item() < 500


def test_scene_from_dataset_matches_jax(jax_ref, dataset):
    cfg = Config(source_path=dataset, resolution=SIZE, trace_chunk=64)
    random.seed(0)
    with mock.patch.dict(os.environ, NO_WORKERS="1"):
        sc = Scene(cfg, device="cpu")
    cams = sc.getTrainCameras() + sc.getTestCameras()
    assert [c.image_name for c in cams] == list(jax_ref["scene/names"])
    assert sc.cameras_extent == float(jax_ref["scene/extent"])
    np.testing.assert_array_equal([(c.znear, c.zfar) for c in cams],
                                  jax_ref["scene/znear_zfar"])
    _assert_scene(sc.gaussians, jax_ref, "scene/gaussians")
    centers, znears = sc.camera_centers_znears()
    assert znears == [c.znear for c in sc.getTrainCameras()]
    pts = np.stack(centers) + 1e-3
    assert sc.select_points_to_prune_near_cameras(pts).all()


def test_save_scene_ply_is_byte_identical(jax_ref, tmp_path):
    scene = tgs.from_numpy(_scene_of(jax_ref, "pruned"), device="cpu")
    save_scene_ply(str(tmp_path / "p.ply"), scene)
    assert (tmp_path / "p.ply").read_bytes() == jax_ref["ply"].tobytes()


def test_psnr_and_image_grid_match_jax(jax_ref, tmp_path):
    from PIL import Image

    x = pieces_inputs()
    assert timg.psnr(x["img_a"], x["img_b"]) == pytest.approx(
        float(jax_ref["psnr"]), rel=1e-12)
    assert timg.psnr(x["img_a"], x["img_a"]) == float("inf")
    assert timg.mse(x["img_a"], x["img_a"]) == 0.0
    timg.save_image_grid(x["grid"], str(tmp_path / "g.png"), nrow=2)
    ours = np.asarray(Image.open(tmp_path / "g.png"))
    theirs = np.asarray(Image.open(jax_ref["dir"] / "grid.png"))
    assert ours.shape == (24, 12, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    timg.save_image(x["grid"][0], str(tmp_path / "one.png"))
    assert np.asarray(Image.open(tmp_path / "one.png")).shape == (8, 6, 3)


@pytest.mark.parametrize("backend,cull,culls", [
    ("xla", True, False), ("auto", True, True), ("pallas", True, True),
    ("auto", False, False), ("pallas", False, False)])
def test_use_pallas_backend_mapping(backend, cull, culls):
    cfg = Config(backend=backend, cull=cull)
    # the kernels trace on every backend: a Config never picks the XLA tracer
    assert ttr.use_pallas_backend(cfg) is True
    assert ttr.step_culls(cfg) is culls


def test_checkpoint_round_trip_of_a_jax_state(jax_ref, tmp_path):
    state = _state_of(jax_ref, "ckpt")
    path = tck.checkpoint_path(str(tmp_path), 7)
    tck.save_train_state(path, state)
    assert tck.latest_checkpoint(str(tmp_path)) == path
    back = tck.load_train_state(path, device="cpu")
    assert back.count == 7
    for tree in ("scene", "mu", "nu"):
        for f in SCENE_FIELDS:
            a = getattr(getattr(back, tree), f)
            assert a.dtype == getattr(getattr(state, tree), f).dtype
            np.testing.assert_array_equal(
                a.numpy(), jax_ref[f"ckpt/{tree}/{f}"], err_msg=f)
    np.testing.assert_array_equal(back.total_weight.numpy(),
                                  jax_ref["ckpt/total_weight"])
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None


def _samples(key, kw):
    import jax.numpy as jnp

    jitter, us = jax_tile_samples(jnp.asarray(key), kw["width"],
                                  kw["height"], kw["tile"],
                                  kw["num_bounces"] + 1)
    return trt.TileSamples(jitter=torch.tensor(jitter), us=torch.tensor(us))


def _run_port_cli(jax_ref, dataset, model):
    """The port's CLI on the JAX run's config, its steps and report
    renders on JAX's samples; returns (final state, the steps' calls)."""
    import jax

    calls = []
    real_step, real_render = ttrain.train_step, ttrain.render

    def step(state, cp, targets, settings, lrs, hyper, **kw):
        i = len(calls)
        kw = dict(kw, generator=None,
                  samples=_samples(jax_ref[f"step{i}/key"], kw))
        new, metrics = real_step(state, cp, targets, settings, lrs, hyper,
                                 **kw)
        calls.append(dict(origin=cp.origin.numpy(), hyper=hyper, lrs=lrs,
                          kw=kw, l1=metrics["l1_diffuse"].item(),
                          capacity=state.scene.capacity, camera=cp,
                          targets=targets, settings=settings))
        return new, metrics

    def render(camera, scene, settings, *args, **kw):
        kw["samples"] = _samples(jax.random.PRNGKey(0), dict(
            width=camera.image_width, height=camera.image_height,
            tile=kw["tile"], num_bounces=kw["num_bounces"]))
        return real_render(camera, scene, settings, *args, **kw)

    cfg = Config(source_path=dataset, model_path=str(model), **CLI_KW)
    with mock.patch.object(ttrain, "train_step", step), \
            mock.patch.object(ttrain, "render", render), \
            mock.patch.dict(os.environ, NO_WORKERS="1"):
        final = ttrain.main(cfg, device="cpu")
    return final, calls


@pytest.fixture(scope="module")
def port_run(jax_ref, dataset, tmp_path_factory):
    model = tmp_path_factory.mktemp("port_cli") / "model"
    final, calls = _run_port_cli(jax_ref, dataset, model)
    return final, calls, model


def _files(model):
    return sorted(str(p.relative_to(model)) for p in model.rglob("*")
                  if p.is_file() and "events.out" not in p.name
                  and "checkpoints" not in p.parts)


def _residue_rows(ref, prefix, f):
    """The Gaussians whose gradient of field `f` is a cancellation residue
    in this step: the rotation of an isotropic Gaussian (its three scales
    equal, as create_from_pcd and farfield_arrays make them, until Adam's
    steps part them) has a zero gradient in exact arithmetic."""
    scaling = ref[f"{prefix}/in/scene/scaling"]
    iso = (scaling[:, 0] == scaling[:, 1]) & (scaling[:, 1] == scaling[:, 2])
    return iso if f == "rotation" else np.zeros_like(iso)


def _param_allowance(ref, prefix, f, lrs):
    """test_torch_train_step.py's rule for one step's params: 1e-6*scale,
    and 2 lr where the gradient is ulp-level or a residue."""
    mu = ref[f"{prefix}/out/mu/{f}"]
    scale = max(1.0, float(np.abs(ref[f"{prefix}/out/scene/{f}"]).max()))
    ulp_level = np.abs(mu) <= 1e-6 * max(1e-30, float(np.abs(mu).max()))
    ulp_level[_residue_rows(ref, prefix, f)] = True
    return np.where(ulp_level, 2.0 * lrs[f], 0.0) + 1e-6 * scale


def test_cli_matches_jax(jax_ref, port_run):
    final, calls, model = port_run
    n = int(jax_ref["n_steps"])
    assert len(calls) == n == CLI_KW["iterations"]
    assert int(jax_ref["n_renders"]) == 2         # train and test view
    # the same artifacts (checkpoints: orbax there, torch.save here)
    assert _files(model) == _files(jax_ref["model"])
    assert (model / "checkpoints" / "step_6" / tck.STATE_FILE).exists()
    assert (model / "num_gaussians.txt").read_text() == (
        jax_ref["model"] / "num_gaussians.txt").read_text()
    ours, theirs = (json.loads((m / "cfg.json").read_text())
                    for m in (model, jax_ref["model"]))
    assert ours.pop("model_path") != theirs.pop("model_path")
    assert ours == theirs
    allow = {f: 0.0 for f in FIELDS}
    for i, c in enumerate(calls):
        p = f"step{i}"
        W, H, nb, K, chunk, tile, culled, mc = jax_ref[f"{p}/ints"]
        kw = c["kw"]
        assert (kw["width"], kw["height"], kw["num_bounces"], kw["max_hits"],
                kw["chunk"], kw["tile"], kw["use_culling"],
                kw["max_clusters"]) == (W, H, nb, K, chunk, tile, bool(culled),
                                        mc), i
        assert not kw["use_culling"]                 # "xla": the brute step
        assert c["hyper"]["apply_grads"] == float(jax_ref[f"{p}/apply_grads"])
        assert [c["lrs"][f] for f in FIELDS] == list(jax_ref[f"{p}/lrs"])
        np.testing.assert_array_equal(c["origin"], jax_ref[f"{p}/origin"])
        assert c["capacity"] == jax_ref[f"{p}/in/scene/xyz"].shape[0], i
        # the residue moves (+-lr) part the two runs' states
        assert c["l1"] == pytest.approx(float(jax_ref[f"{p}/l1_diffuse"]),
                                        rel=FREE_RUN_L1), i
        for f in FIELDS:
            step_allow = _param_allowance(jax_ref, p, f, c["lrs"])
            if f in COUPLED:
                step_allow = np.full_like(step_allow, 2.0 * c["lrs"][f])
            if i and np.shape(allow[f]) != step_allow.shape:
                # the injection compacted the live rows to the front
                live = np.nonzero(jax_ref[f"step{i - 1}/out/scene/live_mask"])
                carried = np.zeros_like(step_allow)
                carried[:live[0].size] = allow[f][live]
                allow[f] = carried
            allow[f] = allow[f] + step_allow
    # bounces from iteration 3, the shell injected after iteration 2
    assert [c["kw"]["num_bounces"] for c in calls] == [0, 0, 2, 2, 2, 2]
    assert calls[2]["capacity"] > calls[1]["capacity"]
    for f in SCENE_FIELDS:
        a = getattr(final.scene, f).numpy()
        b = jax_ref[f"final/scene/{f}"]
        if f == "live_mask":
            np.testing.assert_array_equal(a, b)
        else:
            assert (np.abs(a - b) <= allow[f]).all(), f
    for split in ("train", "test"):
        ours = np.loadtxt(model / f"{split}_validation_scores.csv",
                          delimiter=",", ndmin=2)
        theirs = np.loadtxt(
            jax_ref["model"] / f"{split}_validation_scores.csv",
            delimiter=",", ndmin=2)
        assert ours[:, 0].tolist() == theirs[:, 0].tolist() == [6.0]
        np.testing.assert_allclose(ours[:, 1:], theirs[:, 1:], atol=0.02,
                                   err_msg=split)


def test_cli_steps_match_jax_step_by_step(jax_ref, port_run):
    """Each step of the CLI's run on the JAX run's state in that step."""
    _final, calls, _model = port_run
    for i, c in enumerate(calls):
        p = f"step{i}"
        state = _state_of(jax_ref, f"{p}/in")
        new, metrics = ttr.train_step(state, c["camera"], c["targets"],
                                      c["settings"], c["lrs"], c["hyper"],
                                      **c["kw"])
        assert metrics["l1_diffuse"].item() == pytest.approx(
            float(jax_ref[f"{p}/l1_diffuse"]), rel=1e-5), i
        sums = {(t, f): (getattr(getattr(new, t), f).numpy(),
                         jax_ref[f"{p}/out/{t}/{f}"])
                for f in FIELDS for t in ("mu", "nu")}
        sums[("", "total_weight")] = (new.total_weight.numpy(),
                                      jax_ref[f"{p}/out/total_weight"])
        top = {t: max(float(np.abs(b).max()) for (tt, _f), (_a, b)
                      in sums.items() if tt == t) for t in ("mu", "nu", "")}
        flipped = np.zeros(state.scene.capacity, bool)
        for (t, f), (a, b) in sums.items():
            res = _residue_rows(jax_ref, p, f)
            # both sides' residues: within 1e-6 of the step's largest sum
            assert (np.abs(a - b)[res] <= 1e-6 * top[t]).all(), (i, t, f)
            flipped |= _rows(~_tight(a, b)) & ~res
        assert flipped.sum() <= MAX_FLIPPED, (i, np.nonzero(flipped)[0])
        for (t, f), (a, b) in sums.items():
            res = _residue_rows(jax_ref, p, f)
            scale = max(1e-6, float(np.abs(b[~res]).max(initial=0.0)))
            assert (np.abs(a - b)[~res] <= 2e-3 * scale).all(), (i, t, f)
        for f in FIELDS:
            a = getattr(new.scene, f).numpy()
            b = jax_ref[f"{p}/out/scene/{f}"]
            assert (np.abs(a - b)
                    <= _param_allowance(jax_ref, p, f, c["lrs"])).all(), (i, f)


def test_cli_resume(dataset, tmp_path):
    """A culled run (32-Gaussian clusters, so the 64 points and the 128-point
    shell make three times the clusters) to 4, saved there, then resumed to
    6: iteration 5 next, both bounces, the grown budget, the state as saved."""
    cfg = Config(source_path=dataset, model_path=str(tmp_path / "m"),
                 **dict(CLI_KW, backend="auto", iterations=4,
                        save_iterations=[4], test_iterations=[],
                        cull_tile=64, cull_cluster=32, max_clusters=4,
                        ray_tile=192, trace_chunk=32))
    seen = []
    real = ttrain.train_step

    def step(state, *args, **kw):
        seen.append(dict(kw, capacity=state.scene.capacity))
        return real(state, *args, **kw)

    saved = []
    real_save = ttrain.save_train_state

    def save(path, state):
        saved.append(state)
        return real_save(path, state)

    with mock.patch.object(ttrain, "train_step", step), \
            mock.patch.object(ttrain, "save_train_state", save), \
            mock.patch.dict(os.environ, NO_WORKERS="1"):
        ttrain.main(cfg, device="cpu")
        first = list(seen)
        seen.clear()
        cfg = dataclasses.replace(cfg, iterations=6)
        resumed = ttrain.main(cfg, resume=True, device="cpu")
    assert all(k["use_culling"] for k in first + seen)
    assert [k["max_clusters"] for k in first] == [4, 4, 64, 64]
    assert [k["num_bounces"] for k in seen] == [2, 2]
    assert [k["max_clusters"] for k in seen] == [64, 64]
    assert len(seen) == 2 and seen[0]["capacity"] == first[-1]["capacity"]
    loaded = tck.load_train_state(tck.checkpoint_path(cfg.model_path, 4),
                                  device="cpu")
    for tree in ("scene", "mu", "nu"):
        for f in SCENE_FIELDS:
            assert torch.equal(getattr(getattr(loaded, tree), f),
                               getattr(getattr(saved[0], tree), f))
    assert loaded.count == saved[0].count == 4
    assert resumed.count == 6
    assert all(torch.isfinite(getattr(resumed.scene, f)).all()
               for f in FIELDS)
    assert (tmp_path / "m" / "point_cloud" / "iteration_4").is_dir()


def test_cli_needs_a_card_or_the_cpu(dataset, tmp_path):
    root = str(Path(__file__).resolve().parents[1])
    args = [sys.executable, "-m",
            "editable_gaussian_reflections_tpu_torch.train",
            "-s", dataset, "-m", str(tmp_path / "m"), "-r", str(SIZE),
            "--iterations", "1", "--test_iterations", "1",
            "--save_iterations", "1", "--trace_chunk", "64", "--max_hits",
            "8", "--ray_tile", str(SIZE * SIZE),
            "--init_num_pts_farfield", "16", "--no_bounces_until_iter", "1",
            "--val_view", "0"]
    env = dict(os.environ, NO_WORKERS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    if not torch.cuda.is_available():
        no_card = subprocess.run(args, env=env, capture_output=True,
                                 text=True, timeout=300)
        assert no_card.returncode != 0
        assert "device='cpu'" in no_card.stderr
        assert not (tmp_path / "m").exists()
    done = subprocess.run(args + ["--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    for name in ("cfg.json", "time.txt", "num_gaussians.txt",
                 "train_validation_scores.csv", "test_preview_iteration_1.png",
                 "point_cloud/iteration_1/point_cloud.ply",
                 "checkpoints/step_1/" + tck.STATE_FILE):
        assert (tmp_path / "m" / name).exists(), name


def test_viewer_raises(dataset, tmp_path):
    """--viewer starts the websocket service (tests/test_torch_viewer.py);
    without the `websockets` package it raises in the caller's thread,
    before the first step."""
    cfg = Config(source_path=dataset, model_path=str(tmp_path / "m"),
                 viewer=True)
    steps = []
    with mock.patch.dict(sys.modules, websockets=None), \
            mock.patch.object(ttrain, "train_step",
                              lambda *a, **k: steps.append(a)):
        with pytest.raises(ImportError, match="'websockets'"):
            ttrain.main(cfg, device="cpu")
    assert not steps


if __name__ == "__main__":
    jax_reference(*sys.argv[1:4])
