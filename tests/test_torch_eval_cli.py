"""PyTorch port vs the root CLIs: the evaluation half of run.sh (render,
metrics) and tools/render_novel_views.py.

  * psnr_metric, ssim_metric and msssim_metric against the root
    metrics.py: equal (the same numpy and scipy code).  RandomVGGLPIPS: the
    root file's seed-0 weights, and its distance within 1e-5 relative (its
    convolutions are XLA's there, PyTorch's here).  PretrainedVGGLPIPS on
    the random checkpoints tests/test_metrics_lpips.py builds: within 1e-5
    relative of the root file's and 1e-4 of that test's torch reference;
    the available() gate.
  * The metrics CLI on the root render CLI's PNG tree: psnr, ssim and
    msssim in metrics.json equal to the root metrics.py's, lpips_rand
    within 1e-4 (both round to 4 decimals).
  * env_mode_pose and generate_spiral_path against the root file's and
    the JAX package's: equal.
  * The render CLI on a model directory written by the JAX package's
    writers (tests/make_synth_dataset.py's views at 24x24, 300 random
    Gaussians, backend "xla": the brute trace on both sides, the port's
    plain version here) at 4 spp in chunks of 2, denoised (the KPN), the
    port's render_frame fed the samples JAX draws from each chunk's key
    (fold_in(fold_in(PRNGKey(view), done), i)): every pass's PNG, target
    PNG and overflow.json against the root render.py's.  The frames differ
    on ulp-level hits (test_torch_backend.py's frame rule: at most 0.5% of
    the elements out of tolerance), so a PNG may differ by 1 level in at
    most PNG_SHARE of its values, and by more at no more than FLIP_SHARE
    of its pixels (measured: one pixel of 576, 5 levels, in a 2-spp
    specular pass).
  * tools/render_novel_views at 2 spiral views, 2 spp, the same way
    (PRNGKey(view) folded per sample).
  * Without a card and without --device cpu, every new CLI raises (as a
    process: exits non-zero).
The JAX side runs in a child process capped at AVX (see
test_torch_render_frame.py).
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import metrics as tmetrics
from editable_gaussian_reflections_tpu_torch import (
    prepare_initial_ply as tprep,
)
from editable_gaussian_reflections_tpu_torch import render as trender
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.tools import (
    render_novel_views as tnovel,
)
from editable_gaussian_reflections_tpu_torch.utils.cam_paths import (
    generate_spiral_path,
)
from editable_gaussian_reflections_tpu_torch.utils.image import read_png

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ITERATION = 7
SIZE = 24
SPP, CHUNK = 4, 2
NOVEL_VIEWS, NOVEL_SPP = 2, 2
# the share of a PNG's values that may differ by one 8-bit level, and of
# its pixels by more (a hit flipping on an ulp)
PNG_SHARE = 0.01
FLIP_SHARE = 0.005
PASSES = trender.PASSES


def _root_module(name, rel):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_model(root: Path):
    """(dataset, model directory) written by the JAX package."""
    from editable_gaussian_reflections_tpu.config import Config as JConfig
    from editable_gaussian_reflections_tpu.config import save_config
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
    from editable_gaussian_reflections_tpu.scene.scene import save_scene_ply
    from tests.make_synth_dataset import make_dataset

    data = make_dataset(str(root / "data"), size=SIZE, n_train=3, n_test=2,
                        n_points=64)
    model = root / "model"
    cfg = dataclasses.replace(
        JConfig(), source_path=data, model_path=str(model), resolution=SIZE,
        backend="xla", max_hits=8, trace_chunk=64, ray_tile=SIZE * SIZE)
    save_config(cfg, str(model / "cfg.json"))
    rng = np.random.default_rng(0)
    n = 300
    scene = jgs.from_arrays(
        xyz=rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        scaling=np.log(rng.uniform(0.05, 0.2, (n, 3))).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(1.0, 1.0, n).astype(np.float32),
        diffuse=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=rng.uniform(0.05, 0.5, n).astype(np.float32),
        pad_multiple=64)
    save_scene_ply(str(model / "point_cloud" / f"iteration_{ITERATION}"
                       / "point_cloud.ply"), scene)
    return data, model


RENDER_ARGV = ["--spp", str(SPP), "--spp_chunk", str(CHUNK), "--skip_video"]
NOVEL_ARGV = ["--n_views", str(NOVEL_VIEWS), "--spp", str(NOVEL_SPP)]
METRICS_ARGV = ["--iteration", str(ITERATION), "--metrics", "psnr", "ssim",
                "msssim", "lpips"]


def jax_cli_runs(model):
    """The root render, novel-view and metrics CLIs on `model`.  Run by the
    models fixture in a child process."""
    sys.argv = ["render"]
    _root_module("render", "render.py").main(["-m", model] + RENDER_ARGV)
    _root_module("novel", "tools/render_novel_views.py").main(
        ["-m", model] + NOVEL_ARGV)
    _root_module("metrics", "metrics.py").main(["-m", model] + METRICS_ARGV)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    data, model = build_model(root)
    jax_model, port_model = root / "jax_model", root / "port_model"
    shutil.copytree(model, jax_model)
    shutil.copytree(model, port_model)
    env = dict(os.environ, JAX_PLATFORMS="cpu", NO_WORKERS="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    subprocess.run([sys.executable, __file__, str(jax_model)], env=env,
                   check=True, timeout=600)
    return dict(data=data, jax=jax_model, port=port_model)


def _jax_keys(view_keys):
    import jax

    return [jax.random.fold_in(k, i) for k, i in view_keys]


def run_port_cli(main, argv, keys):
    """`main(argv)` with the port's render_frame fed, call by call, the
    samples JAX draws from `keys`."""
    from tests.test_torch_render_tile import jax_tile_samples

    real = trt.render_frame
    queue = list(keys)

    def render_frame(scene, camera, settings, generator, width, height,
                     **kw):
        jitter, us = jax_tile_samples(queue.pop(0), width, height,
                                      kw["tile"], kw["num_bounces"] + 1)
        kw["samples"] = trt.TileSamples(jitter=torch.tensor(jitter),
                                        us=torch.tensor(us))
        return real(scene, camera, settings, None, width, height, **kw)

    with mock.patch.object(trt, "render_frame", render_frame), \
            mock.patch.dict(os.environ, NO_WORKERS="1"):
        main(argv + ["--device", "cpu"])
    assert not queue


@pytest.fixture(scope="module")
def port_runs(models):
    import jax

    model = str(models["port"])
    render_keys = [(jax.random.fold_in(jax.random.PRNGKey(v), done), i)
                   for v in range(2) for done in range(0, SPP, CHUNK)
                   for i in range(min(CHUNK, SPP - done))]
    run_port_cli(trender.main, ["-m", model] + RENDER_ARGV,
                 _jax_keys(render_keys))
    novel_keys = [(jax.random.PRNGKey(v), i) for v in range(NOVEL_VIEWS)
                  for i in range(NOVEL_SPP)]
    run_port_cli(tnovel.main, ["-m", model] + NOVEL_ARGV,
                 _jax_keys(novel_keys))
    return models


def assert_pngs_close(ours: Path, theirs: Path):
    a, b = read_png(str(ours)), read_png(str(theirs))
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, ours
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    flipped = (diff > 1).any(-1)
    assert flipped.mean() <= FLIP_SHARE, (ours, int(flipped.sum()))
    assert (diff > 0).mean() <= PNG_SHARE, (ours, float((diff > 0).mean()))


def _pngs(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*.png"))


# ----------------------------------------------------------------- metrics

def _images(seed=0, size=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_metric_functions_match_root():
    root = _root_module("metrics", "metrics.py")
    for seed in range(2):
        a, b = _images(seed, 96)
        for fn in ("psnr_metric", "ssim_metric", "msssim_metric"):
            assert getattr(tmetrics, fn)(a, b) == getattr(root, fn)(a, b), fn
        assert tmetrics.psnr_metric(a, a) == 100.0
    ours = tmetrics.RandomVGGLPIPS(device="cpu")
    theirs = root.RandomVGGLPIPS()
    for la, lb in zip(ours.weights, theirs.weights):
        for wa, wb in zip(la, lb):
            np.testing.assert_array_equal(wa, wb)
    a, b = _images(1)
    assert ours(a, b) == pytest.approx(theirs(a, b), rel=1e-5)
    assert ours(a, a) < 1e-6 and ours(a, b) > 0


def test_pretrained_lpips_matches_root(tmp_path, monkeypatch):
    from tests.test_metrics_lpips import _make_checkpoints, _torch_lpips

    root = _root_module("metrics", "metrics.py")
    monkeypatch.delenv("LPIPS_VGG_WEIGHTS", raising=False)
    monkeypatch.delenv("LPIPS_LIN_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))  # no caches
    assert not tmetrics.PretrainedVGGLPIPS.available()
    vgg_path, lin_path, convs, lin_sd = _make_checkpoints(str(tmp_path))
    monkeypatch.setenv("LPIPS_VGG_WEIGHTS", vgg_path)
    monkeypatch.setenv("LPIPS_LIN_WEIGHTS", lin_path)
    assert tmetrics.PretrainedVGGLPIPS.available()
    a, b = _images(0)
    ours = tmetrics.PretrainedVGGLPIPS(device="cpu")(a, b)
    assert ours == pytest.approx(
        root.PretrainedVGGLPIPS(vgg_path, lin_path)(a, b), rel=1e-5)
    assert ours == pytest.approx(_torch_lpips(a, b, convs, lin_sd), rel=1e-4)
    assert tmetrics.PretrainedVGGLPIPS(device="cpu")(a, a) == pytest.approx(
        0.0, abs=1e-6)


def test_metrics_cli_matches_root(models, tmp_path):
    tree = tmp_path / "model"
    shutil.copytree(models["jax"], tree)
    (tree / "metrics.json").unlink()
    ours = tmetrics.main(["-m", str(tree), "--device", "cpu"] + METRICS_ARGV)
    theirs = json.loads((models["jax"] / "metrics.json").read_text())
    assert json.loads((tree / "metrics.json").read_text()) == ours
    assert list(ours) == list(theirs) == ["diffuse", "specular", "render"]
    for rp in ours:
        assert list(ours[rp]) == list(theirs[rp]) == [
            "psnr", "ssim", "msssim", "lpips_rand"]
        for m in ("psnr", "ssim", "msssim"):
            assert ours[rp][m] == theirs[rp][m], (rp, m)
        assert abs(ours[rp]["lpips_rand"] - theirs[rp]["lpips_rand"]) <= (
            1e-4 + 1e-9)


# ------------------------------------------------------- poses and paths

def test_env_mode_pose_and_spiral_match_root():
    from editable_gaussian_reflections_tpu.utils.cam_paths import (
        generate_spiral_path as jspiral,
    )

    root = _root_module("render", "render.py")
    for mode in ("env_rot_1", "env_rot_2", "env_move_1", "env_move_2"):
        for idx in range(4):
            for a, b in zip(trender.env_mode_pose(mode, idx, 4),
                            root.env_mode_pose(mode, idx, 4)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        trender.env_mode_pose("regular", 0, 4)
    from tests.make_synth_dataset import look_at_c2w

    rng = np.random.default_rng(4)
    eyes = rng.normal(size=(5, 3)) * [0.5, 0.5, 0.1] + [0, -3, 1]
    c2ws = np.stack([look_at_c2w(e, target=rng.normal(size=3) * 0.1)
                     for e in eyes])
    c2ws[:, :3, 1:3] *= -1          # Blender -> COLMAP axes
    for kw in ({}, dict(n_render_views=7, n_rots=1, zrate=0.3)):
        path = generate_spiral_path(c2ws, **kw)
        assert np.isfinite(path).all()
        np.testing.assert_array_equal(path, jspiral(c2ws, **kw))


# ---------------------------------------------------------------- the CLIs

def test_render_cli_matches_root(port_runs):
    base = Path("test") / f"ours_{ITERATION}"
    ours, theirs = port_runs["port"] / base, port_runs["jax"] / base
    names = _pngs(theirs)
    assert names == _pngs(ours)
    assert len(names) == 2 * len(PASSES) * 2      # 2 views, preds + targets
    for name in names:
        assert_pngs_close(ours / name, theirs / name)
    assert json.loads((ours / "overflow.json").read_text()) == json.loads(
        (theirs / "overflow.json").read_text())


def test_render_novel_views_matches_root(port_runs):
    base = Path("novel_views") / f"ours_{ITERATION}"
    ours, theirs = port_runs["port"] / base, port_runs["jax"] / base
    names = _pngs(theirs)
    assert names == _pngs(ours) and len(names) == NOVEL_VIEWS * len(PASSES)
    for name in names:
        assert_pngs_close(ours / name, theirs / name)


def test_clis_need_a_card_or_the_cpu(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    model = str(models["port"])
    for main, argv in (
            (trender.main, ["-m", model]),
            (tnovel.main, ["-m", model]),
            (tmetrics.main, ["-m", model]),
            (tprep.main, ["-s", models["data"]])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.RandomVGGLPIPS()
    env =dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    done = subprocess.run(
        [sys.executable, "-m", "editable_gaussian_reflections_tpu_torch."
         "render", "-m", model], env=env, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0 and "device='cpu'" in done.stderr


if __name__ == "__main__":
    jax_cli_runs(sys.argv[1])
