"""PyTorch port vs JAX package: the FPS CLI and the scene loading it needs.

A tiny Blender-layout dataset (tests/make_synth_dataset.py, 32x32 views)
and a model directory written by the JAX package's own writers (cfg.json
through its save_config, point_cloud/iteration_7/point_cloud.ply through
its save_scene_ply) are loaded by both packages' Scene: the Gaussian
parameters must be equal element for element, and the cameras equal in
pose, intrinsics, depth-derived z-planes and G-buffers.  Then the port's
measure_fps CLI runs on the CPU (the kernels' plain versions) and writes
fps.json.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.config import Config as JConfig
from editable_gaussian_reflections_tpu.config import save_config
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.scene.scene import Scene as JScene
from editable_gaussian_reflections_tpu.scene.scene import save_scene_ply
from editable_gaussian_reflections_tpu.utils import ply as jply
from editable_gaussian_reflections_tpu_torch import measure_fps as tfps
from editable_gaussian_reflections_tpu_torch.config import load_model_config
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.scene.scene import (
    Scene,
    search_for_max_iteration,
)
from editable_gaussian_reflections_tpu_torch.utils import ply as tply
from tests.make_synth_dataset import make_dataset

torch.set_num_threads(1)

ITERATION = 7
SIZE = 32


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """(dataset dir, model dir) written by the JAX package."""
    root = tmp_path_factory.mktemp("fps")
    data = make_dataset(str(root / "data"), size=SIZE, n_train=3, n_test=2)
    model = root / "model"
    cfg = dataclasses.replace(JConfig(), source_path=data,
                              model_path=str(model), resolution=SIZE)
    save_config(cfg, str(model / "cfg.json"))
    rng = np.random.default_rng(0)
    n = 300
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scene = jgs.from_arrays(
        xyz=rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        scaling=np.log(rng.uniform(0.05, 0.2, (n, 3))).astype(np.float32),
        rotation=quat, opacity=rng.normal(1.0, 1.0, n).astype(np.float32),
        diffuse=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=rng.uniform(0.05, 0.5, n).astype(np.float32),
        pad_multiple=512)
    save_scene_ply(str(model / "point_cloud" / f"iteration_{ITERATION}"
                       / "point_cloud.ply"), scene)
    return data, model


def test_scene_loads_the_jax_model_directory(model_dir):
    data, model = model_dir
    jcfg = dataclasses.replace(JConfig(), source_path=data,
                               model_path=str(model), resolution=SIZE)
    cfg = load_model_config(str(model), [])
    assert cfg.source_path == data and cfg.resolution == SIZE
    assert search_for_max_iteration(str(model / "point_cloud")) == ITERATION
    ref = JScene(jcfg, load_iteration=ITERATION, shuffle=False,
                 model_path=str(model))
    out = Scene(cfg, load_iteration=ITERATION, shuffle=False,
                model_path=str(model), device="cpu")
    for f in tgs.GaussianScene._fields:
        np.testing.assert_array_equal(getattr(out.gaussians, f).numpy(),
                                      np.asarray(getattr(ref.gaussians, f)),
                                      err_msg=f)
    assert out.cameras_extent == ref.cameras_extent
    for split in ("getTrainCameras", "getTestCameras"):
        cams, jcams = getattr(out, split)(), getattr(ref, split)()
        assert [c.image_name for c in cams] == [c.image_name for c in jcams]
        for c, j in zip(cams, jcams):
            for a in ("R", "T", "camera_center", "world_view_transform",
                      "full_proj_transform"):
                np.testing.assert_array_equal(getattr(c, a), getattr(j, a),
                                              err_msg=a)
            assert (c.FoVx, c.FoVy, c.znear, c.zfar) == (
                j.FoVx, j.FoVy, j.znear, j.zfar)
            for a, b in zip(c.render_pose(c.znear, c.zfar),
                            j.render_pose(j.znear, j.zfar)):
                np.testing.assert_array_equal(a, b)
            for img in ("original_image", "diffuse_image", "depth_image",
                        "normal_image", "roughness_image", "f0_image"):
                # float16 on the host; the untonemap's float32 rounding may
                # differ by one float16 step
                np.testing.assert_allclose(getattr(c, img), getattr(j, img),
                                           rtol=1e-3, atol=1e-3, err_msg=img)


def test_ply_codec_is_byte_compatible(model_dir, tmp_path):
    _, model = model_dir
    src = model / "point_cloud" / f"iteration_{ITERATION}" / "point_cloud.ply"
    ours, theirs = tply.load_gaussian_ply(src), jply.load_gaussian_ply(src)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    tply.save_gaussian_ply(a, **ours)
    jply.save_gaussian_ply(b, **theirs)
    assert a.read_bytes() == b.read_bytes() == src.read_bytes()


def test_prior_layouts_raise(model_dir, tmp_path):
    """A sparse/ directory selects the Blender-prior layout, which loads
    now (tests/test_torch_prior_datasets.py): without a COLMAP model in it,
    its COLMAP reader raises, where the Blender layout would not look."""
    _, model = model_dir
    (tmp_path / "sparse").mkdir()
    cfg = dataclasses.replace(load_model_config(str(model), []),
                              source_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="cameras.txt"):
        Scene(cfg, load_iteration=ITERATION, model_path=str(model),
              device="cpu")
    # initializing from the point cloud reads the dataset first
    with pytest.raises(FileNotFoundError, match="cameras.txt"):
        Scene(cfg, model_path=str(model), device="cpu")


def test_measure_fps_runs_on_the_cpu_and_writes_fps_json(model_dir, capsys):
    _, model = model_dir
    (model / "fps.json").unlink(missing_ok=True)
    fps = tfps.main(["-m", str(model), "--device", "cpu"])
    assert fps > 0.0
    text = (model / "fps.json").read_text()
    assert float(text) == pytest.approx(fps, abs=0.01)
    printed = capsys.readouterr().out
    assert "composite_mode: scanq" in printed and "FPS" in printed
    cfg = json.loads((model / "cfg.json").read_text())
    assert cfg["composite_mode"] == "kbuffer"  # the CLI's default, not saved
