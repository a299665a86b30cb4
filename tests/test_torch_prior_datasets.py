"""PyTorch port vs JAX package: the Blender-prior and COLMAP-prior dataset
layouts (tests/make_prior_fixtures.py's scenes, as
tests/test_prior_datasets.py builds them).

  * Every CameraInfo field of BlenderPriorDataset and ColmapPriorDataset
    (both splits, at native size with and without `resolution`, clamp_max,
    max_images) against the JAX package's item: equal, except
    render/diffuse/specular, which go through untonemap in float32 on
    each side (PyTorch's pow and sqrt against XLA's): within 1e-6
    relative.  The RANSAC draws: a random.Random(seed) here, the seeded
    `random` module there; the depth rescale recovers the fixture's known
    fit (distances within 2e-3 of the true ones, as the JAX test holds).
  * get_dataset's dispatch: priors/ -> COLMAP prior, sparse/ -> Blender
    prior, else Blender; the Scene reads prior items in order, so a seeded
    read repeats.
  * prepare_initial_ply (sfm, dense) against the root prepare_initial_ply:
    sfm the same bytes; dense the same points and colours within 1e-6
    relative (the prior buffers' untonemap above; the Blender layout's
    8-bit colours through the port's untonemap).
  * Five iterations of the port's training CLI on each layout, on the CPU
    (the twin of test_train_few_iters_on_priors), and on the Blender-prior
    layout initialized from its COLMAP points (prepare_initial_ply --mode
    sfm, init_type sfm): the Scene's first Gaussians sit on those points.
    The COLMAP layout's 225 points fill a 256-Gaussian cluster, so its
    steps cull, and its far-field injection (trace_chunk 64) must keep the
    capacity a multiple of the cluster.
"""

import dataclasses
import os
import random
from unittest import mock

import numpy as np
import pytest

from editable_gaussian_reflections_tpu.dataset.blender_prior import (
    BlenderPriorDataset as JBlenderPrior,
)
from editable_gaussian_reflections_tpu.dataset.colmap_prior import (
    ColmapPriorDataset as JColmapPrior,
)
from editable_gaussian_reflections_tpu_torch import (
    prepare_initial_ply as tprep,
)
from editable_gaussian_reflections_tpu_torch import train as ttrain
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.dataset.blender import (
    BlenderDataset,
)
from editable_gaussian_reflections_tpu_torch.dataset.blender_prior import (
    BlenderPriorDataset,
)
from editable_gaussian_reflections_tpu_torch.dataset.colmap_prior import (
    ColmapPriorDataset,
)
from editable_gaussian_reflections_tpu_torch.scene.dataset_readers import (
    get_dataset,
)
from editable_gaussian_reflections_tpu_torch.utils.ply import (
    load_xyzrgb_ply,
    read_ply,
)
from tests.make_prior_fixtures import (
    make_blender_prior_dataset,
    make_colmap_prior_dataset,
)
from tests.make_synth_dataset import make_dataset
from tests.test_prior_datasets import expected_distance

SIZE = 32
FOV = 0.9
HDR = ("image", "diffuse_image", "specular_image")


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("blender_prior")
    return make_blender_prior_dataset(str(d), size=SIZE, n_train=3, n_test=1,
                                      fov=FOV)


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("colmap_prior")
    return make_colmap_prior_dataset(str(d), size=SIZE, n_frames=9, fov=FOV)


def assert_items_equal(ours, theirs):
    for f in theirs.__dataclass_fields__:
        a, b = getattr(ours, f), getattr(theirs, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            if f in HDR:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


CASES = [("blender", "train", {}), ("blender", "test", {}),
         ("blender", "train", dict(resolution=SIZE, max_images=2)),
         ("colmap", "train", {}), ("colmap", "test", {}),
         ("colmap", "train", dict(clamp_max=0.2, resolution=SIZE,
                                  max_images=3))]


@pytest.mark.parametrize("layout,split,kw", CASES)
def test_prior_items_match_jax(blender_dir, colmap_dir, layout, split, kw):
    d, ours_cls, theirs_cls = (
        (blender_dir, BlenderPriorDataset, JBlenderPrior)
        if layout == "blender" else
        (colmap_dir, ColmapPriorDataset, JColmapPrior))
    seed = 11
    ours = ours_cls(d, split=split, rng=random.Random(seed), **kw)
    theirs = theirs_cls(d, split=split, **kw)
    random.seed(seed)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert_items_equal(a, b)
        np.testing.assert_allclose(a.depth_image[..., 0],
                                   expected_distance(), atol=2e-3)
    if "clamp_max" in kw:
        assert float(a.image.max()) <= 0.2 + 1e-6


def test_scene_reads_prior_items_in_order(blender_dir):
    """Without NO_WORKERS a prior layout still reads its items in order:
    a seeded read repeats, and equals the items read one by one."""
    from editable_gaussian_reflections_tpu_torch.scene.dataset_readers import (
        read_dataset,
    )

    ds = get_dataset(Config(resolution=SIZE), blender_dir, "train")
    runs = []
    for _ in range(2):
        random.seed(3)
        with mock.patch.dict(os.environ):
            os.environ.pop("NO_WORKERS", None)
            runs.append([c.depth_image for c in read_dataset(ds)])
    random.seed(3)
    one_by_one = [ds[i].depth_image for i in range(len(ds))]
    for a, b, c in zip(*runs, one_by_one):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.astype(np.float16))


def test_get_dataset_dispatch(blender_dir, colmap_dir, tmp_path):
    cfg = Config(source_path="x", model_path=str(tmp_path / "m"))
    assert isinstance(get_dataset(cfg, colmap_dir, "train"),
                      ColmapPriorDataset)
    assert isinstance(get_dataset(cfg, blender_dir, "train"),
                      BlenderPriorDataset)
    synth = make_dataset(str(tmp_path / "synth"), size=16, n_train=2,
                         n_test=1, n_points=32)
    assert type(get_dataset(cfg, synth, "train")) is BlenderDataset
    clamp = dataclasses.replace(cfg, clamp_max=0.3, max_images=2)
    ds = get_dataset(clamp, colmap_dir, "train")
    assert ds.clamp_max == 0.3 and len(ds) == 2


def _prepare(tmp_path, src, argv):
    """The port's and the root file's PLY from `argv` on a copy of `src`
    each: (ours, theirs) as paths."""
    import shutil

    import prepare_initial_ply as jprep

    out = []
    for name, main in (("ours", lambda a: tprep.main(a + ["--device", "cpu"])),
                       ("theirs", jprep.main)):
        d = tmp_path / name
        shutil.copytree(src, d)
        for f in d.glob("point_cloud_*.ply"):
            f.unlink()
        main(["-s", str(d)] + argv)
        mode = argv[argv.index("--mode") + 1]
        out.append(d / f"point_cloud_{mode}.ply")
    return out


@pytest.mark.parametrize("layout,argv", [
    ("blender", ["--mode", "sfm"]), ("colmap", ["--mode", "sfm"]),
    ("blender", ["--mode", "dense", "--resolution", str(SIZE),
                 "--voxel_scale", "4"]),
    ("colmap", ["--mode", "dense", "--resolution", str(SIZE),
                "--voxel_scale", "4", "--max_images", "4"]),
    ("synth", ["--mode", "dense", "--resolution", "16", "--voxel_scale",
               "4"])])
def test_prepare_initial_ply_matches_the_root_file(blender_dir, colmap_dir,
                                                   tmp_path, layout, argv):
    if layout == "synth":
        src = make_dataset(str(tmp_path / "synth"), size=16, n_train=2,
                           n_test=1, n_points=32)
    else:
        src = blender_dir if layout == "blender" else colmap_dir
    with mock.patch.dict(os.environ, NO_WORKERS="1"):
        ours, theirs = _prepare(tmp_path, src, argv)
    a, b = read_ply(str(ours)), read_ply(str(theirs))
    assert list(a) == list(b) == ["x", "y", "z", "red", "green", "blue"]
    assert a["x"].size > 0
    if "sfm" in argv:
        assert ours.read_bytes() == theirs.read_bytes()
        return
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("red", "green", "blue"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("layout,init", [("blender", "dense"),
                                         ("colmap", "dense"),
                                         ("blender", "sfm")])
def test_train_few_iters_on_priors(blender_dir, colmap_dir, tmp_path,
                                   layout, init):
    """5 iterations of the port's training CLI through each prior layout,
    on the CPU."""
    src = blender_dir if layout == "blender" else colmap_dir
    if init == "sfm":
        import shutil

        src = str(tmp_path / "data")
        shutil.copytree(blender_dir, src)
        tprep.main(["-s", src, "--mode", "sfm", "--device", "cpu"])
    model_path = str(tmp_path / f"model_{layout}")
    cfg = Config(
        source_path=src, model_path=model_path, resolution=SIZE,
        iterations=5, no_bounces_until_iter=2,
        test_iterations=[5], save_iterations=[5],
        trace_chunk=64, max_hits=8, ray_tile=SIZE * SIZE,
        init_num_pts_farfield=64, init_type=init,
        pruning_interval=4, pruning_start_iter=3, val_view=0,
    )
    seen = []
    real = ttrain.Scene

    def scene(*args, **kw):
        sc = real(*args, **kw)
        seen.append(sc.gaussians.xyz.numpy().copy())
        return sc

    with mock.patch.dict(os.environ, NO_WORKERS="1"), \
            mock.patch.object(ttrain, "Scene", scene):
        state = ttrain.main(cfg, device="cpu")
    assert os.path.exists(os.path.join(model_path, "point_cloud",
                                       "iteration_5", "point_cloud.ply"))
    assert state.count == 5
    points, _ = load_xyzrgb_ply(os.path.join(src, f"point_cloud_{init}.ply"))
    np.testing.assert_array_equal(seen[0][:points.shape[0]], points)
