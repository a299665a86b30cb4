"""PyTorch port vs PIL and the JAX package: the readers a dataset on disk
goes through, with no imaging package.

  * utils/image.read_png against PIL, array for array: 8- and 16-bit,
    colour types 0, 2, 4 and 6, every row filter (files the port's
    write_png writes, one filter per file) and the files PIL writes (its
    adaptive filters); dataset/image_utils.from_png equal to the JAX
    package's from_pil_image(Image.open(path)); palette and interlaced
    files raise.  PIL keeps only the high byte of 16-bit colour types (and
    opens 16-bit gray+alpha as RGBA): read_png keeps both bytes, and
    pil_samples gives PIL's array.
  * dataset/colmap_loader.py's binary and text readers, read_model and
    dataset/colmap_parser.py against the JAX package's, on
    tests/test_io.py's fixture: equal.
  * ops/quaternion.rotmat_to_quat against JAX's on each of Shepperd's four
    branches: within 2 float32 ulps (2.4e-7).
  * utils/depth.py, every function against JAX's: equal (numpy on both
    sides; ransac_linear_fit with its samples from random.Random(seed)
    here and the seeded `random` module there).
  * utils/points.py (make_skybox, depth_to_points): equal;
    utils/ply.save_xyzrgb_ply: JAX's bytes.
  * resize_area at native size with cv2 unimportable, and a Blender
    dataset of PNGs loaded with PIL and cv2 unimportable: the JAX package's
    arrays; tests/test_compress_dataset.py's round trip through the port's
    dataset/blender.py.
"""

import os
import random
import struct
import sys
import zlib
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from editable_gaussian_reflections_tpu.dataset import colmap_loader as jcl
from editable_gaussian_reflections_tpu.dataset.blender import (
    BlenderDataset as JBlenderDataset,
)
from editable_gaussian_reflections_tpu.dataset.colmap_parser import (
    ColmapParser as JColmapParser,
)
from editable_gaussian_reflections_tpu.dataset.image_utils import (
    from_pil_image,
)
from editable_gaussian_reflections_tpu.utils import depth as jdepth
from editable_gaussian_reflections_tpu.utils import ply as jply
from editable_gaussian_reflections_tpu_torch.dataset import blender as tblender
from editable_gaussian_reflections_tpu_torch.dataset import colmap_loader as tcl
from editable_gaussian_reflections_tpu_torch.dataset.colmap_parser import (
    ColmapParser,
)
from editable_gaussian_reflections_tpu_torch.dataset.image_utils import (
    from_png,
    pil_samples,
)
from editable_gaussian_reflections_tpu_torch.ops.quaternion import (
    rotmat_to_quat,
)
from editable_gaussian_reflections_tpu_torch.utils import depth as tdepth
from editable_gaussian_reflections_tpu_torch.utils import ply as tply
from editable_gaussian_reflections_tpu_torch.utils.image import (
    PNG_FILTERS,
    _png_chunk,
    read_png,
    write_png,
)
from tests.make_synth_dataset import make_dataset
from tests.test_io import _write_colmap_binary

CHANNELS = (1, 2, 3, 4)


def _image(ch: int, dtype, seed: int = 0) -> np.ndarray:
    """[13, 17, ch] samples: noise below smooth ramps, so that every filter
    has small and large residues and PIL's adaptive choice varies by row."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    img = rng.integers(0, top + 1, (13, 17, ch)).astype(dtype)
    ramp = np.linspace(0, top, 17)[None, :, None] * np.linspace(
        0.2, 1.0, ch)[None, None, :]
    img[:7] = (ramp + 3 * np.arange(7)[:, None, None]).clip(0, top).astype(
        dtype)
    return img


def _pil_array(path) -> np.ndarray:
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("filter_type", PNG_FILTERS)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", CHANNELS)
def test_read_png_matches_pil_on_the_ports_files(tmp_path, ch, dtype,
                                                 filter_type):
    img = _image(ch, dtype)
    path = str(tmp_path / "a.png")
    write_png(path, img, filter_type)
    with open(path, "rb") as f:
        raw = f.read()
    idat = raw[raw.index(b"IDAT") + 4:]
    rows = zlib.decompressobj().decompress(idat)
    stride = 1 + 17 * ch * np.dtype(dtype).itemsize
    assert {rows[i * stride] for i in range(13)} == {
        PNG_FILTERS.index(filter_type)}
    got = read_png(path)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, img[..., 0] if ch == 1 else img)
    pil = _pil_array(path)
    np.testing.assert_array_equal(pil_samples(got), pil)
    assert pil_samples(got).dtype == pil.dtype
    np.testing.assert_array_equal(from_png(path),
                                  from_pil_image(Image.open(path)))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_read_png_matches_pil_on_pil_files(tmp_path, mode):
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    dtype = np.uint16 if mode == "I;16" else np.uint8
    seen = set()
    for seed in range(4):
        img = _image(ch, dtype, seed)
        pil_img = Image.fromarray(img[..., 0] if ch == 1 else img)
        assert pil_img.mode == mode
        path = str(tmp_path / f"{seed}.png")
        pil_img.save(path)
        with open(path, "rb") as f:
            raw = f.read()
        idat = raw[raw.index(b"IDAT") + 4:]
        rows = zlib.decompressobj().decompress(idat)
        stride = 1 + 17 * ch * np.dtype(dtype).itemsize
        seen |= {rows[i * stride] for i in range(13)}
        got = read_png(path)
        pil = _pil_array(path)
        assert got.dtype == pil.dtype and got.shape == pil.shape
        np.testing.assert_array_equal(got, pil)
        np.testing.assert_array_equal(from_png(path),
                                      from_pil_image(Image.open(path)))
    assert len(seen) >= 2, seen           # PIL varies its filters by row


def test_read_png_at_dataset_size_under_pils_filters(tmp_path):
    """A 96x128 render-like image and a 16-bit depth ramp, written by
    PIL: every filter PIL picks decodes to PIL's array."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    rgb = np.stack([xx * 2, yy * 2, (xx + yy)], -1) + rng.integers(
        0, 8, (96, 128, 3))
    depth = (yy * 400 + xx * 150 + rng.integers(0, 50, (96, 128)))
    for arr in (rgb.clip(0, 255).astype(np.uint8),
                depth.clip(0, 65535).astype(np.uint16)):
        path = str(tmp_path / "d.png")
        Image.fromarray(arr).save(path)
        np.testing.assert_array_equal(read_png(path), _pil_array(path))


def test_read_png_refuses_palette_and_interlaced(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image(3, np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="palette"):
        read_png(path)
    path = str(tmp_path / "i.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0,
                                                0, 1)))
        f.write(_png_chunk(b"IDAT", zlib.compress(bytes(4 * 13))))
        f.write(_png_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)


# ------------------------------------------------------------------ COLMAP

def _write_colmap_text(d):
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n1 PINHOLE 640 480 500 510 320 240\n"
                "2 SIMPLE_PINHOLE 320 240 250 160 120\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n"
                "7 0.9 0.1 0.2 0.3 0.1 0.2 0.3 1 img0.png\n"
                "10 20 100 30 40 -1\n"
                "9 1 0 0 0 1 2 3 2 img1.png\n\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n100 1 2 3 255 128 0 0.5 7 0 7 1\n"
                "101 -1 0.5 2 1 2 3 0.25 9 0\n")


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b) and type(a).__name__ == type(b).__name__
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("form", ["binary", "text"])
def test_colmap_readers_match_jax(tmp_path, form):
    d = tmp_path / "scene" / "sparse" / "0"
    d.mkdir(parents=True)
    if form == "binary":
        _write_colmap_binary(str(d))
        readers = ("read_cameras_binary", "read_images_binary",
                   "read_points3D_binary")
        names = ("cameras.bin", "images.bin", "points3D.bin")
    else:
        _write_colmap_text(str(d))
        readers = ("read_cameras_text", "read_images_text",
                   "read_points3D_text")
        names = ("cameras.txt", "images.txt", "points3D.txt")
    for reader, name in zip(readers, names):
        _assert_same(getattr(tcl, reader)(str(d / name)),
                     getattr(jcl, reader)(str(d / name)))
    _assert_same(tcl.read_model(str(d)), jcl.read_model(str(d)))
    ours, theirs = (ColmapParser(str(tmp_path / "scene")),
                    JColmapParser(str(tmp_path / "scene")))
    for f in ("points", "points_rgb", "points_err", "point_indices"):
        _assert_same(getattr(ours, f), getattr(theirs, f))
    img = ours.image_by_name("img0.png")
    assert img.id == 7
    _assert_same(ours.visible_point_indices(img),
                 theirs.visible_point_indices(theirs.image_by_name(
                     "img0.png")))
    assert ours.image_by_name("missing.png") is None


def _rotations():
    """Random rotations and one on each of Shepperd's four branches (the
    trace or one diagonal entry largest)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    Rs = [jcl.qvec2rotmat(v) for v in q]
    for axis in range(3):
        R = -np.eye(3)
        R[axis, axis] = 1.0             # a half turn about `axis`
        Rs.append(R)
    Rs.append(np.eye(3))
    return np.asarray(Rs, np.float32)


def test_rotmat_to_quat_matches_jax():
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops.quaternion import (
        rotmat_to_quat as jrotmat_to_quat,
    )

    Rs = _rotations()
    ours = rotmat_to_quat(torch.from_numpy(Rs)).numpy()
    theirs = np.asarray(jrotmat_to_quat(jnp.asarray(Rs)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2.4e-7)
    for R in Rs[-4:]:
        np.testing.assert_allclose(tcl.rotmat2qvec(R), jcl.rotmat2qvec(R),
                                   rtol=0, atol=2.4e-7)


# ------------------------------------------------------------------- depth

def test_depth_utils_match_jax():
    rng = np.random.default_rng(9)
    H, W, fovx, fovy = 12, 16, 0.9, 0.7
    R = jcl.qvec2rotmat(rng.normal(size=4) / 2.0)
    R /= np.cbrt(np.linalg.det(R))
    for fn, args in (
            ("compute_primary_ray_directions", (H, W, fovy, R)),
            ("transform_depth_to_position_image",
             (rng.uniform(1, 5, (H, W)), fovx, fovy)),
            ("transform_points", (rng.normal(size=(5, 7, 3)),
                                  rng.normal(size=(4, 4)))),
            ("project_pointcloud_to_depth_map",
             (rng.normal(size=(300, 3)) * [1, 1, 0.5] + [0, 0, 3], fovx,
              fovy, (H, W))),
            ("transform_normals_to_world", (rng.normal(size=(H, W, 3)), R)),
            ("transform_normals_world_to_camera",
             (rng.normal(size=(H, W, 3)), R)),
            ("linear_least_squares_1d", (rng.normal(size=40),
                                         rng.normal(size=40)))):
        _assert_same(getattr(tdepth, fn)(*args), getattr(jdepth, fn)(*args))
    # the RANSAC draws: a seeded random.Random here, the seeded module there
    x = rng.uniform(0.2, 0.9, 500)
    y = 8.0 * x - 0.8 + rng.normal(0, 0.002, 500)
    y[::7] += rng.uniform(1, 3, y[::7].shape)         # outliers
    for seed in (0, 1, 17):
        ours = tdepth.ransac_linear_fit(x, y, rng=random.Random(seed))
        random.seed(seed)
        theirs = jdepth.ransac_linear_fit(x, y)
        _assert_same(ours, theirs)
        assert abs(ours[0][0] - 8.0) < 0.05     # the outliers are out
    # quantized x: the degenerate-sample guards give the same fit
    xq = np.round(x * 4) / 4
    random.seed(4)
    _assert_same(tdepth.ransac_linear_fit(xq, y, rng=random.Random(4)),
                 jdepth.ransac_linear_fit(xq, y))


def test_points_match_jax():
    from editable_gaussian_reflections_tpu.utils import points as jpoints
    from editable_gaussian_reflections_tpu_torch.utils import (
        points as tpoints,
    )

    for args in ((64, 3.0), (10, 1.5, (0.2, 0.3, 0.4), 5)):
        _assert_same(tuple(tpoints.make_skybox(*args)),
                     tuple(jpoints.make_skybox(*args)))
    rng = np.random.default_rng(3)
    args = (rng.uniform(1, 4, (6, 5)), rng.normal(size=(6, 5, 3)),
            rng.normal(size=(6, 5, 3)))
    _assert_same(tpoints.depth_to_points(*args),
                 jpoints.depth_to_points(*args))


def test_save_xyzrgb_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(37, 3)).astype(np.float32)
    rgb = rng.uniform(size=(37, 3)).astype(np.float32)
    tply.save_xyzrgb_ply(str(tmp_path / "a.ply"), xyz, rgb)
    jply.save_xyzrgb_ply(str(tmp_path / "b.ply"), xyz, rgb)
    assert (tmp_path / "a.ply").read_bytes() == (
        tmp_path / "b.ply").read_bytes()
    back = tply.load_xyzrgb_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(back[0], xyz)


# ----------------------------------------------------------------- dataset

def test_resize_area_at_native_size_needs_no_cv2():
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    with mock.patch.dict(sys.modules, cv2=None):
        assert tblender.resize_area(img, 2) is img
        with pytest.raises(ImportError):
            tblender.resize_area(img, 1)


def _blender_png_dataset(root) -> str:
    """tests/make_synth_dataset.py's dataset with its TIFF depth buffers
    re-encoded as PNG (16-bit gray, as the prior layouts store scalars)."""
    data = make_dataset(str(root), size=16, n_train=2, n_test=1,
                        n_points=32)
    for dirpath, _dirs, files in os.walk(data):
        for name in files:
            if name.endswith(".tiff"):
                import imageio.v3 as iio
                p = os.path.join(dirpath, name)
                arr = np.asarray(iio.imread(p), np.float32)
                arr = np.clip(arr / max(float(arr.max()), 1e-6), 0, 1)
                if arr.ndim == 3:
                    arr = arr[..., 0]
                Image.fromarray((arr * 65535).round().astype(
                    np.uint16)).save(p[:-5] + ".png")
                os.remove(p)
    return data


def test_blender_pngs_load_without_pil_or_cv2(tmp_path):
    data = _blender_png_dataset(tmp_path / "png")
    theirs = JBlenderDataset(data, "train", resolution=16)
    with mock.patch.dict(sys.modules, {"PIL": None, "PIL.Image": None,
                                       "cv2": None, "imageio": None}):
        ours = tblender.BlenderDataset(data, "train", resolution=16)
        items = [ours[i] for i in range(len(ours))]
    assert len(items) == len(theirs) == 2
    for a, b in zip(items, (theirs[0], theirs[1])):
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f


def test_compress_roundtrip_through_the_port(tmp_path):
    """tests/test_compress_dataset.py's round trip, loaded by the port's
    BlenderDataset (within f16 quantization), and the source loaded as the
    JAX package loads it."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import compress_dataset

    src = make_dataset(str(tmp_path / "src"), size=16, n_train=2, n_test=1,
                       n_points=32)
    dst = str(tmp_path / "dst")
    assert compress_dataset.compress_scene(src, dst) == 3
    a = tblender.BlenderDataset(src, "train", resolution=16)
    b = tblender.BlenderDataset(dst, "train", resolution=16)
    j = JBlenderDataset(src, "train", resolution=16)
    assert len(a) == len(b) == len(j)
    ia, ib, ij = a[0], b[0], j[0]
    for k in ("image", "diffuse_image", "depth_image", "normal_image",
              "roughness_image", "f0_image"):
        va, vb = np.asarray(getattr(ia, k)), np.asarray(getattr(ib, k))
        assert va.shape == vb.shape, k
        np.testing.assert_allclose(va, vb, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(va, getattr(ij, k), err_msg=k)
