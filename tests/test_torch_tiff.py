"""The port's numpy TIFF reader and writer (utils/image.py read_tiff,
write_tiff) against imageio, and the Blender loader on TIFF buffers.

  * read_tiff on imageio's float32 files (gray and RGB, 16x16 and 129x77,
    NaN and infinities included) equals iio.imread bit for bit, and
    imageio reads write_tiff's files bit for bit (tolerance 0: the bytes
    of the float32 values are compared).
  * Hand-built files: several strips (RowsPerStrip 3 of 16 rows, SHORT
    offsets), big-endian (MM), four samples a pixel: read bit for bit.
  * Each refusal (Compression 5, a TileWidth tag, 64-bit samples,
    PlanarConfiguration 2, unsigned samples, a truncated strip) raises a
    ValueError that names its tag.
  * BlenderDataset on tests/make_synth_dataset.py's dataset (float32 TIFF
    depth buffers) with imageio, cv2 and PIL blocked equals the JAX
    package's BlenderDataset field by field (tolerance 0).
"""

import struct
import sys
from unittest import mock

import imageio.v3 as iio
import numpy as np
import pytest

from editable_gaussian_reflections_tpu.dataset.blender import (
    BlenderDataset as JBlenderDataset,
)
from editable_gaussian_reflections_tpu_torch.dataset import (
    blender as tblender,
)
from editable_gaussian_reflections_tpu_torch.utils.image import (
    read_tiff,
    write_tiff,
)
from tests.make_synth_dataset import make_dataset

BLOCKED = {"imageio": None, "imageio.v3": None, "cv2": None, "PIL": None,
           "PIL.Image": None}


def _image(shape, seed=0) -> np.ndarray:
    img = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    img.flat[0], img.flat[1], img.flat[2] = np.nan, np.inf, -np.inf
    return img


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


SHAPES = [(16, 16), (16, 16, 3), (129, 77), (129, 77, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_read_tiff_matches_imageio(shape, tmp_path):
    img = _image(shape)
    path = str(tmp_path / "a.tiff")
    iio.imwrite(path, img)
    _same(read_tiff(path), np.asarray(iio.imread(path)))
    _same(read_tiff(path), img)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_imageio_reads_write_tiff(shape, tmp_path):
    img = _image(shape, seed=1)
    path = str(tmp_path / "a.tiff")
    write_tiff(path, img)
    _same(np.asarray(iio.imread(path)), img)
    _same(read_tiff(path), img)


def build_tiff(img: np.ndarray, order: str = "<", rows_per_strip=None,
               tags: dict | None = None, drop=(), offsets_type: int = 4,
               bits: int = 32) -> bytes:
    """A TIFF of `img` ([H, W, C] samples, written as they are) in byte
    order `order`, strips of rows_per_strip rows, with `tags` ({tag: (type,
    values)}) overriding or adding entries and `drop` removed."""
    h, w, c = img.shape
    rows = rows_per_strip or h
    data = np.ascontiguousarray(img).astype(
        img.dtype.newbyteorder(order)).tobytes()
    row_bytes = w * c * img.dtype.itemsize
    strips = [data[y * row_bytes:min(h, y + rows) * row_bytes]
              for y in range(0, h, rows)]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c),
               259: (3, [1]), 262: (3, [1 if c == 1 else 2]),
               273: (offsets_type, [0] * len(strips)), 277: (3, [c]),
               278: (4, [rows]), 279: (4, [len(s) for s in strips]),
               284: (3, [1]), 339: (3, [3] * c)}
    entries.update(tags or {})
    for t in drop:
        entries.pop(t)
    codes = {3: "H", 4: "I"}
    n = len(entries)
    extra_at = 8 + 2 + 12 * n + 4
    extra = b""
    # strips after the out-of-line values; offsets fixed up below
    blobs = {}
    for tag, (typ, vals) in sorted(entries.items()):
        blobs[tag] = struct.pack(order + codes[typ] * len(vals), *vals)
    sizes = sum(len(b) for b in blobs.values() if len(b) > 4)
    data_at = extra_at + sizes
    offs, at = [], data_at
    for s in strips:
        offs.append(at)
        at += len(s)
    typ = entries[273][0]
    blobs[273] = struct.pack(order + codes[typ] * len(offs), *offs)
    out = [(b"II" if order == "<" else b"MM")
           + struct.pack(order + "HI", 42, 8), struct.pack(order + "H", n)]
    for tag, (typ, vals) in sorted(entries.items()):
        raw = blobs[tag]
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack(order + "I", extra_at + len(extra))
            extra += raw
        out.append(struct.pack(order + "HHI", tag, typ, len(vals)) + field)
    out.append(struct.pack(order + "I", 0))
    assert len(extra) == sizes
    return b"".join(out) + extra + b"".join(strips)


@pytest.mark.parametrize("case", ["strips", "big_endian", "rgba",
                                  "big_endian_strips_gray"])
def test_read_tiff_other_layouts(case, tmp_path):
    path = tmp_path / "a.tiff"
    if case == "strips":
        img = _image((16, 9, 3), seed=2)
        path.write_bytes(build_tiff(img, rows_per_strip=3, offsets_type=3))
    elif case == "big_endian":
        img = _image((7, 5, 3), seed=3)
        path.write_bytes(build_tiff(img, order=">"))
    elif case == "rgba":
        img = _image((6, 4, 4), seed=4)
        path.write_bytes(build_tiff(img, tags={338: (3, [2])}))
    else:
        img = _image((11, 6, 1), seed=5)
        path.write_bytes(build_tiff(img, order=">", rows_per_strip=4))
    out = read_tiff(str(path))
    _same(out, img[..., 0] if img.shape[2] == 1 else img)
    if case != "rgba":
        # imageio reads the same pixels
        _same(np.asarray(iio.imread(str(path)), np.float32), out)


REFUSALS = {
    "compressed": (dict(tags={259: (3, [5])}), "Compression"),
    "tiled": (dict(tags={322: (3, [16]), 323: (3, [16])}), "TileWidth"),
    "float64": (dict(tags={258: (3, [64, 64, 64])}), "BitsPerSample"),
    "planar_2": (dict(tags={284: (3, [2])}), "PlanarConfiguration"),
    "unsigned": (dict(tags={339: (3, [1, 1, 1])}), "SampleFormat"),
    "no_sample_format": (dict(drop=(339,)), "SampleFormat"),
    "short_strip": (dict(tags={279: (4, [100])}), "StripByteCounts"),
    "predictor": (dict(tags={317: (3, [3])}), "Predictor"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_read_tiff_refuses_what_it_cannot_read(case, tmp_path):
    kw, tag = REFUSALS[case]
    img = _image((16, 16, 3), seed=6)
    if case == "float64":
        img = img.astype(np.float64)
    path = tmp_path / "a.tiff"
    path.write_bytes(build_tiff(img, **kw))
    with pytest.raises(ValueError, match=tag):
        read_tiff(str(path))


def test_write_tiff_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float64), np.zeros((4, 4, 2), np.float32),
                np.zeros(4, np.float32)):
        with pytest.raises(ValueError):
            write_tiff(str(tmp_path / "a.tiff"), bad)


def test_blender_tiff_dataset_loads_without_imaging_packages(tmp_path):
    data = make_dataset(str(tmp_path / "data"), size=16, n_train=2, n_test=1,
                        n_points=32)
    theirs = JBlenderDataset(data, "train", resolution=16)
    with mock.patch.dict(sys.modules, BLOCKED):
        ours = tblender.BlenderDataset(data, "train", resolution=16)
        items = [ours[i] for i in range(len(ours))]
    assert len(items) == len(theirs) == 2
    for a, b in zip(items, (theirs[0], theirs[1])):
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert x.tobytes() == y.tobytes(), f
            else:
                assert x == y, f
    # the depth buffers are the TIFFs
    assert any(p.suffix == ".tiff" for p in (tmp_path / "data").rglob("*"))
