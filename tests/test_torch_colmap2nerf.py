"""PyTorch port vs the root tools/colmap2nerf.py.

  * On tests/make_prior_fixtures.py's COLMAP prior dataset (sparse/0,
    PINHOLE): the port's transforms.json has the root tool's keys and
    frames in the same order, strings and integers equal, floats within
    1e-12.
  * sharpness on PNG frames (8-bit gray, gray+alpha, RGB, RGBA, 16-bit
    gray; smooth and noisy) within 1e-9 relative of the root tool's, which
    reads them with cv2 (the port decodes them itself); on a JPEG both go
    through cv2 and are equal.
  * --sharpen_percent 50 removes the same files from two copies of a frame
    directory.
  * The JPEG branch with cv2 and PIL blocked raises an ImportError naming
    both.
  * Without a card and without --device cpu the tool exits non-zero.
"""

import json
import shutil
import subprocess
import sys
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.tools import colmap2nerf as tc2n
from editable_gaussian_reflections_tpu_torch.utils.image import write_png
from tests.make_prior_fixtures import make_colmap_prior_dataset
from tests.test_torch_room_dataset import child_env, root_module


@pytest.fixture(scope="module")
def root_tool():
    return root_module("colmap2nerf", "tools/colmap2nerf.py")


def _close(a, b, where="") -> None:
    if isinstance(b, dict):
        assert list(a) == list(b), where
        for k in b:
            _close(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(b, float):
        assert isinstance(a, float) and abs(a - b) <= 1e-12, (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_transforms_match_root(root_tool, tmp_path):
    data = make_colmap_prior_dataset(str(tmp_path / "colmap"))
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    root_tool.main(["--colmap_path", data, "--out", str(theirs)])
    out = tc2n.main(["--colmap_path", data, "--out", str(ours),
                     "--device", "cpu"])
    mine = json.loads(ours.read_text())
    _close(mine, json.loads(theirs.read_text()))
    assert out == mine and len(mine["frames"]) == 9
    # frames sorted by name, each a rigid c2w
    names = [f["file_path"] for f in mine["frames"]]
    assert names == sorted(names)
    for f in mine["frames"]:
        m = np.asarray(f["transform_matrix"])
        np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3),
                                   atol=1e-9)


def _frames(rng):
    """PNG frames of every kind sharpness reads: {name: samples}."""
    h, w = 37, 52
    smooth = np.linspace(0, 255, h * w).reshape(h, w)
    noisy = rng.integers(0, 256, (h, w, 4))
    out = {
        "a_gray.png": np.round(smooth).astype(np.uint8),
        "b_gray_alpha.png": noisy[..., :2].astype(np.uint8),
        "c_rgb.png": noisy[..., :3].astype(np.uint8),
        "d_rgba.png": noisy.astype(np.uint8),
        "e_gray16.png": rng.integers(0, 65536, (h, w)).astype(np.uint16),
        "f_rgb_smooth.png": np.stack([smooth, smooth[::-1],
                                      smooth[:, ::-1]], -1).round().astype(
                                          np.uint8),
    }
    for k in range(4):
        blur = cv2.GaussianBlur(noisy[..., :3].astype(np.uint8), (0, 0),
                                1.0 + k)
        out[f"g_blur{k}.png"] = blur
    return out


def test_sharpness_matches_root(root_tool, tmp_path):
    frames = _frames(np.random.default_rng(0))
    for name, img in frames.items():
        path = str(tmp_path / name)
        write_png(path, img)
        ours, theirs = tc2n.sharpness(path), root_tool.sharpness(path)
        assert ours == pytest.approx(theirs, rel=1e-9, abs=0), name
    jpg = str(tmp_path / "h.jpg")
    cv2.imwrite(jpg, frames["c_rgb.png"])
    assert tc2n.sharpness(jpg) == root_tool.sharpness(jpg)


def test_sharpen_percent_removes_the_same_files(root_tool, tmp_path):
    src = tmp_path / "frames"
    src.mkdir()
    for name, img in _frames(np.random.default_rng(1)).items():
        write_png(str(src / name), img)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    root_tool.main(["--images", str(theirs), "--sharpen_percent", "50"])
    tc2n.main(["--images", str(ours), "--sharpen_percent", "50",
               "--device", "cpu"])
    kept = sorted(p.name for p in ours.iterdir())
    assert kept == sorted(p.name for p in theirs.iterdir())
    assert len(kept) == len(list(src.iterdir())) // 2


def test_jpeg_needs_cv2_or_pil(tmp_path):
    jpg = tmp_path / "a.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xd9")
    blocked = {"cv2": None, "PIL": None, "PIL.Image": None}
    with mock.patch.dict(sys.modules, blocked):
        with pytest.raises(ImportError, match="cv2 or PIL"):
            tc2n.sharpness(str(jpg))
        with pytest.raises(ImportError, match="cv2 or PIL"):
            tc2n.cull_blurry(str(tmp_path), 50)
        # PNGs need neither
        write_png(str(tmp_path / "b.png"), np.zeros((4, 4), np.uint8))
        assert tc2n.sharpness(str(tmp_path / "b.png")) == 0.0


def test_tool_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    data = make_colmap_prior_dataset(str(tmp_path / "colmap"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc2n.main(["--colmap_path", data,
                   "--out", str(tmp_path / "t.json")])
    done = subprocess.run(
        [sys.executable, "-m",
         "editable_gaussian_reflections_tpu_torch.tools.colmap2nerf",
         "--colmap_path", data, "--out", str(tmp_path / "t.json")],
        env=child_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and "device='cpu'" in done.stderr
    assert not (tmp_path / "t.json").exists()
