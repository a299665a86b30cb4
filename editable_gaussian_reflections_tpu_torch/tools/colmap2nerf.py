"""COLMAP -> transforms.json converter (instant-ngp style) - twin of the root
tools/colmap2nerf.py.

    python -m editable_gaussian_reflections_tpu_torch.tools.colmap2nerf \\
        --colmap_path <dir with sparse/0> [--images images] \\
        [--out transforms.json] [--aabb_scale 16] [--video <file> \\
        --video_fps 2] [--sharpen_percent P] [--device cpu]

Reads a COLMAP sparse model with the port's loaders
(dataset/colmap_loader.py) and writes transforms.json: camera_angle_x/_y,
the focal lengths, and per frame (sorted by name) the c2w matrix in the
OpenGL/Blender convention the Blender datasets expect.  --video extracts
frames with ffmpeg (a RuntimeError when it is not on PATH);
--sharpen_percent keeps the sharpest share of the frames by the variance
of the Laplacian, computed in numpy for PNG frames (`sharpness`); JPEG
frames need cv2 or PIL, as in the JAX tool.  Host code only: nothing here
runs on the card, but the tool takes `--device` as every tool of the port
does (cuda unless `--device cpu`; without a card and without it the tool
exits non-zero).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess

import numpy as np

from ..dataset.colmap_loader import qvec2rotmat, read_model
from ..device import resolve_device
from ..utils.image import read_png

# libpng's RGB -> gray (what cv2.imread(..., IMREAD_GRAYSCALE) asks of
# it: png_set_rgb_to_gray(0.299, 0.587)) in 15-bit fixed point, truncated
_GRAY_RGB = (9797, 19234, 3737)


def png_gray8(path) -> np.ndarray:
    """An 8-bit PNG (or 16-bit gray) as cv2.imread(path,
    cv2.IMREAD_GRAYSCALE) decodes it: colour through libpng's fixed-point
    weights, truncated; alpha dropped; 16-bit gray to its high byte."""
    img = read_png(path)
    if img.dtype == np.uint16:
        if img.ndim != 2:
            raise ValueError(f"{path}: 16-bit colour PNGs are not supported "
                             "by sharpness (8-bit, or 16-bit gray)")
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return img[..., 0]
    rgb = img[..., :3].astype(np.int64)
    w = np.asarray(_GRAY_RGB, np.int64)
    return ((rgb * w).sum(-1) >> 15).astype(np.uint8)


def laplacian_var(gray: np.ndarray) -> float:
    """cv2.Laplacian(gray, cv2.CV_64F).var(): the 3x3 kernel [0 1 0; 1 -4
    1; 0 1 0] in float64, borders reflected without repeating the edge
    (BORDER_REFLECT_101)."""
    p = np.pad(np.asarray(gray, np.float64), 1, mode="reflect")
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4 * p[1:-1, 1:-1])
    return float(lap.var())


def sharpness(image_path) -> float:
    """Variance of the Laplacian (the reference's blur metric), as the JAX
    tool's cv2 branch computes it.  PNGs are decoded here; other formats
    go through cv2, else PIL (whose branch differs, as in the JAX tool:
    float32 gray, the border rows and columns left out)."""
    if image_path.lower().endswith(".png"):
        return laplacian_var(png_gray8(image_path))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(image_path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            return 0.0
        return float(cv2.Laplacian(img, cv2.CV_64F).var())
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{image_path}: sharpness of a non-PNG frame needs cv2 or PIL "
            "(opencv-python or pillow), and neither is installed") from None
    g = np.asarray(Image.open(image_path).convert("L"), np.float32)
    lap = (-4 * g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1]
           + g[1:-1, :-2] + g[1:-1, 2:])
    return float(lap.var())


def extract_video_frames(video: str, out_dir: str, fps: float) -> int:
    """ffmpeg frame extraction (reference run_ffmpeg equivalent)."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH (needed for --video)")
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-i", video, "-qscale:v", "1", "-qmin", "1",
         "-vf", f"fps={fps}", os.path.join(out_dir, "%04d.jpg")],
        check=True, capture_output=True,
    )
    return len([f for f in os.listdir(out_dir) if f.endswith(".jpg")])


def cull_blurry(images_dir: str, keep_percent: float) -> int:
    """Delete the blurriest (100 - keep_percent)% of frames."""
    files = sorted(
        f for f in os.listdir(images_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))
    scored = [(sharpness(os.path.join(images_dir, f)), f) for f in files]
    scored.sort(reverse=True)
    keep = max(1, int(len(scored) * keep_percent / 100.0))
    removed = 0
    for _, f in scored[keep:]:
        os.remove(os.path.join(images_dir, f))
        removed += 1
    return removed


def transforms(colmap_path: str, images: str, aabb_scale: int) -> dict:
    """transforms.json's contents from the sparse model under
    `colmap_path` (sparse/0, sparse, or the directory itself)."""
    sparse = colmap_path
    for sub in ("sparse/0", "sparse"):
        cand = os.path.join(colmap_path, sub)
        if os.path.isdir(cand):
            sparse = cand
            break
    cams, imgs, _pts = read_model(sparse)

    cam = next(iter(cams.values()))
    w, h = cam.width, cam.height
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        fl_x = fl_y = cam.params[0]
    else:
        fl_x, fl_y = cam.params[0], cam.params[1]
    angle_x = 2 * math.atan(w / (2 * fl_x))
    angle_y = 2 * math.atan(h / (2 * fl_y))

    frames = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        R = qvec2rotmat(img.qvec)
        t = img.tvec.reshape(3, 1)
        w2c = np.concatenate([np.concatenate([R, t], 1),
                              [[0, 0, 0, 1]]], 0)
        c2w = np.linalg.inv(w2c)
        # COLMAP (y down, z forward) -> OpenGL/Blender (y up, z back)
        c2w[0:3, 1:3] *= -1
        frames.append({
            "file_path": os.path.join(images, img.name),
            "transform_matrix": c2w.tolist(),
        })
    return {
        "camera_angle_x": angle_x,
        "camera_angle_y": angle_y,
        "fl_x": float(fl_x), "fl_y": float(fl_y),
        "w": int(w), "h": int(h),
        "cx": w / 2, "cy": h / 2,
        "aabb_scale": aabb_scale,
        "frames": frames,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="colmap2nerf", allow_abbrev=False)
    p.add_argument("--colmap_path", required=False, default=None,
                   help="dir containing sparse/0 (or the sparse dir itself)")
    p.add_argument("--images", default="images")
    p.add_argument("--out", default="transforms.json")
    p.add_argument("--aabb_scale", type=int, default=16)
    p.add_argument("--video", default=None,
                   help="extract frames from this video into --images first")
    p.add_argument("--video_fps", type=float, default=2.0)
    p.add_argument("--sharpen_percent", type=float, default=None,
                   help="keep only this percent of sharpest frames")
    p.add_argument("--device", default="cuda",
                   help="cuda or cpu, as every tool of the port takes it "
                   "(the conversion itself runs on the host)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.video:
        n = extract_video_frames(args.video, args.images, args.video_fps)
        print(f"extracted {n} frames from {args.video} @ {args.video_fps} fps")
    if args.sharpen_percent is not None:
        removed = cull_blurry(args.images, args.sharpen_percent)
        print(f"culled {removed} blurry frames "
              f"(kept sharpest {args.sharpen_percent}%)")
    if args.colmap_path is None:
        if args.video or args.sharpen_percent is not None:
            print("no --colmap_path given - frames prepared, run COLMAP "
                  "then re-invoke with --colmap_path")
            return None
        p.error("--colmap_path is required (unless only preparing frames)")

    out = transforms(args.colmap_path, args.images, args.aabb_scale)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out} with {len(out['frames'])} frames")
    return out


if __name__ == "__main__":
    main()
