"""Image metrics and IO helpers (twin of the JAX package's utils/image.py,
itself the twin of reference utils/image_utils.py).

The PNGs are written with the standard library (zlib, struct: 8-bit RGB,
no filtering), so the training CLI's previews need no imaging package; they
decode to the pixels the JAX package's PIL-written files decode to.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def mse(img1, img2):
    return float(np.mean((np.asarray(img1) - np.asarray(img2)) ** 2))


def psnr(img1, img2):
    """Clamp-free PSNR over [0,1] images (image_utils.py)."""
    m = np.mean(
        (np.asarray(img1, np.float64) - np.asarray(img2, np.float64)) ** 2
    )
    if m == 0:
        return float("inf")
    return float(20.0 * np.log10(1.0 / np.sqrt(m)))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, rgb: np.ndarray):
    """An [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_image_grid(images, path, nrow=2):
    """Save a list/array of HWC [0,1] images as a tiled PNG grid."""
    imgs = [np.asarray(im) for im in images]
    imgs = [im[..., None].repeat(3, -1) if im.ndim == 2 else im for im in imgs]
    imgs = [im.repeat(3, -1) if im.shape[-1] == 1 else im[..., :3] for im in imgs]
    h, w, _ = imgs[0].shape
    ncol = nrow
    nr = (len(imgs) + ncol - 1) // ncol
    grid = np.zeros((nr * h, ncol * w, 3), np.float32)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncol)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, arr)


def save_image(image, path):
    save_image_grid([image], path, nrow=1)
