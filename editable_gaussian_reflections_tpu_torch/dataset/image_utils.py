"""8/16-bit PNG <-> float conversion - twin of reference dataset/image_utils.py
(the port's copy of the JAX package's; PIL is imported only by
to_pil_image).  from_png reads through utils/image.read_png, so loading a
dataset needs no imaging package."""

from __future__ import annotations

import numpy as np

from ..utils.image import read_png


def to_pil_image(arr: np.ndarray):
    from PIL import Image
    _, _, c = arr.shape
    if c == 3:
        return Image.fromarray((arr * (2**8 - 1)).round().astype(np.uint8))
    if c == 1:
        return Image.fromarray((arr[:, :, 0] * (2**16 - 1)).round().astype(np.uint16))
    raise ValueError("Number of channels not supported")


def from_pil_image(img) -> np.ndarray:
    arr = np.array(img, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr / (2**8 - 1)
    elif arr.ndim == 2:
        arr = arr / (2**16 - 1)
        arr = arr[:, :, None]
    return arr


def pil_samples(samples: np.ndarray) -> np.ndarray:
    """read_png's samples as np.asarray(PIL.Image.open(path)) holds them:
    PIL keeps the high byte of 16-bit colour types and opens 16-bit
    gray+alpha as RGBA (gray, gray, gray, alpha)."""
    if samples.dtype != np.uint16 or samples.ndim == 2:
        return samples
    hi = (samples >> 8).astype(np.uint8)
    if hi.shape[-1] == 2:
        hi = hi[..., [0, 0, 0, 1]]
    return hi


def from_png(path) -> np.ndarray:
    """from_pil_image(Image.open(path)), read without PIL."""
    return from_pil_image(pil_samples(read_png(path)))
