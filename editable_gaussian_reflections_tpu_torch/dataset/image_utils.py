"""8/16-bit PIL <-> float conversion - twin of reference dataset/image_utils.py
(the port's copy of the JAX package's; PIL is imported where it is used)."""

from __future__ import annotations

import numpy as np


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
