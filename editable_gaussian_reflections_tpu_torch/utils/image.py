"""Image metrics and IO helpers (twin of the JAX package's utils/image.py,
itself the twin of reference utils/image_utils.py).

PNGs are read and written with the standard library (zlib, struct), so
nothing here needs an imaging package: `write_png` writes 8- or 16-bit
gray, gray+alpha, RGB or RGBA with one row filter for the whole image (None
unless asked); `read_png` decodes those colour types at both depths under
all five row filters, as PIL's writer leaves them.  The training CLI's
previews decode to the pixels the JAX package's PIL-written files decode to.
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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: gray, RGB, gray+alpha, RGBA (3, the
# palette, is refused)
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
PNG_FILTERS = ("none", "sub", "up", "average", "paeth")


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor of each byte from its left (a), upper (b) and
    upper-left (c) neighbours, on integer arrays."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """[H, stride] bytes of the image filtered with row filter `kind` on
    every row (the neighbours of the first row and the first pixel are 0)."""
    x = raw.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    pred = (0, left, up, (left + up) // 2, _paeth(left, up, upleft))[kind]
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path, image: np.ndarray, filter_type: str = "none"):
    """A uint8 or uint16 image as a PNG of that bit depth: [H, W] or
    [H, W, 1] gray, [H, W, 2] gray+alpha, [H, W, 3] RGB, [H, W, 4] RGBA.
    Every row takes `filter_type` (one of PNG_FILTERS)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {v: k for k, v in PNG_CHANNELS.items()}[ch]
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
        img = img.astype(">u2")      # PNG samples are big-endian
    else:
        raise ValueError(f"write_png: dtype {img.dtype} (uint8 or uint16)")
    bpp = ch * depth // 8
    raw = np.ascontiguousarray(img).view(np.uint8).reshape(h, w * bpp)
    kind = PNG_FILTERS.index(filter_type)
    rows = np.concatenate([np.full((h, 1), kind, np.uint8),
                           _filter_rows(raw, bpp, kind)], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                ctype, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter_sequential(cur: bytearray, prev: bytes, bpp: int,
                         kind: int) -> None:
    """Average (3) or Paeth (4) undone in place, byte by byte: each byte's
    predictor takes the byte `bpp` to its left, already decoded.  The first
    pixel's left and upper-left neighbours are 0, so its predictor is the
    byte above (Paeth) or half of it (Average)."""
    n = len(cur)
    if kind == 3:
        for i in range(bpp):
            cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
        for i in range(bpp, n):
            cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF
        return
    for i in range(bpp):
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, n):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else
                            b if pb <= pc else c)) & 0xFF


def read_png(path) -> np.ndarray:
    """A PNG's samples at the file's own depth (uint8 or uint16): [H, W]
    for gray, [H, W, 2] gray+alpha, [H, W, 3] RGB, [H, W, 4] RGBA.

    Rows are undone one after another: None, Sub and Up as whole-row array
    operations, Average and Paeth byte by byte (each byte needs its decoded
    left neighbour).  Palette and interlaced files raise ValueError.  For
    8-bit files and 16-bit gray this is np.asarray(PIL.Image.open(path));
    PIL keeps only the high byte of 16-bit colour types."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs (colour type 3) are not "
                         "supported")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         "supported")
    if ctype not in PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth}"
                         " is not supported")
    ch = PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = cur
        elif kind == 1:
            # each byte lane of a pixel is a running sum mod 256
            out[y] = np.cumsum(cur.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(stride)
        elif kind == 2:
            out[y] = cur + prev
        elif kind in (3, 4):
            buf = bytearray(cur.tobytes())
            _unfilter_sequential(buf, prev.tobytes(), bpp, kind)
            out[y] = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        prev = out[y]
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = out.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


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
