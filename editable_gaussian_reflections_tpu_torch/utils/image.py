"""Image metrics and IO helpers (twin of the JAX package's utils/image.py,
itself the twin of reference utils/image_utils.py).

PNGs are read and written with the standard library (zlib, struct), so
nothing here needs an imaging package: `write_png` writes 8- or 16-bit
gray, gray+alpha, RGB or RGBA with one row filter for the whole image (None
unless asked); `read_png` decodes those colour types at both depths under
all five row filters, as PIL's writer leaves them.  The training CLI's
previews decode to the pixels the JAX package's PIL-written files decode to.

Float32 TIFFs (the G-buffers tools/make_room_dataset.py writes) are written
and read with numpy and struct: `write_tiff` writes the uncompressed
little-endian single-strip layout imageio writes; `read_tiff` also reads
several strips, big-endian files and four samples a pixel, and raises for
anything else (compression, tiles, other sample formats) rather than
return wrong pixels.
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


# TIFF tags (TIFF 6.0): the ones write_tiff writes and read_tiff reads
_TIFF_WIDTH, _TIFF_LENGTH, _TIFF_BITS, _TIFF_COMPRESSION = 256, 257, 258, 259
_TIFF_PHOTOMETRIC, _TIFF_STRIP_OFFSETS, _TIFF_SAMPLES = 262, 273, 277
_TIFF_ROWS_PER_STRIP, _TIFF_STRIP_BYTES, _TIFF_PLANAR = 278, 279, 284
_TIFF_PREDICTOR, _TIFF_SAMPLE_FORMAT = 317, 339
_TIFF_TILE_TAGS = {322: "TileWidth", 323: "TileLength", 324: "TileOffsets",
                   325: "TileByteCounts"}
# field type -> (struct code, bytes): SHORT, LONG (the types of every tag
# read here; a tag of another type reads as absent)
_TIFF_TYPES = {3: ("H", 2), 4: ("I", 4)}


def write_tiff(path, array: np.ndarray) -> None:
    """A float32 [H, W] or [H, W, 3] image as an uncompressed little-endian
    TIFF: chunky planes, SampleFormat 3 (IEEE float) at 32 bits, one strip
    of all H rows - the layout imageio writes for such an array."""
    img = np.asarray(array)
    if img.dtype != np.float32 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_tiff: a float32 [H, W] or [H, W, 3] array,"
                         f" not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    data = np.ascontiguousarray(img, "<f4").tobytes()
    # (tag, type, values); SHORT arrays of 3 do not fit the entry's 4
    # bytes and go after the IFD
    entries = [(_TIFF_WIDTH, 4, [w]), (_TIFF_LENGTH, 4, [h]),
               (_TIFF_BITS, 3, [32] * spp), (_TIFF_COMPRESSION, 3, [1]),
               (_TIFF_PHOTOMETRIC, 3, [1 if spp == 1 else 2]),
               (_TIFF_STRIP_OFFSETS, 4, [0]), (_TIFF_SAMPLES, 3, [spp]),
               (_TIFF_ROWS_PER_STRIP, 4, [h]),
               (_TIFF_STRIP_BYTES, 4, [len(data)]),
               (_TIFF_PLANAR, 3, [1]), (_TIFF_SAMPLE_FORMAT, 3, [3] * spp)]
    ifd_end = 8 + 2 + 12 * len(entries) + 4
    extra = b""
    packed = []
    for tag, typ, vals in entries:
        raw = struct.pack("<" + _TIFF_TYPES[typ][0] * len(vals), *vals)
        if len(raw) <= 4:
            packed.append((tag, typ, len(vals), raw.ljust(4, b"\0")))
        else:
            packed.append((tag, typ, len(vals),
                           struct.pack("<I", ifd_end + len(extra))))
            extra += raw
    data_at = ifd_end + len(extra)
    data_at += data_at % 2                      # word-aligned strip
    out = [b"II*\0", struct.pack("<IH", 8, len(packed))]
    for tag, typ, count, raw in packed:
        if tag == _TIFF_STRIP_OFFSETS:
            raw = struct.pack("<I", data_at)
        out.append(struct.pack("<HHI", tag, typ, count) + raw)
    out.append(struct.pack("<I", 0))            # no next IFD
    out.append(extra.ljust(data_at - ifd_end, b"\0"))
    out.append(data)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _tiff_tags(data: bytes, bo: str, path) -> dict:
    """tag -> tuple of values of the first IFD's SHORT and LONG fields
    (None for fields of other types)."""
    (ifd,) = struct.unpack(bo + "I", data[4:8])
    if ifd + 2 > len(data):
        raise ValueError(f"{path}: IFD offset {ifd} past the end of the "
                         "file")
    (n,) = struct.unpack(bo + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
        if typ not in _TIFF_TYPES:
            tags[tag] = None
            continue
        code, size = _TIFF_TYPES[typ]
        nbytes = size * count
        if nbytes <= 4:
            raw = data[e + 8:e + 8 + nbytes]
        else:
            (at,) = struct.unpack(bo + "I", data[e + 8:e + 12])
            raw = data[at:at + nbytes]
            if len(raw) != nbytes:
                raise ValueError(f"{path}: tag {tag} runs past the end of "
                                 "the file")
        tags[tag] = struct.unpack(bo + code * count, raw)
    return tags


def read_tiff(path) -> np.ndarray:
    """An uncompressed float32 TIFF's pixels as native float32: [H, W] for
    one sample a pixel, [H, W, 3] or [H, W, 4] for three or four.

    Reads little- (II) and big-endian (MM) files, chunky planes, any number
    of strips; only the first image of the file.  Anything else raises a
    ValueError naming the tag and value: Compression other than 1,
    Predictor other than 1, tiles (TileWidth ...), SampleFormat other than
    3, BitsPerSample other than 32, SamplesPerPixel other than 1, 3 or 4,
    PlanarConfiguration 2, and strips shorter than their rows."""
    with open(path, "rb") as f:
        data = f.read()
    order = data[:2]
    if order not in (b"II", b"MM"):
        raise ValueError(f"{path}: not a TIFF file (byte order {order!r})")
    bo = "<" if order == b"II" else ">"
    (magic,) = struct.unpack(bo + "H", data[2:4])
    if magic != 42:
        raise ValueError(f"{path}: TIFF version {magic} is not supported "
                         "(42; 43 is BigTIFF)")
    tags = _tiff_tags(data, bo, path)

    def one(tag, name, default=None):
        vals = tags.get(tag)
        if vals is None:
            if default is None:
                raise ValueError(f"{path}: no {name} tag ({tag})")
            return default
        return vals[0]

    for tag, name in _TIFF_TILE_TAGS.items():
        if tag in tags:
            raise ValueError(f"{path}: {name} ({tag}) is present: tiled "
                             "TIFFs are not supported")
    w = one(_TIFF_WIDTH, "ImageWidth")
    h = one(_TIFF_LENGTH, "ImageLength")
    spp = one(_TIFF_SAMPLES, "SamplesPerPixel", 1)
    checks = (("Compression", _TIFF_COMPRESSION, (1,), "1 (none)"),
              ("Predictor", _TIFF_PREDICTOR, (1,), "1 (none)"),
              ("PlanarConfiguration", _TIFF_PLANAR, (1,), "1 (chunky)"),
              ("SamplesPerPixel", _TIFF_SAMPLES, (1, 3, 4), "1, 3 or 4"))
    for name, tag, ok, want in checks:
        value = one(tag, name, 1)
        if value not in ok:
            raise ValueError(f"{path}: {name} ({tag}) = {value} is not "
                             f"supported ({want})")
    for name, tag, want, default in (
            ("SampleFormat", _TIFF_SAMPLE_FORMAT, 3, (1,)),
            ("BitsPerSample", _TIFF_BITS, 32, (1,))):
        vals = tags.get(tag) or default
        if len(vals) not in (1, spp) or any(v != want for v in vals):
            raise ValueError(f"{path}: {name} ({tag}) = {list(vals)} is not "
                             f"supported ({want} for every sample)")
    offsets = tags.get(_TIFF_STRIP_OFFSETS)
    counts = tags.get(_TIFF_STRIP_BYTES)
    if not offsets or not counts or len(offsets) != len(counts):
        raise ValueError(f"{path}: StripOffsets ({_TIFF_STRIP_OFFSETS}) and "
                         f"StripByteCounts ({_TIFF_STRIP_BYTES}) must be "
                         "present and of one length")
    rows = min(one(_TIFF_ROWS_PER_STRIP, "RowsPerStrip", 2**32 - 1), h)
    row_bytes = w * spp * 4
    if len(offsets) != -(-h // rows):
        raise ValueError(f"{path}: {len(offsets)} strips of RowsPerStrip "
                         f"({_TIFF_ROWS_PER_STRIP}) = {rows} for {h} rows")
    parts = []
    for i, (at, nbytes) in enumerate(zip(offsets, counts)):
        need = min(rows, h - i * rows) * row_bytes
        chunk = data[at:at + need]
        if nbytes < need or len(chunk) != need:
            raise ValueError(f"{path}: strip {i} holds {min(nbytes, len(chunk))}"
                             f" bytes of its {need} (StripByteCounts "
                             f"({_TIFF_STRIP_BYTES}) = {nbytes})")
        parts.append(chunk)
    img = np.frombuffer(b"".join(parts), bo + "f4").astype(np.float32)
    img = img.reshape(h, w, spp)
    return img[..., 0] if spp == 1 else img


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
