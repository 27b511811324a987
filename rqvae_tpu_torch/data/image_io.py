"""Image files to HWC uint8 RGB arrays, and a PNG writer.

`read_image` stands in for PIL's Image.open(...).convert("RGB") in the
JAX package's dataset layer (rqvae_tpu/data/datasets.py:45-48). PNG is
decoded here with zlib and numpy: 8-bit samples (1, 2 and 4 bits too for
grey and palette), no interlace, colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey + alpha) and 6 (RGBA), all five row filters. The
result equals PIL's convert("RGB") bit for bit: grey is repeated into
the three channels, a palette is looked up (an index past its end reads
black), alpha and tRNS are dropped. Interlaced and 16-bit PNGs raise
ValueError. Any other format (ImageNet's JPEGs) goes through PIL,
imported inside the call; without PIL it raises ImportError naming the
file.

`write_png` writes an HWC uint8 array (grey, grey + alpha, RGB or RGBA)
as a PNG, each row filtered as libpng's heuristic picks or all rows with
one chosen filter, for seeded test folders.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG without IEND")


def _unfilter_rows(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines (each led by its filter byte) ->
    [H, stride] bytes. Rows above the first Average or Paeth row are undone
    a whole row at a time (Sub as a running sum mod 256, Up as a sum with
    the row above); from that row down, _wavefront does the rest."""
    kinds, data = rows[:, 0], rows[:, 1:]
    if kinds.size and int(kinds.max()) >= len(FILTERS):
        raise ValueError(f"{name}: unknown PNG row filter {int(kinds.max())}")
    height, stride = data.shape
    out = np.empty((height, stride), np.uint8)
    sequential = np.flatnonzero(kinds >= 3)
    first = int(sequential[0]) if sequential.size else height
    prev = np.zeros(stride, np.uint8)
    for r in range(first):
        if kinds[r] == 0:
            prev = data[r]
        elif kinds[r] == 1:
            prev = np.cumsum(data[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            prev = data[r] + prev
        out[r] = prev
    if first < height:
        out[first:] = _wavefront(kinds[first:], data[first:], prev, bpp)
    return out


_DIFF = 511  # b - c and a - c lie in [-255, 255]
_PREDICTORS = None


def _predictors() -> np.ndarray:
    """The five filters' predictors less c, as a flat table indexed by
    (filter, b - c, a - c): None -c is applied by the caller (0 here),
    Sub a - c, Up b - c, Average ((a + b) >> 1) - c = (u + v) >> 1, and
    Paeth's choice of a, b or c, which depends on u = b - c and v = a - c
    alone (pa = |u|, pb = |v|, pc = |u + v|)."""
    global _PREDICTORS
    if _PREDICTORS is None:
        d = np.arange(-255, 256, dtype=np.int32)
        u, v = np.broadcast_arrays(d[:, None], d[None, :])
        pa, pb, pc = np.abs(u), np.abs(v), np.abs(u + v)
        paeth = np.where((pa <= pb) & (pa <= pc), v, np.where(pb <= pc, u, 0))
        _PREDICTORS = np.stack([np.zeros_like(u), v, u, (u + v) >> 1, paeth]).reshape(-1)
    return _PREDICTORS


def _diagonal_view(buf: np.ndarray, height: int, width: int) -> np.ndarray:
    """The [height, width, bpp] image inside a diagonal-major buffer: pixel
    (j, x) of rows j = 1..height is buf[x + j + 1, j]."""
    se, sj, sc = buf.strides
    return np.lib.stride_tricks.as_strided(buf[2, 1], shape=(height, width, buf.shape[2]), strides=(se + sj, se, sc),
                                           writeable=True)


def _wavefront(kinds: np.ndarray, data: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undoes rows of any filter below the decoded row `prev`. A pixel needs
    its left (a), upper (b) and upper-left (c) neighbours, so all pixels of
    one anti-diagonal are independent: the loop runs over the H + W - 1
    anti-diagonals, each a few numpy calls over its pixels. The buffer is
    diagonal-major (S[e, j] holds pixel (j, e - 1 - j), row 0 the row above,
    zeros off the image), so each diagonal is contiguous. The predictor is
    c + _predictors()[filter, b - c, a - c], c dropped on None rows."""
    height, stride = data.shape
    width = stride // bpp
    S = np.zeros((height + width + 1, height + 1, bpp), np.int32)
    R = np.zeros_like(S)
    S[1 : width + 1, 0] = prev.reshape(width, bpp)
    _diagonal_view(R, height, width)[...] = data.reshape(height, width, bpp)
    table = _predictors()
    offset = np.zeros((height + 1, 1), np.int32)  # each row's filter block, and the +255 of both differences
    offset[1:, 0] = kinds.astype(np.int32) * _DIFF * _DIFF + 255 * _DIFF + 255
    keep_c = None
    if (kinds == 0).any():
        keep_c = np.ones((height + 1, 1), np.int32)
        keep_c[1:, 0] = kinds != 0
    u_buf, v_buf, g_buf = (np.empty((height, bpp), np.int32) for _ in range(3))
    for e in range(2, height + width + 1):
        lo, hi = max(1, e - width), min(height, e - 1) + 1
        n = hi - lo
        a, b, c = S[e - 1, lo:hi], S[e - 1, lo - 1 : hi - 1], S[e - 2, lo - 1 : hi - 1]
        u = np.subtract(b, c, out=u_buf[:n])
        v = np.subtract(a, c, out=v_buf[:n])
        np.multiply(u, _DIFF, out=u)
        np.add(u, v, out=u)
        np.add(u, offset[lo:hi], out=u)
        g = table.take(u, out=g_buf[:n])
        np.add(g, c if keep_c is None else c * keep_c[lo:hi], out=g)
        np.add(g, R[e, lo:hi], out=g)
        np.bitwise_and(g, 255, out=S[e, lo:hi])
    return _diagonal_view(S, height, width).astype(np.uint8).reshape(height, stride)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB (module docstring)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if ctype not in CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is unknown")
    if depth != 8 and not (depth in (1, 2, 4) and ctype in (0, 3)):
        raise ValueError(f"{name}: {depth}-bit PNG of colour type {ctype} is not supported (8-bit, or 1/2/4-bit "
                         f"grey or palette)")
    bpp = CHANNELS[ctype]
    stride = (width * bpp * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{name}: PNG image data too short")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    pixels = _unfilter_rows(rows, max(bpp * depth // 8, 1), name)  # whole bytes, one a pixel below 8 bits
    if depth < 8:  # samples packed from the high bits down
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        pixels = ((pixels[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)[:, :width]
        if ctype == 0:  # grey scaled to 8 bits, as PIL's L;1 / L;2 / L;4 readers do
            pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    pixels = pixels.reshape(height, width, bpp)
    if ctype == 2:
        return pixels
    if ctype == 6:
        return np.ascontiguousarray(pixels[..., :3])
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette[:256]
        return table[pixels[..., 0]]
    return np.repeat(pixels[..., :1], 3, axis=2)  # grey (+ alpha)


def read_image(spec: Union[str, bytes]) -> np.ndarray:
    """A file path or the file's bytes -> [H, W, 3] uint8 RGB."""
    if isinstance(spec, bytes):
        data, name = spec, "<bytes>"
    else:
        with open(spec, "rb") as f:
            data = f.read()
        name = os.fspath(spec)
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, name)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{name}: not a PNG, and reading other image formats needs PIL, which is not "
                          f"installed") from e
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _filtered(pixels: np.ndarray, bpp: int) -> np.ndarray:
    """[H, W*bpp] uint8 scanlines -> [5, H, W*bpp]: their bytes under each filter."""
    x = pixels.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, row_filter: str = "adaptive") -> bytes:
    """An [H, W] or [H, W, C] uint8 array (C 1 grey, 2 grey + alpha, 3 RGB,
    4 RGBA) -> PNG bytes at zlib's default level. `row_filter` is one of
    FILTERS for every row, or "adaptive": each row the filter whose bytes,
    read as signed, have the least sum of magnitudes (libpng's heuristic,
    which PIL's writer also follows; photographic rows mostly get Paeth)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    height, width, c = image.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    every = _filtered(image.reshape(height, width * c), c)
    if row_filter == "adaptive":
        kinds = np.abs(every.view(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    else:
        kinds = np.full(height, FILTERS.index(row_filter))
    rows = every[kinds, np.arange(height)]
    raw = np.concatenate([kinds[:, None].astype(np.uint8), rows], axis=1).tobytes()

    def chunk(kind_: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind_ + body + struct.pack(">I", zlib.crc32(kind_ + body))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def write_png(path: str, image: np.ndarray, row_filter: str = "adaptive") -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, row_filter))
