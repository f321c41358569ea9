"""PNG reading and writing with the standard library and numpy.

The serving endpoint decodes ``image_b64`` request images; Pillow is not
always installed where the port serves, and PNG is lossless, so an 8-bit
RGB or RGBA PNG decodes here to the same pixels Pillow gives
(``Image.open(...).convert("RGB")``: the alpha channel is dropped). Other
images (palette, grey, 16-bit, interlaced PNG, JPEG, ...) are left to
Pillow (``decode_png`` returns None for them).

Request images come from outside the program, so the reader keeps
Pillow's guard against decompression bombs: a header of more than
``MAX_PIXELS`` pixels is refused before anything is inflated, and the
image data is inflated only up to the size the header declares.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> bytes per pixel at 8 bits
# Pillow's Image.MAX_IMAGE_PIXELS default (1 GiB of 24-bit pixels / 4)
MAX_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """[H, W, 3] uint8 RGB of an 8-bit, non-interlaced RGB or RGBA PNG, or
    None when ``data`` is another image (not a PNG, or a PNG of another
    kind). Raises ValueError for a PNG that is cut short or corrupt, of
    more than MAX_PIXELS pixels, or whose data inflates past its size."""
    if not data.startswith(SIGNATURE):
        return None
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError("PNG: truncated chunk")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in a {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"PNG: a {length}-byte IHDR (13 expected)")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        return None
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG: {width} x {height} pixels exceeds the limit "
                         f"of {MAX_PIXELS} (a decompression bomb?)")
    bpp = _CHANNELS[colour]
    stride = width * bpp + 1
    need = height * stride
    inflate = zlib.decompressobj()
    try:
        # one byte past the declared size tells "too much" from "enough"
        raw = inflate.decompress(b"".join(idat), need + 1)
    except zlib.error as e:
        raise ValueError(f"PNG: bad image data ({e})") from None
    if len(raw) != need:
        raise ValueError(f"PNG: {'more than ' if len(raw) > need else ''}"
                         f"{len(raw)} bytes of image data for {height} rows "
                         f"of {stride}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    pixels = unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, bpp))
    return np.ascontiguousarray(pixels[..., :3])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(f, a, b, c):
    """The PNG predictor of filter type ``f`` from the left (a), up (b) and
    up-left (c) bytes (int32 arrays; f broadcasts over the last axis)."""
    return np.select(
        [f == 1, f == 2, f == 3, f == 4],
        [a, b, (a + b) // 2, _paeth(a, b, c)], 0)


def unfilter(filters: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of [H, W, bpp] filtered bytes. Without Average or Paeth rows, a row at
    a time (Sub is a running sum along the row). Otherwise a byte depends on
    its left, up and up-left neighbours, so the pixels go by anti-diagonals
    (r + i = const), each one a vector step over its pixels: H + W - 1
    steps."""
    h, w, bpp = filtered.shape
    top = int(filters.max()) if filters.size else 0
    if top > 4:
        raise ValueError(f"PNG: unknown filter type {top}")
    if top <= 2:
        out = np.empty_like(filtered)
        up = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            f = filters[r]
            row = filtered[r]
            if f == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)  # wraps mod 256
            elif f == 2:
                row = row + up  # uint8: wraps mod 256
            out[r] = up = row
        return out
    x = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row and column
    raw = filtered.astype(np.int32)
    f = filters.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        i = d - r
        pred = _predict(f[r, None], x[r + 1, i], x[r, i + 1], x[r, i])
        x[r + 1, i + 1] = (raw[r, i] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def encode_png(pixels: np.ndarray,
               filters: Optional[Sequence[int]] = None) -> bytes:
    """A PNG of [H, W, 3] (RGB) or [H, W, 4] (RGBA) uint8 pixels; row r
    takes filter type ``filters[r % len(filters)]`` (default: all 0)."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, bpp = pixels.shape
    if bpp not in (3, 4):
        raise ValueError(f"encode_png: {bpp} channels (3 or 4)")
    x = np.zeros((h + 1, w + 1, bpp), np.int32)
    x[1:, 1:] = pixels
    a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    types = np.asarray([filters[r % len(filters)] for r in range(h)]
                       if filters else np.zeros(h), np.int32)
    body = (x[1:, 1:] - _predict(types[:, None, None], a, b, c)) & 0xFF
    raw = np.concatenate([types[:, None].astype(np.uint8),
                          body.astype(np.uint8).reshape(h, w * bpp)], 1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if bpp == 3 else 6, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))
