"""The port's PNG reader against hostile input: request images come from
outside the server, so a decompression bomb and a malformed header must be
a ValueError (the server's 400) before anything large is allocated."""

import base64
import struct
import zlib

import numpy as np
import pytest

from visionselector_tpu_torch.api import serve as tserve
from visionselector_tpu_torch.preprocess import png


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _png(width: int, height: int, raw: bytes, ihdr: bytes = None) -> bytes:
    if ihdr is None:
        ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def _refused(data: bytes, match: str):
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)
    with pytest.raises(ValueError, match=match):
        tserve.decode_image(base64.b64encode(data).decode())


def test_png_bomb_header_refused_before_inflating(monkeypatch):
    """A header past Pillow's MAX_IMAGE_PIXELS is refused before any
    inflation; one at the limit's edge passes the check."""
    side = int(np.sqrt(png.MAX_PIXELS)) + 1
    bomb = _png(side, side, b"\0" * 64)

    def no_inflate():
        raise AssertionError("inflated a refused image")

    monkeypatch.setattr(png.zlib, "decompressobj", no_inflate)
    _refused(bomb, "exceeds the limit")
    monkeypatch.undo()
    # within the limit the size check passes; the short data is then refused
    _refused(_png(side - 1, side - 1, b"\0" * 64), "bytes of image data")


@pytest.mark.parametrize("extra", [1, 1 << 26])
def test_png_data_past_its_size_is_refused(extra):
    """An IDAT that inflates past the declared rows (by one byte, or by
    64 MiB of zeros in a ~65 KB body) is refused without inflating all of
    it; the exact size decodes."""
    w, h = 4, 3
    rows = b"".join(b"\0" + bytes(range(r, r + w * 3)) for r in range(h))
    got = png.decode_png(_png(w, h, rows))
    want = np.arange(w * 3)[None] + np.arange(h)[:, None]
    assert np.array_equal(got.reshape(h, -1), want.astype(np.uint8))
    bomb = _png(w, h, rows + b"\0" * extra)
    assert len(bomb) < 70_000
    _refused(bomb, "more than")


@pytest.mark.parametrize("n", [0, 12, 14])
def test_png_ihdr_of_the_wrong_length_is_a_value_error(n):
    """An IHDR that is not 13 bytes is a ValueError (a 400), not the
    struct.error of unpacking it."""
    _refused(_png(1, 1, b"\0\0\0\0", ihdr=b"\x01" * n), "IHDR")
