"""Image output beyond PPM: PNG, written with the standard library.

The reference writes only ASCII P3 PPM (/root/reference/src/smallpt.cpp:
548-551, contract C1) — film.write_ppm reproduces that byte-for-byte; this
module adds PNG for convenience (the repo's committed
comparison_uni_imp.png shows the author also wanted PNG). PNG is encoded
with zlib + struct, so rendering needs no imaging package; reading a
non-PPM file uses Pillow when it is installed."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import film

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(image_u8: np.ndarray) -> bytes:
    """(h, w, 3) uint8 -> PNG bytes (8-bit RGB, filter type 0 per row)."""
    img = np.ascontiguousarray(np.asarray(image_u8, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) image, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1
    )
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _PNG_SIGNATURE
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by encode_png (8-bit RGB, unfiltered rows) ->
    (h, w, 3) uint8. Other PNG flavours go through read_image/Pillow."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, filt, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit RGB non-interlaced PNGs")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * 3
    )
    if np.any(rows[:, 0] != 0):
        raise ValueError("filtered PNG rows; read it with read_image")
    return rows[:, 1:].reshape(h, w, 3).copy()


def write_image(path: str, image_u8: np.ndarray, ext: str = "") -> None:
    """Write a (h, w, 3) uint8 image; format from ``ext`` or the path's
    extension (.ppm or .png)."""
    ext = (ext or path[path.rfind("."):]).lower()
    if ext == ".ppm":
        film.write_ppm(path, image_u8)
    elif ext == ".png":
        with open(path, "wb") as f:
            f.write(encode_png(image_u8))
    else:
        raise ValueError(f"unsupported image format {ext!r}; use .ppm or "
                         ".png")


def read_image(path: str) -> np.ndarray:
    """Read an image file into (h, w, 3) uint8. PPM needs nothing extra;
    other formats need Pillow."""
    if path.endswith(".ppm"):
        return film.read_ppm(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"reading {path!r} needs Pillow, which is not installed; "
            "convert the image to .ppm"
        ) from e
    return np.asarray(Image.open(path).convert("RGB"))
