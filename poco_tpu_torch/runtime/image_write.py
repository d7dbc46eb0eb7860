"""Image writers of the demo and the trainer: PNG on the standard library
(`zlib`, `struct`) and JPEG through the port's native library
(`runtime/loader.py:encode_jpeg`: libjpeg on a host that has it, nvJPEG's
encoder on the card's host). `write_image` picks the format from the
file's extension as `cv2.imwrite` does, so the demo writes the names and
formats the JAX demo writes. A JPEG that cannot be encoded raises; no
other format is written in its place.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .loader import encode_jpeg

JPEG_QUALITY = 95  # cv2.imwrite's default (IMWRITE_JPEG_QUALITY)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) RGB or (H, W) grey uint8 -> PNG bytes (8-bit, filter 0)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, not {image.dtype}")
    if image.ndim == 2:
        color_type, channels = 0, 1
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"encode_png takes (H, W, 3) or (H, W), not {image.shape}")
    h, w = image.shape[:2]
    rows = np.empty((h, 1 + w * channels), np.uint8)
    rows[:, 0] = 0  # filter type None on every scanline
    rows[:, 1:] = image.reshape(h, w * channels)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The inverse of `encode_png`: its 8-bit RGB or grey, not interlaced
    PNGs, filter 0 on every scanline, to (H, W, 3) or (H, W) uint8. For
    reading the port's own frames back where the loader decodes JPEG only
    (its nvJPEG route); any other PNG raises ValueError."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG (no PNG signature)")
    pos, header, idat = 8, None, []
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
    if header is None or not idat:
        raise ValueError("a PNG without IHDR or IDAT")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in (0, 2) or interlace:
        raise ValueError(f"decode_png reads 8-bit RGB or grey PNGs, not interlaced; this one "
                         f"has bit depth {depth}, colour type {color_type}, interlace {interlace}")
    channels = 3 if color_type == 2 else 1
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * channels):
        raise ValueError("a PNG whose image data does not fill its size")
    rows = rows.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("decode_png reads unfiltered scanlines (encode_png's) only")
    image = rows[:, 1:].reshape(h, w, channels)
    return image if channels == 3 else image[..., 0]


def write_png(path: str, image: np.ndarray) -> None:
    """Write `image` (RGB or grey uint8) to `path` as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def write_image(path: str, image: np.ndarray) -> None:
    """Write RGB uint8 `image` to `path` in the format its extension names:
    `.jpg` / `.jpeg` as JPEG (quality 95, 4:2:0), `.png` as PNG. Any other
    extension raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(np.asarray(image, np.uint8), JPEG_QUALITY)
        with open(path, "wb") as f:
            f.write(data)
    elif ext == ".png":
        write_png(path, image)
    else:
        raise ValueError(f"{path}: the port writes .jpg, .jpeg and .png images only")
