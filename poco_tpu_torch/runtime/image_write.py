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
