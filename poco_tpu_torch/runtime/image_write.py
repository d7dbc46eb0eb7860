"""PNG writer on the standard library (`zlib`, `struct`): the demo's one
output format. The card's host has no image codec for writing (no OpenCV,
PIL, libpng or JPEG encoder), so where the JAX demo's `cv2.imwrite`
writes the input's format, the port writes PNG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


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
