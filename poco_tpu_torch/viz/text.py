"""`cv2.getTextSize` and `cv2.putText` for FONT_HERSHEY_SIMPLEX, without
OpenCV (the demo's caption, `viz.renderer.overlay_text`).

OpenCV 5 draws FONT_HERSHEY_SIMPLEX as the TrueType font Rubik that it
embeds, at an integer pixel size, round(fontScale / 0.037), and at wght
400 up to thickness 1, 600 beyond. Its outlines and advances at those two
weights are data here (`caption_font.py`, recovered from cv2 by
tools/make_caption_font.py, which states how). A glyph's outline is
scaled by size / 935 pixels a font unit; the pen moves floor(advance *
scale + 1/128) whole pixels a glyph; a string's width is 1 plus those
steps and its height the size. Each glyph is rasterised on its own at its
pen position (`runtime.raster.put_glyphs`, stb_truetype's coverage
rasteriser, native) and blended over the image by its coverage.
Characters outside printable ASCII draw as '?'.
"""

from __future__ import annotations

import numpy as np

from .caption_font import ASCENDER, GLYPHS, SCALE_PER_SIZE


def pixel_size(font_scale: float) -> int:
    """The text's size in pixels, as cv2 maps a Hershey fontScale."""
    return int(round(font_scale / SCALE_PER_SIZE))


def _weight(thickness: int) -> int:
    return 400 if thickness <= 1 else 600


def _glyph(ch: str, wght: int) -> tuple:
    code = ord(ch)
    return GLYPHS[wght][code if 32 <= code < 127 else ord("?")]


def _layout(text: str, size: int, wght: int) -> tuple[list[tuple], list[int]]:
    """The glyphs of `text` and each one's pen offset in pixels; the last
    offset is the pen after the text."""
    scale = size / ASCENDER
    glyphs, pens, x = [], [], 0
    for ch in text:
        glyphs.append(_glyph(ch, wght))
        pens.append(x)
        x += int(np.floor(glyphs[-1][0] * scale + 1 / 128))
    return glyphs, pens + [x]


def get_text_size(text: str, font_scale: float, thickness: int) -> tuple[int, int]:
    """(width, height) as `cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX,
    font_scale, thickness)[0]` gives them."""
    size = pixel_size(font_scale)
    if not text:
        return 0, 0
    return 1 + _layout(text, size, _weight(thickness))[1][-1], size


def put_text(img: np.ndarray, text: str, org: tuple[int, int], font_scale: float,
             color, thickness: int = 1) -> np.ndarray:
    """`cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, font_scale, color,
    thickness)` in place on an (H, W, 3) uint8 image; returns it."""
    from ..runtime.raster import put_glyphs

    size = pixel_size(font_scale)
    glyphs, pens = _layout(text, size, _weight(thickness))
    drawn = [(contours, int(org[0]) + pen) for (_, contours), pen in zip(glyphs, pens) if contours]
    if drawn:
        put_glyphs(img, [c for c, _ in drawn], [x for _, x in drawn], int(org[1]),
                   size / ASCENDER, color)
    return img
