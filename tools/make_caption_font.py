"""Recover what cv2.putText draws for FONT_HERSHEY_SIMPLEX, and write it as
data for the port (`poco_tpu_torch/viz/caption_font.py`), with cv2's own
caption at two frame heights for the card's check
(`tests/data/torch_caption_cv2.npz`).

    python tools/make_caption_font.py

The JAX package's caption (`overlay_text`) is `cv2.getTextSize`, a filled
rectangle and `cv2.putText(..., FONT_HERSHEY_SIMPLEX, ...)`. OpenCV 5 (the
cv2 this script was run with: opencv-python 5.0.0) no longer draws the
Hershey strokes: its binary holds no Hershey table, and putText draws the
TrueType font Rubik that it embeds (gzip member `Rubik.ttf`, a variable
font on one axis, wght 300-900), through its own `putText(img, text, org,
color, FontFace("sans"), size, weight)`. What this script recovers, each
piece checked against cv2 before anything is written:

  * the size: cv2.getTextSize's height is an integer pixel size, and it
    steps at fontScale = (size - 0.5) * k: found by bisection, k = 0.037,
    so size = round(fontScale / 0.037);
  * the weight: 400 for thickness <= 1, 600 beyond (legacy putText equals
    the FontFace call at that size and weight, pixel for pixel);
  * the outlines: Rubik.ttf, cut out of cv2's shared library, at wght 400
    and 600 normalised through fvar and avar (each step rounded to
    F2Dot14, as the OpenType spec has it); each point's coordinate is
    the default plus the scalar times each gvar delta, where a delta left
    to interpolation (IUP) is rounded to an integer first, and the sum is
    floored to an integer;
  * the advance of a glyph: floor of its right phantom point less floor
    of its left one (a glyph with no outline keeps its hmtx advance);
  * the scale: size / 935 pixels a font unit (935 = hhea ascender); the
    pen moves floor(advance * scale + 1/128) pixels a glyph, a string's
    width is 1 plus those steps (0 for an empty string), its height the
    size.

The port rasterises the outlines as stb_truetype's version-2 rasteriser
does (`runtime/native/poco_raster.cpp`, `poco_put_glyphs`: curves cut
with 0.35 px flatness, exact signed-area coverage in float, each glyph's
own bitmap blended at its integer pen position by
(dst * (255 - a) + colour * a + 127) / 255). The script ends by printing
how far `viz.text` is from cv2 on random strings, colours and sizes:
widths and heights (none) and the share of changed pixels that differ
(about 1e-4, each by one grey level). Needs cv2, fontTools and numpy.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import textwrap
import types
import zlib

import cv2
import numpy as np
from fontTools.misc.fixedTools import floatToFixedToFloat
from fontTools.ttLib import TTFont
from fontTools.varLib.iup import iup_delta
from fontTools.varLib.models import normalizeLocation, piecewiseLinearMap, supportScalar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT = cv2.FONT_HERSHEY_SIMPLEX
WEIGHTS = {1: 400, 2: 600}          # thickness -> wght
CHARS = range(32, 127)
REFERENCE_HEIGHTS = (540, 1080)     # cv2's captions kept for the card's check
CAPTION = "Other View"


def embedded_font() -> bytes:
    path = os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")
    data = open(path, "rb").read()
    start = data.index(b"\x1f\x8b\x08\x08", data.index(b"Rubik.ttf\x00") - 40)
    return zlib.decompressobj(16 + zlib.MAX_WBITS).decompress(data[start:])


def size_step() -> float:
    """fontScale per pixel of size: bisect each step of getTextSize's height."""
    steps = []
    for size in range(3, 40):
        lo, hi = 0.0, 4.0
        for _ in range(60):
            mid = (lo + hi) / 2
            lo, hi = (lo, mid) if cv2.getTextSize("A", FONT, mid, 1)[0][1] >= size else (mid, hi)
        steps.append(hi / (size - 0.5))
    step = round(float(np.median(steps)), 6)
    assert np.allclose(steps, step, rtol=1e-9, atol=0), steps
    return step


def location(font: TTFont, wght: int) -> float:
    axis = {a.axisTag: (a.minValue, a.defaultValue, a.maxValue) for a in font["fvar"].axes}
    norm = floatToFixedToFloat(normalizeLocation({"wght": wght}, axis)["wght"], 14)
    return floatToFixedToFloat(piecewiseLinearMap(norm, font["avar"].segments["wght"]), 14)


def glyph(font: TTFont, code: int, loc: float) -> tuple:
    """(advance in font units, contours of (x, y, on_curve)) at `loc`."""
    name = font.getBestCmap()[code]
    glyf = font["glyf"]
    if glyf[name].numberOfContours <= 0:
        return font["hmtx"].metrics[name][0], ()
    coords, controls = glyf._getCoordinatesAndControls(name, font["hmtx"].metrics, None)
    coords = [tuple(map(float, c)) for c in coords]
    pts = np.asarray(coords)
    for var in font["gvar"].variations.get(name, []):
        scalar = supportScalar({"wght": loc}, var.axes)
        if not scalar:
            continue
        deltas = var.coordinates
        if None in deltas:
            inferred = np.asarray([d is None for d in deltas])
            deltas = np.asarray(iup_delta(deltas, coords, controls.endPts), float)
            deltas[inferred] = np.floor(deltas[inferred] + 0.5)
        pts = pts + scalar * np.asarray(deltas, float)
    pts = np.floor(pts).astype(int)
    flags = glyf[name].getCoordinates(glyf)[2]
    contours, start = [], 0
    for end in controls.endPts:
        contours.append(tuple((int(pts[i, 0]), int(pts[i, 1]), int(flags[i] & 1))
                              for i in range(start, end + 1)))
        start = end + 1
    return int(pts[-3, 0] - pts[-4, 0]), tuple(contours)


def check(module: dict) -> None:
    """Hold `viz.text`, run on the data just made, to cv2."""
    sys.path.insert(0, REPO)
    data = types.ModuleType("poco_tpu_torch.viz.caption_font")
    data.__dict__.update(module)     # the recovered data, not the committed file
    sys.modules[data.__name__] = data
    from poco_tpu_torch.viz import text

    face = cv2.FontFace("sans")
    for thickness, wght in WEIGHTS.items():
        for scale in (0.2, 0.87, 2.5):
            size = text.pixel_size(scale)
            img = np.zeros((3 * size, 12 * size, 3), np.uint8)
            legacy = cv2.putText(img.copy(), "Ag0}", (5, 2 * size), FONT, scale, (255, 255, 255),
                                 thickness)
            ttf = cv2.putText(img.copy(), "Ag0}", (5, 2 * size), (255, 255, 255), face, size,
                              wght)[1]
            assert (legacy == ttf).all(), (thickness, scale)
    rng = np.random.RandomState(0)
    sizes_off = changed = off = worst = 0
    for _ in range(400):
        scale, thickness = float(rng.uniform(0.05, 4.0)), int(rng.randint(1, 6))
        caption = "".join(map(chr, rng.randint(32, 127, rng.randint(0, 14))))
        size = text.pixel_size(scale)
        sizes_off += cv2.getTextSize(caption, FONT, scale, thickness)[0] != \
            text.get_text_size(caption, scale, thickness)
        img = (rng.rand(3 * size + 4, 12 * size + 20, 3) * 255).astype(np.uint8)
        org, color = (int(rng.randint(-5, 10)), 2 * size), tuple(map(int, rng.randint(0, 256, 3)))
        ref = cv2.putText(img.copy(), caption, org, FONT, scale, color, thickness)
        got = text.put_text(img.copy(), caption, org, scale, color, thickness)
        diff = np.abs(got.astype(int) - ref).max(-1)
        changed += int((ref != img).any(-1).sum())
        off += int((diff > 0).sum())
        worst = max(worst, int(diff.max()))
    print(f"400 random strings: {sizes_off} text sizes differ from cv2.getTextSize; "
          f"{off} of the {changed} pixels cv2.putText changes differ (at most {worst} levels)")


def overlay_text(image: np.ndarray, txt_str: str) -> np.ndarray:
    """The JAX package's caption (`poco_tpu.viz.renderer.overlay_text`), as
    the same cv2 calls."""
    font_scale = image.shape[0] * 0.0016
    thickness = max(int(image.shape[0] * 0.005), 1)
    bbox_offset = int(image.shape[0] * 0.01)
    text_x, text_y = int(image.shape[1] * 0.02), int(image.shape[0] * 0.06)
    tw, th = cv2.getTextSize(txt_str, FONT, fontScale=font_scale, thickness=thickness)[0]
    cv2.rectangle(image, (text_x, text_y + bbox_offset),
                  (text_x + tw + bbox_offset, text_y - th - bbox_offset), (255, 255, 255),
                  cv2.FILLED)
    return cv2.putText(image, txt_str, (text_x, text_y), FONT, font_scale, (255, 0, 0), thickness)


def reference_captions() -> dict:
    """cv2's caption box at REFERENCE_HEIGHTS (16:9 frames), cropped, and
    the box (x0, y0, x1, y1)."""
    out = {}
    for h in REFERENCE_HEIGHTS:
        blank = np.zeros((h, h * 16 // 9, 3), np.uint8)
        drawn = overlay_text(blank.copy(), CAPTION)
        ys, xs = np.nonzero((drawn != blank).any(-1))
        out[f"box_{h}"] = np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.int32)
        out[f"caption_{h}"] = drawn[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "poco_tpu_torch", "viz",
                                                  "caption_font.py"))
    ap.add_argument("--reference", default=os.path.join(REPO, "tests", "data",
                                                        "torch_caption_cv2.npz"))
    args = ap.parse_args()
    font = TTFont(io.BytesIO(embedded_font()))
    ascender = font["hhea"].ascent
    glyphs = {wght: {code: glyph(font, code, location(font, wght)) for code in CHARS}
              for wght in WEIGHTS.values()}
    names = font["name"]
    notice = [str(names.getDebugName(i) or "") for i in (0, 13)]
    lines = [
        '"""The font cv2.putText draws for FONT_HERSHEY_SIMPLEX (OpenCV 5: Rubik),',
        "as data, recovered from cv2 by tools/make_caption_font.py (which states",
        "the method; do not edit).",
        "",
        "The glyph outlines are the Rubik font's, instanced at two weights; its",
        "notice, as the font states it:",
        "",
        *("    " + line for part in notice for line in textwrap.wrap(part, 72)),
        "",
        "GLYPHS[wght][code] = (advance in font units, contours): each contour a",
        "tuple of TrueType points (x, y, on_curve) in font units, y up.",
        '"""',
        "",
        f"SCALE_PER_SIZE = {size_step()!r}   # fontScale per pixel of text size",
        f"ASCENDER = {ascender!r}   # scale = size / ASCENDER pixels a font unit",
        f"WEIGHTS = {WEIGHTS!r}   # thickness (1, or 2 and more) -> wght",
        "",
        "GLYPHS = {",
    ]
    for wght, table in glyphs.items():
        lines.append(f"    {wght}: {{")
        for code, (adv, cs) in table.items():
            lines.append(f"        {code}: ({adv!r}, {cs!r}),")
        lines.append("    },")
    lines.append("}")
    source = "\n".join(lines) + "\n"
    module: dict = {}
    exec(source, module)
    check(module)
    with open(args.out, "w") as f:
        f.write(source)
    print(f"wrote {args.out} ({len(source)} bytes)")
    np.savez_compressed(args.reference, **reference_captions())
    print(f"wrote {args.reference}")


if __name__ == "__main__":
    main()
