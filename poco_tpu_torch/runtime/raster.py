"""ctypes binding and g++ build of the demo's mesh rasterizer
(`native/poco_raster.cpp`; the counterpart of `poco_tpu.runtime.raster`),
and of two of cv2's drawing calls: the wireframe (`cv2.polylines` of each
face, LINE_AA on the float overlay) and the keypoints (`cv2.circle`,
filled, LINE_AA), each as OpenCV's drawing.cpp draws it; `circles_filled`
the synthetic data sets' blobs (`cv2.circle`, filled, LINE_8); `put_glyphs`
draws the caption's glyphs as OpenCV 5's putText does (`viz/text.py`).

g++ builds the library at first use, never at import, into
`poco_tpu_torch/_build/libpoco_raster-<hash>.so`, named by a hash of the
source and the flags. A build or load that fails raises with g++'s
error: there is no painter's-loop fallback (the JAX package's fallback
is `cv2.fillPoly`, and the port has no OpenCV).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "poco_raster.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpoco_raster-{digest[:16]}.so"


def build() -> Path:
    """The rasterizer library, compiled now if this source has none yet."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the mesh rasterizer needs g++ to build; none on PATH") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the mesh rasterizer did not build:\n{proc.stderr.strip()}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.poco_label_triangles.restype = None
            lib.poco_label_triangles.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.poco_wireframe.restype = None
            lib.poco_wireframe.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.poco_circles_aa.restype = None
            lib.poco_circles_aa.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.poco_circles_filled.restype = None
            lib.poco_circles_filled.argtypes = lib.poco_circles_aa.argtypes
            lib.poco_put_glyphs.restype = None
            lib.poco_put_glyphs.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.poco_raster_mesh.restype = None
            lib.poco_raster_mesh.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def raster_mesh(
    overlay: np.ndarray,
    uv: np.ndarray,
    face_z: np.ndarray,
    faces: np.ndarray,
    face_rgb: np.ndarray,
    onscreen: np.ndarray,
) -> np.ndarray:
    """Rasterize flat-shaded triangles over a copy of `overlay` and return it.

    Args:
        overlay: (H, W, 3) RGB, pre-filled with the background.
        uv: (V, 2) pixel coords.
        face_z: (F,) mean depth (bigger = closer = wins).
        faces: (F, 3) vertex indices.
        face_rgb: (F, 3) shaded colours in 0..255.
        onscreen: (F,) bool cull mask.
    Returns:
        (H, W, 3) float32.
    """
    lib = _load()
    out = np.array(overlay, np.float32, order="C", copy=True)
    uv_c = np.ascontiguousarray(uv, np.float32)
    z_c = np.ascontiguousarray(face_z, np.float32)
    f_c = np.ascontiguousarray(faces, np.int64)
    c_c = np.ascontiguousarray(face_rgb, np.float32)
    m_c = np.ascontiguousarray(onscreen, np.uint8)
    h, w = out.shape[:2]
    lib.poco_raster_mesh(
        out.ctypes.data, h, w,
        uv_c.ctypes.data, z_c.ctypes.data, f_c.ctypes.data,
        c_c.ctypes.data, m_c.ctypes.data,
        len(uv_c), len(f_c),
    )
    return out


def label_triangles(labels: np.ndarray, pts: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Paint integer triangles over a copy of `labels` in the given order
    (the last face over a pixel wins) and return it.

    Args:
        labels: (H, W) uint8.
        pts: (F, 3, 2) integer pixel corners (x, y).
        values: (F,) uint8 label of each face.
    Returns:
        (H, W) uint8, each face filled as `cv2.fillPoly(img, [pts], value)`
        fills it (LINE_8, shift 0).
    """
    lib = _load()
    out = np.array(labels, np.uint8, order="C", copy=True)
    pts_c = np.ascontiguousarray(pts, np.int32)
    v_c = np.ascontiguousarray(values, np.uint8)
    h, w = out.shape
    lib.poco_label_triangles(out.ctypes.data, h, w, pts_c.ctypes.data, v_c.ctypes.data,
                             len(v_c))
    return out


def _rgb8(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def wireframe(overlay: np.ndarray, pts: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """Draw each face's outline over a copy of `overlay`, in the given
    order, and return it.

    Args:
        overlay: (H, W, 3) float32 RGB.
        pts: (F, 3, 2) integer pixel corners (x, y).
        colors: (F, 3) colour of each face.
    Returns:
        (H, W, 3) float32, each face drawn as `cv2.polylines(overlay,
        [pts], True, colour, 1, cv2.LINE_AA)` draws it on a float32 image
        (LineIterator's 8-connected pixels in the colour).
    """
    lib = _load()
    out = np.array(overlay, np.float32, order="C", copy=True)
    pts_c = np.ascontiguousarray(pts, np.int32)
    c_c = np.ascontiguousarray(colors, np.float32)
    h, w = out.shape[:2]
    lib.poco_wireframe(out.ctypes.data, h, w, pts_c.ctypes.data, c_c.ctypes.data, len(c_c))
    return out


def circles_aa(img: np.ndarray, centers: np.ndarray, radius: int, color) -> None:
    """`cv2.circle(img, c, radius, color, -1, cv2.LINE_AA)` for each
    integer centre, in order, in place on an (H, W, 3) uint8 image."""
    lib = _load()
    if not img.flags.c_contiguous:
        raise ValueError("circles_aa draws in place: the image must be C-contiguous")
    img = _rgb8(img)
    c_c = np.ascontiguousarray(centers, np.int32).reshape(-1, 2)
    rgb = np.ascontiguousarray(color, np.int32)
    lib.poco_circles_aa(img.ctypes.data, img.shape[0], img.shape[1], c_c.ctypes.data,
                        len(c_c), int(radius), rgb.ctypes.data)


def circles_filled(img: np.ndarray, centers: np.ndarray, radius: int, color) -> None:
    """`cv2.circle(img, c, radius, color, -1)` (LINE_8) for each integer
    centre, in order, in place on an (H, W, 3) uint8 image: OpenCV's
    midpoint walk of horizontal spans, clipped to the image. `color` is
    written to the channels in the order given."""
    lib = _load()
    if not img.flags.c_contiguous:
        raise ValueError("circles_filled draws in place: the image must be C-contiguous")
    img = _rgb8(img)
    if radius < 0:
        raise ValueError(f"circles_filled: radius {radius} < 0")
    c_c = np.ascontiguousarray(centers, np.int32).reshape(-1, 2)
    rgb = np.ascontiguousarray(color, np.int32)
    lib.poco_circles_filled(img.ctypes.data, img.shape[0], img.shape[1], c_c.ctypes.data,
                            len(c_c), int(radius), rgb.ctypes.data)


def put_glyphs(img: np.ndarray, glyphs: list[tuple], pen_x: list[int], baseline: int,
               scale: float, color) -> None:
    """Draw glyphs in place on an (H, W, 3) uint8 image, each blended by its
    coverage, in order: `glyphs[k]` is a tuple of TrueType contours ((x, y,
    on_curve) points in font units, y up) with its origin at (pen_x[k],
    baseline) and `scale` pixels a font unit."""
    lib = _load()
    if not img.flags.c_contiguous:
        raise ValueError("put_glyphs draws in place: the image must be C-contiguous")
    img = _rgb8(img)
    contours = [c for g in glyphs for c in g]
    if not contours:
        return
    pts = np.ascontiguousarray(np.concatenate([np.asarray(c, np.int32) for c in contours]))
    lengths = np.asarray([len(c) for c in contours], np.int32)
    per_glyph = np.asarray([len(g) for g in glyphs], np.int32)
    pens = np.ascontiguousarray(pen_x, np.int32)
    rgb = np.ascontiguousarray(color, np.int32)
    lib.poco_put_glyphs(img.ctypes.data, img.shape[0], img.shape[1], pts.ctypes.data,
                        lengths.ctypes.data, per_glyph.ctypes.data, pens.ctypes.data,
                        len(glyphs), int(baseline), float(scale), rgb.ctypes.data)
