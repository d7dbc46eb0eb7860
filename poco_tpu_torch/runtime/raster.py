"""ctypes binding and g++ build of the demo's mesh rasterizer
(`native/poco_raster.cpp`; the counterpart of `poco_tpu.runtime.raster`).

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
