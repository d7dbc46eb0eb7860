"""The port's image loader: ctypes bindings and the g++ build of
`native/poco_loader.cpp` (the counterpart of `poco_tpu.runtime.loader`).

    decode_image(path_or_bytes)                   -> (H, W, 3) uint8 RGB
    encode_jpeg(rgb, quality=95)                  -> JPEG bytes
    affine_crop(img, center, bbox_size, res)      -> (R, R, 3) float32
    affine_warp(img, affine, gain, res)           -> (R, R, 3) float32
    batch_decode_crop(paths, centers, sizes, res) -> (N, R, R, 3) float32
    batch_decode_affine(paths, affines, gains, res)
                                                  -> crops, dims (N, 2)

The batch functions decode and warp on a C++ thread pool; ctypes drops
the GIL for each call. EXIF orientation is applied as `cv2.imread`
applies it. There is no OpenCV behind it: a library that cannot be built
raises with g++'s error, and a file that does not decode raises with its
path and the reason.

The library is built with g++ at first use, never at import, into
`poco_tpu_torch/_build/`, named by a hash of the source and the flags.
The build picks one decoder by what links on the host and keeps it
(`route()`): "libjpeg" (`-ljpeg`, with `-lpng -DPOCO_HAS_PNG` when libpng
links too), else "nvjpeg" (nvJPEG from the CUDA toolkit under
$CUDA_HOME or /usr/local/cuda: JPEG decoded to YCbCr planes on the card,
copied back, RGB rebuilt and warped on the host). It prints
`loader route=...` to stderr when it loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "poco_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

MAX_H, MAX_W = 4096, 4096

_STATUS = {
    -1: "not a decodable image (corrupt or truncated data)",
    -2: f"larger than {MAX_H}x{MAX_W}",
    -3: "unreadable file (missing, empty or over 512 MiB)",
    -6: "16-bit PNG: the loader reads 8-bit PNG only (libpng's 16-to-8 "
        "conversion is not cv2's)",
    -7: "CUDA or nvJPEG failure on the card",
    -8: "the JPEG encoder failed",
}

_lib = None
_lib_lock = threading.Lock()


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def candidates() -> list[tuple[str, tuple[str, ...]]]:
    """The builds tried, in order: (route, link flags)."""
    cuda = _cuda_home()
    return [
        ("libjpeg", ("-ljpeg", "-lpng", "-DPOCO_HAS_PNG")),
        ("libjpeg", ("-ljpeg",)),
        ("nvjpeg", ("-DPOCO_NVJPEG", f"-I{cuda}/include", f"-L{cuda}/lib64",
                    f"-Wl,-rpath,{cuda}/lib64", "-lnvjpeg", "-lcudart")),
    ]


def library_path(route: str, flags: tuple[str, ...]) -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(BASE_FLAGS + flags).encode()
    ).hexdigest()
    return BUILD_DIR / f"libpoco_loader-{route}-{digest[:16]}.so"


def build() -> tuple[str, Path]:
    """The loader library (route, path): one already built from this
    source, else the first candidate that compiles and links. Raises with
    every attempt's g++ error when none does."""
    options = [(route, flags, library_path(route, flags)) for route, flags in candidates()]
    for route, _, path in options:
        if path.exists():
            return route, path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for route, flags, path in options:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *BASE_FLAGS, str(SOURCE), "-o", str(tmp), *flags, "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("the image loader needs g++ to build; none on PATH") from e
        if proc.returncode == 0:
            os.replace(tmp, path)
            return route, path
        errors.append(f"route {route} ({' '.join(flags)}):\n{proc.stderr.strip()}")
    raise RuntimeError(
        "the image loader could not be built: neither libjpeg (jpeglib.h, -ljpeg) nor "
        f"nvJPEG (nvjpeg.h, -lnvjpeg under {_cuda_home()}) compiles and links here.\n"
        + "\n".join(errors)
    )


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        route, path = build()
        lib = ctypes.CDLL(str(path))
        int_p = ctypes.POINTER(ctypes.c_int)
        lib.poco_route.restype = ctypes.c_int
        lib.poco_route.argtypes = []
        lib.poco_has_png.restype = ctypes.c_int
        lib.poco_has_png.argtypes = []
        lib.poco_image_dims.restype = ctypes.c_int
        lib.poco_image_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t, int_p, int_p]
        lib.poco_decode_image.restype = ctypes.c_int
        lib.poco_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, int_p, int_p,
        ]
        lib.poco_encode_jpeg.restype = ctypes.c_int
        lib.poco_encode_jpeg.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.poco_affine_crop.restype = None
        lib.poco_affine_crop.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.poco_affine_warp.restype = None
        lib.poco_affine_warp.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.poco_batch_decode_crop.restype = None
        lib.poco_batch_decode_crop.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.poco_batch_decode_affine.restype = None
        lib.poco_batch_decode_affine.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int,
        ]
        built = {1: "libjpeg", 2: "nvjpeg"}[lib.poco_route()]
        if built != route:
            raise RuntimeError(f"{path} reports route {built}, built as {route}")
        print(f"loader route={route} png={bool(lib.poco_has_png())} ({path.name})",
              file=sys.stderr)
        _lib = lib
        return _lib


def route() -> str:
    """The decoder the library was built with: "libjpeg" or "nvjpeg"."""
    return {1: "libjpeg", 2: "nvjpeg"}[_load().poco_route()]


def native_available() -> bool:
    """True when the library builds (or is built) on this host."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def png_available() -> bool:
    """True when the built library decodes PNG (libpng at build time)."""
    return bool(_load().poco_has_png())


def native_exts() -> tuple[str, ...]:
    """File extensions the loader decodes on this host."""
    return (".jpg", ".jpeg", ".png") if png_available() else (".jpg", ".jpeg")


def _failure(status: int, what: str) -> str:
    if status == -5:
        formats = "JPEG and 8-bit PNG" if png_available() else "JPEG only"
        reason = f"unsupported format: the {route()} loader decodes {formats}"
    else:
        reason = _STATUS.get(status, "decode failed")
    return f"{what}: {reason} (status {status})"


def decode_image(data: bytes | str | os.PathLike) -> np.ndarray:
    """Decode a JPEG or PNG (a path or its bytes) to (H, W, 3) RGB uint8,
    EXIF orientation applied. The container is sniffed from its magic
    bytes, not the extension. Raises ValueError naming the file and the
    reason when it does not decode."""
    lib = _load()
    what = "image bytes"
    if not isinstance(data, (bytes, bytearray)):
        what = os.fspath(data)
        with open(what, "rb") as f:
            data = f.read()
    data = bytes(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.poco_image_dims(data, len(data), ctypes.byref(h), ctypes.byref(w))
    if rc == 0 and (h.value > MAX_H or w.value > MAX_W):
        rc = -2
    if rc != 0:
        raise ValueError(_failure(rc, what))
    out = np.empty((h.value, w.value, 3), np.uint8)
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib.poco_decode_image(
        data, len(data), out.ctypes.data, h.value, w.value, ctypes.byref(oh), ctypes.byref(ow)
    )
    if rc == 0 and (oh.value, ow.value) != (h.value, w.value):
        raise ValueError(f"{what}: decoded {oh.value}x{ow.value}, header says "
                         f"{h.value}x{w.value}")
    if rc != 0:
        raise ValueError(_failure(rc, what))
    return out


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB uint8 -> JPEG bytes at `quality` with 4:2:0 chroma (the
    settings of `cv2.imwrite`'s default), on the library's route: libjpeg
    on the host, or nvJPEG on the card. Raises when the encoder fails."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not {image.shape} {image.dtype}")
    lib = _load()
    h, w = image.shape[:2]
    size = ctypes.c_size_t()
    cap = h * w * 3 + 65536
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.poco_encode_jpeg(image.ctypes.data, h, w, int(quality), out.ctypes.data,
                                  cap, ctypes.byref(size))
        if rc != -9:
            break
        cap = size.value
    if rc != 0:
        raise RuntimeError(_failure(rc, f"JPEG encode of a {w}x{h} image ({route()} route)"))
    return out[:size.value].tobytes()


def decode_jpeg(data: bytes | str | os.PathLike) -> np.ndarray:
    """`decode_image` under the JAX package's JPEG-only name."""
    return decode_image(data)


def _image_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {img.shape}")
    if img.dtype != np.uint8:
        cast = img.astype(np.uint8)
        if not np.array_equal(cast, img):
            raise ValueError("the warp reads 8-bit pixels: the image must hold whole "
                             "values in [0, 255]")
        img = cast
    return np.ascontiguousarray(img)


def affine_crop(img: np.ndarray, center, bbox_size: float, out_res: int = 224) -> np.ndarray:
    """(H, W, 3) -> (R, R, 3) float32 axis-aligned crop (cv2-parity
    bilinear, zero outside the image)."""
    lib = _load()
    img = _image_u8(img)
    out = np.empty((out_res, out_res, 3), np.float32)
    lib.poco_affine_crop(
        img.ctypes.data, img.shape[0], img.shape[1],
        float(center[0]), float(center[1]), float(bbox_size), out_res, out.ctypes.data,
    )
    return out


def affine_warp(img: np.ndarray, affine: np.ndarray, gain=(1.0, 1.0, 1.0),
                out_res: int = 224) -> np.ndarray:
    """One image through the batch warp: `affine` is the (2, 3)
    output->source matrix (`data.transforms.affine_output_to_source`),
    `gain` the per-channel multipliers, the result clamped to [0, 255]."""
    lib = _load()
    img = _image_u8(img)
    m = np.ascontiguousarray(np.asarray(affine, np.float32).reshape(6))
    g = np.ascontiguousarray(np.asarray(gain, np.float32).reshape(3))
    out = np.empty((out_res, out_res, 3), np.float32)
    lib.poco_affine_warp(img.ctypes.data, img.shape[0], img.shape[1], m.ctypes.data,
                         g.ctypes.data, out_res, out.ctypes.data)
    return out


def _raise_failed(paths, statuses) -> None:
    bad = [(p, int(s)) for p, s in zip(paths, statuses) if s != 0]
    if bad:
        raise ValueError("batch decode failed for "
                         + "; ".join(_failure(s, p) for p, s in bad))


def batch_decode_crop(paths: list[str], centers: np.ndarray, bbox_sizes: np.ndarray,
                      out_res: int = 224, num_threads: int = 0) -> np.ndarray:
    """Decode + axis-aligned crop of a batch of files on `num_threads`
    threads (0: one a core): (N, R, R, 3) float32. Raises ValueError with
    the path and reason of every file that fails."""
    lib = _load()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    centers = np.ascontiguousarray(centers, np.float32).reshape(n, 2)
    bbox_sizes = np.ascontiguousarray(bbox_sizes, np.float32).reshape(n)
    out = np.empty((n, out_res, out_res, 3), np.float32)
    statuses = np.zeros(n, np.int32)
    lib.poco_batch_decode_crop(
        c_paths, n, centers.ctypes.data, bbox_sizes.ctypes.data, out_res, MAX_H, MAX_W,
        out.ctypes.data, statuses.ctypes.data, num_threads,
    )
    _raise_failed(paths, statuses)
    return out


def batch_decode_affine(paths: list[str], affines: np.ndarray, gains: np.ndarray,
                        out_res: int = 224,
                        num_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Decode + general affine warp of a batch of files on `num_threads`
    threads (0: one a core).

    Args:
        affines: (N, 2, 3) output->source matrices (cv2 convention,
            `data.transforms.affine_output_to_source`; rotation, flip and
            scale are in the matrix).
        gains: (N, 3) per-channel multipliers (channel-noise
            augmentation); the result is clamped to [0, 255].
    Returns:
        crops (N, R, R, 3) float32 and dims (N, 2) int32, each image's
        decoded (h, w). Raises ValueError with the path and reason of
        every file that fails.
    """
    lib = _load()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    affines = np.ascontiguousarray(np.asarray(affines, np.float32).reshape(n, 6))
    gains = np.ascontiguousarray(np.asarray(gains, np.float32).reshape(n, 3))
    out = np.empty((n, out_res, out_res, 3), np.float32)
    statuses = np.zeros(n, np.int32)
    dims = np.zeros((n, 2), np.int32)
    lib.poco_batch_decode_affine(
        c_paths, n, affines.ctypes.data, gains.ctypes.data, out_res, MAX_H, MAX_W,
        out.ctypes.data, statuses.ctypes.data, dims.ctypes.data, num_threads,
    )
    _raise_failed(paths, statuses)
    return out, dims


def read_image_rgb(path: str) -> np.ndarray:
    """Read an image file as (H, W, 3) RGB uint8 (`decode_image`)."""
    return decode_image(path)


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of the decoded image, EXIF orientation applied,
    from the file's headers without decoding its pixels."""
    lib = _load()
    with open(path, "rb") as f:
        data = f.read()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.poco_image_dims(data, len(data), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(_failure(rc, path))
    return h.value, w.value


def read_images_rgb(paths: list[str], num_threads: int = 8) -> list[np.ndarray]:
    """Read many images in parallel (ctypes drops the GIL in the decode)."""
    if len(paths) <= 1 or num_threads <= 1:
        return [read_image_rgb(p) for p in paths]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(num_threads, len(paths))) as pool:
        return list(pool.map(read_image_rgb, paths))
