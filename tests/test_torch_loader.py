"""PyTorch port vs JAX package and OpenCV: the image loader
(`poco_tpu_torch/runtime/loader.py`) and the cv2-free transforms.

  * the port's loader against `poco_tpu.runtime.loader` on the same bytes:
    decode, `affine_crop`, `batch_decode_crop` and `batch_decode_affine`
    exact (both libraries build from the same C++ on the same system
    libjpeg here);
  * against `cv2.imread`: mean absolute difference under 2 grey levels
    (the bar of tests/test_native_loader.py:27-32; the IDCTs may differ);
    EXIF orientations 2-8 in cv2's layout, exactly (the port's own decode
    of the unrotated file, transposed and flipped as cv2 does) and within
    that bar of cv2's pixels; 8-bit PNG exact; a 16-bit PNG, a missing
    file, bytes that are no image and a truncated JPEG raise, naming the
    file and the cause, in the single and the batch calls; a library that
    cannot be built raises with g++'s error;
  * the fixtures of `chip_smoke.py` phase 4g regenerate equal: the smoke
    JPEGs' thumbnails (`tests/data/torch_smoke_thumbs.npz`) from
    `cv2.imread`, and the seeded 1920x1080 JPEG (`tests/data/
    torch_fullhd.jpg`) from `cv2.imencode`;
  * the transforms: `_affine_matrix` within 1e-9 of
    `cv2.getAffineTransform`, `rotate_axis_angle` within 1e-6 of cv2's
    Rodrigues (the JAX package's), `crop_image` and `process_image`
    against the JAX package's cv2 warp at its own bars
    (tests/test_native_loader.py:46-57 and :108-116: atol 1.0 and 1.5 in
    the interior);
  * the nvJPEG route's host half (RGB rebuilt from YCbCr planes) equal to
    libjpeg's own RGB for 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and grey, odd
    sizes included (a program built from the loader's source);
  * no source of the port or `chip_smoke.py` imports OpenCV.
"""

import ast
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from poco_tpu.data import transforms as jax_transforms
from poco_tpu.runtime import loader as jax_loader

import chip_smoke
from poco_tpu_torch.data import transforms
from poco_tpu_torch.runtime import loader

REPO = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"
SMOKE = sorted(str(p) for p in (REPO / "data" / "dataset_folders" / "smoke").glob("*.jpg"))
DECODE_MEAN_TOL = 2.0   # grey levels against cv2.imread (tests/test_native_loader.py:32)
CROP_TOL, PROCESS_TOL = 1.0, 1.5  # JAX's bars, crop and augmented crop vs its cv2 warp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module, as the other data test
    files pin it under the fast tier's six workers. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(shape, seed):
    rng = np.random.RandomState(seed)
    return cv2.GaussianBlur(rng.randint(0, 255, shape, dtype=np.uint8), (11, 11), 5)


@pytest.fixture(scope="module")
def jpeg_file(tmp_path_factory):
    """JAX's test image: a blurred random 120x160 RGB, quality 95."""
    path = str(tmp_path_factory.mktemp("jpg") / "test.jpg")
    cv2.imwrite(path, _smooth((120, 160, 3), 0)[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    return path


def _with_orientation(jpeg: bytes, orientation: int) -> bytes:
    """JPEG bytes with a minimal EXIF APP1 (Orientation tag) after SOI."""
    tiff = (b"II*\x00\x08\x00\x00\x00" + b"\x01\x00"
            + b"\x12\x01\x03\x00\x01\x00\x00\x00" + bytes([orientation, 0, 0, 0])
            + b"\x00\x00\x00\x00")
    payload = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    return jpeg[:2] + app1 + jpeg[2:]


def make_fullhd_jpeg() -> bytes:
    """The seeded 1920x1080 JPEG of `tests/data/torch_fullhd.jpg` (a
    3DPW frame's size): sinusoids of random phase per channel plus blurred
    noise, quality 90, about 400 KB."""
    rng = np.random.RandomState(0)
    h, w = 1080, 1920
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(6):
            fx, fy = rng.uniform(0.5, 12, 2) * 2 * np.pi / np.array([w, h])
            img[..., c] += rng.uniform(10, 30) * np.sin(fx * x + fy * y + rng.uniform(0, 2 * np.pi))
        img[..., c] += 128
    noise = cv2.GaussianBlur(rng.randn(h, w, 3) * 40, (0, 0), 1.5)
    img = np.clip(img + noise, 0, 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    return enc.tobytes()


def _cv2_rgb(path: str) -> np.ndarray:
    img = cv2.imread(path)
    assert img is not None, path
    return img[:, :, ::-1]


def _warps(n, seed, shape):
    rng = np.random.RandomState(seed)
    h, w = shape
    affines, gains = [], []
    for k in range(n):
        aug = transforms.sample_augment_params(rng)
        center = np.array([rng.uniform(0, w), rng.uniform(0, h)], np.float32)
        affines.append(transforms.affine_output_to_source(
            center, rng.uniform(20, 2 * max(h, w)) * aug.scale, 32, aug.rot, aug.flip))
        gains.append(aug.pixel_noise)
    return np.stack(affines), np.stack(gains)


# --------------------------------------------------------------------------
# the loader against the JAX package's
# --------------------------------------------------------------------------

def test_route_on_this_host_is_libjpeg_with_png():
    assert loader.route() == "libjpeg" and loader.png_available()
    assert loader.native_available()
    assert loader.native_exts() == (".jpg", ".jpeg", ".png")
    assert [route for route, _ in loader.candidates()] == ["libjpeg", "libjpeg", "nvjpeg"]


@pytest.mark.parametrize("which", ["test", "smoke_first", "smoke_last", "fullhd"])
def test_decode_matches_jax_loader_exactly(jpeg_file, which):
    path = {"test": jpeg_file, "smoke_first": SMOKE[0], "smoke_last": SMOKE[-1],
            "fullhd": str(DATA / "torch_fullhd.jpg")}[which]
    ref = jax_loader.decode_image(path)
    with open(path, "rb") as f:
        data = f.read()
    for got in (loader.decode_image(path), loader.decode_image(data), loader.read_image_rgb(path),
                loader.decode_jpeg(Path(path))):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    assert loader.image_size(path) == jax_loader.image_size(path) == ref.shape[:2]


@pytest.mark.parametrize("center,bbox,res", [((80.0, 60.0), 64.0, 32), ((0.0, 0.0), 80.0, 16),
                                             ((150.5, 10.25), 300.0, 224)])
def test_affine_crop_matches_jax_exactly(jpeg_file, center, bbox, res):
    img = loader.decode_image(jpeg_file)
    np.testing.assert_array_equal(loader.affine_crop(img, center, bbox, res),
                                  jax_loader.affine_crop(img, center, bbox, res))


def test_batch_decode_crop_matches_jax_exactly(jpeg_file):
    paths = [jpeg_file] + SMOKE[:5]
    rng = np.random.RandomState(2)
    centers = rng.uniform(0, 256, (6, 2)).astype(np.float32)
    sizes = rng.uniform(16, 400, 6).astype(np.float32)
    got = loader.batch_decode_crop(paths, centers, sizes, out_res=32, num_threads=3)
    ref, statuses = jax_loader.batch_decode_crop(paths, centers, sizes, out_res=32, num_threads=2)
    assert (statuses == 0).all()
    np.testing.assert_array_equal(got, ref)


def test_batch_decode_affine_matches_jax_exactly(jpeg_file):
    paths = [jpeg_file] * 3 + SMOKE[:9]
    affines, gains = _warps(len(paths), 3, (120, 160))
    got, dims = loader.batch_decode_affine(paths, affines, gains, 32, num_threads=4)
    ref, statuses, ref_dims = jax_loader.batch_decode_affine(paths, affines, gains, 32)
    assert (statuses == 0).all()
    np.testing.assert_array_equal(dims, ref_dims)
    np.testing.assert_array_equal(got, ref)
    # one image at a time through the same warp
    for k, path in enumerate(paths):
        np.testing.assert_array_equal(
            loader.affine_warp(loader.decode_image(path), affines[k], gains[k], 32), got[k])


def test_read_images_rgb_in_threads_equals_one_by_one():
    got = loader.read_images_rgb(SMOKE[:6], num_threads=3)
    for path, img in zip(SMOKE[:6], got):
        np.testing.assert_array_equal(img, loader.decode_image(path))


# --------------------------------------------------------------------------
# the loader against OpenCV
# --------------------------------------------------------------------------

def test_decode_matches_cv2(jpeg_file):
    for path in [jpeg_file] + SMOKE:
        got, ref = loader.decode_image(path), _cv2_rgb(path)
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).mean() < DECODE_MEAN_TOL, path


# cv2.imread's EXIF transforms (imgcodecs ExifTransform), as numpy
EXIF_LAYOUT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
    7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1],
}


@pytest.mark.parametrize("orientation", sorted(EXIF_LAYOUT))
def test_exif_orientation_as_cv2(tmp_path, orientation):
    """A 40x64 JPEG tagged with `orientation`: the port decodes it in
    cv2.imread's layout (its own decode of the untagged bytes, transposed
    and flipped as cv2 does: exact), within cv2's pixels at the decode bar,
    and the batch path and `image_size` see the same (h, w)."""
    ok, enc = cv2.imencode(".jpg", _smooth((40, 64, 3), orientation), [cv2.IMWRITE_JPEG_QUALITY, 95])
    plain = enc.tobytes()
    tagged = _with_orientation(plain, orientation)
    path = str(tmp_path / f"o{orientation}.jpg")
    Path(path).write_bytes(tagged)
    got = loader.decode_image(path)
    np.testing.assert_array_equal(got, EXIF_LAYOUT[orientation](loader.decode_image(plain)))
    ref = _cv2_rgb(path)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).mean() < DECODE_MEAN_TOL
    assert loader.image_size(path) == got.shape[:2]
    affines, gains = _warps(1, orientation, got.shape[:2])
    crops, dims = loader.batch_decode_affine([path], affines, gains, 32)
    assert tuple(dims[0]) == got.shape[:2]
    np.testing.assert_array_equal(crops[0], loader.affine_warp(got, affines[0], gains[0], 32))


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "palette"])
def test_png_8bit_exact(tmp_path, kind):
    rng = np.random.RandomState(len(kind))
    path = str(tmp_path / f"{kind}.png")
    if kind == "palette":
        # a colour-type-3 PNG written by hand: 4-entry palette, 8-bit indices
        import struct
        import zlib

        idx = rng.randint(0, 4, (13, 17)).astype(np.uint8)
        palette = bytes([255, 0, 0, 0, 255, 0, 0, 0, 255, 7, 99, 200])

        def chunk(tag, body):
            return (struct.pack(">I", len(body)) + tag + body
                    + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

        raw = b"".join(b"\x00" + row.tobytes() for row in idx)
        Path(path).write_bytes(
            b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 17, 13, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    else:
        channels = {"rgb": 3, "rgba": 4, "gray": 1}[kind]
        img = rng.randint(0, 256, (21, 33, channels) if channels > 1 else (21, 33), dtype=np.uint8)
        cv2.imwrite(path, img)
    ref = _cv2_rgb(path)
    np.testing.assert_array_equal(loader.decode_image(path), ref)
    np.testing.assert_array_equal(loader.decode_image(path), jax_loader.decode_image(path))


# The nvJPEG route's host half (`ycc_to_rgb`: libjpeg's fancy upsampling
# and colour tables over decoded planes) against libjpeg itself: a small
# program built from the loader's source takes libjpeg's planes
# (decoded without fancy upsampling, one sample a block) and its RGB.
PLANES_CHECK = r"""
#include "poco_loader.cpp"
int main(int argc, char** argv) {
  std::vector<uint8_t> bytes = read_file(argv[1]), rgb;
  int h = 0, w = 0;
  if (decode_jpeg_raw(bytes.data(), bytes.size(), rgb, 1 << 14, 1 << 14, &h, &w)) return 2;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes.data(), bytes.size());
  jpeg_read_header(&cinfo, TRUE);
  const int comps = cinfo.num_components;
  const int hf = comps == 3 ? cinfo.max_h_samp_factor / cinfo.comp_info[1].h_samp_factor : 1;
  const int vf = comps == 3 ? cinfo.max_v_samp_factor / cinfo.comp_info[1].v_samp_factor : 1;
  cinfo.out_color_space = comps == 3 ? JCS_YCbCr : JCS_GRAYSCALE;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);
  std::vector<uint8_t> ycc(size_t(h) * w * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = ycc.data() + size_t(cinfo.output_scanline) * w * comps;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  const int pw = (w + hf - 1) / hf, ph = (h + vf - 1) / vf;
  std::vector<uint8_t> y(size_t(h) * w), cb(size_t(pw) * ph), cr(size_t(pw) * ph), out;
  for (size_t i = 0; i < y.size(); ++i) y[i] = ycc[i * comps];
  for (int r = 0; r < ph && comps == 3; ++r)
    for (int c = 0; c < pw; ++c) {
      cb[size_t(r) * pw + c] = ycc[(size_t(r * vf) * w + c * hf) * 3 + 1];
      cr[size_t(r) * pw + c] = ycc[(size_t(r * vf) * w + c * hf) * 3 + 2];
    }
  ycc_to_rgb(y.data(), cb.data(), cr.data(), comps, w, h, pw, ph, hf, vf, out);
  int worst = 0;
  for (size_t i = 0; i < out.size(); ++i) worst = std::max(worst, std::abs(out[i] - rgb[i]));
  std::printf("%d %d %d\n", hf, vf, worst);
  return 0;
}
"""

SUBSAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1),
                "grey": (1, 1)}


@pytest.fixture(scope="module")
def planes_check(tmp_path_factory):
    root = tmp_path_factory.mktemp("planes")
    (root / "check.cpp").write_text(PLANES_CHECK)
    exe = root / "check"
    subprocess.run(["g++", "-O2", "-std=c++17", f"-I{loader.SOURCE.parent}", str(root / "check.cpp"),
                    "-o", str(exe), "-ljpeg"], check=True, capture_output=True)
    return root, exe


@pytest.mark.parametrize("sampling", sorted(SUBSAMPLINGS))
@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (5, 7), (3, 3)])
def test_nvjpeg_planes_rebuild_equals_libjpeg(planes_check, sampling, shape):
    root, exe = planes_check
    img = _smooth(shape + (3,), sum(shape))
    path = str(root / f"{sampling}_{shape[0]}x{shape[1]}.jpg")
    if sampling == "grey":
        cv2.imwrite(path, img[..., 0])
    else:
        flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    out = subprocess.run([str(exe), path], check=True, capture_output=True, text=True).stdout
    hf, vf, worst = map(int, out.split())
    assert (hf, vf) == SUBSAMPLINGS[sampling]
    assert worst == 0


# --------------------------------------------------------------------------
# failures raise, naming the file and the cause
# --------------------------------------------------------------------------

def test_16bit_png_raises(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, (np.random.RandomState(3).rand(9, 11) * 65535).astype(np.uint16))
    with pytest.raises(ValueError, match=r"deep\.png: 16-bit PNG.*status -6"):
        loader.decode_image(path)
    with pytest.raises(ValueError, match=r"deep\.png: 16-bit PNG"):
        loader.batch_decode_affine([path], np.zeros((1, 2, 3)), np.ones((1, 3)), 8)


def test_bad_path_and_bad_bytes_raise(tmp_path, jpeg_file):
    missing = str(tmp_path / "missing.jpg")
    with pytest.raises(FileNotFoundError):
        loader.decode_image(missing)
    with pytest.raises(ValueError, match=r"image bytes: unsupported format: the libjpeg loader"):
        loader.decode_image(b"not a jpeg")
    data = Path(jpeg_file).read_bytes()
    truncated = str(tmp_path / "truncated.jpg")
    Path(truncated).write_bytes(data[:200])
    with pytest.raises(ValueError, match=r"truncated\.jpg: not a decodable image"):
        loader.decode_image(truncated)
    text = str(tmp_path / "text.jpg")
    Path(text).write_text("not an image")
    affines, gains = np.zeros((4, 2, 3)), np.ones((4, 3))
    with pytest.raises(ValueError, match=r"missing\.jpg: unreadable file.*status -3.*"
                                         r"text\.jpg: unsupported format.*status -5"):
        loader.batch_decode_affine([jpeg_file, missing, jpeg_file, text], affines, gains, 8)
    with pytest.raises(ValueError, match=r"truncated\.jpg: not a decodable image.*status -1"):
        loader.batch_decode_crop([truncated], np.zeros((1, 2)), np.ones(1), 8)
    with pytest.raises(ValueError, match="whole values"):
        loader.affine_warp(np.full((4, 4, 3), 0.5, np.float32), np.zeros((2, 3)))


def test_build_failure_raises_with_the_compiler_error(monkeypatch, tmp_path):
    """No fallback: where no candidate links, `build` raises with each
    attempt's g++ error (here a library that does not exist)."""
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "candidates",
                        lambda: [("libjpeg", ("-lpoco_no_such_jpeg",)),
                                 ("nvjpeg", ("-DPOCO_NVJPEG", "-I/nonexistent"))])
    with pytest.raises(RuntimeError, match=r"(?s)could not be built.*cannot find "
                                           r"-lpoco_no_such_jpeg.*route nvjpeg.*fatal error"):
        loader.build()
    assert list(tmp_path.iterdir()) == []


# --------------------------------------------------------------------------
# chip_smoke's fixtures
# --------------------------------------------------------------------------

def test_thumbnail_fixture_regenerates_equal():
    """`tests/data/torch_smoke_thumbs.npz` is `chip_smoke.smoke_thumbnails`
    of `cv2.imread`, thumbnails rounded to uint8."""
    made = chip_smoke.smoke_thumbnails(_cv2_rgb)
    ref = np.load(chip_smoke.THUMBS_NPZ)
    assert sorted(ref.files) == ["means", "names", "thumbs"] and len(ref["names"]) == 48
    np.testing.assert_array_equal(ref["names"], made["names"])
    np.testing.assert_array_equal(ref["means"], made["means"])
    np.testing.assert_array_equal(ref["thumbs"], np.rint(made["thumbs"]).astype(np.uint8))
    # the port's own decode meets the bars phase 4g holds it to
    port = chip_smoke.smoke_thumbnails(loader.decode_image)
    assert np.abs(port["thumbs"] - ref["thumbs"]).max() <= chip_smoke.THUMB_TOL
    assert np.abs(port["means"] - ref["means"]).max() <= chip_smoke.MEAN_TOL


def test_fullhd_fixture_regenerates_equal():
    data = chip_smoke.FULLHD_JPEG.read_bytes()
    assert data == make_fullhd_jpeg()
    assert len(data) <= 500 * 1024
    assert loader.decode_image(data).shape == (1080, 1920, 3)


# --------------------------------------------------------------------------
# the transforms without cv2
# --------------------------------------------------------------------------

def test_affine_matrix_matches_cv2():
    rng = np.random.RandomState(4)
    for _ in range(50):
        center = rng.uniform(0, 1000, 2).astype(np.float32)
        bbox, rot = rng.uniform(10, 800), rng.uniform(-60, 60)
        for inv in (False, True):
            got = transforms._affine_matrix(center, bbox, 224, rot, inv)
            ref = jax_transforms._affine_matrix(center, bbox, 224, rot, inv)  # cv2's
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
            assert got.dtype == np.float64 and got.shape == (2, 3)


def test_rotate_axis_angle_matches_cv2():
    rng = np.random.RandomState(5)
    cases = [rng.randn(3) * s for s in (1e-7, 0.1, 1.0, 3.0) for _ in range(25)]
    cases += [np.array([np.pi, 0, 0]), np.array([0, np.pi - 1e-7, 0]), np.zeros(3),
              np.ones(3) / np.sqrt(3) * np.pi]
    for aa in cases:
        for rot in (rng.uniform(-60, 60), 180.0, -90.0):
            got = transforms.rotate_axis_angle(aa.astype(np.float32), rot)
            ref = jax_transforms.rotate_axis_angle(aa.astype(np.float32), rot)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rot", [0.0, 25.0])
def test_crop_image_matches_jax_cv2_warp(jpeg_file, rot):
    img = loader.decode_image(jpeg_file)
    center, scale = np.array([80.0, 60.0], np.float32), 0.4
    got = transforms.crop_image(img, center, scale, 32, rot)
    ref = jax_transforms.crop_image(img.astype(np.float32), center, scale, 32, rot)
    np.testing.assert_allclose(got[2:-2, 2:-2], ref[2:-2, 2:-2], atol=CROP_TOL)
    # float input with whole values is the same image
    np.testing.assert_array_equal(
        transforms.crop_image(img.astype(np.float32), center, scale, 32, rot), got)


def test_process_image_matches_jax_cv2_warp(jpeg_file):
    img = loader.decode_image(jpeg_file)
    center, scale = np.array([80.0, 60.0]), 0.4
    for aug in (transforms.AugmentParams(), transforms.AugmentParams(rot=25.0),
                transforms.AugmentParams(flip=True),
                transforms.AugmentParams(rot=-40.0, flip=True, scale=1.2,
                                         pixel_noise=np.array([0.7, 1.0, 1.3], np.float32))):
        got = transforms.process_image(img, center, aug.scale * scale, aug, 32)
        ref = jax_transforms.process_image(img.astype(np.float32), center, aug.scale * scale,
                                           aug, 32)
        np.testing.assert_allclose(got[2:-2, 2:-2], ref[2:-2, 2:-2], atol=PROCESS_TOL)


# --------------------------------------------------------------------------
# no OpenCV in the port
# --------------------------------------------------------------------------

def _port_sources():
    return sorted((REPO / "poco_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_opencv(path):
    """No import of cv2 outside a function body, nor an
    `importlib.import_module` / `__import__` of it there (docstrings that
    cite cv2's conventions may stay): the port imports and runs without
    OpenCV, and takes the JAX package's cv2 routes (the demo's video files,
    cameras and window) only inside the calls that use them, where cv2 is
    installed (`test_port_reads_with_cv2_hidden`,
    tests/test_torch_live_sources.py)."""
    tree = ast.parse(path.read_text())
    in_functions = {id(node) for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for node in ast.walk(fn)}
    for node in ast.walk(tree):
        if id(node) in in_functions:
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and ast.unparse(node.func) in ("__import__", "importlib.import_module")):
            names = [node.args[0].value]
        else:
            continue
        for name in names:
            assert name.split(".")[0] != "cv2", f"{path}: imports {name}"


def test_port_reads_with_cv2_hidden():
    """With `cv2` unimportable, the loader, transforms and occlusion modules
    import and run (in a fresh process)."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "from poco_tpu_torch.runtime import loader\n"
        "from poco_tpu_torch.data import occlusion, transforms\n"
        f"img = loader.decode_image({SMOKE[0]!r})\n"
        "crop = transforms.crop_image(img, (128, 128), 1.0, 32, 10.0)\n"
        "assert crop.shape == (32, 32, 3) and crop.max() > 0\n"
        "assert occlusion.resize_by_factor(occlusion.synthetic_occluders(n=1)[0], 0.5).shape[2] == 4\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
