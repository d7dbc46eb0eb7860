"""PyTorch port vs JAX package: the demo's video files, cameras and streams
(`poco_tpu_torch/utils/mjpeg.py`, `demo/stream.py`'s sources,
`utils/demo_utils.py`'s video I/O, `--display`, Mask R-CNN and YouTube).

This host has cv2 5.0.0 (FFMPEG and the built-in MJPEG writer) and no
ffmpeg binary; a host with neither takes the Motion-JPEG route, which
these tests reach by hiding cv2 (chip_smoke.py phase 4j (e) hides it on
the card's host the same way)
(`monkeypatch.setitem(sys.modules, "cv2", None)`). The bars:
  * Motion-JPEG AVIs that cv2 writes (`CAP_OPENCV_MJPEG`, `CAP_FFMPEG`):
    `read_avi_mjpeg` gives cv2.VideoCapture's frame count, and its frames
    decoded by the port's `decode_jpeg` lie within 2 grey levels (mean
    absolute difference) of cv2's frames, the loader's bar against cv2
    (tests/test_torch_loader.py); `write_avi_mjpeg` round-trips the bytes
    exactly, and cv2 reads its files;
  * HTTP Motion-JPEG on loopback (`MjpegHttpServer`, with and without
    the parts' Content-Length): `MjpegFrameSource` equals
    `DirectoryFrameSource` over the same files bit for bit, and the JAX
    package's `VideoCaptureFrameSource` (cv2 opens the URL here) is
    within the 2-level bar;
  * the demo, JAX's `demo.run_webcam` / `run_video` against the port's
    `cli.demo` on the same clip (both through cv2 here), on the JAX
    `_tiny_tester` and its twin (tests/test_torch_demo.py's `testers`):
    results at tests/test_torch_demo.py's bars (`HEAD_TOL`, atol 0.05 on
    the recorded boxes as tests/test_torch_stream.py uses), rendered
    frames at the renderer's bar, and the extracted frames byte-equal;
  * the Motion-JPEG route: extracted frames byte-equal to the AVI's,
    results bit-identical to the same frames given as a folder, the
    HTTP stream's frames bit-identical to the directory's;
  * `--display`, Mask R-CNN and YouTube as `demo.py` treats them: JAX's
    notices and SystemExit, word for word, outputs unchanged, and no
    network.
"""

import http.server
import os
import shutil
import socket
import struct
import sys
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import demo as jax_demo
from poco_tpu.demo import stream as jax_stream
from poco_tpu.utils import demo_utils as jax_demo_utils

from poco_tpu_torch.cli import demo as cli_demo
from poco_tpu_torch.demo import stream
from poco_tpu_torch.runtime import loader
from poco_tpu_torch.runtime.image_write import decode_png, encode_png
from poco_tpu_torch.runtime.loader import decode_jpeg
from poco_tpu_torch.utils import demo_utils, mjpeg

from .test_torch_demo import (  # noqa: F401  (fixtures)
    DISPLAY_NOTICE,
    HEAD_TOL,
    MASKRCNN_NOTICE,
    TINY_YAML,
    YOUTUBE_EXIT,
    _assert_frames_close,
    _assert_result_close,
    _assert_video_results_close,
    _scene,
    frame_folder,
    testers,
)

CV2_LEVELS = 2.0          # mean |port decode - cv2 frame| (tests/test_torch_loader.py)
BOX_ATOL = 0.05           # the recorded boxes' atol (tests/test_torch_stream.py)
CLIP_HW = (120, 160)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_display_no_ffmpeg(monkeypatch):
    """No display server and no ffmpeg binary in any test here (this host
    has none; a developer's may have both)."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)


def _cv2_frames(path_or_url, api=cv2.CAP_ANY) -> list[np.ndarray]:
    """Every frame cv2.VideoCapture reads, RGB."""
    cap = cv2.VideoCapture(path_or_url, api)
    assert cap.isOpened(), path_or_url
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1].copy())
    cap.release()
    return frames


def _mad(a, b) -> float:
    return float(np.abs(a.astype(np.int64) - b).mean())


def _write_cv2_avi(path, frames_rgb, api) -> None:
    h, w = frames_rgb[0].shape[:2]
    writer = cv2.VideoWriter(str(path), api, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
    assert writer.isOpened()
    for frame in frames_rgb:
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
    writer.release()


@pytest.fixture(scope="module")
def clip(frame_folder, tmp_path_factory) -> Path:
    """tests/test_torch_demo.py's 4 frames as an MJPG AVI written by cv2's
    own MJPEG writer."""
    path = tmp_path_factory.mktemp("clip") / "clip.avi"
    _write_cv2_avi(path, [cv2.imread(str(p))[:, :, ::-1]
                          for p in sorted(Path(frame_folder).iterdir())], cv2.CAP_OPENCV_MJPEG)
    return path


@pytest.fixture(scope="module")
def jpeg_folder(clip, tmp_path_factory) -> Path:
    """The clip's stored JPEGs as files `%06d.jpg`."""
    folder = tmp_path_factory.mktemp("jpegs")
    for i, data in enumerate(mjpeg.read_avi_mjpeg(str(clip))):
        (folder / f"{i:06d}.jpg").write_bytes(data)
    return folder


# --------------------------------------------------------------------------
# AVI files
# --------------------------------------------------------------------------

@pytest.mark.parametrize("api", [cv2.CAP_OPENCV_MJPEG, cv2.CAP_FFMPEG],
                         ids=["opencv_mjpeg", "ffmpeg"])
def test_avi_reader_matches_cv2(tmp_path, api):
    frames = [_scene(s, (144, 176)) for s in range(5)]
    path = tmp_path / "x.avi"
    _write_cv2_avi(path, frames, api)
    stored = list(mjpeg.read_avi_mjpeg(str(path)))
    ref = _cv2_frames(str(path))
    assert len(stored) == len(ref) == 5
    assert mjpeg.avi_frame_size(str(path)) == (144, 176)
    for data, want in zip(stored, ref):
        assert _mad(decode_jpeg(data), want) < CV2_LEVELS


def test_avi_writer_round_trips_and_cv2_reads_it(jpeg_folder, tmp_path):
    data = [p.read_bytes() for p in sorted(jpeg_folder.iterdir())]
    path = tmp_path / "y.avi"
    assert mjpeg.write_avi_mjpeg(str(path), iter(data), 29.97, CLIP_HW[::-1]) == 4
    assert list(mjpeg.read_avi_mjpeg(str(path))) == data
    assert mjpeg.avi_frame_size(str(path)) == CLIP_HW
    cap = cv2.VideoCapture(str(path))
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(29.97)
    cap.release()
    for api in (cv2.CAP_ANY, cv2.CAP_OPENCV_MJPEG):
        ref = _cv2_frames(str(path), api)
        assert len(ref) == 4
        for d, want in zip(data, ref):
            assert _mad(decode_jpeg(d), want) < CV2_LEVELS


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, *chunks: bytes) -> bytes:
    return _chunk(b"LIST", kind + b"".join(chunks))


def _hdrl(handler=b"MJPG", compression=b"MJPG", audio=True) -> bytes:
    h, w = CLIP_HW
    avih = struct.pack("<14I", 40000, 0, 0, 0x10, 3, 0, 2, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", handler, 0, 0, 0, 0, 1, 25, 0, 3,
                       0, 0, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, compression, 0, 0, 0, 0, 0)
    streams = [_list(b"strl", _chunk(b"strh", strh), _chunk(b"strf", strf))]
    if audio:
        streams.append(_list(b"strl", _chunk(b"strh", b"auds" + bytes(52)),
                             _chunk(b"strf", bytes(18))))
    return _list(b"hdrl", _chunk(b"avih", avih), *streams)


def test_avi_reader_walks_rec_lists_junk_and_odd_chunks(jpeg_folder, tmp_path):
    """A hand-made AVI: `JUNK` before and inside `movi`, a frame in a
    `LIST rec ` with an audio chunk, an odd-sized frame (padded), a `00db`
    frame, a `00dc` chunk that is not a JPEG and the index: the JPEG
    frames come out as stored, in order."""
    a, b, c = [p.read_bytes() for p in sorted(jpeg_folder.iterdir())[:3]]
    b = b + b"\0" if len(b) % 2 == 0 else b   # an odd size: the chunk is padded
    movi = _list(b"movi", _chunk(b"JUNK", b"x" * 7),
                 _list(b"rec ", _chunk(b"00dc", a), _chunk(b"01wb", b"\1" * 9)),
                 _chunk(b"00dc", b), _chunk(b"00dc", b"not a frame"), _chunk(b"00db", c))
    riff = b"AVI " + _hdrl() + _chunk(b"JUNK", b"\0" * 33) + movi + _chunk(b"idx1", bytes(48))
    path = tmp_path / "hand.avi"
    path.write_bytes(_chunk(b"RIFF", riff))
    assert list(mjpeg.read_avi_mjpeg(str(path))) == [a, b, c]
    assert mjpeg.avi_frame_size(str(path)) == CLIP_HW


def test_avi_reader_refuses_other_codecs_and_opendml(jpeg_folder, tmp_path):
    frame = next(iter(sorted(jpeg_folder.iterdir()))).read_bytes()
    movi = _list(b"movi", _chunk(b"00dc", frame))
    for name, hdrl in (("xvid", _hdrl(b"XVID", b"XVID")), ("h264", _hdrl(b"H264", b"MJPG"))):
        path = tmp_path / f"{name}.avi"
        path.write_bytes(_chunk(b"RIFF", b"AVI " + hdrl + movi))
        with pytest.raises(ValueError, match="cv2.VideoCapture or ffmpeg"):
            list(mjpeg.read_avi_mjpeg(str(path)))
    path = tmp_path / "odml.avi"
    path.write_bytes(_chunk(b"RIFF", b"AVI " + _hdrl() + movi)
                     + _chunk(b"RIFF", b"AVIX" + movi))
    with pytest.raises(ValueError, match="AVIX.*cv2.VideoCapture or ffmpeg"):
        list(mjpeg.read_avi_mjpeg(str(path)))
    path.write_bytes(b"RIFF\0\0\0\0WAVE")
    with pytest.raises(ValueError, match="not an AVI"):
        list(mjpeg.read_avi_mjpeg(str(path)))


# --------------------------------------------------------------------------
# HTTP Motion-JPEG
# --------------------------------------------------------------------------

@pytest.mark.parametrize("content_length", [True, False], ids=["length", "scan"])
def test_http_stream_equals_the_directory(jpeg_folder, content_length):
    data = [p.read_bytes() for p in sorted(jpeg_folder.iterdir())]
    with mjpeg.MjpegHttpServer(data, content_length=content_length) as server:
        assert list(mjpeg.iter_mjpeg_http(server.url)) == data
        source = stream.MjpegFrameSource(server.url)
        got = [source.read() for _ in range(5)]
        source.close()
        # the JAX package's source over the same URL (cv2 opens it here)
        want = jax_stream.VideoCaptureFrameSource(server.url)
        ref = [want.read() for _ in range(5)]
        want.close()
    direct = stream.DirectoryFrameSource(str(jpeg_folder))
    for g, d, r in zip(got, [direct.read() for _ in range(5)], ref):
        if d is None:
            assert g is None and r is None
            continue
        np.testing.assert_array_equal(g, d)
        assert _mad(g, r) < CV2_LEVELS


@pytest.mark.parametrize("content_type, boundary", [
    ('multipart/x-mixed-replace; boundary="frame"', b"frame"),
    ("multipart/x-mixed-replace;boundary=--myboundary", b"myboundary"),
    ("Multipart/X-Mixed-Replace; charset=x; boundary=b1", b"b1"),
])
def test_http_boundary_forms(content_type, boundary):
    assert mjpeg._boundary(content_type, "u") == boundary


def test_http_refuses_what_is_not_motion_jpeg():
    class Plain(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.end_headers()

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Plain)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(ValueError, match="multipart/x-mixed-replace"):
            list(mjpeg.iter_mjpeg_http(f"http://127.0.0.1:{httpd.server_address[1]}/"))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    with pytest.raises(ValueError, match="not an http"):
        list(mjpeg.iter_mjpeg_http("rtsp://127.0.0.1:1/x"))


# --------------------------------------------------------------------------
# open_source: the JAX package's routes with cv2, Motion-JPEG without
# --------------------------------------------------------------------------

def test_open_source_routes(clip, jpeg_folder, tmp_path, monkeypatch):
    source = stream.open_source(str(clip))
    assert isinstance(source, stream.VideoCaptureFrameSource)
    ref = jax_stream.open_source(str(clip))
    for _ in range(5):
        g, r = source.read(), ref.read()
        assert (g is None and r is None) or np.array_equal(g, r)
    source.close()
    ref.close()
    looped = stream.DirectoryFrameSource(str(jpeg_folder), loop=True)
    first = [looped.read() for _ in range(4)]
    np.testing.assert_array_equal(looped.read(), first[0])

    monkeypatch.setitem(sys.modules, "cv2", None)
    data = [p.read_bytes() for p in sorted(jpeg_folder.iterdir())]
    with mjpeg.MjpegHttpServer(data) as server:
        for spec in (str(clip), server.url):
            source = stream.open_source(spec)
            assert isinstance(source, stream.MjpegFrameSource)
            got = [source.read() for _ in range(4)]
            source.close()
            for g, f in zip(got, first):
                np.testing.assert_array_equal(g, f)
    (tmp_path / "x.mp4").write_bytes(b"\0")
    for spec in ("0", "webcam:0", str(tmp_path / "x.mp4"), "rtsp://127.0.0.1:1/x"):
        with pytest.raises(RuntimeError, match="needs cv2.VideoCapture"):
            stream.open_source(spec)


# --------------------------------------------------------------------------
# the demo on a clip: JAX against the port, both through cv2
# --------------------------------------------------------------------------

def _recording(monkeypatch, tester, method: str) -> list:
    """Record what `tester.<method>` returns."""
    calls = []
    fn = getattr(tester, method)

    def record(*args, **kwargs):
        calls.append(fn(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(tester, method, record)
    return calls


def _args(out, *flags):
    return cli_demo.parse_args(["--cfg", TINY_YAML, "--output_folder", str(out), *flags,
                                "--device", "cpu"])


def test_webcam_on_a_clip_matches_jax(testers, clip, tmp_path, monkeypatch):
    """`--mode webcam --webcam_source clip.avi --smooth`: JAX's
    `run_webcam` against the port's, frame by frame after smoothing."""
    port, ref = testers
    got = _recording(monkeypatch, port, "infer_frame_finalize")
    want = _recording(monkeypatch, ref, "infer_frame_finalize")
    flags = ["--mode", "webcam", "--webcam_source", str(clip), "--smooth"]
    got_stats = cli_demo.run_webcam(_args(tmp_path / "port", *flags), port)
    want_stats = jax_demo.run_webcam(_args(tmp_path / "jax", *flags), ref)
    assert got_stats["frames"] == want_stats["frames"] == 4 == len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.pop("bboxes"), r.pop("bboxes"), rtol=HEAD_TOL,
                                   atol=BOX_ATOL)
        _assert_result_close(g, r)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        _assert_frames_close(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_video_on_a_clip_matches_jax(testers, clip, tmp_path, monkeypatch):
    """`--mode video --vid_file clip.avi --smooth`: JAX's `demo.run_video`
    against the port's. Both probe the size with cv2, extract with cv2 at
    JPEG quality 95 (byte-equal frames) and write an mp4 with cv2's mp4v."""
    port, ref = testers
    got = _recording(monkeypatch, port, "run_on_video")
    want = _recording(monkeypatch, ref, "run_on_video")
    warmed = _recording(monkeypatch, port, "warmup_sizes")
    flags = ["--mode", "video", "--vid_file", str(clip), "--smooth"]
    cli_demo.run_video(_args(tmp_path / "port", *flags), port)
    jax_demo.run_video(_args(tmp_path / "jax", *flags), ref)
    assert warmed == [{CLIP_HW}]
    _assert_video_results_close(got[0], want[0])
    frames = {side: _files(tmp_path / side / "frames_clip") for side in ("port", "jax")}
    assert frames["port"] == frames["jax"] and len(frames["jax"]) == 4
    names = sorted(os.listdir(tmp_path / "jax" / "rendered"))
    assert names == sorted(os.listdir(tmp_path / "port" / "rendered")) and len(names) == 4
    for name in names:
        _assert_frames_close(tmp_path / "port" / "rendered" / name,
                             tmp_path / "jax" / "rendered" / name)
    for side in ("port", "jax"):
        assert len(_cv2_frames(str(tmp_path / side / "clip_poco.mp4"))) == 4


def _files(folder) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(Path(folder).iterdir()) if p.is_file()}


def test_video_io_routes_match_jax(clip, frame_folder, tmp_path, monkeypatch):
    """`video_to_images` and `images_to_video` without ffmpeg: the cv2
    route equals the JAX package's (frames byte-equal, an mp4v file each);
    with cv2 hidden, the MJPG AVI's JPEGs come out unchanged and the
    frames go into `<stem>.avi` at quality 95, within the loader's bar of
    the frames."""
    for side, module in (("port", demo_utils), ("jax", jax_demo_utils)):
        folder, n, shape = module.video_to_images(str(clip), str(tmp_path / side),
                                                  return_info=True)
        assert n == 4 and shape == (*CLIP_HW, 3)
        module.images_to_video(frame_folder, str(tmp_path / f"{side}.mp4"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for side in ("port", "jax"):
        assert len(_cv2_frames(str(tmp_path / f"{side}.mp4"))) == 4
    assert demo_utils.video_frame_size(str(clip)) == CLIP_HW

    monkeypatch.setitem(sys.modules, "cv2", None)
    folder, n, shape = demo_utils.video_to_images(str(clip), str(tmp_path / "mjpeg"),
                                                  return_info=True)
    assert n == 4 and shape == (*CLIP_HW, 3)
    assert list(_files(folder).values()) == list(mjpeg.read_avi_mjpeg(str(clip)))
    assert sorted(_files(folder)) == [f"{i:06d}.jpg" for i in range(1, 5)]
    assert demo_utils.video_frame_size(str(clip)) == CLIP_HW
    avi = demo_utils.images_to_video(frame_folder, str(tmp_path / "out_poco.mp4"))
    assert avi == str(tmp_path / "out_poco.avi")
    stored = list(mjpeg.read_avi_mjpeg(avi))
    pngs = [p for p in sorted(Path(frame_folder).iterdir())]
    assert len(stored) == len(pngs) == 4
    for data, png in zip(stored, pngs):
        assert _mad(decode_jpeg(data), decode_jpeg(png)) < CV2_LEVELS


def test_decode_png_reads_the_ports_own_pngs():
    """`decode_png` is `encode_png`'s inverse (RGB and grey), and refuses
    a PNG with filtered scanlines (cv2's) rather than misread it."""
    rgb = _scene(3, (37, 53))
    np.testing.assert_array_equal(decode_png(encode_png(rgb)), rgb)
    np.testing.assert_array_equal(decode_png(encode_png(rgb[..., 1].copy())), rgb[..., 1])
    ok, data = cv2.imencode(".png", rgb)
    assert ok
    with pytest.raises(ValueError, match="unfiltered"):
        decode_png(data.tobytes())


# --------------------------------------------------------------------------
# the card's route: Motion-JPEG with cv2 hidden
# --------------------------------------------------------------------------

def test_motion_jpeg_route_without_cv2(testers, clip, jpeg_folder, tmp_path, monkeypatch):
    """With cv2 hidden, as on a host without it: `--vid_file clip.avi`
    extracts the stored JPEGs byte for byte, and its results are
    bit-identical to `--image_folder` over the same JPEGs; the written
    `.avi` reads back with as many frames as were rendered. The HTTP
    stream of those JPEGs gives the frames of the directory's stream,
    bit for bit."""
    port, _ = testers
    monkeypatch.setitem(sys.modules, "cv2", None)
    read = loader.read_image_rgb

    def jpeg_only(path):   # as the loader's nvJPEG route on the card's host
        if str(path).endswith(".png"):
            raise ValueError(f"{path}: unsupported format: the nvjpeg loader decodes JPEG only")
        return read(path)

    monkeypatch.setattr(loader, "read_image_rgb", jpeg_only)
    runs = _recording(monkeypatch, port, "run_on_video")
    cli_demo.run_video(_args(tmp_path / "avi", "--mode", "video", "--vid_file", str(clip),
                             "--smooth"), port)
    cli_demo.run_video(_args(tmp_path / "dir", "--mode", "video", "--image_folder",
                             str(jpeg_folder), "--smooth"), port)
    assert list(_files(tmp_path / "avi" / "frames_clip").values()) == \
        list(_files(jpeg_folder).values())
    (got,), (want,) = runs[0].values(), runs[1].values()
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    rendered = sorted(os.listdir(tmp_path / "avi" / "rendered"))
    assert len(rendered) == 4
    assert len(list(mjpeg.read_avi_mjpeg(str(tmp_path / "avi" / "clip_poco.avi")))) == 4

    data = list(_files(jpeg_folder).values())
    with mjpeg.MjpegHttpServer(data) as server:
        for label, source in (("http", server.url), ("dir", str(jpeg_folder))):
            cli_demo.run_webcam(_args(tmp_path / f"stream_{label}", "--mode", "webcam",
                                      "--webcam_source", source, "--smooth",
                                      "--max_frames", "3"), port)
    streamed = _files(tmp_path / "stream_http")
    assert streamed == _files(tmp_path / "stream_dir") and len(streamed) == 3


# --------------------------------------------------------------------------
# --display, Mask R-CNN, YouTube
# --------------------------------------------------------------------------

def test_display_prints_the_notice_and_changes_nothing(testers, frame_folder, jpeg_folder,
                                                       tmp_path, monkeypatch, capsys):
    """`--display` in the video and webcam modes: JAX's notice once a
    tester, and the written frames those of a run without it."""
    port, _ = testers
    monkeypatch.setattr(port, "_display_warned", False, raising=False)
    for mode, flags in (("video", ["--image_folder", frame_folder]),
                        ("webcam", ["--webcam_source", str(jpeg_folder)])):
        for display in ([], ["--display"]):
            out = tmp_path / f"{mode}{len(display)}"
            run = cli_demo.run_video if mode == "video" else cli_demo.run_webcam
            run(_args(out, "--mode", mode, *flags, *display), port)
        sub = "rendered" if mode == "video" else ""
        assert _files(tmp_path / f"{mode}1" / sub) == _files(tmp_path / f"{mode}0" / sub)
    assert capsys.readouterr().out.count(DISPLAY_NOTICE) == 1


def test_maskrcnn_falls_back_as_jax(monkeypatch, tmp_path, capsys):
    """Without torchvision, `--detector maskrcnn` prints JAX's notice and
    turns into yolo, which without weights turns into refine, in both
    CLIs (the JAX tester's build is stubbed: only the choice is compared)."""
    import poco_tpu.demo.tester as jax_tester

    monkeypatch.setitem(sys.modules, "torchvision", None)
    monkeypatch.delenv("POCO_TPU_YOLO_WEIGHTS", raising=False)
    monkeypatch.delenv("POCO_TPU_MASKRCNN_WEIGHTS", raising=False)
    flags = ["--detector", "maskrcnn", "--yolo_weights", str(tmp_path / "absent.weights")]
    port_args = _args(tmp_path, *flags)
    tester = cli_demo.build_tester(port_args)
    port_out = capsys.readouterr().out
    class Stub:
        def __init__(self, *args, detector=None, **kwargs):
            self.detector = detector

        def make_refined_detector(self, base):
            return base

    monkeypatch.setattr(jax_tester, "PocoTester", Stub)
    jax_args = _args(tmp_path, *flags)
    jax_demo.build_tester(jax_args)
    jax_out = capsys.readouterr().out
    assert port_args.detector == jax_args.detector == "refine"
    assert hasattr(tester.detector, "detect_batch")
    for out in (port_out, jax_out):
        assert MASKRCNN_NOTICE in out and "falling back to --detector refine" in out


def test_youtube_without_backends_exits_as_jax(tmp_path, monkeypatch):
    """A YouTube URL without pytube or yt-dlp: JAX's SystemExit from both
    `run_video`s, before any tester work, and no socket connects."""
    monkeypatch.setitem(sys.modules, "pytube", None)

    def no_network(*args):
        raise AssertionError("a socket tried to connect")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    flags = ["--mode", "video", "--vid_file", "https://www.youtube.com/watch?v=x"]
    for run in (cli_demo.run_video, jax_demo.run_video):
        with pytest.raises(SystemExit) as exit_:
            run(_args(tmp_path / run.__module__, *flags), None)
        assert str(exit_.value) == YOUTUBE_EXIT
    for download in (demo_utils.download_youtube_clip, jax_demo_utils.download_youtube_clip):
        assert download("https://youtu.be/x", str(tmp_path / "dl")) is None


def test_warmup_runs_the_frame_and_tracking_sizes(testers, monkeypatch):
    """`warmup(frame_hw)` runs one forward at the frame's size and one at
    the tracking pass's 512-px size, as the JAX tester warms both."""
    import poco_tpu_torch.demo.tester as tester_module

    port, _ = testers
    assert port.warmup_sizes((540, 960)) == {(540, 960), (288, 512)}
    assert port.warmup_sizes((120, 160)) == {(120, 160)}
    seen = []
    forward = tester_module.detect_forward

    def recording(model, smpl, image, centers, scales, true_hw=None):
        seen.append((tuple(image.shape), np.asarray(centers).tolist()))
        return forward(model, smpl, image, centers, scales, true_hw)

    monkeypatch.setattr(tester_module, "detect_forward", recording)
    port.warmup((540, 960))
    assert seen == [((288, 512, 3), [[256.0, 144.0]]), ((540, 960, 3), [[480.0, 270.0]])]
