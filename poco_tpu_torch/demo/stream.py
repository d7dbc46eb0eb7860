"""Streaming (webcam) demo mode (port of `poco_tpu.demo.stream`).

A frame source feeds one frame at a time through the tester's
`infer_frame_dispatch` / `infer_frame_finalize`; detections and SMPL
outputs stream back with a measured latency a frame, and the streaming
`OneEuroFilter` (utils/one_euro.py) smooths the primary person.

Frame sources (`open_source` picks one from a CLI string, in the JAX
package's order):
  * `DirectoryFrameSource`: a directory of images in sorted order (a
    replayed camera; `loop` starts it over at its end);
  * `VideoCaptureFrameSource`: `cv2.VideoCapture` over a camera index, a
    stream URL or a video file, where cv2 is importable (the JAX
    package's route);
  * `MjpegFrameSource`: without cv2, a Motion-JPEG AVI file or HTTP
    stream (`utils/mjpeg.py`), each frame decoded by the port's own JPEG
    decoder (`runtime/loader.decode_jpeg`: nvJPEG on the card's host).

Smoothing filters the rendered quantities (vertices, camera, 2D joints)
directly, as the JAX package's stream does: no extra dispatch a frame.

The JAX stream pads every frame to a 256-px bucket (`bucket_hw`) so that
XLA reuses one compiled program; eager torch needs no padding, so the
port dispatches each frame at its own size (the crops, and so the
results, do not depend on the padding: tests/test_torch_stream.py holds
the port's stream to the JAX package's).
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Any

import numpy as np

from ..runtime.image_write import write_png


class DirectoryFrameSource:
    """The sorted images of a directory as a frame stream."""

    def __init__(self, folder: str, loop: bool = False, max_frames: int | None = None):
        from ..data.inference import images_in_folder

        self.files = images_in_folder(folder)
        if not self.files:
            raise ValueError(f"no images in {folder}")
        if max_frames is not None:
            self.files = self.files[:max_frames]
        self.loop = loop
        self._i = 0

    def read(self) -> np.ndarray | None:
        from ..runtime.loader import read_image_rgb

        if self._i >= len(self.files):
            if not self.loop:
                return None
            self._i = 0
        path = self.files[self._i]
        self._i += 1
        return read_image_rgb(path)

    def close(self) -> None:
        pass


class VideoCaptureFrameSource:
    """`cv2.VideoCapture` over a camera index, a stream URL or a video file
    (the JAX package's source); frames come out RGB."""

    def __init__(self, device: int | str = 0):
        import cv2

        self.cap = cv2.VideoCapture(device)
        if not self.cap.isOpened():
            raise RuntimeError(
                f"cannot open video capture {device!r} (no camera in "
                "this environment? use a directory path as the source "
                "for replay mode)"
            )

    def read(self) -> np.ndarray | None:
        ok, frame = self.cap.read()
        if not ok:
            return None
        return frame[:, :, ::-1].copy()  # BGR -> RGB

    def close(self) -> None:
        self.cap.release()


class MjpegFrameSource:
    """A Motion-JPEG AVI file or `http(s)://` stream, without cv2: each
    frame's JPEG decoded by `runtime/loader.decode_jpeg`."""

    def __init__(self, spec: str):
        from ..utils.mjpeg import iter_mjpeg_http, read_avi_mjpeg

        self.frames = iter_mjpeg_http(spec) if _is_url(spec) else read_avi_mjpeg(spec)

    def read(self) -> np.ndarray | None:
        from ..runtime.loader import decode_jpeg

        data = next(self.frames, None)
        return None if data is None else decode_jpeg(data)

    def close(self) -> None:
        self.frames.close()


def _is_url(spec: str) -> bool:
    return spec.lower().startswith(("http://", "https://"))


def open_source(spec: str, max_frames: int | None = None):
    """A directory -> its replay. Then, where cv2 is importable, a camera
    index ('0', 'webcam:N'), a URL or a file -> `VideoCaptureFrameSource`,
    as the JAX package does; without cv2, an `.avi` file or an http(s)
    URL -> `MjpegFrameSource`. Anything else raises, naming both routes."""
    if os.path.isdir(spec):
        return DirectoryFrameSource(spec, max_frames=max_frames)
    from ..utils.demo_utils import optional_cv2

    if optional_cv2() is not None:
        if spec.startswith("webcam:"):
            spec = spec.split(":", 1)[1]
        return VideoCaptureFrameSource(int(spec) if spec.isdigit() else spec)
    if _is_url(spec) or (spec.lower().endswith(".avi") and os.path.isfile(spec)):
        return MjpegFrameSource(spec)
    raise RuntimeError(
        f"--webcam_source {spec!r}: a camera, a file other than a Motion-JPEG AVI or a "
        "stream other than HTTP Motion-JPEG needs cv2.VideoCapture, and cv2 does not import here; "
        "without cv2 the port reads a directory of frames, an MJPG .avi file or an "
        "http(s) multipart/x-mixed-replace (Motion-JPEG) stream"
    )


def run_stream(
    tester,
    source,
    output_folder: str | None = None,
    smooth: bool = True,
    min_cutoff: float = 0.004,
    beta: float = 1.5,
    uncert_color: bool = True,
    display: bool = False,
    render: bool = True,
    max_frames: int | None = None,
    pipeline: bool = True,
) -> dict[str, Any]:
    """Drive the per-frame pipeline over a frame source, at most
    `max_frames` frames of it, and close the source at the end.

    With `pipeline` (default) the loop runs a depth-1 dispatch-ahead
    pipeline: frame N's card work (crop, forward, SMPL) runs while the
    host finishes frame N-1 (fetch, smoothing, render, write) and detects
    frame N+1. Frames are finalized strictly in order, so smoothing and
    rendering are bit-identical to the sequential path (`pipeline=False`).
    With `render`, frames are rendered when `output_folder` is given
    (written there) or `display` (shown: `tester._display_frame`). Unlike
    the JAX stream, no `tester.warmup` runs first: eager torch compiles
    nothing a frame size, and the kernels build at their first launch.

    Returns latency statistics in milliseconds: a frame's end to end
    (detection start to render done; under pipelining it spans one
    pipeline slot) and the model's (dispatch to fetch), and `fps`, frames
    over the whole wall time.
    """
    from ..utils.one_euro import OneEuroFilter
    from ..viz.renderer import get_vertex_colors

    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
    frame = source.read()
    if frame is None:
        raise ValueError("empty frame source")
    lbs_weights = tester.lbs_weights

    filters: dict[str, OneEuroFilter] = {}
    lat_e2e: list[float] = []
    lat_model: list[float] = []
    n_frames = 0
    n_detections = 0

    def _smooth(key: str, t: float, x: np.ndarray) -> np.ndarray:
        f = filters.get(key)
        if f is None:
            filters[key] = OneEuroFilter(t, x, min_cutoff=min_cutoff, beta=beta)
            return x
        return np.asarray(f(t, x), x.dtype)

    def _process(st: dict[str, Any]) -> None:
        """Finalize one dispatched frame: fetch, smooth, render, write."""
        nonlocal n_detections
        result = tester.infer_frame_finalize(st["handle"])
        t_fetched = time.perf_counter()
        if result:
            n_detections += len(result["bboxes"])
            if smooth:
                # the primary (first) detection only: a re-detected stream
                # has no track ids; the frame index is the filter's clock
                for key in ("verts", "orig_cam", "smpl_joints2d"):
                    sm = _smooth(key, st["idx"], result[key][0])
                    result[key] = np.concatenate([sm[None], result[key][1:]], axis=0)
            if render and (output_folder or display):
                canvas = st["frame"].copy()
                var = result["var"]
                for pi in range(len(result["bboxes"])):
                    vc = None
                    if uncert_color and var is not None:
                        vc = get_vertex_colors(var[pi].copy(), lbs_weights,
                                               backbone=tester.backbone)
                    canvas = tester.renderer.render(canvas, result["verts"][pi],
                                                    result["orig_cam"][pi], vertex_colors=vc)
                if output_folder:
                    write_png(osp.join(output_folder, f"stream_{st['idx']:06d}.png"), canvas)
                if display:
                    tester._display_frame(canvas)
        t_done = time.perf_counter()
        lat_model.append((t_fetched - st["t_disp"]) * 1e3)
        lat_e2e.append((t_done - st["t0"]) * 1e3)

    pend: dict[str, Any] | None = None
    wall_t0 = time.perf_counter()
    while frame is not None:
        if max_frames is not None and n_frames >= max_frames:
            break
        t0 = time.perf_counter()
        dets = tester.detector(frame)
        t_disp = time.perf_counter()
        cur = {"handle": tester.infer_frame_dispatch(frame, dets), "frame": frame,
               "idx": n_frames, "t0": t0, "t_disp": t_disp}
        if pipeline:
            # frame N-1 is finished after N is dispatched: N's card work
            # overlaps N-1's fetch and render and N+1's detection
            if pend is not None:
                _process(pend)
            pend = cur
        else:
            _process(cur)
        n_frames += 1
        frame = source.read()
    if pend is not None:
        _process(pend)
    wall = time.perf_counter() - wall_t0

    source.close()
    e2e = np.asarray(lat_e2e) if lat_e2e else np.asarray([np.nan])
    mdl = np.asarray(lat_model) if lat_model else np.asarray([np.nan])
    return {
        "frames": n_frames,
        "detections": n_detections,
        "pipelined": bool(pipeline),
        "e2e_ms_p50": round(float(np.percentile(e2e, 50)), 1),
        "e2e_ms_p90": round(float(np.percentile(e2e, 90)), 1),
        "model_ms_p50": round(float(np.percentile(mdl, 50)), 1),
        "model_ms_p90": round(float(np.percentile(mdl, 90)), 1),
        "fps": round(n_frames / max(wall, 1e-9), 2),
    }
