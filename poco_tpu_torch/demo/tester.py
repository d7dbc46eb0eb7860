"""Demo runtime: image-folder and video inference with rendering (port of
`poco_tpu.demo.tester`; reference pocolib/core/tester.py:54-580).

`detect_forward` answers one request: the image goes to the model's
device once, as uint8, and crop, normalize, CLIFF conditioning,
backbone, head, SMPL and uncertainty all run there. `PocoTester` drives
the folder and video demos around it: detection, model-in-the-loop box
refinement, IoU tracking, One-Euro smoothing and the mesh overlays.

Eager torch needs none of the JAX demo's padding (detections to
multiples of 8 or 4, frames to 256-px buckets, chunks to `batch_size`),
which exists so that XLA reuses one compiled program: the rows here are
the JAX outputs' real rows. As there, the heavy outputs are rounded to
fp16 on the device (vertices and 3D joints on the folder path, and the
2D joints too on the video path, `_forward_compact`). The folder mode
writes each overlay under its input's own name and format (`x.jpg` as a
JPEG, `runtime/image_write.write_image`), as the JAX demo does; the
video mode writes `%06d.png`. `stage_seconds` sums host-clock seconds by stage
(decode, detect, poco, smooth, render, write), each stage also a span
(`utils/spans.py`). Nothing synchronizes at a stage's end: for a stage
that runs on the card, its seconds are the time to enqueue its work plus
the waits where it reads results back, and work it only enqueues counts
to the stage that next waits for the card.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import pickle
import sys
import time
from collections import Counter
from typing import Any

import numpy as np
import torch

from ..data.inference import InferenceDataset, images_in_folder
from ..eval.uncertainty import global_uncert, prepare_uncert
from ..ops.preprocess import normalize_image, preprocess_crops
from ..runtime.image_write import write_image, write_png
from ..runtime.loader import read_image_rgb, read_images_rgb
from ..smpl.lbs import SmplParams
from ..utils import spans
from ..utils.demo_utils import (
    convert_crop_cam_to_orig_img,
    convert_crop_coords_to_orig_img,
    optional_cv2,
    prepare_rendering_results,
)
from ..runtime.raster import circles_aa
from ..viz.renderer import Renderer, get_vertex_colors, overlay_text, save_obj
from .tracker import Detector, full_frame_detector, run_tracking


def draw_keypoints_2d(frame: np.ndarray, joints2d: np.ndarray, radius: int = 3) -> np.ndarray:
    """Mark projected 2D joints (reference --draw_keypoints flag,
    demo.py:279-281): a filled green circle of `radius` at each finite
    joint, truncated to whole pixels, as `cv2.circle(..., -1, LINE_AA)`
    draws it (`runtime.raster.circles_aa`), in place when `frame` is a
    C-contiguous uint8 image."""
    out = np.ascontiguousarray(frame)
    pts = np.concatenate([person[:, :2] for person in np.atleast_3d(joints2d)])
    pts = pts[np.isfinite(pts).all(axis=1)]
    circles_aa(out, np.trunc(pts).astype(np.int64), radius, (0, 255, 0))
    return out


def _on_device(x, device, dtype):
    """`x` as a `dtype` tensor on `device`. A host array bound for a card is
    staged through pinned memory (torch's caching host allocator, which
    keeps the block until the copy is done) and copied without waiting: a
    copy from pageable memory waits for the card's queue to drain. A card
    tensor is cast on its device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = torch.as_tensor(x)
    if torch.device(device).type == "cuda" and x.device.type == "cpu":
        return x.to(dtype).pin_memory().to(device, non_blocking=True)
    return x.to(device=device, dtype=dtype)


class RequestOutputs(dict):
    """The outputs of a request answered on a card, a dict of the model's
    outputs made on the port's request stream. Reading a value (by key,
    `get`, `values`, `items`, `pop`, `copy`, or `dict(...)` / `{**...}` of
    it) first makes the reader's current stream wait on the request's
    `done` event, once a stream. So the fetch of a request waits for that
    request alone, and not for the requests dispatched after it, which a
    wait made when the request returned would have put in the caller's
    stream before the fetch. The values are recorded on the caller's stream
    for the caching allocator (`Tensor.record_stream`); a reader on another
    stream that frees them while its reads are queued records its own."""

    def __init__(self, outputs: dict, done: torch.cuda.Event, device: torch.device):
        super().__init__(outputs)
        self.done, self.device = done, device
        self._waited: set[int] = set()

    def _ready(self) -> None:
        stream = torch.cuda.current_stream(self.device)
        if stream.cuda_stream not in self._waited:
            stream.wait_event(self.done)
            self._waited.add(stream.cuda_stream)

    def __getitem__(self, key):
        self._ready()
        return super().__getitem__(key)

    def __iter__(self):
        # a dict subclass with its own __iter__ is copied (dict(...), {**...},
        # update) through keys() and __getitem__, not from its storage
        return super().__iter__()

    def get(self, key, default=None):
        self._ready()
        return super().get(key, default)

    def values(self):
        self._ready()
        return super().values()

    def items(self):
        self._ready()
        return super().items()

    def pop(self, *args):
        self._ready()
        return super().pop(*args)

    def copy(self) -> dict:
        return dict(self)


_REQUEST_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_LAST_DONE: dict[torch.device, torch.cuda.Event] = {}


def _request_stream(device: torch.device) -> torch.cuda.Stream:
    """The port's request stream on `device`: one a device, made once, from
    torch's pool of non-blocking streams (no implicit order with the
    legacy default stream)."""
    stream = _REQUEST_STREAMS.get(device)
    if stream is None:
        stream = _REQUEST_STREAMS[device] = torch.cuda.Stream(device=device)
    return stream


def _answer(model, smpl, device, image, centers, scales, true_hw) -> dict[str, Any]:
    """Upload, crop (at the model's `img_res`) and the model, on the current stream."""
    with spans.span(spans.UPLOAD, wait=True):
        image = _on_device(image, device, torch.uint8)
        centers = _on_device(centers, device, torch.float32)
        scales = _on_device(scales, device, torch.float32)
        if true_hw is not None:
            true_hw = _on_device(true_hw, device, torch.float32)
    with spans.span(spans.CROP):
        batch = preprocess_crops(image, centers, scales, out_res=model.cfg.img_res,
                                 true_hw=true_hw)
    return model(batch, smpl)


@torch.inference_mode()
def detect_forward(
    model: torch.nn.Module,
    smpl: SmplParams,
    image_uint8_hwc,
    centers,
    scales,
    true_hw=None,
) -> dict[str, Any]:
    """Answer one request.

    On a card the request runs on the port's request stream
    (`_request_stream`), after the work queued so far on the caller's
    current stream, and returns without waiting for the card: host inputs
    go up through pinned memory, the model's constants are on the card
    already. It returns a `RequestOutputs`, whose reads wait for this
    request alone. Until an output is read (or the card synchronized), the
    card may still be reading the request's inputs and the model's weights:
    a caller that writes to them on its own stream reads an output first.
    Under `utils/spans.py`'s recording or a profiler, the request opens
    `poco/ahead` when it starts while the card is still running the
    request before it (its done event has not fired): the host has run
    ahead of the card, and the card goes from one request to the next
    with no gap. (Not as it returns: the card's launch queue holds fewer
    launches than a request makes, so the host, held at its launches,
    returns when the card is well into this request.) On the CPU it runs
    and returns the model's plain dict.

    Args:
        model: a POCO in eval mode; its device is the request's device.
        smpl: SMPL weights on the same device.
        image_uint8_hwc: (H, W, 3) uint8 RGB image (numpy or tensor).
        centers: (N, 2) bbox centers in image pixels.
        scales: (N,) bbox heights / 200.
        true_hw: optional (2,) unpadded (h, w) of a bottom/right-padded image.
    Returns:
        The model's output dict for the N boxes.
    """
    with spans.span(spans.REQUEST):
        device = next(model.parameters()).device
        inputs = (image_uint8_hwc, centers, scales, true_hw)
        if device.type != "cuda":
            return _answer(model, smpl, device, *inputs)
        before = _LAST_DONE.get(device)
        if spans.active() and before is not None and not before.query():
            with spans.span(spans.AHEAD):   # the card is still on the request before
                pass
        caller = torch.cuda.current_stream(device)
        stream = _request_stream(device)
        stream.wait_stream(caller)
        for x in inputs:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(stream)   # the caller's memory, read on this stream
        with torch.cuda.stream(stream):
            out = _answer(model, smpl, device, *inputs)
            done = torch.cuda.Event()
            done.record(stream)
        for value in out.values():
            if isinstance(value, torch.Tensor):
                value.record_stream(caller)
        _LAST_DONE[device] = done
        return RequestOutputs(out, done, device)


def _boxes(boxes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, 4) cxcywh -> (boxes, centers, scales = max side / 200)."""
    dets = np.atleast_2d(np.asarray(boxes, np.float32))
    return dets, dets[:, :2], np.maximum(dets[:, 2], dets[:, 3]) / 200.0


def _fp16(x: torch.Tensor) -> torch.Tensor:
    """fp16 rounding on the device, back to fp32 (the JAX demo's compact fetch)."""
    return x.half().float()


class PocoTester:
    """Folder and video demo driver.

    Args:
        model: a POCO in eval mode; its device is the demo's device.
        smpl: SMPL weights on the same device.
        detector: person detector (see `demo.tracker`); full frame by default.
        batch_size: chunk size of the video path's forwards.
        kinematic_uncert: accumulate uncertainty down the kinematic chain
            for colours and logs (the reference demo forces it on unless
            --no_kinematic_uncert, tester.py:59).

    `stage_seconds` holds the host clock's seconds by stage (see the
    module's docstring): enqueue time and read-back waits for the card's
    stages, not their card time.
    """

    _FETCH_KEYS = (
        "smpl_vertices", "smpl_joints3d", "smpl_joints2d",
        "pred_pose", "pred_shape", "pred_cam", "var_pose",
    )

    def __init__(
        self,
        model: torch.nn.Module,
        smpl: SmplParams,
        detector: Detector = full_frame_detector,
        batch_size: int = 32,
        kinematic_uncert: bool = False,
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.smpl = smpl
        self.detector = detector
        self.batch_size = batch_size
        self.kinematic_uncert = kinematic_uncert
        self.backbone = model.cfg.backbone
        self.img_res = model.cfg.img_res
        self.loss_ver = model.cfg.loss_ver
        self.faces = smpl.faces.cpu().numpy()
        self.lbs_weights = smpl.all_lbs_weights.cpu().numpy()
        self.renderer = Renderer(self.faces)
        self.stage_seconds: Counter = Counter()
        self._display_warned = False

    @contextlib.contextmanager
    def _stage(self, name: str):
        start = time.perf_counter()
        try:
            with spans.span(name):
                yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - start

    def _display_frame(self, frame: np.ndarray) -> None:
        """Show a rendered frame in a cv2 window (reference tester.py:352,
        --display). Without cv2, a display server or a GUI backend in cv2,
        a one-time notice, and the run goes on. (On Linux with no DISPLAY or
        WAYLAND_DISPLAY the window is not tried: a Qt build of cv2 aborts
        the process there instead of raising.)"""
        cv2 = optional_cv2()
        headless = sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))
        if cv2 is not None and not headless:
            try:
                cv2.imshow("poco", frame[:, :, ::-1])
                cv2.waitKey(1)
                return
            except cv2.error:
                pass
        if not self._display_warned:
            print("--display requested but no GUI backend; skipping")
            self._display_warned = True

    @staticmethod
    def warmup_sizes(frame_hw: tuple[int, int] | None) -> set[tuple[int, int]]:
        """The frame sizes `warmup` runs: the frame's own and the tracking
        pass's (its long side downscaled to 512 px)."""
        h0, w0 = frame_hw or (256, 256)
        ds = min(1.0, 512.0 / max(h0, w0))
        return {(h0, w0), (int(round(h0 * ds)), int(round(w0 * ds)))}

    def warmup(self, frame_hw: tuple[int, int] | None = None) -> None:
        """One forward of a whole-frame box on a black frame at each of
        `warmup_sizes(frame_hw)`, on the tester's device and waited for, so
        that the kernels' build and cuDNN's first calls come before the
        video's frames are extracted (the JAX demo's `warmup` queues its
        programs' compiles there)."""
        for h, w in sorted(self.warmup_sizes(frame_hw)):
            frame = torch.zeros((h, w, 3), dtype=torch.uint8, device=self.device)
            _, centers, scales = _boxes(full_frame_detector(frame))
            detect_forward(self.model, self.smpl, frame, centers, scales)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _run_batches(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Forward a host batch in chunks of `batch_size`, vertices and
        joints rounded to fp16 on the device (`_forward_compact`)."""
        n = batch["img"].shape[0]
        outs: dict[str, list] = {}
        with torch.inference_mode():
            for s in range(0, n, self.batch_size):
                dev = {k: _on_device(v[s:s + self.batch_size], self.device, torch.float32)
                       for k, v in batch.items()}
                dev["img"] = normalize_image(dev["img"])
                out = self.model(dev, self.smpl)
                for k in self._FETCH_KEYS:
                    v = out.get(k)
                    if v is None:
                        continue
                    if k in ("smpl_vertices", "smpl_joints3d", "smpl_joints2d"):
                        v = _fp16(v)
                    outs.setdefault(k, []).append(v.float().cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}

    def _prep_uncert(self, out: dict) -> tuple[np.ndarray | None, np.ndarray | None]:
        if out.get("var_pose") is None:
            return None, None
        var = prepare_uncert(
            out["var_pose"], loss_ver=self.loss_ver, kinematic=self.kinematic_uncert
        )
        var = np.clip(var, 0.0, 1.0)
        gvar = global_uncert(var.copy(), backbone=self.backbone)
        return var, gvar

    def _joints2d_orig(self, j2d: np.ndarray, centers, sizes) -> np.ndarray:
        """CLIFF's 2D joints are full-image pixels already; other heads'
        are normalized crop coordinates (tester.py:216-233)."""
        if "cliff" in self.backbone:
            return j2d
        bbox_chw = np.concatenate([centers, np.asarray(sizes)[:, None]], axis=1)
        return convert_crop_coords_to_orig_img(bbox_chw, j2d, self.img_res)

    # ------------------------------------------------------------------
    def run_detector(self, image_files: list[str]) -> list[np.ndarray]:
        """Per-image detections (reference tester.py:140-151), read in
        chunks of 64."""
        if hasattr(self.detector, "detect_batch"):
            out: list[np.ndarray] = []
            for start in range(0, len(image_files), 64):
                with self._stage("decode"):
                    imgs = read_images_rgb(image_files[start:start + 64])
                with self._stage("detect"):
                    out.extend(self.detector.detect_batch(imgs))
            return out
        out = []
        for p in image_files:
            with self._stage("decode"):
                img = read_image_rgb(p)
            with self._stage("detect"):
                out.append(self.detector(img))
        return out

    def infer_keypoints(self, img: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        """Predicted 2D keypoints (original-image pixels) for each box, one
        fused crop + forward; feeds the refine detector."""
        return self.infer_keypoints_with_uncert(img, boxes)[0]

    def infer_keypoints_with_uncert(
        self, img: np.ndarray, boxes: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Keypoints and each box's global uncertainty, for the
        confidence-guided window detector (tracker.py)."""
        dets, centers, scales = _boxes(boxes)
        out = detect_forward(self.model, self.smpl, img, centers, scales)
        j2d = self._joints2d_orig(out["smpl_joints2d"].cpu().numpy(), centers, scales * 200.0)
        return j2d, self._global_uncert(out, len(dets))

    def _global_uncert(self, out: dict, n: int) -> np.ndarray:
        """(n,) global uncertainty of a forward's rows (zeros without an
        uncertainty head)."""
        var_pose = out.get("var_pose")
        _, gvar = self._prep_uncert({"var_pose": None if var_pose is None
                                     else var_pose.cpu().numpy()})
        return gvar if gvar is not None else np.zeros(n, np.float32)

    @torch.inference_mode()
    def infer_keypoints_batch(
        self,
        imgs: list[np.ndarray],
        boxes_list: list[np.ndarray],
        frames_per_dispatch: int = 8,
        return_uncert: bool = False,
    ) -> list[np.ndarray] | tuple[list[np.ndarray], list[np.ndarray]]:
        """`infer_keypoints` over many frames: the crops of up to
        `frames_per_dispatch` frames go through the model as one batch.
        Returns one (n_i, J, 2) array per frame (and one (n_i,) global
        uncertainty per frame with `return_uncert`); a frame without boxes
        gets empty arrays."""
        boxes_list = [np.asarray(b, np.float32).reshape(-1, 4) for b in boxes_list]
        out_j2d, out_gvar = [], []
        for start in range(0, len(imgs), frames_per_dispatch):
            sel = range(start, min(start + frames_per_dispatch, len(imgs)))
            parts = []
            for i in sel:
                if len(boxes_list[i]):
                    _, c, s = _boxes(boxes_list[i])
                    parts.append(preprocess_crops(
                        _on_device(imgs[i], self.device, torch.uint8),
                        _on_device(c, self.device, torch.float32),
                        _on_device(s, self.device, torch.float32),
                        out_res=self.img_res,
                    ))
            j2d = np.zeros((0, 0, 2), np.float32)
            gvar = np.zeros(0, np.float32)
            if parts:
                batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
                out = self.model(batch, self.smpl)
                j2d = out["smpl_joints2d"].cpu().numpy()
                if return_uncert:
                    gvar = self._global_uncert(out, len(j2d))
            row = 0
            for i in sel:
                n = len(boxes_list[i])
                ji = j2d[row:row + n]
                if n:
                    _, c, s = _boxes(boxes_list[i])
                    ji = self._joints2d_orig(ji, c, s * 200.0)
                out_j2d.append(ji)
                if return_uncert:
                    out_gvar.append(gvar[row:row + n])
                row += n
        if return_uncert:
            return out_j2d, out_gvar
        return out_j2d

    def make_refined_detector(self, base: Detector | None = None, iters: int = 1):
        """Proposals (the current detector by default) refined by the
        model's own predicted keypoints."""
        from .tracker import make_keypoint_refine_detector

        return make_keypoint_refine_detector(
            base or self.detector, self.infer_keypoints, iters=iters,
            infer_keypoints_batch=self.infer_keypoints_batch,
        )

    def make_uncert_detector(self, **kwargs):
        """Confidence-guided multi-person detector (no external weights):
        tiled proposals -> keypoint boxes -> uncertainty-scored NMS."""
        from .tracker import make_uncert_window_detector

        return make_uncert_window_detector(
            self.infer_keypoints_with_uncert,
            infer_batch=self.infer_keypoints_batch, **kwargs
        )

    # ------------------------------------------------------------------
    def infer_frame_dispatch(self, img: np.ndarray, dets: np.ndarray) -> dict[str, Any] | None:
        """Launch one frame's crop + forward without waiting for it: CUDA
        runs it asynchronously, so the caller may overlap host work until
        `infer_frame_finalize`. The heavy outputs are rounded to fp16 on
        the device (`_compact_stream`). None when there are no detections."""
        dets = np.atleast_2d(np.asarray(dets, np.float32))
        if dets.size == 0:
            return None
        dets, centers, scales = _boxes(dets)
        out = detect_forward(self.model, self.smpl, img, centers, scales)
        compact = {}
        for k in self._FETCH_KEYS:
            v = out.get(k)
            if v is not None:
                compact[k] = _fp16(v) if k in ("smpl_vertices", "smpl_joints3d") else v
        return {"out_dev": compact, "dets": dets, "centers": centers, "scales": scales,
                "h0": img.shape[0], "w0": img.shape[1], "n": len(dets)}

    def infer_frame_finalize(self, pending: dict[str, Any] | None) -> dict[str, Any]:
        """Fetch a dispatched frame's outputs and build its result dict
        (camera conversion, uncertainty). Blocks on the device."""
        if pending is None:
            return {}
        dets, centers, scales = pending["dets"], pending["centers"], pending["scales"]
        out = {k: v.float().cpu().numpy() for k, v in pending["out_dev"].items()}
        var, gvar = self._prep_uncert(out)
        bbox_chw = np.concatenate([centers, (scales * 200.0)[:, None]], axis=1)
        orig_cam = convert_crop_cam_to_orig_img(
            out["pred_cam"], bbox_chw, pending["w0"], pending["h0"]
        )
        return {
            "verts": out["smpl_vertices"],
            "pred_cam": out["pred_cam"],
            "orig_cam": orig_cam,
            "pose": out["pred_pose"],
            "betas": out["pred_shape"],
            "joints3d": out["smpl_joints3d"],
            "smpl_joints2d": self._joints2d_orig(out["smpl_joints2d"], centers, scales * 200.0),
            "bboxes": dets,
            "var": var,
            "var_global": gvar,
        }

    def infer_frame(self, img: np.ndarray, dets: np.ndarray) -> dict[str, Any]:
        """One frame through crop + forward: the per-frame core of the
        folder demo (reference tester.py:171-233). {} without detections."""
        return self.infer_frame_finalize(self.infer_frame_dispatch(img, dets))

    def _vertex_colors(self, var) -> np.ndarray:
        return get_vertex_colors(np.array(var, copy=True), self.lbs_weights,
                                 backbone=self.backbone)

    def run_on_image_folder(
        self,
        image_folder: str,
        output_folder: str | None = None,
        detections: list[np.ndarray] | None = None,
        render: bool = True,
        sideview: bool = False,
        save_obj: bool = False,
        uncert_color: bool = True,
        draw_keypoints: bool = False,
        skip_frame: int = 1,
        render_crop: bool = False,
        display: bool = False,
    ) -> list[dict[str, Any]]:
        """Folder demo (reference tester.py:153-360).

        For each image: detect, run crop + forward over all its detections
        at once, convert cameras and keypoints to original-image
        coordinates, and with `render` write the overlay under its input's
        own name and format (twice the width with `sideview`). skip_frame=N
        takes every Nth image; render_crop draws on the first detection's 224-px
        crop with the crop camera (tester.py:256-280); `draw_keypoints`
        marks the projected joints (`draw_keypoints_2d`); `display` shows
        each written frame (`_display_frame`).
        """
        image_files = images_in_folder(image_folder)[:: max(skip_frame, 1)]
        if detections is None:
            detections = self.run_detector(image_files)
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)

        results = []
        for img_path, dets in zip(image_files, detections):
            with self._stage("decode"):
                img = read_image_rgb(img_path)
            with self._stage("poco"):
                result = self.infer_frame(img, dets)
            results.append(result)
            if not result or not (render and output_folder):
                continue
            with self._stage("render"):
                frame = self._render_folder_frame(img, img_path, result, output_folder,
                                                  sideview, save_obj, uncert_color, render_crop,
                                                  draw_keypoints)
            with self._stage("write"):
                write_image(osp.join(output_folder, osp.basename(img_path)), frame)
            if display:
                self._display_frame(frame)
        return results

    def _render_folder_frame(self, img, img_path, result, output_folder, sideview,
                             with_obj, uncert_color, render_crop,
                             draw_keypoints=False) -> np.ndarray:
        dets = result["bboxes"]
        _, centers, scales = _boxes(dets)
        var = result["var"]
        if render_crop:
            from ..data.transforms import crop_image

            frame = crop_image(img, centers[0], scales[0])  # float32, as the JAX demo draws on
        else:
            frame = img.copy()
        # white sideview canvas, joined after the person loop (tester.py:274,348)
        side_frame = np.ones_like(frame) * 255 if sideview else None
        for pi in range(len(dets)):
            vc = self._vertex_colors(var[pi]) if uncert_color and var is not None else None
            if not render_crop or pi == 0:
                cam = result["pred_cam"][pi] if render_crop else result["orig_cam"][pi]
                frame = self.renderer.render(frame, result["verts"][pi], cam, vertex_colors=vc)
                if side_frame is not None:
                    # same camera, mesh turned 270 degrees about y (tester.py:336-346)
                    side_frame = self.renderer.render(
                        side_frame, result["verts"][pi], cam, vertex_colors=vc,
                        angle=270.0, axis=(0, 1, 0),
                    )
            if with_obj:
                save_obj(osp.join(output_folder, f"{osp.basename(img_path)}_{pi}.obj"),
                         result["verts"][pi], self.faces)
        if draw_keypoints:
            frame = draw_keypoints_2d(frame, result["smpl_joints2d"])
        if side_frame is not None:
            frame = np.concatenate([frame, side_frame], axis=1)
        return frame

    # ------------------------------------------------------------------
    def run_tracking(self, image_folder: str, cache_file: str | None = None) -> dict[int, dict]:
        """Track people across frames, with a pkl stage cache (reference
        demo.py:125-131)."""
        if cache_file and osp.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        with self._stage("detect"):
            tracks = run_tracking(images_in_folder(image_folder), self.detector)
        if cache_file:
            with open(cache_file, "wb") as f:
                pickle.dump(tracks, f)
        return tracks

    def run_on_video(
        self,
        image_folder: str,
        tracks: dict[int, dict] | None = None,
        smooth: bool = False,
        min_cutoff: float = 0.004,
        beta: float = 0.7,
    ) -> dict[int, dict]:
        """Video demo over extracted frames (reference tester.py:362-480).

        Returns dict[person_id] with per-frame verts / pose / betas /
        cameras / joints / uncertainty, ready for `render_results`.
        """
        if tracks is None:
            tracks = self.run_tracking(image_folder)
        image_files = images_in_folder(image_folder)
        if not image_files:
            return {}
        from ..runtime.loader import image_size

        h, w = image_size(image_files[0])
        results: dict[int, dict] = {}
        for person_id, track in tracks.items():
            dataset = InferenceDataset(
                image_folder,
                frames=track["frames"],
                bboxes=track.get("bbox"),
                joints2d=track.get("joints2d"),
                crop_size=self.img_res,
            )
            with self._stage("decode"):
                batch = dataset.load_all()
            if batch is None:
                continue
            batch.pop("frame_id")
            with self._stage("poco"):
                out = self._run_batches(batch)
            var, gvar = self._prep_uncert(out)
            if smooth:
                from ..utils.smooth_pose import smooth_pose

                with self._stage("smooth"):
                    verts, pose_hat, joints3d = smooth_pose(
                        out["pred_pose"], out["pred_shape"], self.smpl,
                        min_cutoff=min_cutoff, beta=beta,
                    )
                out["smpl_vertices"] = verts
                out["pred_pose"] = pose_hat
                out["smpl_joints3d"] = joints3d
            bbox_chw = np.concatenate(
                [batch["center"], (batch["scale"] * 200.0)[:, None]], axis=1
            )
            results[person_id] = {
                "verts": out["smpl_vertices"],
                "pose": out["pred_pose"],
                "betas": out["pred_shape"],
                "pred_cam": out["pred_cam"],
                "orig_cam": convert_crop_cam_to_orig_img(out["pred_cam"], bbox_chw, w, h),
                "joints3d": out["smpl_joints3d"],
                "smpl_joints2d": self._joints2d_orig(
                    out["smpl_joints2d"], batch["center"], batch["scale"] * 200.0),
                # the dataset's frames and boxes, not the raw track's: it
                # drops frames without a valid smoothed box
                "frame_ids": np.asarray(dataset.frames),
                "bboxes": dataset.bboxes,
                "var": var if var is not None else np.zeros(1),
                "var_global": gvar if gvar is not None else np.zeros(1),
            }
        return results

    def render_results(
        self,
        results: dict[int, dict],
        image_folder: str,
        output_folder: str,
        uncert_color: bool = True,
        wireframe: bool = False,
        uncert_log: str | None = None,
        display: bool = False,
        sideview: bool = False,
    ) -> None:
        """Depth-sorted per-frame rendering to `%06d.png` (reference
        tester.py:482-580), and the per-person global uncertainty log
        (`frame person value` lines). `wireframe` draws the meshes as face
        outlines; `sideview` renders the meshes turned 270 degrees on a
        black canvas with the "Other View" caption (`overlay_text`) beside
        each frame (tester.py:511,557-570). `display` shows each frame
        (`_display_frame`)."""
        image_files = images_in_folder(image_folder)
        os.makedirs(output_folder, exist_ok=True)
        frame_results = prepare_rendering_results(results, len(image_files))
        log_lines = []
        for frame_id, img_path in enumerate(image_files):
            with self._stage("decode"):
                frame = read_image_rgb(img_path)
            with self._stage("render"):
                side_frame = np.zeros_like(frame) if sideview else None
                for person_id, data in frame_results[frame_id].items():
                    vc = (self._vertex_colors(data["var"])
                          if uncert_color and data.get("var") is not None else None)
                    frame = self.renderer.render(frame, data["verts"], data["cam"],
                                                 vertex_colors=vc, wireframe=wireframe)
                    if side_frame is not None:
                        side_frame = self.renderer.render(
                            side_frame, data["verts"], data["cam"], vertex_colors=vc,
                            wireframe=wireframe, angle=270.0, axis=(0, 1, 0))
                    if data.get("var_global") is not None:
                        log_lines.append(
                            f"{frame_id} {person_id} {float(data['var_global']):.4f}"
                        )
                if side_frame is not None:
                    frame = np.concatenate([frame, overlay_text(side_frame, "Other View")],
                                           axis=1)
            with self._stage("write"):
                write_png(osp.join(output_folder, f"{frame_id:06d}.png"), frame)
            if display:
                self._display_frame(frame)
        if uncert_log:
            with open(uncert_log, "w") as f:
                f.write("\n".join(log_lines))
