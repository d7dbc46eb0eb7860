"""Person detection and multi-person box tracking for the demo (port of
`poco_tpu.demo.tracker`).

The reference shells out to external packages (yolov3-pytorch +
multi-person-tracker, pocolib/core/tester.py:113-151). The contract is
kept: `dict[person_id] -> {'bbox': (T, 4) cxcywh, 'frames': [frame_ids]}`
from a pluggable detector and a greedy-IoU tracker. No OpenCV: HOG
proposals are the full frame (as on any cv2 build without HOG), the
refine detector's downscale is `resize_area` (cv2's INTER_AREA weights,
written out), and the Mask R-CNN option is torchvision's model where
torchvision and a local weights file are there (`make_maskrcnn_detector`).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable

import numpy as np
import torch

Detector = Callable[[np.ndarray], np.ndarray]
"""(H, W, 3) RGB image -> (N, 4) cxcywh person boxes."""


def area_weights(src_size: int, dst_size: int) -> np.ndarray:
    """(dst, src) weights of cv2's INTER_AREA downscale along one axis
    (imgproc/resize.cpp `computeResizeAreaTab`): each output cell
    averages the source cells its span [d*s, (d+1)*s) covers, the partial
    cells at either end by the covered fraction."""
    scale = src_size / dst_size
    weights = np.zeros((dst_size, src_size), np.float64)
    for d in range(dst_size):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src_size - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src_size - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            weights[d, sx1 - 1] = (sx1 - fsx1) / cell
        weights[d, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            weights[d, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return weights


def resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8 by cv2's INTER_AREA
    downscale: separable area weights (`area_weights`), float sums,
    rounded to nearest (an exact halving as cv2's integer fast path,
    halves rounded up). cv2 sums in float32 in its own order, so a pixel
    may differ from it by one grey level. Downscale only."""
    h, w = img.shape[:2]
    if out_h > h or out_w > w:
        raise ValueError("resize_area downscales only")
    if (h, w) == (2 * out_h, 2 * out_w):
        # cv2's fast path for an exact halving: (sum of 2x2 + 2) >> 2
        x = np.asarray(img, np.int32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    wy = area_weights(h, out_h).astype(np.float32)
    wx = area_weights(w, out_w).astype(np.float32)
    x = np.asarray(img, np.float32)
    rows = np.tensordot(wy, x, axes=(1, 0))                   # (out_h, W, C)
    out = np.tensordot(wx, rows, axes=(1, 1)).transpose(1, 0, 2)  # (out_h, out_w, C)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def full_frame_detector(img: np.ndarray) -> np.ndarray:
    """Fallback detector: one box covering the whole frame.

    Matches the demo behavior when detection is unavailable — the subject
    is assumed framed (reference single-person fallback).
    """
    h, w = img.shape[:2]
    size = max(h, w) * 0.95
    return np.array([[w / 2.0, h / 2.0, size, size]], np.float32)


def hog_person_detector(img: np.ndarray) -> np.ndarray:
    """The full-frame proposal: the JAX package's HOG+SVM detector
    (`cv2.HOGDescriptor`) is what it returns on any OpenCV build without
    HOG, and the port has no OpenCV. The keypoint-refine wrapper then
    recovers a tight person box from the model's own predictions."""
    return full_frame_detector(img)


def make_maskrcnn_detector(score_thresh: float = 0.7, weights_path: str | None = None,
                           device: str | torch.device = "cpu") -> Detector | None:
    """torchvision's Mask R-CNN person detector (the reference's --detector
    maskrcnn, demo.py:258), as the JAX package's: the model on `device`
    when torchvision is installed and its weights are a local file
    (`weights_path`, else $POCO_TPU_MASKRCNN_WEIGHTS); None otherwise, and
    the CLI falls back with a notice. Nothing is downloaded: the JAX
    package's `weights="DEFAULT"` fetches them, the port does not."""
    try:
        import torchvision
    except ImportError:
        return None
    weights_path = weights_path or os.environ.get("POCO_TPU_MASKRCNN_WEIGHTS", "")
    if not weights_path or not os.path.isfile(weights_path):
        return None
    try:
        model = torchvision.models.detection.maskrcnn_resnet50_fpn(
            weights=None, weights_backbone=None)
        model.load_state_dict(torch.load(weights_path, map_location="cpu"))
    except (OSError, RuntimeError, pickle.UnpicklingError):
        return None   # not a Mask R-CNN state dict
    model = model.to(device).eval()

    def detect(img: np.ndarray) -> np.ndarray:
        ten = torch.from_numpy(
            np.ascontiguousarray(img, np.float32).transpose(2, 0, 1) / 255.0).to(device)
        with torch.no_grad():
            out = model([ten])[0]
        keep = (out["labels"] == 1) & (out["scores"] >= score_thresh)
        xyxy = out["boxes"][keep].cpu().numpy()
        if xyxy.size == 0:
            return np.zeros((0, 4), np.float32)
        cx = (xyxy[:, 0] + xyxy[:, 2]) / 2.0
        cy = (xyxy[:, 1] + xyxy[:, 3]) / 2.0
        w = xyxy[:, 2] - xyxy[:, 0]
        h = xyxy[:, 3] - xyxy[:, 1]
        return np.stack([cx, cy, w, h], axis=1).astype(np.float32)

    return detect


def tiled_window_proposals(
    img: np.ndarray,
    scales: tuple[float, ...] = (0.9, 0.55),
    stride_frac: float = 0.5,
    max_windows: int = 24,
) -> np.ndarray:
    """Multi-scale tiled square window proposals (detector-free).

    Feeds the confidence-guided detector below when no learned person
    detector is available.
    """
    h, w = img.shape[:2]
    boxes = []
    for s in scales:
        size = min(h, w) * s
        step = max(size * stride_frac, 1.0)
        ys = np.arange(size / 2, h - size / 2 + 1e-6, step)
        xs = np.arange(size / 2, w - size / 2 + 1e-6, step)
        if len(ys) == 0:
            ys = np.array([h / 2.0])
        if len(xs) == 0:
            xs = np.array([w / 2.0])
        for cy in ys:
            for cx in xs:
                boxes.append([cx, cy, size, size])
    boxes = np.asarray(boxes, np.float32)
    return boxes[:max_windows]


def nms_cxcywh(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45
) -> np.ndarray:
    """Greedy non-max suppression; returns kept indices (desc score)."""
    order = np.argsort(-scores)
    keep = []
    for i in order:
        if any(_iou(boxes[i], boxes[j]) > iou_threshold for j in keep):
            continue
        keep.append(int(i))
    return np.asarray(keep, np.int64)


def make_uncert_window_detector(
    infer_keypoints_with_uncert,
    scales: tuple[float, ...] = (0.9, 0.55),
    max_people: int = 6,
    uncert_quantile: float = 0.5,
    infer_batch=None,
) -> Detector:
    """Confidence-guided multi-person detection — POCO's own uncertainty
    as the person/no-person score, no external detector weights needed.

    Tiled window proposals are refined to keypoint-derived boxes by the
    pose model; windows whose predicted global uncertainty falls in the
    worst `uncert_quantile` are dropped, the rest deduped by IoU NMS.
    Quality tracks the trained checkpoint's confidence calibration (the
    paper's confident-frame selection, applied spatially).

    Args:
        infer_keypoints_with_uncert: (img, boxes) -> (kps (N, J, 2+),
            uncert (N,)) — PocoTester.infer_keypoints_with_uncert.
    """

    def _postprocess(img, kps, uncert):
        refined, scores = [], []
        for bi in range(len(kps)):
            bb = bbox_from_kp2d(np.asarray(kps[bi]))
            if bb[2] < 8 or bb[3] < 8 or not np.isfinite(bb).all():
                continue
            refined.append(bb)
            scores.append(-float(uncert[bi]))
        if not refined:
            return full_frame_detector(img)
        refined = np.stack(refined)
        scores = np.asarray(scores, np.float32)
        cutoff = np.quantile(scores, uncert_quantile)
        ok = scores >= cutoff
        refined, scores = refined[ok], scores[ok]
        keep = nms_cxcywh(refined, scores)[:max_people]
        return refined[keep]

    def detect(img: np.ndarray) -> np.ndarray:
        proposals = tiled_window_proposals(img, scales=scales)
        kps, uncert = infer_keypoints_with_uncert(img, proposals)
        return _postprocess(img, kps, uncert)

    if infer_batch is not None:
        def detect_batch(imgs: list[np.ndarray]) -> list[np.ndarray]:
            """Same windows scored across many frames with batched
            device dispatches (tester.infer_keypoints_batch with
            return_uncert); per-frame fallback on mixed sizes."""
            if len({im.shape for im in imgs}) != 1:
                return [detect(im) for im in imgs]
            proposals = tiled_window_proposals(imgs[0], scales=scales)
            kps_list, unc_list = infer_batch(
                imgs, [proposals] * len(imgs), return_uncert=True
            )
            return [
                _postprocess(im, kps, unc)
                for im, kps, unc in zip(imgs, kps_list, unc_list)
            ]

        detect.detect_batch = detect_batch

    return detect


def bbox_from_kp2d(kp2d: np.ndarray) -> np.ndarray:
    """(J, 2+) keypoints in image pixels -> (4,) cxcywh square bbox.

    Reference: vibe_image_utils.get_bbox_from_kp2d:310-328 — tight bound,
    squared to max(w, h), scaled 1.1x.
    """
    ul = kp2d[:, :2].min(axis=0)
    lr = kp2d[:, :2].max(axis=0)
    w, h = lr - ul
    c = ul + np.array([w, h]) / 2.0
    size = max(w, h) * 1.1
    return np.array([c[0], c[1], size, size], np.float32)


def make_keypoint_refine_detector(
    base: Detector,
    infer_keypoints,
    iters: int = 1,
    infer_keypoints_batch=None,
    detect_size: int = 512,
) -> Detector:
    """Model-in-the-loop detector: proposals from `base` are refined by
    running the pose model and re-deriving the bbox from the predicted
    2D keypoints — the pose-tracking-quality default (the same bbox
    derivation the reference uses for `--tracking_method pose`,
    inference.py:58-67), without needing an external keypoint binary.

    Args:
        base: proposal detector (e.g. hog_person_detector).
        infer_keypoints: (img RGB, boxes (N,4) cxcywh) -> (N, J, 2+)
            predicted 2D keypoints in ORIGINAL-image pixels (the
            tester's fused crop+forward provides this).
        iters: refinement rounds.
    """

    def detect(img: np.ndarray) -> np.ndarray:
        boxes = np.atleast_2d(np.asarray(base(img), np.float32))
        if boxes.size == 0:
            return boxes.reshape(0, 4)
        h, w = img.shape[:2]
        for _ in range(iters):
            kps = infer_keypoints(img, boxes)
            refined = []
            for bi in range(len(boxes)):
                bb = bbox_from_kp2d(np.asarray(kps[bi]))
                # clamp center into the frame; keep the proposal if the
                # model's keypoints collapsed (degenerate box)
                if bb[2] < 8 or bb[3] < 8 or not np.isfinite(bb).all():
                    refined.append(boxes[bi])
                    continue
                bb[0] = np.clip(bb[0], 0, w)
                bb[1] = np.clip(bb[1], 0, h)
                refined.append(bb)
            boxes = np.stack(refined)
        return boxes

    if infer_keypoints_batch is not None:
        def detect_batch(imgs: list[np.ndarray]) -> list[np.ndarray]:
            """Refine proposals for many frames with batched device
            dispatches (tester.infer_keypoints_batch); falls back to
            per-frame when frame sizes differ.

            Frames are downscaled to `detect_size` on the long side for
            the detection pass only (the reference detects at
            yolo_img_size=416 on full-res frames the same way,
            demo.py:260-262) — the refined boxes are mapped back to
            original coordinates and the model later crops from the
            full-resolution frames.
            """
            if len({im.shape for im in imgs}) != 1:
                return [detect(im) for im in imgs]
            h, w = imgs[0].shape[:2]
            ds = min(1.0, detect_size / max(h, w))
            if ds < 1.0:
                small = [
                    resize_area(im, int(round(h * ds)), int(round(w * ds)))
                    for im in imgs
                ]
            else:
                small = imgs
            boxes_list = [
                np.atleast_2d(np.asarray(base(im), np.float32))
                for im in small
            ]
            for _ in range(iters):
                kps = infer_keypoints_batch(small, boxes_list)
                nxt = []
                for bi, (boxes, kp) in enumerate(zip(boxes_list, kps)):
                    if len(boxes) == 0:
                        nxt.append(boxes.reshape(0, 4))
                        continue
                    refined = []
                    for di in range(len(boxes)):
                        bb = bbox_from_kp2d(np.asarray(kp[di]))
                        if (
                            bb[2] < 8 or bb[3] < 8
                            or not np.isfinite(bb).all()
                        ):
                            refined.append(boxes[di])
                            continue
                        bb[0] = np.clip(bb[0], 0, w * ds)
                        bb[1] = np.clip(bb[1], 0, h * ds)
                        refined.append(bb)
                    nxt.append(np.stack(refined))
                boxes_list = nxt
            # map the refined boxes back to original-frame coordinates
            return [b / ds for b in boxes_list]

        detect.detect_batch = detect_batch

    return detect


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two cxcywh boxes."""
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


class IouTracker:
    """Greedy IoU association tracker over per-frame detections."""

    def __init__(self, iou_threshold: float = 0.3, max_age: int = 10):
        self.iou_threshold = iou_threshold
        self.max_age = max_age

    def track(
        self, detections_per_frame: list[np.ndarray]
    ) -> dict[int, dict]:
        """Associate detections into tracklets.

        Args:
            detections_per_frame: list over frames of (N_i, 4) cxcywh.
        Returns:
            dict[person_id] -> {'bbox': (T, 4), 'frames': (T,) int array}
            (the reference MPT output contract, tester.py:126-137).
        """
        next_id = 0
        active: dict[int, dict] = {}   # id -> {box, age}
        tracks: dict[int, dict] = {}

        for frame_id, dets in enumerate(detections_per_frame):
            dets = np.atleast_2d(np.asarray(dets, np.float32))
            if dets.size == 0:
                dets = np.zeros((0, 4), np.float32)
            unmatched = list(range(len(dets)))
            # age out stale tracks
            for tid in list(active):
                active[tid]["age"] += 1
                if active[tid]["age"] > self.max_age:
                    del active[tid]
            # greedy match by IoU
            pairs = []
            for tid, tr in active.items():
                for di in unmatched:
                    pairs.append((_iou(tr["box"], dets[di]), tid, di))
            pairs.sort(reverse=True)
            used_t, used_d = set(), set()
            for iou, tid, di in pairs:
                if iou < self.iou_threshold:
                    break
                if tid in used_t or di in used_d:
                    continue
                used_t.add(tid)
                used_d.add(di)
                active[tid].update(box=dets[di], age=0)
                tracks[tid]["bbox"].append(dets[di])
                tracks[tid]["frames"].append(frame_id)
            # new tracks
            for di in unmatched:
                if di in used_d:
                    continue
                tid = next_id
                next_id += 1
                active[tid] = {"box": dets[di], "age": 0}
                tracks[tid] = {"bbox": [dets[di]], "frames": [frame_id]}

        return {
            tid: {
                "bbox": np.asarray(tr["bbox"], np.float32),
                "frames": np.asarray(tr["frames"], np.int64),
            }
            for tid, tr in tracks.items()
            if len(tr["frames"]) > 0
        }


def run_tracking(
    image_files: list[str],
    detector: Detector = full_frame_detector,
    min_num_frames: int = 1,
) -> dict[int, dict]:
    """Detect + track across an extracted frame folder.

    Mirrors POCOTester.run_tracking (tester.py:113-138) including the
    minimum tracklet length filter.
    """
    from ..runtime.loader import read_image_rgb, read_images_rgb

    if hasattr(detector, "detect_batch"):
        # batched device detector (e.g. YoloDetector): one jitted
        # program per tracker batch instead of one dispatch per frame.
        # Frames are read in bounded chunks so long videos do not need
        # the whole sequence decoded in RAM at once.
        dets = []
        CHUNK = 64
        for start in range(0, len(image_files), CHUNK):
            imgs = read_images_rgb(image_files[start:start + CHUNK])
            dets.extend(detector.detect_batch(imgs))
    else:
        dets = []
        for path in image_files:
            dets.append(detector(read_image_rgb(path)))
    tracks = IouTracker().track(dets)
    return {
        tid: tr for tid, tr in tracks.items()
        if len(tr["frames"]) >= min_num_frames
    }
