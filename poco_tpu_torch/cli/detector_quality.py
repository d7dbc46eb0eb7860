"""The demo's detectors against ground-truth boxes (the port's counterpart
of the repo's `tools/detector_quality.py`).

    python -m poco_tpu_torch.cli.detector_quality --gt data/dataset_extras/conv_test.npz \\
        --img_root data [--cfg configs/convergence.yaml] [--ckpt X.pt | <logdir>] \\
        [--limit 100] [--iou 0.5] [--device cuda|cpu]

Recall at IoU and mean IoU of every detector the demo has, against GT
person boxes: `full_frame`, `hog` (the full frame on the port, which has
no OpenCV, as on any OpenCV build without HOG), `refine` (the model's own
keypoints around the full-frame proposal) and `uncert` (tiled windows
scored by the model's confidence), plus `yolo` when `demo/yolo.py` finds
yolov3.weights (licence-gated; not in the repo). The GT is any npz with
`imgname` (relative to --img_root) and either `bbox` (N, 4 cxcywh) or
`part` (N, K, 3 keypoints and confidence), the box then made from the
visible keypoints as the pose-tracking path makes it. The synthetic
convergence set (`cli.convergence_bench`) gives both a trained checkpoint
and exact GT. The model runs on `--device`; without `--ckpt` its weights
are random (torch seed 0). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..device import default_device


def iou_cxcywh(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two (cx, cy, w, h) boxes."""
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / union) if union > 0 else 0.0


def gt_boxes_from_npz(npz_path: str) -> tuple[list[str], list[np.ndarray]]:
    """The image names and each image's (n, 4) GT boxes: `bbox` as given,
    else the box of the visible `part` keypoints (`bbox_from_kp2d`; an
    image with fewer than two visible has none)."""
    from ..demo.tracker import bbox_from_kp2d

    d = np.load(npz_path, allow_pickle=True)
    names = [str(x) for x in d["imgname"]]
    if "bbox" in d.files:
        return names, [np.atleast_2d(b) for b in d["bbox"]]
    boxes = []
    for kp in d["part"]:
        # invisible joints are stored as (0, 0, 0): they would pull the
        # box's corner to the origin
        vis = kp[kp[:, 2] > 0.5]
        if len(vis) < 2:
            boxes.append(np.zeros((0, 4), np.float32))
            continue
        boxes.append(np.atleast_2d(bbox_from_kp2d(vis)))
    return names, boxes


def evaluate(detector, frames, gts, iou_thresh: float = 0.5) -> dict:
    """Recall at `iou_thresh` and mean IoU of the best detection for each
    GT box (a detector with `detect_batch` gets the frames at once)."""
    ious, hits, n_gt = [], 0, 0
    if hasattr(detector, "detect_batch"):
        dets = detector.detect_batch(frames)
    else:
        dets = [detector(f) for f in frames]
    for det, gt in zip(dets, gts):
        det = np.atleast_2d(np.asarray(det, np.float32))
        for g in gt:
            n_gt += 1
            best = max((iou_cxcywh(d, g) for d in det if d.size), default=0.0)
            ious.append(best)
            hits += best >= iou_thresh
    return {
        "recall": round(hits / max(n_gt, 1), 4),
        "mean_iou": round(float(np.mean(ious)) if ious else 0.0, 4),
        "n_gt": n_gt,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gt", required=True, help="npz with imgname and part or bbox")
    parser.add_argument("--img_root", required=True)
    parser.add_argument("--cfg", default="configs/convergence.yaml")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--limit", type=int, default=100)
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    args = parser.parse_args(argv)

    import torch

    from ..config import model_config_from_hparams, update_hparams
    from ..demo.tester import PocoTester
    from ..demo.tracker import full_frame_detector, hog_person_detector
    from ..demo.yolo import make_yolo_detector
    from ..device import resolve_device
    from ..models.poco import POCO
    from ..runtime.loader import read_image_rgb
    from ..smpl.assets import resolve_smpl_params
    from ..utils.checkpoint import load_checkpoint_into

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names, gts = gt_boxes_from_npz(args.gt)
    names, gts = names[: args.limit], gts[: args.limit]
    frames = [read_image_rgb(os.path.join(args.img_root, n)) for n in names]

    torch.manual_seed(0)
    model = POCO(model_config_from_hparams(update_hparams(args.cfg))).to(device).eval()
    if args.ckpt:
        load_checkpoint_into(model, args.ckpt)
    tester = PocoTester(model, resolve_smpl_params(None, "neutral", device))

    variants = {
        "full_frame": full_frame_detector,
        "hog": hog_person_detector,
        "refine": tester.make_refined_detector(full_frame_detector),
        "uncert": tester.make_uncert_detector(),
    }
    yolo = make_yolo_detector(None, device=device)
    if yolo is not None:
        variants["yolo"] = yolo

    results = {}
    for name, det in variants.items():
        results[name] = evaluate(det, frames, gts, args.iou)
        print(name, results[name], file=sys.stderr)
    out = {"iou_thresh": args.iou, "detectors": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
