"""YOLOv3 person detector (NCHW torch) with a Darknet `.weights` loader
(port of `poco_tpu.demo.yolo`).

The reference delegates person detection to the external `yolov3-pytorch`
package (pocolib/core/tester.py:113-151; demo flags `--detector yolo
--yolo_img_size 416`). Here the letterbox, the network (Darknet-53 and
three detection heads, fp32 convolutions on cuDNN) and the box decode
run on the model's device; the threshold, top-k, NMS and un-letterboxing
stay on the host. Weights load from the official Darknet binary format
(`yolov3.weights`), which is not in the repo: `make_yolo_detector` looks
for it and returns None without it. The architecture follows the public
YOLOv3 paper and cfg (Redmon & Farhadi, 2018).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

# Standard YOLOv3 anchors (pixels, relative to the 416 training input),
# grouped coarse -> fine to match the order detection maps are emitted.
YOLO_ANCHORS: tuple[tuple[tuple[float, float], ...], ...] = (
    ((116, 90), (156, 198), (373, 326)),  # stride 32
    ((30, 61), (62, 45), (59, 119)),      # stride 16
    ((10, 13), (16, 30), (33, 23)),       # stride 8
)

PERSON_CLASS = 0  # COCO class index used by the reference demo

# Conv indices of the three detection convs (bias, no BN) in cfg order.
DETECT_CONV_IDS = (58, 66, 74)
NUM_CONVS = 75


class YoloV3(nn.Module):
    """Darknet-53 + 3-scale YOLOv3 detection heads, NCHW.

    The convolutions are named ``conv0..conv74`` and their batch norms
    ``bn0..bn73`` in the order of the official Darknet cfg, which is also
    the serialization order of ``yolov3.weights`` and the JAX package's
    naming; `load_darknet_weights` walks the same order.

    Args:
        width: base filter count (32 for the real network; tests shrink it).
        num_classes: detection classes (80 for COCO weights).
    """

    def __init__(self, width: int = 32, num_classes: int = 80):
        super().__init__()
        self.width = width
        self.num_classes = num_classes
        w = width
        self._plan: list = []          # (kind, args) in forward order
        cin = 3

        def cb(filters, kernel, stride):
            nonlocal cin
            i = self._add_conv(cin, filters, kernel, stride, bn=True)
            cin = filters
            return ("cb", i)

        def detect():
            return ("detect", self._add_conv(cin, 3 * (5 + num_classes), 1, 1, bn=False))

        def res(filters):
            a = cb(filters, 1, 1)
            b = cb(filters * 2, 3, 1)
            return ("res", (a[1], b[1]))

        plan = self._plan
        plan += [cb(w, 3, 1), cb(2 * w, 3, 2), res(w), cb(4 * w, 3, 2)]
        plan += [res(2 * w) for _ in range(2)]
        plan += [cb(8 * w, 3, 2)] + [res(4 * w) for _ in range(8)] + [("save", "route36")]
        plan += [cb(16 * w, 3, 2)] + [res(8 * w) for _ in range(8)] + [("save", "route61")]
        plan += [cb(32 * w, 3, 2)] + [res(16 * w) for _ in range(4)]
        # scale 0 head (stride 32)
        for _ in range(2):
            plan += [cb(16 * w, 1, 1), cb(32 * w, 3, 1)]
        plan += [cb(16 * w, 1, 1), ("save", "branch0"), cb(32 * w, 3, 1), detect(), ("out", None)]
        # scale 1 head (stride 16)
        cin = 16 * w
        plan += [("load", "branch0"), cb(8 * w, 1, 1), ("upcat", "route61")]
        cin = 8 * w + 16 * w
        for _ in range(2):
            plan += [cb(8 * w, 1, 1), cb(16 * w, 3, 1)]
        plan += [cb(8 * w, 1, 1), ("save", "branch1"), cb(16 * w, 3, 1), detect(), ("out", None)]
        # scale 2 head (stride 8)
        cin = 8 * w
        plan += [("load", "branch1"), cb(4 * w, 1, 1), ("upcat", "route36")]
        cin = 4 * w + 8 * w
        for _ in range(2):
            plan += [cb(4 * w, 1, 1), cb(8 * w, 3, 1)]
        plan += [cb(4 * w, 1, 1), cb(8 * w, 3, 1), detect(), ("out", None)]
        assert self._num_convs == NUM_CONVS

    _num_convs = 0

    def _add_conv(self, cin: int, cout: int, kernel: int, stride: int, bn: bool) -> int:
        i = self._num_convs
        self._num_convs = i + 1
        pad = (kernel - 1) // 2
        self.add_module(f"conv{i}", nn.Conv2d(cin, cout, kernel, stride, pad, bias=not bn))
        if bn:
            self.add_module(f"bn{i}", nn.BatchNorm2d(cout, eps=1e-5))
        return i

    def _cb(self, y: torch.Tensor, i: int) -> torch.Tensor:
        y = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y))
        return F.leaky_relu(y, 0.1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, 3, S, S) RGB in [0, 1] -> three raw (B, 3*(5+C), S/s, S/s)
        maps, strides 32, 16, 8."""
        saved, outs, y = {}, [], x
        for kind, arg in self._plan:
            if kind == "cb":
                y = self._cb(y, arg)
            elif kind == "res":
                y = y + self._cb(self._cb(y, arg[0]), arg[1])
            elif kind == "detect":
                y = getattr(self, f"conv{arg}")(y)
            elif kind == "save":
                saved[arg] = y
            elif kind == "load":
                y = saved[arg]
            elif kind == "upcat":
                y = torch.cat([F.interpolate(y, scale_factor=2, mode="nearest"), saved[arg]],
                              dim=1)
            else:  # "out"
                outs.append(y)
        return tuple(outs)


def load_darknet_weights(path: str, model: YoloV3) -> YoloV3:
    """Load an official Darknet `.weights` file into `model`, in place.

    Binary layout: a header of 3 int32 (major, minor, revision), a "seen"
    counter (int64 when major*10+minor >= 2, else int32), then raw
    float32 parameters in cfg order: for each BN conv [bn_bias, bn_scale,
    bn_mean, bn_var, kernel (OIHW)]; for each detection conv [bias,
    kernel (OIHW)]. A file of another width or class count does not fit
    exactly and raises.
    """
    with open(path, "rb") as f:
        major, minor, _rev = np.fromfile(f, np.int32, 3)
        if int(major) * 10 + int(minor) >= 2:
            np.fromfile(f, np.int64, 1)
        else:
            np.fromfile(f, np.int32, 1)
        buf = np.fromfile(f, np.float32)
    pos = 0

    def take(shape) -> torch.Tensor:
        nonlocal pos
        n = int(np.prod(shape))
        out = buf[pos:pos + n]
        if out.size != n:
            raise ValueError(
                f"darknet weights file truncated: need {n} floats at "
                f"offset {pos}, have {buf.size - pos}"
            )
        pos += n
        return torch.from_numpy(out.reshape(shape).copy())

    state = {}
    for i in range(NUM_CONVS):
        conv = getattr(model, f"conv{i}")
        cout = conv.out_channels
        if i in DETECT_CONV_IDS:
            state[f"conv{i}.bias"] = take((cout,))
        else:
            state[f"bn{i}.bias"] = take((cout,))
            state[f"bn{i}.weight"] = take((cout,))
            state[f"bn{i}.running_mean"] = take((cout,))
            state[f"bn{i}.running_var"] = take((cout,))
        state[f"conv{i}.weight"] = take(tuple(conv.weight.shape))
    if pos != buf.size:
        raise ValueError(
            f"darknet weights file has {buf.size - pos} unread floats: "
            f"architecture/width mismatch (width {model.width}, "
            f"{model.num_classes} classes)"
        )
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model


def save_darknet_weights(model: YoloV3, path: str) -> None:
    """Write `model`'s weights as a Darknet `.weights` file (version 0.2),
    in the layout `load_darknet_weights` reads."""
    parts = []
    for i in range(NUM_CONVS):
        conv = getattr(model, f"conv{i}")
        if i in DETECT_CONV_IDS:
            parts.append(conv.bias)
        else:
            bn = getattr(model, f"bn{i}")
            parts += [bn.bias, bn.weight, bn.running_mean, bn.running_var]
        parts.append(conv.weight)
    flat = torch.cat([t.detach().float().cpu().reshape(-1) for t in parts]).numpy()
    with open(path, "wb") as f:
        f.write(np.array([0, 2, 0], np.int32).tobytes())
        f.write(np.zeros(1, np.int64).tobytes())
        f.write(flat.astype(np.float32).tobytes())


def decode_predictions(
    p: torch.Tensor,
    anchors: Sequence[tuple[float, float]],
    stride: int,
    num_classes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw (B, 3*(5+C), H, W) map -> (boxes cxcywh px, person score).

    Standard YOLOv3 decode: xy = (sigmoid(t_xy) + cell) * stride,
    wh = anchor * exp(t_wh), score = sigmoid(obj) * sigmoid(cls).
    Returns boxes (B, H*W*3, 4) and person scores (B, H*W*3), rows in the
    JAX package's (y, x, anchor) order.
    """
    b, _, h, w = p.shape
    p = p.permute(0, 2, 3, 1).reshape(b, h, w, 3, 5 + num_classes)
    cy, cx = torch.meshgrid(
        torch.arange(h, dtype=p.dtype, device=p.device),
        torch.arange(w, dtype=p.dtype, device=p.device),
        indexing="ij",
    )
    anc = torch.as_tensor(anchors, dtype=p.dtype, device=p.device)  # (3, 2) in input pixels
    xy = (torch.sigmoid(p[..., 0:2]) + torch.stack([cx, cy], dim=-1)[:, :, None, :]) * stride
    wh = anc * torch.exp(p[..., 2:4].clamp(-10.0, 10.0))
    obj = torch.sigmoid(p[..., 4])
    cls = torch.sigmoid(p[..., 5 + PERSON_CLASS])
    boxes = torch.cat([xy, wh], dim=-1).reshape(b, -1, 4)
    scores = (obj * cls).reshape(b, -1)
    return boxes, scores


def letterbox(
    img, size: int, fill: float = 0.5, device=None
) -> tuple[torch.Tensor, float, float, float]:
    """Aspect-preserving resize + pad to (size, size), RGB in [0, 1], on
    `device` (the image's own for a tensor, else the CPU).

    The resize is bilinear with half-pixel centres, as cv2's INTER_LINEAR
    (the JAX package's `letterbox`), rounded to 8 bits as cv2 rounds its
    uint8 output; cv2 weighs in 11-bit fixed point and this in float, so
    a pixel may differ by one grey level. Returns (canvas (size, size, 3)
    float32, scale, pad_x, pad_y): detections map back via
    orig = (net - pad) / scale.
    """
    image = torch.as_tensor(np.ascontiguousarray(img) if isinstance(img, np.ndarray) else img,
                            device=device)
    h, w = image.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = image.permute(2, 0, 1)[None].float()
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
        x = x.round().clamp(0, 255)
    canvas = torch.full((size, size, 3), fill, dtype=torch.float32, device=image.device)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = x[0].permute(1, 2, 0) / 255.0
    return canvas, scale, float(pad_x), float(pad_y)


class YoloDetector:
    """Person detector honouring the tracker's `Detector` contract.

    On the device: letterbox, forward and the 3-scale decode. On the
    host: confidence threshold, top-k, NMS and un-letterboxing.
    """

    def __init__(
        self,
        weights_path: str,
        img_size: int = 416,
        conf_threshold: float = 0.5,
        nms_threshold: float = 0.45,
        batch_size: int = 12,
        width: int = 32,
        num_classes: int = 80,
        pre_nms_topk: int = 200,
        device="cuda",
    ):
        if img_size % 32 != 0:
            raise ValueError("yolo_img_size must be a multiple of 32")
        self.device = resolve_device(device)
        self.img_size = img_size
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.batch_size = batch_size
        self.pre_nms_topk = pre_nms_topk  # cap the O(n^2) host NMS
        self.model = load_darknet_weights(
            weights_path, YoloV3(width=width, num_classes=num_classes)
        ).to(self.device).eval()

    @torch.inference_mode()
    def forward_decode(self, canvases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, S, S, 3) letterboxed canvases on the device -> boxes
        (B, N, 4) cxcywh in canvas pixels and person scores (B, N)."""
        maps = self.model(canvases.permute(0, 3, 1, 2))
        decoded = [
            decode_predictions(p, YOLO_ANCHORS[si], 32 // (2 ** si), self.model.num_classes)
            for si, p in enumerate(maps)
        ]
        return (torch.cat([d[0] for d in decoded], dim=1),
                torch.cat([d[1] for d in decoded], dim=1))

    def letterbox_batch(self, imgs: list[np.ndarray]):
        """Letterboxed (B, S, S, 3) canvases on the device and each
        image's (scale, pad_x, pad_y)."""
        boxed = [letterbox(img, self.img_size, device=self.device) for img in imgs]
        return torch.stack([b[0] for b in boxed]), [b[1:] for b in boxed]

    def postprocess(self, boxes: np.ndarray, scores: np.ndarray, meta) -> np.ndarray:
        """One image's decoded rows -> (N, 4) cxcywh boxes in its pixels."""
        from .tracker import nms_cxcywh

        scale, px, py = meta
        keep = scores >= self.conf_threshold
        bx, sc = boxes[keep], scores[keep]
        if bx.size == 0:
            return np.zeros((0, 4), np.float32)
        if len(sc) > self.pre_nms_topk:
            top = np.argpartition(-sc, self.pre_nms_topk)[: self.pre_nms_topk]
            bx, sc = bx[top], sc[top]
        bx[:, 0] = (bx[:, 0] - px) / scale
        bx[:, 1] = (bx[:, 1] - py) / scale
        bx[:, 2:] /= scale
        return bx[nms_cxcywh(bx, sc, self.nms_threshold)]

    def detect_batch(self, imgs: list[np.ndarray]) -> list[np.ndarray]:
        """RGB uint8 images -> list of (N_i, 4) cxcywh person boxes."""
        out: list[np.ndarray] = []
        for start in range(0, len(imgs), self.batch_size):
            canvases, metas = self.letterbox_batch(imgs[start:start + self.batch_size])
            boxes, scores = self.forward_decode(canvases)
            boxes = boxes.cpu().numpy()
            scores = scores.cpu().numpy()
            out.extend(self.postprocess(b, s, m) for b, s, m in zip(boxes, scores, metas))
        return out

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return self.detect_batch([img])[0]


def default_weights_candidates(weights_path: str | None = None) -> list[str | None]:
    """Where the Darknet file is looked for, in order: the given path,
    $POCO_TPU_YOLO_WEIGHTS, then data/detector/yolov3.weights in the repo."""
    return [
        weights_path,
        os.environ.get("POCO_TPU_YOLO_WEIGHTS"),
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "data", "detector", "yolov3.weights",
        ),
    ]


def make_yolo_detector(
    weights_path: str | None = None, **kwargs
) -> YoloDetector | None:
    """The YOLO detector on the first weights file found
    (`default_weights_candidates`), else None."""
    for cand in default_weights_candidates(weights_path):
        if cand and os.path.isfile(cand):
            return YoloDetector(cand, **kwargs)
    return None
