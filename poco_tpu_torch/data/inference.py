"""Demo-time datasets: per-tracklet video crops and image folders (port of
`poco_tpu.data.inference`; reference pocolib/dataset/inference.py:31-197).

Items carry the full CLIFF input set (crop, bbox_info, focal_length,
scale, center, orig_shape). Pixels come from the port's loader: a whole
tracklet through `runtime/loader.batch_decode_crop` (decode and crop on a
C++ thread pool), one item through `read_image_rgb` and
`transforms.crop_image`. No OpenCV.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Sequence

import numpy as np

from ..constants import IMG_RES
from ..runtime import loader
from ..utils.smooth_bbox import get_smooth_bbox_params
from .dataset import calculate_bbox_info_np
from .transforms import crop_image


def images_in_folder(folder: str) -> list[str]:
    exts = (".png", ".jpg", ".jpeg")
    return sorted(
        osp.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith(exts)
    )


def _item(img: np.ndarray, bbox: np.ndarray, scale_factor: float, crop_size: int) -> dict:
    orig_shape = np.array(img.shape[:2], np.float32)
    center = bbox[:2].astype(np.float32)
    scale = np.float32(max(bbox[2], bbox[3]) * scale_factor / 200.0)
    crop = crop_image(img, center, float(scale), crop_size)
    return {
        "img": crop.astype(np.float32),
        "scale": scale,
        "center": center,
        "orig_shape": orig_shape,
        "focal_length": np.float32(np.sqrt(orig_shape[0] ** 2 + orig_shape[1] ** 2)),
        "bbox_info": calculate_bbox_info_np(center, scale, orig_shape),
    }


class InferenceDataset:
    """One person tracklet over video frames.

    Args:
        image_folder: extracted frame directory.
        frames: frame indices where the person is present.
        bboxes: (T, 4) cxcywh person boxes, or None when `joints2d` given.
        joints2d: optional (T, K, 3) keypoint track: boxes are derived and
            smoothed from it (reference inference.py:58-67).
        scale_factor: bbox enlargement (reference default 1.1).
    """

    def __init__(
        self,
        image_folder: str,
        frames: Sequence[int],
        bboxes: np.ndarray | None = None,
        joints2d: np.ndarray | None = None,
        scale_factor: float = 1.1,
        crop_size: int = IMG_RES,
    ):
        self.image_files = np.array(images_in_folder(image_folder))
        self.frames = np.asarray(frames)
        self.joints2d = joints2d
        self.scale_factor = scale_factor
        self.crop_size = crop_size

        if bboxes is None and joints2d is not None:
            params, start, end = get_smooth_bbox_params(list(joints2d), vis_thresh=0.3)
            # params covers frames 0..end (zero rows before `start`); keep
            # only frames with a real smoothed box: a zero scale row would
            # divide to inf below
            valid = params[:, 2] > 0
            params = params[valid]
            cxcy = params[:, :2]
            # the scale param is 150 / person height -> box edge
            size = 150.0 / params[:, 2:3] * 1.2
            bboxes = np.concatenate([cxcy, size, size], axis=1)
            self.frames = self.frames[np.nonzero(valid)[0]]
        self.bboxes = np.asarray(bboxes, np.float32)
        assert len(self.bboxes) == len(self.frames), (
            f"bbox/frame mismatch: {len(self.bboxes)} vs {len(self.frames)}"
        )

    def __len__(self) -> int:
        return len(self.frames)

    def load_all(self, num_threads: int = 0) -> dict | None:
        """The whole tracklet as one stacked batch (the per-item dict's
        keys), decoded and cropped by the loader's thread pool; None for
        an empty tracklet. A file the loader cannot decode raises."""
        paths = [str(self.image_files[f]) for f in self.frames]
        if not paths:
            return None
        # per-frame dims from the headers: CLIFF's conditioning follows
        # each frame's own size even when sizes differ mid-tracklet
        orig_shapes = np.array([loader.image_size(p) for p in paths], np.float32)
        centers = np.ascontiguousarray(self.bboxes[:, :2], np.float32)
        bbox_sizes = (
            np.maximum(self.bboxes[:, 2], self.bboxes[:, 3]) * self.scale_factor
        ).astype(np.float32)
        crops = loader.batch_decode_crop(paths, centers, bbox_sizes, self.crop_size,
                                         num_threads)
        scales = bbox_sizes / 200.0
        return {
            "img": crops,
            "scale": scales,
            "center": centers,
            "orig_shape": orig_shapes,
            "focal_length": np.sqrt(
                orig_shapes[:, 0] ** 2 + orig_shapes[:, 1] ** 2
            ).astype(np.float32),
            "bbox_info": np.stack([
                calculate_bbox_info_np(c, s, o)
                for c, s, o in zip(centers, scales, orig_shapes)
            ]),
            "frame_id": self.frames.astype(np.int32),
        }

    def __getitem__(self, idx: int) -> dict:
        img = loader.read_image_rgb(self.image_files[self.frames[idx]])
        item = _item(img, self.bboxes[idx], self.scale_factor, self.crop_size)
        item["frame_id"] = np.int32(self.frames[idx])
        return item


class ImageFolderDataset:
    """All detections across an image folder (reference inference.py:138-197).

    Args:
        detections: list (per image) of (N_i, 4) cxcywh boxes.
    """

    def __init__(
        self,
        image_folder: str,
        detections: list[np.ndarray],
        scale_factor: float = 1.0,
        crop_size: int = IMG_RES,
    ):
        self.image_files = images_in_folder(image_folder)
        self.crop_size = crop_size
        self.scale_factor = scale_factor
        self.index: list[tuple[int, np.ndarray]] = []
        for img_idx, dets in enumerate(detections):
            for det in np.atleast_2d(np.asarray(dets, np.float32)):
                if det.size:
                    self.index.append((img_idx, det))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> dict:
        img_idx, bbox = self.index[idx]
        img = loader.read_image_rgb(self.image_files[img_idx])
        item = _item(img, bbox, self.scale_factor, self.crop_size)
        item["img_idx"] = np.int32(img_idx)
        return item
