"""Demo pipeline utilities (port of `poco_tpu.utils.demo_utils`; reference
pocolib/utils/demo_utils.py:183-315): video I/O through ffmpeg, camera
and keypoint conversions, depth-sorted render preparation.

Video I/O needs `ffmpeg` on PATH and raises without it: the JAX package's
`cv2.VideoCapture` / `VideoWriter` branch has no counterpart here (the
port runs without OpenCV). Frames are extracted as JPEG (`-qscale:v 2`),
the format every route of the port's loader decodes. YouTube download is
not ported: it needs the network (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
import subprocess
from collections import OrderedDict

import numpy as np

from ..data.transforms import convert_crop_coords_to_orig_img  # noqa: F401 (re-exported)


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _require_ffmpeg(what: str) -> None:
    if not has_ffmpeg():
        raise RuntimeError(
            f"{what} needs ffmpeg on PATH (the port has no OpenCV video "
            "fallback); give --image_folder a directory of frames instead"
        )


def video_to_images(
    vid_file: str, img_folder: str | None = None, return_info: bool = False
):
    """Extract a video's frames as `%06d.jpg` (reference
    demo_utils.py:183-208), stale frames of an earlier extraction removed
    first. With `return_info`, returns (folder, frame count, (h, w, 3))."""
    _require_ffmpeg("video_to_images")
    if img_folder is None:
        raise ValueError("video_to_images needs an output folder")
    os.makedirs(img_folder, exist_ok=True)
    for f in os.listdir(img_folder):
        if f.lower().endswith((".png", ".jpg", ".jpeg")):
            os.remove(osp.join(img_folder, f))
    subprocess.run(
        ["ffmpeg", "-i", vid_file, "-f", "image2", "-v", "error",
         "-qscale:v", "2", f"{img_folder}/%06d.jpg"],
        check=True,
    )
    if return_info:
        from ..runtime.loader import image_size

        frames = sorted(os.listdir(img_folder))
        h, w = image_size(osp.join(img_folder, frames[0]))
        return img_folder, len(frames), (h, w, 3)
    return img_folder


def images_to_video(
    img_folder: str, output_vid_file: str, fps: int = 30,
    pattern: str = "%06d.png",
) -> None:
    """Assemble frames into an H.264 mp4 (reference demo_utils.py:237-246)."""
    _require_ffmpeg("images_to_video")
    os.makedirs(osp.dirname(output_vid_file) or ".", exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-framerate", str(fps), "-threads", "16", "-i",
         f"{img_folder}/{pattern}", "-profile:v", "baseline", "-level",
         "3.0", "-c:v", "libx264", "-pix_fmt", "yuv420p", "-an", "-v",
         "error", output_vid_file],
        check=True,
    )


def convert_crop_cam_to_orig_img(
    cam: np.ndarray, bbox: np.ndarray, img_width: float, img_height: float
) -> np.ndarray:
    """Weak-perspective crop camera -> original-image ortho camera
    (reference demo_utils.py:249-266).

    Args:
        cam: (N, 3) [s, tx, ty] in crop coords.
        bbox: (N, 3+) rows (cx, cy, h).
    Returns:
        (N, 4) [sx, sy, tx, ty] in original-image coords.
    """
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty]).T


def split_into_chunks(frame_ids, seqlen: int, stride: int) -> list:
    """(start, end) index pairs of overlapping fixed-length windows over a
    track, the last one flush with its end (reference
    vibe_image_utils.py:354-371)."""
    frame_ids = list(frame_ids)
    if len(frame_ids) < seqlen:
        return [(0, len(frame_ids))] if frame_ids else []
    chunks = []
    start = 0
    while start + seqlen <= len(frame_ids):
        chunks.append((start, start + seqlen))
        start += stride
    if chunks and chunks[-1][1] < len(frame_ids):
        chunks.append((len(frame_ids) - seqlen, len(frame_ids)))
    return chunks


def prepare_rendering_results(results: dict, nframes: int) -> list:
    """Per-frame person render lists, sorted by the y-scale of the
    original-image camera, far to near (reference demo_utils.py:283-315).

    Args:
        results: dict[person_id] with arrays 'verts', 'orig_cam',
            'frame_ids', optional 'smpl_joints2d', 'var', 'var_global'.
    """
    frame_results = [{} for _ in range(nframes)]
    for person_id, person_data in results.items():
        for idx, frame_id in enumerate(person_data["frame_ids"]):
            entry = {
                "verts": person_data["verts"][idx],
                "cam": person_data["orig_cam"][idx],
            }
            if "smpl_joints2d" in person_data:
                entry["joints2d"] = person_data["smpl_joints2d"][idx]
            for key in ("var", "var_global"):
                val = person_data.get(key)
                entry[key] = (
                    val[idx] if val is not None and len(val) > 1 else None
                )
            frame_results[frame_id][person_id] = entry

    for frame_id, frame_data in enumerate(frame_results):
        keys = list(frame_data.keys())
        sort_idx = np.argsort([frame_data[k]["cam"][1] for k in keys])
        frame_results[frame_id] = OrderedDict(
            (keys[i], frame_data[keys[i]]) for i in sort_idx
        )
    return frame_results
