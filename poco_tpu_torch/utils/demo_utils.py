"""Demo pipeline utilities (port of `poco_tpu.utils.demo_utils`; reference
pocolib/utils/demo_utils.py:183-315): video I/O, YouTube download, camera
and keypoint conversions, depth-sorted render preparation.

Video I/O takes the JAX package's routes where they exist on the host,
ffmpeg first, then cv2, and after them a route of the port's own that
needs neither: Motion-JPEG (`utils/mjpeg.py`). `video_to_images` copies
an MJPG AVI's stored JPEGs out unchanged; `images_to_video` encodes the
frames with the port's JPEG encoder into `<stem>.avi` (Motion-JPEG) in
place of the mp4 that ffmpeg or cv2 write. Frames are extracted as JPEG,
the format every route of the port's loader decodes. cv2, pytube and
yt-dlp are imported or run only inside the calls that use them.
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


def optional_cv2():
    """cv2, or None where it does not import (not installed, or installed
    without the libraries it loads)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def download_youtube_clip(url: str, download_folder: str) -> str | None:
    """Download a YouTube video for the video demo (reference
    demo_utils.py:86-88): pytube where it is installed, then the yt-dlp
    binary; the downloaded file's path, or None when neither is there or
    the download fails."""
    os.makedirs(download_folder, exist_ok=True)
    try:
        from pytube import YouTube  # optional

        stream = YouTube(url).streams.get_highest_resolution()
        return stream.download(output_path=download_folder)
    except ImportError:
        pass
    except Exception:
        return None
    if shutil.which("yt-dlp"):
        out_tpl = osp.join(download_folder, "%(id)s.%(ext)s")
        try:
            r = subprocess.run(
                ["yt-dlp", "-f", "best[ext=mp4]/best", "-o", out_tpl,
                 "--print", "after_move:filepath", url],
                capture_output=True, text=True, check=True,
            )
            path = r.stdout.strip().splitlines()[-1]
            return path if osp.exists(path) else None
        except (subprocess.CalledProcessError, IndexError):
            return None
    return None


def video_frame_size(vid_file: str) -> tuple[int, int]:
    """(height, width) of a video's frames without extracting them: cv2's
    probe where cv2 is installed (256 for a side it cannot read, as the
    JAX demo has it), else the MJPG AVI header."""
    cv2 = optional_cv2()
    if cv2 is not None:
        cap = cv2.VideoCapture(vid_file)
        fh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 256
        fw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 256
        cap.release()
        return fh, fw
    from .mjpeg import avi_frame_size

    return avi_frame_size(vid_file)


def video_to_images(
    vid_file: str, img_folder: str | None = None, return_info: bool = False
):
    """Extract a video's frames as `%06d.jpg`, numbered from 1 (reference
    demo_utils.py:183-208), stale frames of an earlier extraction removed
    first. The routes, in order: ffmpeg (`-qscale:v 2`); cv2.VideoCapture
    with `imwrite` at JPEG quality 95 (the JAX package's fallback); an MJPG
    AVI's stored JPEGs written unchanged (`mjpeg.read_avi_mjpeg`: no decode,
    no re-encode). Raises when none applies. With `return_info`, returns
    (folder, frame count, (h, w, 3))."""
    if img_folder is None:
        raise ValueError("video_to_images needs an output folder")
    os.makedirs(img_folder, exist_ok=True)
    for f in os.listdir(img_folder):
        if f.lower().endswith((".png", ".jpg", ".jpeg")):
            os.remove(osp.join(img_folder, f))
    cv2 = optional_cv2()
    if has_ffmpeg():
        subprocess.run(
            ["ffmpeg", "-i", vid_file, "-f", "image2", "-v", "error",
             "-qscale:v", "2", f"{img_folder}/%06d.jpg"],
            check=True,
        )
    elif cv2 is not None:
        cap = cv2.VideoCapture(vid_file)
        idx = 1
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.imwrite(osp.join(img_folder, f"{idx:06d}.jpg"), frame,
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            idx += 1
        cap.release()
    else:
        from .mjpeg import read_avi_mjpeg

        try:
            frames = read_avi_mjpeg(vid_file)
            for idx, data in enumerate(frames, start=1):
                with open(osp.join(img_folder, f"{idx:06d}.jpg"), "wb") as f:
                    f.write(data)
        except ValueError as err:
            raise RuntimeError(
                f"video_to_images: {vid_file} needs ffmpeg on PATH or cv2, neither of which "
                f"is here, unless it is a Motion-JPEG AVI ({err}); give --image_folder a "
                "directory of frames instead") from err
    frames = sorted(f for f in os.listdir(img_folder) if f.endswith(".jpg"))
    if not frames:
        raise RuntimeError(f"video_to_images: no frame could be read from {vid_file}")
    if return_info:
        from ..runtime.loader import image_size

        h, w = image_size(osp.join(img_folder, frames[0]))
        return img_folder, len(frames), (h, w, 3)
    return img_folder


def images_to_video(
    img_folder: str, output_vid_file: str, fps: int = 30,
    pattern: str = "%06d.png",
) -> str:
    """Assemble frames into a video and return its path. ffmpeg writes an
    H.264 mp4 (reference demo_utils.py:237-246), else cv2.VideoWriter an
    mp4v one (the JAX package's fallback); with neither, the frames are
    encoded by the port's JPEG encoder at quality 95 (`loader.encode_jpeg`:
    libjpeg, or nvJPEG on the card's host) into a Motion-JPEG AVI,
    `output_vid_file` with the suffix `.avi` (where the loader reads no
    PNG, the frames must be the port's own PNGs: `image_write.decode_png`)."""
    os.makedirs(osp.dirname(output_vid_file) or ".", exist_ok=True)
    if has_ffmpeg():
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-threads", "16", "-i",
             f"{img_folder}/{pattern}", "-profile:v", "baseline", "-level",
             "3.0", "-c:v", "libx264", "-pix_fmt", "yuv420p", "-an", "-v",
             "error", output_vid_file],
            check=True,
        )
        return output_vid_file
    frames = sorted(f for f in os.listdir(img_folder) if f.endswith((".png", ".jpg")))
    if not frames:
        raise FileNotFoundError(f"no frames in {img_folder}")
    cv2 = optional_cv2()
    if cv2 is not None:
        first = cv2.imread(osp.join(img_folder, frames[0]))
        h, w = first.shape[:2]
        writer = cv2.VideoWriter(
            output_vid_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        for f in frames:
            writer.write(cv2.imread(osp.join(img_folder, f)))
        writer.release()
        return output_vid_file
    from ..runtime.image_write import decode_png
    from ..runtime.loader import encode_jpeg, read_image_rgb
    from .mjpeg import write_avi_mjpeg

    def read(name: str) -> np.ndarray:
        path = osp.join(img_folder, name)
        try:
            return read_image_rgb(path)
        except ValueError:
            if not name.endswith(".png"):
                raise
            # the loader's nvJPEG route decodes JPEG only: the demo's own
            # PNGs are read back by their encoder's inverse
            with open(path, "rb") as f:
                return decode_png(f.read())

    avi = osp.splitext(output_vid_file)[0] + ".avi"
    first = read(frames[0])
    write_avi_mjpeg(avi, (encode_jpeg(first if i == 0 else read(f), quality=95)
                          for i, f in enumerate(frames)), fps, first.shape[1::-1])
    print(f"no ffmpeg or cv2: wrote the frames as Motion-JPEG to {avi}")
    return avi


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
