"""Synthetic occlusion augmentation: keypoint-targeted occluder pasting
(port of `poco_tpu.data.occlusion`, without OpenCV).

Reference contract: pocolib/dataset/occlusion.py:43-150. Occluder patches
are RGBA numpy arrays (alpha-blended paste). `load_pascal_occluders`
extracts segmented non-person objects from a Pascal VOC root;
`synthetic_occluders` makes random elliptical patches, so the
augmentation runs without the VOC download. The resizes, the erosion and
the ellipse are numpy versions of the cv2 calls the JAX package makes
(`cv2.resize` INTER_LINEAR and INTER_AREA, `cv2.erode`, `cv2.ellipse`),
and images are read through the port's loader. Every random draw is the
JAX package's, in its order.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime import loader

# the 24 GT joints of the SPIN order (JOINT_NAME_REGISTRY["spin"][25:] of
# the JAX package's utils/kp_utils.py), which the COCO statistics name
SPIN_GT_JOINT_NAMES = [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop", "hip", "thorax",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)",
    "nose", "leye", "reye", "lear", "rear",
]


def paste_over(im_src: np.ndarray, im_dst: np.ndarray, center) -> None:
    """Alpha-blend `im_src` (RGBA) onto `im_dst` (RGB) in place at center.

    Reference: occlusion.py paste_over.
    """
    w_src, h_src = im_src.shape[1], im_src.shape[0]
    w_dst, h_dst = im_dst.shape[1], im_dst.shape[0]
    center = np.round(np.asarray(center)).astype(np.int32)
    raw_start = center - np.array([w_src // 2, h_src // 2])
    raw_end = raw_start + np.array([w_src, h_src])
    start = np.clip(raw_start, 0, [w_dst, h_dst])
    end = np.clip(raw_end, 0, [w_dst, h_dst])
    region = im_dst[start[1]:end[1], start[0]:end[0]]
    src_start = start - raw_start
    src_end = src_start + (end - start)
    src = im_src[src_start[1]:src_end[1], src_start[0]:src_end[0]]
    if src.size == 0 or region.size == 0:
        return
    rgb = src[..., :3]
    alpha = (src[..., 3:4].astype(np.float32) / 255.0)
    im_dst[start[1]:end[1], start[0]:end[0]] = (
        alpha * rgb + (1.0 - alpha) * region
    )


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weights of cv2.resize's INTER_LINEAR along one
    axis: pixel centres at +0.5, the offset rounded to float32, the
    taps clamped to the edge."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32).astype(np.float64)
    x0 = np.floor(f)
    frac = f - x0
    x0 = x0.astype(np.int64)
    low = x0 < 0
    frac[low], x0[low] = 0.0, 0
    high = x0 >= src - 1
    frac[high], x0[high] = 0.0, src - 1
    w = np.zeros((dst, src))
    rows = np.arange(dst)
    np.add.at(w, (rows, x0), 1.0 - frac)
    np.add.at(w, (rows, np.minimum(x0 + 1, src - 1)), frac)
    return w


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of cv2.resize's INTER_AREA shrink along one axis
    (computeResizeAreaTab): each output cell averages the source pixels it
    covers, partial pixels by their covered share, slivers under 1e-3
    dropped."""
    scale = src / dst
    w = np.zeros((dst, src))
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx2 = min(int(np.floor(fsx2)), src - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = (sx1 - fsx1) / cell
        w[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return w


def resize_by_factor(im: np.ndarray, factor: float) -> np.ndarray:
    """Resize an 8-bit image by `factor` to the rounded size: bilinear up,
    area average down, as `cv2.resize` does with INTER_LINEAR / INTER_AREA
    (within one grey level: cv2 rounds in fixed point)."""
    h, w = im.shape[:2]
    new_w, new_h = np.maximum(np.round(np.array([w, h]) * factor), 1).astype(int)
    if (new_h, new_w) == (h, w):
        return im.copy()
    weights = _linear_weights if factor > 1.0 else _area_weights
    wy, wx = weights(h, new_h), weights(w, new_w)
    rows = np.tensordot(wy, im.reshape(h, w, -1).astype(np.float64), axes=1)
    out = np.einsum("ywc,xw->yxc", rows, wx, optimize=True)
    out = np.clip(np.rint(out), 0, 255).astype(im.dtype)
    return out.reshape((new_h, new_w) + im.shape[2:])


def occlude_with_objects_kp(
    im: np.ndarray,
    kp2d_norm: np.ndarray,
    scale: float,
    occluders: list[np.ndarray],
    rng: np.random.RandomState,
    img_size: int = 224,
) -> np.ndarray:
    """Paste 1-7 occluders near visible GT keypoints.

    Reference: occlude_with_pascal_objects_kp (occlusion.py:108-148):
    pick random visible joints of the 24 GT keypoints, jitter the paste
    center by 0.1*scale, scale occluders by a random factor relative to
    the 256px reference size.

    Args:
        im: (H, W, 3) crop, float [0, 255].
        kp2d_norm: (49, 3) keypoints in [-1, 1] crop coords + confidence.
        scale: bbox scale (height/200).
    """
    result = im.copy()
    im_w, im_h = im.shape[1], im.shape[0]
    im_scale_factor = min(im_w, im_h) / 256.0
    count = rng.randint(1, 8)

    kp = kp2d_norm[25:].copy()
    kp[:, :2] = 0.5 * img_size * (kp[:, :2] + 1.0)
    visible = kp[kp[:, 2] > 0.3]
    if len(visible) == 0 or len(occluders) == 0:
        return result

    for _ in range(count):
        occ = occluders[rng.randint(len(occluders))]
        x, y = visible[rng.randint(len(visible))][:2]
        x = int(np.clip(x + rng.randn() * 0.1 * scale, 0, im_w))
        y = int(np.clip(y + rng.randn() * 0.1 * scale, 0, im_h))
        factor = rng.uniform(0.2, 1.0) * im_scale_factor + 1e-8
        occ = resize_by_factor(occ, factor)
        paste_over(occ, result, (x, y))
    return result


def occlude_with_objects(
    im: np.ndarray,
    occluders: list[np.ndarray],
    rng: np.random.RandomState,
) -> np.ndarray:
    """Paste 1-7 occluders at uniformly random positions (the reference's
    non-keypoint variant, occlusion.py occlude_with_pascal_objects:152-176)."""
    result = im.copy()
    width_height = np.asarray([im.shape[1], im.shape[0]])
    im_scale_factor = min(width_height) / 256.0
    count = rng.randint(1, 8)
    if len(occluders) == 0:
        return result
    for _ in range(count):
        occ = occluders[rng.randint(len(occluders))]
        center = rng.uniform([0, 0], width_height)
        factor = rng.uniform(0.2, 1.0) * im_scale_factor + 1e-8
        occ = resize_by_factor(occ, factor)
        paste_over(occ, result, center)
    return result


def load_coco_occluders(path: str) -> dict:
    """Load the COCO occluder archive (reference occlusion.py:100-106).

    The pkl holds {'stats': {joint_name: [(obj_class, h, scale), ...]},
    'obj_class': array of class names, 'object_with_mask': list of RGBA
    patches}; the per-joint occlusion frequency, aligned by joint name to
    the SPIN 24-joint order, is derived from the stats (uniform when no
    name matches).
    """
    import joblib

    occluders = joblib.load(path)
    stats = occluders["stats"]
    freq = np.array([len(stats.get(name, ())) for name in SPIN_GT_JOINT_NAMES], np.float64)
    if freq.sum() == 0:
        freq = np.ones(len(SPIN_GT_JOINT_NAMES), np.float64)
    occluders["joint_occ_freq"] = freq / freq.sum()
    return occluders


def occlude_with_coco_objects(
    im: np.ndarray,
    kp2d_norm: np.ndarray,
    occluders: dict,
    rng: np.random.RandomState,
    img_size: int = 224,
    max_n_objects: int = 4,
) -> np.ndarray:
    """COCO-statistics occlusion: joints are occluded with the empirical
    per-joint frequency and class statistics from COCO annotations.

    Reference: occlusion.py occlude_with_coco_objects:178-245.
    """
    result = im.copy()
    kp = kp2d_norm[25:].copy()
    kp[:, :-1] = 0.5 * img_size * (kp[:, :-1] + 1.0)

    count = rng.randint(0, max_n_objects)
    if count == 0 or not np.any(kp[:, 2] >= 0.5):
        return result

    j_occ_prob = np.asarray(occluders["joint_occ_freq"], np.float64).copy()
    j_occ_prob = j_occ_prob / j_occ_prob.sum()
    obj_class = np.asarray(occluders["obj_class"])

    for _ in range(count):
        # rejection-sample a visible joint by occlusion frequency
        # (reference: multinomial + nonvis retry loop, bounded here)
        jid = None
        for _ in range(50):
            cand = int(rng.multinomial(1, j_occ_prob).argmax())
            if kp[cand, 2] >= 0.5:
                jid = cand
                break
        if jid is None:
            continue
        center = kp[jid, :2]
        stats = occluders["stats"].get(SPIN_GT_JOINT_NAMES[jid], [])
        if not stats:
            continue
        occluder_info = stats[rng.randint(len(stats))]
        matches = np.argwhere(obj_class == occluder_info[0])
        if len(matches) == 0:
            continue
        occ_id = int(matches[rng.randint(len(matches))][0])
        mask = occluders["object_with_mask"][occ_id]
        factor = (
            1.0 / (mask.shape[0] / img_size) * rng.uniform(0.05, 0.7)
        )
        mask = resize_by_factor(mask, factor)
        paste_over(mask, result, center)
    return result


def synthetic_coco_occluders(n: int = 12, seed: int = 0) -> dict:
    """A stand-in for the COCO occluder archive with its structure, so the
    COCO path runs without the licence-gated pkl."""
    rng = np.random.RandomState(seed)
    patches = synthetic_occluders(n=n, seed=seed)
    classes = np.array([f"class_{i % 4}" for i in range(n)])
    stats = {
        name: [(classes[rng.randint(n)], 64, 2.0) for _ in range(rng.randint(1, 5))]
        for name in SPIN_GT_JOINT_NAMES
    }
    freq = np.array([len(v) for v in stats.values()], np.float64)
    return {
        "stats": stats,
        "obj_class": classes,
        "object_with_mask": patches,
        "joint_occ_freq": freq / freq.sum(),
    }


def erode(mask: np.ndarray, size: int = 8) -> np.ndarray:
    """Grey erosion by a size x size square anchored at its centre, pixels
    outside the image ignored (`cv2.erode` with its default border)."""
    lo = size // 2
    padded = np.pad(mask, ((lo, size - 1 - lo), (lo, size - 1 - lo)),
                    constant_values=np.iinfo(mask.dtype).max)
    windows = np.lib.stride_tricks.sliding_window_view(padded, (size, size))
    return windows.min(axis=(2, 3))


def to_gray(rgb: np.ndarray) -> np.ndarray:
    """8-bit RGB -> grey with libpng's rgb_to_gray at the 0.299 / 0.587
    weights cv2 asks of it for IMREAD_GRAYSCALE (exact on grey images)."""
    rgb = rgb.astype(np.int64)
    y = (9798 * rgb[..., 0] + 19235 * rgb[..., 1] + 3735 * rgb[..., 2] + 16384) >> 15
    return y.astype(np.uint8)


def load_pascal_occluders(pascal_voc_root_path: str) -> list[np.ndarray]:
    """Extract segmented non-person occluder patches from a VOC root.

    Reference: occlusion.py:43-98. Requires the VOC2012 layout
    (Annotations/, SegmentationObject/, JPEGImages/); the segmentation
    PNGs need a loader built with libpng (`loader.png_available()`).
    """
    import glob
    import xml.etree.ElementTree as ET

    occluders = []
    seg_dir = os.path.join(pascal_voc_root_path, "SegmentationObject")
    ann_dir = os.path.join(pascal_voc_root_path, "Annotations")
    img_dir = os.path.join(pascal_voc_root_path, "JPEGImages")

    for ann_path in sorted(glob.glob(os.path.join(ann_dir, "*.xml"))):
        root = ET.parse(ann_path).getroot()
        is_segmented = root.find("segmented")
        if is_segmented is None or is_segmented.text != "1":
            continue
        boxes = []
        for i_obj, obj in enumerate(root.findall("object")):
            name = obj.find("name").text
            difficult = obj.find("difficult")
            if name == "person" or (
                difficult is not None and difficult.text == "1"
            ):
                continue
            bb = obj.find("bndbox")
            boxes.append(
                (
                    i_obj,
                    [
                        int(bb.find("xmin").text), int(bb.find("ymin").text),
                        int(bb.find("xmax").text), int(bb.find("ymax").text),
                    ],
                )
            )
        if not boxes:
            continue
        stem = os.path.splitext(os.path.basename(ann_path))[0]
        seg_path = os.path.join(seg_dir, stem + ".png")
        jpg_path = os.path.join(img_dir, stem + ".jpg")
        if not (os.path.exists(seg_path) and os.path.exists(jpg_path)):
            continue
        seg = to_gray(loader.decode_image(seg_path))
        img = loader.decode_image(jpg_path)
        for i_obj, (xmin, ymin, xmax, ymax) in boxes:
            mask = (seg[ymin:ymax, xmin:xmax] == i_obj + 1).astype(np.uint8) * 255
            if mask.size == 0:
                continue
            eroded = erode(mask)
            if eroded.mean() < 0.20 * 255:  # too thin / noisy
                continue
            patch = img[ymin:ymax, xmin:xmax]
            rgba = np.concatenate([patch, eroded[..., None]], axis=-1)
            occluders.append(rgba.astype(np.uint8))
    return occluders


def ellipse_mask(h: int, w: int) -> np.ndarray:
    """A filled ellipse of 255 in an (h, w) uint8 mask, centred at
    (w // 2, h // 2) with semi-axes (w // 2 - 1, h // 2 - 1): the pixels
    whose centres lie inside it (`cv2.ellipse` fills a polygon through
    its outline, so the two differ only at the edge)."""
    a, b = w // 2 - 1, h // 2 - 1
    y, x = np.mgrid[0:h, 0:w]
    inside = ((x - w // 2) / max(a, 1e-9)) ** 2 + ((y - h // 2) / max(b, 1e-9)) ** 2 <= 1.0
    return np.where(inside, 255, 0).astype(np.uint8)


def synthetic_occluders(
    n: int = 32, seed: int = 0, max_size: int = 80
) -> list[np.ndarray]:
    """Random colored elliptical patches, a stand-in occluder set that
    keeps the augmentation path testable without VOC data."""
    rng = np.random.RandomState(seed)
    occluders = []
    for _ in range(n):
        h = rng.randint(16, max_size)
        w = rng.randint(16, max_size)
        patch = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        occluders.append(np.dstack([patch, ellipse_mask(h, w)]))
    return occluders
