"""Training-time image summaries: GT and predicted meshes over the input
crops (port of `poco_tpu.viz.train_viz`; reference trainer.py:467-583,
which logs such grids to TensorBoard).

Every LOG_SAVE_INTERVAL step with TRAINING.SAVE_IMAGES, the trainer
renders a grid of [input crop | GT mesh | predicted mesh (| side view)]
rows with the port's rasterizer (`viz/renderer.py`) and writes it as
`<logdir>/images/train_e{epoch}_s{step}.png`, as the JAX trainer does;
no OpenCV.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..constants import IMG_NORM_MEAN, IMG_NORM_STD
from ..runtime.image_write import write_png
from .renderer import Renderer, get_vertex_colors


def denormalize_images(img: np.ndarray) -> np.ndarray:
    """Undo the ImageNet normalization -> uint8 HWC."""
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    return np.clip((img * std + mean) * 255.0, 0, 255).astype(np.uint8)


def render_training_grid(
    images: np.ndarray,
    pred_verts: np.ndarray,
    pred_cam: np.ndarray,
    faces: np.ndarray,
    gt_verts: np.ndarray | None = None,
    gt_cam: np.ndarray | None = None,
    var_pose: np.ndarray | None = None,
    lbs_weights: np.ndarray | None = None,
    backbone: str = "cliff",
    max_rows: int = 4,
    sideview: bool = False,
) -> np.ndarray:
    """The [input | GT | pred (| side)] comparison grid.

    Args:
        images: (B, H, W, 3) normalized crops (NHWC).
        pred_verts / gt_verts: (B, V, 3).
        pred_cam / gt_cam: (B, 3) weak-perspective crop cameras (the GT
            meshes drawn by the predicted camera when gt_cam is None).
    Returns:
        (rows * H, cols * W, 3) uint8.
    """
    n = min(max_rows, images.shape[0])
    h, w = images.shape[1:3]
    renderer = Renderer(faces, w, h)
    rows = []
    for i in range(n):
        crop = denormalize_images(np.asarray(images[i]))
        cols = [crop]
        if gt_verts is not None:
            cam = gt_cam[i] if gt_cam is not None else pred_cam[i]
            cols.append(renderer.render(crop, np.asarray(gt_verts[i]), np.asarray(cam),
                                        color=(0.3, 0.8, 0.3)))
        vc = None
        if var_pose is not None and lbs_weights is not None:
            vc = get_vertex_colors(np.array(var_pose[i], copy=True), lbs_weights,
                                   backbone=backbone)
        cols.append(renderer.render(crop, np.asarray(pred_verts[i]), np.asarray(pred_cam[i]),
                                    vertex_colors=vc))
        if sideview:
            cols.append(renderer.render_sideview(np.asarray(pred_verts[i]),
                                                 np.asarray(pred_cam[i])))
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


def save_training_grid(grid: np.ndarray, logdir: str, tag: str) -> str:
    """Write the grid as `<logdir>/images/<tag>.png`; returns the path."""
    out_dir = osp.join(logdir, "images")
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, f"{tag}.png")
    write_png(path, grid)
    return path
