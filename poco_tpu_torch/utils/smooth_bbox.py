"""Temporal bbox smoothing from 2D keypoint tracks (port of
`poco_tpu.utils.smooth_bbox`, numpy and scipy).

Reference contract: pocolib/utils/smooth_bbox.py:9-121 (originally from
human_dynamics): bbox params from keypoints, linear interpolation of
detection gaps, median + Gaussian filtering.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as signal
from scipy.ndimage import gaussian_filter1d


def kp_to_bbox_param(kp, vis_thresh: float):
    """[cx, cy, scale] from (K, 3) keypoints; None if invisible/tiny."""
    if kp is None:
        return None
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    person_height = np.linalg.norm(max_pt - min_pt)
    if person_height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    scale = 150.0 / person_height
    return np.append(center, scale)


def get_all_bbox_params(kps, vis_thresh: float = 2.0):
    """Per-frame bbox params with linear gap interpolation.

    Args:
        kps: list of (K, 3) keypoints or None per frame.
    Returns:
        (bbox_params (T, 3), start_index, end_index).
    """
    start, end = None, None
    params = []
    for i, kp in enumerate(kps):
        p = kp_to_bbox_param(kp, vis_thresh)
        if p is None:
            if start is None:
                continue
            params.append(None)
        else:
            if start is None:
                start = i
            end = i
            params.append(p)
    # trim trailing Nones and interpolate interior gaps
    while params and params[-1] is None:
        params.pop()
    out = []
    i = 0
    while i < len(params):
        if params[i] is not None:
            out.append(params[i])
            i += 1
            continue
        j = i
        while j < len(params) and params[j] is None:
            j += 1
        prev, nxt = out[-1], params[j]
        gap = j - i + 1
        for k in range(1, gap):
            out.append(prev + (nxt - prev) * k / gap)
        i = j
    if not out:
        return np.zeros((0, 3)), 0, -1
    return np.asarray(out), start, end


def smooth_bbox_params(bbox_params, kernel_size: int = 11, sigma: float = 3):
    """Median + Gaussian filtering per channel."""
    if len(bbox_params) == 0:
        return bbox_params
    smoothed = np.array(
        [
            signal.medfilt(traj, min(kernel_size, len(traj) // 2 * 2 + 1))
            for traj in bbox_params.T
        ]
    ).T
    return np.array([gaussian_filter1d(traj, sigma) for traj in smoothed.T]).T


def get_smooth_bbox_params(
    kps, vis_thresh: float = 2.0, kernel_size: int = 11, sigma: float = 3
):
    """Smooth [cx, cy, scale] track from per-frame keypoints.

    Returns (smoothed (start+T, 3) with zero rows before `start`,
    start_index, end_index).
    """
    bbox_params, start, end = get_all_bbox_params(kps, vis_thresh)
    smoothed = smooth_bbox_params(bbox_params, kernel_size, sigma)
    if start:
        smoothed = np.vstack((np.zeros((start, 3)), smoothed))
    return smoothed, start, end
