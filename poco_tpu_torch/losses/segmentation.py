"""Part-segmentation and silhouette losses (torch port of
`poco_tpu.losses.segmentation`).

Reference contracts: pocolib/losses/segmentation.py:12-27 (cross-entropy
over PARE's part-segmentation logits) and losses.py:556-563
(`neg_iou_loss`, the differentiable-render silhouette loss). They enter
`poco_loss` through the `pred_segm_mask` / `gt_segm_mask` keys. With
more than one process, `part_segmentation_loss` is this process's share
of the global batch's mean, as the other losses are (`losses.py`).
"""

from __future__ import annotations

import torch

from ..parallel import distributed


def part_segmentation_loss(pred_logits: torch.Tensor, gt_labels: torch.Tensor,
                           valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel-wise cross-entropy over C part classes.

    Args:
        pred_logits: (B, C, H, W) logits, class 0 the background (the PARE
            head's `pred_segm_mask`).
        gt_labels: (B, H, W) integer labels in [0, C).
        valid_mask: optional (B,) sample weights (has_smpl).
    """
    top = pred_logits.amax(dim=1, keepdim=True)
    logz = torch.log(torch.exp(pred_logits - top).sum(dim=1)) + top[:, 0]
    gathered = pred_logits.gather(1, gt_labels[:, None].long())[:, 0]
    per_sample = (logz - gathered).mean(dim=(1, 2))
    if valid_mask is not None:
        w = valid_mask.to(per_sample.dtype)
        count = distributed.all_reduce_sum_(w.sum())
        return (per_sample * w).sum() / torch.clamp(count, min=1.0)
    if distributed.process_count() == 1:
        return per_sample.mean()
    return per_sample.sum() / (per_sample.numel() * distributed.process_count())


def neg_iou_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - soft IoU of (B, ...) masks in [0, 1] (reference losses.py:556-563)."""
    dims = tuple(range(1, predict.ndim))
    intersect = (predict * target).sum(dims) + 1e-6
    union = (predict + target - predict * target).sum(dims) + 1e-6
    return 1.0 - (intersect / union).mean()
