"""Serving one request: an image and its person boxes -> POCO outputs.

Port of the fused preprocessing + forward of the JAX demo
(`poco_tpu.demo.tester.PocoTester._detect_forward`): the image goes to
the model's device once, as uint8, and crop, normalize, CLIFF
conditioning, backbone, head, SMPL and uncertainty all run there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.preprocess import preprocess_crops
from ..smpl.lbs import SmplParams


@torch.inference_mode()
def detect_forward(
    model: torch.nn.Module,
    smpl: SmplParams,
    image_uint8_hwc,
    centers,
    scales,
    true_hw=None,
) -> dict[str, Any]:
    """Answer one request.

    Args:
        model: a POCO in eval mode; its device is the request's device.
        smpl: SMPL weights on the same device.
        image_uint8_hwc: (H, W, 3) uint8 RGB image (numpy or tensor).
        centers: (N, 2) bbox centers in image pixels.
        scales: (N,) bbox heights / 200.
        true_hw: optional (2,) unpadded (h, w) of a bottom/right-padded image.
    Returns:
        The model's output dict for the N boxes.
    """
    device = next(model.parameters()).device

    def on_device(x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    image = on_device(image_uint8_hwc, torch.uint8)
    batch = preprocess_crops(
        image,
        on_device(centers, torch.float32),
        on_device(scales, torch.float32),
        true_hw=None if true_hw is None else on_device(true_hw, torch.float32),
    )
    return model(batch, smpl)
