"""Batched on-device preprocessing: crop -> resize -> normalize -> CLIFF
conditioning, in plain torch (port of `poco_tpu.ops.preprocess`).

One image goes to the device once (uint8) and every person crop comes
from one inverse-affine bilinear gather. Conventions match cv2
(pixel centers at integer coordinates, INTER_LINEAR, BORDER_CONSTANT=0).
`crop_and_resize_mxu` is the separable option: two fp32 products.
"""

from __future__ import annotations

import torch

from ..constants import IMG_NORM_MEAN, IMG_NORM_STD, IMG_RES
from ..utils import spans


def crop_transform_params(
    center: torch.Tensor,
    bbox_size: torch.Tensor,
    rot_deg: torch.Tensor | None = None,
    out_res: int = IMG_RES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-crop affine map from output pixel to source pixel.

    src = center + R(rot) @ ((dst - res/2) * bbox/res), as cv2's
    gen_trans_from_patch_cv with inv=True.

    Args:
        center: (B, 2) crop centers in source pixels.
        bbox_size: (B,) square bbox edge in source pixels (scale * 200).
        rot_deg: optional (B,) rotation in degrees.
    Returns:
        (a (B, 2, 2) linear maps, t (B, 2) translations).
    """
    sx = bbox_size / out_res
    if rot_deg is None:
        rot_rad = torch.zeros_like(sx)
    else:
        rot_rad = torch.deg2rad(rot_deg)
    cos, sin = torch.cos(rot_rad), torch.sin(rot_rad)
    a = torch.stack(
        [
            torch.stack([cos * sx, -sin * sx], dim=-1),
            torch.stack([sin * sx, cos * sx], dim=-1),
        ],
        dim=-2,
    )
    half = out_res / 2.0
    t = center - (a[:, :, 0] * half + a[:, :, 1] * half)
    return a, t


def bilinear_sample_image(
    image: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
) -> torch.Tensor:
    """Sample an (H, W, C) float image at float coords, zero outside.

    Args:
        xs, ys: (...,) source coordinates.
    Returns:
        (..., C) sampled values.
    """
    h, w, c = image.shape
    flat = image.reshape(h * w, c)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]

    def tap(yi, xi):
        # NaN passes `clamp` and casts to -2^63: map it to 0 first (as
        # XLA's cast does), so a non-finite box reads pixels in range and
        # its NaN weights make its crop NaN, as in the JAX package
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.nan_to_num(xi, nan=0.0).clamp(0, w - 1).long()
        yc = torch.nan_to_num(yi, nan=0.0).clamp(0, h - 1).long()
        return flat[yc * w + xc] * valid[..., None]

    return (
        tap(y0, x0) * (1 - wx) * (1 - wy)
        + tap(y0, x0 + 1) * wx * (1 - wy)
        + tap(y0 + 1, x0) * (1 - wx) * wy
        + tap(y0 + 1, x0 + 1) * wx * wy
    )


def crop_and_resize(
    image: torch.Tensor,
    center: torch.Tensor,
    bbox_size: torch.Tensor,
    rot_deg: torch.Tensor | None = None,
    out_res: int = IMG_RES,
) -> torch.Tensor:
    """All person crops of one (H, W, 3) image in one gather.

    Returns:
        (B, out_res, out_res, 3) float32 crops, on the input's value scale.
    """
    image = image.float()
    a, t = crop_transform_params(center, bbox_size, rot_deg, out_res)
    grid = torch.arange(out_res, dtype=torch.float32, device=image.device)
    gx, gy = torch.meshgrid(grid, grid, indexing="xy")
    xs = (
        a[:, 0, 0, None, None] * gx + a[:, 0, 1, None, None] * gy
        + t[:, 0, None, None]
    )
    ys = (
        a[:, 1, 0, None, None] * gx + a[:, 1, 1, None, None] * gy
        + t[:, 1, None, None]
    )
    return bilinear_sample_image(image, xs, ys)


def crop_and_resize_mxu(
    image: torch.Tensor,
    center: torch.Tensor,
    bbox_size: torch.Tensor,
    out_res: int = IMG_RES,
) -> torch.Tensor:
    """Axis-aligned crops as two products (port of the JAX package's
    `crop_and_resize_mxu`), an option beside the gather of
    `crop_and_resize`; nothing on the demo's path switches to it.

    An unrotated bilinear resample is separable: out = Ry @ img @ Rx^T,
    with Ry (R, H) and Rx (R, W) dense rows of at most two bilinear taps
    (zero padding outside the image falls out of rows that sum to less
    than 1). Both contractions run in fp32 (the JAX package's
    Precision.HIGHEST); on a card with TF32 matmuls on they would round
    the pixels to 10 bits, so that raises.

    Args:
        image: (H, W, 3) source image.
        center: (B, 2) crop centres (x, y).
        bbox_size: (B,) box edge in source pixels.
    Returns:
        (B, out_res, out_res, 3) float32 crops.
    """
    if image.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "crop_and_resize_mxu needs fp32 matmuls without TF32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    image = image.float()
    h, w = image.shape[:2]
    grid = torch.arange(out_res, dtype=torch.float32, device=image.device)
    scale = (bbox_size.float() / out_res)[:, None]
    xs = (grid[None, :] - out_res / 2.0) * scale + center[:, :1].float()
    ys = (grid[None, :] - out_res / 2.0) * scale + center[:, 1:2].float()

    def weight_rows(coords: torch.Tensor, n: int) -> torch.Tensor:
        """(B, R) source coordinates -> (B, R, n) bilinear weight rows."""
        idx = torch.arange(n, dtype=torch.float32, device=image.device)
        return torch.clamp(1.0 - (coords[..., None] - idx).abs(), min=0.0)

    rows = torch.einsum("biy,yxc->bixc", weight_rows(ys, h), image)
    return torch.einsum("bjx,bixc->bijc", weight_rows(xs, w), rows)


_NORM_CONSTANTS: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _norm_constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std on `device`, made once a device (a copy to
    the card waits for its queue to drain); made anew, and not kept, while
    torch compiles or exports."""
    tracing = torch.compiler.is_compiling() or torch.compiler.is_exporting()
    constants = None if tracing else _NORM_CONSTANTS.get(device)
    if constants is None:
        with torch.inference_mode(False), torch.no_grad():
            constants = tuple(torch.tensor(values, dtype=torch.float32, device=device)
                              for values in (IMG_NORM_MEAN, IMG_NORM_STD))
        if not tracing:
            _NORM_CONSTANTS[device] = constants
    return constants


def normalize_image(crops: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """ImageNet normalization of (..., 3) RGB in [0, max_val]."""
    with spans.span(spans.SYNC_NORM, wait=True):
        mean, std = _norm_constants(crops.device)
    return (crops / max_val - mean) / std


def calculate_focal_length(img_h, img_w):
    """Full-image focal proxy sqrt(h^2 + w^2) (image_utils.py:171-172)."""
    return torch.sqrt(img_h**2.0 + img_w**2.0)


def calculate_bbox_info(
    center: torch.Tensor, scale: torch.Tensor, orig_shape: torch.Tensor
) -> torch.Tensor:
    """CLIFF bbox descriptor with H36M normalization constants.

    Args:
        center: (B, 2) bbox centers (x, y).
        scale: (B,) bbox height / 200.
        orig_shape: (B, 2) original (h, w).
    Returns:
        (B, 3) normalized [cx - w/2, cy - h/2, b].
    """
    img_h, img_w = orig_shape[..., 0], orig_shape[..., 1]
    focal = calculate_focal_length(img_h, img_w)
    b = scale * 200.0
    cx = (center[..., 0] - img_w / 2.0) / focal * 2.8
    cy = (center[..., 1] - img_h / 2.0) / focal * 2.8
    bn = (b - 0.24 * focal) / (0.06 * focal)
    return torch.stack([cx, cy, bn], dim=-1)


def preprocess_crops(
    image: torch.Tensor,
    centers: torch.Tensor,
    scales: torch.Tensor,
    out_res: int = IMG_RES,
    true_hw: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """One image + N detections -> the model's batch dict.

    Args:
        image: (H, W, 3) uint8 or float RGB image, possibly zero-padded at
            the bottom/right.
        centers: (B, 2) bbox centers.
        scales: (B,) bbox height / 200.
        true_hw: optional (2,) unpadded (h, w), used for the camera model.
    """
    h, w = image.shape[:2]
    crops = crop_and_resize(image, centers, scales * 200.0, out_res=out_res)
    batch = centers.shape[0]
    if true_hw is None:
        with spans.span(spans.SYNC_TRUE_HW, wait=True):
            # filled on the device (a number set by indexing, like a tensor
            # made from host numbers, is copied there and waits for its queue)
            true_hw = torch.empty(2, dtype=torch.float32, device=image.device)
            true_hw[0].fill_(h)
            true_hw[1].fill_(w)
    true_hw = true_hw.float()
    orig_shape = true_hw.expand(batch, 2)
    return {
        "img": normalize_image(crops),
        "bbox_info": calculate_bbox_info(centers, scales, orig_shape),
        "focal_length": calculate_focal_length(true_hw[0], true_hw[1]).expand(
            batch
        ),
        "scale": scales,
        "center": centers,
        "orig_shape": orig_shape,
    }
