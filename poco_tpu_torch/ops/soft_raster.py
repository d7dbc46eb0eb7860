"""Differentiable soft rasterization of SMPL meshes (torch port of
`poco_tpu.ops.soft_raster`).

Vertex point-splatting with Gaussian kernels: one (pixels x vertices)
squared-distance matrix a sample, smooth in the vertex positions, so the
silhouette-IoU and part cross-entropy losses reach pose and shape.

  * `soft_silhouette`: (B, R, R) coverage in [0, 1], the render loss's
    `pred_smpl_render` / `gt_smpl_render`;
  * `soft_part_probs`: (B, R, R, 25) background + 24 part probabilities,
    whose argmax is the part-segmentation target.

The squared distances follow the JAX package's expansion
|p|^2 - 2 p.v + |v|^2 in fp32, the cross term a (P, 2) x (b, 2, V)
matmul as there, so that both packages round it alike (written out as
two products, it misses tests/test_torch_render_loss.py's 1e-5). At
pixel scale |p|^2 is ~3000 px^2 against a 1.5 px splat, so TF32's
rounding of that matmul would swamp the splat: on a card the functions
raise unless fp32 matmuls are at "highest" precision, which every entry
point of the port sets.

One (B, P, V) fp32 tensor is 5.5 GB at B=64, R=56 and V=6890, so the rows
go through in chunks of at most `ROW_ELEMENTS` matrix entries; where a
gradient is wanted, each chunk is checkpointed (recomputed in the
backward) instead of keeping its matrices. Rows are independent:
chunking does not change a value.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# matrix entries (pixels x vertices x rows) a chunk holds at most: 1 GiB of fp32
ROW_ELEMENTS = 2**28


def project_weak_perspective(verts: torch.Tensor, cam: torch.Tensor, out_res: int) -> torch.Tensor:
    """(B, V, 3) + (B, 3) [s, tx, ty] -> (B, V, 2) pixel coordinates (the
    host renderer's convention, viz/renderer.py)."""
    s, tx, ty = cam[:, 0:1], cam[:, 1:2], cam[:, 2:3]
    u = (s * (verts[..., 0] + tx) + 1.0) * out_res / 2.0
    v = (s * (-verts[..., 1] + ty) + 1.0) * out_res / 2.0
    return torch.stack([u, v], dim=-1)


def _pixel_grid(out_res: int, like: torch.Tensor) -> torch.Tensor:
    r = torch.arange(out_res, dtype=like.dtype, device=like.device) + 0.5
    gx = r[None, :].expand(out_res, out_res)
    gy = r[:, None].expand(out_res, out_res)
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)  # (P, 2)


def _splats(uv: torch.Tensor, pix: torch.Tensor, sigma: float) -> torch.Tensor:
    """(b, V, 2) + (P, 2) -> (b, P, V) Gaussian splat weights."""
    cross = torch.einsum("pk,bvk->bpv", pix, uv)
    d2 = ((pix**2).sum(-1)[None, :, None] - 2.0 * cross) + (uv**2).sum(-1)[:, None, :]
    return torch.exp(-d2 / (2.0 * sigma**2))


def _by_rows(fn, uv: torch.Tensor, num_pixels: int) -> torch.Tensor:
    """fn over chunks of uv's rows, concatenated; each chunk checkpointed
    where uv wants a gradient."""
    if uv.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "soft rasterization needs fp32 matmuls without TF32 (its squared distances "
            "cancel at pixel scale): set torch.backends.cuda.matmul.allow_tf32 = False")
    rows = max(1, ROW_ELEMENTS // (num_pixels * uv.shape[1]))
    if rows >= uv.shape[0]:
        chunks = [uv]
    else:
        chunks = uv.split(rows)
    grad = torch.is_grad_enabled() and uv.requires_grad
    outs = [checkpoint(fn, c, use_reentrant=False) if grad else fn(c) for c in chunks]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def soft_silhouette(verts: torch.Tensor, cam: torch.Tensor, out_res: int = 56,
                    sigma: float = 1.5) -> torch.Tensor:
    """Differentiable silhouette from Gaussian vertex splats: (B, V, 3)
    vertices and (B, 3) weak-perspective crop cameras -> (B, R, R)
    coverage 1 - exp(-sum of splats), with splat radius `sigma` px."""
    uv = project_weak_perspective(verts, cam, out_res)
    pix = _pixel_grid(out_res, verts)

    def cover(uv_rows):
        return 1.0 - torch.exp(-_splats(uv_rows, pix, sigma).sum(-1))

    return _by_rows(cover, uv, len(pix)).reshape(verts.shape[0], out_res, out_res)


def soft_part_probs(verts: torch.Tensor, cam: torch.Tensor, vertex_parts_onehot: torch.Tensor,
                    out_res: int = 56, sigma: float = 1.5) -> torch.Tensor:
    """Differentiable part-probability maps: (B, V, 3), (B, 3) and a (V, 24)
    one-hot or soft part assignment (the SMPL skinning weights) ->
    (B, R, R, 25) probabilities, channel 0 the background."""
    uv = project_weak_perspective(verts, cam, out_res)
    pix = _pixel_grid(out_res, verts)

    def probs(uv_rows):
        part_mass = torch.einsum("bpv,vj->bpj", _splats(uv_rows, pix, sigma),
                                 vertex_parts_onehot)
        total = part_mass.sum(-1, keepdim=True)
        bg = torch.exp(-total)
        return torch.cat([bg, (1.0 - bg) * part_mass / torch.clamp(total, min=1e-9)], dim=-1)

    return _by_rows(probs, uv, len(pix)).reshape(verts.shape[0], out_res, out_res, -1)


def render_losses(pred_verts: torch.Tensor, gt_verts: torch.Tensor, cam: torch.Tensor,
                  out_res: int = 56, sigma: float = 1.5) -> torch.Tensor:
    """1 - soft IoU of the predicted and GT silhouettes (reference
    losses.py:328-332 with neg_iou_loss:556-563), differentiable in the
    predicted vertices."""
    from ..losses.segmentation import neg_iou_loss

    pred_sil = soft_silhouette(pred_verts, cam, out_res, sigma)
    gt_sil = soft_silhouette(gt_verts, cam, out_res, sigma)
    return neg_iou_loss(pred_sil, gt_sil)
