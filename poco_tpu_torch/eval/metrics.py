"""Evaluation metrics: MPJPE, PA-MPJPE (batched Procrustes), PVE, the
H36M joint regression and the uncertainty/error Pearson (port of
`poco_tpu.eval.metrics`).

Every metric is per sample, in the inputs' length unit (multiply by 1000
for mm), so split reports re-aggregate exactly. Procrustes is one batched
SVD of the (B, 3, 3) cross-covariance instead of the reference's
per-sample numpy loop (pocolib/utils/eval_utils.py:11-118). Everything is
fp32: the contractions go through cuBLAS, so callers keep TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's default), the
counterpart of the JAX package's `Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

from ..constants import H36M_TO_J14


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, J, 3) joints -> (B,) mean per-joint position error
    (reference eval_utils.py:99-107)."""
    return torch.linalg.norm(pred - gt, dim=-1).mean(dim=-1)


def vertex_error(pred_verts: torch.Tensor, gt_verts: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) meshes -> (B,) per-vertex error, PVE / V2V
    (reference eval_utils.py:109-118)."""
    return torch.linalg.norm(pred_verts - gt_verts, dim=-1).mean(dim=-1)


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Similarity alignment of pred (B, N, 3) onto gt (B, N, 3).

    Scale s, rotation R and translation t minimizing
    ||s * pred @ R^T + t - gt||^2 for every sample at once: R = V diag(d) U^T
    from the SVD U S V^T of the cross-covariance, with d = (1, 1,
    sign(det(U V^T))) as the reflection guard, and s = sum(S d) / var(pred)
    (the reference's compute_similarity_transform, eval_utils.py:11-82).
    R does not depend on the signs the SVD gives its singular vectors.
    """
    mu_p = pred.mean(dim=1, keepdim=True)
    mu_g = gt.mean(dim=1, keepdim=True)
    xp = pred - mu_p
    xg = gt - mu_g
    var_p = (xp**2).sum(dim=(1, 2))
    k = torch.einsum("bni,bnj->bij", xp, xg)
    u, s, vh = torch.linalg.svd(k)
    det = torch.linalg.det(u @ vh)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, torch.sign(det)], dim=-1)
    rot = (vh.transpose(-1, -2) * d[:, None, :]) @ u.transpose(-1, -2)
    scale = (s * d).sum(dim=-1) / var_p.clamp_min(1e-12)
    return scale[:, None, None] * torch.einsum("bij,bnj->bni", rot, xp) + mu_g


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE, per sample (reference eval_utils.py:84-97)."""
    return mpjpe(procrustes_align(pred, gt), gt)


def joints_from_vertices(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """17 H36M joints regressed from (B, V, 3) vertices with the (17, V)
    regressor, centered on the pelvis (H36M joint 0), the 14 LSP joints
    kept: (B, 14, 3) (reference eval_utils.py:62-75)."""
    j17 = torch.einsum("jv,bvk->bjk", j_regressor, vertices)
    j14 = j17[:, torch.as_tensor(H36M_TO_J14, device=j17.device)]
    return j14 - j17[:, 0:1]


def uncert_error_correlation(uncert: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of predicted uncertainty and actual error (the
    reference's confidence sanity metric, eval_utils.py:162-165)."""
    u = uncert - uncert.mean()
    e = err - err.mean()
    denom = torch.sqrt((u**2).sum() * (e**2).sum()) + 1e-12
    return (u * e).sum() / denom
