"""Independent checks of the eval path, shared by `chip_smoke.py` and the
tests: a float64 numpy Procrustes, and a flip-equivariant stub model with
an eval batch whose images encode its ground truth."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SMPL_JOINTS_FLIP_PERM
from ..ops.rotation import axis_angle_to_rotmat
from ..smpl.lbs import smpl_forward


def procrustes_f64(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred (B, N, 3) aligned onto gt by the reference's per-sample
    Procrustes (pocolib/utils/eval_utils.py:11-82), in float64 numpy."""
    out = []
    for p, g in zip(pred.astype(np.float64), gt.astype(np.float64)):
        x1, x2 = p - p.mean(0), g - g.mean(0)
        k = x1.T @ x2
        u, _, vh = np.linalg.svd(k)
        r = vh.T @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vh))]) @ u.T
        out.append(np.trace(r @ k) / np.sum(x1**2) * x1 @ r.T + g.mean(0))
    return np.stack(out)


class EquivariantStub:
    """A flip-equivariant model: it reads the pose that the (possibly
    mirrored) image depicts, so for the mirrored image it reports flip(R)
    (the stub of tests/test_eval.py:206-261)."""

    def __init__(self, width: int):
        self.width = width

    def __call__(self, batch, smpl):
        im = batch["img"]
        perm = torch.as_tensor(SMPL_JOINTS_FLIP_PERM, device=im.device)
        flag = im[:, 1, 0, 0][:, None, None]  # 1 = original, 0 = mirrored
        dec_mirror = im[:, 0, self.width - 24:, :].flip(1)[:, perm, :]
        dec_mirror = dec_mirror * torch.tensor([1.0, -1.0, -1.0], device=im.device)
        dec = flag * im[:, 0, :24, :] + (1.0 - flag) * dec_mirror
        rot = axis_angle_to_rotmat(dec.reshape(-1, 3)).reshape(-1, 24, 3, 3)
        shape = torch.zeros(dec.shape[0], 10, device=im.device)
        return {"smpl_vertices": smpl_forward(smpl, shape, rot).vertices,
                "pred_pose": rot, "pred_shape": shape}


def equivariant_case(device, batch: int = 8, height: int = 32, width: int = 48, seed: int = 7):
    """The stub and an eval batch whose images encode its GT pose
    (axis-angles in row 0, an original-orientation flag at (1, 0))."""
    rng = np.random.RandomState(seed)
    aa = rng.uniform(-0.4, 0.4, (batch, 24, 3)).astype(np.float32)
    img = np.zeros((batch, height, width, 3), np.float32)
    img[:, 0, :24, :] = aa
    img[:, 1, 0, 0] = 1.0
    return EquivariantStub(width), {
        "img": torch.from_numpy(img).to(device),
        "pose": torch.from_numpy(aa.reshape(batch, 72)).to(device),
        "betas": torch.zeros(batch, 10, device=device),
        "gender": -torch.ones(batch, dtype=torch.int32, device=device),
    }
