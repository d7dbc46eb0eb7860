"""Conditional RealNVP normalizing flow over the pose residual (torch).

Port of `poco_tpu.models.heads.flow` (reference pocolib/models/layers/
real_nvp.py and pocolib/models/head/nf_head.py): an affine-coupling flow
over bar_pose = |pred - gt| / sigma, optionally conditioned on the pose
head's features, giving a per-part log-likelihood `log_phi`. It runs only
where a ground-truth pose is given (training, calibration).

Submodule names are the reference's: `cond_layer`, and `flow.s.{i}` /
`flow.t.{i}` as Sequential[Linear, LeakyReLU, Linear, LeakyReLU,
Linear(, Tanh)] (poco_tpu/utils/checkpoint_convert.py:271-284). The
coupling masks follow from the config, so they are a non-persistent
buffer, rebuilt at construction as the JAX converter rebuilds them.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...utils import spans


# Coupling masks (reference nf_head.py:20-29): (2 * num_layers, num_rv).

def get_alter_masks(num_rv: int, num_layers: int) -> np.ndarray:
    pair = [
        [i % 2 for i in range(num_rv)],
        [(i + 1) % 2 for i in reversed(range(num_rv))],
    ]
    return np.array(pair * num_layers, dtype=np.float32)


def get_new_masks(num_rv: int, num_layers: int) -> np.ndarray:
    split = math.floor(num_rv / 2)
    pair = [
        [min(i // split, 1) for i in range(num_rv)],
        [min(i // split, 1) for i in reversed(range(num_rv))],
    ]
    return np.array(pair * num_layers, dtype=np.float32)


def get_old_masks(num_rv: int, num_layers: int) -> np.ndarray:
    split = math.ceil(num_rv / 2)
    pair = [
        [i // split for i in range(num_rv)],
        [i // split for i in reversed(range(num_rv))],
    ]
    return np.array(pair * num_layers, dtype=np.float32)


MASK_BUILDERS = {"alter": get_alter_masks, "new": get_new_masks, "old": get_old_masks}


def coupling_net(num_in: int, hidden: int, num_out: int, final_tanh: bool) -> nn.Sequential:
    """3-layer MLP, LeakyReLU(0.01) between, tanh on scale nets
    (reference nf_head.py:13-17)."""
    layers = [
        nn.Linear(num_in, hidden), nn.LeakyReLU(0.01),
        nn.Linear(hidden, hidden), nn.LeakyReLU(0.01),
        nn.Linear(hidden, num_out),
    ]
    if final_tanh:
        layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class RealNVP(nn.Module):
    """Affine-coupling flow with an optional conditioning concat
    (reference real_nvp.py:25-70)."""

    def __init__(self, num_rv: int, num_coupling_layers: int, hidden: int = 64,
                 mask_type: str = "alter", context_dim: int = 0):
        super().__init__()
        self.num_rv = num_rv
        masks = MASK_BUILDERS[mask_type](num_rv, num_coupling_layers)
        self.register_buffer("mask", torch.from_numpy(masks), persistent=False)
        n_in = num_rv + context_dim
        self.s = nn.ModuleList(
            coupling_net(n_in, hidden, num_rv, final_tanh=True) for _ in masks
        )
        self.t = nn.ModuleList(
            coupling_net(n_in, hidden, num_rv, final_tanh=False) for _ in masks
        )

    def _st(self, i: int, masked: torch.Tensor, cond: torch.Tensor | None):
        inp = masked if cond is None else torch.cat([masked, cond], dim=1)
        inv = 1.0 - self.mask[i]
        return self.s[i](inp) * inv, self.t[i](inp) * inv

    def forward_p(self, z: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        """Latent -> data (the sampling direction)."""
        x = z
        for i in range(len(self.s)):
            x_masked = x * self.mask[i]
            s, t = self._st(i, x_masked, cond)
            x = x_masked + (1.0 - self.mask[i]) * (x * torch.exp(s) + t)
        return x

    def backward_p(
        self, x: torch.Tensor, cond: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Data -> latent, with log |det J|."""
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        z = x
        for i in reversed(range(len(self.s))):
            z_masked = z * self.mask[i]
            s, t = self._st(i, z_masked, cond)
            z = (1.0 - self.mask[i]) * (z - t) * torch.exp(-s) + z_masked
            log_det = log_det - s.sum(dim=1)
        return z, log_det

    def log_prob(self, x: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        z, log_det = self.backward_p(x, cond)
        prior = -0.5 * (z**2).sum(dim=1) - 0.5 * self.num_rv * math.log(2 * math.pi)
        return prior + log_det

    def sample(self, batch: int, generator: torch.Generator,
               cond: torch.Tensor | None = None) -> torch.Tensor:
        """`batch` draws; the standard-normal latents come from `generator`
        (on the flow's device)."""
        z = torch.randn(
            (batch, self.num_rv), generator=generator, device=self.mask.device,
            dtype=self.mask.dtype,
        )
        return self.forward_p(z, cond)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        return self.log_prob(x, cond)


class FlowHead(nn.Module):
    """Flow over the sigma-normalized pose residual (reference nf_head.py:
    32-136)."""

    def __init__(
        self,
        num_input_features: int,
        num_nf_rv: int = 9,
        num_flow_layers: int = 1,
        nflow_mask_type: str = "alter",
        cond_nflow: bool = True,
        context_dim: int = 512,
        exclude_uncert_idx: Sequence[int] = (),
        mask_params_id: Sequence[int] = (),
        num_joints: int = 24,
    ):
        super().__init__()
        self.num_nf_rv = num_nf_rv
        self.num_joints = num_joints
        self.sel_parts = [j for j in range(num_joints) if j not in exclude_uncert_idx]
        self.mask_params_id = list(mask_params_id)
        if cond_nflow:
            self.cond_layer = nn.Linear(num_input_features, context_dim)
        self.flow = RealNVP(
            num_nf_rv, num_flow_layers, mask_type=nflow_mask_type,
            context_dim=context_dim if cond_nflow else 0,
        )

    def forward(
        self,
        uncert_feat: torch.Tensor,
        pred_pose: torch.Tensor,
        gt_pose_rotmat: torch.Tensor,
        var_pose: torch.Tensor | None,
    ) -> torch.Tensor:
        """log phi of every sample (the loss masks by has_smpl).

        Args:
            uncert_feat: (B, C) pose-head features, the condition.
            pred_pose, gt_pose_rotmat: (B, 24, 3, 3).
            var_pose: (B, P) or (B, P, 3, 3) predicted sigma, or None for
                the raw residual.
        Returns:
            (B, P * 9 / num_nf_rv) per-part log-likelihoods.
        """
        batch = pred_pose.shape[0]
        with spans.span(spans.SYNC_FLOW_PARTS, wait=True):   # the list index goes to the card
            pred = pred_pose[:, self.sel_parts]
            gt = gt_pose_rotmat[:, self.sel_parts]
        sigma = torch.ones_like(pred) if var_pose is None else var_pose
        if sigma.ndim == 2:
            sigma = sigma[:, :, None, None].expand(-1, -1, 3, 3)
        bar_pose = (pred - gt).abs() / (sigma + 1e-9)
        if self.num_nf_rv == self.num_joints:
            bar_pose = bar_pose.mean(dim=(-1, -2))
        bar_pose = bar_pose.reshape(-1, self.num_nf_rv)

        cond = None
        if hasattr(self, "cond_layer"):
            cond = self.cond_layer(uncert_feat)
            reps = bar_pose.shape[0] // batch
            if reps > 1:
                cond = torch.repeat_interleave(cond, reps, dim=0)

        log_phi = self.flow.log_prob(bar_pose, cond).reshape(batch, -1)
        if (
            log_phi.shape[1] == self.num_joints
            and self.mask_params_id
            and len(self.sel_parts) == self.num_joints
        ):
            keep = torch.ones(self.num_joints, dtype=log_phi.dtype, device=log_phi.device)
            keep[self.mask_params_id] = 0.0
            log_phi = log_phi * keep
        return log_phi
