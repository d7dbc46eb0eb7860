# Frozen copy of poco_tpu_torch/models/poco.py at commit 48ff100 (see __init__.py):
# PocoConfig and POCO as they stand; the backbone registry holds the two
# HRNets the benchmark runs, and the bf16 region, the dummy batch and the
# builders are left out.
"""POCO composition: backbone -> head -> SMPL -> uncertainty -> flow."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from .cliff import CliffHead
from .common import flax_variance_update
from .flow import FlowHead
from .hrnet import hrnet_w32, hrnet_w48_cls
from .lbs import SmplParams
from .pare import PareHead
from .poco_uncert import PocoUncertHead
from .smpl_model import smpl_head, smplcam_head

BACKBONES = {
    "hrnet_w32": hrnet_w32,
    "hrnet_w48_cls": hrnet_w48_cls,
}


@dataclasses.dataclass(frozen=True)
class PocoConfig:
    """Model hyperparameters (mirrors `poco_tpu.models.poco.PocoConfig`)."""

    backbone: str = "hrnet_w48_cls-cliff"   # "<backbone>-<head>"
    img_res: int = 224
    uncert_layer: str = "diff_branch"
    activation_type: str = "sigmoid"
    uncert_type: str = "pose"
    uncert_inp_type: str = "feat-pose-net"
    loss_ver: str = "norm_flow_res_gaus"
    num_neurons: tuple[int, ...] = (216,)
    num_flow_layers: int = 1
    sigma_dim: int = 1
    num_nf_rv: int = 9
    mask_params_id: tuple[int, ...] = ()
    nflow_mask_type: str = "alter"
    exclude_uncert_idx: tuple[int, ...] = ()
    use_dropout: bool = True
    use_iter_feats: bool = True
    cond_nflow: bool = True
    context_dim: int = 512
    gt_pose_cond: bool = True
    gt_pose_cond_ds: str = "h36m"
    gt_pose_cond_ratio: float = 0.25

    @property
    def backbone_name(self) -> str:
        return self.backbone.split("-")[0]

    @property
    def head_name(self) -> str:
        parts = self.backbone.split("-")
        return parts[1] if len(parts) > 1 else "hmr"

    @property
    def has_uncert_head(self) -> bool:
        return "diff_branch" in self.uncert_layer

    @property
    def has_flow_head(self) -> bool:
        return "norm_flow" in self.loss_ver

    @staticmethod
    def parse_num_neurons(spec: str) -> tuple[int, ...]:
        """'216-' -> (216,), '1024-512' -> (1024, 512)."""
        return tuple(int(x) for x in spec.split("-") if x)


class POCO(nn.Module):
    """POCO with a CLIFF, PARE or HMR head; `forward` is the inference
    graph, plus the flow head's `log_phi` when the batch has a GT pose."""

    def __init__(self, cfg: PocoConfig = PocoConfig()):
        super().__init__()
        if cfg.backbone_name not in BACKBONES:
            raise NotImplementedError(
                f"backbone {cfg.backbone_name!r} is not in the registry "
                f"({sorted(BACKBONES)})"
            )
        if cfg.head_name not in ("cliff", "pare"):
            raise NotImplementedError(f"head {cfg.head_name!r}: the heads are cliff and pare")
        self.cfg = cfg
        self.backbone = BACKBONES[cfg.backbone_name]()
        n_feat = self.backbone.out_channels
        if cfg.head_name == "cliff":
            self.head = CliffHead(num_input_features=n_feat)
        else:
            self.head = PareHead(num_input_features=n_feat, uncert_layer=cfg.uncert_layer)
        head_channels = self.head.get_output_channels()
        if cfg.has_uncert_head:
            self.uncert_head = PocoUncertHead(
                num_input_channels=head_channels,
                num_neurons=cfg.num_neurons,
                sigma_dim=cfg.sigma_dim,
                activation_type=cfg.activation_type,
                use_dropout=cfg.use_dropout,
                uncert_inp_type=cfg.uncert_inp_type,
                exclude_uncert_idx=cfg.exclude_uncert_idx,
                loss_ver=cfg.loss_ver,
            )
        if cfg.has_flow_head:
            self.flow_head = FlowHead(
                num_input_features=head_channels,
                num_nf_rv=cfg.num_nf_rv,
                num_flow_layers=cfg.num_flow_layers,
                nflow_mask_type=cfg.nflow_mask_type,
                cond_nflow=cfg.cond_nflow,
                context_dim=cfg.context_dim,
                exclude_uncert_idx=cfg.exclude_uncert_idx,
                mask_params_id=cfg.mask_params_id,
            )

    def forward(self, batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict[str, Any]:
        if not self.training:
            return self._forward(batch, smpl)
        # in training, BN's running variances follow flax's biased update
        with flax_variance_update(self):
            return self._forward(batch, smpl)

    def _forward(self, batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict[str, Any]:
        cfg = self.cfg
        features = self.backbone(batch["img"].permute(0, 3, 1, 2))
        head_out = (self.head(features, batch["bbox_info"]) if cfg.head_name == "cliff"
                    else self.head(features))
        rotmat, shape = (head_out[k] for k in ("pred_pose", "pred_shape"))
        cam = head_out["pred_cam"]
        if cfg.head_name == "cliff":
            s = smplcam_head(
                smpl,
                rotmat=rotmat,
                shape=shape,
                cam=cam,
                focal_length=batch["focal_length"],
                bbox_scale=batch["scale"],
                bbox_center=batch["center"],
                img_h=batch["orig_shape"][:, 0],
                img_w=batch["orig_shape"][:, 1],
                img_res=cfg.img_res,
            )
        else:
            s = smpl_head(
                smpl,
                rotmat=rotmat,
                shape=shape,
                cam=cam,
                img_res=cfg.img_res,
                normalize_joints2d=True,
            )
        output = dict(head_out)
        output.update(
            smpl_vertices=s.vertices,
            smpl_joints3d=s.joints3d,
            smpl_joints2d=s.joints2d,
            pred_cam_t=s.cam_t,
        )
        if s.fullimg_cam_t is not None:
            output["pred_fullimg_cam_t"] = s.fullimg_cam_t
        if cfg.has_uncert_head:
            cond = cfg.gt_pose_cond
            output.update(self.uncert_head(
                head_out["uncert_feat"],
                head_out["pred_pose"],
                gt_pose_rotmat=batch.get("gt_pose_rotmat") if cond else None,
                gt_pose_cond_mask=batch.get("gt_pose_cond_mask") if cond else None,
            ))
        # The flow log-likelihood exists only with a GT pose (reference
        # nf_head.py:128-130 returns None at inference).
        output["log_phi"] = None
        if cfg.has_flow_head and "gt_pose_rotmat" in batch:
            output["log_phi"] = self.flow_head(
                head_out["uncert_feat"],
                head_out["pred_pose"],
                batch["gt_pose_rotmat"],
                output.get("var_pose"),
            )
        return output
