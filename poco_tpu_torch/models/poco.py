"""POCO-CLIFF composition: backbone -> CLIFF head -> SMPL -> uncertainty.

Port of `poco_tpu.models.poco` for the `cliff` head (reference
pocolib/models/poco.py:12-129). Submodules carry the reference names
`backbone`, `head` and `uncert_head`, so their state_dict keys are the
reference checkpoint's.

Batch dict (the JAX package's layout):
    img          (B, 224, 224, 3)  normalized crop, NHWC
    bbox_info    (B, 3)            CLIFF bbox descriptor
    focal_length (B,)              full-image focal length
    scale        (B,)              bbox height / 200
    center       (B, 2)            bbox center (pixels)
    orig_shape   (B, 2)            original (h, w)
    gt_pose_rotmat    (B, 24, 3, 3)  optional, training only
    gt_pose_cond_mask (B,)           optional, training only
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..device import resolve_device
from ..smpl.lbs import SmplParams
from ..smpl.model import smplcam_head
from .backbones.hrnet import NUM_FEATURES, hrnet_w48_cls
from .heads.cliff import CliffHead
from .heads.poco_uncert import PocoUncertHead

BACKBONES = {"hrnet_w48_cls": hrnet_w48_cls}
BACKBONE_CHANNELS = {"hrnet_w48_cls": NUM_FEATURES}


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
    """POCO with the CLIFF head; `forward` is the inference graph."""

    def __init__(self, cfg: PocoConfig = PocoConfig()):
        super().__init__()
        if cfg.head_name != "cliff" or cfg.backbone_name not in BACKBONES:
            raise NotImplementedError(
                f"backbone {cfg.backbone!r}: only "
                f"{sorted(BACKBONES)} with the cliff head are ported"
            )
        self.cfg = cfg
        self.backbone = BACKBONES[cfg.backbone_name]()
        self.head = CliffHead(
            num_input_features=BACKBONE_CHANNELS[cfg.backbone_name]
        )
        if cfg.has_uncert_head:
            self.uncert_head = PocoUncertHead(
                num_input_channels=self.head.get_output_channels(),
                num_neurons=cfg.num_neurons,
                sigma_dim=cfg.sigma_dim,
                activation_type=cfg.activation_type,
                use_dropout=cfg.use_dropout,
                uncert_inp_type=cfg.uncert_inp_type,
                exclude_uncert_idx=cfg.exclude_uncert_idx,
                loss_ver=cfg.loss_ver,
            )

    def forward(self, batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict[str, Any]:
        cfg = self.cfg
        if cfg.has_flow_head and "gt_pose_rotmat" in batch:
            raise NotImplementedError(
                "the RealNVP flow head (log_phi with a GT pose) is not ported"
            )
        features = self.backbone(batch["img"].permute(0, 3, 1, 2))
        head_out = self.head(features, batch["bbox_info"])
        s = smplcam_head(
            smpl,
            rotmat=head_out["pred_pose"],
            shape=head_out["pred_shape"],
            cam=head_out["pred_cam"],
            focal_length=batch["focal_length"],
            bbox_scale=batch["scale"],
            bbox_center=batch["center"],
            img_h=batch["orig_shape"][:, 0],
            img_w=batch["orig_shape"][:, 1],
            img_res=cfg.img_res,
        )
        output = dict(head_out)
        output.update(
            smpl_vertices=s.vertices,
            smpl_joints3d=s.joints3d,
            smpl_joints2d=s.joints2d,
            pred_cam_t=s.cam_t,
            pred_fullimg_cam_t=s.fullimg_cam_t,
        )
        if cfg.has_uncert_head:
            cond = cfg.gt_pose_cond
            output.update(self.uncert_head(
                head_out["uncert_feat"],
                head_out["pred_pose"],
                gt_pose_rotmat=batch.get("gt_pose_rotmat") if cond else None,
                gt_pose_cond_mask=batch.get("gt_pose_cond_mask") if cond else None,
            ))
        # The flow log-likelihood exists only with a GT pose (training).
        output["log_phi"] = None
        return output


def make_dummy_batch(
    cfg: PocoConfig, batch_size: int = 1, device="cuda"
) -> dict[str, torch.Tensor]:
    """A shape-correct batch of constants, for warm-up."""
    device = resolve_device(device)
    b = batch_size

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "img": full((b, cfg.img_res, cfg.img_res, 3), 0.0),
        "bbox_info": full((b, 3), 0.0),
        "focal_length": full((b,), 1000.0),
        "scale": full((b,), 1.0),
        "center": full((b, 2), 500.0),
        "orig_shape": full((b, 2), 1000.0),
    }


def build_poco_cliff(device="cuda", **overrides) -> POCO:
    """The POCO-CLIFF model (configs/poco_cliff.yaml), in eval mode on
    `device`. Weights come from torch's global generator: seed it with
    `torch.manual_seed` for a repeatable random model."""
    device = resolve_device(device)
    return POCO(PocoConfig(**overrides)).to(device).eval()
