"""POCO composition: backbone -> head -> SMPL -> uncertainty -> flow.

Port of `poco_tpu.models.poco` (reference pocolib/models/poco.py:12-129
and hmr.py, the plain-HMR baseline of METHOD=spin): every backbone and
head family of the JAX registry.
Submodules carry the reference names `backbone`, `head`, `uncert_head`
and `flow_head`, so their state_dict keys are the reference checkpoint's.
`_forward` runs each part in a span (`utils/spans.py`): `poco/backbone`,
`poco/head`, `poco/smpl` (SMPL and the cameras), `poco/uncert`, `poco/flow`.

Batch dict (the JAX package's layout):
    img          (B, 224, 224, 3)  normalized crop, NHWC
    bbox_info    (B, 3)            CLIFF bbox descriptor    [cliff head]
    focal_length (B,)              full-image focal length  [cliff head]
    scale        (B,)              bbox height / 200        [cliff head]
    center       (B, 2)            bbox center (pixels)     [cliff head]
    orig_shape   (B, 2)            original (h, w)          [cliff head]
    gt_pose_rotmat    (B, 24, 3, 3)  optional: the flow head's log_phi
    gt_pose_cond_mask (B,)           optional, GT_POSE_COND calibration

Precision: the weights are fp32. `compute_precision(device_type, dtype)`
is the region that runs the model in bf16, as `POCO(dtype=jnp.bfloat16)`
of the JAX package does: the backbone, heads and uncertainty head compute
in bf16 (a bf16 autocast), SMPL and the cameras in fp32 (`_forward` shuts
the autocast off around them). Inference, the exported artifacts and the
trainer's `TRAINING.PRECISION: 16` all enter it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..device import resolve_device
from ..smpl.lbs import SmplParams
from ..smpl.model import smpl_head, smplcam_head
from ..utils import spans
from .backbones import resnet
from .backbones.common import flax_variance_update
from .backbones.hrnet import hrnet_w32, hrnet_w48, hrnet_w48_cls, hrnet_w64
from .backbones.tiny import tiny_cls, tiny_pose
from .heads.cliff import CliffHead
from .heads.flow import FlowHead
from .heads.hmr import HmrHead
from .heads.pare import PareHead
from .heads.poco_uncert import PocoUncertHead

BACKBONES = {
    "resnet18": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152,
    "resnext50_32x4d": resnet.resnext50_32x4d,
    "resnext101_32x8d": resnet.resnext101_32x8d,
    "wide_resnet50_2": resnet.wide_resnet50_2,
    "wide_resnet101_2": resnet.wide_resnet101_2,
    "hrnet_w32": hrnet_w32,
    "hrnet_w48": hrnet_w48,
    "hrnet_w48_cls": hrnet_w48_cls,
    "hrnet_w64": hrnet_w64,
    "tiny": tiny_cls,
    "tiny_pose": tiny_pose,
}


COMPUTE_DTYPES = {"fp32": None, "bf16": torch.bfloat16}


def compute_precision(device_type: str, dtype: torch.dtype | None):
    """The model's compute precision on `device_type` ("cuda" or "cpu"):
    a bf16 autocast for `dtype=torch.bfloat16`, nothing for None (fp32)."""
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"compute dtype {dtype}: the model computes in fp32 (None) or bf16")
    return torch.autocast(device_type, dtype=torch.bfloat16, enabled=dtype is not None)


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
        if cfg.head_name not in ("cliff", "pare", "hmr"):
            raise NotImplementedError(
                f"head {cfg.head_name!r}: the heads are cliff, pare and hmr"
            )
        self.cfg = cfg
        self.backbone = BACKBONES[cfg.backbone_name]()
        n_feat = self.backbone.out_channels
        if cfg.head_name == "cliff":
            self.head = CliffHead(num_input_features=n_feat)
        elif cfg.head_name == "pare":
            self.head = PareHead(num_input_features=n_feat, uncert_layer=cfg.uncert_layer)
        else:
            self.head = HmrHead(num_input_features=n_feat)
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
        with spans.span(spans.BACKBONE):
            features = self.backbone(batch["img"].permute(0, 3, 1, 2))
        with spans.span(spans.HEAD):
            head_out = (self.head(features, batch["bbox_info"]) if cfg.head_name == "cliff"
                        else self.head(features))
        # SMPL and the cameras run outside a bf16 autocast (PRECISION: 16):
        # SMPL in fp32, as the JAX package promotes a bf16 shape against its
        # fp32 SMPL tensors; the camera in the head's own dtype, as JAX
        # computes a bf16 camera's translation (POCO-PARE's) in bf16
        with spans.span(spans.SMPL), torch.autocast(features.device.type, enabled=False):
            rotmat, shape = (_full_precision(head_out[k]) for k in ("pred_pose", "pred_shape"))
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
            with spans.span(spans.UNCERT):
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
            with spans.span(spans.FLOW):
                output["log_phi"] = self.flow_head(
                    head_out["uncert_feat"],
                    head_out["pred_pose"],
                    batch["gt_pose_rotmat"],
                    output.get("var_pose"),
                )
        return output


def _full_precision(x: torch.Tensor) -> torch.Tensor:
    """fp32 for a bf16/fp16 tensor of an autocast region; fp32 and fp64 as they are."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def make_dummy_batch(
    cfg: PocoConfig, batch_size: int = 1, include_gt: bool = True, device="cuda"
) -> dict[str, torch.Tensor]:
    """A shape-correct batch of constants, for warm-up; with `include_gt`
    an identity GT pose (and an all-False GT_POSE_COND mask), so the
    forward also runs the flow head."""
    device = resolve_device(device)
    b = batch_size

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    batch = {
        "img": full((b, cfg.img_res, cfg.img_res, 3), 0.0),
        "bbox_info": full((b, 3), 0.0),
        "focal_length": full((b,), 1000.0),
        "scale": full((b,), 1.0),
        "center": full((b, 2), 500.0),
        "orig_shape": full((b, 2), 1000.0),
    }
    if include_gt:
        batch["gt_pose_rotmat"] = torch.eye(3, device=device).expand(b, 24, 3, 3)
        batch["gt_pose_cond_mask"] = torch.zeros(b, dtype=torch.bool, device=device)
    return batch


def _build(device, **config) -> POCO:
    device = resolve_device(device)
    return POCO(PocoConfig(**config)).to(device).eval()


def build_poco_cliff(device="cuda", **overrides) -> POCO:
    """The POCO-CLIFF model (configs/poco_cliff.yaml), in eval mode on
    `device`. Weights come from torch's global generator: seed it with
    `torch.manual_seed` for a repeatable random model."""
    return _build(device, **overrides)


def build_poco_pare(device="cuda", **overrides) -> POCO:
    """POCO-PARE (configs/poco_pare.yaml: HRNet-W32, PARE head, feat-pose
    uncertainty at 512 neurons, a 3-layer flow), in eval mode on `device`."""
    defaults = dict(
        backbone="hrnet_w32-pare",
        uncert_inp_type="feat-pose",
        num_neurons=(512,),
        num_flow_layers=3,
        gt_pose_cond=False,
    )
    defaults.update(overrides)
    return _build(device, **defaults)


def build_hmr(device="cuda", **overrides) -> POCO:
    """The HMR/SPIN baseline (configs/spin_hmr.yaml: ResNet-50, HMR head,
    no uncertainty or flow head), in eval mode on `device`."""
    defaults = dict(
        backbone="resnet50-hmr",
        uncert_layer="",
        loss_ver="mse",
        gt_pose_cond=False,
    )
    defaults.update(overrides)
    return _build(device, **defaults)
