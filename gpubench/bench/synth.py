"""Everything a run makes from its seed, on the device and in a few large
calls: the weights (through the reference model), the SMPL model file,
the frames and boxes of the `frames` traffic and the batches of the
`train_batches` traffic. Both sides get what this module makes; neither
makes it."""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from reference.constants import SMPL_PARENTS
from reference.lbs import SmplParams
from reference.poco import PocoConfig
from reference.preprocess import calculate_bbox_info, calculate_focal_length, normalize_image
from reference.rotation import axis_angle_to_rotmat
from reference.smpl_model import smpl_49

NUM_EXTRA_JOINTS = 9


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` for the seed (any whole number: it is
    folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def seeded_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Every parameter from one uniform draw on the model's device: each
    leaf U(-b, b), b the largest magnitude the module's own initializer
    gave it (so a layer initialized small stays small, a zero one stays
    zero); BN layers' gains U(0.5, 1.5) and shifts U(-0.05, 0.05)."""
    params = list(model.parameters())
    bn = {}
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.affine:
            bn[id(m.weight)] = (0.5, 1.0)
            bn[id(m.bias)] = (0.05, 0.0)
    bounds = torch.stack(torch._foreach_norm(params, float("inf"))).tolist()
    scales = [bn.get(id(p), (b, 0.0))[0] for p, b in zip(params, bounds)]
    offsets = [bn.get(id(p), (b, 0.0))[1] for p, b in zip(params, bounds)]
    flat = torch.empty(sum(p.numel() for p in params), device=params[0].device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    views = [v.view_as(p) for v, p in zip(flat.split([p.numel() for p in params]), params)]
    torch._foreach_mul_(views, scales)
    torch._foreach_add_(views, offsets)
    with torch.no_grad():
        torch._foreach_copy_(params, views)


def calibrate_batchnorm(module: nn.Module, *inputs) -> None:
    """Every BN layer's running statistics set to those of one batch: a
    train-mode pass at momentum 1 (the benchmark's copy of
    `poco_tpu_torch/utils/weights.py:calibrate_batchnorm`)."""
    bns = [m for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    module.train()
    with torch.no_grad():
        module(*inputs)
    module.eval()
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum


def tf32(on: bool) -> None:
    """TF32 for matmuls and convolutions on or off (the controls' precision)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ref_config(model_cfg: dict):
    """The reference's PocoConfig of a configuration's `model` group."""
    return PocoConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()})


def reference_model(model_cls, cfg, seed: int, device, crops_nchw: torch.Tensor) -> nn.Module:
    """The frozen reference model with the seed's weights, its BN layers
    calibrated on `crops_nchw` (the head's too, where it has BN layers)."""
    torch.manual_seed(int(seed) % 2**63)   # the initializers' scales (`seeded_weights`)
    with torch.device(device):
        model = model_cls(cfg)
    model.to(device)
    seeded_weights(model, generator(seed + 1, device))
    calibrate_batchnorm(model.backbone, crops_nchw)
    if any(isinstance(m, nn.BatchNorm2d) for m in model.head.modules()):
        calibrate_batchnorm(model.head, model.backbone(crops_nchw))
    model.eval()
    return model


def smpl_arrays(gen: torch.Generator, device, num_verts: int, num_faces: int,
                num_betas: int = 10) -> dict[str, torch.Tensor]:
    """A synthetic SMPL at the published sizes, as a model file holds it:
    template in [-1, 1], small shape and pose blendshapes, row-normalized
    joint and extra regressors, softmax skinning weights, random faces."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    j_reg = rand(24, num_verts) ** 4
    extra = rand(NUM_EXTRA_JOINTS, num_verts) ** 4
    return {
        "v_template": 2.0 * rand(num_verts, 3) - 1.0,
        "shapedirs": 0.03 * randn(num_verts, 3, num_betas),
        "posedirs": 0.01 * randn(num_verts, 3, 207),
        "J_regressor": j_reg / j_reg.sum(1, keepdim=True),
        "weights": torch.softmax(2.0 * randn(num_verts, 24), dim=1),
        "J_regressor_extra": extra / extra.sum(1, keepdim=True),
        "f": torch.randint(0, num_verts, (num_faces, 3), generator=gen, device=device,
                           dtype=torch.int32),
    }


def write_smpl_files(arrays: dict[str, torch.Tensor], directory: str) -> tuple[str, str]:
    """The SMPL arrays as a user's model file: `SMPL_NEUTRAL.npz` (with its
    kinematic tree) and the extra regressor `J_regressor_extra.npy`."""
    os.makedirs(directory, exist_ok=True)
    host = {k: v.cpu().numpy() for k, v in arrays.items()}
    model_path = os.path.join(directory, "SMPL_NEUTRAL.npz")
    extra_path = os.path.join(directory, "J_regressor_extra.npy")
    kintree = np.stack([np.asarray(SMPL_PARENTS, np.int64), np.arange(24)])
    np.savez(model_path, kintree_table=kintree,
             **{k: v for k, v in host.items() if k != "J_regressor_extra"})
    np.save(extra_path, host["J_regressor_extra"])
    return model_path, extra_path


def frame_pool(gen: torch.Generator, device, traffic: dict) -> list[np.ndarray]:
    """The frames of the `frames` traffic: uint8 RGB noise, held on the host."""
    frames = torch.randint(0, 256, (traffic["frames"], traffic["frame_height"],
                                    traffic["frame_width"], 3),
                           generator=gen, device=device, dtype=torch.uint8)
    return list(frames.cpu().numpy())


def box_sets(gen: torch.Generator, device, traffic: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """`box_sets` sets of `boxes` boxes: centres uniform in [margin, w - margin]
    x [margin, h - margin], scales (height / 200) uniform in [scale_min, scale_max]."""
    n, k = traffic["box_sets"], traffic["boxes"]
    h, w, margin = traffic["frame_height"], traffic["frame_width"], traffic["center_margin"]
    u = torch.rand((n, k, 3), generator=gen, device=device).cpu().numpy()
    cx = margin + u[..., 0] * (w - 2 * margin)
    cy = margin + u[..., 1] * (h - 2 * margin)
    s = traffic["scale_min"] + u[..., 2] * (traffic["scale_max"] - traffic["scale_min"])
    centers = np.stack([cx, cy], axis=-1).astype(np.float32)
    return [(centers[i], s[i].astype(np.float32)) for i in range(n)]


def train_batches(gen: torch.Generator, device, traffic: dict, model_cfg: dict,
                  smpl: SmplParams) -> list[dict[str, torch.Tensor]]:
    """The batches of the `train_batches` traffic on the device, in the
    schema of the port's training batch (`poco_tpu_torch/data/dataset.py`):
    seeded crops, GT pose uniform in +-pose_range rad axis-angle, betas in
    +-betas_range, the datasets drawn by their ratios, 3D joints (from the
    GT mesh) on the rows of `three_d` datasets, full-image keypoints placed
    in the box, and the GT_POSE_COND mask of the configuration (the first
    `gt_pose_cond_ratio` of the rows of `gt_pose_cond_ds`)."""
    b, n = traffic["batch"], traffic["batches"]
    h, w = traffic["frame_height"], traffic["frame_width"]
    names = list(traffic["datasets"])
    ratios = torch.tensor([traffic["datasets"][k] for k in names], device=device)
    three_d = torch.tensor([k in traffic["three_d"] for k in names], device=device)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    batches = []
    for _ in range(n):
        noise = torch.randint(0, 256, (b, 224, 224, 3), generator=gen, device=device)
        gain = uniform(*traffic["gain"], b, 1, 1, 1)
        offset = uniform(*traffic["offset"], b, 1, 1, 1)
        crops = (offset + gain * noise.float()).clamp(0.0, 255.0)
        pose = uniform(-traffic["pose_range"], traffic["pose_range"], b, 72)
        betas = uniform(-traffic["betas_range"], traffic["betas_range"], b, 10)
        ds = torch.multinomial(ratios, b, replacement=True, generator=gen)
        center = torch.stack([uniform(*traffic["center_x"], b), uniform(*traffic["center_y"], b)], 1)
        scale = uniform(*traffic["scale"], b)
        orig_shape = torch.tensor([[h, w]], dtype=torch.float32, device=device).expand(b, 2)
        with torch.no_grad():
            rot = axis_angle_to_rotmat(pose.reshape(-1, 3)).reshape(b, 24, 3, 3)
            _, joints = smpl_49(smpl, betas, rot)
        has_3d = three_d[ds].float()
        box = (scale * 200.0)[:, None]
        kp_xy = center[:, None] + 0.5 * box[..., None] * joints[..., :2]
        ones = torch.ones((b, 49, 1), device=device)
        cond = torch.zeros(b, dtype=torch.bool, device=device)
        if model_cfg.get("gt_pose_cond"):
            rows = torch.nonzero(ds == names.index(model_cfg["gt_pose_cond_ds"]))[:, 0]
            cond[rows[: int(model_cfg["gt_pose_cond_ratio"] * len(rows))]] = True
        batches.append({
            "img": normalize_image(crops),
            "pose": pose,
            "betas": betas,
            "pose_3d": torch.cat([joints[:, 25:], ones[:, :24]], -1) * has_3d[:, None, None],
            "keypoints": torch.cat([2.0 * (kp_xy - center[:, None]) / box[..., None], ones], -1),
            "keypoints_fullimg": torch.cat([kp_xy, ones], -1),
            "has_smpl": torch.ones(b, device=device),
            "has_pose_3d": has_3d,
            "scale": scale,
            "center": center,
            "orig_shape": orig_shape,
            "focal_length": calculate_focal_length(orig_shape[:, 0], orig_shape[:, 1]),
            "bbox_info": calculate_bbox_info(center, scale, orig_shape),
            "gt_pose_cond_mask": cond,
        })
    return batches
