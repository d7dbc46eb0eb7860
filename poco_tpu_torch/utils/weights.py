"""Weights carried between the JAX package's variable tree and the port.

`state_dict_from_jax` is the inverse of the torch -> flax converter
(`poco_tpu/utils/checkpoint_convert.py:36-81`): it takes the JAX model's
variables (`params`, `batch_stats`, `buffers`, as numpy arrays) and
returns the port's state_dict, with reference torch names;
`yolo_state_dict_from_jax` does the same for the demo's YOLOv3. It also holds
the helpers that give a randomly initialized model well-scaled batch-norm
statistics, for runs without a checkpoint.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.array(v, np.float32)
    return out


_CONV_BN = {"conv": 0, "bn": 1}


def _block_name(path: str) -> str | None:
    """'{n}/conv1' -> '{n}.conv1'; '{n}/downsample_conv' -> '{n}.downsample.0'."""
    m = re.fullmatch(r"(\d+)/((?:conv|bn)\d)", path)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"(\d+)/downsample_(conv|bn)", path)
    if m:
        return f"{m.group(1)}.downsample.{_CONV_BN[m.group(2)]}"
    return None


def _backbone_torch_name(path: str) -> str | None:
    """flax module path under `backbone_net` (HRNet or ResNet) -> torch
    module name."""
    if re.fullmatch(r"(conv|bn)\d", path):
        return path
    m = re.fullmatch(r"layer(\d)/(.+)", path)
    if m and _block_name(m.group(2)):
        return f"layer{m.group(1)}.{_block_name(m.group(2))}"
    m = re.fullmatch(r"transition(\d)_(\d+)_(conv|bn)(\d+)", path)
    if m:
        t, i, kind, k = m.groups()
        if int(i) < int(t):  # an existing branch: one conv + BN
            return f"transition{t}.{i}.{_CONV_BN[kind]}"
        return f"transition{t}.{i}.{k}.{_CONV_BN[kind]}"  # a new branch: a chain
    m = re.fullmatch(r"stage(\d)_(\d+)/branch(\d+)/(.+)", path)
    if m and _block_name(m.group(4)):
        s, mm, b, rest = m.groups()
        return f"stage{s}.{mm}.branches.{b}.{_block_name(rest)}"
    m = re.fullmatch(r"stage(\d)_(\d+)/fuse_(\d+)_(\d+)_(conv|bn)(\d+)", path)
    if m:
        s, mm, i, j, kind, k = m.groups()
        if int(j) > int(i):
            return f"stage{s}.{mm}.fuse_layers.{i}.{j}.{_CONV_BN[kind]}"
        return f"stage{s}.{mm}.fuse_layers.{i}.{j}.{k}.{_CONV_BN[kind]}"
    m = re.fullmatch(r"incre(\d)/(.+)", path)
    if m and _block_name(m.group(2)):
        return f"incre_modules.{m.group(1)}.{_block_name(m.group(2))}"
    m = re.fullmatch(r"downsamp(\d)_(conv|bn)", path)
    if m:
        return f"downsamp_modules.{m.group(1)}.{_CONV_BN[m.group(2)]}"
    if path in ("final_conv", "final_bn"):
        return f"final_layer.{0 if path == 'final_conv' else 1}"
    # pose merge: [Upsample, conv, BN, ReLU] repeats (conv at 4k+1), or
    # [conv, BN, ReLU] repeats (conv at 3k)
    m = re.fullmatch(r"(upsample|downsample)_stage_(\d)_(conv|bn)(\d+)", path)
    if m:
        direction, b, kind, k = m.groups()
        if direction == "upsample":
            return f"upsample_stage_{b}.{4 * int(k) + 1 + _CONV_BN[kind]}"
        return f"downsample_stage_{b}.{3 * int(k) + _CONV_BN[kind]}"
    return None


_NONLOCAL = (
    "branch_2d_nonlocal|branch_3d_nonlocal|final_pose_nonlocal|"
    "final_shape_nonlocal|branch_iter_3d_nonlocal"
)


def _head_torch_name(path: str) -> str | None:
    """flax module path under `head` (CLIFF, HMR or PARE) -> torch name."""
    if re.fullmatch(
        r"fc1|fc2|decpose|decshape|deccam|shape_mlp|cam_mlp|pose_mlp|uncert_mlp|"
        r"(keypoint|smpl)_final_layer(_pre|_prebn)?|coattention/(linear_e|gate|final_conv_\d)|"
        rf"({_NONLOCAL})/(g|theta|phi|w|w_bn)",
        path,
    ):
        return path.replace("/", ".")
    m = re.fullmatch(r"(keypoint|smpl)_deconv_(conv|bn)(\d+)", path)
    if m:  # [conv, BN, ReLU] repeats
        branch, kind, k = m.groups()
        return f"{branch}_deconv_layers.{3 * int(k) + _CONV_BN[kind]}"
    m = re.fullmatch(r"coattention/final_conv_(\d)_(c|bn)(\d)", path)
    if m:  # [conv, BN, ReLU] repeats
        tag, kind, r = m.groups()
        return f"coattention.final_conv_{tag}.{3 * int(r) + (kind == 'bn')}"
    return None


_UNCERT_NAMES = {"poseNet_fc": "uncert_fc_poseNet", "featNet_fc": "uncert_fc_featNet"}


def _torch_module_name(top: str, path: str) -> str | None:
    if top == "backbone_net":
        name = _backbone_torch_name(path)
    elif top == "head":
        name = _head_torch_name(path)
    elif top == "uncert_head":
        name = _UNCERT_NAMES.get(path)
        if re.fullmatch(r"fc\d+", path):
            name = f"uncert_{path}"
    elif top == "flow_head":
        name = "cond_layer" if path == "cond_layer" else None
        m = re.fullmatch(r"flow/(s|t)(\d+)/fc(\d)", path)
        if m:  # Sequential[Linear, LeakyReLU, Linear, LeakyReLU, Linear(, Tanh)]
            st, i, k = m.groups()
            name = f"flow.{st}.{i}.{2 * int(k)}"
    else:
        name = None
    return None if name is None else f"{top.removesuffix('_net')}.{name}"


_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "weight"): "weight",   # PerPositionConv1x1 (lc2d)
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    """conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
    lc2d weights (H, W, O, C) -> the reference (1, O, C, H, W, 1)."""
    if leaf == "kernel":
        return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    if leaf == "weight":
        return value.transpose(2, 3, 0, 1)[None, ..., None]
    return value


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX POCO variables -> the port's state_dict.

    Layouts as `_torch_layout`; BN scale/bias -> weight/bias with mean/var
    -> running_mean/var (and a zero `num_batches_tracked`);
    `buffers/head/init_*` -> `head.init_*`. Every leaf of a POCO-CLIFF,
    POCO-PARE or HMR tree has a place; a leaf that has none raises.
    """
    state: dict[str, torch.Tensor] = {}
    unknown = []
    for col in ("params", "batch_stats", "buffers"):
        for path, value in _flatten(variables.get(col, {})).items():
            key = "/".join((col,) + path)
            if col == "buffers":
                if path[0] == "head" and len(path) == 2 and path[1].startswith("init_"):
                    state[f"head.{path[1]}"] = torch.from_numpy(value.reshape(1, -1))
                else:
                    unknown.append(key)
                continue
            module = _torch_module_name(path[0], "/".join(path[1:-1]))
            leaf = _LEAF_NAMES.get((col, path[-1]))
            if module is None or leaf is None:
                unknown.append(key)
                continue
            value = _torch_layout(path[-1], value)
            state[f"{module}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
            if leaf == "running_mean":
                state[f"{module}.num_batches_tracked"] = torch.tensor(0)
    if unknown:
        raise KeyError(f"JAX leaves with no place in the port: {unknown}")
    return state


def randomize_batchnorm(module: nn.Module, generator: torch.Generator) -> None:
    """Give every BN layer non-trivial affine parameters."""
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.data = (
                torch.rand(m.weight.shape, generator=generator) + 0.5
            ).to(m.weight.device)
            m.bias.data = (
                torch.randn(m.bias.shape, generator=generator) * 0.05
            ).to(m.bias.device)


def calibrate_batchnorm(module: nn.Module, *inputs) -> None:
    """Set every BN layer's running stats to those of one batch.

    Running stats of a randomly initialized model compound over a deep
    net (activations reach 1e10); one train-mode pass with momentum 1
    pins them to the calibration batch, so eval-mode activations stay
    O(1). The module is left in eval mode with its momenta restored.
    """
    bns = [
        m for m in module.modules()
        if isinstance(m, nn.modules.batchnorm._BatchNorm)
    ]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    module.train()
    with torch.no_grad():
        module(*inputs)
    module.eval()
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum


def yolo_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's flax `YoloV3` variables (`params`, `batch_stats`,
    as numpy) -> the port's `demo.yolo.YoloV3` state_dict: `conv{i}`
    kernels HWIO -> OIHW and biases, `bn{i}` scale/bias -> weight/bias and
    mean/var -> running_mean/var. A leaf with no place raises."""
    state: dict[str, torch.Tensor] = {}
    leaves = {("params", "kernel"): "weight", ("params", "bias"): "bias",
              ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}
    unknown = []
    for col in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(col, {})).items():
            leaf = leaves.get((col, path[-1]))
            if len(path) != 2 or leaf is None or not re.fullmatch(r"(conv|bn)\d+", path[0]):
                unknown.append("/".join((col,) + path))
                continue
            state[f"{path[0]}.{leaf}"] = torch.from_numpy(
                np.ascontiguousarray(_torch_layout(path[-1], value)))
            if leaf == "running_mean":
                state[f"{path[0]}.num_batches_tracked"] = torch.tensor(0)
    if unknown:
        raise KeyError(f"JAX YOLO leaves with no place in the port: {unknown}")
    return state
