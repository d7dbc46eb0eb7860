"""Weights carried between the JAX package's variable tree and the port.

`state_dict_from_jax` is the inverse of the torch -> flax converter
(`poco_tpu/utils/checkpoint_convert.py:36-81`): it takes the JAX model's
variables (`params`, `batch_stats`, `buffers`, as numpy arrays) and
returns the port's state_dict, with reference torch names. It also holds
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


def _block_name(path: str) -> str | None:
    """'{n}/conv1' -> '{n}.conv1'; '{n}/downsample_conv' -> '{n}.downsample.0'."""
    m = re.fullmatch(r"(\d+)/((?:conv|bn)\d)", path)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"(\d+)/downsample_(conv|bn)", path)
    if m:
        return f"{m.group(1)}.downsample.{0 if m.group(2) == 'conv' else 1}"
    return None


def _hrnet_torch_name(path: str) -> str | None:
    """flax module path under `backbone_net` -> torch module name."""
    if re.fullmatch(r"(conv|bn)\d", path):
        return path
    m = re.fullmatch(r"layer1/(.+)", path)
    if m and _block_name(m.group(1)):
        return f"layer1.{_block_name(m.group(1))}"
    m = re.fullmatch(r"transition(\d)_(\d+)_(conv|bn)(\d+)", path)
    if m:
        t, i, kind, k = m.groups()
        idx = 0 if kind == "conv" else 1
        if int(i) < int(t):  # an existing branch: one conv + BN
            return f"transition{t}.{i}.{idx}"
        return f"transition{t}.{i}.{k}.{idx}"  # a new branch: a chain
    m = re.fullmatch(r"stage(\d)_(\d+)/branch(\d+)/(.+)", path)
    if m and _block_name(m.group(4)):
        s, mm, b, rest = m.groups()
        return f"stage{s}.{mm}.branches.{b}.{_block_name(rest)}"
    m = re.fullmatch(r"stage(\d)_(\d+)/fuse_(\d+)_(\d+)_(conv|bn)(\d+)", path)
    if m:
        s, mm, i, j, kind, k = m.groups()
        idx = 0 if kind == "conv" else 1
        if int(j) > int(i):
            return f"stage{s}.{mm}.fuse_layers.{i}.{j}.{idx}"
        return f"stage{s}.{mm}.fuse_layers.{i}.{j}.{k}.{idx}"
    m = re.fullmatch(r"incre(\d)/(.+)", path)
    if m and _block_name(m.group(2)):
        return f"incre_modules.{m.group(1)}.{_block_name(m.group(2))}"
    m = re.fullmatch(r"downsamp(\d)_(conv|bn)", path)
    if m:
        return f"downsamp_modules.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
    if path in ("final_conv", "final_bn"):
        return f"final_layer.{0 if path == 'final_conv' else 1}"
    return None


_UNCERT_NAMES = {"poseNet_fc": "uncert_fc_poseNet", "featNet_fc": "uncert_fc_featNet"}


def _torch_module_name(top: str, path: str) -> str | None:
    if top == "backbone_net":
        name = _hrnet_torch_name(path)
        return None if name is None else f"backbone.{name}"
    if top == "head" and path in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        return f"head.{path}"
    if top == "uncert_head":
        if path in _UNCERT_NAMES:
            return f"uncert_head.{_UNCERT_NAMES[path]}"
        if re.fullmatch(r"fc\d+", path):
            return f"uncert_head.uncert_{path}"
    return None


_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def state_dict_from_jax(
    variables: dict,
) -> tuple[dict[str, torch.Tensor], dict[str, np.ndarray]]:
    """JAX POCO variables -> (port state_dict, JAX leaves not carried).

    conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
    BN scale/bias -> weight/bias with mean/var -> running_mean/var (and a
    zero `num_batches_tracked`), `buffers/head/init_*` -> `head.init_*`.
    The leaves not carried are the flow head's, which the port does not
    have yet; any other leaf that has no place in the port raises.
    """
    state: dict[str, torch.Tensor] = {}
    skipped: dict[str, np.ndarray] = {}
    unknown = []
    for col in ("params", "batch_stats", "buffers"):
        for path, value in _flatten(variables.get(col, {})).items():
            key = "/".join((col,) + path)
            if path[0] == "flow_head":
                skipped[key] = value
                continue
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
            if path[-1] == "kernel":
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            state[f"{module}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(value))
            if leaf == "running_mean":
                state[f"{module}.num_batches_tracked"] = torch.tensor(0)
    if unknown:
        raise KeyError(f"JAX leaves with no place in the port: {unknown}")
    return state, skipped


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
