"""Checkpoint files for the port: torch `.pt` / `.ckpt` state_dicts in the
reference's names (`backbone.`, `head.`, `uncert_head.`, `flow_head.`),
plain, wrapped in `model` / `state_dict`, or with Lightning's `model.`
prefix (port of the torch branch of
`poco_tpu.utils.checkpoint_convert`). Orbax directories, the JAX
package's own checkpoints, are refused: reading them needs orbax.
"""

from __future__ import annotations

import glob
import os

import torch
from torch import nn

# the markers of an orbax checkpoint directory
_ORBAX_MARKERS = ("_METADATA", "manifest.ocdbt", "d", "_CHECKPOINT_METADATA")


def _is_orbax(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS
    )


def _refuse_orbax(path: str):
    raise ValueError(
        f"{path} is an orbax checkpoint directory (the JAX package's format); "
        "the port reads torch .pt/.ckpt files only"
    )


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A torch checkpoint file -> its flat state_dict (unwraps `model` /
    `state_dict` nesting, reference poco.py:134-136, and strips
    Lightning's `model.` prefix)."""
    if _is_orbax(path):
        _refuse_orbax(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if any(k.startswith("model.") for k in ckpt):
        ckpt = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in ckpt.items()}
    return ckpt


def get_model_path(logdir: str, inf_model: str = "best") -> str:
    """The checkpoint file inside a run logdir.

    "best" -> best_model, "best_mpjpe_var" -> best_model_mpjpe_var,
    "cam"/"best_cam" -> best_model_cam, "last"/"latest" -> last, each as
    `<name>.pt` or `<name>`; otherwise, or when that file is missing, the
    newest `.pt`/`.ckpt` file (reference train_utils.py:126-136, the
    demo's --inf_model). An orbax directory in its place raises.
    """
    names = {
        "best": "best_model",
        "best_mpjpe_var": "best_model_mpjpe_var",
        "cam": "best_model_cam",
        "best_cam": "best_model_cam",
        "last": "last",
        "latest": "last",
    }
    name = names.get(inf_model)
    if name:
        for path in (os.path.join(logdir, f"{name}.pt"), os.path.join(logdir, name)):
            if os.path.isfile(path):
                return path
            if _is_orbax(path):
                _refuse_orbax(path)
    files = sorted(
        (c for c in glob.glob(os.path.join(logdir, "*"))
         if c.endswith((".pt", ".ckpt")) and os.path.isfile(c)),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .pt or .ckpt checkpoint in {logdir}")
    return files[-1]


def load_checkpoint_into(model: nn.Module, path: str, inf_model: str = "best") -> str:
    """Load a `.pt` file, or the one a logdir holds (`get_model_path`),
    into `model`; returns the file read.

    Keys the model does not have are printed and skipped. A parameter or
    buffer of the model that the file lacks raises, so that no run goes
    on with random weights without a word.
    """
    if os.path.isdir(path):
        path = get_model_path(path, inf_model)
    state = load_torch_checkpoint(path)
    result = model.load_state_dict(state, strict=False)
    if result.unexpected_keys:
        print(f"{path}: {len(result.unexpected_keys)} keys the model does not have, "
              f"skipped: {sorted(result.unexpected_keys)}")
    if result.missing_keys:
        raise KeyError(
            f"{path} lacks {len(result.missing_keys)} parameters or buffers of the "
            f"model: {sorted(result.missing_keys)}"
        )
    print(f"loaded {len(state) - len(result.unexpected_keys)} tensors from {path}")
    return path
