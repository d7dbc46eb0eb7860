"""Checkpoint files for the port: torch `.pt` / `.ckpt` state_dicts in the
reference's names (`backbone.`, `head.`, `uncert_head.`, `flow_head.`),
plain, wrapped in `model` / `state_dict`, or with Lightning's `model.`
prefix (port of the torch branch of
`poco_tpu.utils.checkpoint_convert`), and the trainer's own payload
(`save_checkpoint` / `load_checkpoint`): the model's state_dict under
`model`, the optimizer's state, the step and the LR scale. Orbax
directories, the JAX package's own checkpoints, are refused: reading them
needs orbax: `tools/orbax_to_torch.py`, run where JAX and orbax are
installed, converts a JAX trainer checkpoint into the port's.
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
        "the port reads torch .pt/.ckpt files only: convert it with "
        "tools/orbax_to_torch.py (where JAX and orbax are installed)"
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


def checkpoint_file(path: str) -> str:
    """`<path>.pt` for a trainer checkpoint named without its suffix."""
    return path if path.endswith((".pt", ".ckpt")) else f"{path}.pt"


def save_checkpoint(path: str, model: nn.Module, optimizer=None, step: int = 0,
                    lr_scale: float = 1.0) -> str:
    """Write the training payload to `<path>.pt` (through a temporary file,
    so a run killed while saving leaves the previous file whole); returns
    the file written."""
    path = checkpoint_file(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "step": int(step),
        "lr_scale": float(lr_scale),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: nn.Module, optimizer=None) -> dict:
    """Restore a `save_checkpoint` payload. The model's keys must match
    exactly: a missing or extra key raises, so a resumed run never goes on
    from partly fresh weights. The optimizer state restores leniently (what
    does not fit keeps its fresh state, as the JAX trainer does). Returns
    `step`, `lr_scale` and `optimizer_kept_fresh` (what was not restored)."""
    path = checkpoint_file(path)
    if _is_orbax(path.removesuffix(".pt")):
        _refuse_orbax(path.removesuffix(".pt"))
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(payload, dict) or "model" not in payload:
        raise ValueError(f"{path} is not a training checkpoint (no 'model' entry)")
    ours = set(model.state_dict())
    theirs = set(payload["model"])
    if ours != theirs:
        raise ValueError(
            f"checkpoint {path!r} does not match the model: missing "
            f"{sorted(ours - theirs)[:10]} extra {sorted(theirs - ours)[:10]} "
            f"(counts {len(ours - theirs)}/{len(theirs - ours)})"
        )
    model.load_state_dict(payload["model"], strict=True)
    kept = []
    if optimizer is not None:
        saved = payload.get("optimizer")
        kept = ["optimizer state missing"] if saved is None else optimizer.load_state_dict(saved)
    return {
        "step": int(payload.get("step", 0)),
        "lr_scale": float(payload.get("lr_scale", 1.0)),
        "optimizer_kept_fresh": kept,
    }


def load_pretrained(model: nn.Module, path: str) -> dict:
    """Warm start from a reference `.pt` (TRAINING.PRETRAINED): every
    tensor whose name and shape the model has is loaded; the rest are
    skipped and counted. Orbax directories raise."""
    state = load_torch_checkpoint(path)
    ours = model.state_dict()
    fits = {k: v for k, v in state.items() if k in ours and tuple(v.shape) == tuple(ours[k].shape)}
    model.load_state_dict(fits, strict=False)
    return {"loaded": len(fits), "skipped": len(state) - len(fits),
            "not_in_checkpoint": len(ours) - len(fits)}
