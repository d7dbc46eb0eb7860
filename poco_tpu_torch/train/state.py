"""Optimizer and parameter bookkeeping for training (port of
`poco_tpu.train.state`).

`ModuleAdam` has the semantics of the JAX package's fused optimizer
(`make_fused_optimizer`, state.py:122-215), in torch's idiom: one
`torch.optim.Adam` param group per top-level module (`backbone`, `head`,
`uncert_head`, `flow_head`; anything else is `other`), with

  * per-module LR multipliers (reference MODULE_LR, trainer.py:591-605);
  * frozen modules (reference FREEZE_PARAMS) kept out of the groups: they
    get no update and their moments do not move (a module with a zero
    multiplier is frozen too);
  * weight decay as L2 added to the gradient before Adam (torch Adam's
    `weight_decay`, not AdamW), after clipping, as the JAX chain orders it;
  * clipping on the whole model's gradient norm, frozen modules included,
    with JAX's factor min(1, clip / (norm + 1e-16)) (torch's
    `clip_grad_norm_` adds 1e-6 instead);
  * an LR scale that the plateau scheduler writes in place, without a new
    optimizer (`set_lr_scale`).

The freeze schedule builds a new `ModuleAdam` at each boundary, whose
moments start at zero, as the JAX trainer re-initializes its optimizer
state there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import MODULE_GROUPS
from .step import global_norm


def module_params(model: nn.Module) -> dict[str, list[nn.Parameter]]:
    """The model's parameters by top-level module; modules outside
    MODULE_GROUPS (and parameters of the model itself) under "other"."""
    groups: dict[str, list[nn.Parameter]] = {}
    for name, param in model.named_parameters():
        top = name.split(".")[0]
        groups.setdefault(top if top in MODULE_GROUPS else "other", []).append(param)
    return groups


class ModuleAdam:
    """Adam with module LRs, freezes, whole-model clipping and an LR scale.

    `step()` reads the `.grad` of every parameter of the model (frozen or
    not), clips, steps the unfrozen groups and returns the gradient's
    global norm before clipping.
    """

    def __init__(
        self,
        model: nn.Module,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        module_lr: dict[str, float] | None = None,
        frozen_modules: tuple[str, ...] = (),
        grad_clip: float | None = None,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
    ):
        module_lr = dict(module_lr or {})
        self.base_lr = lr
        self.lr_scale = 1.0
        self.grad_clip = grad_clip or None
        self.params = [p for p in model.parameters()]
        groups = []
        for name, params in module_params(model).items():
            mult = 0.0 if name in frozen_modules else module_lr.get(name, 1.0)
            if mult == 0.0:
                continue
            groups.append({"params": params, "name": name, "lr_mult": mult, "lr": lr * mult})
        self.frozen_modules = tuple(
            n for n in module_params(model) if n not in {g["name"] for g in groups}
        )
        self.optimizer = torch.optim.Adam(
            groups, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay
        ) if groups else None

    def set_lr_scale(self, scale: float) -> None:
        """Scale every group's LR relative to the base LR, in place: the
        moments and step counts are untouched."""
        self.lr_scale = float(scale)
        for group in self.groups:
            group["lr"] = self.base_lr * group["lr_mult"] * self.lr_scale

    @property
    def groups(self) -> list[dict]:
        return self.optimizer.param_groups if self.optimizer is not None else []

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            raise RuntimeError("ModuleAdam.step: no parameter has a gradient")
        norm = global_norm(grads)
        if self.grad_clip:
            scale = torch.clamp(self.grad_clip / (norm + 1e-16), max=1.0)
            torch._foreach_mul_(grads, scale)
        if self.optimizer is not None:
            self.optimizer.step()
        return norm

    def state_dict(self) -> dict:
        return {
            "lr_scale": self.lr_scale,
            "groups": [g["name"] for g in self.groups],
            "adam": self.optimizer.state_dict() if self.optimizer is not None else None,
        }

    def load_state_dict(self, state: dict) -> list[str]:
        """Restore leniently, as the JAX trainer restores its optimizer
        state: what does not fit this optimizer's groups (another freeze
        set, another model) keeps its fresh state. Returns what was kept
        fresh, for the log; the LR scale is the caller's (`set_lr_scale`)."""
        kept = []
        names = [g["name"] for g in self.groups]
        if state.get("groups") != names or state.get("adam") is None:
            return [f"groups {state.get('groups')} != {names}"]
        adam = state["adam"]
        for group, saved in zip(self.groups, adam["param_groups"]):
            if len(group["params"]) != len(saved["params"]):
                kept.append(group["name"])
        if kept:
            return kept
        ours = self.optimizer.state_dict()
        for saved, mine in zip(adam["param_groups"], ours["param_groups"]):
            saved["lr"] = mine["lr"]  # the LR is set by the caller, not restored
        try:
            self.optimizer.load_state_dict(adam)
        except (ValueError, RuntimeError) as e:
            return [str(e)]
        return []


def count_params(model: nn.Module) -> dict[str, int]:
    """Parameter counts per top-level module and in total (reference
    trainer.py:186-190)."""
    counts = {name: sum(p.numel() for p in params)
              for name, params in module_params(model).items()}
    counts["total"] = sum(counts.values())
    return counts


def check_finite(tree, where: str = "") -> None:
    """Raise FloatingPointError if any tensor or array of a (nested) dict
    holds NaN or Inf (reference NaN probes, pare_head.py:803-807,
    losses.py:353-354). Reads the values on the host: a debug helper."""
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
            return
        if node is None:
            return
        arr = node.detach().float().cpu().numpy() if torch.is_tensor(node) else np.asarray(node)
        if not np.all(np.isfinite(arr)):
            raise FloatingPointError(f"non-finite values in {where}{path}")

    walk(tree, "")
