"""Convert a JAX trainer checkpoint (orbax) into the PyTorch port's.

    python tools/orbax_to_torch.py --ckpt <jax logdir>/last --cfg CONFIG.yaml \\
        --out <port logdir>/last

Reads the orbax directory the JAX package's `Trainer.save_checkpoint`
writes (through `poco_tpu.utils.checkpoint_convert.restore_checkpoint_tree`)
and its `<dir>.trainer.json` sidecar, and writes the port's training
checkpoint: `<out>.pt` in `poco_tpu_torch.utils.checkpoint.save_checkpoint`'s
layout and `<out>.trainer.json`, which `python -m poco_tpu_torch.cli.train
--resume <out>` (or `Trainer.load_checkpoint`) continues from.

  * `model`: the parameters, BN statistics and head buffers, through
    `poco_tpu_torch.utils.weights.state_dict_from_jax`; the port model built
    from `--cfg` must take every key (strict).
  * `optimizer`: the JAX fused Adam's state (`count`, and the first and
    second moments of each top-level module as one flat vector) mapped
    onto `ModuleAdam`'s torch Adam groups, parameter by parameter, with
    the frozen modules of the checkpoint's epoch left out as the port
    leaves them out. A state of another layout (optax's per-leaf chain)
    is refused with the reason: no fresh optimizer is started in its place.
  * `step` and `lr_scale` are carried over; the sidecar's trackers (epoch,
    global step, best metrics, top-k, plateau LR, validation history) too.
  * The JAX PRNG key has no torch counterpart: the port's sidecar gets no
    generator state, so the resumed run's dropout masks are drawn from the
    port's own seed, not from the JAX run's key.

It needs JAX, flax and orbax (it imports `poco_tpu`) and torch; it runs
where those are installed, not on a host with torch alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIDECAR_KEYS = ("next_epoch", "global_step", "best_metric", "best_corr", "best_mpjpe_var",
                "topk", "current_lr", "plateau_best", "plateau_count", "val_history")


def _adam_moments(opt_state: dict, params: dict) -> tuple[int, float, dict, dict]:
    """The fused JAX Adam's count, lr_scale and its moments as port
    state_dicts (torch names and layouts). Raises on any other layout."""
    from jax.flatten_util import ravel_pytree

    from poco_tpu_torch.utils.weights import state_dict_from_jax

    if not (isinstance(opt_state, dict) and {"count", "groups"} <= set(opt_state)):
        raise ValueError(
            "the checkpoint's optimizer state is not the JAX trainer's fused Adam "
            "(count / lr_scale / per-module m and v): its layout "
            f"({type(opt_state).__name__}) cannot be mapped onto the port's Adam, and "
            "no fresh optimizer is put in its place")
    moments = {}
    for which in ("m", "v"):
        tree = {}
        for group, sub in opt_state["groups"].items():
            if group not in params:
                raise ValueError(f"optimizer group {group!r} has no parameters in the checkpoint")
            flat, unravel = ravel_pytree(params[group])
            vec = np.asarray(sub[which], np.float32)
            if vec.shape != flat.shape:
                raise ValueError(f"optimizer group {group!r}: {which} holds {vec.shape[0]} "
                                 f"values for {flat.shape[0]} parameters")
            tree[group] = unravel(vec)
        moments[which] = state_dict_from_jax({"params": tree})
    lr_scale = float(np.asarray(opt_state.get("lr_scale", 1.0)))
    return int(np.asarray(opt_state["count"])), lr_scale, moments["m"], moments["v"]


def convert(ckpt: str, hparams, out: str) -> dict:
    """Convert the JAX checkpoint `ckpt` (its orbax directory) for the model
    `hparams` (the port's config tree) into `<out>.pt` and
    `<out>.trainer.json`; returns a summary."""
    import jax

    from poco_tpu.utils.checkpoint_convert import restore_checkpoint_tree
    from poco_tpu_torch.config import (
        model_config_from_hparams,
        parse_freeze_params,
        parse_module_lr,
    )
    from poco_tpu_torch.models.poco import POCO
    from poco_tpu_torch.train.state import ModuleAdam
    from poco_tpu_torch.utils import checkpoint as ckpt_io
    from poco_tpu_torch.utils.weights import state_dict_from_jax

    ckpt = os.path.abspath(ckpt).rstrip("/")
    tree = jax.tree.map(np.asarray, restore_checkpoint_tree(ckpt))
    variables = {k: tree[k] for k in ("params", "batch_stats", "buffers") if tree.get(k)}
    model = POCO(model_config_from_hparams(hparams))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    sidecar = {}
    if os.path.exists(ckpt + ".trainer.json"):
        with open(ckpt + ".trainer.json") as f:
            sidecar = json.load(f)
    # the optimizer of the checkpoint's epoch: its freeze set and base LR
    schedule = parse_freeze_params(hparams.TRAINING.FREEZE_PARAMS)
    epoch = max(int(sidecar.get("next_epoch", 1)) - 1, 0)
    frozen: tuple[str, ...] = ()
    for e in sorted(schedule):
        if e <= epoch:
            frozen = tuple(schedule[e])
    base_lr = sidecar.get("current_lr") or hparams.OPTIMIZER.LR
    optimizer = ModuleAdam(model, lr=base_lr, weight_decay=hparams.OPTIMIZER.WD,
                           module_lr=parse_module_lr(hparams.OPTIMIZER.MODULE_LR),
                           frozen_modules=frozen,
                           grad_clip=hparams.TRAINING.GRAD_CLIP_VAL or None)
    count, lr_scale, exp_avg, exp_avg_sq = _adam_moments(tree["opt_state"], variables["params"])
    names = {p: n for n, p in model.named_parameters()}
    missing = [names[p] for g in optimizer.groups for p in g["params"] if names[p] not in exp_avg]
    if missing:
        raise ValueError(f"the JAX optimizer state has no moments for {missing[:10]}")
    for group in optimizer.groups:
        for p in group["params"]:
            optimizer.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": exp_avg[names[p]].clone(),
                "exp_avg_sq": exp_avg_sq[names[p]].clone(),
            }
    optimizer.set_lr_scale(lr_scale)
    step = int(np.asarray(tree.get("step", count)))
    path = ckpt_io.save_checkpoint(out, model, optimizer, step, lr_scale)
    port_sidecar = {k: sidecar[k] for k in SIDECAR_KEYS if k in sidecar}
    port_sidecar["rng"] = None  # the JAX PRNG key has no torch counterpart
    with open(out + ".trainer.json", "w") as f:
        json.dump(port_sidecar, f)
    return {"checkpoint": path, "step": step, "adam_count": count, "lr_scale": lr_scale,
            "groups": [g["name"] for g in optimizer.groups], "frozen": list(frozen),
            "tensors": len(model.state_dict())}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", required=True, help="the JAX checkpoint's orbax directory")
    parser.add_argument("--cfg", default=None,
                        help="the run's config yaml (default: config_to_run.yaml beside --ckpt)")
    parser.add_argument("--cfg_id", type=int, default=0, help="grid-search experiment id")
    parser.add_argument("--out", required=True,
                        help="the port checkpoint to write, without .pt (e.g. <logdir>/last)")
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from poco_tpu_torch.config import get_grid_search_configs, update_hparams_from_dict

    cfg = args.cfg or os.path.join(os.path.dirname(os.path.abspath(args.ckpt)),
                                   "config_to_run.yaml")
    import yaml

    with open(cfg) as f:
        experiments, _ = get_grid_search_configs(yaml.safe_load(f))
    summary = convert(args.ckpt, update_hparams_from_dict(experiments[args.cfg_id]), args.out)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
