"""The system under test, `poco_tpu_torch`, through its public entry
points: the model, the SMPL loader, `detect_forward`, the train step and
its optimizer. Imported when a run starts, never with this module."""

from __future__ import annotations

import torch


def _model_kwargs(model_cfg: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()}


def build_model(model_cfg: dict, state_dict: dict, device) -> torch.nn.Module:
    """The port's POCO for the configuration, holding `state_dict`."""
    from poco_tpu_torch.models.poco import POCO, PocoConfig

    with torch.device(device):
        model = POCO(PocoConfig(**_model_kwargs(model_cfg)))
    model.to(device)
    model.load_state_dict(state_dict)
    return model.eval()


def load_smpl(model_path: str, extra_path: str, device):
    from poco_tpu_torch.smpl.assets import load_smpl_model

    return load_smpl_model(model_path, extra_path, device=device)


def detect_forward(model, smpl, image, centers, scales) -> dict:
    from poco_tpu_torch.demo.tester import detect_forward as forward

    return forward(model, smpl, image, centers, scales)


def fetch_keys() -> tuple[str, ...]:
    """What a demo fetches of a request (`PocoTester._FETCH_KEYS`) and the
    full-image camera."""
    from poco_tpu_torch.demo.tester import PocoTester

    return tuple(PocoTester._FETCH_KEYS) + ("pred_fullimg_cam_t",)


def train_step(model, config: dict):
    """`make_train_step` with `ModuleAdam` at the configuration's settings:
    returns (step, optimizer)."""
    from poco_tpu_torch.losses.losses import LossConfig
    from poco_tpu_torch.train.state import ModuleAdam
    from poco_tpu_torch.train.step import make_train_step

    opt = config["optimizer"]
    optimizer = ModuleAdam(model, lr=opt["lr"], weight_decay=opt["weight_decay"],
                           grad_clip=opt["grad_clip"] or None, betas=tuple(opt["betas"]),
                           eps=opt["eps"])
    loss_cfg = LossConfig(**_model_kwargs(config["loss"]))
    return make_train_step(model, optimizer, loss_cfg), optimizer


def adam_state(model, optimizer) -> dict[str, dict]:
    """Adam's state (`exp_avg`, `exp_avg_sq`, `step`) of each parameter
    that has one, by the parameter's name."""
    adam = optimizer.optimizer
    if adam is None:
        return {}
    return {n: adam.state[p] for n, p in model.named_parameters() if p in adam.state}
