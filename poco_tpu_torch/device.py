"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from .utils.comp_cache import platform_from_env


def default_device() -> str:
    """The entry points' default device: the one POCO_TPU_PLATFORM names,
    else cuda."""
    return platform_from_env() or "cuda"


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks.

    With `device=None` the default is the one POCO_TPU_PLATFORM names
    (`utils/comp_cache.py`), else CUDA. Raises when a CUDA device is asked
    for and there is no card, so a run meant for the card never falls
    back to the CPU unnoticed.
    """
    if device is None:
        device = default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
