"""Platform selection from the environment (port of
`poco_tpu.utils.comp_cache`).

`POCO_TPU_PLATFORM` picks the entry points' default device, as it picks
the JAX platform there: `cpu`, or `cuda` / `gpu` for the card. It is read
through `device.resolve_device` when the caller names no device (every
CLI's `--device` defaults to it); a device the caller names wins. It
only picks: asking for the card where there is none still raises, and a
failed card run never becomes a CPU run.

The JAX module's other half, the persistent XLA compilation cache
(`enable_compilation_cache`), has no counterpart: PyTorch's eager
kernels compile nothing per shape, and the port's own kernels are built
once per checkout into `poco_tpu_torch/_build/` (`ops/kernels.py`).
"""

from __future__ import annotations

import os

ENV = "POCO_TPU_PLATFORM"
DEVICES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def platform_from_env() -> str | None:
    """The device that POCO_TPU_PLATFORM names (cpu or cuda), or None
    when it is unset or empty; raises on another value."""
    value = os.environ.get(ENV, "").strip().lower()
    if not value:
        return None
    if value not in DEVICES:
        raise ValueError(f"{ENV}={value!r}: expected one of {sorted(DEVICES)}")
    return DEVICES[value]
