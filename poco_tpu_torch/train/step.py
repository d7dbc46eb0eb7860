"""Training-step helpers (port of `poco_tpu.train.step`); so far only the
checkpoint-selection metric that evaluation reports."""

from __future__ import annotations


def best_model_metric(pa_mpjpe_mm: float, mpjpe_mm: float) -> float:
    """Composite selection criterion (reference trainer.py:407-408)."""
    return 0.5 * (1.5 * pa_mpjpe_mm + mpjpe_mm)
