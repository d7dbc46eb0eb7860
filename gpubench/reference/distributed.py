"""One process, in place of `poco_tpu_torch/parallel/distributed.py`.

The reference runs in one process: the data group is this process alone,
so its sums over processes are the identity, and there is no model axis
(a vertex shard never reaches `lbs.py`'s model-group calls here)."""

from __future__ import annotations

import torch


def data_count() -> int:
    return 1


def data_index() -> int:
    return 0


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    return tensor


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    return tensor


def _no_model_axis(*args, **kwargs):
    raise NotImplementedError("the reference has no model axis")


model_partial_sum = model_replicated = model_gather = _no_model_axis
