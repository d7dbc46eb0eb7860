"""Batch padding and row shards for data parallelism (port of the parts of
`poco_tpu.parallel.mesh` that carry over).

The JAX package places one SPMD program on a device mesh: `make_mesh`,
`batch_sharding`, `replicated`, `shard_batch` and `replicate_tree`
describe XLA's placement of the batch and the parameters. They have no
counterpart here: the process group (`parallel/distributed.py`) takes
their place, with one process a card, each holding its own rows and a copy
of the parameters. The "model" axis (`shard_smpl_params`, the SMPL weights
split over the vertex dimension) is not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import numpy as np


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad the batch axis to a multiple of `multiple` by repeating the last
    row. Returns (padded, valid_mask)."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    pad = target - n
    mask = np.ones(target, bool)
    if pad:
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        arr = np.pad(arr, widths, mode="edge")
        mask[n:] = False
    return arr, mask


def shard_bounds(rows: int, num_shards: int, shard_index: int) -> tuple[int, int]:
    """Row range [lo, hi) of shard `shard_index` of a batch of `rows`
    (padded to a multiple of `num_shards`): the shards are contiguous, in
    order."""
    if rows % num_shards:
        raise ValueError(f"global batch {rows} not divisible by {num_shards} shards")
    per = rows // num_shards
    return shard_index * per, (shard_index + 1) * per
