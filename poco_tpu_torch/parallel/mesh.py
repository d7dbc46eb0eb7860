"""Batch padding and row shards for data parallelism (port of the parts of
`poco_tpu.parallel.mesh` that carry over).

The JAX package places one SPMD program on a device mesh: `make_mesh`,
`batch_sharding`, `replicated`, `shard_batch` and `replicate_tree`
describe XLA's placement of the batch and the parameters. They have no
counterpart here: the process group (`parallel/distributed.py`) takes
their place, with one process a card, each holding its own rows and a copy
of the parameters. The "model" axis is the process grid of
`distributed.form_grid`; `shard_smpl_params` splits the SMPL weights over
its model group by vertex, as the JAX function places them.
"""

from __future__ import annotations

import dataclasses

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


def vertex_counts(num_verts: int, shards: int) -> tuple:
    """The vertices of each of `shards` contiguous ranges, in order: the
    first `num_verts % shards` one larger (6890 over 4: 1723, 1723, 1722,
    1722). The JAX package needs divisibility; an uneven split is fine
    here."""
    base, extra = divmod(num_verts, shards)
    return tuple(base + (i < extra) for i in range(shards))


def shard_smpl_params(params):
    """This process's vertex range of the SMPL weights on the model axis
    (the counterpart of `poco_tpu.parallel.mesh.shard_smpl_params`):
    `v_template`, `shapedirs` and `lbs_weights` on their V axis,
    `posedirs`, `j_regressor` and `j_regressor_extra` on their V columns,
    `faces` and `vertex_joint_ids` whole. The result carries a
    `VertexShard`, so `smpl/lbs.py` runs its sharded forward. With model
    size 1 the params come back as they are."""
    from ..smpl.lbs import VertexShard
    from . import distributed

    if distributed.model_size() == 1:
        return params
    if params.shard is not None:
        raise ValueError("the SMPL params are sharded already")
    counts = vertex_counts(params.v_template.shape[0], distributed.model_size())
    lo = sum(counts[:distributed.model_index()])
    hi = lo + counts[distributed.model_index()]
    return dataclasses.replace(
        params,
        v_template=params.v_template[lo:hi].contiguous(),
        shapedirs=params.shapedirs[lo:hi].contiguous(),
        posedirs=params.posedirs[:, 3 * lo:3 * hi].contiguous(),
        j_regressor=params.j_regressor[:, lo:hi].contiguous(),
        lbs_weights=params.lbs_weights[lo:hi].contiguous(),
        j_regressor_extra=params.j_regressor_extra[:, lo:hi].contiguous(),
        shard=VertexShard(lo, hi, counts, distributed.model_group(), params.lbs_weights),
    )
