"""PyTorch port: the SMPL "model" axis (vertex-sharded SMPL over a
data x model process grid) against the JAX package and one process.

The JAX package places the SMPL weights on the "model" axis of a mesh
(`poco_tpu.parallel.mesh.shard_smpl_params`) and XLA partitions the
forward; the port forms a (data, model) process grid
(`distributed.form_grid`), shards the weights by vertex
(`parallel.mesh.shard_smpl_params`) and writes out the crossings
(`model_partial_sum`, `model_replicated`, `model_gather`). The ranks run
`tests/torch_mp_worker.py` over gloo on the CPU (file:// rendezvous):

  * 2 ranks, model 2 (data 1): `smpl_case`;
  * 4 ranks, model 4 (data 1) and then model 2 (data 2 x model 2):
    `smpl_case` and one tiny-cliff train step (`step_case`).

Tolerances: `smpl_49` within atol 1e-5 m of JAX's on the same synthetic
SMPL (tests/test_eval.py's bar for the JAX package's own sharded forward);
the gradients of the shape and the rotations within 1e-5 relative L2 of
one process's (a backward that sums where it should not is off by the
model size, a relative error of 1 or more); the grid's train step at the
bars of tests/test_torch_multiprocess.py's two-rank step.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.smpl import assets as jassets
from poco_tpu.smpl.model import smpl_49 as jax_smpl_49

from poco_tpu_torch.parallel import distributed as dist
from poco_tpu_torch.parallel.mesh import shard_smpl_params, vertex_counts
from poco_tpu_torch.smpl import assets as tassets
from poco_tpu_torch.smpl import lbs as tlbs

from . import torch_mp_worker as worker
from .test_torch_multiprocess import DATA, _env, _run_ranks, check_step_matches

# (world, model size) of each sharded run of smpl_case
SMPL_GRIDS = [(2, 2), (4, 4), (4, 2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _worker_cmd(out, world: int, rank: int, model: str, cases: str) -> list[str]:
    return [sys.executable, "tests/torch_mp_worker.py", "--world", str(world), "--rank",
            str(rank), "--init", str(out / "init"), "--outdir", str(out), "--data_dir",
            str(DATA), "--model", model, "--cases", cases]


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Each rank's npz by (case, world, model size)."""
    runs = {2: ("2", "smpl"), 4: ("4,2", "smpl,step")}
    res = {}
    for world, (models, cases) in runs.items():
        out = tmp_path_factory.mktemp(f"world{world}")
        _run_ranks([_worker_cmd(out, world, r, models, cases) for r in range(world)],
                   [_env()] * world)
        for model in (int(m) for m in models.split(",")):
            for case in cases.split(","):
                res[case, world, model] = [dict(np.load(out / f"{case}_m{model}_rank{r}.npz"))
                                           for r in range(world)]
    return res


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    out = tmp_path_factory.mktemp("single")
    return {
        "smpl": worker.smpl_case(slice(0, worker.SMPL_ROWS)),
        "step": worker.step_case(slice(0, worker.GLOBAL_BATCH), str(out / "step"), str(DATA)),
    }


def _data_shards(ranks: list[dict], model: int) -> list[dict]:
    """Model index 0 of each data index, in data order."""
    return ranks[::model]


@pytest.mark.parametrize("num_verts", worker.SMPL_VERTS)
@pytest.mark.parametrize("world,model", SMPL_GRIDS)
def test_sharded_smpl_49_matches_jax(grids, world, model, num_verts):
    """Sharded `smpl_49` on every rank against JAX's `smpl_49` on the same
    synthetic SMPL (seed 0), within atol 1e-5: the vertices (gathered in
    shard order) and the 49 joints; each process's vertex range is its
    `vertex_counts` range (131 = 66 + 65 = 33 + 33 + 33 + 32), and the
    processes of a model group hold the same rows bit for bit."""
    ranks = grids["smpl", world, model]
    counts = vertex_counts(num_verts, model)
    for r, res in enumerate(ranks):
        m = r % model
        np.testing.assert_array_equal(res[f"{num_verts}/shard"],
                                      [sum(counts[:m]), sum(counts[:m + 1])])
        for key in ("verts", "joints"):
            np.testing.assert_array_equal(res[f"{num_verts}/{key}"],
                                          ranks[r - m][f"{num_verts}/{key}"])
    jsmpl = jassets.synthetic_smpl_model(num_verts=num_verts, seed=0)
    x = worker.smpl_inputs(num_verts)
    ref_v, ref_j = jax_smpl_49(jsmpl, jnp.asarray(x["betas"]), jnp.asarray(x["rotmats"]))
    shards = _data_shards(ranks, model)
    for key, ref in (("verts", ref_v), ("joints", ref_j)):
        got = np.concatenate([s[f"{num_verts}/{key}"] for s in shards])
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("num_verts", worker.SMPL_VERTS)
@pytest.mark.parametrize("world,model", SMPL_GRIDS)
def test_sharded_smpl_gradients_match_one_process(grids, single, world, model, num_verts):
    """The gradients of betas and of the rotations of a weighted sum of the
    vertices and joints, sharded against one process: within 1e-5
    relative L2, the same on every process of a model group."""
    ranks = grids["smpl", world, model]
    shards = _data_shards(ranks, model)
    for name in ("grad_betas", "grad_rotmats"):
        key = f"{num_verts}/{name}"
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[key], ranks[r - r % model][key], err_msg=key)
        got = np.concatenate([s[key] for s in shards]).astype(np.float64)
        ref = single["smpl"][key].astype(np.float64)
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref), key


@pytest.mark.parametrize("model", [4, 2])
def test_grid_train_step_matches_one_process(grids, single, model):
    """One tiny-cliff train step (global batch 8, dropout live, uneven
    masks) on 4 ranks, at model 4 (data 1) and on the 2 x 2 grid, its
    SMPL sharded over each model group, against one process: every rank
    the same, and the global loss terms, gradients, weights and running
    statistics at the two-rank step's bars."""
    ranks = grids["step", 4, model]
    check_step_matches(ranks, _data_shards(ranks, model), single["step"])


def test_model_size_one_is_the_world():
    """Without a grid (model size 1) the data group is the world, and
    `shard_smpl_params` returns the params themselves."""
    dist.form_grid(1)
    assert dist.model_size() == 1 and dist.model_group() is None
    assert (dist.data_count(), dist.data_index()) == (dist.process_count(),
                                                      dist.process_index())
    smpl = tassets.synthetic_smpl_model(num_verts=32, device="cpu")
    assert shard_smpl_params(smpl) is smpl and smpl.shard is None
    assert smpl.all_lbs_weights is smpl.lbs_weights
    with pytest.raises(ValueError, match="not divisible"):
        dist.form_grid(3)


@pytest.mark.parametrize("num_verts,shards", [(6890, 2), (6890, 4), (131, 4), (5, 4)])
def test_vertex_counts_split_in_order(num_verts, shards):
    """Contiguous ranges, the first ones a vertex larger, as
    np.array_split cuts (6890 over 4: 1723, 1723, 1722, 1722)."""
    counts = vertex_counts(num_verts, shards)
    assert counts == tuple(len(part) for part in np.array_split(np.arange(num_verts), shards))
    assert sum(counts) == num_verts


def test_export_refuses_sharded_params(tmp_path):
    """An artifact holds the whole SMPL: `export_poco` refuses params that
    hold one process's vertex range."""
    from poco_tpu_torch.runtime.export import export_poco

    smpl = tassets.synthetic_smpl_model(num_verts=16, device="cpu")
    sharded = dataclasses.replace(smpl, shard=tlbs.VertexShard(0, 8, (8, 8), None,
                                                               smpl.lbs_weights))
    model = torch.nn.Linear(1, 1).eval()
    with pytest.raises(ValueError, match="unsharded"):
        export_poco(model, sharded, str(tmp_path / "art"), batch_sizes=(1,), device="cpu")


def test_vertex_shard_moves_with_the_params():
    """`SmplParams.to` moves the shard's whole-mesh skinning weights too,
    and keeps its range and group."""
    smpl = tassets.synthetic_smpl_model(num_verts=16, device="cpu")
    shard = tlbs.VertexShard(0, 8, (8, 8), None, smpl.lbs_weights)
    moved = dataclasses.replace(smpl, shard=shard).to(torch.float64)
    assert moved.shard.lbs_weights.dtype == torch.float64
    assert (moved.shard.lo, moved.shard.hi, moved.shard.counts) == (0, 8, (8, 8))
