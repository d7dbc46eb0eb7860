"""PyTorch port vs JAX package: the pieces of data parallelism, in one process.

The launch contract's errors on the same environment, `pad_to_multiple`
and the rows a process owns (`local_shard_bounds`, `mesh.shard_bounds`),
the loader's shards over `PocoDataset` and `RatioMixedDataset` (rows and
`_global_row_names` equal to the JAX package's `DataLoader` with the same
arguments, on its native decode and warp), and the global
GT-pose-conditioning selection against the JAX trainer's `_cond_mask`.
The process counts are patched: no process group forms here (the
two-process runs are in tests/test_torch_multiprocess.py).
"""

import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from poco_tpu.data.dataset import DataLoader as JaxDataLoader
from poco_tpu.data.dataset import PocoDataset as JaxPocoDataset
from poco_tpu.data.mixed import RatioMixedDataset as JaxMixed
from poco_tpu.parallel import distributed as jax_dist
from poco_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from poco_tpu.train.trainer import Trainer as JaxTrainer

from poco_tpu_torch.config import get_hparams_defaults
from poco_tpu_torch.data.dataset import DataLoader, PocoDataset
from poco_tpu_torch.data.mixed import RatioMixedDataset
from poco_tpu_torch.parallel import distributed as dist
from poco_tpu_torch.parallel.mesh import pad_to_multiple, shard_bounds
from poco_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "data"
TRAIN_NPZ = DATA / "dataset_extras" / "smoke_train.npz"
TEST_NPZ = DATA / "dataset_extras" / "smoke_test.npz"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def world(monkeypatch):
    """Patch both packages to see `n` processes, this one `p`."""
    def set_world(n: int, p: int) -> None:
        monkeypatch.setattr(jax, "process_count", lambda: n)
        monkeypatch.setattr(jax, "process_index", lambda: p)
        monkeypatch.setattr(dist, "process_count", lambda: n)
        monkeypatch.setattr(dist, "process_index", lambda: p)
    return set_world


# --------------------------------------------------------------------------
# the launch contract
# --------------------------------------------------------------------------

@pytest.mark.parametrize("env,match", [
    ({}, None),
    ({"POCO_PROCESS_ID": "1"}, "POCO_PROCESS_ID is set"),
    ({"POCO_PROCESS_ID": "1", "POCO_COORDINATOR": "host0:7701"}, "incomplete"),
    ({"POCO_NUM_PROCESSES": "2"}, "incomplete"),
])
def test_topology_environment_errors_match_jax(monkeypatch, env, match):
    """tests/test_multiprocess.py:94-108's environments, and two more: no
    topology is a one-process run in both packages (no group forms); a
    dangling or partial one raises the same ValueError in both."""
    for key in ("POCO_COORDINATOR", "POCO_NUM_PROCESSES", "POCO_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for package in (jax_dist, dist):
        if match is None:
            assert package.maybe_initialize() is False
        else:
            with pytest.raises(ValueError, match=match):
                package.maybe_initialize()
    assert not torch.distributed.is_initialized()


def test_dist_without_topology_or_torchrun_environment_raises(monkeypatch):
    """--dist (auto) with neither POCO_* nor torchrun's variables cannot
    form a world, and says so rather than run one process."""
    for key in ("POCO_COORDINATOR", "POCO_NUM_PROCESSES", "POCO_PROCESS_ID", "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        dist.maybe_initialize(auto=True, backend="gloo")
    assert not torch.distributed.is_initialized()


def test_one_process_helpers_are_no_ops():
    """Without a process group every helper is the identity, as the JAX
    package's are with one process."""
    a = np.arange(6.0).reshape(3, 2)
    t = torch.arange(4.0)
    assert dist.process_count() == 1 and dist.process_index() == 0 and dist.is_main_process()
    assert dist.allgather(a) is a
    assert dist.all_reduce_sum(t) is t and dist.all_reduce_sum_(t) is t
    assert dist.broadcast_object({"x": 1}) == {"x": 1}
    dist.barrier()
    dist.all_reduce_gradients([torch.nn.Parameter(t.clone())])
    assert dist.local_shard_bounds(8) == jax_dist.local_shard_bounds(8) == (0, 8)


# --------------------------------------------------------------------------
# padding and rows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 3), 2, 0), ((8, 2, 2), 4, 0), ((3,), 8, 0), ((2, 5), 3, 1), ((6, 1), 3, 0),
])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    arr = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, mask = pad_to_multiple(arr, multiple, axis)
    ref, ref_mask = jax_pad_to_multiple(arr, multiple, axis)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(mask, ref_mask)
    assert got.dtype == ref.dtype


@pytest.mark.parametrize("global_batch,n", [(8, 2), (64, 2), (12, 3), (16, 4)])
def test_local_shard_bounds_and_rows_match_jax(world, global_batch, n):
    """Each process's rows are the JAX process's: contiguous, in rank
    order; an indivisible batch raises in both."""
    rows = np.arange(global_batch)
    seen = []
    for p in range(n):
        world(n, p)
        lo, hi = dist.local_shard_bounds(global_batch)
        assert (lo, hi) == jax_dist.local_shard_bounds(global_batch)
        assert shard_bounds(global_batch, n, p) == (lo, hi)
        seen.extend(rows[lo:hi])
    assert seen == list(rows)
    world(n, 0)
    for package in (dist, jax_dist):
        with pytest.raises(ValueError, match="not divisible"):
            package.local_shard_bounds(global_batch + 1)


# --------------------------------------------------------------------------
# the loader's shards
# --------------------------------------------------------------------------

def _assert_batches_equal(port: dict, ref: dict) -> None:
    assert list(port) == list(ref)
    for key, value in ref.items():
        if isinstance(value, list):
            assert port[key] == value, key
        else:
            np.testing.assert_array_equal(port[key], value, err_msg=key)


def _datasets(package_dataset, mixed_class, kind: str):
    kwargs = {"img_dir": str(DATA), "is_train": True, "seed": 5}
    if kind == "poco":
        return package_dataset(str(TRAIN_NPZ), dataset_name="smoke", **kwargs)
    members = [package_dataset(str(TRAIN_NPZ), dataset_name="h36m", **kwargs),
               package_dataset(str(TEST_NPZ), dataset_name="coco", **kwargs)]
    return mixed_class(members, [0.6, 0.4], seed=7)


@pytest.mark.parametrize("kind", ["poco", "mixed"])
def test_sharded_loader_matches_jax(monkeypatch, kind):
    """DataLoader(num_shards=2, shard_index=i), global batch 8, shuffled,
    training augmentation on: every shard's batches (rows and
    `_global_row_names`) equal the JAX loader's with the same arguments,
    and the two shards together are the one-process batch."""
    monkeypatch.setenv("POCO_TPU_NATIVE_LOADER", "1")
    whole = list(DataLoader(_datasets(PocoDataset, RatioMixedDataset, kind), batch_size=8,
                            seed=2))
    shards = []
    for i in range(2):
        port = list(DataLoader(_datasets(PocoDataset, RatioMixedDataset, kind), batch_size=8,
                               seed=2, num_shards=2, shard_index=i))
        ref = list(JaxDataLoader(_datasets(JaxPocoDataset, JaxMixed, kind), batch_size=8,
                                 seed=2, num_shards=2, shard_index=i))
        assert len(port) == len(ref) == 2
        for b, r in zip(port, ref):
            _assert_batches_equal(b, r)
            assert len(b["_global_row_names"]) == 8 and len(b["imgname"]) == 4
        shards.append(port)
    for b, (first, second) in enumerate(zip(*shards)):
        assert first["_global_row_names"] == second["_global_row_names"]
        assert first["_global_row_names"] == list(whole[b]["dataset_name"])
        for key, value in whole[b].items():
            joined = (first[key] + second[key] if isinstance(value, list)
                      else np.concatenate([first[key], second[key]]))
            if isinstance(value, list):
                assert joined == value, key
            else:
                np.testing.assert_array_equal(joined, value, err_msg=key)


@pytest.mark.parametrize("batch_size,drop_last,match", [
    (7, True, "not divisible"), (8, False, "drop_last"),
])
def test_sharded_loader_errors_match_jax(batch_size, drop_last, match):
    for loader in (DataLoader, JaxDataLoader):
        with pytest.raises(ValueError, match=match):
            loader([], batch_size=batch_size, drop_last=drop_last, num_shards=2, shard_index=0)


class _Keepless:
    """A dataset with a `get_batch` that takes no `keep=`."""

    def __init__(self, n=8):
        self.rows = np.arange(n, dtype=np.float32)

    def __len__(self):
        return len(self.rows)

    def get_batch(self, indices):
        return {"x": self.rows[np.asarray(indices)]}


def test_sharded_loader_warns_on_a_keepless_dataset_as_jax():
    """Such a dataset is sliced (the JAX loader's fallback) with the same
    warning; the rows are the slice of the global batch."""
    for loader in (DataLoader, JaxDataLoader):
        loader._warned_keepless_shard = False
        with pytest.warns(UserWarning, match="no get_batch"):
            batches = list(loader(_Keepless(), batch_size=4, shuffle=False, num_shards=2,
                                  shard_index=1))
        np.testing.assert_array_equal([b["x"] for b in batches], [[2.0, 3.0], [6.0, 7.0]])


# --------------------------------------------------------------------------
# the GT-pose-conditioning mask of a shard
# --------------------------------------------------------------------------

@pytest.mark.parametrize("names,cond_ds,ratio", [
    (["smoke"] * 8, "smoke", 0.5),
    (["h36m", "coco", "h36m", "h36m", "coco", "coco", "h36m", "coco"], "h36m", 0.75),
    (["coco", "h36m"] * 4, "all", 0.5),
    (["coco"] * 6, "h36m", 1.0),
])
def test_global_cond_mask_slice_matches_jax(world, names, cond_ds, ratio):
    """Each process's slice of the global selection equals the JAX
    trainer's `_cond_mask` on the same loader batch; a batch without
    `_global_row_names` raises in both."""
    h = get_hparams_defaults()
    h.POCO.GT_POSE_COND_DS = cond_ds
    h.POCO.GT_POSE_COND_RATIO = ratio
    n = 2
    per = len(names) // n
    parts = []
    for p in range(n):
        world(n, p)
        host = {"dataset_name": names[p * per:(p + 1) * per], "_global_row_names": names}
        got = Trainer._cond_mask(types.SimpleNamespace(hparams=h, world=n), host)
        ref = JaxTrainer._cond_mask(types.SimpleNamespace(hparams=h, n_procs=n), host)
        np.testing.assert_array_equal(got, ref)
        parts.append(got)
    one = Trainer._cond_mask(types.SimpleNamespace(hparams=h, world=1), {"dataset_name": names})
    np.testing.assert_array_equal(np.concatenate(parts), one)
    for trainer, self_ in ((Trainer, types.SimpleNamespace(hparams=h, world=n)),
                           (JaxTrainer, types.SimpleNamespace(hparams=h, n_procs=n))):
        with pytest.raises(RuntimeError, match="_global_row_names"):
            trainer._cond_mask(self_, {"dataset_name": names[:per]})
