"""Data parallelism over processes with `torch.distributed` (port of
`poco_tpu.parallel.distributed`).

The reference trains with PyTorch-Lightning DDP (train.py:81-96: NCCL
ranks, rank-0 gating in pocolib/utils/train_utils.py:161-184). The JAX
package runs one SPMD program over a global mesh; here, as in PyTorch,
each process drives one card and holds its own rows of the global batch:

  * `maybe_initialize` forms the process group before the first CUDA use
    (NCCL on cards, gloo on the CPU);
  * each process loads only its contiguous rows of every global batch
    (`data.dataset.DataLoader(num_shards=, shard_index=)`);
  * the model's cross-row reductions are taken over the global batch
    (batch norm in `models/backbones/common.py`, dropout masks in
    `models/layers.py`, loss means in `losses/losses.py`), and the train
    step sums the gradients over processes (`all_reduce_gradients`), so N
    processes give the result of one process on the same global batch;
  * `is_main_process()` gates the logs, checkpoints and reports.

There is no `global_batch_from_local`: the JAX package assembles a global
sharded array from each process's rows, while here each process keeps its
rows on its own card and only the reductions cross processes.

Launch contract, as in the JAX package: set

    POCO_COORDINATOR=host:port  POCO_NUM_PROCESSES=N  POCO_PROCESS_ID=i

(one process per card; `POCO_COORDINATOR` may also be a `file://` path
that every process can reach), or pass `auto=True` (`--dist`) under
`torchrun`, which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT: torch has no pod detection, so `auto` reads that
environment. With none of these, `maybe_initialize` does nothing and the
run is one process. Every helper below is a no-op in a one-process run.

gloo works on host memory (its CUDA paths cover only some collectives), so
under gloo the collectives here stage CUDA tensors through host copies.
NCCL takes them where they lie.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import shard_bounds

_formed_here = False  # the group was formed by maybe_initialize


def maybe_initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    auto: bool = False,
    backend: str | None = None,
) -> bool:
    """Form the process group if a topology is configured.

    Explicit arguments win; otherwise the POCO_* variables are used;
    `auto=True` (`--dist`) with none of them reads torchrun's environment.
    `backend` defaults to NCCL when a card is present, else gloo. Under
    NCCL the process's current CUDA device becomes `cuda:<local_rank>`
    (LOCAL_RANK, else the process id modulo the cards). A topology that
    cannot form raises: nothing falls back to one process. Returns True
    when the world has more than one process.
    """
    global _formed_here

    coordinator = coordinator or os.environ.get("POCO_COORDINATOR")
    if num_processes is None and os.environ.get("POCO_NUM_PROCESSES"):
        num_processes = int(os.environ["POCO_NUM_PROCESSES"])
    if process_id is None and os.environ.get("POCO_PROCESS_ID"):
        process_id = int(os.environ["POCO_PROCESS_ID"])

    if coordinator is None and num_processes is None and not auto:
        # A dangling POCO_PROCESS_ID alone is a broken launcher: every
        # process would train on its own, each believing it is rank 0.
        if process_id is not None:
            raise ValueError(
                "POCO_PROCESS_ID is set but POCO_COORDINATOR / "
                "POCO_NUM_PROCESSES are not — refusing to fall back to "
                "independent single-process runs; fix the launcher env"
            )
        return False
    partial = coordinator is None or num_processes is None or process_id is None
    any_set = coordinator is not None or num_processes is not None or process_id is not None
    if partial and (not auto or any_set):
        raise ValueError(
            "incomplete multi-process topology: need ALL of "
            "POCO_COORDINATOR, POCO_NUM_PROCESSES, POCO_PROCESS_ID "
            "(or, with --dist, none of them and torchrun's environment) "
            f"(got coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})"
        )
    if dist.is_initialized():
        return dist.get_world_size() > 1

    if partial:  # auto, from torchrun's environment
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if not os.environ.get(k)]
        if missing:
            raise ValueError(
                f"--dist without POCO_* needs torchrun's environment; missing {missing}"
            )
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    _formed_here = True
    return num_processes > 1


def form_world(device: str, auto: bool = False) -> None:
    """The process group of an entry point (the POCO_* variables, or
    torchrun's with `auto`, i.e. --dist), formed before the first CUDA
    use: NCCL for a card, gloo for the CPU. Prints the process's place in
    it."""
    maybe_initialize(auto=auto, backend="gloo" if torch.device(device).type == "cpu" else "nccl")
    if backend() is not None:
        print(f"world: rank {process_index()} of {process_count()} "
              f"(backend {backend()})", flush=True)


def shutdown() -> None:
    """Destroy the process group that `maybe_initialize` formed."""
    global _formed_here

    if _formed_here and dist.is_initialized():
        dist.destroy_process_group()
    _formed_here = False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gate (reference train_utils.py:167-170)."""
    return process_index() == 0


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def local_shard_bounds(global_batch: int) -> tuple[int, int]:
    """Row range [lo, hi) of the global batch that this process owns: the
    process's contiguous slice, in rank order."""
    return shard_bounds(global_batch, process_count(), process_index())


def _staged(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor a collective runs on: a host copy of a CUDA tensor
    under gloo, the tensor itself otherwise."""
    if tensor.is_cuda and dist.get_backend() == "gloo":
        return tensor.cpu()
    return tensor


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over processes, in place (no gradient)."""
    if process_count() == 1:
        return tensor
    staged = _staged(tensor)
    dist.all_reduce(staged)
    if staged is not tensor:
        tensor.copy_(staged)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """y = sum over processes of x, the same on every process. Each
    process's loss reads y, so the gradient of x on a process is the sum
    of y's gradients over processes."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone())


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum over processes that carries a gradient (a new tensor)."""
    if process_count() == 1:
        return tensor
    return _AllReduceSum.apply(tensor)


def all_reduce_gradients(params) -> None:
    """Sum the gradients of `params` over processes, in place, in one
    collective over a flat buffer in the parameters' order. Every process
    must hold gradients for the same parameters."""
    if process_count() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(parts, grads)])


def allgather(array: np.ndarray) -> np.ndarray:
    """Every process's rows of `array` (the same shape on every process),
    concatenated in rank order, on every process. Collective: every
    process must call it at the same point."""
    if process_count() == 1:
        return array
    local = torch.from_numpy(np.ascontiguousarray(array))
    if dist.get_backend() == "nccl":
        local = local.cuda()
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    return torch.cat(parts).cpu().numpy()


def broadcast_object(obj):
    """Rank 0's `obj` on every process (a picklable object)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Cross-process sync point (reference train_utils.py:173-184)."""
    if process_count() == 1:
        return
    dist.barrier()
