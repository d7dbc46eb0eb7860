"""Dataset mixing: ratio-sampled multi-dataset training (port of
`poco_tpu.data.mixed`).

Reference contracts:
  * EFTMixedDataset: the "h36m_coco_mpii_0.5_0.3_0.2" spec parsed into
    datasets and cumulative ratios, a dataset drawn per item
    (pocolib/dataset/eft_dataset.py:11-37);
  * MixedDataset: the legacy SPIN 30/60/10 partition
    (pocolib/dataset/mixed_dataset.py:12-36);
  * STAGE_DATASETS: "0+h36m_1.0,10+h36m_coco_0.5_0.5", the curriculum
    switched by epoch (pocolib/core/trainer.py:640-654).
"""

from __future__ import annotations

import inspect

import numpy as np


def parse_datasets_and_ratios(spec: str) -> tuple[list[str], list[float]]:
    """'h36m_coco_0.6_0.4' -> (['h36m', 'coco'], [0.6, 0.4])."""
    parts = spec.split("_")
    n = len(parts) // 2
    names, ratios = parts[:n], [float(p) for p in parts[n:]]
    if len(names) != len(ratios):
        raise ValueError(f"dataset/ratio mismatch in {spec!r}")
    return names, ratios


def parse_stage_datasets(spec: str) -> dict[int, str]:
    """'0+h36m_1.0,10+h36m_coco_0.5_0.5' -> {0: 'h36m_1.0', 10: ...}."""
    stages = {}
    for part in spec.split(","):
        if not part:
            continue
        epoch, ds = part.split("+", 1)
        stages[int(epoch)] = ds
    return stages


def stage_for_epoch(stages: dict[int, str], epoch: int) -> str | None:
    """The curriculum spec active at `epoch` (the latest stage <= epoch)."""
    active = None
    for start in sorted(stages):
        if epoch >= start:
            active = stages[start]
    return active


class RatioMixedDataset:
    """Ratio-sampled mixture whose length is its longest member's.

    Each item draws a member by cumulative ratio and indexes it modulo the
    member's length (reference eft_dataset.py:30-34).
    """

    def __init__(self, datasets: list, ratios: list[float], seed: int = 0):
        if len(datasets) != len(ratios):
            raise ValueError("dataset/ratio mismatch")
        self.datasets = datasets
        self.cum_ratios = np.cumsum(np.asarray(ratios, np.float64))
        self.rng = np.random.RandomState(seed)
        self.length = max(len(d) for d in datasets)

    def __len__(self) -> int:
        return self.length

    def _pick(self) -> int:
        p = self.rng.rand()
        for i, edge in enumerate(self.cum_ratios):
            if p <= edge:
                return i
        return len(self.datasets) - 1

    def __getitem__(self, index: int):
        i = self._pick()
        return self.datasets[i][index % len(self.datasets[i])]

    def get_batch(self, indices, keep=None) -> dict:
        """A whole batch: the members drawn for every index first, then
        each member's share read (through its own `get_batch` where it has
        one), reassembled in request order; the JAX package's order of
        random draws.

        keep: positions (a slice or a list) of the rows to build, for
        sharded loading. The members are still drawn for every index and
        each member draws its per-row randomness over its whole global
        share, so every process sees the one-process batch's composition
        and augmentations; only the kept rows are decoded. The result then
        carries `_global_row_names` (the member's dataset name of every
        global row).
        """
        from .dataset import collate

        indices = [int(i) for i in indices]
        choices = [self._pick() for _ in indices]
        names = None
        sel = list(range(len(indices)))
        if keep is not None:
            names = [getattr(self.datasets[c], "dataset_name", f"ds{c}") for c in choices]
            sel = sel[keep] if isinstance(keep, slice) else [int(k) for k in keep]
        slot = {k: j for j, k in enumerate(sel)}  # global position -> output row
        items: list = [None] * len(sel)
        for di, ds in enumerate(self.datasets):
            pos = [k for k, c in enumerate(choices) if c == di]
            if not pos:
                continue
            local = [indices[k] % len(ds) for k in pos]
            kept = [r for r, k in enumerate(pos) if k in slot]
            sub_get = getattr(ds, "get_batch", None)
            if sub_get is not None and len(kept) == len(pos):
                sub = sub_get(local)
                for j, k in enumerate(pos):
                    items[slot[k]] = {key: sub[key][j] for key in sub}
            elif sub_get is not None and "keep" in inspect.signature(sub_get).parameters:
                sub = sub_get(local, keep=kept)
                keys = [key for key in sub if key != "_global_row_names"]
                for j, r in enumerate(kept):
                    items[slot[pos[r]]] = {key: sub[key][j] for key in keys}
            else:
                for r in kept:
                    items[slot[pos[r]]] = ds[local[r]]
        batch = collate(items)
        if names is not None:
            batch["_global_row_names"] = names
        return batch


def spin_mixed_partition(dataset_lengths: list[int]) -> list[float]:
    """The legacy SPIN 30% H36M / 60% in-the-wild / 10% MPI-INF split
    (mixed_dataset.py:19-28), for the 6 canonical datasets in the order
    [h36m, lsp-orig, mpii, lspet, coco, mpi-inf-3dhp]."""
    itw = sum(dataset_lengths[1:-1])
    return [0.3] + [0.6 * n / itw for n in dataset_lengths[1:-1]] + [0.1]
