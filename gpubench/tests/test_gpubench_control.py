"""On the card: the control (the reference put in the port's place in
TF32, the precision below the configurations' fp32 with TF32 off) fails
each cell's comparison, and the port passes it, at the cells' full
widths with small traffic (8 boxes a request, batches of 8). Run on the
card with `python3 -m pytest -m gpu gpubench/tests -q`; skips without one."""

from __future__ import annotations

import tempfile
import time

import pytest
import torch

import run
from bench import manifest
from conftest import TINY_CELLS, make_small_copy

pytestmark = pytest.mark.gpu
SEEDS = (2**31 + 5, 2**31 + 7, 2**31 + 9)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_small_copy(tmp_path_factory.mktemp("small"))


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_fails_and_port_passes(small_root, cell):
    data = manifest.load_cell(f"small_{cell}", small_root)
    for seed in SEEDS:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = run.context(data, seed, 0.0, False, "cuda", tmp, time.perf_counter())
            run.precise("cuda")
            readings = manifest.runner(data["traffic_data"]["kind"], small_root).control(ctx)
        assert any(readings["control"][k] > limit for k, limit in data["limits"].items()), (
            seed, readings)
        result = run.run_cell(f"small_{cell}", seed, 2.0, False, "cuda", root=small_root,
                              t_start=time.perf_counter())
        assert result["correct"], (seed, result["checks"])
