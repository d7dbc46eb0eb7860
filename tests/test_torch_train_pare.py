"""PyTorch port vs JAX package: one train step of POCO-PARE and of HMR.

The narrow POCO-PARE twin (HRNet-W32 pose at width 8, the PARE head with
its `PerPositionConv1x1` pose MLP, part attention and 56x56 branch convs
at full width; `test_torch_model.narrow_models(mp, "pare")`) with
configs/poco_pare.yaml's loss, and the tiny HMR twin (ResNet-50's
Bottleneck stages at depth 1, the HMR head at full width) with
configs/spin_hmr.yaml's: the port's `make_train_step` against JAX's on
the same weights and batch (B=2), all-keep dropout and the ReLU branches
of the port's float64 forward on both sides, at the bars of
`test_torch_train.test_train_step_matches_jax` for its narrow twin: the
loss terms (rtol 1e-5, atol 1e-6), each gradient leaf in L2 form
(|port - JAX| <= 1e-3 |JAX| + 1e-5 sqrt(n)), the BN running statistics
(atol 1e-5 + rtol 1e-4) and the parameters after the step (atol 2e-6
where both gradients exceed 1e-6 with one sign). Its own file, so that
`--dist loadfile` runs it beside `test_torch_train.py`.
"""

import pytest
import torch

from .test_torch_model import HMR_YAML, PARE_YAML, narrow_models
from .test_torch_train import check_train_step_against_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind,yaml", [("pare", PARE_YAML), ("hmr", HMR_YAML)], ids=["pare", "hmr"])
def test_train_step_matches_jax(monkeypatch, kind, yaml):
    twin = narrow_models(monkeypatch, kind)
    check_train_step_against_jax(monkeypatch, twin, yaml, narrow=True)
