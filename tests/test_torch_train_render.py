"""PyTorch port vs JAX package: one train step of the narrow POCO-PARE
twin with the render and part-segmentation losses on.

configs/poco_pare.yaml with TRAINING.USE_SMPL_RENDER_LOSS and
USE_SMPL_SEGM_LOSS on, the narrow twin of `test_torch_model.narrow_models`
(V=6890 SMPL, B=2): the port's `make_train_step` against JAX's at the bars
of `test_torch_train.check_train_step_against_jax` (loss terms rtol 1e-5,
each gradient leaf 1e-3 relative in L2 form, with the ReLU branches of the
port's float64 forward and the port's GT part labels on both sides), or
within FP32_FLOOR times the port's own fp32 distance from its float64
value. Its own file, so that `--dist loadfile` runs it beside the
rasterizer's tests (tests/test_torch_render_loss.py).
"""

import pytest
import torch

from .test_torch_model import PARE_YAML, narrow_models
from .test_torch_train import check_train_step_against_jax


# The render term moves the predicted vertices' fp32 noise into the
# gradient through the splats' curvature (sigma 1.5 px), and the port's CPU
# forward is about twice as far from float64 as XLA's (narrow twin's
# vertices 2.1e-4 against 1.2e-4 m): with the same labels, the render term
# reads 2.9e-5 relative from JAX's (the port 2.0e-5 from its float64) and
# backbone batch-norm leaves up to 1.96x the 1e-3 bar (the port 1.8e-3
# from its float64, at most 1.22x that from JAX). The render loss alone
# reads up to 1.60x the bar; the segmentation loss alone passes it (0.64).
FP32_FLOOR = 2.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_step_with_render_and_segm_losses_matches_jax(monkeypatch, tmp_path):
    yaml = tmp_path / "poco_pare_render_segm.yaml"
    yaml.write_text(PARE_YAML.read_text()
                    + "TRAINING:\n  USE_SMPL_RENDER_LOSS: true\n  USE_SMPL_SEGM_LOSS: true\n")
    twin = narrow_models(monkeypatch, "pare")
    check_train_step_against_jax(monkeypatch, twin, yaml, narrow=True,
                                 expect_terms=("loss/loss_smpl_segm", "loss/loss_smpl_render"),
                                 fp32_floor=FP32_FLOOR)
