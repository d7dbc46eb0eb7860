"""The port's CUDA kernels on the card (marker `gpu`; skipped without one).

Run on a machine with a CUDA card:

    python -m pytest -m gpu tests/test_torch_gpu.py

The skinning kernel is held to its plain torch version on the same CUDA
tensors at atol 1e-4 (fp32 sums of 24 terms in another order), at the
main path's shape and at ragged ones, and must launch exactly once per
SMPL forward.
"""

import numpy as np
import pytest
import torch

from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops.skinning import skinning, skinning_reference
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.smpl.lbs import smpl_forward

pytestmark = pytest.mark.gpu

ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(batch, num_verts, seed, device):
    rng = np.random.RandomState(seed)
    w = rng.rand(num_verts, 24).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    tfms = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 24, 4, 4)).copy()
    aa = torch.from_numpy((0.5 * rng.randn(batch * 24, 3)).astype(np.float32))
    tfms[:, :, :3, :3] = axis_angle_to_rotmat(aa).numpy().reshape(batch, 24, 3, 3)
    tfms[:, :, :3, 3] = 0.2 * rng.randn(batch, 24, 3)
    vp = rng.randn(batch, num_verts, 3).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (w, tfms, vp)]


@pytest.mark.parametrize("batch,num_verts", [(128, 6890), (3, 1001), (5, 1), (9, 257)])
def test_skinning_kernel_matches_plain(cuda, batch, num_verts):
    args = _inputs(batch, num_verts, seed=batch * num_verts, device=cuda)
    out = skinning(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=ATOL)


def test_skinning_refuses_what_the_kernel_does_not_take(cuda):
    w, tfms, vp = _inputs(2, 64, seed=0, device=cuda)
    with pytest.raises(TypeError):
        skinning(w.double(), tfms, vp)
    with pytest.raises(ValueError, match="contiguous"):
        skinning(w, tfms, vp.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="one CUDA device"):
        skinning(w.cpu(), tfms, vp)


def test_smpl_forward_launches_the_kernel_once(cuda):
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    rot = axis_angle_to_rotmat(0.3 * torch.randn(4, 24, 3, device=cuda))
    betas = torch.randn(4, 10, device=cuda)
    before = skinning.launches
    out = smpl_forward(smpl, betas, rot)
    torch.cuda.synchronize()
    assert skinning.launches == before + 1
    ref = smpl_forward(smpl.to("cpu"), betas.cpu(), rot.cpu())
    torch.testing.assert_close(out.vertices.cpu(), ref.vertices, rtol=0, atol=ATOL)
