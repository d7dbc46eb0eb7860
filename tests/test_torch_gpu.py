"""The port's CUDA kernels on the card (marker `gpu`; skipped without one).

Run on a machine with a CUDA card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The skinning kernel (`skinning`, 3xTF32 tensor cores) and its fp32-FMA
yardstick (`skinning_simt`) are held to their plain torch version on the
same CUDA tensors at atol 1e-4 (fp32 sums of 24 terms in another order;
the 3xTF32 split is within about 1e-6 of fp32), at the main path's shape,
at the edges of the 16-row warp slices and the 128-vertex block tile,
at odd sample counts (a pair with one sample), and at any 4-byte
alignment of the tensors. The main path launches `skinning` once
per SMPL forward and never `skinning_simt`.
"""

import numpy as np
import pytest
import torch

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.backbones.hrnet import HRNet
from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops.skinning import skinning, skinning_reference, skinning_simt
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.smpl.lbs import smpl_forward

pytestmark = pytest.mark.gpu

ATOL = 1e-4
KERNELS = {"skinning": skinning, "skinning_simt": skinning_simt}


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


@pytest.mark.parametrize("batch", [1, 2, 31, 33, 128])
@pytest.mark.parametrize("num_verts", [1, 63, 64, 65, 127, 128, 129, 6890])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_match_plain_at_tile_edges(cuda, kernel, num_verts, batch):
    args = _inputs(batch, num_verts, seed=7 * batch + num_verts, device=cuda)
    out = KERNELS[kernel](*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=ATOL)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_take_any_float_alignment(cuda, kernel, offset):
    """Contiguous views that start 4, 8 or 12 bytes past a 16-byte line."""
    args = _inputs(5, 130, seed=offset, device=cuda)
    shifted = []
    for a in args:
        base = torch.empty(a.numel() + 4, device=cuda)
        view = base[offset:offset + a.numel()].view(a.shape)
        view.copy_(a)
        shifted.append(view)
    assert all(v.data_ptr() % 16 == 4 * offset for v in shifted)
    out = KERNELS[kernel](*shifted)
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


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernels_refuse_inputs_that_need_a_gradient(cuda, kernel):
    """No backward: a result autograd cannot follow is an error, not a
    silently missing gradient. Without autograd the same call runs."""
    w, tfms, vp = _inputs(2, 64, seed=3, device=cuda)
    vp.requires_grad_(True)
    before = KERNELS[kernel].launches
    with pytest.raises(RuntimeError, match="no backward"):
        KERNELS[kernel](w, tfms, vp)
    assert KERNELS[kernel].launches == before
    with torch.no_grad():
        out = KERNELS[kernel](w, tfms, vp)
    torch.cuda.synchronize()
    assert KERNELS[kernel].launches == before + 1
    torch.testing.assert_close(
        out, skinning_reference(w, tfms, vp.detach()), rtol=0, atol=ATOL
    )


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


def test_main_path_launches_skinning_and_never_the_yardstick(cuda, monkeypatch):
    """`detect_forward` on a narrow POCO-CLIFF (HRNet width 8; every other
    module at full width, V=6890): one `skinning` launch per request, no
    `skinning_simt` launch."""
    monkeypatch.setitem(port_poco.BACKBONES, "hrnet_w48_cls", lambda: HRNet(width=8))
    torch.manual_seed(0)
    model = port_poco.build_poco_cliff(device=cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (240, 320, 3)).astype(np.uint8)
    centers = np.asarray([[160, 120], [40, 200], [300, 30]], np.float32)
    scales = np.asarray([1.1, 0.5, 0.8], np.float32)
    before, before_simt = skinning.launches, skinning_simt.launches
    for _ in range(2):
        out = detect_forward(model, smpl, image, centers, scales)
    torch.cuda.synchronize()
    assert skinning.launches == before + 2
    assert skinning_simt.launches == before_simt
    assert out["smpl_vertices"].shape == (3, 6890, 3)
    assert bool(torch.isfinite(out["smpl_vertices"]).all())
