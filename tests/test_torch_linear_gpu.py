"""The 3xTF32 linear kernel (`csrc/linear_3xtf32.cu` through
`ops/linear.py:linear_3xtf32`) on the card (marker `gpu`; skipped without
one). Run on a machine with a CUDA card:

    python -m pytest --noconftest -m gpu tests/test_torch_linear_gpu.py

Accuracy is read against an fp64 product, as the largest error of an
output scaled by |x| @ |w|^T + |b| (the size of the sum it rounds): at
each of a ViT-H block's four products (K, N of qkv, proj, fc1 and fc2)
at 24,576 rows (a 128-box request) and at ragged row counts (192: one
crop; 1536; 200, which ends inside a 128-row tile), the kernel is within
four times `F.linear`'s fp32 error (cuBLAS, TF32 off) on the same inputs
and at least a hundred times under `F.linear`'s in TF32. Each epilogue
matches the plain version; NaN and Inf in either operand reach the output
where they reach `F.linear`'s; the weight is split anew each call, so
`load_state_dict` and in-place edits show at once. A 128-box HMR 2.0
request launches the kernel 128 times (4 a block, 32 blocks) and a
POCO-CLIFF request never; ViT-H's trunk is within four times the
`F.linear` trunk's fp32 gap to its fp64 run. The op refuses non-fp32,
non-contiguous and gradient-requiring inputs and views off the alignment
the kernel reads with, and under a bf16 autocast region runs in fp32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.backbones import vit as vit_module
from poco_tpu_torch.models.backbones.hrnet import HRNet
from poco_tpu_torch.models.backbones.vit import vit_h
from poco_tpu_torch.ops.linear import EPILOGUES, linear_3xtf32, linear_reference
from poco_tpu_torch.smpl.assets import synthetic_smpl_model

pytestmark = pytest.mark.gpu

# (K, N) of one ViT-H block's products
SHAPES = {"qkv": (1280, 3840), "proj": (1280, 1280), "fc1": (1280, 5120), "fc2": (5120, 1280)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(m, k, n, seed, device, residual=False):
    """x ~ N(0, 1), w at nn.Linear's spread (U(+-1/sqrt(k))), b ~ 0.1 N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, device=device, generator=gen)
    w = (2 * torch.rand(n, k, device=device, generator=gen) - 1) * k ** -0.5
    b = 0.1 * torch.randn(n, device=device, generator=gen)
    r = torch.randn(m, n, device=device, generator=gen) if residual else None
    return x, w, b, r


def scaled_error(y, x, w, b):
    want = x.double() @ w.double().T + b.double()
    scale = x.double().abs() @ w.double().abs().T + b.double().abs()
    return float(((y.double() - want) / scale).abs().max())


@pytest.mark.parametrize("rows", [24576, 192, 1536, 200])
@pytest.mark.parametrize("layer", list(SHAPES))
def test_kernel_is_fp32_accurate(cuda, layer, rows):
    k, n = SHAPES[layer]
    x, w, b, _ = operands(rows, k, n, rows + k + n, cuda)
    with torch.no_grad():
        ours = scaled_error(linear_3xtf32(x, w, b), x, w, b)
        fp32 = scaled_error(F.linear(x, w, b), x, w, b)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = scaled_error(F.linear(x, w, b), x, w, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert ours <= 4 * fp32, (ours, fp32)
    assert 100 * ours <= tf32, (ours, tf32)


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_epilogue_matches_plain_torch(cuda, epilogue):
    """At 1000 x 1280 x 1280 (the last row tile ragged), against the plain
    version in fp64: within 1e-6 of the output's scale."""
    x, w, b, r = operands(1000, 1280, 1280, 11, cuda, residual=epilogue == "residual")
    got = linear_3xtf32(x, w, b, epilogue, r)
    want = linear_reference(x.double(), w.double(), b.double(), epilogue,
                            None if r is None else r.double())
    scale = x.double().abs() @ w.double().abs().T + b.double().abs()
    if r is not None:
        scale = scale + r.double().abs()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(((got.double() - want) / scale).abs().max()) < 1e-6


def test_odd_shapes_and_columns_past_the_tile(cuda):
    """N = 200 and K = 36: a column tile and a k-tile cut short."""
    x, w, b, r = operands(300, 36, 200, 12, cuda, residual=True)
    got = linear_3xtf32(x, w, b, "residual", r)
    want = linear_reference(x.double(), w.double(), b.double(), "residual", r.double())
    assert float((got.double() - want).abs().max()) < 1e-5


def test_non_finite_inputs_reach_the_output(cuda):
    x, w, b, _ = operands(256, 1280, 512, 13, cuda)
    x[3, 7], x[100, 2], x[200, 9] = float("nan"), float("inf"), -float("inf")
    w[5, 0], w[300, 1000] = float("nan"), float("inf")
    got, want = linear_3xtf32(x, w, b), F.linear(x, w, b)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert not bool(torch.isfinite(got[3]).any()) and not bool(torch.isfinite(got[:, 5]).any())


def test_weight_changes_show_at_once(cuda):
    """No split of a weight is kept between calls: after `load_state_dict`
    and after an in-place edit the output follows the new weight."""
    torch.manual_seed(14)
    layer, other = nn.Linear(1280, 1280).to(cuda), nn.Linear(1280, 1280).to(cuda)
    x = torch.randn(384, 1280, device=cuda)
    with torch.no_grad():
        before = linear_3xtf32(x, layer.weight, layer.bias)
        layer.load_state_dict(other.state_dict())
        after = linear_3xtf32(x, layer.weight, layer.bias)
        layer.weight.mul_(2.0)
        doubled = linear_3xtf32(x, layer.weight, layer.bias)
        for got, w in ((after, other.weight), (doubled, 2.0 * other.weight)):
            assert scaled_error(got, x, w, other.bias) < 1e-6
        assert scaled_error(before, x, other.weight, other.bias) > 1e-2


def request(boxes):
    rng = np.random.RandomState(15)
    image = rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8)
    centers = rng.uniform(100, 620, (boxes, 2)).astype(np.float32)
    scales = rng.uniform(0.8, 3.0, boxes).astype(np.float32)
    return image, centers, scales


def test_hmr2_request_launches_the_kernel_four_times_a_block(cuda, monkeypatch):
    """A 128-box HMR 2.0 request: 128 launches; a POCO-CLIFF request (its
    HRNet narrowed): none."""
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    torch.manual_seed(0)
    model = port_poco.build_hmr2(device=cuda)
    detect_forward(model, smpl, *request(128))["smpl_vertices"].cpu()
    before = linear_3xtf32.launches
    out = detect_forward(model, smpl, *request(128))
    assert bool(torch.isfinite(out["smpl_vertices"]).all())
    assert linear_3xtf32.launches == before + 128
    del model, out
    monkeypatch.setitem(port_poco.BACKBONES, "hrnet_w48_cls", lambda: HRNet(width=8))
    cliff = port_poco.build_poco_cliff(device=cuda)
    before = linear_3xtf32.launches
    detect_forward(cliff, smpl, *request(128))["smpl_vertices"].cpu()
    assert linear_3xtf32.launches == before


def test_trunk_matches_the_flinear_trunk(cuda, monkeypatch):
    """ViT-H at its initializers on 8 crops: the kernel's features lie as
    close to the fp64 trunk's as `F.linear`'s fp32 features do, within four
    times, and both within 1e-4 of their largest value."""
    torch.manual_seed(16)
    trunk = vit_h().to(cuda).eval()
    crops = torch.randn(8, 3, 256, 192, device=cuda)
    with torch.no_grad():
        ours = trunk(crops)
        monkeypatch.setattr(vit_module, "linear_3xtf32", linear_reference)
        plain = trunk(crops)
        want = trunk.double()(crops.double())

    def gap(y):
        return float((y.double() - want).abs().max() / want.abs().max())

    assert gap(ours) <= 4 * gap(plain) and gap(plain) < 1e-4, (gap(ours), gap(plain))


def test_op_refuses_what_the_kernel_does_not_take(cuda):
    x, w, b, _ = operands(64, 1280, 256, 17, cuda)
    with pytest.raises(TypeError):
        linear_3xtf32(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        linear_3xtf32(torch.randn(64, 2560, device=cuda)[:, ::2], w, b)
    with pytest.raises(ValueError):
        linear_3xtf32(x[:, :1278].contiguous(), w[:, :1278].contiguous(), b)
    with pytest.raises(RuntimeError, match="no backward"):
        linear_3xtf32(x, w.requires_grad_(), b)
    with pytest.raises(ValueError):
        linear_3xtf32(x.cpu(), w.detach(), b)


def shifted(t, floats=1):
    """A contiguous copy of `t` that starts `floats` floats past an
    allocation's start, as a view into a flat buffer may."""
    flat = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = flat[floats:].view(t.shape)
    view.copy_(t)
    return view


def test_op_refuses_misaligned_views(cuda):
    """x and the weight must start on 16 bytes, bias and residual on 8:
    a view off those raises before any launch, not a misaligned-address
    fault that would end the CUDA context."""
    x, w, b, r = operands(64, 1280, 256, 19, cuda, residual=True)
    before = linear_3xtf32.launches
    for args in ((shifted(x, 2), w, b), (x, shifted(w), b), (x, shifted(w, 2), b),
                 (x, w, shifted(b))):
        with pytest.raises(ValueError, match="boundary"):
            linear_3xtf32(*args)
    with pytest.raises(ValueError, match="boundary"):
        linear_3xtf32(x, w, b, "residual", shifted(r))
    assert linear_3xtf32.launches == before
    got = linear_3xtf32(x, w, shifted(b, 2), "residual", shifted(r, 2))   # 8-byte: taken
    torch.testing.assert_close(got, linear_3xtf32(x, w, b, "residual", r), rtol=0, atol=0)


def test_bf16_autocast_runs_the_kernel_in_fp32(cuda):
    x, w, b, _ = operands(256, 1280, 256, 18, cuda)
    before = linear_3xtf32.launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got = linear_3xtf32(x.bfloat16(), w, b, "gelu")
    assert linear_3xtf32.launches == before + 1 and got.dtype == torch.float32
    want = F.gelu(F.linear(x.bfloat16().float(), w, b))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
