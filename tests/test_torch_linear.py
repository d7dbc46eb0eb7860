"""The 3xTF32 linear op (`ops/linear.py`) on the CPU, where it runs the
plain version, and the arithmetic of its CUDA kernel (`csrc/
linear_3xtf32.cu`, which runs only on the card:
`tests/test_torch_linear_gpu.py`).

- The op's CPU route is `F.linear` and the same epilogue in plain torch,
  bitwise, at 2-D and 3-D inputs; it launches nothing.
- Its fake implementation gives `torch.export` the output's shape, with
  the batch dynamic, and the exported program keeps the op.
- The split the kernel computes, stated in plain torch (TF32 rounding by
  bit operations; three fp32 products of the parts, each exact as on the
  tensor cores): against an fp64 product at 256 x K x 256, K = 1280 and
  5120, its largest error scaled by |x| @ |w|^T stays within twice fp32's,
  while one product of TF32-rounded operands is at least a hundred times
  worse.
- A ViT block's forward through the op is bitwise the block written with
  `nn.Linear` calls and its own residual adds, as it was before the op.
- On the CPU the op stays differentiable: inputs that need a gradient
  take the plain version itself, and a ViT block backpropagates through
  it with the gradients of the block written with `nn.Linear` calls.
- The wrapper refuses unknown epilogues, a residual without its epilogue
  and tensors on other devices (the card's refusals of gradients and of
  misaligned views are in `tests/test_torch_linear_gpu.py`).
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from poco_tpu_torch.models.backbones.vit import ViT
from poco_tpu_torch.ops.linear import (
    EPILOGUES,
    linear_3xtf32,
    linear_3xtf32_emulated,
    linear_reference,
    tf32_split,
)


def operands(shape, k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, k, generator=gen)
    w = (2 * torch.rand(n, k, generator=gen) - 1) * k ** -0.5
    b = 0.1 * torch.randn(n, generator=gen)
    r = torch.randn(*shape, n, generator=gen)
    return x, w, b, r


@pytest.mark.parametrize("shape", [(48,), (3, 16)], ids=["2d", "3d"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_cpu_route_is_flinear_bitwise(epilogue, shape):
    x, w, b, r = operands(shape, 64, 96, 1)
    residual = r if epilogue == "residual" else None
    before = linear_3xtf32.launches
    got = linear_3xtf32(x, w, b, epilogue, residual)
    want = F.linear(x, w, b)
    want = {"none": want, "gelu": F.gelu(want), "residual": r + want}[epilogue]
    assert torch.equal(got, want)
    assert linear_3xtf32.launches == before


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_fake_gives_the_shape_under_export(epilogue):
    class Layer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(32, 24)

        def forward(self, x, r):
            return linear_3xtf32(x, self.fc.weight, self.fc.bias, epilogue,
                                 r if epilogue == "residual" else None)

    layer = Layer().eval()
    x, _, _, r = operands((5, 7), 32, 24, 2)
    batch = torch.export.Dim("batch", min=1, max=64)
    with torch.no_grad():
        program = torch.export.export(layer, (x, r), dynamic_shapes=({0: batch}, {0: batch}))
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    assert "poco_tpu_torch.linear_3xtf32.default" in targets
    out = [node for node in program.graph.nodes if node.op == "output"][0].args[0][0]
    assert isinstance(out.meta["val"].shape[0], torch.SymInt)
    assert tuple(out.meta["val"].shape[1:]) == (7, 24)
    x3, _, _, r3 = operands((3, 7), 32, 24, 3)
    with torch.no_grad():
        assert torch.equal(program.module()(x3, r3), layer(x3, r3))


def test_tf32_split_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10            # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0e-3])
    big, small = tf32_split(x)
    assert big[:5].tolist() == [1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp)]
    assert torch.equal(big + small, x)   # these residuals fit TF32
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("k", [1280, 5120])
def test_split_keeps_fp32_accuracy(k):
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(256, k, generator=gen)
    w = (2 * torch.rand(256, k, generator=gen) - 1) * k ** -0.5
    want = x.double() @ w.double().T
    scale = x.double().abs() @ w.double().abs().T

    def err(y):
        return float(((y.double() - want) / scale).abs().max())

    fp32 = err(x @ w.T)
    three = err(linear_3xtf32_emulated(x, w))
    one = err(tf32_split(x)[0] @ tf32_split(w)[0].T)
    assert three <= 2 * fp32, (three, fp32)
    assert one >= 100 * fp32, (one, fp32)


def old_block(block, x):
    """A ViT block as it was written before the op: nn.Linear calls and
    the residual adds of the block."""
    b, n, c = x.shape
    h = block.norm1(x)
    qkv = block.attn.qkv(h).reshape(b, n, 3, block.attn.num_heads, c // block.attn.num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    out = F.scaled_dot_product_attention(q, k, v)
    x = x + block.attn.proj(out.transpose(1, 2).reshape(b, n, c))
    return x + block.mlp.fc2(F.gelu(block.mlp.fc1(block.norm2(x))))


def test_vit_block_is_bitwise_as_before():
    torch.manual_seed(4)
    trunk = ViT(img_size=(64, 48), embed_dim=64, depth=2, num_heads=4).eval()
    x = torch.randn(3, 12, 64)
    with torch.no_grad():
        for block in trunk.blocks:
            assert torch.equal(block(x), old_block(block, x))


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_cpu_route_carries_the_gradient(epilogue):
    x, w, b, r = operands((8,), 16, 8, 5)
    residual = r if epilogue == "residual" else None
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    twins = [t.clone().requires_grad_() for t in (x, w, b)]
    grad_out = torch.randn(8, 8, generator=torch.Generator().manual_seed(7))
    linear_3xtf32(*leaves, epilogue, residual).backward(grad_out)
    linear_reference(*twins, epilogue, residual).backward(grad_out)
    for got, want in zip(leaves, twins):
        assert torch.equal(got.grad, want.grad)


def test_vit_block_backpropagates_on_the_cpu():
    torch.manual_seed(8)
    trunk = ViT(img_size=(64, 48), embed_dim=64, depth=1, num_heads=4)
    block = trunk.blocks[0]
    x = torch.randn(2, 12, 64)
    grad_out = torch.randn(2, 12, 64)
    grads = []
    for forward in (block, lambda t: old_block(block, t)):
        block.zero_grad()
        leaf = x.clone().requires_grad_()
        forward(leaf).backward(grad_out)
        grads.append([leaf.grad] + [p.grad.clone() for p in block.parameters()])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_wrapper_refusals():
    x, w, b, r = operands((8,), 16, 8, 5)
    with pytest.raises(ValueError, match="epilogue"):
        linear_3xtf32(x, w, b, "relu")
    with pytest.raises(ValueError, match="residual"):
        linear_3xtf32(x, w, b, "residual")
    with pytest.raises(ValueError, match="residual"):
        linear_3xtf32(x, w, b, "none", r)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        linear_3xtf32(x.to("meta"), w, b)


def test_reference_matches_the_op_contract():
    x, w, b, r = operands((6,), 8, 4, 6)
    assert torch.equal(linear_reference(x, w, b, "residual", r), r + F.linear(x, w, b))
