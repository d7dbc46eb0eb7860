"""fp32 linear layers on Hopper's tensor cores: the 3xTF32 kernel's wrapper
and its plain torch version.

`linear_3xtf32(x, weight, bias, epilogue, residual)` computes
`F.linear(x, weight, bias)` followed by the epilogue: "none", "gelu" (the
exact erf GELU, `F.gelu`'s default) or "residual" (`residual + y`). On
CUDA tensors it launches `csrc/linear_3xtf32.cu` (a persistent `wgmma`
GEMM that sums three TF32 products, A_small B_big + A_big B_small + A_big
B_big, in fp32: fp32's accuracy, not TF32's), after `poco_tf32_split`
splits the weight into its TF32 big and small parts in scratch for that
call; it runs `linear_reference` only for tensors that lie on the CPU. A
CUDA tensor either runs the kernel or raises: there is no fallback. The
op is the registered torch custom op `poco_tpu_torch::linear_3xtf32`,
with a CUDA implementation (the kernel), a CPU one (the plain version) and
a fake one (shapes only), so `torch.export` keeps the call. The kernel
has no backward: the wrapper refuses CUDA inputs that need a gradient,
while CPU inputs that need one take `linear_reference` itself, so autograd
differentiates it as it did `nn.Linear`. Under a bf16
autocast region on the card its inputs are cast to fp32 (the kernel has
no bf16 form); on the CPU the plain version runs under the region as
`F.linear` would. Importing this module registers the op.

`tf32_split` and `linear_3xtf32_emulated` state the kernel's arithmetic
in plain torch (TF32 rounding by bit operations, fp32 products of the
parts), for the tests that hold the split to fp32's error on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernels
from .skinning import _refuse_gradient

EPILOGUES = ("none", "gelu", "residual")


def linear_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     epilogue: str = "none", residual: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Plain `epilogue(F.linear(x, weight, bias))`; "residual" is
    `residual + y`, as a pre-norm block's `x + layer(...)`."""
    y = F.linear(x, weight, bias)
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "residual":
        return residual + y
    return y


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 `x` as big + small: big is x rounded to TF32 (10 mantissa bits,
    to nearest, ties away from zero: `cvt.rna.tf32.f32` for finite x), small
    the residual x - big rounded the same way."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


def linear_3xtf32_emulated(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight^T as the kernel sums it: the three products of the TF32
    parts, each exact in fp32 as on the tensor cores, small terms first."""
    x_big, x_small = tf32_split(x)
    w_big, w_small = tf32_split(weight)
    return x_small @ w_big.T + x_big @ w_small.T + x_big @ w_big.T


def _check(x, weight, bias, residual) -> torch.device:
    """Raise unless the CUDA inputs are what the kernel takes; returns
    their device."""
    tensors = [x, weight, bias] + ([] if residual is None else [residual])
    device = x.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "linear_3xtf32: tensors must all lie on the CPU or on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"linear_3xtf32: float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_3xtf32: inputs must be contiguous")
    n, k = weight.shape if weight.dim() == 2 else (-1, -1)
    out_shape = (*x.shape[:-1], n)
    if (x.dim() < 1 or x.shape[-1] != k or bias.shape != (n,)
            or (residual is not None and residual.shape != out_shape)):
        raise ValueError(
            "linear_3xtf32: expected x (..., K), weight (N, K), bias (N,)"
            f"{', residual (..., N)' if residual is not None else ''}, got "
            f"{[tuple(t.shape) for t in tensors]}")
    if k % 4 or n % 2 or k == 0 or x.numel() // k >= 2**31:
        raise ValueError(f"linear_3xtf32: K must be a positive multiple of 4, N even and "
                         f"the rows under 2^31, got K={k}, N={n}, {x.numel() // max(k, 1)} rows")
    # TMA reads x and the split reads the weight as float4; the epilogue
    # reads bias and residual as float2
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("linear_3xtf32: x and weight must start on a 16-byte boundary")
    if bias.data_ptr() % 8 or (residual is not None and residual.data_ptr() % 8):
        raise ValueError("linear_3xtf32: bias and residual must start on an 8-byte boundary")
    return device


def _call(symbol: str, device: torch.device, args, argtypes) -> None:
    """Launch `symbol` of the kernel library on the current stream of
    `device`; raise if the launch fails."""
    fn = getattr(kernels.load("linear_3xtf32"), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linear_3xtf32: {symbol} failed: CUDA error {rc}")


@torch.library.custom_op("poco_tpu_torch::linear_3xtf32", mutates_args=(),
                         device_types="cuda")
def _linear_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               residual: torch.Tensor | None, epilogue: str) -> torch.Tensor:
    """The CUDA implementation of the op: the weight's split, then the
    kernel, counted."""
    device = _check(x, weight, bias, residual)
    n, k = weight.shape
    m = x.numel() // k
    big, small = torch.empty((2, n, k), dtype=torch.float32, device=device)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.float32, device=device)
    _call("poco_tf32_split", device,
          [weight.data_ptr(), big.data_ptr(), small.data_ptr(), weight.numel()],
          [ctypes.c_void_p] * 3 + [ctypes.c_longlong])
    _call("poco_linear_3xtf32", device,
          [x.data_ptr(), big.data_ptr(), small.data_ptr(), bias.data_ptr(),
           None if residual is None else residual.data_ptr(), out.data_ptr(),
           m, n, k, EPILOGUES.index(epilogue)],
          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4)
    linear_3xtf32.launches += 1
    return out


@_linear_op.register_kernel("cpu")
def _linear_cpu(x, weight, bias, residual, epilogue):
    return linear_reference(x, weight, bias, epilogue, residual)


@_linear_op.register_fake
def _linear_fake(x, weight, bias, residual, epilogue):
    return x.new_empty((*x.shape[:-1], weight.shape[0]))


torch.library.register_autocast("poco_tpu_torch::linear_3xtf32", "cuda", torch.float32)


def linear_3xtf32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  epilogue: str = "none", residual: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """`epilogue(F.linear(x, weight, bias))` in fp32; same contract as
    `linear_reference`.

    Calls the `poco_tpu_torch::linear_3xtf32` op. CPU tensors take the
    plain version, and `linear_reference` itself where an input needs a
    gradient while autograd is on, so that the gradient flows. CUDA
    tensors must be float32, contiguous and on one device, with K a
    multiple of 4, N even, x and weight on a 16-byte boundary and bias and
    residual on an 8-byte one; the kernel writes a fresh output on the
    current stream and `linear_3xtf32.launches` counts each launch (never
    a CPU, traced or fake call). CUDA inputs that need a gradient raise
    while autograd is on: the kernel has no backward. Tensors on any
    other device (meta included) raise here, before the op would reach
    its fake implementation.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"linear_3xtf32: epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("linear_3xtf32: a residual goes with the 'residual' epilogue alone")
    tensors = [x, weight, bias] + ([] if residual is None else [residual])
    if all(t.device.type == "cpu" for t in tensors):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return linear_reference(x, weight, bias, epilogue, residual)
    elif all(t.device.type == "cuda" and t.device == x.device for t in tensors):
        _refuse_gradient("linear_3xtf32", tensors, "any input")
    else:
        raise ValueError(
            "linear_3xtf32: tensors must all lie on the CPU or on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}")
    return torch.ops.poco_tpu_torch.linear_3xtf32(x, weight, bias, residual, epilogue)


linear_3xtf32.launches = 0
