"""Residual sum and bias-free LayerNorm in one hand-written CUDA kernel.

ModernBERT's pre-norm layers (``models/modernbert.py``) normalise the
residual stream right after adding to it. :func:`add_layernorm` computes,
over ``(..., H)`` tensors of one type and a gamma of shape ``(H,)``:

- with a residual ``d``: ``s = x + d`` in the compute type, then
  ``y = LN(s)``; returns ``(s, y)``;
- without one: ``y = LN(x)``; returns ``y``;

``LN(v) = ((vc * rsqrt(mean(vc * vc) + eps)) * gamma)`` with
``vc = v - mean(v)``, float32 two-pass statistics, rounded to the input's
type at the end (no bias: ModernBERT's LayerNorms have none).

On CUDA tensors ``csrc/add_layernorm.cu`` computes it in one launch, or
the wrapper raises (a type other than float32 or bfloat16, a width the
kernel is not built for, :data:`SUPPORTED_WIDTHS`, no rows, operands on
other devices); CPU tensors take the plain version,
:func:`add_layernorm_plain`, the chain of PyTorch ops the model ran before
the kernel (``layernorm.ln_forward_math`` without a bias). The kernel
replaces no TPU kernel: the JAX package has no ModernBERT. What bounds it
on the H100: a few flops per element against 8 bytes per element in bf16
with a residual and 4 without, so HBM bytes; one warp per row keeps the
row in registers, so every input is read once and every output written
once. ``s`` is bitwise the plain sum; ``y`` differs from the plain chain
only by the order of the row sums.

The gradient (:class:`_AddLayerNorm`) is ``layernorm.ln_backward_math``,
plain PyTorch in float32 from the saved sum and gamma, plus the sum's own,
passed to both ``x`` and ``d``, on every device (the JAX package has no
kernel to mirror, and no benchmark cell trains ModernBERT). Kernel 5
(``layernorm.layernorm_bwd``) does not serve it: it rounds gamma to the
input's type first, as the JAX package's ``_pln_bwd`` does, where
ModernBERT's forward, its reference and this gradient keep gamma in
float32.

The kernel's wrapper records the span ``launch.add_layernorm`` and counts
``add_layernorm.launches`` and ``add_layernorm.residual`` (the launches with
a residual; ``utils/profiling.count``); a replayed CUDA graph adds the
counts its capture recorded (``utils/graphs.py``). It makes no
synchronisation, no host read and no allocation but ``torch.empty``, so a
CUDA graph captures it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.profiling import count, spanned
from ._build import DTYPE_CODES, aligned, ptr
from .layernorm import SUPPORTED_WIDTHS, ln_backward_math, ln_forward_math


def add_layernorm_plain(x, d, weight, eps: float):
    """Plain PyTorch version of the kernel: ``(x + d, LN(x + d))`` with a
    residual ``d``, ``LN(x)`` without (``d`` None)."""
    if d is None:
        return ln_forward_math(x, weight, None, eps)
    s = x + d
    return s, ln_forward_math(s, weight, None, eps)


def _check(x, d, weight):
    H = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"add_layernorm takes float32 or bfloat16, got {x.dtype}")
    if H not in SUPPORTED_WIDTHS:
        raise ValueError(f"add_layernorm takes H in {SUPPORTED_WIDTHS}, got {H}")
    if x.numel() == 0:
        raise ValueError("add_layernorm needs at least one row")
    if weight.shape != (H,):
        raise ValueError(f"gamma {tuple(weight.shape)} must be ({H},)")
    if weight.device != x.device or (d is not None and d.device != x.device):
        raise ValueError("add_layernorm inputs must share one CUDA device")


@spanned("launch.add_layernorm")
def _launch(x, d, weight, eps):
    from ._build import load_library

    _check(x, d, weight)
    shape, H = x.shape, x.shape[-1]
    M = x.numel() // H
    x = aligned(x).view(M, H)
    d = None if d is None else aligned(d).view(M, H)
    gamma = aligned(weight.float())
    y = torch.empty_like(x)
    s = None if d is None else torch.empty_like(x)
    lib = load_library("add_layernorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.add_layernorm_fwd(DTYPE_CODES[x.dtype], ptr(x), None if d is None else ptr(d),
                                    ptr(gamma), None if s is None else ptr(s), ptr(y), M, H,
                                    ctypes.c_float(eps), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"add_layernorm_fwd launch failed: CUDA error {err}")
    count("add_layernorm.launches")
    if d is None:
        return y.view(shape)
    count("add_layernorm.residual")
    return s.view(shape), y.view(shape)


class _AddLayerNorm(torch.autograd.Function):
    """The kernel forward on CUDA tensors, the plain one on CPU tensors; the
    plain float32 gradient from the saved sum and gamma."""

    @staticmethod
    def forward(ctx, x, d, weight, eps):
        out = (_launch if x.is_cuda else add_layernorm_plain)(x, d, weight, eps)
        ctx.save_for_backward(x if d is None else out[0], weight)
        ctx.eps, ctx.residual = eps, d is not None
        return out

    @staticmethod
    def backward(ctx, *grads):
        s, weight = ctx.saved_tensors
        dx, dgamma = ln_backward_math(s, weight, grads[-1], ctx.eps)
        dgamma = dgamma.to(weight.dtype)
        if not ctx.residual:
            return dx, None, dgamma, None
        ds = dx + grads[0]
        return ds, ds, dgamma, None


def add_layernorm(x: torch.Tensor, d: Optional[torch.Tensor], weight: torch.Tensor,
                  eps: float):
    """``(x + d, LN(x + d))`` with a residual ``d`` of ``x``'s shape and
    type, ``LN(x)`` with ``d`` None (see the module's docstring); ``weight``
    is gamma, ``(H,)``. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if d is not None and (d.shape != x.shape or d.dtype != x.dtype):
        raise ValueError(f"the residual {tuple(d.shape)} {d.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"add_layernorm runs on CUDA or CPU tensors, got {x.device}")
    return _AddLayerNorm.apply(x, d, weight, float(eps))
