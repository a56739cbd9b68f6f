"""Block LayerNorm with a hand-written CUDA backward, and its split twin.

Counterpart of ``recformer_tpu/ops/pallas_layernorm.py``, selected by
``config.ln_impl``:

- ``'pallas_bwd'``: :func:`fused_bwd_layernorm` (the JAX package's
  ``pallas_layernorm``). The forward is plain PyTorch,
  :func:`ln_forward_math` (``_ln_forward_math``: float32 statistics with the
  two-pass variance, output in the input's type). The backward is
  ``csrc/layernorm_bwd.cu``, which replaces ``_ln_bwd_kernel``: dx, dgamma
  and dbeta in one launch over the rows with the statistics recomputed. As
  in ``_pln_bwd``, gamma and dout are rounded to the input's type first (the
  kernel rounds the float32 parameter itself, so the wrapper casts
  nothing), dx is returned in that type and dgamma/dbeta, accumulated in
  float32, in gamma's. The TPU kernel sums dgamma/dbeta across its
  sequential grid; on the card blocks run in any order, so the kernel sums
  them inside the same launch in an order fixed by the grid alone (a
  block's warps, then the blocks' rows of partials after a grid barrier):
  bitwise the same from run to run, and one call is one device kernel.
- ``'split_bwd'``: :func:`split_layernorm`, plain PyTorch with
  ``_sln_bwd``'s formula (gamma kept in float32, :func:`ln_backward_math`).
  It has no kernel: the JAX version has none.

On CPU tensors the backward takes :func:`layernorm_bwd_plain`; on CUDA
tensors it launches the kernel or raises. What bounds the kernel on the
H100: a few flops per element against 6 bytes per element in bf16, so HBM
bytes; a persistent grid whose warps keep their next row in flight while
they reduce the current one. ``PERF.md`` has its time beside the bound.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.profiling import count, spanned
from ._build import DTYPE_CODES, aligned, ptr

# Row widths the kernel is built for (``ROWLN_WIDTHS`` in csrc/row_reduce.cuh).
SUPPORTED_WIDTHS = (64, 128, 256, 384, 512, 768, 1024)


def ln_forward_math(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: float32 mean, centred values, mean of
    their squares, ``rsqrt(var + eps)``, ``x_hat * weight + bias`` (no bias
    term where ``bias`` is None); output in ``x``'s type."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float()
    return (y if bias is None else y + bias.float()).to(x.dtype)


def ln_backward_math(x: torch.Tensor, weight: torch.Tensor, dout: torch.Tensor, eps: float):
    """``_sln_bwd``'s gradient of :func:`ln_forward_math` over the last axis,
    gamma kept in float32 and the statistics recomputed: dx in ``x``'s type
    and the float32 dgamma summed over every row (dbeta is ``dout``'s sum)."""
    x32 = x.float()
    dy = dout.float()
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dyg = dy * weight.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dyg - m1 - xhat * m2)).to(x.dtype)
    return dx, (dy * xhat).sum(tuple(range(x.dim() - 1)))


def layernorm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, dout: torch.Tensor, eps: float):
    """Plain PyTorch version of the backward kernel over ``(M, H)`` rows, in
    its rounding order (sums scaled by ``1/H``), gamma rounded to ``x``'s
    type first as the kernel rounds it. Returns dx in ``x``'s type and
    float32 (dgamma, dbeta)."""
    gamma = gamma.to(x.dtype)
    x32 = x.float()
    dy = dout.float()
    inv_h = 1.0 / x.shape[-1]
    mu = x32.sum(-1, keepdim=True) * inv_h
    xc = x32 - mu
    var = (xc * xc).sum(-1, keepdim=True) * inv_h
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dyg = dy * gamma.float()
    m1 = dyg.sum(-1, keepdim=True) * inv_h
    m2 = (dyg * xhat).sum(-1, keepdim=True) * inv_h
    dx = rstd * (dyg - m1 - xhat * m2)
    return dx.to(x.dtype), (dy * xhat).sum(0), dy.sum(0)


def _check(x, gamma, dout):
    if x.dim() != 2:
        raise ValueError(f"layernorm_bwd takes (M, H) rows, got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"layernorm_bwd takes float32 or bfloat16, got {x.dtype}")
    if x.shape[1] not in SUPPORTED_WIDTHS:
        raise ValueError(f"layernorm_bwd takes H in {SUPPORTED_WIDTHS}, got {x.shape[1]}")
    if x.shape[0] == 0:
        raise ValueError("layernorm_bwd needs at least one row")
    if dout.shape != x.shape or dout.dtype != x.dtype or gamma.shape != x.shape[1:]:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} and gamma "
                         f"{tuple(gamma.shape)} must match x {tuple(x.shape)} {x.dtype}")
    if gamma.dtype != torch.float32:
        raise TypeError(f"layernorm_bwd takes the float32 parameter gamma, got {gamma.dtype}")
    if dout.device != x.device or gamma.device != x.device:
        raise ValueError("layernorm_bwd inputs must share one CUDA device")


@spanned("launch.kernel5")
def _launch_bwd(x, gamma, dout, eps):
    from ._build import load_library

    _check(x, gamma, dout)
    M, H = x.shape
    x, dout, gamma = aligned(x), aligned(dout), aligned(gamma)
    lib = load_library("layernorm_bwd")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, H), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rows = lib.layernorm_bwd_partial_rows(DTYPE_CODES[x.dtype], H)
        if rows <= 0:
            raise RuntimeError(f"layernorm_bwd cannot be sized: CUDA error {-rows}")
        partial = torch.empty((rows, 2 * H), **f32)
        err = lib.layernorm_bwd(DTYPE_CODES[x.dtype], ptr(x), ptr(gamma), ptr(dout), ptr(dx),
                                ptr(partial), ptr(dgb), M, H, ctypes.c_float(eps),
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"layernorm_bwd launch failed: CUDA error {err}")
    count("kernel5.launches")
    return dx, dgb[0], dgb[1]


def layernorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dout: torch.Tensor, eps: float):
    """The backward kernel's wrapper over ``(M, H)`` rows: x and dout of one
    type, gamma the float32 parameter (rounded to x's type inside). Returns
    dx in ``x``'s type and float32 (dgamma, dbeta). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if x.is_cuda:
        return _launch_bwd(x, gamma, dout, eps)
    if x.device.type != "cpu":
        raise ValueError(f"layernorm_bwd runs on CUDA or CPU tensors, got {x.device}")
    return layernorm_bwd_plain(x, gamma, dout, eps)


class _FusedBwdLayerNorm(torch.autograd.Function):
    """Plain forward, the backward kernel as its gradient (``_pln_fwd`` /
    ``_pln_bwd``); saves x and gamma."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return ln_forward_math(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        H = x.shape[-1]
        dx, dgamma, dbeta = layernorm_bwd(x.reshape(-1, H), weight.float(),
                                          dout.reshape(-1, H).to(x.dtype), ctx.eps)
        return dx.view(x.shape), dgamma.to(weight.dtype), dbeta.to(weight.dtype), None


def fused_bwd_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with the plain forward and the backward
    kernel (the JAX package's ``pallas_layernorm``)."""
    return _FusedBwdLayerNorm.apply(x, weight, bias, float(eps))


class _SplitLayerNorm(torch.autograd.Function):
    """Plain forward and ``_sln_bwd``'s backward (gamma in float32)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return ln_forward_math(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        dx, dgamma = ln_backward_math(x, weight, dout, ctx.eps)
        dbeta = dout.float().sum(tuple(range(x.dim() - 1)))
        return dx, dgamma.to(weight.dtype), dbeta.to(weight.dtype), None


def split_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm with the split plain backward (``ln_impl='split_bwd'``)."""
    return _SplitLayerNorm.apply(x, weight, bias, float(eps))
