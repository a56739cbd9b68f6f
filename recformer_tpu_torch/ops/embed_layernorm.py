"""Fused four-way embedding sum + LayerNorm: the hand-written CUDA kernels.

Counterpart of ``recformer_tpu/ops/pallas_embed.py``, selected by
``config.embed_ln_impl = 'pallas'``. ``csrc/embed_layernorm.cu`` replaces
``_fwd_kernel`` (forward) and ``_bwd_kernel`` (backward):

- forward: the four ``(M, H)`` addends (word, token-position, token-type and
  item-position rows) widened to float32 and summed in the order
  ``a + b + c + d``, then LayerNorm with the two-pass variance (means as
  ``jnp.mean`` takes them, sums divided by H), ``x_hat * gamma + beta``,
  written in the addends' type. The sum is never materialised.
- backward: recomputes ``x_hat`` from the addends and writes the one dx that
  all four addends share, in their type, and float32 dgamma/dbeta. As in
  ``_fused_bwd``, dgamma/dbeta return in gamma's type. dout is read in its
  own type and widened in registers (JAX casts it to float32 first, which
  gives the same values). The TPU kernel sums dgamma/dbeta across its
  sequential grid; here the kernel sums them inside the same launch in an
  order fixed by the grid alone (bitwise the same from run to run, one
  device kernel a call), the code ``csrc/row_reduce.cuh`` shares with the
  LayerNorm backward.

Like the JAX VJP, the autograd function saves the four addends (and gamma);
they are freed with the graph. Unlike the TPU wrapper, any number of rows
works: no row count has to divide a block.

On CPU tensors the plain versions run (:func:`embed_layernorm_plain`,
:func:`embed_layernorm_bwd_plain`); on CUDA tensors the kernels launch or
raise. What bounds them on the H100: a few flops per element against 10
(forward) and 12 (backward) bytes per element in bf16, so HBM bytes; one
warp per row keeps the row in registers, so every input is read once, and
the backward's warps keep their next row in flight while they reduce the
current one.
``PERF.md`` has their times beside the bound.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import DTYPE_CODES, aligned, ptr
from .layernorm import SUPPORTED_WIDTHS

# Launches of the forward and backward kernels since the last reset.
LAUNCHES = 0
BWD_LAUNCHES = 0


def _sum4(a, b, c, d):
    return a.float() + b.float() + c.float() + d.float()


def embed_layernorm_plain(a, b, c, d, gamma, beta, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel over ``(M, H)`` addends:
    the float32 sum, the two-pass LayerNorm, output in the addends' type."""
    x = _sum4(a, b, c, d)
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    xhat = xc * torch.rsqrt(var + eps)
    return (xhat * gamma.float() + beta.float()).to(a.dtype)


def embed_layernorm_bwd_plain(a, b, c, d, gamma, dout, eps: float):
    """Plain PyTorch version of the backward kernel. Returns the shared dx
    in the addends' type and float32 (dgamma, dbeta)."""
    x = _sum4(a, b, c, d)
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    g = dout.float()
    gg = g * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dx = inv * (gg - m1 - xhat * m2)
    return dx.to(a.dtype), (g * xhat).sum(0), g.sum(0)


def _check(addends, gamma, other, name):
    a = addends[0]
    if a.dim() != 2:
        raise ValueError(f"embed_layernorm takes (M, H) rows, got {tuple(a.shape)}")
    if a.dtype not in DTYPE_CODES:
        raise TypeError(f"embed_layernorm takes float32 or bfloat16, got {a.dtype}")
    if a.shape[1] not in SUPPORTED_WIDTHS:
        raise ValueError(f"embed_layernorm takes H in {SUPPORTED_WIDTHS}, got {a.shape[1]}")
    if a.shape[0] == 0:
        raise ValueError("embed_layernorm needs at least one row")
    for t in (*addends, other):
        if t.shape != a.shape or t.dtype != a.dtype:
            raise ValueError(f"the addends and {name} must share one shape and type")
    if gamma.shape != a.shape[1:]:
        raise ValueError(f"gamma {tuple(gamma.shape)} must be ({a.shape[1]},)")
    if any(t.device != a.device for t in (*addends, other, gamma)):
        raise ValueError("embed_layernorm inputs must share one CUDA device")


def _launch(a, b, c, d, gamma, beta, eps):
    global LAUNCHES
    from ._build import load_library

    _check((a, b, c, d), gamma, a, "out")
    if beta.shape != gamma.shape or beta.device != a.device:
        raise ValueError("beta must match gamma")
    M, H = a.shape
    a, b, c, d = (aligned(t) for t in (a, b, c, d))
    gamma, beta = aligned(gamma.float()), aligned(beta.float())
    out = torch.empty_like(a)
    lib = load_library("embed_layernorm")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.embed_layernorm_fwd(DTYPE_CODES[a.dtype], ptr(a), ptr(b), ptr(c), ptr(d),
                                      ptr(gamma), ptr(beta), ptr(out), M, H,
                                      ctypes.c_float(eps), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"embed_layernorm_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _launch_bwd(a, b, c, d, gamma, dout, eps):
    global BWD_LAUNCHES
    from ._build import load_library

    _check((a, b, c, d), gamma, dout, "dout")
    M, H = a.shape
    a, b, c, d, dout = (aligned(t) for t in (a, b, c, d, dout))
    gamma = aligned(gamma.float())
    lib = load_library("embed_layernorm")
    f32 = dict(dtype=torch.float32, device=a.device)
    dx = torch.empty_like(a)
    dgb = torch.empty((2, H), **f32)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rows = lib.embed_layernorm_bwd_partial_rows(DTYPE_CODES[a.dtype], H)
        if rows <= 0:
            raise RuntimeError(f"embed_layernorm_bwd cannot be sized: CUDA error {-rows}")
        partial = torch.empty((rows, 2 * H), **f32)
        err = lib.embed_layernorm_bwd(DTYPE_CODES[a.dtype], ptr(a), ptr(b), ptr(c), ptr(d),
                                      ptr(gamma), ptr(dout), ptr(dx), ptr(partial), ptr(dgb),
                                      M, H, ctypes.c_float(eps), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"embed_layernorm_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dx, dgb[0], dgb[1]


def embed_layernorm_fwd(a, b, c, d, gamma, beta, eps: float) -> torch.Tensor:
    """The forward kernel's wrapper over ``(M, H)`` addends. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if a.is_cuda:
        return _launch(a, b, c, d, gamma, beta, eps)
    if a.device.type != "cpu":
        raise ValueError(f"embed_layernorm runs on CUDA or CPU tensors, got {a.device}")
    return embed_layernorm_plain(a, b, c, d, gamma, beta, eps)


def embed_layernorm_bwd(a, b, c, d, gamma, dout, eps: float):
    """The backward kernel's wrapper: dout of the addends' shape and type.
    Returns the shared dx and float32 (dgamma, dbeta). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if a.is_cuda:
        return _launch_bwd(a, b, c, d, gamma, dout, eps)
    if a.device.type != "cpu":
        raise ValueError(f"embed_layernorm runs on CUDA or CPU tensors, got {a.device}")
    return embed_layernorm_bwd_plain(a, b, c, d, gamma, dout, eps)


class _EmbedLayerNorm(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient
    (``_fused_core`` with ``_fused_fwd`` / ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, a, b, c, d, gamma, beta, eps):
        ctx.save_for_backward(a, b, c, d, gamma)
        ctx.eps = eps
        return embed_layernorm_fwd(a, b, c, d, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dout):
        a, b, c, d, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = embed_layernorm_bwd(a, b, c, d, gamma, dout.to(a.dtype), ctx.eps)
        return dx, dx, dx, dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def fused_embed_layernorm(word: torch.Tensor, pos: torch.Tensor, typ: torch.Tensor,
                          item: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``word + pos + typ + item`` over ``(B, L, H)`` addends of
    one type, through the kernels; output in the addends' type."""
    B, L, H = word.shape
    flat = [t.reshape(B * L, H) for t in (word, pos, typ, item)]
    return _EmbedLayerNorm.apply(*flat, gamma, beta, float(eps)).view(B, L, H)
