"""Fused windowed + global attention forward: the hand-written CUDA kernel.

Replaces ``recformer_tpu/ops/pallas_attention.py::_fwd_kernel`` (reached
through ``_band_core_fwd_call`` from ``pallas_window_attention``). Each local
query takes one float32 softmax over its +-window/2 band of *local* keys and
G global key columns; the global columns are the local k/v rows at the
global positions. The un-normalised exponentials are cast to the input type,
multiplied by V and only then divided by the row sum. With G == 1 and a
compact global-row output, the epilogue is fused: mask==2 rows take
``g_out`` and padding rows are zeroed.

What bounds it on the H100: the useful work is about ``4*D*(W+1)`` flops per
query row and head against ``8*D`` bytes of q/k/v/out traffic per row and
head in bf16, some 33 flops per byte at W=64, far below the card's ~295
flops per byte in bf16, so the bound is HBM bytes. The design keeps HBM
traffic near one read of q/k/v and one write of out: a thread block owns a
tile of query rows of one (batch, head) and stages the tile's K/V band,
``[t0 - W/2, t1 + W/2)``, in shared memory once; every query row of the tile
reads its keys from there, and the scores never leave the chip.

The library holds two kernels of that design and picks one from what it
sees of the inputs. For bf16 at ``D == W == 64`` (the Recformer-base shapes)
a block of four warps takes 64 query rows; each warp computes the scores of
its 16 rows against the 80 band keys they can see plus one 8-wide tile of
global keys on the tensor cores (``mma.sync`` m16n8k16, fp32 accumulate),
masks and softmaxes them in registers, and feeds the exponentials, rounded
to bf16, straight back as the A operand of ``P.V``. Every other shape, and
float32, takes a CUDA-core kernel in which a warp owns one query row at a
time: lanes split the band's key columns for the scores (K rows padded to
``D + 1`` words so lanes hit different banks), reduce max and sum with
shuffles, then split the head dimension for ``e.V``. ``wgmma``, TMA and
pipelined loads are later work; ``PERF.md`` has the measured times beside
the bound.

``window_attention`` keeps the arguments and the pre-processing of
``pallas_window_attention``. On CPU tensors the band core runs its plain
version, ``window_attention_plain``; on CUDA tensors it launches the kernel
or raises. Dropout is training work: ``dropout_rate > 0`` raises.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import _batch_index, _global_rows, attention_scale, global_prefix_indices

# Launches of the CUDA kernel since the last reset (one per ``band_attention``
# call on CUDA tensors).
LAUNCHES = 0

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_plain(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout,
                           num_heads: int, window: int, fuse_epilogue: bool):
    """Plain PyTorch version of the kernel, in the kernel's rounding order.

    q2/k2/v2: (B, L, H*D); keyloc/mrow: (B, L) int32; gk/gv/gout: (B, G, H*D);
    gvalid: (B, G) int32. ``q * scale`` rounds to the input type, the scores
    and the softmax are float32, the exponentials round to the input type
    before the product with V, and the division by the row sum comes last.
    """
    B, L, HD = q2.shape
    H = num_heads
    D = HD // H
    G = gk.shape[1]
    dt = q2.dtype
    half = window // 2
    scale = torch.tensor(1.0 / D ** 0.5, dtype=dt, device=q2.device)
    q = (q2.view(B, L, H, D) * scale).float()
    # zero-pad K/V (and keyloc with 0) by half a window so key i+o exists for
    # every offset o in [-half, half]
    kp = torch.nn.functional.pad(k2.view(B, L, H, D).float(), (0, 0, 0, 0, half, half))
    vp = torch.nn.functional.pad(v2.view(B, L, H, D).float(), (0, 0, 0, 0, half, half))
    klp = torch.nn.functional.pad(keyloc, (half, half))
    band = torch.stack([(q * kp[:, o:o + L]).sum(-1) for o in range(window + 1)],
                       dim=-1)  # (B, L, H, W+1)
    band = torch.where((klp.unfold(1, window + 1, 1) != 0)[:, :, None, :], band, -1e30)
    glob = torch.einsum("blhd,bghd->blhg", q, gk.view(B, G, H, D).float())
    glob = torch.where((gvalid != 0)[:, None, None, :], glob, -1e30)
    scores = torch.cat([band, glob], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # (B, L, H, 1)
    e = e.to(dt).float()
    out = torch.zeros_like(q)
    for o in range(window + 1):
        out += e[..., o:o + 1] * vp[:, o:o + L]
    out += torch.einsum("blhg,bghd->blhd", e[..., window + 1:], gv.view(B, G, H, D).float())
    out = out / denom
    if fuse_epilogue:
        g_row = gout[:, :1].view(B, 1, H, D).float()
        mr = mrow[:, :, None, None]
        out = torch.where(mr == 2, g_row, torch.where(mr == 1, out, 0.0))
    return out.to(dt).view(B, L, HD)


def _launch(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads, window,
            fuse_epilogue):
    global LAUNCHES
    from ._build import load_library

    B, L, HD = q2.shape
    H = num_heads
    D = HD // H
    G = gk.shape[1]
    dt = q2.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"band attention kernel takes float32 or bfloat16, got {dt}")
    if D not in SUPPORTED_HEAD_DIMS or HD != H * D:
        raise ValueError(f"band attention kernel takes head_dim in {SUPPORTED_HEAD_DIMS}, got {HD}/{H}")
    tensors = (q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout)
    if any(t.device != q2.device for t in tensors):
        raise ValueError("band attention inputs must share one CUDA device")
    if any(t.dtype != dt for t in (k2, v2, gk, gv, gout)):
        raise TypeError("q/k/v/gk/gv/gout must share one dtype")
    q2, k2, v2, gk, gv, gout = (t.contiguous() for t in (q2, k2, v2, gk, gv, gout))
    keyloc, gvalid, mrow = (t.to(torch.int32).contiguous() for t in (keyloc, gvalid, mrow))
    out = torch.empty_like(q2)
    scale = float(torch.tensor(1.0 / D ** 0.5, dtype=dt))
    lib = load_library("band_attention_fwd")
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(q2.device):
        err = lib.band_attention_fwd(
            _DTYPE_CODES[dt], ptr(q2), ptr(k2), ptr(v2), ptr(keyloc), ptr(gk),
            ptr(gv), ptr(gvalid), ptr(mrow), ptr(gout), ptr(out),
            B, L, H, D, G, window, ctypes.c_float(scale),
            int(bool(fuse_epilogue)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"band_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def band_attention(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads: int,
                   window: int, fuse_epilogue: bool):
    """The kernel's wrapper over ``(B, L, H*D)`` operands (arguments as in
    :func:`window_attention_plain`). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if q2.is_cuda:
        return _launch(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads,
                       window, fuse_epilogue)
    if q2.device.type != "cpu":
        raise ValueError(f"band attention runs on CUDA or CPU tensors, got {q2.device}")
    return window_attention_plain(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout,
                                  num_heads, window, fuse_epilogue)


def prepare_band_inputs(q, k, v, mask, max_globals: int = 1):
    """The wrapper's pre-processing: demote extra mask==2 rows to local and
    build the kernel's operands. Returns (mask, dict of operands)."""
    B, L, H, D = q.shape
    # at most ``max_globals`` global rows per sequence (the data pipeline
    # emits one, the <s> row): extra mask==2 rows are demoted to local
    gidx0, gvalid0 = global_prefix_indices(mask, max_globals)
    kept = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    kept[_batch_index(gidx0), gidx0] = gvalid0
    mask = torch.where((mask == 2) & ~kept, torch.ones_like(mask), mask)

    HD = H * D
    k2 = k.reshape(B, L, HD)
    v2 = v.reshape(B, L, HD)
    gidx, gvalid = global_prefix_indices(mask, max_globals)
    bidx = _batch_index(gidx)
    ops = dict(
        q2=q.reshape(B, L, HD), k2=k2, v2=v2,
        keyloc=(mask == 1).to(torch.int32),
        gk=k2[bidx, gidx], gv=v2[bidx, gidx],
        gvalid=gvalid.to(torch.int32),
        mrow=mask.to(torch.int32),
    )
    return mask, ops


def window_attention(q, k, v, q_g, k_g, v_g, mask, window: int, max_globals: int = 1,
                     dropout_rate: float = 0.0, g_out=None):
    """Same contract as :func:`attention.dense_attention`, through the fused
    kernel. ``g_out`` may be the compact ``(B, G, H, D)`` global-row output
    (taken by the fused epilogue when G == 1) or the scattered
    ``(B, L, H, D)`` form; when None the global rows come from
    ``q_g``/``k_g``/``v_g``. The kernel picks its own query tile, so the
    JAX wrapper's ``block_q`` (and ``interpret``) have no counterpart."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout arrives with the training slice")
    B, L, H, D = q.shape
    dt = q.dtype
    scale = attention_scale(D, dt, q.device)
    mask, ops = prepare_band_inputs(q, k, v, mask, max_globals)

    compact_gout = g_out is not None and g_out.shape[1] == max_globals != L
    if max_globals == 1 and (g_out is None or compact_gout):
        if g_out is None:
            g_out = _global_rows(q_g, k_g, v_g, mask, scale, dt, max_globals,
                                 compact=True)
        gout2 = g_out.reshape(B, max_globals, H * D).to(dt)
        out2 = band_attention(**ops, gout=gout2, num_heads=H, window=window,
                              fuse_epilogue=True)
        return out2.view(B, L, H, D)

    placeholder = torch.zeros((B, max_globals, H * D), dtype=dt, device=q.device)
    out2 = band_attention(**ops, gout=placeholder, num_heads=H, window=window,
                          fuse_epilogue=False)
    out = out2.view(B, L, H, D)
    if g_out is None:
        g_out = _global_rows(q_g, k_g, v_g, mask, scale, dt, max_globals)
    out = torch.where((mask == 2)[:, :, None, None], g_out, out)
    return torch.where((mask == 0)[:, :, None, None], 0.0, out).to(dt)
