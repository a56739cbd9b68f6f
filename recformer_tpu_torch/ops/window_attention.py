"""Fused windowed + global attention: the hand-written CUDA kernels.

Forward: ``csrc/band_attention_fwd.cu`` replaces
``recformer_tpu/ops/pallas_attention.py::_fwd_kernel`` (reached through
``_band_core_fwd_call`` from ``pallas_window_attention``). Each local query
takes one float32 softmax over its +-window/2 band of *local* keys and G
global key columns; the global columns are the local k/v rows at the global
positions. The un-normalised exponentials take dropout (kept ones scaled by
``1/(1-rate)``), are cast to the input type, multiplied by V and only then
divided by the undropped row sum. With G == 1 and a compact global-row
output, the epilogue is fused: mask==2 rows take ``g_out`` and padding rows
are zeroed.

Backward: ``csrc/band_attention_bwd.cu`` replaces ``_bwd_kernel`` (reached
through ``_band_core_bwd_call`` under the ``_band_core`` custom VJP). It
recomputes the band softmax and regenerates the dropout mask, and returns
dq, dk, dv and the float32 dgk, dgv, dgout. The TPU kernel carries dK/dV and
dgK/dgV across its sequential grid; on the card the blocks run in parallel,
so a query pass writes dq, the row statistics and per-tile partials of the
global-row gradients, a key pass owns each key tile and writes dk/dv once,
and a reduction sums the partials (deterministic, no atomics).

What bounds them on the H100: the useful work is about ``4*D`` (forward)
and ``10*D`` (backward) flops per (query, key) pair and head against
``8*D`` (forward) and ``14*D`` (backward) bytes of q/k/v/out traffic per
row and head in bf16, far below the card's ~295 flops per byte in bf16, so
the bound is HBM bytes. A thread block owns a tile of rows of one (batch,
head) and stages the tile's K/V band in shared memory once; scores never
leave the chip. The forward has two kernels and picks one from the inputs:
for bf16 at ``D == W == 64`` (the Recformer-base shapes) a block of four
warps takes 64 query rows on the tensor cores (``mma.sync`` m16n8k16, fp32
accumulate) and feeds the exponentials, rounded to bf16, straight back as
the A operand of ``P.V``; every other shape, and float32, takes a CUDA-core
kernel in which a warp owns one query row at a time. The backward is
CUDA-core only for now. ``PERF.md`` has the measured times beside the bound.

Dropout is one exact function of absolute coordinates,
``keep(seed, b, h, i, c) = philox4x32_10((c >> 2, i, h, b), (seed, 0))[c & 3]
>= floor(rate * 2**32)`` with c the key position j or ``L + g`` for global
column g. :func:`dropout_keep` computes it in plain torch and
``csrc/band_common.cuh`` on the card, so both kernels and both plain versions
draw the same mask bit for bit. It cannot reproduce the TPU's hardware bits:
parity with the JAX package under dropout is statistical.

``window_attention`` keeps the arguments and the pre-processing of
``pallas_window_attention``. On CPU tensors the band core runs its plain
versions (:func:`window_attention_plain` forward,
:func:`window_attention_bwd_plain` backward) through the same autograd
function; on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import DTYPE_CODES as _DTYPE_CODES
from ._build import ptr as _ptr
from .attention import _batch_index, _global_rows, attention_scale, global_prefix_indices

# Launches of the CUDA kernels since the last reset: one per forward and one
# per backward ``band_attention`` call on CUDA tensors.
LAUNCHES = 0
BWD_LAUNCHES = 0

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the dropout keep mask
# ---------------------------------------------------------------------------

def _mulhilo(a: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``a * x`` for a constant ``a`` and int64
    ``x`` in [0, 2**32): the product is split into 16-bit halves of ``a``
    so that no int64 intermediate overflows."""
    p0 = x * (a & 0xFFFF)  # < 2**48
    p1 = x * (a >> 16)     # < 2**48
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & _MASK32
    hi = ((p0 >> 16) + p1) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 words (broadcasting);
    returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    return min(int(rate * 2.0 ** 32), _MASK32)


def dropout_keep(seed: int, rate: float, b, h, i, c) -> torch.Tensor:
    """The attention-dropout keep mask, broadcast over int64 index tensors
    ``b`` (batch), ``h`` (head), ``i`` (query row) and ``c`` (column: key
    position j, or ``L + g`` for global column g; non-negative)."""
    c = c.to(torch.int64)
    words = philox4x32_10(c >> 2, i.to(torch.int64), h.to(torch.int64), b.to(torch.int64),
                          int(seed) & _MASK32, 0)
    sel = c & 3
    bits = torch.where(sel == 0, words[0], torch.where(
        sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))
    return bits >= dropout_threshold(rate)


def _keep_mask(seed, rate, B, L, H, window, G, device):
    """(B, L, H, window + 1 + G) keep mask of the band and global columns;
    band column o of row i is key ``i - window/2 + o`` (clamped at 0: a
    column off [0, L) carries no key, so its bit is never used)."""
    half = window // 2
    i = torch.arange(L, device=device)[:, None]
    band = (i - half + torch.arange(window + 1, device=device)[None, :]).clamp_min(0)
    glob = (L + torch.arange(G, device=device))[None, :].expand(L, G)
    cols = torch.cat([band, glob], dim=1)  # (L, ncol)
    return dropout_keep(seed, rate, torch.arange(B, device=device)[:, None, None, None],
                        torch.arange(H, device=device)[None, None, :, None],
                        i[None, :, :, None], cols[None, :, None, :])


def _drop_scale(rate: float) -> float:
    """``1/(1-rate)`` as float32, the value both kernels multiply by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _band_scores(q, kp, klp, gk, gvalid, window):
    """float32 (B, L, H, W+1+G) scores of the scaled queries ``q`` against
    the zero-padded band keys ``kp`` and the global keys, masked with -1e30."""
    B, L, H, D = q.shape
    G = gk.shape[1]
    band = torch.stack([(q * kp[:, o:o + L]).sum(-1) for o in range(window + 1)], dim=-1)
    band = torch.where((klp.unfold(1, window + 1, 1) != 0)[:, :, None, :], band, -1e30)
    glob = torch.einsum("blhd,bghd->blhg", q, gk.view(B, G, H, D).float())
    glob = torch.where((gvalid != 0)[:, None, None, :], glob, -1e30)
    return torch.cat([band, glob], dim=-1)


def _pad_band(x, half):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, half, half))


def window_attention_plain(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout,
                           num_heads: int, window: int, fuse_epilogue: bool,
                           dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the forward kernel, in its rounding order.

    q2/k2/v2: (B, L, H*D); keyloc/mrow: (B, L) int32; gk/gv/gout: (B, G, H*D);
    gvalid: (B, G) int32. ``q * scale`` rounds to the input type, the scores
    and the softmax are float32, the exponentials take dropout and round to
    the input type before the product with V, and the division by the
    undropped row sum comes last.
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
    kp = _pad_band(k2.view(B, L, H, D).float(), half)
    vp = _pad_band(v2.view(B, L, H, D).float(), half)
    klp = torch.nn.functional.pad(keyloc, (half, half))
    scores = _band_scores(q, kp, klp, gk, gvalid, window)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # (B, L, H, 1)
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, dropout_rate, B, L, H, window, G, q2.device)
        e = torch.where(keep, e * _drop_scale(dropout_rate), 0.0)
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


def window_attention_bwd_plain(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, dout,
                               num_heads: int, window: int, fuse_epilogue: bool,
                               dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the backward kernel, in its rounding order.
    Arguments as in :func:`window_attention_plain` plus ``dout`` (B, L, H*D).
    Returns (dq, dk, dv) in the input type and float32 (dgk, dgv, dgout) of
    shape (B, G, H*D).

    The scores are recomputed in float32 from ``q * scale`` rounded to the
    input type; ``p`` is the softmax of the undropped exponentials; with the
    keep mask ``m = keep / (1 - rate)``, ``dp = m * (dout . V)`` and
    ``ds = p * (dp - sum(p * dp))``; ds rounds to the input type before dq
    and dk, ``m * p`` before dv; dq is scaled after its float32 product.
    With the fused epilogue, dgout sums dout over mask == 2 rows and the band
    sees dout only at mask == 1 rows.
    """
    B, L, HD = q2.shape
    H = num_heads
    D = HD // H
    G = gk.shape[1]
    dt = q2.dtype
    half = window // 2
    scale = torch.tensor(1.0 / D ** 0.5, dtype=dt, device=q2.device)
    q = (q2.view(B, L, H, D) * scale).float()
    kp = _pad_band(k2.view(B, L, H, D).float(), half)
    vp = _pad_band(v2.view(B, L, H, D).float(), half)
    klp = torch.nn.functional.pad(keyloc, (half, half))
    do = dout.to(dt).view(B, L, H, D).float()
    if fuse_epilogue:
        mr = mrow[:, :, None, None]
        dgout = torch.zeros((B, G, HD), dtype=torch.float32, device=q2.device)
        dgout[:, 0] = torch.where(mr == 2, do, 0.0).sum(1).reshape(B, HD)
        do = torch.where(mr == 1, do, 0.0)
    else:
        dgout = torch.zeros((B, G, HD), dtype=torch.float32, device=q2.device)

    scores = _band_scores(q, kp, klp, gk, gvalid, window)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    gvf = gv.view(B, G, H, D).float()
    dp = torch.cat([torch.stack([(do * vp[:, o:o + L]).sum(-1) for o in range(window + 1)],
                                dim=-1),
                    torch.einsum("blhd,bghd->blhg", do, gvf)], dim=-1)
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, dropout_rate, B, L, H, window, G, q2.device)
        inv = _drop_scale(dropout_rate)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        p_drop = p
    row_dot = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row_dot)).to(dt).float()
    pd = p_drop.to(dt).float()

    dq = torch.einsum("blhg,bghd->blhd", ds[..., window + 1:], gk.view(B, G, H, D).float())
    dkp = torch.zeros_like(kp)
    dvp = torch.zeros_like(vp)
    for o in range(window + 1):
        dq += ds[..., o:o + 1] * kp[:, o:o + L]
        dkp[:, o:o + L] += ds[..., o:o + 1] * q
        dvp[:, o:o + L] += pd[..., o:o + 1] * do
    dq = (dq * (1.0 / D ** 0.5)).to(dt).reshape(B, L, HD)
    dk = dkp[:, half:half + L].to(dt).reshape(B, L, HD)
    dv = dvp[:, half:half + L].to(dt).reshape(B, L, HD)
    dgk = torch.einsum("blhg,blhd->bghd", ds[..., window + 1:], q).reshape(B, G, HD)
    dgv = torch.einsum("blhg,blhd->bghd", pd[..., window + 1:], do).reshape(B, G, HD)
    return dq, dk, dv, dgk, dgv, dgout


# ---------------------------------------------------------------------------
# the kernels' launchers
# ---------------------------------------------------------------------------

def _check(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads):
    B, L, HD = q2.shape
    H = num_heads
    D = HD // H
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
    return ([t.contiguous() for t in (q2, k2, v2, gk, gv, gout)],
            [t.to(torch.int32).contiguous() for t in (keyloc, gvalid, mrow)])


def _dropout_args(rate: float, seed: int):
    if rate <= 0.0:
        return [0, 0, 0, ctypes.c_float(1.0)]
    return [1, int(seed) & _MASK32, dropout_threshold(rate), ctypes.c_float(_drop_scale(rate))]


def _launch(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads, window,
            fuse_epilogue, dropout_rate=0.0, seed=0):
    global LAUNCHES
    from ._build import load_library

    (q2, k2, v2, gk, gv, gout), (keyloc, gvalid, mrow) = _check(
        q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads)
    B, L, HD = q2.shape
    H = num_heads
    D = HD // H
    G = gk.shape[1]
    dt = q2.dtype
    out = torch.empty_like(q2)
    scale = float(torch.tensor(1.0 / D ** 0.5, dtype=dt))
    lib = load_library("band_attention_fwd")
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    with torch.cuda.device(q2.device):
        err = lib.band_attention_fwd(
            _DTYPE_CODES[dt], _ptr(q2), _ptr(k2), _ptr(v2), _ptr(keyloc), _ptr(gk),
            _ptr(gv), _ptr(gvalid), _ptr(mrow), _ptr(gout), _ptr(out),
            B, L, H, D, G, window, ctypes.c_float(scale), int(bool(fuse_epilogue)),
            *_dropout_args(dropout_rate, seed), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"band_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def bwd_query_tile(head_dim: int, num_globals: int, window: int) -> int:
    """Query-tile height of the backward kernel's query pass (its tile
    partials of dgk/dgv/dgout are summed over ``ceil(L / tile)`` tiles)."""
    from ._build import load_library

    tile = load_library("band_attention_bwd").band_attention_bwd_tile(
        head_dim, num_globals, window)
    if tile <= 0:
        raise ValueError(f"band attention backward: D={head_dim}, G={num_globals}, "
                         f"window={window} do not fit in shared memory")
    return tile


def _launch_bwd(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, dout, num_heads, window,
                fuse_epilogue, dropout_rate=0.0, seed=0):
    global BWD_LAUNCHES
    from ._build import load_library

    (q2, k2, v2, gk, gv, gout), (keyloc, gvalid, mrow) = _check(
        q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads)
    if dout.shape != q2.shape or dout.device != q2.device:
        raise ValueError(f"dout must match q: {tuple(dout.shape)} vs {tuple(q2.shape)}")
    B, L, HD = q2.shape
    H = num_heads
    D = HD // H
    G = gk.shape[1]
    dt = q2.dtype
    dout = dout.to(dt).contiguous()
    lib = load_library("band_attention_bwd")
    n_tiles = -(-L // bwd_query_tile(D, G, window))
    dq, dk, dv = (torch.empty_like(q2) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q2.device)
    dg = torch.empty((3, B, G, HD), **f32)
    stats = torch.empty((B, H, L, 3), **f32)
    ws = torch.empty((3, B, H, n_tiles, G, D), **f32)
    q_scale = float(torch.tensor(1.0 / D ** 0.5, dtype=dt))
    dq_scale = float(torch.tensor(1.0 / D ** 0.5, dtype=torch.float32))
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    with torch.cuda.device(q2.device):
        err = lib.band_attention_bwd(
            _DTYPE_CODES[dt], _ptr(q2), _ptr(k2), _ptr(v2), _ptr(keyloc), _ptr(gk),
            _ptr(gv), _ptr(gvalid), _ptr(mrow), _ptr(dout), _ptr(dq), _ptr(dk), _ptr(dv),
            _ptr(dg), _ptr(stats), _ptr(ws), B, L, H, D, G, window,
            ctypes.c_float(q_scale), ctypes.c_float(dq_scale), int(bool(fuse_epilogue)),
            *_dropout_args(dropout_rate, seed), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"band_attention_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return dq, dk, dv, dg[0], dg[1], dg[2]


def band_attention_bwd(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, dout,
                       num_heads: int, window: int, fuse_epilogue: bool,
                       dropout_rate: float = 0.0, seed: int = 0):
    """The backward kernel's wrapper (arguments as in
    :func:`window_attention_bwd_plain`). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    args = (q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, dout, num_heads, window,
            fuse_epilogue, dropout_rate, seed)
    if q2.is_cuda:
        return _launch_bwd(*args)
    if q2.device.type != "cpu":
        raise ValueError(f"band attention runs on CUDA or CPU tensors, got {q2.device}")
    return window_attention_bwd_plain(*args)


class _BandCore(torch.autograd.Function):
    """The band core with the backward kernel as its gradient. Like the JAX
    VJP, it saves its inputs and the seed, not the probabilities."""

    @staticmethod
    def forward(ctx, q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads, window,
                fuse_epilogue, dropout_rate, seed):
        args = (q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads, window,
                fuse_epilogue, dropout_rate, seed)
        if q2.is_cuda:
            out = _launch(*args)
        elif q2.device.type == "cpu":
            out = window_attention_plain(*args)
        else:
            raise ValueError(f"band attention runs on CUDA or CPU tensors, got {q2.device}")
        ctx.save_for_backward(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout)
        ctx.config = (num_heads, window, fuse_epilogue, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout = ctx.saved_tensors
        dq, dk, dv, dgk, dgv, dgout = band_attention_bwd(
            q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, dout, *ctx.config)
        return (dq, dk, dv, None, dgk.to(gk.dtype), dgv.to(gv.dtype), None, None,
                dgout.to(gout.dtype), None, None, None, None, None)


def band_attention(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads: int,
                   window: int, fuse_epilogue: bool, dropout_rate: float = 0.0,
                   seed: int = 0):
    """The forward kernel's wrapper over ``(B, L, H*D)`` operands (arguments
    as in :func:`window_attention_plain`), differentiable through the
    backward kernel. CPU tensors take the plain versions; CUDA tensors launch
    the kernels or raise."""
    return _BandCore.apply(q2, k2, v2, keyloc, gk, gv, gvalid, mrow, gout, num_heads,
                           window, bool(fuse_epilogue), float(dropout_rate), int(seed))


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


def draw_seed(host_generator: torch.Generator) -> int:
    """One kernel dropout seed from a CPU generator (no device sync)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=host_generator))


def window_attention(q, k, v, q_g, k_g, v_g, mask, window: int, max_globals: int = 1,
                     dropout_rate: float = 0.0, generator=None, host_generator=None,
                     g_out=None):
    """Same contract as :func:`attention.dense_attention`, through the fused
    kernels. ``g_out`` may be the compact ``(B, G, H, D)`` global-row output
    (taken by the fused epilogue when G == 1) or the scattered
    ``(B, L, H, D)`` form; when None the global rows come from
    ``q_g``/``k_g``/``v_g``. The kernel picks its own query tile, so the
    JAX wrapper's ``block_q`` (and ``interpret``) have no counterpart.

    With ``dropout_rate > 0``: the kernels' seed is drawn from
    ``host_generator`` (a CPU ``torch.Generator``), and the global rows, when
    computed here, take their dropout from ``generator`` (on the tensors'
    device), split as the JAX wrapper splits its key into band and global
    parts."""
    B, L, H, D = q.shape
    dt = q.dtype
    scale = attention_scale(D, dt, q.device)
    mask, ops = prepare_band_inputs(q, k, v, mask, max_globals)
    seed = 0
    gen_glb = None
    if dropout_rate > 0.0:
        if host_generator is None:
            raise ValueError("dropout_rate > 0 requires a host_generator")
        seed = draw_seed(host_generator)
        gen_glb = generator
    drop = dict(dropout_rate=dropout_rate, seed=seed)

    compact_gout = g_out is not None and g_out.shape[1] == max_globals != L
    if max_globals == 1 and (g_out is None or compact_gout):
        if g_out is None:
            g_out = _global_rows(q_g, k_g, v_g, mask, scale, dt, max_globals,
                                 dropout_rate, gen_glb, compact=True)
        gout2 = g_out.reshape(B, max_globals, H * D).to(dt)
        out2 = band_attention(**ops, gout=gout2, num_heads=H, window=window,
                              fuse_epilogue=True, **drop)
        return out2.view(B, L, H, D)

    placeholder = torch.zeros((B, max_globals, H * D), dtype=dt, device=q.device)
    out2 = band_attention(**ops, gout=placeholder, num_heads=H, window=window,
                          fuse_epilogue=False, **drop)
    out = out2.view(B, L, H, D)
    if g_out is None:
        g_out = _global_rows(q_g, k_g, v_g, mask, scale, dt, max_globals,
                             dropout_rate, gen_glb)
    # the global and padding rows' gradient never reaches the kernel
    out = torch.where((mask == 2)[:, :, None, None], g_out, out)
    return torch.where((mask == 0)[:, :, None, None], 0.0, out).to(dt)

