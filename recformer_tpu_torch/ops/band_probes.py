"""Two timing probes of the windowed-attention forward: the hand-written CUDA kernels.

``csrc/band_probes.cu`` replaces the two TPU probes of the JAX package's
band kernel (kernel 1, ``recformer_tpu/ops/pallas_attention.py::_fwd_kernel``):

- :func:`band_ablation` replaces ``benchmarks/kernel_ablation.py::kern``:
  kernel 1's band forward with parts removed one at a time. Query block i
  (``block_q`` rows) reads the padded key rows ``[i*block_q, i*block_q +
  block_q + W)`` (``kpad``/``vpad``/``keyloc`` carry W/2 rows of padding at
  each end), takes the raw float32 scores ``q . k`` (no 1/sqrt(D) scale)
  over that whole band, and per variant:

  - ``dots_only``: the raw scores;
  - ``no_softmax``: the scores masked with -1e30 (the window
    ``|t - (u - W/2)| <= W/2`` and ``keyloc != 0``), not normalised;
  - ``no_mask``: a softmax over the whole band, padding included;
  - ``band_softmax``: the masked softmax over the band;
  - ``full``: the same with the global scores ``q . gk`` (masked by
    ``gvalid``) in the denominator; only the band columns reach P.V, so
    ``gv`` is never read.

  The softmax divides by ``max(sum, 1e-30)``; ``e`` rounds to the input type
  before P.V, accumulated in float32. ``dots_only``, ``no_softmax`` and
  ``no_mask`` cover the whole band and so depend on ``block_q``;
  ``band_softmax`` and ``full`` keep only the window, which every band
  holds, and do not (except on a row with no valid key and no valid global,
  which averages its whole band). At ``block_q = 16`` the band is 16 + 64 =
  80 keys, the ten 8-key tiles one warp of kernel 1 sees, so
  ``band_softmax`` there is kernel 1's windowed arithmetic and ``full`` adds
  the global scores.
- :func:`band_headpair` replaces ``benchmarks/headpair_probe.py::perhead``
  and ``pair``: ``(q . k^T) . v`` over a band of ``min(block_q + W, L)``
  unpadded key rows starting at ``clamp(i*block_q - W/2, 0, L - band)``
  (edge blocks shift their window), no mask and no softmax; the scores
  round to the input type before the second product. ``perhead`` contracts
  each 64-lane head in turn; ``pair`` computes a head pair at once against
  block-diagonal K and V (128-lane contraction, twice the columns). The
  cross-head terms multiply exact zeros, so both compute one function, and
  :func:`band_headpair_plain` serves both.

What bounds them on the H100 (``PERF.md`` has the times): about 4*D flops
per (query, key) pair against 8*D bytes of q/k/v/out per row and head in
bf16, so HBM bytes, as for kernel 1; at ``block_q = 256`` the products take
half the byte time at the tensor cores' peak. The kernels (``csrc/
band_probes.cu`` with ``csrc/hopper_tma.cuh``) are built for that: a
persistent block a SM whose one producer thread stages each tile of query
rows, and the band under it once, by TMA (128-byte swizzled, 64-row
chunks through a ring of stages on mbarriers) while four consumer
warpgroups take both products on ``wgmma`` (Q.K^T from shared memory, P.V
with P from registers) and the mask and online softmax in registers. A
warpgroup's 64 rows may span several query blocks (``block_q`` below 64 or
not a multiple of it): it walks the union of their bands and leaves each
row's other-block columns out (P zero; out of the softmax's max and sum),
so one path serves every ``block_q``. ``perhead`` and ``pair`` share the
body and differ in staging alone: one TMA box per head, or one box for the
pair's 128 lanes; both issue only the per-head products.

The kernels take bf16 only, D = 64, ``block_q`` a multiple of 16 dividing
L, W a multiple of 16 and at most 8 global keys; anything else raises. On
CPU tensors the wrappers take the plain versions (any float dtype, any
shape the reference takes); on CUDA tensors they launch the kernels or
raise. ``ABLATION_LAUNCHES`` and ``HEADPAIR_LAUNCHES`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import aligned, ptr

# Launches of the two kernels since the last reset.
ABLATION_LAUNCHES = 0
HEADPAIR_LAUNCHES = 0

# the ``variant`` argument of each kernel's C interface
ABLATION_VARIANTS = ("dots_only", "no_softmax", "no_mask", "band_softmax", "full")
HEADPAIR_VARIANTS = ("perhead", "pair")

NEG_INF = -1e30  # the reference's mask value (``recformer_tpu/ops/attention.py``)
HEAD_DIM = 64    # the kernels' head width; the head-pair probe's fixed width
MAX_GLOBALS = 8  # the ablation kernel's global keys: one 8-wide tile


def _variant(variant: str, names) -> int:
    if variant not in names:
        raise ValueError(f"variant must be one of {names}, got {variant!r}")
    return names.index(variant)


def _compute_type(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def band_ablation_plain(q, kpad, vpad, keyloc, gk, gv, gvalid, *, variant: str,
                        block_q: int, window: int, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the ablation kernel (see the module note).

    q: (B, L, H*D); kpad, vpad: (B, L + W, H*D); keyloc: (B, L + W, 1) or
    (B, L + W) int; gk, gv: (B, G, H*D); gvalid: (B, 1, G) or (B, G) int.
    Returns (B, L, H*D) in q's type."""
    v_code = _variant(variant, ABLATION_VARIANTS)
    B, L, HD = q.shape
    H = num_heads
    D = HD // H
    W = window
    half = W // 2
    band = block_q + W
    nb = L // block_q
    G = gk.shape[1]
    dt = q.dtype
    ct = _compute_type(dt)
    dev = q.device
    if L % block_q or HD != H * D or kpad.shape[1] != L + W:
        raise ValueError(f"shapes: q {tuple(q.shape)}, kpad {tuple(kpad.shape)}, "
                         f"block_q {block_q}, window {W}, heads {H}")
    rows = (torch.arange(nb, device=dev)[:, None] * block_q
            + torch.arange(band, device=dev)[None, :])             # (nb, band)
    qb = q.reshape(B, nb, block_q, H, D).to(ct)
    kb = kpad.reshape(B, L + W, H, D)[:, rows].to(ct)              # (B, nb, band, H, D)
    vb = vpad.reshape(B, L + W, H, D)[:, rows].to(ct)
    s = torch.einsum("bnthd,bnuhd->bnhtu", qb, kb)                 # (B, nb, H, bq, band)
    t = torch.arange(block_q, device=dev)[:, None]
    u = torch.arange(band, device=dev)[None, :]
    key_ok = keyloc.reshape(B, L + W)[:, rows] != 0                # (B, nb, band)
    mask = ((t - (u - half)).abs() <= half) & key_ok[:, :, None, None, :]
    if v_code == 0:    # dots_only
        e = s
    elif v_code == 1:  # no_softmax
        e = torch.where(mask, s, NEG_INF)
    elif v_code == 2:  # no_mask
        e = _softmax(s)
    elif v_code == 3:  # band_softmax
        e = _softmax(torch.where(mask, s, NEG_INF))
    else:              # full: the global scores join the denominator only
        gs = torch.einsum("bnthd,bghd->bnhtg", qb, gk.reshape(B, G, H, D).to(ct))
        g_ok = gvalid.reshape(B, G) != 0
        gs = torch.where(g_ok[:, None, None, None, :], gs, NEG_INF)
        e = _softmax(torch.cat([torch.where(mask, s, NEG_INF), gs], dim=-1))[..., :band]
    out = torch.einsum("bnhtu,bnuhd->bnthd", e.to(dt).to(ct), vb)
    return out.to(dt).reshape(B, L, HD)


def headpair_offsets(L: int, block_q: int, window: int):
    """(band, [offset of each query block's band]) of the head-pair probe:
    ``band = min(block_q + W, L)``, offsets clamped into [0, L - band]."""
    band = min(block_q + window, L)
    half = window // 2
    return band, [min(max(i * block_q - half, 0), L - band) for i in range(L // block_q)]


def band_headpair_plain(q, k, v, *, variant: str, block_q: int, window: int) -> torch.Tensor:
    """Plain PyTorch version of both head-pair kernels (see the module note).

    q, k, v: (B, L, P*128), each 128 lanes a pair of 64-wide heads. Returns
    (B, L, P*128) in q's type."""
    _variant(variant, HEADPAIR_VARIANTS)
    B, L, C = q.shape
    if C % (2 * HEAD_DIM) or L % block_q:
        raise ValueError(f"shapes: q {tuple(q.shape)}, block_q {block_q}")
    H = C // HEAD_DIM
    nb = L // block_q
    dt = q.dtype
    ct = _compute_type(dt)
    band, offs = headpair_offsets(L, block_q, window)
    rows = (torch.tensor(offs, device=q.device)[:, None]
            + torch.arange(band, device=q.device)[None, :])        # (nb, band)
    qb = q.reshape(B, nb, block_q, H, HEAD_DIM).to(ct)
    kb = k.reshape(B, L, H, HEAD_DIM)[:, rows].to(ct)
    vb = v.reshape(B, L, H, HEAD_DIM)[:, rows].to(ct)
    s = torch.einsum("bnthd,bnuhd->bnhtu", qb, kb).to(dt).to(ct)
    out = torch.einsum("bnhtu,bnuhd->bnthd", s, vb)
    return out.to(dt).reshape(B, L, C)


# ---------------------------------------------------------------------------
# the kernels' launchers
# ---------------------------------------------------------------------------

def _check_kernel_shape(L: int, block_q: int, window: int):
    if block_q <= 0 or block_q % 16 or L % block_q:
        raise ValueError(f"probe kernels take block_q a multiple of 16 dividing L, "
                         f"got block_q={block_q}, L={L}")
    if window <= 0 or window % 16:
        raise ValueError(f"probe kernels take a window that is a multiple of 16, got {window}")


def _check_bf16(*tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"probe kernels take bfloat16, got {t.dtype}")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("probe kernel inputs must share one CUDA device")


def _launch_ablation(q, kpad, vpad, keyloc, gk, gv, gvalid, variant, block_q, window,
                     num_heads):
    global ABLATION_LAUNCHES
    from ._build import load_library

    code = _variant(variant, ABLATION_VARIANTS)
    B, L, HD = q.shape
    H = num_heads
    G = gk.shape[1]
    _check_bf16(q, kpad, vpad, gk, gv)
    if HD != H * HEAD_DIM:
        raise ValueError(f"the ablation kernel takes head_dim {HEAD_DIM}, got {HD}/{H}")
    _check_kernel_shape(L, block_q, window)
    if not 1 <= G <= MAX_GLOBALS:
        raise ValueError(f"the ablation kernel takes 1..{MAX_GLOBALS} global keys, got {G}")
    padded = (B, L + window, HD)
    if tuple(kpad.shape) != padded or tuple(vpad.shape) != padded:
        raise ValueError(f"kpad/vpad must be {padded}, got {tuple(kpad.shape)}, "
                         f"{tuple(vpad.shape)}")
    if keyloc.numel() != B * (L + window) or gvalid.numel() != B * G:
        raise ValueError("keyloc must hold (B, L + W) and gvalid (B, G) values")
    if tuple(gv.shape) != tuple(gk.shape) or gk.shape[0] != B or gk.shape[2] != HD:
        raise ValueError(f"gk/gv must be (B, G, H*D), got {tuple(gk.shape)}, {tuple(gv.shape)}")
    q, kpad, vpad, gk = (aligned(t) for t in (q, kpad, vpad, gk))
    keyloc = aligned(keyloc.to(q.device, torch.int32).reshape(B, L + window))
    gvalid = gvalid.to(q.device, torch.int32).reshape(B, G).contiguous()
    out = torch.empty_like(q)
    lib = load_library("band_probes")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.band_ablation(code, ptr(q), ptr(kpad), ptr(vpad), ptr(keyloc), ptr(gk),
                                ptr(gvalid), ptr(out), B, L, H, G, window, block_q,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"band_ablation launch failed: CUDA error {err}")
    ABLATION_LAUNCHES += 1
    return out


def _launch_headpair(q, k, v, variant, block_q, window):
    global HEADPAIR_LAUNCHES
    from ._build import load_library

    code = _variant(variant, HEADPAIR_VARIANTS)
    B, L, C = q.shape
    _check_bf16(q, k, v)
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"q, k and v must share one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if C % (2 * HEAD_DIM):
        raise ValueError(f"the head-pair kernel takes 128-lane head pairs, got width {C}")
    _check_kernel_shape(L, block_q, window)
    q, k, v = (aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = load_library("band_probes")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.band_headpair(code, ptr(q), ptr(k), ptr(v), ptr(out), B, L, C // 128,
                                window, block_q, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"band_headpair launch failed: CUDA error {err}")
    HEADPAIR_LAUNCHES += 1
    return out


def _on(t: torch.Tensor) -> bool:
    """True for a CUDA tensor; False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"the probes run on CUDA or CPU tensors, got {t.device}")
    return False


def band_ablation(q, kpad, vpad, keyloc, gk, gv, gvalid, *, variant: str, block_q: int,
                  window: int, num_heads: int) -> torch.Tensor:
    """The ablation kernel's wrapper (arguments as in
    :func:`band_ablation_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    kw = dict(variant=variant, block_q=block_q, window=window, num_heads=num_heads)
    if _on(q):
        return _launch_ablation(q, kpad, vpad, keyloc, gk, gv, gvalid, **kw)
    return band_ablation_plain(q, kpad, vpad, keyloc, gk, gv, gvalid, **kw)


def band_headpair(q, k, v, *, variant: str, block_q: int, window: int) -> torch.Tensor:
    """The head-pair kernels' wrapper (arguments as in
    :func:`band_headpair_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if _on(q):
        return _launch_headpair(q, k, v, variant, block_q, window)
    return band_headpair_plain(q, k, v, variant=variant, block_q=block_q, window=window)
