"""Longformer-style windowed + global attention: plain PyTorch twins.

The deterministic counterparts of ``recformer_tpu/ops/attention.py``, with
the same public layout: q/k/v ``(B, L, H, D)``, an int mask ``(B, L)`` coded
{0 = padding, 1 = local, 2 = global}, output ``(B, L, H, D)``.

- A local query at position i attends to every global position and to the
  local positions j with ``|i - j| <= window // 2``; global positions enter
  once, as global columns.
- A global query attends to every non-padding position through its own
  projections.
- Padding queries produce zeros; padding keys are never attended.
- Scores are scaled by ``1/sqrt(head_dim)`` and softmaxed in float32.

Rounding follows the JAX functions: a product that JAX asks for in float32
(``preferred_element_type``) multiplies the compute-type operands in float32
here; any other product accumulates in float32 and rounds once to the
compute type, as XLA's dot does. Training applies inverted dropout to the
float32 probabilities (``dropout_rate``), drawn from an explicit
``torch.Generator`` on the tensors' device: the same function as the JAX
package's, with other random bits.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _prob_dropout(probs: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout on attention probabilities (float32)."""
    if rate <= 0.0:
        return probs
    if generator is None:
        raise ValueError("dropout_rate > 0 requires a generator")
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    return torch.where(u < 1.0 - rate, probs / (1.0 - rate), 0.0)


def _split_masks(mask: torch.Tensor):
    return mask == 0, mask == 1, mask == 2


def _einsum32(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """Einsum of compute-type operands with float32 products and sums."""
    return torch.einsum(eq, *[x.float() for x in xs])


def attention_scale(head_dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``1/sqrt(D)`` computed in float32, then cast to the compute type."""
    d = torch.tensor(float(head_dim), dtype=torch.float32, device=device)
    return (1.0 / torch.sqrt(d)).to(dtype)


def global_prefix_indices(mask: torch.Tensor, max_globals: int):
    """Indices of the first ``max_globals`` global positions per row, plus a
    validity flag; earliest positions win. With no global row the index is 0
    and the flag False."""
    B, L = mask.shape
    is_global = (mask == 2).float()
    pos = torch.arange(L, dtype=torch.float32, device=mask.device) / (2.0 * L)
    idx = torch.topk(is_global - pos, max_globals, dim=1).indices  # (B, G)
    valid = torch.gather(mask, 1, idx) == 2
    return idx, valid


def _batch_index(idx: torch.Tensor) -> torch.Tensor:
    return torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)


def scatter_global_rows(out_g: torch.Tensor, mask: torch.Tensor, max_globals: int):
    """(B, G, H, D) compact global-row outputs -> (B, L, H, D) with the
    values at the global positions, zeros elsewhere."""
    B, L = mask.shape
    gidx, _ = global_prefix_indices(mask, max_globals)
    out = out_g.new_zeros((B, L) + tuple(out_g.shape[2:]))
    return out.index_put_((_batch_index(gidx), gidx), out_g, accumulate=True)


def _global_rows(q_g, k_g, v_g, mask, scale, dtype, max_globals: int = 1,
                 dropout_rate: float = 0.0, generator=None, compact: bool = False):
    """Full-attention output of the global query rows, computed only at the
    (at most ``max_globals``) global positions. ``q_g`` is either the
    full-length ``(B, L, H, D)`` projection or already gathered at the
    ``global_prefix_indices`` rows, ``(B, max_globals, H, D)``. Returns the
    compact ``(B, G, H, D)`` rows when ``compact`` else the scattered
    ``(B, L, H, D)`` form."""
    B, L = mask.shape
    is_pad = mask == 0
    gidx, gvalid = global_prefix_indices(mask, max_globals)
    if q_g.shape[1] == max_globals and max_globals != L:
        qg_sel = q_g
    else:
        qg_sel = q_g[_batch_index(gidx), gidx]  # (B, G, H, D)
    scores = _einsum32("bghd,bmhd->bhgm", qg_sel * scale, k_g)
    scores = torch.where(is_pad[:, None, None, :], NEG_INF, scores)
    probs = _prob_dropout(torch.softmax(scores, dim=-1), dropout_rate, generator)
    out_g = _einsum32("bhgm,bmhd->bghd", probs.to(dtype), v_g).to(dtype)
    out_g = torch.where(gvalid[:, :, None, None], out_g, 0.0).to(dtype)
    if compact:
        return out_g
    return scatter_global_rows(out_g, mask, max_globals)


def global_rows_thin(hidden, qg_sel, w_kg, b_kg, w_vg, b_vg, mask, dtype,
                     max_globals: int = 1, dropout_rate: float = 0.0, generator=None,
                     compact: bool = False):
    """Global-row attention without the full-length k_g/v_g projections:

        scores[l] = q_g . (hidden[l] @ W_kg)  =  hidden[l] . (W_kg^T q_g)
        out       = probs @ (hidden @ W_vg)   =  (probs @ hidden) @ W_vg

    ``hidden``: (B, L, hs); ``qg_sel``: (B, G, H, D) gathered global queries
    (unscaled); ``w_kg``/``w_vg``: (hs, hs) applied as ``x @ w``;
    ``b_kg``/``b_vg``: (hs,). Returns the compact (B, G, H, D) rows when
    ``compact`` else (B, L, H, D) with zeros off the global rows."""
    B, L = mask.shape
    H, D = qg_sel.shape[2], qg_sel.shape[3]
    scale = attention_scale(D, dtype, hidden.device)
    is_pad = mask == 0
    _, gvalid = global_prefix_indices(mask, max_globals)
    qs = (qg_sel * scale).to(dtype)
    # the weights round to the compute type before the float32 contractions
    w_kg_h = w_kg.to(dtype).float().reshape(-1, H, D)
    w_vg_h = w_vg.to(dtype).float().reshape(-1, H, D)
    qs32 = qs.float()
    r = torch.einsum("ehd,bghd->bghe", w_kg_h, qs32)  # (B, G, H, hs)
    sb = torch.einsum("hd,bghd->bgh", b_kg.float().reshape(H, D), qs32)
    scores = _einsum32("ble,bghe->bhgl", hidden.to(dtype), r.to(dtype))
    scores = scores + sb.permute(0, 2, 1)[:, :, :, None]
    scores = torch.where(is_pad[:, None, None, :], NEG_INF, scores)
    probs = _prob_dropout(torch.softmax(scores, dim=-1), dropout_rate, generator)  # (B, H, G, L)
    # out = (probs @ hidden) @ W_vg + b_vg * sum(probs)   [sum != 1 with dropout]
    t = _einsum32("bhgl,ble->bghe", probs.to(dtype), hidden.to(dtype)).to(dtype)
    out_g = torch.einsum("bghe,ehd->bghd", t.float(), w_vg_h)
    psum = probs.sum(dim=-1)  # (B, H, G)
    out_g = out_g + (b_vg.float().reshape(1, 1, H, D)
                     * psum.permute(0, 2, 1)[:, :, :, None])
    out_g = out_g.to(dtype)
    out_g = torch.where(gvalid[:, :, None, None], out_g, 0.0).to(dtype)
    if compact:
        return out_g
    return scatter_global_rows(out_g, mask, max_globals)


def dense_attention(q, k, v, q_g, k_g, v_g, mask, window: int, dropout_rate: float = 0.0,
                    generator=None, g_out=None):
    """O(L^2) oracle implementation. Dropout draws the local rows' mask, then
    the global rows', from ``generator``."""
    B, L, H, D = q.shape
    dt = q.dtype
    scale = attention_scale(D, dt, q.device)
    is_pad, is_local, is_global = _split_masks(mask)
    half = window // 2

    i = torch.arange(L, device=q.device)[:, None]
    j = torch.arange(L, device=q.device)[None, :]
    in_window = (i - j).abs() <= half  # (L, L)

    # local rows: keys = globals  U  (window & local)
    allowed = is_global[:, None, :] | (in_window[None] & is_local[:, None, :])
    scores = _einsum32("blhd,bmhd->bhlm", q * scale, k)
    scores = torch.where(allowed[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    any_key = allowed.any(dim=-1)  # (B, L)
    probs = torch.where(any_key[:, None, :, None], probs, 0.0)
    probs = _prob_dropout(probs, dropout_rate, generator)
    out = _einsum32("bhlm,bmhd->blhd", probs.to(dt), v).to(dt)

    if g_out is not None:
        pass  # precomputed global rows (global_rows_thin)
    elif q_g.shape[1] != L:
        g_out = _global_rows(q_g, k_g, v_g, mask, scale, dt, q_g.shape[1],
                             dropout_rate, generator)
    else:
        # oracle path: global rows for every position, then select
        g_scores = _einsum32("blhd,bmhd->bhlm", q_g * scale, k_g)
        g_scores = torch.where(is_pad[:, None, None, :], NEG_INF, g_scores)
        g_probs = _prob_dropout(torch.softmax(g_scores, dim=-1), dropout_rate, generator)
        g_out = _einsum32("bhlm,bmhd->blhd", g_probs.to(dt), v_g).to(dt)
    out = torch.where(is_global[:, :, None, None], g_out, out)
    return torch.where(is_pad[:, :, None, None], 0.0, out).to(dt)


def chunked_attention(q, k, v, q_g, k_g, v_g, mask, window: int,
                      block: int = 128, max_globals: int = 1, dropout_rate: float = 0.0,
                      generator=None, g_out=None):
    """Banded attention via sliding chunks, O(L * (block + window)); ``L``
    must be a multiple of ``block``. Normalises the probabilities before the
    cast to the compute type, as the JAX twin does."""
    B, L, H, D = q.shape
    if L % block:
        raise ValueError(f"L={L} must be a multiple of block={block}")
    dt = q.dtype
    dev = q.device
    half = window // 2
    nb = L // block
    band = block + 2 * half  # keys visible to one query block
    scale = attention_scale(D, dt, dev)
    is_pad, is_local, is_global = _split_masks(mask)

    # key positions for block c: [c*block - half, c*block + block + half)
    kidx = ((torch.arange(nb, device=dev) * block)[:, None]
            + torch.arange(band, device=dev)[None, :] - half)  # (nb, band)
    kvalid_pos = (kidx >= 0) & (kidx < L)
    kidx_c = kidx.clamp(0, L - 1)
    k_b = k[:, kidx_c]  # (B, nb, band, H, D)
    v_b = v[:, kidx_c]
    key_local = is_local[:, kidx_c] & kvalid_pos[None]  # (B, nb, band)

    t = torch.arange(block, device=dev)[:, None]
    u = torch.arange(band, device=dev)[None, :]
    in_window = (t - (u - half)).abs() <= half  # (block, band)
    band_allowed = key_local[:, :, None, :] & in_window[None, None]

    qb = (q * scale).reshape(B, nb, block, H, D)
    band_scores = _einsum32("bnthd,bnuhd->bhntu", qb, k_b)
    band_scores = torch.where(band_allowed[:, None], band_scores, NEG_INF)

    gidx, gvalid = global_prefix_indices(mask, max_globals)
    bidx = _batch_index(gidx)
    kg_sel = k[bidx, gidx]  # (B, G, H, D)
    vg_sel = v[bidx, gidx]
    g_scores = _einsum32("bnthd,bghd->bhntg", qb, kg_sel)
    g_scores = torch.where(gvalid[:, None, None, None, :], g_scores, NEG_INF)

    scores = torch.cat([band_scores, g_scores], dim=-1)
    m = scores.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = _prob_dropout(probs, dropout_rate, generator)
    p_band, p_glob = probs[..., :band], probs[..., band:]

    out = _einsum32("bhntu,bnuhd->bnthd", p_band.to(dt), v_b).to(dt)
    out = out + _einsum32("bhntg,bghd->bnthd", p_glob.to(dt), vg_sel).to(dt)
    out = out.reshape(B, L, H, D)

    if g_out is None:
        g_out = _global_rows(q_g, k_g, v_g, mask, scale, dt, max_globals,
                             dropout_rate, generator)
    out = torch.where(is_global[:, :, None, None], g_out, out)
    return torch.where(is_pad[:, :, None, None], 0.0, out).to(dt)
