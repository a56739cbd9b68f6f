"""Device-side batch construction: sequence assembly.

Counterpart of ``assemble_sequences`` / ``assemble_for_config`` in
``recformer_tpu/data/device_pipeline.py``. The host ships only
``(B, max_items)`` item-id arrays; the packed item table lives on the device
and assembly is gather/scatter there. Semantics:

- newest-first item reversal, the oldest items dropped past ``max_items``;
- token-stream truncation at exactly ``out_len`` (mid-item): truncated and
  invalid tokens land in an overflow slot at ``out_len`` that is cut off;
- padding conventions: pad id, item position ``max_item_embeddings - 1``,
  token type 3; position 0 holds ``<s>`` with type 0 and item position 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import RecformerConfig


def assemble_sequences(
    table: Dict[str, torch.Tensor],
    item_ids: torch.Tensor,  # (B, S_in) chronological [past ... present]
    seq_lens: torch.Tensor,  # (B,)
    *,
    out_len: int,
    max_items: int,
    pad_token_id: int,
    bos_token_id: int,
    max_item_embeddings: int,
) -> Dict[str, torch.Tensor]:
    """Build model-ready int32 arrays from item-id sequences. ``max_items``
    is the item-count cap (``max_item_embeddings - 1``); ``out_len`` the
    static output token length."""
    B, S_in = item_ids.shape
    S = max_items
    M = table["token_ids"].shape[1]
    null_item = table["token_ids"].shape[0] - 1
    dev = item_ids.device

    # newest-first: slot s holds the item at chronological index len-1-s
    slot = torch.arange(S, device=dev)[None, :]  # (1, S)
    src = seq_lens.long()[:, None] - 1 - slot  # (B, S)
    valid_slot = src >= 0
    ids = torch.gather(item_ids.long(), 1, src.clamp(0, S_in - 1))
    ids = torch.where(valid_slot, ids, null_item)

    tok = table["token_ids"][ids]  # (B, S, M)
    typ = table["token_types"][ids]
    beg = table["word_begin"][ids]
    lens = table["lengths"][ids].long() * valid_slot  # (B, S)

    starts = 1 + torch.cumsum(lens, dim=1) - lens  # (B, S); +1 for <s>
    pos_in_item = torch.arange(M, device=dev)[None, None, :]
    tok_valid = pos_in_item < lens[:, :, None]
    dest = starts[:, :, None] + pos_in_item  # (B, S, M)
    # invalid or truncated tokens land in the overflow slot ``out_len``
    dest = torch.where(tok_valid, dest.clamp_max(out_len), out_len)

    flat_b = torch.arange(B, device=dev)[:, None, None].expand_as(dest).reshape(-1)
    flat_dest = dest.reshape(-1)

    def scatter(fill_value, values, first):
        out = torch.full((B, out_len + 1), fill_value, dtype=torch.int32, device=dev)
        out[flat_b, flat_dest] = values.reshape(-1).to(torch.int32)
        out = out[:, :out_len].contiguous()
        out[:, 0] = first
        return out

    item_pos_vals = (slot + 1)[:, :, None].expand_as(dest)
    ones = torch.ones_like(dest)
    global_attention_mask = torch.zeros((B, out_len), dtype=torch.int32, device=dev)
    global_attention_mask[:, 0] = 1
    return {
        "input_ids": scatter(pad_token_id, tok, bos_token_id),
        "item_position_ids": scatter(max_item_embeddings - 1, item_pos_vals, 0),
        "token_type_ids": scatter(3, typ, 0),
        "attention_mask": scatter(0, ones, 1),
        "global_attention_mask": global_attention_mask,
        "word_begin": scatter(0, beg, 0),
    }


def assemble_for_config(table, item_ids, seq_lens, config: RecformerConfig,
                        out_len: int | None = None, pad_token_id: int | None = None,
                        bos_token_id: int | None = None):
    return assemble_sequences(
        table,
        item_ids,
        seq_lens,
        out_len=out_len if out_len is not None else config.max_token_num,
        max_items=config.max_item_embeddings - 1,
        pad_token_id=config.pad_token_id if pad_token_id is None else pad_token_id,
        bos_token_id=config.bos_token_id if bos_token_id is None else bos_token_id,
        max_item_embeddings=config.max_item_embeddings,
    )
