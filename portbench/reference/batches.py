"""Batches from item ids, plainly: sequence assembly, pretraining pair
sampling and whole-word MLM, as the RecFormer data contract defines them
(a row loop on the host where the program scatters on the device).

- A history is read newest first; at most ``max_item_embeddings - 1``
  items are kept; ``<s>`` (type 0, item position 0) comes first, then each
  item's tokens with item position ``k + 1`` for the k-th newest item; the
  stream is cut at ``out_len``; padding is the pad id, item position
  ``max_item_embeddings - 1``, type 3, attention 0; ``<s>`` is the one
  global token.
- A pretraining pair's target is uniform over the history's second half;
  view a is the history before it, view b the target item alone.
- Whole-word MLM: a budget of ``round(0.15 * tokens)`` (at least 1, at
  most P); words are visited in the order of random priorities and taken
  whole while they fit; a taken token becomes the mask token with
  probability 0.8, a random token with 0.1, and stays with 0.1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

IGNORE = -100


def assemble(table: Dict[str, np.ndarray], item_ids: np.ndarray, seq_lens: np.ndarray,
             out_len: int, cfg, device) -> Dict[str, torch.Tensor]:
    B = item_ids.shape[0]
    pad_pos = cfg.max_item_embeddings - 1
    out = {
        "input_ids": np.full((B, out_len), cfg.pad_token_id, np.int64),
        "item_position_ids": np.full((B, out_len), pad_pos, np.int64),
        "token_type_ids": np.full((B, out_len), 3, np.int64),
        "attention_mask": np.zeros((B, out_len), np.int64),
        "word_begin": np.zeros((B, out_len), np.int64),
    }
    for r in range(B):
        n = int(seq_lens[r])
        items = [int(x) for x in item_ids[r, :n][::-1][:pad_pos]]
        ids, pos, typ, beg = [cfg.bos_token_id], [0], [0], [0]
        for k, it in enumerate(items):
            m = int(table["lengths"][it])
            ids += table["token_ids"][it, :m].tolist()
            typ += table["token_types"][it, :m].tolist()
            beg += table["word_begin"][it, :m].tolist()
            pos += [k + 1] * m
        m = min(len(ids), out_len)
        out["input_ids"][r, :m] = ids[:m]
        out["item_position_ids"][r, :m] = pos[:m]
        out["token_type_ids"][r, :m] = typ[:m]
        out["attention_mask"][r, :m] = 1
        out["word_begin"][r, :m] = beg[:m]
    batch = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    glob = torch.zeros_like(batch["attention_mask"])
    glob[:, 0] = 1
    batch["global_attention_mask"] = glob
    return batch


def pretrain_targets(u: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """The target position from a uniform ``u`` per row: uniform over
    ``[(len - 1) // 2, len - 1]``, in float32 as drawn."""
    lens = seq_lens.to(torch.int32)
    start = torch.div(lens - 1, 2, rounding_mode="floor")
    t = start + torch.floor(u.float() * (lens - start).float()).to(torch.int32)
    return torch.minimum(t, lens - 1)


def max_predictions(length: int, p: float) -> int:
    return min(512, ((int(round(length * p)) + 15) // 8) * 8)


def mlm(batch: Dict[str, torch.Tensor], priorities, u, random_ids, cfg, P: int):
    """Whole-word MLM given its draws. Returns (corrupted ids, (B, L) bool
    of the masked tokens)."""
    ids, att, begin = batch["input_ids"], batch["attention_mask"], batch["word_begin"]
    B, L = ids.shape
    maskable = ((att == 1) & (ids != cfg.bos_token_id) & (ids != cfg.eos_token_id)
                & (ids != cfg.pad_token_id))
    begin = begin.clone()
    begin[:, 1] = torch.where(maskable[:, 1], torch.ones_like(begin[:, 1]), begin[:, 1])
    word = torch.cumsum(begin * maskable, dim=1)  # 0: before any word
    budget = torch.round(att.sum(dim=1) * cfg.mlm_probability).to(torch.int64).clamp(1, P)

    word_np, mk_np = word.cpu().numpy(), maskable.cpu().numpy()
    sizes = np.zeros((B, L + 1), np.int64)
    for r in range(B):
        np.add.at(sizes[r], word_np[r][mk_np[r]], 1)
    sizes[:, 0] = 0
    order = torch.argsort(priorities, dim=1, stable=True).cpu().numpy()
    budget_np = budget.cpu().numpy()
    taken = np.zeros((B, L + 1), bool)
    used = np.zeros(B, np.int64)
    rows = np.arange(B)
    for t in range(L + 1):  # the greedy walk, all rows together
        w = order[:, t]
        s = sizes[rows, w]
        take = (s > 0) & (used + s <= budget_np)
        taken[rows, w] = take
        used += np.where(take, s, 0)
    masked = torch.from_numpy(taken).to(ids.device).gather(1, word) & maskable
    corrupted = torch.where(masked & (u < 0.8), torch.full_like(ids, cfg.mask_token_id),
                            torch.where(masked & (u >= 0.8) & (u < 0.9), random_ids, ids))
    return corrupted, masked
