"""Device-side batch construction: sequence assembly, pretraining pair
sampling and whole-word MLM.

Counterpart of ``recformer_tpu/data/device_pipeline.py``. The host ships only
``(B, max_items)`` item-id arrays; the packed item table lives on the device
and assembly is gather/scatter there. Semantics:

- newest-first item reversal, the oldest items dropped past ``max_items``;
- token-stream truncation at exactly ``out_len`` (mid-item): truncated and
  invalid tokens land in an overflow slot at ``out_len`` that is cut off;
- padding conventions: pad id, item position ``max_item_embeddings - 1``,
  token type 3; position 0 holds ``<s>`` with type 0 and item position 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import RecformerConfig

IGNORE_INDEX = -100


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


# ---------------------------------------------------------------------------
# Target sampling
# ---------------------------------------------------------------------------

def pretrain_pairs_from_draws(u: torch.Tensor, seq_lens: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pretrain pair sampling given uniforms ``u`` (B,): the target position
    is uniform over the second half ``[(len-1)//2, len-1]``. Returns
    (prefix_len = target_pos, target_pos)."""
    seq_lens = seq_lens.to(torch.int32)
    start = torch.div(seq_lens - 1, 2, rounding_mode="floor")
    span = (seq_lens - start).float()
    target = start + torch.floor(u.float() * span).to(torch.int32)
    target = torch.minimum(target, seq_lens - 1)
    return target, target


def sample_pretrain_pairs(generator: torch.Generator, seq_lens: torch.Tensor):
    u = torch.rand(seq_lens.shape, generator=generator, device=seq_lens.device)
    return pretrain_pairs_from_draws(u, seq_lens)


# ---------------------------------------------------------------------------
# Whole-word MLM
# ---------------------------------------------------------------------------

def _select_words_greedy(priorities: torch.Tensor, sizes: torch.Tensor,
                         budget: torch.Tensor, max_budget: int) -> torch.Tensor:
    """Greedy whole-word selection in random order with skip-and-continue:
    visit the words of a row by ascending priority, take a word iff its size
    is positive and fits in what is left of the budget; an oversized word is
    skipped and the walk goes on. ``priorities``/``sizes``: (B, N);
    ``budget``: (B,), at most ``max_budget``. Returns the (B, N) bool
    selection by word id.

    The walk is a sequential scan over N words, but its state (the tokens
    used so far) lives in [0, max_budget]: each word is a map of that small
    set into itself, maps compose associatively, and a prefix scan of map
    tables (Hillis-Steele, log2 N rounds of one gather) gives the state
    before and after every word in a few dozen kernels instead of N
    dependent steps. Exact: integer tables, no rounding."""
    B, N = sizes.shape
    dev = sizes.device
    order = torch.argsort(priorities, dim=1, stable=True)
    s = torch.gather(sizes.long(), 1, order)  # (B, N) sizes in visiting order
    x = torch.arange(max_budget + 1, device=dev)  # states: tokens used so far
    nxt = x[None, None, :] + s[:, :, None]
    fits = (s[:, :, None] > 0) & (nxt <= budget.long()[:, None, None])
    table = torch.where(fits, nxt, x[None, None, :])  # (B, N, max_budget + 1)
    d = 1
    while d < N:  # table[k] <- table[k] o table[k - d]
        table = torch.cat([table[:, :d], torch.gather(table[:, d:], 2, table[:, :-d])], dim=1)
        d *= 2
    after = table[:, :, 0]
    before = torch.cat([torch.zeros_like(after[:, :1]), after[:, :-1]], dim=1)
    take = after > before
    return torch.zeros_like(take).scatter(1, order, take)


def whole_word_mlm_from_draws(batch: Dict[str, torch.Tensor], priorities: torch.Tensor,
                              u: torch.Tensor, random_ids: torch.Tensor, *,
                              mlm_probability: float, max_predictions: int,
                              mask_token_id: int, bos_token_id: int, eos_token_id: int,
                              pad_token_id: int) -> Dict[str, torch.Tensor]:
    """Whole-word MLM given its random draws: word priorities ``(B, L+1)``,
    corruption uniforms ``(B, L)`` and random token ids ``(B, L)``. Returns
    {mlm_input_ids (B, L), mlm_positions (B, P), mlm_labels (B, P)}."""
    ids = batch["input_ids"]
    att = batch["attention_mask"]
    begin = batch["word_begin"].clone()
    B, L = ids.shape
    P = max_predictions

    maskable = (att == 1) & (ids != bos_token_id) & (ids != eos_token_id) & (ids != pad_token_id)
    # a maskable token right after <s> always starts a word
    begin[:, 1] = torch.where(maskable[:, 1], torch.ones_like(begin[:, 1]), begin[:, 1])
    word_id = torch.cumsum(begin * maskable.to(begin.dtype), dim=1)  # (B, L), 0 = no word

    n_tokens = att.sum(dim=1)  # includes <s>
    budget = torch.round(n_tokens * mlm_probability).to(torch.int32).clamp(1, P)
    sizes = torch.zeros((B, L + 1), dtype=torch.int64, device=ids.device)
    sizes.scatter_add_(1, word_id.long(), maskable.long())
    sizes[:, 0] = 0  # word 0 = tokens before any word: never masked
    selected = _select_words_greedy(priorities, sizes, budget, P)
    mask_label = torch.gather(selected, 1, word_id.long()) & maskable

    # 80% [MASK], 10% random token, 10% keep
    mlm_input_ids = torch.where(
        mask_label & (u < 0.8), torch.full_like(ids, mask_token_id),
        torch.where(mask_label & (u >= 0.8) & (u < 0.9), random_ids.to(ids.dtype), ids))

    # masked positions into a static (B, P) block, earliest first
    score = (mask_label.float() * 2.0
             - torch.arange(L, dtype=torch.float32, device=ids.device) / L)
    positions = torch.topk(score, P, dim=1).indices
    pos_is_masked = torch.gather(mask_label, 1, positions)
    labels = torch.where(pos_is_masked, torch.gather(ids, 1, positions).long(), IGNORE_INDEX)
    return {
        "mlm_input_ids": mlm_input_ids,
        "mlm_positions": positions.to(torch.int32),
        "mlm_labels": labels.to(torch.int32),
    }


def whole_word_mlm(generator: torch.Generator, batch: Dict[str, torch.Tensor], *,
                   vocab_size: int, **kw) -> Dict[str, torch.Tensor]:
    """Draws the priorities, corruption uniforms and random ids from
    ``generator`` (in that order), then :func:`whole_word_mlm_from_draws`."""
    ids = batch["input_ids"]
    B, L = ids.shape
    dev = ids.device
    priorities = torch.rand((B, L + 1), generator=generator, device=dev)
    u = torch.rand((B, L), generator=generator, device=dev)
    random_ids = torch.randint(0, vocab_size, (B, L), generator=generator, device=dev)
    return whole_word_mlm_from_draws(batch, priorities, u, random_ids, **kw)


def mlm_for_config(generator, batch, config: RecformerConfig, max_predictions: int | None = None):
    if max_predictions is None:
        L = batch["input_ids"].shape[1]
        # generous static bound: budget is round(0.15 * L), padded to a multiple of 8
        max_predictions = min(512, ((int(round(L * config.mlm_probability)) + 15) // 8) * 8)
    return whole_word_mlm(
        generator, batch,
        mlm_probability=config.mlm_probability,
        max_predictions=max_predictions,
        vocab_size=config.vocab_size,
        mask_token_id=config.mask_token_id,
        bos_token_id=config.bos_token_id,
        eos_token_id=config.eos_token_id,
        pad_token_id=config.pad_token_id,
    )


# ---------------------------------------------------------------------------
# Composed batch construction
# ---------------------------------------------------------------------------

def make_pretrain_batch(generator: torch.Generator, table, item_ids, seq_lens,
                        config: RecformerConfig):
    """Device-side pretrain batch: pair sampling, then two views, then MLM on
    each. View a is the history prefix at ``max_token_num``; view b the
    single target item at the short static ``item_seq_len``."""
    prefix_len, target_pos = sample_pretrain_pairs(generator, seq_lens)
    target_item = torch.gather(item_ids, 1, target_pos.long()[:, None])  # (B, 1)
    batch_a = assemble_for_config(table, item_ids, prefix_len, config)
    batch_b = assemble_for_config(table, target_item, torch.ones_like(seq_lens), config,
                                  out_len=config.item_seq_len)
    batch_a.update(mlm_for_config(generator, batch_a, config))
    batch_b.update(mlm_for_config(generator, batch_b, config))
    return batch_a, batch_b
