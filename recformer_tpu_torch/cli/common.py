"""Shared CLI plumbing: config construction, cached corpus tokenization,
item-table upload, model initialisation and checkpoint loading.

Counterpart of ``recformer_tpu/cli/common.py``. Functions that place data
or a model take a ``device``, default ``cuda``; without a GPU they raise
unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..config import RecformerConfig
from ..data.item_table import ItemTable
from ..data.tokenization import RecformerTokenizer
from ..data.vocab import backend_for_config
from ..models.recformer import init_weights
from ..training.checkpoint import load_torch_checkpoint, merge_params
from ..utils.device import resolve_device


MODEL_SIZES = ("base", "tiny", "modernbert-large")


def build_config(args, item_num: int = 0) -> RecformerConfig:
    """The config of ``args.model_size`` (one of :data:`MODEL_SIZES`:
    ``RecformerConfig.base()``, ``.tiny()`` or ``.modernbert_large()``) with
    the options the command line gave."""
    kw = dict(item_num=item_num)
    for name in ("temp", "finetune_negative_sample_size", "attention_impl",
                 "max_token_num", "pooler_type", "mlm_weight", "pos_weight",
                 "scan_layers", "remat", "remat_policy", "hidden_act",
                 "scan_unroll", "ln_impl", "embed_ln_impl"):
        if hasattr(args, name) and getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    size = getattr(args, "model_size", "base")
    if size == "tiny":
        return RecformerConfig.tiny(**{k: v for k, v in kw.items()
                                       if k not in ("max_token_num",)})
    if size == "modernbert-large":
        return RecformerConfig.modernbert_large(**kw)
    return RecformerConfig.base(**kw)


def make_tokenizer(config: RecformerConfig, hf_tokenizer_path: Optional[str] = None):
    hf_tok = None
    if hf_tokenizer_path:
        from transformers import AutoTokenizer

        hf_tok = AutoTokenizer.from_pretrained(hf_tokenizer_path, local_files_only=True)
    return RecformerTokenizer(config, backend_for_config(config, hf_tok))


def tokenize_corpus_cached(tokenizer: RecformerTokenizer, item_meta: Dict,
                           item2id: Dict[str, int], cache_dir: str,
                           cache_name: str) -> ItemTable:
    """Tokenize all item metadata into a packed ItemTable, with an npz disk
    cache."""
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"item_table_{cache_name}.npz")
    if os.path.exists(cache):
        print(f"[corpus] cache hit: {cache}")
        return ItemTable.load(cache)
    print(f"[corpus] tokenizing {len(item_meta)} items")
    table = tokenizer.encode_corpus_table(item_meta, item2id)
    table.save(cache)
    return table


def rank0_first(mesh, fn):
    """``fn()`` on rank 0, then on the other ranks: a cache that ``fn``
    writes (the tokenized corpus) is written once and read by the rest."""
    if mesh is None:
        return fn()
    import torch.distributed as dist

    out = fn() if mesh.rank == 0 else None
    dist.barrier()
    return out if mesh.rank == 0 else fn()


def table_to_device(table: ItemTable, device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in table.as_arrays().items()}


def init_model_params(model, config: RecformerConfig, device="cuda", seed: int = 0):
    """Initialise ``model``'s parameters from ``seed`` (an explicit CPU
    generator, so the weights do not depend on the device), move it to
    ``device`` and put it in eval mode. Returns the model."""
    dev = resolve_device(device)
    init_weights(model, config, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def maybe_load_pretrained(model, ckpt_path: Optional[str]):
    """Load a torch ``.bin``/``.pt`` state dict into ``model`` with
    ``training.checkpoint.merge_params``: every name and shape match is
    copied, the rest keeps its initial value. Returns the model."""
    if ckpt_path:
        merge_params(load_torch_checkpoint(ckpt_path), model)
    return model
