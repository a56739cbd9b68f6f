"""Host-side orchestration of the serving path: catalog encoding and ranked
evaluation.

Counterparts of ``encode_all_items`` and ``evaluate_seqrec`` in
``recformer_tpu/training/loops.py``. Both stream fixed-size batches through
the model on its device and keep their results there; the host reads once
at the end.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import RecformerConfig
from ..data.datasets import EvalDataset
from .steps import make_encode_items_step, make_eval_step


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def params_fingerprint(model) -> str:
    """Cheap content fingerprint: float64 sums of the 8 largest parameters."""
    params = sorted((p for p in model.state_dict().values()), key=lambda p: -p.numel())[:8]
    return ",".join(f"{float(p.double().sum()):.6e}" for p in params)


def encode_all_items(model, table, config: RecformerConfig, batch_size: int = 256,
                     cache_path: Optional[str] = None) -> torch.Tensor:
    """Encode every catalog item as a one-item sequence and return the pooled
    ``(N, H)`` matrix on the model's device, in the compute type.

    Items go in chunks of ``batch_size`` (the tail chunk is padded with item
    0 and trimmed). ``cache_path``: optional ``.npz`` cache holding the
    embeddings with a fingerprint of the parameters; a changed model
    re-encodes."""
    n = int(table["lengths"].shape[0]) - 1
    dev = _model_device(model)
    if cache_path:
        fp = params_fingerprint(model)
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as data:
                if str(data["fingerprint"]) == fp and int(data["n_items"]) == n:
                    print(f"[encode] item-embedding cache hit: {cache_path}")
                    return torch.from_numpy(data["embeddings"]).to(
                        dev, getattr(torch, str(data["dtype"])))
        emb = encode_all_items(model, table, config, batch_size)
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        # stored as float32: npz has no bfloat16, and float32 holds bf16 exactly
        np.savez(cache_path, embeddings=emb.float().cpu().numpy(),
                 dtype=str(emb.dtype).removeprefix("torch."), fingerprint=fp, n_items=n)
        return emb
    step = make_encode_items_step(config, model)
    pad_to = -(-n // batch_size) * batch_size
    ids = torch.zeros(pad_to, dtype=torch.int32)
    ids[:n] = torch.arange(n, dtype=torch.int32)
    ids = ids.to(dev)
    out = None
    for c in range(0, pad_to, batch_size):
        pooled = step(table, ids[c:c + batch_size])
        if out is None:
            out = torch.empty((pad_to, pooled.shape[-1]), dtype=pooled.dtype, device=dev)
        out[c:c + batch_size] = pooled
    return out[:n]


def evaluate_seqrec(model, table, dataset: EvalDataset, item_embeddings,
                    config: RecformerConfig, batch_size: int = 32,
                    ks: Sequence[int] = (10, 50)) -> Dict[str, float]:
    """Full-catalog ranked evaluation; exact (sum / count) aggregation, with
    the sums kept on the device until the end."""
    step = make_eval_step(config, model, ks=ks)
    dev = _model_device(model)
    totals = None
    for batch in dataset.batches(batch_size):
        out = step(table, *(torch.from_numpy(a).to(dev) for a in (
            batch.item_ids, batch.seq_lens, batch.labels, batch.valid)), item_embeddings)
        totals = out if totals is None else {k: totals[k] + v for k, v in out.items()}
    if totals is None:
        return {}
    totals = {k: float(v) for k, v in totals.items()}
    count = totals.pop("count")
    return {k: v / max(count, 1.0) for k, v in totals.items()}
