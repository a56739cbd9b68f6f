"""Catalog encoding: ``training.steps.make_encode_items_step`` in chunks of
``chunk`` items, cycling through both synthetic catalogs (the finetuning
one and the pretraining one) in a closed loop, each chunk's pooled
embeddings written into the catalog buffer as
``training.loops.encode_item_rows`` writes them. A unit is one chunk.

The check: a sample of the catalog's items drawn from the seed, each
row's relative L2 gap from the reference's float32 embedding
(``emb_gap``, the widest)."""

from __future__ import annotations

import numpy as np
import torch

from .. import flops
from ..reference import model as rm
from ..traffic.generate import HashTokenizer, pack_table, seqrec_corpus, stream_seed
from ..weights import make_weights
from .common import build_model, mark, reference_pooled, table_to_device


class Driver:
    unit_name = "chunk"
    head = "seqrec"

    def __init__(self, cell):
        from recformer_tpu_torch.models.heads import RecformerForSeqRec
        from recformer_tpu_torch.training.steps import make_encode_items_step

        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, dev
        self.C = t["chunk"]
        attrs = []
        for stream, corpus in t["catalogs"].items():
            attrs += seqrec_corpus(cell.seed, stream, corpus)[0]
        self.table_np = pack_table(attrs, HashTokenizer(cfg.vocab_size), cfg.max_attr_num,
                                   cfg.max_attr_length)
        self.n_items = N = len(attrs)
        # one cycle over the catalog: ceil(N / C) chunks, the last wrapping
        n_chunks = -(-N // self.C)
        self.chunk_ids = (np.arange(n_chunks * self.C) % N).astype(np.int32).reshape(n_chunks,
                                                                                       self.C)
        self.weight_seed = stream_seed(cell.seed, "weights")
        mark("corpus")
        table = table_to_device(self.table_np, dev)
        model = build_model(RecformerForSeqRec, cfg, make_weights(cfg, self.head,
                                                                   self.weight_seed, dev), dev)
        step = make_encode_items_step(cfg, model)
        chunks = torch.from_numpy(self.chunk_ids).to(dev)
        catalog = torch.empty((n_chunks * self.C, cfg.hidden_size), dtype=cfg.compute_dtype,
                              device=dev)

        def run(k):
            c = k % n_chunks
            catalog[c * self.C:(c + 1) * self.C] = step(table, chunks[c])

        self._run, self._state, self.catalog = run, (model, table), catalog
        self.units_done = 0
        self._ref = None
        mark("model")
        for _ in range(t["warmup_chunks"]):
            self.unit()
        mark("warm-up")

    def unit(self):
        self._run(self.units_done)
        self.units_done += 1

    def align(self):
        pass

    profile_units = 8

    def end_to_end(self, window) -> dict:
        return {"encode_items_per_s": window.units * self.C / window.wall_s}

    # -- counts ----------------------------------------------------------
    def _valid(self, k: int) -> np.ndarray:
        ids = self.chunk_ids[k % len(self.chunk_ids)]
        return np.minimum(1 + self.table_np["lengths"][ids].astype(np.int64), self.cfg.item_seq_len)

    def window_flops(self, start: int, stop: int) -> float:
        return sum(flops.encoder_forward(self.cfg, self._valid(k)) for k in range(start, stop))

    def kernel_work(self, start: int, stop: int) -> dict:
        return {"attn_fwd": [flops.attn_fwd_work(self.cfg, self._valid(k), w)
                             for k in range(start, stop) for w in self.cfg.attention_window]}

    def valid_share(self) -> float:
        n = np.concatenate([self._valid(k) for k in range(len(self.chunk_ids))])
        return float(n.sum() / (len(n) * self.cfg.item_seq_len))

    # -- the check ---------------------------------------------------------
    def free(self):
        self.catalog_rows = self.catalog[:self.n_items].float()
        self._state = self._run = self.catalog = None

    def sample(self) -> np.ndarray:
        """Items to check (every one a window's chunk wrote): drawn from the
        seed, with the longest item."""
        done = min(self.units_done * self.C, self.n_items)
        rng = np.random.default_rng(stream_seed(self.cell.seed, "check"))
        pick = rng.choice(done, size=min(self.t["check_items"], done), replace=False)
        longest = int(np.argmax(self.table_np["lengths"][:done]))
        return np.unique(np.append(pick, longest))

    def embeddings_of(self, precision: str, items: np.ndarray) -> torch.Tensor:
        cfg = self.cfg
        P = rm.as_params(make_weights(cfg, self.head, self.weight_seed, self.dev), grad=False)
        return reference_pooled(P, cfg, self.table_np, items[:, None],
                                np.ones(len(items), np.int64), cfg.item_seq_len,
                                rm.Numerics(precision), self.dev)

    def readings(self, got: torch.Tensor, items: np.ndarray) -> dict:
        if self._ref is None:
            self._ref = self.embeddings_of("fp32", items)
        gap = torch.linalg.norm(got - self._ref, dim=1) / torch.linalg.norm(self._ref, dim=1)
        return {"emb_gap": float(gap.max())}

    def check(self) -> dict:
        items = self.sample()
        return self.readings(self.catalog_rows[torch.from_numpy(items).to(self.dev)], items)

    def control(self) -> dict:
        """The reference computed in fp8, in the program's place."""
        items = self.sample()
        return self.readings(self.embeddings_of("fp8", items), items)
