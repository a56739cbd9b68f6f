"""Ranking on the ModernBERT backbone: ``rank.py``'s unit, window and check
(``cli.serve``'s path, one client in a closed loop; set-up encodes the
catalog), with the backbone's own weights (``weights_modernbert.py``),
plain reference (``reference/modernbert.py``, one sequence at a time),
operation counts (``flops_modernbert.py``) and kernel work: kernel 1's
launches at the local layers (``attn_fwd``, window ``local_attention``, no
global column) and the global layers' attention (``global_attn_fwd``).

A program without the modernbert backbone (no ``backbone`` field in its
config) is refused at once."""

from __future__ import annotations

import numpy as np
import torch

from .. import flops, flops_modernbert
from ..reference import batches as rb
from ..reference import model as rm
from ..reference import modernbert as rmb
from ..traffic.generate import HashTokenizer, pack_table, pad_histories, seqrec_corpus, stream_seed
from ..weights_modernbert import make_weights
from . import rank
from .common import build_model, mark, table_to_device


class Driver(rank.Driver):
    def __init__(self, cell):
        if getattr(cell.config, "backbone", None) != "modernbert":
            raise SystemExit("rank_modernbert: the program's config has no modernbert backbone")
        from recformer_tpu_torch.data.device_pipeline import assemble_for_config
        from recformer_tpu_torch.models.heads import RecformerForSeqRec, similarity_scores
        from recformer_tpu_torch.training.loops import encode_all_items

        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, dev
        self.B, self.k = t["batch_size"], t["top_k"]
        attrs, users = seqrec_corpus(cell.seed, "finetune", t["corpus"])
        self.table_np = pack_table(attrs, HashTokenizer(cfg.vocab_size), cfg.max_attr_num,
                                   cfg.max_attr_length)
        self.n_items = len(attrs)
        ids, lens = pad_histories(users, t["corpus"]["history_length"]["max"])
        order = np.random.default_rng(stream_seed(cell.seed, "order")).permutation(len(users))
        nb = len(users) // self.B
        o = order[:nb * self.B]
        self.ids, self.lens = ids[o].reshape(nb, self.B, -1), lens[o].reshape(nb, self.B)
        self.weight_seed = stream_seed(cell.seed, "weights")
        mark("corpus")
        table = table_to_device(self.table_np, dev)
        model = build_model(RecformerForSeqRec, cfg, make_weights(cfg, self.head,
                                                                   self.weight_seed, dev), dev)
        mark("model")
        item_emb = encode_all_items(model, table, cfg, t["encode_batch_size"]).float()

        def request(ids_np, lens_np):
            with torch.no_grad():
                b = assemble_for_config(table, torch.from_numpy(ids_np).to(dev),
                                        torch.from_numpy(lens_np).to(dev), cfg)
                pooled = model(b).float()
                scores_k, ids_k = torch.topk(similarity_scores(pooled, item_emb, cfg.temp),
                                             self.k, dim=-1)
            return scores_k.cpu().numpy(), ids_k.cpu().numpy()

        self._request = request
        self._state = (model, table, item_emb)
        self.units_done = 0
        self._ref = None
        self.latency_s: list = []
        self.answers: dict = {}
        mark("catalog")
        for _ in range(t["warmup_requests"]):
            self.unit()
        mark("warm-up")
        self.window_start = self.units_done

    # -- counts ----------------------------------------------------------
    def window_flops(self, start: int, stop: int) -> float:
        cfg = self.cfg
        return sum(flops_modernbert.encoder_forward(cfg, self._valid(k))
                   + flops.scoring_forward(cfg, self.B, self.n_items) for k in range(start, stop))

    def kernel_work(self, start: int, stop: int) -> dict:
        cfg, local, glob = self.cfg, [], []
        for k in range(start, stop):
            n = self._valid(k)
            for i in range(cfg.num_hidden_layers):
                if cfg.is_global_layer(i):
                    glob.append(flops_modernbert.global_attn_work(cfg, n))
                else:
                    local.append(flops_modernbert.local_attn_work(cfg, n))
        return {"attn_fwd": local, "global_attn_fwd": glob}

    # -- the check ---------------------------------------------------------
    def answers_of(self, precision: str, ks) -> dict:
        """(n, catalog) scores of requests ``ks`` by the reference computed
        in ``precision``: its catalog in chunks of 256, each history alone."""
        cfg = self.cfg
        P = rm.as_params(make_weights(cfg, self.head, self.weight_seed, self.dev), grad=False)
        num = rm.Numerics(precision)
        items = _pooled(P, cfg, self.table_np, np.arange(self.n_items)[:, None],
                        np.ones(self.n_items, np.int64), cfg.item_seq_len, num, self.dev)
        out = {}
        for k in ks:
            b = k % len(self.ids)
            user = _pooled(P, cfg, self.table_np, self.ids[b], self.lens[b], cfg.max_token_num,
                           num, self.dev, chunk=1)
            out[k] = rmb.scores(user, items, cfg.temp).cpu().numpy()
        return out


@torch.no_grad()
def _pooled(P, cfg, table_np, item_ids, seq_lens, out_len, num, device, chunk=256):
    """The reference's pooled (n, hs) float32 outputs of rows of item ids,
    ``chunk`` rows at a time."""
    out = []
    for s in range(0, len(item_ids), chunk):
        batch = rb.assemble(table_np, item_ids[s:s + chunk], seq_lens[s:s + chunk], out_len, cfg,
                            device)
        out.append(rmb.encode(P, cfg, batch, batch["input_ids"], num)[:, 0])
    return torch.cat(out)
