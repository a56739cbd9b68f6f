"""Ranking: ``cli.serve``'s path for one client in a closed loop. Set-up
encodes the catalog (``training.loops.encode_all_items``, no cache). A unit
is one request of ``batch_size`` users: their histories to the device,
``assemble_for_config``, ``RecformerForSeqRec``, ``similarity_scores``
against the catalog, ``torch.topk``, and the ids and scores on the host;
timed from the call until they are there.

The check: a sample of the window's requests drawn from the seed (the one
holding the longest history among them) against the reference's
float32 catalog and towers: ``topk_gap`` is the widest gap by which the
reference's score of an id the program returned at rank r lies below the
reference's r-th best score, ``score_gap`` the widest gap between a score
the program returned and the reference's score of that id."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops
from ..reference import model as rm
from ..traffic.generate import HashTokenizer, pack_table, pad_histories, seqrec_corpus, stream_seed
from ..weights import make_weights
from .common import build_model, mark, reference_pooled, table_to_device


class Driver:
    unit_name = "request"
    head = "seqrec"

    def __init__(self, cell):
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

    def unit(self):
        k = self.units_done
        b = k % len(self.ids)
        t0 = time.perf_counter()
        self.answers[k] = self._request(self.ids[b], self.lens[b])
        self.latency_s.append(time.perf_counter() - t0)
        self.units_done += 1

    def align(self):
        pass

    profile_units = 8

    def end_to_end(self, window) -> dict:
        lat = np.asarray(self.latency_s[window.start:window.start + window.units])
        return {"rank_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    # -- counts ----------------------------------------------------------
    def _valid(self, k: int) -> np.ndarray:
        b = k % len(self.ids)
        return flops.valid_tokens(self.table_np["lengths"], self.ids[b], self.lens[b],
                                  self.cfg.max_token_num, self.cfg.max_item_embeddings - 1)

    def window_flops(self, start: int, stop: int) -> float:
        cfg = self.cfg
        return sum(flops.encoder_forward(cfg, self._valid(k))
                   + flops.scoring_forward(cfg, self.B, self.n_items) for k in range(start, stop))

    def kernel_work(self, start: int, stop: int) -> dict:
        return {"attn_fwd": [flops.attn_fwd_work(self.cfg, self._valid(k), w)
                             for k in range(start, stop) for w in self.cfg.attention_window]}

    def valid_share(self) -> float:
        n = np.concatenate([self._valid(k) for k in range(len(self.ids))])
        return float(n.sum() / (len(n) * self.cfg.max_token_num))

    # -- the check ---------------------------------------------------------
    def free(self):
        self._state = self._request = None

    def sample(self, start: int, stop: int) -> list:
        """Request indices to check: ``check_requests`` drawn from the seed
        among the window's, with the request holding the longest history."""
        ks = np.arange(start, stop)
        rng = np.random.default_rng(stream_seed(self.cell.seed, "check"))
        pick = set(rng.choice(ks, size=min(self.t["check_requests"], len(ks)),
                              replace=False).tolist())
        pick.add(int(ks[np.argmax([self.lens[k % len(self.ids)].max() for k in ks])]))
        return sorted(pick)

    def answers_of(self, precision: str, ks) -> dict:
        """(scores, ids) top-k of requests ``ks`` by the reference computed
        in ``precision``: its catalog, its towers, its scores."""
        cfg = self.cfg
        P = rm.as_params(make_weights(cfg, self.head, self.weight_seed, self.dev), grad=False)
        num = rm.Numerics(precision)
        items = reference_pooled(P, cfg, self.table_np, np.arange(self.n_items)[:, None],
                                 np.ones(self.n_items, np.int64), cfg.item_seq_len, num, self.dev)
        out = {}
        for k in ks:
            b = k % len(self.ids)
            user = reference_pooled(P, cfg, self.table_np, self.ids[b], self.lens[b],
                                    cfg.max_token_num, num, self.dev, chunk=self.B)
            out[k] = rm.scores(user, items, cfg.temp).cpu().numpy()
        return out

    def readings(self, answers: dict) -> dict:
        """Gaps of ``answers`` ((scores, ids) of each sampled request) from
        the reference's scores."""
        if self._ref is None:
            self._ref = self.answers_of("fp32", sorted(answers))
        topk_gap = score_gap = 0.0
        for k, (got_s, got_i) in answers.items():
            ref = self._ref[k]
            best = -np.sort(-ref, axis=1)[:, :self.k]
            at = np.take_along_axis(ref, got_i.astype(np.int64), axis=1)
            topk_gap = max(topk_gap, float((best - at).max()))
            score_gap = max(score_gap, float(np.abs(got_s - at).max()))
        return {"topk_gap": topk_gap, "score_gap": score_gap}

    def check(self) -> dict:
        ks = self.sample(self.window_start, self.units_done)
        return self.readings({k: self.answers[k] for k in ks})

    def control(self) -> dict:
        """The reference computed in fp8, in the program's place."""
        ks = self.sample(self.window_start, self.units_done)
        out = {}
        for k, ref in self.answers_of("fp8", ks).items():
            s = torch.topk(torch.from_numpy(ref), self.k, dim=-1)
            out[k] = (s.values.numpy(), s.indices.numpy())
        return self.readings(out)
