"""Fraud training: ``training.steps.make_fraud_train_step`` at
``cli.finetune_classification``'s recipe (batch 16, dropout 0.1 and the
head's 0.2, BCE with the split's ``pos_weight``, AdamW every step) on card
histories. A unit is one step: the batch assembled on the device, the
backbone and the fraud head forward and backward, one update."""

from __future__ import annotations

import numpy as np
import torch

from .. import flops
from ..reference import batches as rb
from ..reference import model as rm
from ..reference.optim import AdamW
from ..reference.rng import StepDraws, fold_in
from ..traffic.generate import HashTokenizer, pack_table, pad_histories, stream_seed, transaction_corpus
from ..weights import make_weights
from .common import (TrainChecks, TrainRecord, build_model, mark, reference_record,
                     table_to_device)


def pos_weight(labels: np.ndarray, scale: float) -> float:
    """The split's negatives over positives times ``scale``, at least 1."""
    pos = float(labels.sum())
    return 1.0 if pos == 0 else max(1.0, (len(labels) - pos) / pos * scale)


class Driver(TrainChecks):
    unit_name = "step"
    head = "fraud"

    def __init__(self, cell):
        from recformer_tpu_torch.models.heads import RecformerForFraudDetection
        from recformer_tpu_torch.training.optimizer import create_optimizer
        from recformer_tpu_torch.training.steps import make_fraud_train_step

        t, dev = cell.traffic, cell.device
        self.t, self.dev, self.B = t, dev, t["batch_size"]
        attrs, seqs, labels = transaction_corpus(cell.seed, "transactions", t["corpus"])
        self.pos_weight = pos_weight(labels, t["pos_weight_scale"])
        cfg = cell.config.replace(pos_weight=self.pos_weight)
        self.cfg = cfg
        self.table_np = pack_table(attrs, HashTokenizer(cfg.vocab_size), cfg.max_attr_num,
                                   cfg.max_attr_length)
        ids, lens = pad_histories(seqs, max(len(s) for s in seqs))
        order = np.random.default_rng(stream_seed(cell.seed, "order")).permutation(len(seqs))
        nb = len(seqs) // self.B
        o = order[:nb * self.B]
        self.ids, self.lens = ids[o].reshape(nb, self.B, -1), lens[o].reshape(nb, self.B)
        self.labels = labels[o].reshape(nb, self.B)
        self.table = table_to_device(self.table_np, dev)
        self.dev_batches = [torch.from_numpy(a).to(dev)
                            for a in (self.ids, self.lens, self.labels)]
        self.valid = torch.ones(self.B, dtype=torch.bool, device=dev)
        self.step_seed = stream_seed(cell.seed, "steps") & 0x7FFFFFFF
        self.weight_seed = stream_seed(cell.seed, "weights")
        self.total_steps = nb * t["epochs"]
        mark("corpus")
        self.model = build_model(RecformerForFraudDetection, cfg,
                                 make_weights(cfg, self.head, self.weight_seed, dev), dev)
        self.optimizer = create_optimizer(
            self.model, learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
            warmup_steps=t["warmup_steps"], total_steps=self.total_steps)
        self._step_fn = make_fraud_train_step(cfg, self.model, self.optimizer)
        self.units_done = 0
        mark("model")
        rec = TrainRecord(self.model, self.optimizer, cfg, self.head, self.weight_seed, dev)
        for _ in range(t["checked_updates"]):
            rec.after_micro_step(self._step()["loss"], True)
        self.program_record = rec.finish(1)
        mark("checked updates")

    def _step(self):
        ids, lens, labels = (a[self.units_done % len(self.ids)] for a in self.dev_batches)
        m = self._step_fn(self.step_seed, self.table, ids, lens, labels, self.valid)
        self.units_done += 1
        return m

    def unit(self):
        self._step()

    def align(self):
        pass

    profile_units = 8

    def end_to_end(self, window) -> dict:
        return {"train_examples_per_s": window.units * self.B / window.wall_s}

    # -- counts ----------------------------------------------------------
    def _valid(self, k: int) -> np.ndarray:
        b = k % len(self.ids)
        return flops.valid_tokens(self.table_np["lengths"], self.ids[b], self.lens[b],
                                  self.cfg.max_token_num, self.cfg.max_item_embeddings - 1)

    def window_flops(self, start: int, stop: int) -> float:
        cfg = self.cfg
        return sum(flops.TRAIN_FACTOR * (flops.encoder_forward(cfg, self._valid(k))
                                         + flops.fraud_head_forward(cfg, self.B))
                   for k in range(start, stop))

    def kernel_work(self, start: int, stop: int) -> dict:
        fwd, bwd = [], []
        for k in range(start, stop):
            n = self._valid(k)
            for w in self.cfg.attention_window:
                fwd.append(flops.attn_fwd_work(self.cfg, n, w))
                bwd.append(flops.attn_bwd_work(self.cfg, n, w))
        return {"attn_fwd": fwd, "attn_bwd": bwd}

    def valid_share(self) -> float:
        n = np.concatenate([self._valid(k) for k in range(len(self.ids))])
        return float(n.sum() / (len(n) * self.cfg.max_token_num))

    # -- the check ---------------------------------------------------------
    def free(self):
        del self.model, self.optimizer, self._step_fn
        self.table = self.dev_batches = None

    def reference_record(self, precision: str = "fp32", fault: str | None = None) -> dict:
        cfg, t = self.cfg, self.t
        w0 = make_weights(cfg, self.head, self.weight_seed, self.dev)
        P = rm.as_params(w0, grad=True)
        opt = AdamW(P, t["learning_rate"], t["warmup_steps"], self.total_steps,
                    weight_decay=t["weight_decay"])
        num = rm.Numerics(precision)
        losses = []
        for k in range(t["checked_updates"]):
            b = k % len(self.ids)
            ids, lens = self.ids[b], self.lens[b]
            labels = torch.from_numpy(self.labels[b]).to(self.dev)
            valid = torch.ones(self.B, device=self.dev)
            if fault == "half_batch":
                h = self.B // 2
                ids, lens, labels, valid = ids[:h], lens[:h], labels[:h], valid[:h]
            batch = rb.assemble(self.table_np, ids, lens, cfg.max_token_num, cfg, self.dev)
            draws = StepDraws(fold_in(self.step_seed, k), self.dev)
            logits = rm.fraud_logits(P, cfg, batch, draws, num)
            loss = rm.fraud_loss(logits, labels, valid, self.pos_weight)
            loss.backward()
            losses.append(float(loss.detach()))
            opt.step()
        return reference_record(opt, losses, 1, w0)
