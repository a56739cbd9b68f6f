"""Finetuning: ``training.steps.make_finetune_step`` at ``cli.finetune``'s
defaults (batch 16, accumulation 8, dropout 0.1, 1,000 sampled negatives,
AdamW at 5e-5 after 100 warm-up steps, no weight decay), eager. Set-up
encodes the catalog with the initial weights (``encode_all_items``) and
keeps it frozen through the run, as stage two of the two-stage loop does.
A unit is one micro-step: the target and the prefix view on the device,
the sequence tower forward with dropout, the sampled softmax against the
catalog, the backward, the optimizer's accumulation (an update every
``accum``-th).

The check follows the first ``checked_updates`` updates in the reference
(``reference/finetune.py``), drawing what the step draws from the same
seeds, against the reference's own float32 catalog."""

from __future__ import annotations

import numpy as np
import torch

from .. import flops
from ..reference import finetune as rf
from ..reference import model as rm
from ..reference.optim import AdamW
from ..reference.rng import StepDraws, fold_in
from ..traffic.generate import HashTokenizer, pack_table, pad_histories, seqrec_corpus, stream_seed
from ..weights import make_weights
from .common import (TrainChecks, TrainRecord, build_model, mark, reference_pooled,
                     reference_record, table_to_device)


class Driver(TrainChecks):
    unit_name = "micro-step"
    head = "seqrec"

    def __init__(self, cell):
        from recformer_tpu_torch.models.heads import RecformerForSeqRec
        from recformer_tpu_torch.training.loops import encode_all_items
        from recformer_tpu_torch.training.optimizer import create_optimizer
        from recformer_tpu_torch.training.steps import make_finetune_step

        t, dev = cell.traffic, cell.device
        cfg = cell.config.replace(finetune_negative_sample_size=t["negatives"])
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, dev
        self.B, self.accum = t["batch_size"], t["grad_accum_steps"]
        attrs, users = seqrec_corpus(cell.seed, "finetune", t["corpus"])
        self.table_np = pack_table(attrs, HashTokenizer(cfg.vocab_size), cfg.max_attr_num,
                                   cfg.max_attr_length)
        self.n_items = len(attrs)
        ids, lens = pad_histories(users, t["corpus"]["history_length"]["max"])
        order = np.random.default_rng(stream_seed(cell.seed, "order")).permutation(len(users))
        nb = len(users) // self.B
        self.ids = ids[order[:nb * self.B]].reshape(nb, self.B, -1)
        self.lens = lens[order[:nb * self.B]].reshape(nb, self.B)
        self.table = table_to_device(self.table_np, dev)
        self.ids_dev = torch.from_numpy(self.ids).to(dev)
        self.lens_dev = torch.from_numpy(self.lens).to(dev)
        self.step_seed = stream_seed(cell.seed, "steps") & 0x7FFFFFFF
        self.weight_seed = stream_seed(cell.seed, "weights")
        # cli.finetune's schedule: two stages of ``epochs`` epochs
        self.total_steps = nb * t["epochs"] * 2
        mark("corpus")
        self.model = build_model(RecformerForSeqRec, cfg,
                                 make_weights(cfg, self.head, self.weight_seed, dev), dev)
        self.items = encode_all_items(self.model, self.table, cfg, t["encode_batch_size"])
        self.optimizer = create_optimizer(
            self.model, learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
            warmup_steps=t["warmup_steps"], total_steps=self.total_steps,
            grad_accum_steps=self.accum)
        step = make_finetune_step(cfg, self.model, self.optimizer)

        def run(k):
            b = k % len(self.ids)
            return step(self.step_seed, self.table, self.ids_dev[b], self.lens_dev[b],
                        self.items)

        self._run = run
        self.units_done = 0
        mark("model")
        rec = TrainRecord(self.model, self.optimizer, cfg, self.head, self.weight_seed, dev)
        for _ in range(t["checked_updates"] * self.accum):
            before = self.optimizer.updates
            m = self._step()
            rec.after_micro_step(m["loss"], self.optimizer.updates > before)
        self.program_record = rec.finish(self.accum)
        mark("checked updates")

    def _step(self):
        m = self._run(self.units_done)
        self.units_done += 1
        return m

    def unit(self):
        self._step()

    def align(self):
        """Micro-steps until the next one starts an accumulation cycle."""
        while self.optimizer.mini_step:
            self._step()

    profile_units = property(lambda self: self.accum)

    def end_to_end(self, window) -> dict:
        return {"train_examples_per_s": window.units * self.B / window.wall_s}

    # -- counts ----------------------------------------------------------
    def _valid(self, k: int) -> np.ndarray:
        """Valid tokens of unit k's rows: the history before the drawn target."""
        b = k % len(self.ids)
        u = StepDraws(fold_in(self.step_seed, k), self.dev).rand(self.B)
        t = rf.targets(u, torch.from_numpy(self.lens[b]).to(u.device)).cpu().numpy()
        return flops.valid_tokens(self.table_np["lengths"], self.ids[b], t,
                                  self.cfg.max_token_num, self.cfg.max_item_embeddings - 1)

    def window_flops(self, start: int, stop: int) -> float:
        cfg, cand = self.cfg, 1 + self.t["negatives"]
        return sum(flops.TRAIN_FACTOR * (flops.encoder_forward(cfg, self._valid(k))
                                         + flops.scoring_forward(cfg, self.B, cand))
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
        """Over the first accumulation cycle's micro-steps."""
        n = np.concatenate([self._valid(k) for k in range(self.accum)])
        return float(n.sum() / (len(n) * self.cfg.max_token_num))

    # -- the check ---------------------------------------------------------
    def free(self):
        del self.model, self.optimizer, self._run
        self.table = self.ids_dev = self.lens_dev = self.items = None

    def reference_record(self, precision: str = "fp32", fault: str | None = None) -> dict:
        cfg, t = self.cfg, self.t
        w0 = make_weights(cfg, self.head, self.weight_seed, self.dev)
        P = rm.as_params(w0, grad=True)
        num = rm.Numerics(precision)
        with torch.no_grad():
            items = reference_pooled(P, cfg, self.table_np, np.arange(self.n_items)[:, None],
                                     np.ones(self.n_items, np.int64), cfg.item_seq_len, num,
                                     self.dev)
        opt = AdamW(P, t["learning_rate"], t["warmup_steps"], self.total_steps,
                    accum=self.accum, weight_decay=t["weight_decay"])
        rows = self.B // 2 if fault == "half_batch" else None
        losses = []
        for k in range(t["checked_updates"] * self.accum):
            b = k % len(self.ids)
            draws = StepDraws(fold_in(self.step_seed, k), self.dev)
            loss = rf.step_loss(P, cfg, self.table_np, self.ids[b], self.lens[b], items,
                                t["negatives"], draws, num, rows)
            loss.backward()
            losses.append(float(loss.detach()))
            opt.step()
        return reference_record(opt, losses, self.accum, w0)
