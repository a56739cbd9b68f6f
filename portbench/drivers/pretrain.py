"""Pretraining: ``training.steps.make_pretrain_step`` at ``cli.pretrain``'s
recipe (batch 8, accumulation 8, dropout 0.1, MLM and in-batch
contrastive, clipping and AdamW). A unit is one micro-step: pair sampling
and MLM on the device, both towers forward and backward, the optimizer's
accumulation (an update every ``accum``-th)."""

from __future__ import annotations

import numpy as np
import torch

from .. import flops
from ..reference import batches as rb
from ..reference import model as rm
from ..reference.optim import AdamW
from ..reference.rng import StepDraws, fold_in
from ..traffic.generate import HashTokenizer, pack_table, pad_histories, seqrec_corpus, stream_seed
from ..weights import make_weights
from .common import (TrainChecks, TrainRecord, build_model, mark, reference_record,
                     table_to_device)


class Driver(TrainChecks):
    unit_name = "micro-step"
    head = "pretrain"

    def __init__(self, cell):
        from recformer_tpu_torch.models.heads import RecformerForPretraining
        from recformer_tpu_torch.training.optimizer import create_optimizer
        from recformer_tpu_torch.training.steps import make_pretrain_step
        from recformer_tpu_torch.utils.rng import StepRNG
        from recformer_tpu_torch.utils.rng import fold_in as program_fold_in

        self.cell, cfg, t, dev = cell, cell.config, cell.traffic, cell.device
        self.cfg, self.t, self.dev = cfg, t, dev
        self.B, self.accum = t["batch_size"], t["grad_accum_steps"]
        attrs, users = seqrec_corpus(cell.seed, "pretrain", t["corpus"])
        self.table_np = pack_table(attrs, HashTokenizer(cfg.vocab_size), cfg.max_attr_num,
                                   cfg.max_attr_length)
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
        mark("corpus")
        self.model = build_model(RecformerForPretraining, cfg,
                                 make_weights(cfg, self.head, self.weight_seed, dev), dev)
        self.optimizer = create_optimizer(
            self.model, learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
            warmup_steps=t["warmup_steps"], total_steps=t["total_steps"],
            grad_accum_steps=self.accum)
        step = make_pretrain_step(cfg, self.model, self.optimizer)

        def run(k):
            b = k % len(self.ids)
            rng = StepRNG(program_fold_in(self.step_seed, k), dev)
            return step(rng, self.table, self.ids_dev[b], self.lens_dev[b])

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
    def _views(self, k: int, draws: StepDraws):
        """Unit k's two views as the reference builds them from the step's
        draws: [(batch, corrupted ids, masked)]."""
        cfg, b = self.cfg, k % len(self.ids)
        ids, lens = self.ids[b], self.lens[b]
        u = draws.rand(self.B)
        target = rb.pretrain_targets(u, torch.from_numpy(lens).to(self.dev)).cpu().numpy()
        a = rb.assemble(self.table_np, ids, target, cfg.max_token_num, cfg, self.dev)
        tgt = ids[np.arange(self.B), target][:, None]
        bb = rb.assemble(self.table_np, tgt, np.ones(self.B, np.int64), cfg.item_seq_len, cfg,
                         self.dev)
        views = []
        for batch in (a, bb):
            L = batch["input_ids"].shape[1]
            pri = draws.rand(self.B, L + 1)
            uu = draws.rand(self.B, L)
            rid = draws.randint(cfg.vocab_size, self.B, L)
            c, m = rb.mlm(batch, pri, uu, rid, cfg, rb.max_predictions(L, cfg.mlm_probability))
            views.append((batch, c, m))
        return views

    def _unit_counts(self, k: int):
        """(valid tokens of view a, of view b, masked tokens) of unit k."""
        draws = StepDraws(fold_in(self.step_seed, k), self.dev)
        views = self._views(k, draws)
        n = [v[0]["attention_mask"].sum(1).cpu().numpy() for v in views]
        return n[0], n[1], int(sum(int(v[2].sum()) for v in views))

    def window_flops(self, start: int, stop: int) -> float:
        cfg, total = self.cfg, 0.0
        for k in range(start, stop):
            na, nb, masked = self._unit_counts(k)
            # each view's clean and corrupted rows, forward and backward
            fwd = (2 * flops.encoder_forward(cfg, na) + 2 * flops.encoder_forward(cfg, nb)
                   + flops.mlm_head_forward(cfg, masked) + flops.contrastive_forward(cfg, self.B))
            total += flops.TRAIN_FACTOR * fwd
        return total

    def kernel_work(self, start: int, stop: int) -> dict:
        cfg = self.cfg
        fwd, bwd = [], []
        for k in range(start, stop):
            na, nb, _ = self._unit_counts(k)
            for n in (np.concatenate([na, na]), np.concatenate([nb, nb])):
                for w in cfg.attention_window:
                    fwd.append(flops.attn_fwd_work(cfg, n, w))
                    bwd.append(flops.attn_bwd_work(cfg, n, w))
        return {"attn_fwd": fwd, "attn_bwd": bwd}

    def valid_share(self) -> float:
        """Over the first accumulation cycle's micro-steps."""
        counts = [self._unit_counts(k) for k in range(self.accum)]
        valid = sum(int(na.sum() + nb.sum()) for na, nb, _ in counts)
        return valid / (self.accum * self.B * (self.cfg.max_token_num + self.cfg.item_seq_len))

    # -- the check ---------------------------------------------------------
    def free(self):
        del self.model, self.optimizer, self._run
        self.table = self.ids_dev = self.lens_dev = None

    def reference_record(self, precision: str = "fp32", fault: str | None = None) -> dict:
        cfg, t = self.cfg, self.t
        w0 = make_weights(cfg, self.head, self.weight_seed, self.dev)
        P = rm.as_params(w0, grad=True)
        opt = AdamW(P, t["learning_rate"], t["warmup_steps"], t["total_steps"],
                    accum=self.accum, weight_decay=t["weight_decay"])
        num = rm.Numerics(precision)
        losses = []
        for k in range(t["checked_updates"] * self.accum):
            draws = StepDraws(fold_in(self.step_seed, k), self.dev)
            views = self._views(k, draws)
            if fault == "half_batch":
                h = self.B // 2
                views = [({n: v[:h] for n, v in b.items()}, c[:h], m[:h]) for b, c, m in views]
            loss = rm.pretrain_loss(P, cfg, views, draws, num)
            loss.backward()
            losses.append(float(loss.detach()))
            opt.step()
        return reference_record(opt, losses, self.accum, w0)
