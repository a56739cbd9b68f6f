"""Ranking on the deepseek_v3 backbone (Moonlight-16B-A3B): ``rank.py``'s
unit and window (``cli.serve``'s path, one client in a closed loop;
set-up encodes the catalog), with the backbone's own weights
(``weights_deepseek_v3.py``, drawn in bf16 and handed to a model built on
the meta device, so the card holds one copy), plain reference
(``reference/deepseek_v3.py``: each layer upcast to float32 as it runs,
cut to the valid tokens), operation counts (``flops_deepseek_v3.py``) and
kernel work: each layer's causal attention (``global_attn_fwd``) and each
routed layer's grouped GEMMs (``moe_gemm``).

The check holds the program one layer at a time. bf16 moves near-tied
router scores, and a token whose choice of experts flips moves by a whole
expert's output, so over 27 layers a history's pooled state, and its
ranking, drift about as far from the float32 reference in bf16 as in fp8
(the control). Held from the program's own input to it, each layer reads
its own rounding. After the window the program runs each checked request
and the catalog's first chunk once more, eagerly (``forward_eager``, which
the serving graphs replay), keeping the states of the rows :func:`ROWS`
names: ``layer_gap`` and ``layer_gap_mean`` hold each layer of those rows
against the reference's from the same input (:meth:`Driver.layer_readings`),
and ``served_gap`` holds what the window served, each checked request's
pooled users and the catalog's chunk, to that run's. A program without the
deepseek_v3 backbone (no such ``backbone`` in its config) is refused at
once. Beside the fp8 control, the ``half_batch`` fault serves the second
half of each checked request a zero pooled state."""

from __future__ import annotations

import gc
from typing import NamedTuple

import numpy as np
import torch

from .. import flops, flops_deepseek_v3
from ..reference import batches as rb
from ..reference import deepseek_v3 as rds
from ..reference import model as rm
from ..traffic.generate import HashTokenizer, pack_table, pad_histories, seqrec_corpus, stream_seed
from ..weights_deepseek_v3 import make_weights
from . import rank
from .common import mark, table_to_device


# the backbone's inputs, as ``RecformerForSeqRec`` hands them on
_INPUTS = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
           "item_position_ids")


def ROWS(B: int) -> tuple:
    """The rows of a checked batch of ``B`` whose layers are held: the
    first of each half."""
    return (0, B // 2)


class Capture(NamedTuple):
    """A checked batch's run: the embeddings and each layer's output of the
    rows :func:`ROWS` names, ``(rows, n, hs)`` on the host, cut to ``n``,
    the longest valid length among them; and the pooled float32 output of
    every row (zero where a stand-in did not run a row)."""
    states: list
    pooled: torch.Tensor


class Driver(rank.Driver):
    def __init__(self, cell):
        if getattr(cell.config, "backbone", None) != "deepseek_v3":
            raise SystemExit("rank_deepseek_v3: the program's config has no deepseek_v3 backbone")
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
        with torch.device("meta"):
            model = RecformerForSeqRec(cfg)
        model.load_state_dict(make_weights(cfg, self.head, self.weight_seed, dev), strict=True,
                              assign=True)
        model.eval()
        mark("model")
        item_emb = encode_all_items(model, table, cfg, t["encode_batch_size"]).float()

        def request(ids_np, lens_np):
            with torch.no_grad():
                b = assemble_for_config(table, torch.from_numpy(ids_np).to(dev),
                                        torch.from_numpy(lens_np).to(dev), cfg)
                pooled = model(b).float()
                scores_k, ids_k = torch.topk(similarity_scores(pooled, item_emb, cfg.temp),
                                             self.k, dim=-1)
            return scores_k.cpu().numpy(), ids_k.cpu().numpy(), pooled.cpu()

        self._request = request
        self._state = (model, table, item_emb)
        self.units_done = 0
        self._served = self._got = self._P = None
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
        return sum(flops_deepseek_v3.encoder_forward(cfg, self._valid(k))
                   + flops.scoring_forward(cfg, self.B, self.n_items) for k in range(start, stop))

    def kernel_work(self, start: int, stop: int) -> dict:
        cfg, attn, gemm = self.cfg, [], []
        for k in range(start, stop):
            n = self._valid(k)
            attn += [flops_deepseek_v3.attn_work(cfg, n)] * cfg.num_hidden_layers
            gemm += [flops_deepseek_v3.moe_gemm_work(cfg, n)] * sum(
                1 for i in range(cfg.num_hidden_layers) if cfg.is_moe_layer(i))
        return {"global_attn_fwd": attn, "moe_gemm": gemm}

    # -- the check ---------------------------------------------------------
    def _checked(self, ks) -> dict:
        """{key: (item ids, lengths, out_len)} of the batches the check
        holds, as the program ran them: each request of ``ks`` (key the
        request) and the catalog's first chunk (key ``'catalog'``, padded
        with item 0 as ``encode_item_rows`` pads it)."""
        out = {k: (self.ids[k % len(self.ids)], self.lens[k % len(self.ids)],
                   self.cfg.max_token_num) for k in ks}
        ids = np.zeros((self.t["encode_batch_size"], 1), np.int32)
        ids[:self.n_catalog, 0] = np.arange(self.n_catalog)
        out["catalog"] = (ids, np.ones(len(ids), np.int32), self.cfg.item_seq_len)
        return out

    @property
    def n_catalog(self) -> int:
        """Items in the catalog's first chunk."""
        return min(self.t["encode_batch_size"], self.n_items)

    def _rows(self, key) -> list:
        return list(ROWS(self.n_catalog if key == "catalog" else self.B))

    def free(self):
        """What the window served to the checked batches, the program's
        runs of them (:meth:`_program_runs`), then its model, catalog and
        graphs, collected now: the reference's bf16 weights take their
        place on the card."""
        ks = self.sample(self.window_start, self.units_done)
        self._served = {k: self.answers[k][2] for k in ks}
        self._served["catalog"] = self._state[2][:self.n_catalog].float().cpu()
        self._got = self._program_runs(ks)
        super().free()
        gc.collect()

    def _program_runs(self, ks) -> dict:
        """{key: :class:`Capture`} of the program's eager forward
        (``forward_eager``, which the serving graphs replay) over each
        checked batch, the serving graphs and their pool dropped first."""
        from recformer_tpu_torch.data.device_pipeline import assemble_for_config
        from recformer_tpu_torch.utils.graphs import Graphs

        model, table, _ = self._state
        bb = model.longformer
        bb.serve_graphs = Graphs(bb.serve_graphs.prefix)
        if torch.device(self.dev).type == "cuda":
            torch.cuda.empty_cache()
        out = {}
        for key, (ids, lens, out_len) in self._checked(ks).items():
            rows = self._rows(key)
            batch = assemble_for_config(table, torch.from_numpy(ids).to(self.dev),
                                        torch.from_numpy(lens).to(self.dev), self.cfg,
                                        out_len=out_len)
            n = max(int(batch["attention_mask"][rows].sum(1).max()), 1)
            states = []

            def keep(x):
                states.append(x[rows, :n].cpu())

            hooks = [bb.layers[0].register_forward_pre_hook(lambda m, a: keep(a[0]))]
            hooks += [lyr.register_forward_hook(lambda m, a, o: keep(o)) for lyr in bb.layers]
            try:
                with torch.no_grad():
                    pooled = bb.forward_eager(*(batch[name] for name in _INPUTS))[1]
                out[key] = Capture(states, pooled.float().cpu())
            finally:
                for h in hooks:
                    h.remove()
        return out

    def _weights(self):
        """The parameters as the program held them, drawn once for the check."""
        if self._P is None:
            self._P = make_weights(self.cfg, self.head, self.weight_seed, self.dev)
        return self._P

    def _reference_runs(self, precision: str, ks) -> dict:
        """{key: :class:`Capture`} of the checked batches' rows that
        :func:`ROWS` names, by the reference computed in ``precision``,
        each row alone."""
        cfg, P, num = self.cfg, self._weights(), rm.Numerics(precision)
        out = {}
        for key, (ids, lens, out_len) in self._checked(ks).items():
            rows, per_row = self._rows(key), []
            pooled = torch.zeros(len(ids), cfg.hidden_size)
            for r in rows:
                batch = rb.assemble(self.table_np, ids[r:r + 1], lens[r:r + 1], out_len, cfg,
                                    self.dev)
                states = []
                pooled[r] = rds.encode(P, cfg, batch, num, states)[1][0].cpu()
                per_row.append([x.cpu() for x in states])
            out[key] = Capture(_stack(per_row, cfg.compute_dtype), pooled)
        return out

    def readings(self, served: dict, got: dict) -> dict:
        """``served_gap``, the largest gap of an element of what was served
        (``served``: {key: pooled float32 rows}, the catalog's chunk without
        its padding) from the same element of the runs ``got``, over the
        largest element of the run; and :meth:`layer_readings` of ``got``."""
        gaps = []
        for k, cap in got.items():
            run = cap.pooled[:len(served[k])]
            gaps.append(float((served[k] - run).abs().max() / run.abs().max().clamp_min(1e-30)))
        out = {"served_gap": max(gaps)}
        out.update(self.layer_readings(got))
        return out

    @torch.no_grad()
    def layer_readings(self, got: dict) -> dict:
        """Each layer of the runs ``got`` held alone against the float32
        reference's from the same input: a token's gap is
        ``|d - d_ref| / |d_ref|``, ``d`` the layer's change to the token's
        state (its output less its input) and ``d_ref`` the reference's
        from that input; for the embeddings, the state's own gap; for the
        final norm, the pooled output's gap from the reference's norm of
        the last layer's output at the last valid token. ``layer_gap`` is
        the largest, over the held rows and the layers, of the median
        token's gap: a choice of experts flipped by a near tie moves a few
        tokens by a whole expert's output, and the median passes them
        over. ``layer_gap_mean`` is the largest over the histories' rows
        and their layers of the mean token's gap, which also sees a fault
        that reaches a minority of the tokens (a history holds thousands;
        over an item's few dozen, one or two flips move the mean by half
        its reading, so the catalog's rows are left out of it)."""
        cfg, P, dev = self.cfg, self._weights(), self.dev
        num = rm.Numerics("fp32")
        checked = self._checked([k for k in got if k != "catalog"])
        med, mean = [], []
        for key, cap in got.items():
            ids, lens, out_len = checked[key]
            rows = self._rows(key)
            batch = rb.assemble(self.table_np, ids[rows], lens[rows], out_len, cfg, dev)
            n = cap.states[0].shape[1]
            mask = batch["attention_mask"][:, :n]
            x = cap.states[0].to(dev).float()
            gaps = [_gap(x, rds.embed(P, batch, n, num))]
            for i in range(cfg.num_hidden_layers):
                y = cap.states[i + 1].to(dev).float()
                gaps.append(_gap(y - x, rds.layer(P, i, cfg, x, mask, num) - x))
                x = y
            last = (mask.sum(1) - 1).clamp_min(0)
            ref = rds.final_norm(P, cfg, x[torch.arange(len(rows), device=dev), last], num)
            pooled = _gap(cap.pooled[rows].to(dev), ref)
            for r in range(len(rows)):
                for g in gaps:
                    g = g[r][mask[r] != 0]
                    med.append(float(g.median()))
                    if key != "catalog":
                        mean.append(float(g.mean()))
                med.append(float(pooled[r]))
                if key != "catalog":
                    mean.append(float(pooled[r]))
        return {"layer_gap": max(med), "layer_gap_mean": max(mean)}

    def check(self) -> dict:
        return self.readings(self._served, self._got)

    def control(self) -> dict:
        """The reference computed in fp8, in the program's place."""
        runs = self._reference_runs("fp8", self.sample(self.window_start, self.units_done))
        return self.readings({k: c.pooled for k, c in runs.items()}, runs)

    def fault(self, name: str) -> dict:
        """The reference in the program's place with a fault planted
        (``half_batch``: the second half of each checked request served a
        zero pooled state, as a program that left half the batch out of
        its timed path would serve)."""
        if name != "half_batch":
            raise ValueError(f"unknown fault {name!r}")
        runs = self._reference_runs("fp32", self.sample(self.window_start, self.units_done))
        served = {k: c.pooled.clone() for k, c in runs.items()}
        for k in served:
            if k != "catalog":
                served[k][self.B // 2:] = 0.0
        return self.readings(served, runs)


def _gap(got, ref):
    """``|got - ref| / |ref|`` over the last dimension."""
    return (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)


def _stack(per_row: list, dtype) -> list:
    """Per-row lists of (1, n_r, hs) states as one list of (rows, n, hs)
    states in ``dtype`` on the host, zero past each row's own length."""
    n = max(s[0].shape[1] for s in per_row)
    out = []
    for i in range(len(per_row[0])):
        x = torch.zeros(len(per_row), n, per_row[0][i].shape[-1], dtype=dtype)
        for r, s in enumerate(per_row):
            x[r, :s[i].shape[1]] = s[i][0].to("cpu", dtype)
        out.append(x)
    return out
