"""Pipeline parallelism: the encoder's layers staged over the mesh's ``pipe``
axis, on a GPipe schedule.

Counterpart of ``recformer_tpu/parallel/pipeline.py``. Stage ``s`` of ``S``
runs layers ``[s*L/S, (s+1)*L/S)`` of the encoder (the stacked
``scan_layers`` layout in JAX; the port's layer list is the same stack, and
``--pipeline`` asks for ``scan_layers`` as the JAX CLI does). Every rank
holds the whole model and its optimizer state, as JAX replicates the whole
TrainState; a rank runs only its stage's layers.

The schedule is explicit, not left to the autograd engine (which could
order the microbatches' point-to-point transfers differently on different
ranks): the batch splits into M microbatches; in the forward, stage ``s``
takes each microbatch from stage ``s-1`` (stage 0 from the embeddings),
runs its layers and sends the activations on; the last stage's outputs are
broadcast to every stage (JAX's ``psum`` of the last stage's outputs). In
the backward, the microbatches run in reverse order, each through
``torch.autograd.backward`` of the stage's outputs, each input gradient sent
upstream; only stage 0 returns a gradient of the pipeline's input (the
embeddings' gradients count on stage 0 alone, see ``owned_by_stage``, so
the later stages skip the embeddings' backward). Each stage runs its M
microbatches only, not
JAX's M + S - 1 masked ticks: the outputs are the same, and kernels 1 and 2
launch ``L/S x M`` times a tower on each rank. Embeddings, the pooler and
the MLM head run on every rank alike, outside the pipeline.

Dropout: one seed a tower from the step's host generator (the same draw on
every stage), folded with the global layer index and the microbatch, so
every (layer, microbatch) draws its own masks. Under ``remat`` each stage
layer runs under ``models.encoder.remat_layer`` (the JAX stages call the
layer directly and drop ``--remat``; the port keeps it).

Gradients: a rank holds its stage's layers' gradients, and the whole
gradients of the pooler and heads (stage 0 the embeddings' too);
``owned_by_stage`` keeps the former and, on stage 0 only, the latter, and
``training.steps.model_axis_backward`` sums them over the world.
"""

from __future__ import annotations

import re

import torch

from ..utils.rng import StepRNG, fold_in
from .collectives import broadcast, isend, recv
from .mesh import PIPE_AXIS

_LAYER = re.compile(r"(^|\.)encoder\.layer\.(\d+)\.")


def _stage_layers(cfg, S: int, s: int) -> range:
    if cfg.num_hidden_layers % S:
        raise ValueError(f"num_hidden_layers={cfg.num_hidden_layers} not divisible by "
                         f"pipe axis {S}")
    n = cfg.num_hidden_layers // S
    return range(s * n, (s + 1) * n)


def owned_by_stage(cfg, S: int, s: int):
    """``own(name)``: whether stage ``s`` contributes the gradient of the
    parameter ``name`` to the sum over the stages: its layers', and the
    layers' of no stage (embeddings, pooler, heads) on stage 0."""
    layers = _stage_layers(cfg, S, s)

    def own(name: str) -> bool:
        m = _LAYER.search(name)
        return int(m.group(2)) in layers if m else s == 0

    return own


def _layer_rng(seed: int, layer: int, mb: int, device) -> StepRNG:
    return StepRNG(fold_in(fold_in(seed, layer), mb), device)


class _Stage:
    """One call's schedule on this rank: its stage's layers, the mesh, M,
    the dropout seed (None: no dropout) and whether to build the graph."""

    def __init__(self, encoder, mesh, microbatches: int, seed, grad: bool):
        cfg = encoder.config
        self.layers = _stage_layers(cfg, mesh.n_model, mesh.model_rank)
        self.modules = [encoder.layer[i] for i in self.layers]
        self.cfg, self.mesh, self.M, self.seed, self.grad = cfg, mesh, microbatches, seed, grad

    def run(self, h, mask, mb):
        from ..models.encoder import remat_layer

        remat = self.cfg.remat and self.grad
        for i, layer in zip(self.layers, self.modules):
            rng = None if self.seed is None else _layer_rng(self.seed, i, mb, h.device)
            h = (remat_layer(layer, h, mask, rng, self.cfg.remat_policy) if remat
                 else layer(h, mask, rng))
        return h


class _Pipelined(torch.autograd.Function):
    """The pipelined encoder as one node of the caller's graph: the stage's
    graphs are built in the forward and run backward by the schedule."""

    @staticmethod
    def forward(ctx, x, mask, stage):
        g, S, s, M = stage.mesh.model_group, stage.mesh.n_model, stage.mesh.model_rank, stage.M
        xs, masks = x.detach().chunk(M), mask.chunk(M)
        ins, outs, sends = [], [], []
        for m in range(M):
            h = (xs[m] if s == 0 else recv(xs[m], s - 1, g)).detach().requires_grad_(stage.grad)
            with torch.set_grad_enabled(stage.grad):
                y = stage.run(h, masks[m], m)
            if s < S - 1:
                sends.append(isend(y, s + 1, g))
            ins.append(h)
            outs.append(y)
        for w in sends:
            w.wait()
        hidden = torch.cat(outs).detach() if s == S - 1 else torch.empty_like(x)
        ctx.stage, ctx.ins, ctx.outs = stage, ins, outs
        return broadcast(hidden, S - 1, g)

    @staticmethod
    def backward(ctx, grad_hidden):
        stage = ctx.stage
        g, S, s, M = stage.mesh.model_group, stage.mesh.n_model, stage.mesh.model_rank, stage.M
        gs = grad_hidden.contiguous().chunk(M)
        dx, sends = [None] * M, []
        for m in reversed(range(M)):
            gy = gs[m] if s == S - 1 else recv(gs[m], s + 1, g)
            torch.autograd.backward(ctx.outs[m], gy)
            if s > 0:
                sends.append(isend(ctx.ins[m].grad, s - 1, g))
            else:
                dx[m] = ctx.ins[m].grad
        for w in sends:
            w.wait()
        ctx.ins = ctx.outs = None
        return (torch.cat(dx) if s == 0 else None), None, None


def _make_pipelined_encoder(encoder, mesh, num_microbatches: int):
    """``run(x (B, L, hs), mask (B, L), rng) -> hidden (B, L, hs)``: the
    encoder's layers over the mesh's ``pipe`` group on the GPipe schedule,
    the output whole on every stage. ``rng`` (a ``StepRNG``, the same on
    every stage, or None) gives the dropout seed."""
    if mesh.axis != PIPE_AXIS:
        raise ValueError(f"pipeline parallelism needs a mesh whose second axis is "
                         f"{PIPE_AXIS!r}, got {mesh.axis!r}")
    _stage_layers(encoder.config, mesh.n_model, mesh.model_rank)
    M = num_microbatches

    def run(x, mask, rng):
        B = mask.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        seed = (None if rng is None else
                int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng.host)))
        stage = _Stage(encoder, mesh, M, seed, torch.is_grad_enabled())
        return _Pipelined.apply(x, mask, stage)

    return run


def _longformer_only(cfg) -> None:
    if cfg.backbone != "longformer":
        raise ValueError(f"pipeline parallelism runs the longformer backbone, not {cfg.backbone!r}")


def make_pipeline_forward(model, mesh, num_microbatches: int, deterministic: bool = True):
    """The backbone (embeddings -> pipelined encoder -> pooler) of a
    ``RecformerModel`` with ``config.scan_layers``; ``num_hidden_layers``
    must divide by the pipe size and the batch by ``num_microbatches``.
    Returns ``run(batch, rng=None) -> (hidden, pooled)``, whole on every
    rank; ``rng`` (a ``StepRNG``, the same on every stage) drives the
    dropout when ``deterministic=False``. Differentiable; the stage layers'
    gradients land on their stage (see ``owned_by_stage``)."""
    from ..models.recformer import merge_attention_masks

    _longformer_only(model.config)
    if not model.config.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True")
    encoder_run = _make_pipelined_encoder(model.encoder, mesh, num_microbatches)

    def run(batch, rng=None):
        if not deterministic and rng is None:
            raise ValueError("deterministic=False requires an rng")
        rng = None if deterministic else rng
        mask = merge_attention_masks(batch["attention_mask"], batch["global_attention_mask"])
        x = model.embeddings(batch["input_ids"], batch["token_type_ids"],
                             batch["item_position_ids"], None, rng)
        hidden = encoder_run(x, mask, rng)
        return hidden, model.pooler(mask, hidden)

    return run


def make_pipeline_pretrain_step(config, model, optimizer, mesh, num_microbatches: int):
    """The GPipe pretraining step: both towers' clean and MLM passes fused
    into one ``(2B, L)`` pipelined forward each, the loss on every stage
    alike, the gradients reduced by ``training.steps.model_axis_backward``
    (see ``owned_by_stage``), one optimizer micro-step. ``model`` is a
    ``RecformerForPretraining`` with ``scan_layers``; the mesh may carry
    data ranks too. Returns ``step(rng, table, item_ids, seq_lens) ->
    metrics``, the contract of ``training.steps.make_pretrain_step`` (the
    ids are the global batch's, every rank draws its pairs and masks and
    keeps its data rank's rows; dropout from ``fold_in(seed, data_rank)``).
    ``step.backward(batch_a, batch_b, rng)`` runs the towers and the reduced
    backward on this data rank's rows of given batches, without the update,
    and returns the metrics."""
    from ..data.device_pipeline import make_pretrain_batch
    from ..models.heads import PretrainForwardOutput
    from ..models.recformer import merge_attention_masks
    from ..training.steps import model_axis_backward, take_rows

    _longformer_only(config)
    cfg = config
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True")
    if cfg.contrastive_gradient != "full":
        raise ValueError("the pipeline-parallel step takes contrastive_gradient='full' (the "
                         "global batch's loss)")
    lf = model.longformer
    encoder_run = _make_pipelined_encoder(lf.encoder, mesh, num_microbatches)
    own = owned_by_stage(cfg, mesh.n_model, mesh.model_rank)

    def tower(batch, rng):
        """One view's clean and MLM passes as one (2B, L) pipelined forward."""
        has_mlm = "mlm_input_ids" in batch

        def dup(x):
            return torch.cat([x, x], dim=0) if has_mlm else x

        ids = (torch.cat([batch["input_ids"], batch["mlm_input_ids"]], dim=0) if has_mlm
               else batch["input_ids"])
        mask = merge_attention_masks(dup(batch["attention_mask"]),
                                     dup(batch["global_attention_mask"]))
        x = lf.embeddings(ids, dup(batch["token_type_ids"]), dup(batch["item_position_ids"]),
                          None, rng)
        hidden = encoder_run(x, mask, rng)
        pooled = lf.pooler(mask, hidden)
        if not has_mlm:
            return pooled, None
        B = batch["input_ids"].shape[0]
        return pooled[:B], model._logits(hidden[B:], batch["mlm_positions"])

    def backward(batch_a, batch_b, rng):
        z1, mlm_a = tower(batch_a, rng)
        z2, mlm_b = tower(batch_b, rng)
        return model_axis_backward(cfg, model, PretrainForwardOutput(z1, z2, mlm_a, mlm_b),
                                   batch_a, batch_b, mesh, own)

    def step(rng, table, item_ids, seq_lens):
        batch_a, batch_b = (take_rows(b, mesh) for b in make_pretrain_batch(
            rng.device, table, item_ids, seq_lens, cfg))
        metrics = backward(batch_a, batch_b,
                           StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device))
        optimizer.step()
        return metrics

    step.backward = backward
    return step
