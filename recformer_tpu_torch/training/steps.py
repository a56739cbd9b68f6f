"""Training and serving steps: pretraining, seq-rec finetuning, ranked
evaluation, item encoding, fraud classification.

Counterparts of ``make_pretrain_step``, ``make_pretrain_eval_step``,
``make_finetune_step``, ``make_eval_step``, ``make_encode_items_step``,
``make_fraud_train_step`` and ``make_fraud_eval_step`` in
``recformer_tpu/training/steps.py``, as plain functions over a model that
holds its parameters. Batch construction runs on the model's device inside
the step; the host ships item-id arrays only. Metrics come back as device
tensors, so a step never waits on the host: the caller converts them when
it logs.

Given a mesh (``parallel/mesh.py``; one process per rank), the pretraining
and finetune steps run data-parallel over its ``data_group``, each rank
handed the same global batch of item ids:

- ``contrastive_gradient='full'`` (the JAX package's GSPMD step): every
  rank draws the global batch's pairs and MLM masks (finetune: targets and
  negatives) from the step's seed and keeps its data rank's rows, so a
  step equals the one-device step on the global batch given the same
  draws; each rank's dropout comes from ``fold_in(seed, data_rank)``. The
  contrastive negatives are all-gathered, each rank backpropagates its
  share of the global loss (the replicated contrastive term over the data
  size, its MLM terms over the global count of valid positions) and the
  gradients are summed over the data group;
- ``'local'`` (the JAX package's ``_local_grad_pretrain_step``, the
  reference's DDP): each rank draws from ``fold_in(seed, data_rank)`` for
  its own rows, the remote contrastive rows are detached, and the
  gradients and metrics are averaged over the data group.

Under tensor parallelism the model's sharded modules run their own
collectives over the ``model_group``; the finetune step scores against a
catalog row-sharded over it (``parallel/catalog.py``). The sequence- and
pipeline-parallel steps (``parallel/sequence.py``, ``parallel/pipeline.py``)
compute the loss alike on every rank of the mesh's second axis and reduce
their gradients with :func:`model_axis_backward`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..config import RecformerConfig
from ..data.device_pipeline import assemble_for_config, make_finetune_batch, make_pretrain_batch
from ..models.heads import similarity_scores
from ..ops.window_attention import draw_seed
from ..parallel.catalog import sharded_full_softmax_loss, sharded_take
from ..parallel.collectives import all_reduce_, psum
from ..utils.graphs import Graphs
from ..utils.profiling import span
from ..utils.rng import StepRNG, fold_in
from . import losses
from .metrics import MAX_VAL, rank_from_scores


def pretrain_loss(config: RecformerConfig, out, batch_a, batch_b, group=None,
                  grad_mode: str = "full"):
    """InfoNCE over the batch plus ``mlm_weight`` times the MLM loss of each
    view. Returns (loss, metrics).

    With a data ``group``: the contrastive batch is gathered from every rank
    (``grad_mode`` as in ``losses.gather_embeddings``). In ``'full'`` mode
    the returned loss is this rank's share of the global loss, whose sum
    over the group is the one-device loss of the whole batch (the
    contrastive term, the same on every rank, over the group's size; the
    MLM means over the group's valid positions), and the metrics are the
    global values; in ``'local'`` mode both are this rank's."""
    cl_loss, correct, total = losses.info_nce_loss(out.z1, out.z2, config.temp, group,
                                                   grad_mode)
    mlm_group = group if grad_mode == "full" else None
    loss = cl_loss if mlm_group is None else cl_loss / dist.get_world_size(group)
    metrics = {"cl_loss": cl_loss, "cl_correct": correct, "cl_total": total}
    mlm_total = 0.0
    for view, logits, batch in (("a", out.mlm_logits_a, batch_a), ("b", out.mlm_logits_b, batch_b)):
        if logits is None:
            continue
        mlm = losses.mlm_loss(logits, batch["mlm_labels"], mlm_group)
        loss = loss + config.mlm_weight * mlm
        if mlm_group is not None:
            mlm = psum(mlm.detach(), mlm_group)
        metrics[f"mlm_loss_{view}"] = mlm
        mlm_total = mlm_total + config.mlm_weight * mlm
    metrics["loss"] = cl_loss + mlm_total if mlm_group is not None else loss
    metrics["accuracy"] = correct / total.clamp_min(1e-5)
    return loss, metrics


def take_rows(x, mesh):
    """This data rank's rows of a global batch (a tensor or a dict of
    them)."""
    if isinstance(x, dict):
        return {k: take_rows(v, mesh) for k, v in x.items()}
    if x.shape[0] % mesh.n_data:
        raise ValueError(f"global batch {x.shape[0]} not divisible by data size {mesh.n_data}")
    b = x.shape[0] // mesh.n_data
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]


def _trained(model):
    """Every trained parameter's gradient (zeros where backward left none),
    in a fixed order, as the gradient reduction needs them on every rank."""
    grads = []
    for p in model.parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    return grads


def pretrain_backward(config: RecformerConfig, model, batch_a, batch_b, rng, mesh=None):
    """The towers with dropout from ``rng`` on this rank's batch, the loss
    and its backward; under a mesh, the gradients reduced over the data
    group (summed in ``'full'`` mode, averaged in ``'local'``). Returns the
    detached metrics."""
    mode = config.contrastive_gradient
    with span("forward"):
        out = model(batch_a, batch_b, deterministic=False, rng=rng)
        if mesh is None:
            loss, metrics = pretrain_loss(config, out, batch_a, batch_b)
        else:
            loss, metrics = pretrain_loss(config, out, batch_a, batch_b, mesh.data_group, mode)
    with span("backward"):
        loss.backward()
        if mesh is not None:
            all_reduce_(_trained(model), mesh.data_group, mean=(mode == "local"))
    if mesh is None:
        return {k: v.detach() for k, v in metrics.items()}
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mode == "local":
        # the counts are over the gathered batch already: the same on every rank
        metrics = {k: v if k in ("cl_correct", "cl_total")
                   else psum(v, mesh.data_group) / mesh.n_data for k, v in metrics.items()}
    return metrics


def model_axis_backward(config: RecformerConfig, model, out, batch_a, batch_b, mesh,
                        own=None):
    """The backward of a pretraining step whose towers ran split over the
    mesh's ``seq`` or ``pipe`` axis, every rank of that axis computing the
    loss alike (the ``'full'`` data-parallel share of the global loss), and
    the gradients summed over the world (data x that axis), so every rank
    holds the same whole gradients:

    - sequence parallelism (``own`` None): the gathered hidden state's
      backward sums the axis's equal cotangents, and each replicated
      tensor's gradient is whole on every rank, so every gradient counts S
      times: the loss is divided by S;
    - pipeline parallelism: ``own(name)`` says which gradients this rank
      contributes (its stage's layers, and the replicated rest on the first
      stage: ``parallel.pipeline.owned_by_stage``); the others are zeroed.

    Returns the detached metrics (the global values)."""
    with span("forward"):
        loss, metrics = pretrain_loss(config, out, batch_a, batch_b, mesh.data_group)
    with span("backward"):
        (loss / mesh.n_model if own is None else loss).backward()
        grads = []
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif own is not None and not own(name):
                p.grad.zero_()
            grads.append(p.grad)
        all_reduce_(grads, None)
    return {k: v.detach() for k, v in metrics.items()}


class SeedRecord:
    """Kernel seeds drawn from ``generator`` as :func:`draw_seed` draws them,
    each kept: the warm-up counts the micro-step's seeds."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.drawn: List[int] = []

    def draw_seed(self) -> int:
        seed = draw_seed(self.generator)
        self.drawn.append(seed)
        return seed


class SeedSlots:
    """One graph's kernel seeds in device memory: ``draw_seed()`` hands out
    the slots in turn (the captured launches read them as they run) and
    :meth:`load` fills them for the next run, which takes them from the
    first."""

    def __init__(self, n: int, device: torch.device):
        self.values = torch.zeros(n, dtype=torch.int32, device=device)
        self.taken = 0

    def __len__(self) -> int:
        return len(self.values)

    def draw_seed(self) -> torch.Tensor:
        i = self.taken
        self.taken += 1
        return self.values[i:i + 1]

    def load(self, seeds: Sequence[int]) -> None:
        host = torch.tensor(seeds, dtype=torch.int32, pin_memory=self.values.is_cuda)
        self.values.copy_(host, non_blocking=True)
        self.taken = 0


class _Streams(NamedTuple):
    """A micro-step's generators, in the shape of a ``StepRNG``."""
    seed: int
    host: object  # a torch.Generator, SeedRecord or SeedSlots
    device: torch.Generator


class _Kept(NamedTuple):
    names: tuple  # the metrics' names; the static outputs are the metrics, then the gradients
    params: list  # the trained parameters
    seeds: SeedSlots


class StepGraphs(Graphs):
    """A training step's graphs of its micro-step ``micro(rng, *inputs)``,
    which leaves its gradients in the parameters' ``.grad`` and returns its
    metrics (``utils/graphs.py``). A replay draws what the eager micro-step
    draws, value for value:

    - the device draws (pairs, MLM, each dropout mask) come from one
      persistent generator of the card, registered with every graph. Before
      a replay it takes the seed and offset at which the step's
      ``rng.device`` stands, and the replay gives each drawing operation the
      offset its eager call would have had (PyTorch's graph-safe Philox
      state); after it, ``rng.device`` moves on by the graph's whole
      increment;
    - the attention kernels' seeds are drawn on the host as before, with
      :func:`draw_seed` from ``rng.host``, as many and in the order the
      eager micro-step draws them (the warm-up counts them). They reach the
      kernels through a :class:`SeedSlots`, refilled before each replay by
      a non-blocking copy from pinned memory.

    The capture leaves the step's generators where the warm-up left them.
    A replay points every trained parameter's ``.grad`` at the graph's
    static gradient (the optimizer sets ``.grad`` to None after each step)."""

    @contextlib.contextmanager
    def _capturing(self, model, micro, args, inputs, device):
        (rng,) = args
        if self._generator is None:
            self._generator = self.primitive.new_generator(device)
        params = [p for p in model.parameters() if p.requires_grad]
        record = SeedRecord(rng.host)
        metrics = micro(_Streams(rng.seed, record, rng.device), *inputs)  # the warm-up
        answer = [p.grad for p in params]
        for p in params:  # the graph writes its own gradients
            p.grad = None
        seeds = SeedSlots(len(record.drawn), device)
        streams = _Streams(rng.seed, seeds, self._generator)
        names = tuple(metrics)

        def run(*inputs):
            out = micro(streams, *inputs)
            return tuple(out[n] for n in names) + tuple(p.grad for p in params)

        yield metrics, run, _Kept(names, params, seeds)
        for p, g in zip(params, answer):
            p.grad = g
        if seeds.taken != len(seeds):
            raise RuntimeError(f"the captured micro-step drew {seeds.taken} kernel seeds, "
                               f"the eager one {len(seeds)}")

    def _replayed(self, graph, args) -> Dict[str, torch.Tensor]:
        (rng,) = args
        names, params, seeds = graph.kept
        if len(seeds):
            seeds.load([draw_seed(rng.host) for _ in range(len(seeds))])
        self._generator.set_state(rng.device.get_state())
        graph.replay()
        rng.device.set_state(self._generator.get_state())
        for p, g in zip(params, graph.outputs[len(names):]):
            p.grad = g
        return {n: m.clone() for n, m in zip(names, graph.outputs)}


def _graphable(model) -> bool:
    """Whether a single-device micro-step may replay: gradients on, no
    activation recomputation (it re-sets the generators inside the
    backward) and no gradient held (a graph writes its gradients; it does
    not add to them)."""
    return (torch.is_grad_enabled() and not model.config.remat
            and all(p.grad is None for p in model.parameters()))


def make_pretrain_step(config: RecformerConfig, model, optimizer, mesh=None):
    """step(rng, table, item_ids, seq_lens) -> metrics: device-side pair
    sampling and MLM, the two towers with dropout, the loss, its backward and
    one optimizer micro-step. ``rng`` is a
    :class:`~recformer_tpu_torch.utils.rng.StepRNG`. Under a mesh the ids
    are the global batch's, and ``rng.seed`` is the step's seed (see the
    module's docstring for the two modes). Without one, everything before
    the optimizer goes through ``step.graphs``, a :class:`StepGraphs` that
    replays it as a CUDA graph where the call allows it."""
    graphs = StepGraphs("train_graph")

    def micro_step(rng, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        if mesh is None:
            batch_a, batch_b = make_pretrain_batch(rng.device, table, item_ids, seq_lens, config)
            return pretrain_backward(config, model, batch_a, batch_b, rng)
        if config.contrastive_gradient == "full":
            batch_a, batch_b = (take_rows(b, mesh) for b in make_pretrain_batch(
                rng.device, table, item_ids, seq_lens, config))
            drop = StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device)
        else:
            drop = StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device)
            batch_a, batch_b = make_pretrain_batch(drop.device, table, take_rows(item_ids, mesh),
                                                   take_rows(seq_lens, mesh), config)
        return pretrain_backward(config, model, batch_a, batch_b, drop, mesh)

    def step(rng, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        metrics = graphs(model, micro_step, (table, item_ids, seq_lens), rng,
                         graphed=mesh is None and _graphable(model))
        optimizer.step()
        return metrics

    step.graphs = graphs
    return step


def make_pretrain_eval_step(config: RecformerConfig, model, mesh=None):
    """step(generator, table, item_ids, seq_lens) -> {val_loss, cl_correct,
    cl_total}: the batch drawn from ``generator``, a deterministic forward.
    Under a mesh the ids are the global batch's, every rank draws the same
    pairs and masks and keeps its data rank's rows, and the contrastive
    negatives are gathered over the data group: the values are the
    one-device ones on the global batch."""

    @torch.no_grad()
    def step(generator, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        batch_a, batch_b = make_pretrain_batch(generator, table, item_ids, seq_lens, config)
        group = None
        if mesh is not None:
            batch_a, batch_b = take_rows(batch_a, mesh), take_rows(batch_b, mesh)
            group = mesh.data_group
        out = model(batch_a, batch_b, deterministic=True)
        _, metrics = pretrain_loss(config, out, batch_a, batch_b, group)
        return {"val_loss": metrics["loss"], "cl_correct": metrics["cl_correct"],
                "cl_total": metrics["cl_total"]}

    return step


def finetune_loss(config: RecformerConfig, pooled, item_embeddings, labels, generator):
    """Sampled softmax over ``finetune_negative_sample_size`` negatives drawn
    from ``generator`` when that size is positive, else the full softmax
    over the catalog."""
    if config.finetune_negative_sample_size > 0:
        return losses.seqrec_sampled_softmax_loss(
            pooled, item_embeddings, labels, config.temp,
            config.finetune_negative_sample_size, generator)
    return losses.seqrec_full_softmax_loss(pooled, item_embeddings, labels, config.temp)


def make_finetune_step(config: RecformerConfig, model, optimizer, mesh=None,
                       n_items: int | None = None):
    """step(seed, table, item_ids, seq_lens, item_embeddings) -> {loss}: a
    target per row over the whole sequence, the prefix batch on the device,
    the sequence tower with dropout, the loss against the frozen catalog
    ``item_embeddings``, its backward and one optimizer micro-step.

    Every draw of the step (targets, dropout, negatives) comes from a
    :class:`StepRNG` seeded with ``fold_in(seed, micro-step)``, as JAX folds
    ``state.step`` into its key: a run resumed from a saved train state
    draws what the uninterrupted run drew.

    Under a mesh: the ids are the global batch's, ``item_embeddings`` is
    this rank's rows of the ``n_items``-row catalog, row-sharded over the
    model group (``parallel.catalog.shard_rows``). The targets and negatives
    are drawn for the global batch (in the one-device order) and the rank
    keeps its rows; the dropout comes from ``fold_in(seed', data_rank)``;
    the full softmax runs through ``sharded_full_softmax_loss``, the sampled
    one over candidate rows fetched with ``sharded_take``; the gradients of
    each rank's share of the mean are summed over the data group."""

    def step(seed, table, item_ids, seq_lens, item_embeddings) -> Dict[str, torch.Tensor]:
        rng = StepRNG(fold_in(seed, optimizer.micro_steps), item_ids.device)
        batch, labels = make_finetune_batch(rng.device, table, item_ids, seq_lens, config)
        if mesh is None:
            with span("forward"):
                pooled = model(batch, deterministic=False, rng=rng)
                loss = finetune_loss(config, pooled, item_embeddings, labels, rng.device)
            with span("backward"):
                loss.backward()
            optimizer.step()
            return {"loss": loss.detach()}
        n_neg = config.finetune_negative_sample_size
        negatives = None
        if n_neg > 0:
            negatives = take_rows(torch.randint(0, n_items, (labels.shape[0], n_neg),
                                                generator=rng.device, device=labels.device), mesh)
        batch, labels = take_rows(batch, mesh), take_rows(labels, mesh)
        drop = StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device)
        with span("forward"):
            pooled = model(batch, deterministic=False, rng=drop)
            if negatives is None:
                loss = sharded_full_softmax_loss(pooled, item_embeddings, labels, config.temp,
                                                 n_items, mesh.model_group)
            else:
                candidates = torch.cat([labels.long()[:, None], negatives.long()], dim=1)
                loss = losses.sampled_softmax_from_candidates(
                    pooled, sharded_take(item_embeddings, candidates, mesh.model_group),
                    config.temp)
        with span("backward"):
            (loss / mesh.n_data).backward()
            all_reduce_(_trained(model), mesh.data_group)
        optimizer.step()
        return {"loss": psum(loss.detach(), mesh.data_group) / mesh.n_data}

    return step


def make_eval_step(config: RecformerConfig, model, ks: Sequence[int] = (10, 50)):
    """step(table, item_ids, seq_lens, labels, valid, item_embeddings) ->
    per-metric *sums* over valid rows plus the valid ``count``: encode the
    history, score it against every item, rank the label."""
    ks = tuple(ks)

    @torch.inference_mode()
    def step(table, item_ids, seq_lens, labels, valid, item_embeddings):
        batch = assemble_for_config(table, item_ids, seq_lens, config)
        pooled = model(batch)
        scores = similarity_scores(pooled.float(), item_embeddings.float(), config.temp)
        return rank_sums(rank_from_scores(scores, labels),
                         (scores > -MAX_VAL).float().sum(dim=-1), valid, ks)

    return step


def rank_sums(rank, valid_length, valid, ks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """NDCG@k, Recall@k, MRR and AUC summed over the ``valid`` rows, and
    their ``count``, from each row's rank and count of valid candidates."""
    w = valid.float()
    out = {}
    for k in ks:
        ind = (rank < k).float()
        out[f"NDCG@{k}"] = (w * ind / torch.log2(rank + 2.0)).sum()
        out[f"Recall@{k}"] = (w * ind).sum()
    out["MRR"] = (w / (rank + 1.0)).sum()
    out["AUC"] = (w * (1.0 - rank / valid_length.clamp_min(1.0))).sum()
    out["count"] = w.sum()
    return out


def make_encode_items_step(config: RecformerConfig, model):
    """step(table, item_id_chunk) -> pooled ``(C, H)``: each item is a
    one-item sequence at the short static ``item_seq_len``."""

    @torch.inference_mode()
    def step(table, item_id_chunk):
        ids = item_id_chunk[:, None]
        lens = torch.ones_like(item_id_chunk)
        batch = assemble_for_config(table, ids, lens, config, out_len=config.item_seq_len)
        return model(batch)

    return step


def fraud_loss(config: RecformerConfig, logits, labels, valid) -> torch.Tensor:
    """BCE with ``config.pos_weight`` over the valid rows: the weighted sum
    over ``max(sum(valid), 1)``."""
    w = valid.float()
    per = losses.bce_with_logits_terms(logits, labels, config.pos_weight)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def make_fraud_train_step(config: RecformerConfig, model, optimizer):
    """step(seed, table, item_ids, seq_lens, labels, valid) -> {loss}: the
    batch on the device, the fraud model with dropout (the backbone's and
    the head's), :func:`fraud_loss`, its backward and one optimizer
    micro-step. The draws come from ``fold_in(seed, micro-step)``, as in
    :func:`make_finetune_step`. Everything before the optimizer goes
    through ``step.graphs``, as in :func:`make_pretrain_step`."""
    graphs = StepGraphs("train_graph")

    def micro_step(rng, table, item_ids, seq_lens, labels, valid) -> Dict[str, torch.Tensor]:
        batch = assemble_for_config(table, item_ids, seq_lens, config)
        with span("forward"):
            loss = fraud_loss(config, model(batch, deterministic=False, rng=rng), labels, valid)
        with span("backward"):
            loss.backward()
        return {"loss": loss.detach()}

    def step(seed, table, item_ids, seq_lens, labels, valid) -> Dict[str, torch.Tensor]:
        rng = StepRNG(fold_in(seed, optimizer.micro_steps), item_ids.device)
        metrics = graphs(model, micro_step, (table, item_ids, seq_lens, labels, valid), rng,
                         graphed=_graphable(model))
        optimizer.step()
        return metrics

    step.graphs = graphs
    return step


def make_fraud_eval_step(config: RecformerConfig, model):
    """step(table, item_ids, seq_lens) -> the float32 fraud probability of
    each row (a deterministic forward)."""

    @torch.inference_mode()
    def step(table, item_ids, seq_lens):
        batch = assemble_for_config(table, item_ids, seq_lens, config)
        return torch.sigmoid(model(batch).float())

    return step
