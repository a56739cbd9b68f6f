"""Sequence (context) parallelism: the token dim sharded over the mesh's
``seq`` axis.

Counterpart of ``recformer_tpu/parallel/sequence.py``. A ±window/2 band is
local: a rank holding a contiguous ``L/S`` slice of the tokens needs only
window/2 rows of keys and values from each neighbour (the halo, two
:func:`~recformer_tpu_torch.parallel.collectives.ppermute` calls; the edge
ranks receive zeros, which the mask coding treats as padding). The global
(CLS) token is the only long-range interaction:

- local -> global: every rank gathers the global positions' standard key
  and value columns (``all_gather`` of ``(B, G, H, D)``);
- global -> all: the global query row attends over every position's global
  keys and values through a distributed softmax: a stability max over the
  ranks (``pmax`` of a detached max), numerators and denominators summed
  over the ranks, never the whole row on one rank.

Everything else in the encoder is per token, so with the attention module
dispatching to :func:`sequence_parallel_attention` (``models/encoder.py``,
the mesh carried on the module as ``sp``) the whole encoder runs sharded.
The attention here is plain PyTorch, as the JAX op is plain ``jnp``: no
Pallas kernel stands behind it, and the item tower of the pretraining step
runs the chunked twin, as JAX's does.

Dropout: each rank draws from its own stream, a seed drawn from the step's
host generator and folded with the seq rank (``utils.rng.head_group_rng``),
as JAX folds the shard index into its key; the generator stays in step on
every rank. Bitwise equality with JAX's masks is not a goal.

Gradients: the hidden state is gathered with ``collectives.all_gather``,
whose backward sums the seq ranks' cotangents. Every rank computes the
pooler, the MLM head and the loss alike from the gathered state, so each
rank's share arrives S times and the replicated tensors' gradients are
whole on every rank: the step divides the loss by S and sums every
gradient over the world (``training.steps.model_axis_backward``).
"""

from __future__ import annotations

import torch

from ..ops.attention import (NEG_INF, _batch_index, _einsum32, _prob_dropout, attention_scale,
                             global_prefix_indices)
from ..utils.rng import StepRNG, fold_in, head_group_rng
from .collectives import (all_gather, all_gather_local, copy_to, gather_list, group_rank,
                          group_size, pmax, ppermute, psum, shard)
from .mesh import SEQ_AXIS


def _halo_exchange(x: torch.Tensor, half: int, group, n: int) -> torch.Tensor:
    """Each rank's slice with ``half`` rows from its left and right
    neighbours along dim 1; the edge ranks receive zeros."""
    if n == 1:
        pad = x.new_zeros((x.shape[0], half) + tuple(x.shape[2:]))
        return torch.cat([pad, x, pad], dim=1)
    # rank i's last rows become rank i+1's left halo, its first rows rank i-1's right halo
    left = ppermute(x[:, -half:], [(i, i + 1) for i in range(n - 1)], group)
    right = ppermute(x[:, :half], [(i, i - 1) for i in range(1, n)], group)
    return torch.cat([left, x, right], dim=1)


def _banded_local(q, k_ext, v_ext, keyok_ext, window: int, scale, gk, gv, g_ok,
                  dropout_rate: float = 0.0, generator=None) -> torch.Tensor:
    """Banded attention of the local queries over the haloed keys and values.

    q: (B, Ls, H, D); k_ext/v_ext: (B, Ls + window, H, D); keyok_ext:
    (B, Ls + window) bool, the key is a local (attendable) position; gk/gv:
    (B, NG, H, D) gathered global columns with validity g_ok (B, NG).
    Returns (B, Ls, H, D) in q's dtype."""
    B, Ls, H, D = q.shape
    dt, dev = q.dtype, q.device
    half = window // 2
    block = min(128, Ls)
    if Ls % block:
        raise ValueError(f"shard length {Ls} must be a multiple of {block}")
    nb = Ls // block
    band = block + 2 * half

    kidx = (torch.arange(nb, device=dev) * block)[:, None] + torch.arange(band, device=dev)[None]
    k_b, v_b = k_ext[:, kidx], v_ext[:, kidx]  # (B, nb, band, H, D)
    ok_b = keyok_ext[:, kidx]  # (B, nb, band)
    t = torch.arange(block, device=dev)[:, None]
    u = torch.arange(band, device=dev)[None, :]
    in_window = (t - (u - half)).abs() <= half  # (block, band)
    allowed = ok_b[:, :, None, :] & in_window[None, None]

    qb = (q * scale).reshape(B, nb, block, H, D)
    scores = _einsum32("bnthd,bnuhd->bhntu", qb, k_b)
    scores = torch.where(allowed[:, None], scores, NEG_INF)
    g_scores = _einsum32("bnthd,bghd->bhntg", qb, gk)
    g_scores = torch.where(g_ok[:, None, None, None, :], g_scores, NEG_INF)

    all_scores = torch.cat([scores, g_scores], dim=-1)
    m = all_scores.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(all_scores - m)
    probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = _prob_dropout(probs, dropout_rate, generator)
    out = _einsum32("bhntu,bnuhd->bnthd", probs[..., :band].to(dt), v_b).to(dt)
    out = out + _einsum32("bhntg,bghd->bnthd", probs[..., band:].to(dt), gv).to(dt)
    return out.reshape(B, Ls, H, D)


def _psum_varying(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group whose result each rank uses differently (its own
    global rows): the backward sums the cotangents too."""
    return copy_to(psum(x, group), group)


def sequence_parallel_attention(q, k, v, q_g, k_g, v_g, mask, window: int, group,
                                max_globals: int = 1, dropout_rate: float = 0.0,
                                generator=None) -> torch.Tensor:
    """One rank's part: the contract of ``ops.attention.dense_attention`` on
    this rank's contiguous slice of the tokens, q/k/v/q_g/k_g/v_g
    ``(B, L/S, H, D)`` (``q_g`` may be pre-gathered at the rank's global
    rows, ``(B, max_globals, H, D)``) and mask ``(B, L/S)``; every rank of
    ``group`` calls it, in group-rank order of the slices. Dropout draws
    from ``generator``, the band's mask then the global row's."""
    B, Ls, H, D = q.shape
    half = window // 2
    if half > Ls:
        raise ValueError(f"shard length {Ls} must be >= window/2={half}")
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout_rate > 0 requires a generator")
    n, idx = group_size(group), group_rank(group)
    dt = q.dtype
    scale = attention_scale(D, dt, q.device)
    is_pad, is_global = mask == 0, mask == 2
    G = max_globals

    # --- halo exchange for the band ---------------------------------
    k_ext = _halo_exchange(k, half, group, n)
    v_ext = _halo_exchange(v, half, group, n)
    keyok_ext = _halo_exchange((mask == 1).to(torch.int32)[..., None], half, group, n)[..., 0] != 0

    # --- every rank's global (CLS) standard key/value columns ---------
    gidx, gvalid = global_prefix_indices(mask, G)  # local (B, G)
    bidx = _batch_index(gidx)
    gk_all = all_gather(k[bidx, gidx], group, dim=1)  # (B, n*G, H, D)
    gv_all = all_gather(v[bidx, gidx], group, dim=1)
    gok_all = torch.cat(gather_list(gvalid.to(torch.int32), group), dim=1) != 0  # (B, n*G)

    out = _banded_local(q, k_ext, v_ext, keyok_ext, window, scale, gk_all, gv_all, gok_all,
                        dropout_rate, generator)

    # --- the global query rows: a softmax distributed over the ranks --
    qg_loc = q_g if (q_g.shape[1] == G and G != Ls) else q_g[bidx, gidx]  # (B, G, H, D)
    qg_all = all_gather(qg_loc, group, dim=1)  # (B, n*G, H, D)
    g_scores = _einsum32("bghd,bmhd->bhgm", qg_all * scale, k_g)  # (B, H, nG, Ls)
    g_scores = torch.where(is_pad[:, None, None, :], NEG_INF, g_scores)
    m_glob = pmax(g_scores.amax(dim=-1), group)  # a stability max: no gradient
    e = torch.exp(g_scores - m_glob[..., None])
    # each rank drops its own key slice; the denominator stays undropped
    e_drop = _prob_dropout(e, dropout_rate, generator)
    num = _psum_varying(torch.einsum("bhgm,bmhd->bghd", e_drop, v_g.float()), group)
    den = _psum_varying(e.sum(dim=-1), group)  # (B, H, nG)
    g_out = (num / den.clamp_min(1e-30).permute(0, 2, 1)[..., None]).to(dt)
    g_out = torch.where(gok_all[:, :, None, None], g_out, 0.0)

    # this rank's global rows back in place
    mine = g_out[:, idx * G:(idx + 1) * G]
    g_rows = out.new_zeros(out.shape).index_put((bidx, gidx), mine, accumulate=True)
    out = torch.where(is_global[:, :, None, None], g_rows, out)
    return torch.where(is_pad[:, :, None, None], 0.0, out)


def _mark(model, mesh) -> None:
    """Hand the mesh to every attention module of ``model``: under
    ``attention_impl='sequence_parallel'`` they run
    :func:`sequence_parallel_attention` over its ``model_group``."""
    from ..models.encoder import LongformerSelfAttention

    if mesh.axis != SEQ_AXIS:
        raise ValueError(f"sequence parallelism needs a mesh whose second axis is "
                         f"{SEQ_AXIS!r}, got {mesh.axis!r}")
    for mod in model.modules():
        if isinstance(mod, LongformerSelfAttention):
            mod.sp = mesh


def with_attention_impl(model, impl: str):
    """``model``'s class again under ``config.replace(attention_impl=impl)``,
    holding the same parameter tensors (built on the meta device, then
    pointed at ``model``'s): the JAX package's second module on the same
    parameter tree, for the item tower and the evaluation of a
    sequence-parallel model."""
    with torch.device("meta"):
        twin = type(model)(model.config.replace(attention_impl=impl))
    for name, p in model.named_parameters():
        owner, attr = name.rsplit(".", 1)
        setattr(twin.get_submodule(owner), attr, p)
    return twin.train(model.training)


def _sp_backbone(backbone, mesh, input_ids, attention_mask, global_attention_mask,
                 token_type_ids, item_position_ids, rng):
    """The backbone (a ``RecformerModel`` marked with the mesh) on this seq
    rank's slice of the tokens: the padding-aware position ids over the
    whole length first, the embeddings and the encoder on the slice with
    this rank's dropout stream, the hidden state gathered. Returns (hidden,
    pooled), whole on every rank."""
    from ..models.embeddings import create_position_ids_from_input_ids
    from ..models.recformer import merge_attention_masks

    g, r, n = mesh.model_group, mesh.model_rank, mesh.n_model
    mask = merge_attention_masks(attention_mask, global_attention_mask)
    pos = create_position_ids_from_input_ids(input_ids, backbone.config.pad_token_id)
    L = input_ids.shape[1]
    if L % n:
        raise ValueError(f"sequence length {L} not divisible by {n} seq shards")
    size = L // n

    def cut(x):
        return x[:, r * size:(r + 1) * size]

    srng = None if rng is None else head_group_rng(rng, r)
    x = backbone.embeddings(cut(input_ids), cut(token_type_ids), cut(item_position_ids),
                            cut(pos), srng)
    hidden = all_gather(backbone.encoder(x, cut(mask), srng), g, dim=1)
    return hidden, backbone.pooler(mask, hidden)


def make_sequence_parallel_forward(model, mesh):
    """The backbone (embeddings -> encoder -> pooler) with the token dim
    sharded over the mesh's ``seq`` axis. ``model`` is a ``RecformerModel``
    whose config has ``attention_impl='sequence_parallel'``; its attention
    modules get the mesh. Returns ``run(batch, rng=None,
    deterministic=True) -> (hidden, pooled)``, whole on every rank;
    ``deterministic=False`` draws dropout from ``rng`` (a ``StepRNG``, the
    same on every rank), folded with the seq rank."""
    if model.config.attention_impl != "sequence_parallel":
        raise ValueError("make_sequence_parallel_forward needs "
                         "attention_impl='sequence_parallel'")
    _mark(model, mesh)

    def run(batch, rng=None, deterministic=True):
        if not deterministic and rng is None:
            raise ValueError("deterministic=False requires an rng")
        return _sp_backbone(model, mesh, batch["input_ids"], batch["attention_mask"],
                            batch["global_attention_mask"], batch["token_type_ids"],
                            batch["item_position_ids"], None if deterministic else rng)

    return run


def make_sequence_parallel_attention(mesh, window: int, max_globals: int = 1):
    """The op over whole ``(B, L, H, D)`` / ``(B, L)`` inputs, the same on
    every rank: each rank takes its slice of dim 1, and the output comes
    back whole. L must divide by the seq size, and each slice hold >=
    window/2 tokens. Differentiable as JAX's ``shard_map`` is: for a loss
    that every rank computes alike from the output, each rank's gradients
    are the whole inputs' (the output's backward keeps this rank's slice of
    the cotangent, the inputs' gathers every rank's). Returns ``run(q, k,
    v, q_g, k_g, v_g, mask, dropout_rate=0.0, rng=None)``; ``rng`` (a
    ``StepRNG``) is folded with the seq rank."""
    g = mesh.model_group

    def run(q, k, v, q_g, k_g, v_g, mask, dropout_rate=0.0, rng=None):
        parts = [shard(x, g, 1) for x in (q, k, v, q_g, k_g, v_g)]
        gen = None if rng is None else head_group_rng(rng, mesh.model_rank).device
        out = sequence_parallel_attention(*parts, shard(mask, g, 1), window, g, max_globals,
                                          dropout_rate, gen)
        return all_gather_local(out, g, dim=1)

    return run


def make_sp_pretrain_step(config, model, optimizer, mesh):
    """The pretraining step with the sequence view's tokens sharded over the
    mesh's ``seq`` axis (and its rows over ``data``): the history tower's
    clean and MLM passes fused into one ``(2B, L)`` sequence-parallel
    forward, the item tower replicated with the chunked twin on the same
    parameters (:func:`with_attention_impl`), the loss on every seq rank
    alike, the gradients reduced by ``training.steps.model_axis_backward``,
    one optimizer micro-step. ``model`` is a ``RecformerForPretraining``
    with ``attention_impl='sequence_parallel'`` and
    ``global_kv_mode='full'``. Returns ``step(rng, table, item_ids,
    seq_lens) -> metrics``, the contract of
    ``training.steps.make_pretrain_step`` (the ids are the global batch's,
    every rank draws its pairs and masks and keeps its data rank's rows;
    dropout from ``fold_in(seed, data_rank)``, then folded with the seq
    rank in the history tower). ``step.backward(batch_a, batch_b, rng)``
    runs the towers and the reduced backward on this data rank's rows of
    given batches, without the update, and returns the metrics."""
    from ..data.device_pipeline import make_pretrain_batch
    from ..models.heads import PretrainForwardOutput
    from ..training.steps import model_axis_backward, take_rows

    cfg = config
    if cfg.attention_impl != "sequence_parallel":
        raise ValueError("make_sp_pretrain_step needs attention_impl='sequence_parallel'")
    if cfg.global_kv_mode != "full":
        raise ValueError("sequence parallelism shards the full-length k_g/v_g tensors: set "
                         "global_kv_mode='full'")
    if cfg.contrastive_gradient != "full":
        raise ValueError("the sequence-parallel step takes contrastive_gradient='full' (the "
                         "global batch's loss)")
    S = mesh.n_model
    half = max(cfg.attention_window) // 2
    if cfg.max_token_num % S or (cfg.max_token_num // S) < half:
        raise ValueError(f"max_token_num={cfg.max_token_num} over {S} seq shards leaves "
                         f"<{half} (window/2) tokens per shard")
    _mark(model, mesh)
    item_model = with_attention_impl(model, "chunked")

    def tower_sp(batch, rng):
        """The sequence view's clean and MLM passes as one (2B, L)
        sequence-parallel forward (``RecformerForPretraining._tower``)."""
        has_mlm = "mlm_input_ids" in batch

        def dup(x):
            return torch.cat([x, x], dim=0) if has_mlm else x

        ids = (torch.cat([batch["input_ids"], batch["mlm_input_ids"]], dim=0) if has_mlm
               else batch["input_ids"])
        hidden, pooled = _sp_backbone(
            model.longformer, mesh, ids, dup(batch["attention_mask"]),
            dup(batch["global_attention_mask"]), dup(batch["token_type_ids"]),
            dup(batch["item_position_ids"]), rng)
        if not has_mlm:
            return pooled, None
        B = batch["input_ids"].shape[0]
        return pooled[:B], model._logits(hidden[B:], batch["mlm_positions"])

    def backward(batch_a, batch_b, rng):
        z1, mlm_a = tower_sp(batch_a, rng)
        z2, mlm_b = item_model._tower(batch_b, False, rng)
        return model_axis_backward(cfg, model, PretrainForwardOutput(z1, z2, mlm_a, mlm_b),
                                   batch_a, batch_b, mesh)

    def step(rng, table, item_ids, seq_lens):
        batch_a, batch_b = (take_rows(b, mesh) for b in make_pretrain_batch(
            rng.device, table, item_ids, seq_lens, cfg))
        metrics = backward(batch_a, batch_b,
                           StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device))
        optimizer.step()
        return metrics

    step.backward = backward
    return step
