"""Multi-rank dry run: one step of each parallel training path at tiny shapes.

Counterpart of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``
(its data- and tensor-parallel parts): over the torchrun world as a
``data`` x ``model`` mesh (model size 2 when the world is at least 4 and
even, else 1) it runs one step each of

- the data-parallel pretraining step (``contrastive_gradient='full'``);
- the data-parallel finetune step against a catalog row-sharded over the
  model ranks (4 sampled negatives, then the full softmax);
- the ZeRO step (AdamW moments sharded over the data ranks) on a data-only
  mesh of the whole world;
- the tensor-parallel step, when the model size is 2;
- the ``'local'`` contrastive-gradient step;

and prints one line for each, from rank 0. Sequence and pipeline
parallelism are not ported yet. Under ``main`` every step runs with
PyTorch's deterministic algorithms (``tensor.deterministic_replicas``);
a caller of :func:`dryrun` that runs the tensor-parallel step on the card
turns them on first.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m recformer_tpu_torch.parallel.dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..config import RecformerConfig
from ..models.heads import RecformerForPretraining, RecformerForSeqRec
from ..models.recformer import init_weights
from ..training.optimizer import create_optimizer
from ..training.steps import make_finetune_step, make_pretrain_step
from ..utils.rng import StepRNG
from .catalog import shard_rows
from .mesh import destroy, make_mesh
from .tensor import deterministic_replicas, shard_model_tp, tp_config


def synthetic_table(cfg, n_items: int, seed: int = 0):
    """A random tokenized table of ``n_items`` items (and the padding row)."""
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    ids = rng.integers(4, cfg.vocab_size - 1, size=(n_items + 1, M)).astype(np.int32)
    types = np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32), (n_items + 1, 1))
    begin = rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32)
    lengths = rng.integers(3, M + 1, size=n_items + 1).astype(np.int32)
    ids[-1] = cfg.pad_token_id
    lengths[-1] = 0
    return {"token_ids": ids, "token_types": types, "word_begin": begin, "lengths": lengths}


def _model(cls, cfg, device, seed=0):
    model = cls(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(seed))
    return model.to(device)


def dryrun(device="cuda", n_model=None) -> dict:
    """Run the steps; returns each one's loss (the same on every rank)."""
    import torch.distributed as dist

    from .mesh import init_distributed

    init_distributed(device)
    world = dist.get_world_size()
    if n_model is None:
        n_model = 2 if (world % 2 == 0 and world >= 4) else 1
    mesh = make_mesh(n_model, device)
    dp_mesh = make_mesh(1, device) if n_model > 1 else mesh
    dev = mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"[dryrun] backend={mesh.backend} world={world} data={mesh.n_data} model={n_model}")

    cfg = RecformerConfig.tiny(max_token_num=64, item_seq_len=32, max_item_embeddings=6,
                               attention_window=(16, 16), finetune_negative_sample_size=4,
                               attention_impl="pallas")
    n_items = 16 * n_model
    table = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_table(cfg, n_items).items()}
    rng = np.random.default_rng(0)
    B = 2 * mesh.n_data
    item_ids = torch.from_numpy(rng.integers(0, n_items, size=(B, 8)).astype(np.int32)).to(dev)
    seq_lens = torch.from_numpy(rng.integers(2, 9, size=B).astype(np.int32)).to(dev)
    out = {}

    def pretrain(name, c, m, **kw):
        model = _model(RecformerForPretraining, c, dev)
        if kw.pop("tp", False):
            shard_model_tp(model, m)
        opt = create_optimizer(model, learning_rate=1e-4, warmup_steps=2, total_steps=10,
                               mesh=m, **kw)
        ids, lens = item_ids, seq_lens
        if m.n_data != mesh.n_data:  # the data-only mesh: a batch of 2 rows a rank
            ids = item_ids.repeat(m.n_data // mesh.n_data, 1)
            lens = seq_lens.repeat(m.n_data // mesh.n_data)
        metrics = make_pretrain_step(c, model, opt, m)(StepRNG(1, dev), table, ids, lens)
        out[name] = float(metrics["loss"])
        say(f"[dryrun] {name} ok: loss={out[name]:.4f}")

    pretrain("pretrain", cfg, mesh)

    ft_model = _model(RecformerForSeqRec, cfg, dev, seed=2)
    ft_opt = create_optimizer(ft_model, total_steps=10, mesh=mesh)
    catalog = torch.from_numpy(
        rng.standard_normal((n_items, cfg.hidden_size)).astype(np.float32)).to(dev)
    shard = shard_rows(catalog, mesh.model_group)
    for negatives in (4, 0):
        c = cfg.replace(finetune_negative_sample_size=negatives)
        ft_step = make_finetune_step(c, ft_model, ft_opt, mesh, n_items=n_items)
        name = f"finetune_{'sampled' if negatives else 'full'}"
        out[name] = float(ft_step(3, table, item_ids, seq_lens, shard)["loss"])
        say(f"[dryrun] {name} (catalog sharded over {n_model}) ok: loss={out[name]:.4f}")

    pretrain("zero", cfg, dp_mesh, zero=True)
    if n_model > 1:
        pretrain("tensor_parallel", tp_config(cfg), mesh, tp=True)
    pretrain("local", cfg.replace(contrastive_gradient="local"), mesh)
    if not all(math.isfinite(v) for v in out.values()):
        raise RuntimeError(f"[dryrun] a loss is not finite: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    deterministic_replicas()  # for the tensor-parallel step, before any CUDA work
    try:
        dryrun(args.device)
    finally:
        destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
