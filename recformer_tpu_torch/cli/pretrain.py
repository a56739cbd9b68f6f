"""Pretraining entry point: MLM + in-batch item-item contrastive retrieval, on one
device or data- and tensor-parallel over ``torch.distributed``.

Counterpart of ``recformer_tpu/cli/pretrain.py``, with its flags plus
``--device`` (default ``cuda``; without a GPU the command raises unless
``--device cpu`` is given). Each step builds its batch on the device (pair
sampling, two views, whole-word MLM), runs the two towers with dropout, and
takes an AdamW micro-step; validation on the dev set (the contrastive
accuracy) runs every ``--valid_step_interval`` steps and after every epoch.
``--remat``/``--remat_policy`` recompute each encoder layer in the backward
(``models/encoder.py``). ``--steps_per_call N`` runs N steps back to back
per call and logs the mean of their metrics (JAX scans them in one device
launch).

Parallelism, one process per rank under torchrun::

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m recformer_tpu_torch.cli.pretrain --data_path DIR ... --device cuda|cpu

The world is a ``data`` x ``model`` mesh (``parallel/mesh.py``: ``nccl`` when
every rank has a card of its own, ``gloo`` when ranks share one or run on the
CPU). With no model-parallel flag every rank is a data rank;
``--tensor_parallel M`` puts M ranks on the model axis (Megatron-style
heads and FFN columns, ``parallel/tensor.py``) and data-parallelism on the
rest; ``--zero`` shards the AdamW moments over the data ranks (plain data
parallelism only). The flags are validated as the JAX CLI's
``_resolve_parallelism`` does, with the same refusals; ``--pipeline`` and
``--sequence_parallel`` (with ``--microbatches`` and ``--attention_impl
sequence_parallel``) are validated too, then refused: they come with the next
port slice. ``--batch_size`` is per data rank: every rank walks the same
global batches of ``batch_size x n_data`` rows and keeps its data rank's
(``training/steps.py``), in training and in validation, whose contrastive
accuracy is over the gathered global batch. Rank 0 alone writes logs, the
mirror and the checkpoints, which hold whole tensors (gathered under tensor
parallelism), so a one-rank run reads them; ``--resume`` loads the whole
train state and shards it again. A SIGTERM/SIGINT latched on any rank is
reduced over the world (a ``gloo`` group of CPU tensors) at the step
boundary, so every rank stops at the same step.

Metric rows, as the JAX CLI writes them: ``loss``, ``accuracy``, the other
step metrics and ``examples_per_sec`` each time the step count crosses a
multiple of 50, ``dev_accuracy`` at each ``--valid_step_interval``
crossing, ``preempted`` at a preemption, each with ``step`` and ``time``,
in ``--log_dir`` (default ``<output_dir>/logs``) ``/metrics.jsonl`` and
repeated in ``--mirror_file``. ``--profile_dir`` records steps 10-15 with
``torch.profiler`` (``utils/profiling.py``) into a Chrome-trace JSON
there. The parameters are saved as torch state dicts, ``best.pt`` (by
dev accuracy) and ``last.pt`` in ``--output_dir``, which
``cli.common.maybe_load_pretrained`` reads back, and the ``--save_top_k``
best by dev accuracy under ``--output_dir/topk``.

Resume: after every epoch, and at the next step boundary after a SIGTERM or
SIGINT (preemption, Ctrl-C), the train state (parameters, optimizer, step,
the epoch to run next, the best accuracy) goes to ``state.pt``; a
preempted run also writes ``last.pt``, prints how to restart and returns.
``--resume`` continues from ``state.pt``: the interrupted epoch restarts
from its first batch. A step's draws are seeded by ``(--seed, micro-step)``.

Data contract: ``--train_file``/``--dev_file`` are JSON lists (or dicts) of
item sequences, raw item keys or dense ids; ``--item_attr_file`` maps item
key -> attribute dict; ``--item2id_file`` maps item key -> dense id.

    python -m recformer_tpu_torch.cli.pretrain --data_path DIR --model_size base \\
        --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time

import torch

from ..data.datasets import SequenceDataset
from ..models.heads import RecformerForPretraining
from ..training.checkpoint import (
    TopKCheckpointManager,
    restore_train_state,
    save_params,
    write_train_state,
)
from ..parallel.collectives import pmax
from ..parallel.mesh import destroy, make_mesh, world_size
from ..parallel.tensor import (deterministic_replicas, gather_state_dict_tp, shard_model_tp,
                               shard_state_dict_tp, tp_config, validate_tp_config)
from ..training.optimizer import create_optimizer
from ..training.steps import make_pretrain_eval_step, make_pretrain_step
from ..utils.device import resolve_device
from ..utils.io import read_json
from ..utils.logging import MetricsLogger
from ..utils.profiling import trace
from ..utils.rng import StepRNG, fold_in
from .common import (
    build_config,
    init_model_params,
    make_tokenizer,
    maybe_load_pretrained,
    rank0_first,
    table_to_device,
    tokenize_corpus_cached,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--train_file", type=str, default="train.json")
    p.add_argument("--dev_file", type=str, default="dev.json")
    p.add_argument("--item_attr_file", type=str, default="meta_data.json")
    p.add_argument("--item2id_file", type=str, default="smap.json")
    p.add_argument("--output_dir", type=str, default="pretrain_ckpts")
    p.add_argument("--longformer_ckpt", type=str, default=None,
                   help="HF Longformer torch .bin to initialize from")
    p.add_argument("--hf_tokenizer", type=str, default=None,
                   help="local path of a Hugging Face tokenizer (no download)")
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--num_train_epochs", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--temp", type=float, default=0.05)
    p.add_argument("--mlm_weight", type=float, default=0.1)
    p.add_argument("--attention_impl", default=None,
                   choices=["dense", "chunked", "pallas", "sequence_parallel"])
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="shard attention heads + FFN over a 'model' axis of this many ranks "
                        "(Megatron-style column/row parallel; data parallelism on the rest)")
    p.add_argument("--pipeline", type=int, default=1,
                   help="split the encoder stack over this many ranks (needs --scan_layers; "
                        "validated, then refused: not ported yet)")
    p.add_argument("--microbatches", type=int, default=2,
                   help="pipeline microbatches per step (with --pipeline)")
    p.add_argument("--sequence_parallel", type=int, default=1,
                   help="shard the token dim over this many ranks (with --attention_impl "
                        "sequence_parallel; validated, then refused: not ported yet)")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 optimizer-state sharding over the data ranks")
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--scan_layers", action="store_true", default=None,
                   help="recorded in the config (the JAX package's stacked layers); the "
                        "port runs the same layer loop either way")
    p.add_argument("--scan_unroll", type=int, default=None,
                   help="recorded in the config; no effect on the port's layer loop")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute each encoder layer in the backward (less memory)")
    p.add_argument("--remat_policy", default=None,
                   choices=["full", "save_attention", "dots", "dots_attn"],
                   help="what a recomputed layer keeps (see config.remat_policy)")
    p.add_argument("--pooler_type", choices=["cls", "avg"], default=None,
                   help="sequence pooling: CLS token (default) or masked mean")
    p.add_argument("--max_token_num", type=int, default=None,
                   help="max sequence length in tokens")
    p.add_argument("--ln_impl", choices=["xla", "pallas_bwd", "split_bwd"], default=None,
                   help="encoder-block LayerNorm: flax's (default), the backward kernel, "
                        "or the split plain backward (see config.ln_impl)")
    p.add_argument("--save_top_k", type=int, default=5,
                   help="keep this many best checkpoints by dev accuracy under output_dir/topk")
    p.add_argument("--fix_word_embedding", action="store_true")
    p.add_argument("--valid_step_interval", type=int, default=2000)
    p.add_argument("--valid_batches", type=int, default=0,
                   help="cap dev validation at this many batches; 0 = the full dev set")
    p.add_argument("--resume", action="store_true",
                   help="resume parameters, optimizer and position from output_dir/state.pt")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-15 here")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="run this many steps back to back per call; each log row holds "
                        "the mean of the call's per-step metrics")
    p.add_argument("--log_dir", type=str, default=None,
                   help="metrics directory (metrics.jsonl, and TensorBoard if importable); "
                        "default output_dir/logs")
    p.add_argument("--mirror_file", default=None,
                   help="append-only JSONL mirror of every logged metric row")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def _resolve_parallelism(args, config, n_dev: int):
    """One-flag strategy selection, the JAX CLI's: returns (config,
    model-axis size, mode) with mode in {'dp', 'tp'} over a world of
    ``n_dev`` ranks; the same combinations exit, and 'pp' / 'sp' exit after
    validation."""
    modes = {"tp": args.tensor_parallel, "pp": args.pipeline, "sp": args.sequence_parallel}
    active = [m for m, v in modes.items() if v > 1]
    if len(active) > 1:
        raise SystemExit("pick at most one of --tensor_parallel / --pipeline "
                         "/ --sequence_parallel > 1")
    if (args.attention_impl == "sequence_parallel") != (args.sequence_parallel > 1):
        raise SystemExit("--attention_impl sequence_parallel and "
                         "--sequence_parallel N>1 go together")
    mode = active[0] if active else "dp"
    if mode != "dp" and args.zero:
        raise SystemExit("--zero composes with plain data parallelism only "
                         "(tp already shards optimizer state with the params)")
    if mode == "dp":
        return config, 1, mode
    n_model = modes[mode]
    if n_dev % n_model:
        raise SystemExit(f"world size {n_dev} not divisible by {n_model}")
    if mode == "tp":
        config = tp_config(config)
        validate_tp_config(config, n_model)
        return config, n_model, mode
    if mode == "pp" and not config.scan_layers:
        raise SystemExit("--pipeline requires --scan_layers (stacked layer "
                         "params with a leading layer axis)")
    flag = "--pipeline" if mode == "pp" else "--sequence_parallel"
    raise SystemExit(f"{flag} {n_model}: not ported yet; pipeline and sequence parallelism "
                     "come with the next port slice")


def _install_preemption_handler() -> dict:
    """Catch SIGTERM and SIGINT and latch the signal in the returned dict,
    so the loop checkpoints at the next step boundary instead of dying in a
    step."""
    flag = {"signal": 0}

    def handler(signum, frame):
        flag["signal"] = signum
        print(f"[pretrain] caught signal {signum}; checkpointing at the next step boundary",
              flush=True)

    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(s, handler)
        except ValueError:  # not the main thread
            pass
    return flag


def _restore_handlers(handlers: dict) -> None:
    for sig, handler in handlers.items():
        try:
            signal.signal(sig, handler)
        except (ValueError, TypeError):  # not the main thread, or not set from Python
            pass


def _crossed(interval: int, prev_step: int, step: int) -> bool:
    """True when [prev_step, step] crossed a multiple of ``interval``."""
    return interval > 0 and step // interval > prev_step // interval


def _validate(eval_step, seed, device, table, dev_ds, batch_size, max_batches=0) -> float:
    """Contrastive dev accuracy. The batches are drawn from a generator made
    anew from ``seed``, so every validation sees the same batches."""
    generator = StepRNG(seed, device).device
    correct = total = None
    for i, batch in enumerate(dev_ds.batches(batch_size, drop_last=True)):
        if max_batches and i >= max_batches:
            print(f"[pretrain] dev subsampled to {max_batches} batches (--valid_batches)")
            break
        out = eval_step(generator, table, torch.from_numpy(batch.item_ids).to(device),
                        torch.from_numpy(batch.seq_lens).to(device))
        correct = out["cl_correct"] if correct is None else correct + out["cl_correct"]
        total = out["cl_total"] if total is None else total + out["cl_total"]
    if total is None:
        return 0.0
    return float(correct) / max(float(total), 1.0)


def main(argv=None):
    args = parse_args(argv)
    config = build_config(args)
    n_world = world_size()
    config, n_model, mode = _resolve_parallelism(args, config, n_world)
    if mode == "tp":  # before any CUDA work (see deterministic_replicas)
        deterministic_replicas()
    mesh = make_mesh(n_model, args.device) if n_world > 1 else None
    try:
        return _train(args, config, mesh)
    finally:
        if mesh is not None:
            destroy(mesh)


def _train(args, config, mesh):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = mesh is None or mesh.rank == 0
    n_data = mesh.n_data if mesh is not None else 1
    tp = mesh is not None and mesh.n_model > 1
    say = print if main_rank else (lambda *a, **k: None)
    tokenizer = make_tokenizer(config, args.hf_tokenizer)

    train_seqs = read_json(os.path.join(args.data_path, args.train_file))
    if isinstance(train_seqs, dict):
        train_seqs = list(train_seqs.values())
    dev_path = os.path.join(args.data_path, args.dev_file)
    dev_seqs = read_json(dev_path) if os.path.exists(dev_path) else train_seqs
    if isinstance(dev_seqs, dict):
        dev_seqs = list(dev_seqs.values())
    meta = read_json(os.path.join(args.data_path, args.item_attr_file))
    item2id = read_json(os.path.join(args.data_path, args.item2id_file))

    def to_int_ids(seqs):
        """Raw item keys map through ``item2id`` (unknown ones are dropped);
        dense int ids pass as they are."""
        out = []
        for s in seqs:
            if s and isinstance(s[0], str):
                s = [item2id[a] for a in s if a in item2id]
            if s:
                out.append(s)
        return out

    train_seqs = to_int_ids(train_seqs)
    dev_seqs = to_int_ids(dev_seqs)
    table_np = rank0_first(mesh, lambda: tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), "pretrain"))
    table = table_to_device(table_np, device)

    # the global batch scales with the data ranks only (model ranks share a batch)
    global_batch = args.batch_size * n_data
    max_items = max(len(s) for s in train_seqs)
    train_ds = SequenceDataset({i: s for i, s in enumerate(train_seqs)}, max_items=max_items)
    dev_ds = SequenceDataset({i: s for i, s in enumerate(dev_seqs)}, max_items=max_items)

    model = init_model_params(RecformerForPretraining(config), config, device)
    model = maybe_load_pretrained(model, args.longformer_ckpt)
    if args.fix_word_embedding:
        # no update for the word-embedding table
        model.longformer.embeddings.word_embeddings.weight.requires_grad_(False)
    if tp:
        shard_model_tp(model, mesh)

    steps_per_epoch = max(1, len(train_ds) // global_batch)
    total = steps_per_epoch * args.num_train_epochs
    optimizer = create_optimizer(
        model, learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=total,
        grad_accum_steps=args.gradient_accumulation_steps, mesh=mesh,
        zero=args.zero and mesh is not None)
    step = make_pretrain_step(config, model, optimizer, mesh)
    eval_step = make_pretrain_eval_step(config, model, mesh)

    def whole_params():
        """The whole parameters (gathered over the model ranks: every rank
        calls this)."""
        return gather_state_dict_tp(model.state_dict(), mesh) if tp else model.state_dict()

    os.makedirs(args.output_dir, exist_ok=True)
    state_path = os.path.join(args.output_dir, "state.pt")
    best_acc = -1.0
    global_step = start_epoch = 0
    if args.resume and os.path.exists(state_path):
        shard = (lambda sd: shard_state_dict_tp(sd, mesh.model_rank, mesh.n_model)) if tp else None
        pos = restore_train_state(state_path, model, optimizer, shard=shard)
        start_epoch, global_step, best_acc = pos["epoch"], pos["global_step"], pos["best_acc"]
        say(f"[pretrain] resumed at step {global_step} (micro-step {optimizer.micro_steps}), "
            f"epoch {start_epoch}")
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    preempt = _install_preemption_handler()
    topk = (TopKCheckpointManager(os.path.join(args.output_dir, "topk"), k=args.save_top_k,
                                  mode="max") if main_rank else None)
    logger = MetricsLogger((args.log_dir or os.path.join(args.output_dir, "logs"))
                           if main_rank else None, mirror_path=args.mirror_file)
    profiling = contextlib.ExitStack()  # the trace of steps 10-15, while it runs
    traced = False
    last_log_step = global_step
    t0 = time.time()

    def validate_and_keep_best():
        nonlocal best_acc
        acc = _validate(eval_step, args.seed, device, table, dev_ds, global_batch,
                        args.valid_batches)
        params = whole_params()
        if main_rank:
            topk.save(params, global_step, acc)
        if acc > best_acc:
            best_acc = acc
            if main_rank:
                save_params(os.path.join(args.output_dir, "best.pt"), params)
        return acc

    def save_state(epoch):
        params, opt_state = whole_params(), optimizer.state_dict()
        if main_rank:
            write_train_state(state_path, params, opt_state, optimizer.micro_steps, epoch=epoch,
                              global_step=global_step, best_acc=best_acc)

    def save_last():
        params = whole_params()
        if main_rank:
            save_params(os.path.join(args.output_dir, "last.pt"), params)

    def stop_signal() -> int:
        """The latched signal, the largest over the world: every rank stops
        at the same step boundary. Reduced on the host, so the host does
        not wait for the card's queued steps."""
        if mesh is None:
            return preempt["signal"]
        return int(pmax(torch.tensor(preempt["signal"]), mesh.host_group))

    def run_steps(pending):
        """The pending batches' steps back to back; the mean of each metric."""
        per_step = []
        for ids, lens in pending:
            rng = StepRNG(fold_in(args.seed, optimizer.micro_steps), device)
            per_step.append(step(rng, table, torch.from_numpy(ids).to(device),
                                 torch.from_numpy(lens).to(device)))
        return {k: torch.stack([m[k].float() for m in per_step]).mean() for k in per_step[0]}

    try:
        for epoch in range(start_epoch, args.num_train_epochs):
            pending = []
            for batch in train_ds.batches(global_batch, shuffle=True, seed=epoch,
                                          drop_last=True):
                if args.profile_dir and main_rank and global_step == 10 and not traced:
                    profiling.enter_context(trace(args.profile_dir, device))
                    traced = True
                prev_step = global_step
                pending.append((batch.item_ids, batch.seq_lens))
                if len(pending) < args.steps_per_call:
                    continue
                metrics = run_steps(pending)
                pending = []
                global_step += args.steps_per_call
                if args.profile_dir and 15 <= global_step < 15 + args.steps_per_call:
                    profiling.close()
                # "crossed the interval": with steps_per_call > 1 the count
                # advances in strides and can skip every multiple
                if _crossed(50, prev_step, global_step):
                    m = {k: float(v) for k, v in metrics.items()}
                    rate = global_batch * (global_step - last_log_step) / (time.time() - t0)
                    t0 = time.time()
                    last_log_step = global_step
                    m["examples_per_sec"] = rate
                    logger.log(global_step, m)
                    say(f"[pretrain] step {global_step} loss {m['loss']:.4f} "
                        f"acc {m['accuracy']:.4f} ({rate:.1f} ex/s)")
                if _crossed(args.valid_step_interval, prev_step, global_step):
                    acc = validate_and_keep_best()
                    logger.log(global_step, {"dev_accuracy": acc})
                    say(f"[pretrain] dev accuracy {acc:.4f}")
                signum = stop_signal()
                if signum:
                    save_state(epoch)
                    save_last()
                    logger.log(global_step, {"preempted": 1.0})
                    say(f"[pretrain] preemption checkpoint at step {global_step} (signal "
                        f"{signum}); restart with --resume (the interrupted epoch "
                        "restarts from its first batch)", flush=True)
                    return {"steps": global_step, "updates": optimizer.updates,
                            "best_dev_accuracy": best_acc, "preempted": signum}
            acc = validate_and_keep_best()
            say(f"[pretrain] epoch {epoch} dev accuracy {acc:.4f}")
            save_last()
            save_state(epoch + 1)
    finally:
        profiling.close()
        logger.close()
        _restore_handlers(handlers)
    if main_rank:
        config.save(os.path.join(args.output_dir, "config.json"))
    say(f"[pretrain] done; {global_step} steps, {optimizer.updates} updates; "
        f"best dev accuracy {best_acc:.4f}")
    return {"steps": global_step, "updates": optimizer.updates, "best_dev_accuracy": best_acc}


if __name__ == "__main__":
    main()
