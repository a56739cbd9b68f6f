#!/usr/bin/env python3
"""Drive every path of the PyTorch port once on one CUDA card, kernels held to their plain versions.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the paths, from the repository's sources, one
   ``nvcc`` per source, all started together;
3. kernel_check: both attention kernels against their plain PyTorch versions
   on the same inputs, at the shapes of the JAX kernel tests, at the two
   Recformer-base shapes, at the analytics tower's (64, 1024), at the
   tensor-parallel phases' views (16 x 1024 and 16 x 128, 6 heads) and at the
   tensor-core versions' edges (L off the
   tiles, tiles of padding rows, no valid global, the global row away from
   0, eight globals unfused, many (batch, head) pairs), float32 and
   bfloat16, attention dropout 0 and 0.1 (one seed): the forward on max abs
   error (<= 1e-4 / 2e-2), each of the backward's six outputs on
   max|err| / max|ref| (<= 1e-4 / 1e-2), bitwise equal on a second call;
   both through their tensor-core versions exactly for bf16 at D = W = 64;
4. dropout_check: at the sequence tower's shape, determinism per seed, the
   keep fraction (0.9 +- 0.005), mean-field unbiasedness over 64 seeds and
   forward/backward mask agreement (a directional derivative along v);
5. kernel_time: both attention kernels at dropout 0 and 0.1, their plain
   versions and one PyTorch library call (``scaled_dot_product_attention``
   with an explicit band+global mask, and its backward, both without
   dropout) at the base shapes (the forward also at the analytics tower's),
   median of per-launch CUDA-event times and
   the device time per launch from a CUDA graph (the backward's also by
   pass, from ``torch.profiler``; SDPA's forward and backward also from a
   graph), beside the least time the card could take and the times before
   the tensor-core redesign;
6. ln_kernel_check: the embedding LayerNorm forward and backward and the
   LayerNorm backward against their plain versions at the main path's rows
   (16,384, 2,048 and 32,768 of 768), 1,000 rows, a narrow row of 64 and
   the backward's grid edges (1, 2,051 and 131,072 rows), float32 and
   bfloat16: the forward on max abs error (<= 1e-5) or one bf16 ulp,
   dx/dgamma/dbeta on max|err| / max|ref| (<= 1e-4 / 1e-2), dgamma/dbeta
   bitwise equal over two calls and over two replays of a CUDA graph, and
   the LayerNorm backward's dx from a float32 gamma off the bf16 grid equal
   bit for bit to its dx from that gamma rounded (the kernel rounds it);
7. ln_kernel_time: the three at their main-path shapes beside their plain
   versions, ``F.layer_norm`` (forward, or its backward: host-timed through
   autograd and by graph through ``aten.native_layer_norm_backward``) and
   the bound, with the device kernels one call runs (one each);
7b. probe_check: the two probe kernels of ``ops/band_probes.py`` (TPU
   kernels 6 and 7: kernel 1's band forward with parts removed, five
   variants; the band products per head and per head pair) against their
   plain versions, bf16, max|err| / max|ref| <= 1e-2, at the probes'
   defaults (B 16, L 1024, H 12, D 64, W 64) at block_q 256, 128, 64 and
   16, with keyloc zero runs and invalid globals, rows with no valid key
   (and no valid global) at block_q 16, 48, 64 and 256, eight globals at
   256, bands longer than the ring (block_q 512, 1024), and at irregular
   edges; probe_sass: the warpgroup MMA and TMA
   instructions ``cuobjdump -sass`` counts in the probes' library (each
   > 0) and ``-Xptxas -v``'s registers and spills of its kernels;
7c. probe_time: the probes' entry points (``python -m
   recformer_tpu_torch.benchmarks.kernel_ablation`` / ``.headpair_probe``)
   at block_q 256 and 16, each variant's CUDA-graph and host time beside
   kernel 1's graph time on the same inputs, the plain versions, the
   bound, the share of the bound and the times before the redesign for
   wgmma and TMA; the launches of this phase are the probe kernels' (their
   path);
8. serving: Recformer-base (random weights from ``--seed``) encodes a
   synthetic 10,000-item catalog, ranks it for 256 users, and the serve CLI
   answers a few users;
8b. serve_graph: the backbone's CUDA graphs for serving at Recformer-base,
   a rank request's (32, 1024) under ``no_grad`` and an encode chunk's
   (256, 128) under ``inference_mode``: the eager, capturing and replayed
   calls bitwise equal to ``forward_eager``, kernel 1's launches 12 a call
   (a replay adds what its capture recorded), a weight updated in place
   seen by the next replay, eager and replayed calls host-timed;
9. encode_embed_kernel: 2,048 items encoded under ``embed_ln_impl='pallas'``,
   pooled cosine against the default path > 0.999;
9b. offline_clis: ``cli.encode_items`` (512 items) and ``cli.evaluate_seq``
   (64 users, a fresh catalog, then encode_items' saved catalog: the same
   metrics) at base width under ``--embed_ln_impl pallas``, launches of
   kernels 1 and 3 as the code says;
10. pretrain_step: 20 base-width pretraining steps at batch 8 (two views,
    fused clean+MLM towers, dropout 0.1, AdamW), steps/s, the whole-word
    MLM's time, peak memory, the device kernels of one step
    (``torch.profiler``); then 10 steps on one fixed batch with dropout
    off, whose loss must fall; pretrain_step_ln_kernels: the same under
    ``embed_ln_impl='pallas'`` and ``ln_impl='pallas_bwd'``, beside it, each
    LayerNorm kernel launch one device kernel;
    pretrain_turns: both configurations timed in alternating blocks of 6
    steps;
11. pretrain_vs_chunked and pretrain_ln_kernels_vs_plain: the float32
    gradients of one deterministic step through the attention kernels
    against the plain chunked attention, and through the LayerNorm kernels
    against the plain split LayerNorm: cosine > 0.999, and each attention
    projection's (each LayerNorm parameter's) gradient within 1e-3 relative;
12. pretrain_cli, pretrain_cli_ln_impl: ``cli.pretrain --model_size base
    --device cuda`` on a small corpus (accumulation 2, dev validation, best,
    last, the train state and ``--save_top_k 2`` saved), then again with
    ``--ln_impl pallas_bwd``; pretrain_cli_preemption: a real SIGTERM after
    the 5th step, latched by the CLI's handler, saves the train state and
    last at step 5; ``--resume`` runs to the end (``--save_top_k 1``);
13. finetune_step, finetune_step_sampled: 20 base-width finetune steps at
    batch 16 over the 10,000-item table (histories of 16-50 items, the
    history view at (16, 1024)), dropout 0.1, accumulation 8, the full
    softmax over a random catalog or 1,000 sampled negatives: steps/s,
    examples/s, peak memory, one profiled step (device kernels, busy time,
    idle share), 12 + 12 attention launches a step, all on the tensor cores;
    then 20 steps on one fixed batch with dropout off, whose loss must fall;
14. finetune_vs_chunked: the float32 gradients of one finetune loss through
    the attention kernels against the chunked twin (the gate of 11, and the
    pooled outputs' cosine > 0.999);
15. finetune_cli, finetune_cli_resume: ``cli.finetune --model_size base
    --device cuda`` on 512 items and 32 users (histories of 16-50 items),
    two epochs a stage: outputs written, finite test metrics, kernel 1 and 2
    launches as the code says (encodes, train steps, dev and test ranking);
    then a run stopped at its first stage-2 dev row and continued with
    ``--resume``: the restored parameters equal the saved train state bit
    for bit, and it resumes at stage 2 epoch 0;
16. fraud_corpus: ``pipelines.synthetic_transactions --scale small --build``
    (400 + 100 cards of 5-60 transactions, fraud bursts planted);
    fraud_step: 20 base-width fraud steps at batch 16 over its
    classification split's cards with their labels (histories of 5-65
    items, the view at (16, 1024)), dropout 0.1 and the head's 0.2,
    ``pos_weight`` from the split, the head at 1e-3: steps/s, examples/s,
    peak memory, one profiled step, 12 + 12 attention launches a step, all
    on the tensor cores; then 20 steps on one fixed batch (half fraudulent)
    with every dropout off, whose loss must fall;
17. fraud_vs_chunked: the float32 gradients of one fraud loss through the
    attention kernels against the chunked twin (the gate of 11 over the
    backbone's gradients, the cosine of all of them, each head tensor within
    1e-3 relative, the logits within 1e-3);
18. convert_ckpt: pretrain_cli's ``best.pt`` through ``cli.convert_ckpt
    --model_size base``: every backbone tensor of ``recformer.pt``,
    ``seqrec.pt`` and ``fraud.pt`` bit-equal to the source, the fraud head
    the seeded initialiser's; ``seqrec.pt`` into ``cli.finetune
    --pretrain_ckpt`` (every tensor copied) for one epoch a stage;
19. fraud_cli, fraud_cli_resume: ``cli.finetune_classification --model_size
    base --device cuda --pretrain_ckpt fraud.pt`` (every tensor copied) on
    the corpus, 2 epochs at batch 16, sweeps at 32, ``--head_lr 1e-3``:
    kernel 1 and 2 launches as the code says (train steps, dev and test
    sweeps), the outputs written; then a run that dies at its second dev
    sweep and is continued with ``--resume``: the restored parameters equal
    the saved train state bit for bit, and its test metrics equal the
    uninterrupted run's;
20. cluster_fraud_overlay: ``cli.cluster --n_clusters 4 --fraud_labels``
    on the fraud corpus's ``finetune_data/`` from convert_ckpt's
    ``recformer.pt`` (user i flagged as the i-th card in sorted order), with
    ``--projection tsne`` and ``umap``: ``mean_fraud`` in every cluster;
21. synthetic_corpus: ``pipelines.synthetic --scale paper`` (the smallest
    paper category: 5,300 items and 11,000 users to finetune on);
    native: the host library (``g++``, built after the kernels) against its
    plain twins there: the epoch shuffle of 11,000 rows for seeds 0-3, one
    epoch of batches of 64, the 5,300-item tokenized table, with the host
    ms of each C++ entry point and its twin;
22. cluster_cli, cluster_cli_cached: ``cli.cluster --model_size base
    --batch_size 64 --min_clusters 2 --max_clusters 10 --projection pca``
    on that corpus, nothing cut: outputs, finite (11,000, 768) embeddings,
    labels in [0, k), kernel 1 launched 12 x (ceil(items/256) +
    ceil(users/64)) times, the seconds of each stage, the tower's users/s
    and the peak memory; then the same command again: a cache hit with no
    launch and byte-equal labels, stats and sweep;
23. cluster_kmeans_vs_plain: the card's float32 Lloyd loop on those
    embeddings at the optimal k against the same loop in float64 on the CPU
    from the same centres: >= 99.9% of labels equal, inertia within 1e-4
    relative; cluster_vs_chunked: two batches of 64 histories in float32
    through kernel 1 and through the chunked attention, pooled cosine >
    0.999 on every row;
24. remat_step: the base pretraining step at batch 8 with dropout 0.1 from
    one set of weights, without remat and under ``full``,
    ``save_attention``, ``dots`` and ``dots_attn``: kernel 1 and 2
    launches a step (48/24 under ``full`` and ``dots``, 24/24 otherwise),
    the peak memory of 2 steps, host-timed steps/s, one profiled step
    (device kernels, busy ms); the gradients of one loss at one ``StepRNG``
    seed within 1e-5 (max|err| / max|ref|, each tensor) of no remat's, the
    generators ending where no remat's end; the control, a recomputation
    from fresh generators, must fail that gate; the peaks ordered ``full`` <
    ``save_attention`` <= ``dots_attn`` <= none and ``full`` < ``dots`` <=
    ``dots_attn``; remat_step_ln_kernels: ``full`` and ``save_attention``
    under ``embed_ln_impl='pallas'``, ``ln_impl='pallas_bwd'``, the same
    counts and gate;
25. remat_finetune_step: the finetune step (1,000 negatives) under
    ``save_attention`` and ``full``: launches (12/12, 24/12) and peak;
26. amazon_pipeline: ``pipelines.amazon`` on a synthetic Amazon-format dump
    at the smallest paper category's scale (5,300 items, 11,000 users of
    5-14 reviews) plus a 2,000-user dev category: host seconds, items,
    users, split sizes;
27. pretrain_cli_host_flags: ``cli.pretrain --model_size base --remat
    --remat_policy dots_attn --steps_per_call 2 --log_dir --mirror_file
    --profile_dir`` on that pretrain corpus trimmed to 18 steps: log rows
    equal to the mirror's at steps 8 and 16, a trace naming kernels 1 and 2,
    launches as the code says;
28. finetune_cli_remat: ``cli.finetune --remat --remat_policy
    save_attention`` on that category trimmed to 128 users, one epoch a
    stage: launches as the code says, finite test metrics;
29. example: ``recformer_tpu_torch.examples.synthetic_end_to_end --device
    cuda``, its six stages ending in ``ALL STAGES COMPLETE``;
30. a world of 2 ranks on the card, started with ``torch.distributed.run
    --standalone`` (this script in rank mode; ``gloo`` with CUDA tensors,
    since NCCL refuses two ranks on one device; every rank under PyTorch's
    deterministic algorithms, turned on before any CUDA work, as tensor
    parallelism needs): dist_check, each
    collective of ``parallel/collectives.py`` against local arithmetic, bit
    for bit; dp_pretrain_step, base width, batch 8 a rank, dropout 0.1,
    ``contrastive_gradient='full'``, 1 warm-up + 4 timed steps (each
    rank's launches a step, 24/24 on the tensor cores, peak GiB, steps/s),
    then the float32 gradients of one deterministic step over the 2 ranks
    (a global batch of 8, 4 a rank) against the one-rank step on that batch
    (the gate of 11); dp_local_step, ``'local'`` on one fixed batch without
    dropout, 6 steps, whose loss must fall; zero_step, 3 steps of one
    backward each updated by plain DP's AdamW and by ZeRO's: the updates
    bit-equal, each one's AdamW state a rank (ZeRO's the share the
    placement rule predicts) and host-timed update, the backward's
    launches; tp_step,
    model 2 at batch 8 with dropout, both ``global_kv_mode``s, 6 heads a
    rank, 24/24 on the tensor cores, the replicated tensors equal across the
    ranks, the gathered float32 gradients against the one-rank step;
    sharded_catalog: 10,000 and 10,001 rows of 768 over the 2 ranks against
    the dense path: ranks, ``valid_length`` and top-k ids exact, scores and
    loss within 1e-5, the loss's gradient in ``pooled`` within 1e-5
    relative, and no padded id for users whose every score is negative;
31. dp_tp_step_ln_kernels: a world of 4 (data 2 x model 2) under
    ``embed_ln_impl='pallas'``, ``ln_impl='pallas_bwd'`` and ``--remat
    --remat_policy save_attention``, 2 steps: launches a step as the code
    says (kernel 1 not relaunched in the backward), each LayerNorm launch
    one device kernel;
32. parallel_clis, run by the world of 2 after its other phases, one
    command after another: ``cli.evaluate_seq --sharded_eval 2`` (float32; 1,001
    items, one padding row) within 1e-5 of one rank; ``cli.serve`` on 2
    ranks, the same ids as one rank; ``cli.pretrain --model_size base
    --tensor_parallel 2``, its ``best.pt`` whole and read by a one-rank
    ``cli.finetune`` for one epoch a stage; ``cli.pretrain --zero`` on 2
    data ranks with a SIGTERM on rank 1 alone after step 5: both ranks stop
    at step 5, and ``--resume`` runs to the end;
33. parallel_dryrun: ``parallel/dryrun.py``'s ``dryrun`` (what ``python -m
    recformer_tpu_torch.parallel.dryrun`` runs) at the end of the worlds of 2
    and 4: every step's loss finite and equal on every rank (its sequence-
    and pipeline-parallel forwards in both worlds, their steps in the world
    of 4);
34. sp_attention_check, in the world of 2 on a ``seq`` mesh of 2: the
    sequence-parallel op (``parallel/sequence.py``) at the history view's
    (16, 1024, 12, 64), window 64, padded rows and the CLS global on shard
    0, against ``chunked_attention`` on the whole inputs, float32 and bf16:
    the forward on max abs error (<= 1e-4 / 2e-2), each of its six
    gradients on max|err| / max|ref| (<= 1e-4 / 1e-2);
35. sp_step and pp_step in the world of 2 (seq 2; pipe 2 with 2
    microbatches and ``scan_layers``), sp_step_dp and pp_step_dp in the
    world of 4 (data 2 x seq 2, data 2 x pipe 2): base width, batch 8 a
    data rank, dropout 0.1, 1 warm-up + 2 timed steps: launches a step on
    each rank as the code says (none of kernels 1-2 under sp; 24/24 under
    pp, all on the tensor cores), peak GiB, steps/s, the device kernels of
    one profiled step; then the float32 gradients of one deterministic step
    against the one-rank step (cosine > 0.9999, each attention projection
    within 1e-3 relative);
36. parallel_cli_pretrain_sp, parallel_cli_pretrain_pp, run by the world of
    2 after the other CLIs: ``cli.pretrain --sequence_parallel 2
    --attention_impl sequence_parallel`` and ``--pipeline 2 --scan_layers
    --microbatches 2`` (a SIGTERM on rank 1 alone after step 2, then
    ``--resume``) on pretrain_cli's corpus, each ``best.pt`` whole and read
    by a one-rank ``cli.finetune`` for one epoch a stage.
37. modernbert: ModernBERT-large at its published widths
    (``RecformerConfig.modernbert_large()``): kernels 1-2 at W 128 with no
    global column against their plain versions (float32 and bf16, dropout 0
    and 0.1; the forward on the tensor cores in bf16, the backward on its
    CUDA-core passes; bitwise equal on a second call); kernel 1 at W 128 and
    the global layers' attention timed at the rank cell's (32, 8192) beside
    their bounds; one pretraining micro-step of 2 users (views (4, 8192) and
    (4, 128), remat ``full``) in float32 against the plain float32 reference
    (``recformer_tpu_torch/reference/modernbert.py``: loss within 1e-4, the
    worst gradient leaf within 1e-2) and in bf16 (its gaps reported), with
    their launches counted; the rank forward at (32, 8192) eager, captured
    and replayed, each bitwise equal to ``forward_eager``, each call 18
    kernel-1 launches on the tensor cores, 10 global-attention launches on
    a fused backend and 57 residual-sum + LayerNorm launches, 28 of them
    with the residual (``ops/add_layernorm.py``); that kernel checked and
    timed at the rank cell's 262,144 rows of 1,024 in bf16, with and without
    the residual, beside its bytes bound, the plain chain it replaced and
    the library route (``x + d`` then ``F.layer_norm``; ``add_layernorm_time``). ``python3 chip_smoke.py --only modernbert`` builds,
    runs kernel_check and kernel_time, then this phase (no result line).
38. train_graph (run after serve_graph): the training micro-step's CUDA
    graphs (``utils/graphs.py``, ``training/steps.py``) at Recformer-base, pretraining at
    batch 8 and accumulation 8 over 24 micro-steps and fraud training at
    batch 16 over 5 steps, each beside the eager step from the same weights
    and draws: every call's metrics, every gradient the optimizer gets and
    every parameter after each update bitwise equal (both under PyTorch's
    deterministic algorithms); one capture, replays =
    calls - 2, kernel 1-2 launches a call as the code says; the step
    host-timed eager and replayed; kernel 1's device time at dropout 0 at W
    64 and W 128 beside PR 18's, and at dropout 0.1 with its seed passed as
    an int and read from device memory. ``python3 chip_smoke.py --only
    train_graph`` builds, runs kernel_check, then this phase (no result
    line).

Launch counts, set to 0 just before each path and read just after, show that
the paths ran the kernels (each kernel on its path at least once; the
probes' path is probe_time), as many times as the code says they must (the
attention kernels' tensor-core launches among them: every forward of
serving, all 24 forwards and 24 backwards of a bf16 pretraining step and
the 12 and 12 of a finetune or fraud step; the ranks of 30-36 report theirs,
added over the ranks). Then the command time, the kernels line,
the card line and, last, the result line. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import re
import shutil
import signal
import sys
import tempfile
import time

import numpy as np
import torch

from recformer_tpu_torch.utils.io import read_json
from recformer_tpu_torch.utils.timing import (busy_ms, capture, card_line, graph_launch_ms,
                                              host_ms)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 core
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # forward, on max abs error
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # backward, each output's rel_err
BWD_OUTPUTS = ("dq", "dk", "dv", "dgk", "dgv", "dgout")
BASE_SHAPES = {"item_tower": (256, 128), "sequence_tower": (16, 1024)}  # (B, L), H=12 D=64 W=64
# cli.cluster's sequence tower: kernel 1 (forward only) at 64 histories
ANALYTICS_SHAPE = {"analytics_tower": (64, 1024)}
# the pretraining step's two views at batch 8 under tensor parallelism 2: (2B, L), H = 6
TP_SHAPES = {"tp_sequence_view": (16, 1024), "tp_item_view": (16, 128)}


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the script's seconds so far (``at_s``)."""
    print(json.dumps({"phase": phase, **kw, "at_s": time.perf_counter() - T_START}), flush=True)


def synthetic_table(cfg, n_items: int, seed: int):
    """Random packed item table with plausible lengths and types (the JAX
    package's ``__graft_entry__.py`` builds its catalog the same way)."""
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    ids = rng.integers(4, cfg.vocab_size - 1, size=(n_items + 1, M)).astype(np.int32)
    types = np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32), (n_items + 1, 1))
    begin = rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32)
    begin[:, 0] = 1
    lengths = rng.integers(6, M + 1, size=n_items + 1).astype(np.int32)
    ids[-1] = cfg.pad_token_id
    lengths[-1] = 0
    return {"token_ids": ids, "token_types": types, "word_begin": begin, "lengths": lengths}


def median_launch_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median per-call time: events recorded between back-to-back calls."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for i in range(n):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([events[i].elapsed_time(events[i + 1]) for i in range(n)]))


# ---------------------------------------------------------------------------
# kernel inputs, checks and times
# ---------------------------------------------------------------------------

def band_case(gen, B, L, H, D, window, dtype, lengths=None, global_at_zero=True,
              extra_global=False, max_globals=1, global_rows=()):
    """Operands of the band-attention kernel on the card, built by the
    wrapper's own pre-processing. ``lengths``: valid tokens per row;
    ``global_rows``: further positions of global rows."""
    from recformer_tpu_torch.ops.window_attention import prepare_band_inputs

    dev = torch.device("cuda")
    q, k, v = ((torch.randn(B, L, H, D, generator=gen, device=dev) * 0.5).to(dtype)
               for _ in range(3))
    if lengths is None:
        lengths = [L] * B
    mask = (torch.arange(L, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    if global_at_zero:
        mask[:, 0] = 2
    if extra_global:
        mask[:, 5] = 2
    for r in global_rows:
        mask[:, r] = 2
    _, ops = prepare_band_inputs(q, k, v, mask, max_globals)
    ops["gout"] = (torch.randn(B, max_globals, H * D, generator=gen, device=dev) * 0.5).to(dtype)
    return ops


def rel_err(out, ref) -> float:
    """max|out - ref| / max|ref| (the abs error where ref is all zero)."""
    ref = ref.float()
    err = float((out.float() - ref).abs().max())
    scale = float(ref.abs().max())
    return err / scale if scale > 0 else err


def tensor_core_shape(dtype, D, window, G) -> bool:
    """Whether the backward takes its tensor-core passes (the C entry
    point's condition)."""
    return dtype == torch.bfloat16 and D == 64 and window == 64 and 1 <= G <= 8


def fwd_tensor_core_shape(dtype, D, window, G) -> bool:
    """Whether the forward takes its tensor-core kernel (W 64 or 128)."""
    return dtype == torch.bfloat16 and D == 64 and window in (64, 128) and G <= 8


def check_case(name, gen, dtype, fuse=True, **kw):
    """Both kernels against their plain versions on one case: the forward at
    dropout 0 and 0.1 (same seed), the backward's six outputs at dropout 0
    and 0.1, each output bitwise equal on a second call, and the backward's
    path (tensor cores exactly where ``tensor_core_shape`` says). Returns the
    forward's max abs error at dropout 0 and the backward's largest abs
    error over its outputs and both rates."""
    from recformer_tpu_torch.ops.window_attention import (band_attention, band_attention_bwd,
                                                          window_attention_bwd_plain,
                                                          window_attention_plain)

    B, L, H, D, window = (kw.pop(x) for x in ("B", "L", "H", "D", "window"))
    ops = band_case(gen, B, L, H, D, window, dtype, **kw)
    common = dict(num_heads=H, window=window, fuse_epilogue=fuse)
    G = ops["gk"].shape[1]
    want_fwd = "tensor_core" if fwd_tensor_core_shape(dtype, D, window, G) else "cuda_core"
    want_path = "tensor_core" if tensor_core_shape(dtype, D, window, G) else "cuda_core"
    fwd_err = bwd_err = 0.0
    for rate in (0.0, 0.1):
        drop = dict(dropout_rate=rate, seed=1234 + L)
        tc_before = read_counts()["band_attention_fwd_tc"]
        with torch.no_grad():
            out = band_attention(**ops, **common, **drop)
        torch.cuda.synchronize()
        tc = read_counts()["band_attention_fwd_tc"] - tc_before
        path = "tensor_core" if tc == 1 else "cuda_core"
        ref = window_attention_plain(**ops, **common, **drop)
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype] and path == want_fwd
        emit("kernel_check", kernel="band_attention_fwd", case=name,
             dtype=str(dtype).removeprefix("torch."), shape=[B, L, H, D], window=window,
             fused_epilogue=fuse, dropout=rate, path=path, max_abs_err=err, tol_abs=TOL[dtype],
             ok=ok)
        if not ok:
            raise AssertionError(f"forward kernel disagrees with its plain version: {name} "
                                 f"{dtype} rate {rate}, path {path}")
        if rate == 0.0:
            fwd_err = err

        dout = (torch.randn(B, L, H * D, generator=gen, device="cuda") * 0.5).to(dtype)
        if not fuse:  # the wrapper zeroes the gradient at global and padding rows
            dout = torch.where(ops["mrow"][:, :, None] == 1, dout, 0.0)
        tc_before = read_counts()["band_attention_bwd_tc"]
        got = band_attention_bwd(**ops, dout=dout, **common, **drop)
        again = band_attention_bwd(**ops, dout=dout, **common, **drop)
        torch.cuda.synchronize()
        tc = read_counts()["band_attention_bwd_tc"] - tc_before
        path = "tensor_core" if tc == 2 else "cuda_core"
        want = window_attention_bwd_plain(**ops, dout=dout, **common, **drop)
        errs = {n: rel_err(g, w) for n, g, w in zip(BWD_OUTPUTS, got, want)}
        abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        stable = all(torch.equal(g, a) for g, a in zip(got, again))
        ok = (all(bool(torch.isfinite(g.float()).all()) for g in got)
              and max(errs.values()) <= BWD_TOL[dtype] and stable and path == want_path)
        emit("kernel_check", kernel="band_attention_bwd", case=name,
             dtype=str(dtype).removeprefix("torch."), shape=[B, L, H, D], window=window,
             fused_epilogue=fuse, dropout=rate, path=path, rel_err=errs, max_abs_err=abs_err,
             tol_rel=BWD_TOL[dtype], bitwise_stable=stable, ok=ok)
        if not ok:
            raise AssertionError(f"backward kernel disagrees with its plain version: {name} "
                                 f"{dtype} rate {rate}: {errs}, stable {stable}, path {path}")
        bwd_err = max(bwd_err, abs_err)
    return fwd_err, bwd_err


def check_kernels(gen):
    small = dict(B=2, L=64, H=2, D=8, lengths=[64, 47])
    cases = {
        "w8": dict(small, window=8),
        "w16": dict(small, window=16),
        "no_globals": dict(small, window=8, global_at_zero=False),
        "item_tower_small": dict(small, L=32, lengths=[32, 23], window=16),
        "window_gt_tile": dict(small, window=32),
        "heads_3x8": dict(small, H=3, window=16),
        "heads_12x8": dict(small, H=12, window=16),
        "heads_2x128": dict(small, D=128, window=16),
        "heads_1x16": dict(small, H=1, D=16, window=16),
        "extra_global_demoted": dict(small, window=8, extra_global=True),
        "two_globals_unfused": dict(small, window=8, extra_global=True, max_globals=2,
                                    fuse=False),
        # base head width and window off the tile grid (tensor-core path in bf16)
        "d64_ragged_L": dict(B=3, L=200, H=2, D=64, window=64, lengths=[200, 150, 37]),
        "d64_no_globals": dict(B=2, L=128, H=3, D=64, window=64, lengths=[128, 90],
                               global_at_zero=False),
        "d64_two_globals_unfused": dict(B=2, L=128, H=2, D=64, window=64, lengths=[128, 77],
                                        extra_global=True, max_globals=2, fuse=False),
        # the tensor-core versions' edges: L off the 64- and 128-row tiles,
        # tiles of padding rows only, no valid global, the global row away
        # from 0 (and L off a multiple of 4, where the global columns' keep
        # bits are drawn one by one), eight globals without the fused
        # epilogue, a grid of many (batch, head) pairs
        "d64_L1000": dict(B=2, L=1000, H=2, D=64, window=64, lengths=[1000, 613]),
        "d64_padding_tiles": dict(B=2, L=384, H=2, D=64, window=64, lengths=[384, 100]),
        "d64_no_globals_L200": dict(B=2, L=200, H=2, D=64, window=64, lengths=[200, 131],
                                    global_at_zero=False),
        "d64_global_at_37_L203": dict(B=2, L=203, H=2, D=64, window=64, lengths=[203, 160],
                                      global_at_zero=False, global_rows=(37,)),
        "d64_eight_globals_unfused": dict(B=2, L=256, H=2, D=64, window=64, lengths=[256, 200],
                                          global_rows=(3, 9, 40, 77, 100, 130, 190),
                                          max_globals=8, fuse=False),
        "d64_many_heads": dict(B=48, L=256, H=12, D=64, window=64,
                               lengths=[256 - 5 * b for b in range(48)]),
    }
    rng = np.random.default_rng(0)
    for name, (B, L) in {**BASE_SHAPES, **ANALYTICS_SHAPE}.items():
        cases[name] = dict(B=B, L=L, H=12, D=64, window=64,
                           lengths=rng.integers(L // 4, L + 1, size=B).tolist())
    # the tensor-parallel phases' views: 6 of the 12 heads a rank
    for name, (B, L) in TP_SHAPES.items():
        cases[name] = dict(B=B, L=L, H=12 // 2, D=64, window=64,
                           lengths=rng.integers(L // 4, L + 1, size=B).tolist())
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, kw in cases.items():
            errs[(name, dtype)] = check_case(name, gen, dtype, **dict(kw))
    return errs


def dropout_check(gen, card):
    """The kernels' dropout at the sequence tower's shape (bf16, rate 0.1):
    determinism per seed, the keep fraction, mean-field unbiasedness over 64
    seeds, and forward/backward mask agreement (the output is linear in v
    for a fixed mask, so the derivative along a random dv equals
    <grad_v, dv> only if the backward regenerates the forward's mask)."""
    from recformer_tpu_torch.ops.window_attention import band_attention

    B, L = BASE_SHAPES["sequence_tower"]
    H, D, W, rate = 12, 64, 64, 0.1
    lengths = np.random.default_rng(2).integers(L // 4, L + 1, size=B).tolist()
    ops = band_case(gen, B, L, H, D, W, torch.bfloat16, lengths=lengths)
    common = dict(num_heads=H, window=W, fuse_epilogue=True)
    local = (ops["mrow"] == 1)[:, :, None]

    def run(seed, rate_=rate, **over):
        with torch.no_grad():
            return band_attention(**dict(ops, **over), **common, dropout_rate=rate_,
                                  seed=seed).float()

    o1, o2, o3, clean = run(7), run(7), run(8), run(0, 0.0)
    determinism = bool(torch.equal(o1, o2) and not torch.equal(o1, o3)
                       and not torch.equal(o1, clean))

    # keep fraction: with q = 0 every valid column scores 0 and, with v = 1
    # and float32, a local row's output is kept columns / (1 - rate) / valid
    ops32 = {n: (t.float() if t.is_floating_point() else t) for n, t in ops.items()}
    with torch.no_grad():
        ones = band_attention(**dict(ops32, q2=torch.zeros_like(ops32["q2"]),
                                     v2=torch.ones_like(ops32["v2"]),
                                     gv=torch.ones_like(ops32["gv"])),
                              **common, dropout_rate=rate, seed=11)
    half = W // 2
    keyloc = torch.nn.functional.pad(ops["keyloc"], (half, half))
    n_valid = (keyloc.unfold(1, W + 1, 1).sum(-1) + ops["gvalid"].sum(-1, keepdim=True)).float()
    kept = ones.view(B, L, H, D)[..., 0] * (1.0 - rate) * n_valid[:, :, None]  # (B, L, H)
    sel = ops["mrow"] == 1
    keep_fraction = float(kept[sel].sum() / (n_valid[sel].sum() * H))

    K = 64
    acc = torch.zeros_like(clean)
    for s in range(K):
        acc += run(100 + s)
    ref = clean[local.expand_as(clean)]
    rel_mean = float(torch.linalg.norm(acc[local.expand_as(acc)] / K - ref)
                     / torch.linalg.norm(ref))
    rel_one = float(torch.linalg.norm(run(100)[local.expand_as(clean)] - ref)
                    / torch.linalg.norm(ref))
    unbiased = rel_mean < 1.6 * rel_one / math.sqrt(K)

    # forward/backward mask agreement. The loss weights w are the forward's
    # own difference along dv, so the derivative <w, J dv> is a sum of
    # squares: with random weights it is a sum of random signs, which can
    # come out small enough for the outputs' bf16 rounding to dominate it.
    dv = (torch.randn(B, L, H * D, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    v = ops["v2"].detach().clone().requires_grad_()

    def delta(seed):
        return (run(seed, v2=(v.detach().float() + dv.float()).to(torch.bfloat16))
                - run(seed, v2=(v.detach().float() - dv.float()).to(torch.bfloat16)))

    w = delta(42)
    loss = (band_attention(**dict(ops, v2=v), **common, dropout_rate=rate, seed=42).float()
            * w).sum()
    (g,) = torch.autograd.grad(loss, v)
    analytic = float((g.float() * dv.float()).sum())
    f_same = float((w * w).sum()) / 2.0
    f_other = float((w * delta(43)).sum()) / 2.0
    rel_same = abs(analytic - f_same) / max(abs(f_same), 1e-6)
    rel_other = abs(analytic - f_other) / max(abs(f_other), 1e-6)
    agree = rel_same < 2e-2 and rel_other > 3 * rel_same
    ok = determinism and abs(keep_fraction - (1 - rate)) <= 0.005 and unbiased and agree
    emit("dropout_check", shape=[B, L, H, D], rate=rate, determinism=determinism,
         keep_fraction=keep_fraction, mean_field_rel_err=rel_mean, one_seed_rel_err=rel_one,
         seeds=K, vjp_analytic=analytic, vjp_fd=f_same, vjp_rel_err=rel_same,
         vjp_rel_err_other_seed=rel_other, card=card, ok=ok)
    if not ok:
        raise AssertionError("attention dropout check failed")


def useful_pairs(ops, window) -> int:
    """(query, key) pairs the local rows need: in-band local keys plus the
    valid global columns (global and padding rows are overwritten)."""
    half = window // 2
    keyloc = torch.nn.functional.pad(ops["keyloc"], (half, half))
    band = keyloc.unfold(1, window + 1, 1).sum(-1)  # (B, L)
    per_row = band + ops["gvalid"].sum(-1, keepdim=True)
    return int((per_row * (ops["mrow"] == 1)).sum())


def sdpa_mask(ops, window):
    """The band+global boolean mask of the local rows, (B, 1, L, L)."""
    B, L, HD = ops["q2"].shape
    half = window // 2
    idx = torch.arange(L, device=ops["q2"].device)
    band = (idx[:, None] - idx[None, :]).abs() <= half
    allowed = band[None] & (ops["keyloc"] != 0)[:, None, :]
    gcol = ops["mrow"] == 2  # the kept global row enters as a key column
    return (allowed | gcol[:, None, :])[:, None]


def sdpa_call(ops, H, D, window):
    """One PyTorch call computing the local rows: SDPA with an explicit
    band+global boolean mask."""
    B, L, HD = ops["q2"].shape
    allowed = sdpa_mask(ops, window)
    q, k, v = (ops[n].view(B, L, H, D).transpose(1, 2) for n in ("q2", "k2", "v2"))
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed)


def sdpa_bwd_call(ops, H, D, window, dout):
    """The backward of that SDPA call: autograd.grad of its output."""
    B, L, HD = ops["q2"].shape
    allowed = sdpa_mask(ops, window)
    q, k, v = (ops[n].view(B, L, H, D).transpose(1, 2).detach().requires_grad_()
               for n in ("q2", "k2", "v2"))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
    g = dout.view(B, L, H, D).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def sdpa_bwd_graph_ms(ops, H, D, window, dout):
    """The SDPA backward's device time per call from a CUDA graph: the
    forward runs on a side stream, so autograd launches the backward there
    and the graph captures it. Returns (ms, how), ms None if capture
    failed (``how`` then says why; the host-timed figure stands alone)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call = sdpa_bwd_call(ops, H, D, window, dout)
    try:
        return graph_launch_ms(call, stream=side), "captured on the forward's stream"
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f"CUDA-graph capture failed: {str(e)[:200]}"


def bound(nbytes, ops_count, dtype):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / PEAK_OPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# kernels 1 and 2's times before their redesign for the tensor cores (bf16,
# host-timed median, NVIDIA H100 80GB HBM3 at 700 W; PERF.md), kept in the
# rows beside this run's
EARLIER_MS = {
    "band_attention_fwd": {"sequence_tower": {"dropout_0": 0.0860, "dropout_0.1": 0.1227},
                           "item_tower": {"dropout_0": 0.1619, "dropout_0.1": 0.2228}},
    "band_attention_bwd": {"sequence_tower": {"dropout_0.1": 1.9066},
                           "item_tower": {"dropout_0.1": 3.3805}},
}


def device_ms_by_kernel(fn, n: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches (the
    backward's passes), from ``torch.profiler`` over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in device_kernels(prof.events()):
        m = re.search(r"band_\w+", e.name)
        k = m.group(0) if m else e.name[:40]
        ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return ms


def time_kernels(gen, card):
    """Both kernels at the two base shapes, and the forward at the analytics
    tower's (64, 1024) (bf16; attention dropout 0 and 0.1), host-timed (median of back-to-back calls) and as device time from a
    CUDA graph, beside the plain versions, SDPA (forward, and its backward,
    both without dropout: the like-for-like figure is the kernels' dropout-0
    time) and the bound; the backward's device time also by pass."""
    from recformer_tpu_torch.ops import window_attention as wa

    H, D, W = 12, 64, 64
    rate = 0.1
    rows = {"band_attention_fwd": {}, "band_attention_bwd": {}}
    rng = np.random.default_rng(1)
    for name, (B, L) in {**BASE_SHAPES, **ANALYTICS_SHAPE}.items():
        dtype = torch.bfloat16
        ops = band_case(gen, B, L, H, D, W, dtype,
                        lengths=rng.integers(L // 4, L + 1, size=B).tolist())
        common = dict(num_heads=H, window=W, fuse_epilogue=True)
        elt = ops["q2"].element_size()
        G = ops["gk"].shape[1]
        pairs = useful_pairs(ops, W)
        with torch.no_grad():
            fwd = {r: (lambda r=r: wa.band_attention(**ops, **common, dropout_rate=r, seed=5))
                   for r in (0.0, rate)}
            kernel_ms = {r: median_launch_ms(f) for r, f in fwd.items()}
            device_ms = {r: graph_launch_ms(f) for r, f in fwd.items()}
            plain_ms = median_launch_ms(lambda: wa.window_attention_plain(**ops, **common),
                                        n=10, warmup=1)
            library_ms = median_launch_ms(sdpa_call(ops, H, D, W))
            library_graph_ms = graph_launch_ms(sdpa_call(ops, H, D, W))
        nbytes = (4 * B * L * H * D * elt + 3 * B * G * H * D * elt
                  + 2 * B * L * 4 + B * G * 4)
        b_ms, b_by = bound(nbytes, 4 * D * H * pairs, dtype)
        rows["band_attention_fwd"][name] = dict(
            shape=[B, L, H, D], window=W, dtype="bfloat16", ms=kernel_ms[0.0],
            ms_dropout=kernel_ms[rate], graph_ms=device_ms[0.0],
            graph_ms_dropout=device_ms[rate], plain_ms=plain_ms, library_ms=library_ms,
            library_graph_ms=library_graph_ms,
            library_call="scaled_dot_product_attention, band+global boolean mask",
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=4 * D * H * pairs,
            earlier_ms=EARLIER_MS["band_attention_fwd"].get(name), card=card)
        emit("kernel_time", kernel="band_attention_fwd", case=name,
             **rows["band_attention_fwd"][name])
        if name not in BASE_SHAPES:  # the analytics tower runs the forward only
            continue

        dout = (torch.randn(B, L, H * D, generator=gen, device="cuda") * 0.5).to(dtype)
        bwd = {r: (lambda r=r: wa.band_attention_bwd(**ops, dout=dout, **common,
                                                     dropout_rate=r, seed=5))
               for r in (0.0, rate)}
        kernel_ms = {r: median_launch_ms(f) for r, f in bwd.items()}
        device_ms = {r: graph_launch_ms(f) for r, f in bwd.items()}
        passes_ms = {f"dropout_{r:g}": device_ms_by_kernel(f) for r, f in bwd.items()}
        plain_ms = median_launch_ms(
            lambda: wa.window_attention_bwd_plain(**ops, dout=dout, **common,
                                                  dropout_rate=rate, seed=5), n=5, warmup=1)
        library_ms = median_launch_ms(sdpa_bwd_call(ops, H, D, W, dout))
        library_graph_ms, library_graph_note = sdpa_bwd_graph_ms(ops, H, D, W, dout)
        # q, k, v, dout read; dq, dk, dv written; keyloc, mrow and gvalid
        # read; gk, gv read; dgk, dgv, dgout written (fp32, as the TPU
        # kernel's). The kernel's own scratch (row statistics, tile
        # partials) is not work the function needs, so it is not counted.
        nbytes = (7 * B * L * H * D * elt + 2 * B * L * 4 + B * G * 4
                  + 2 * B * G * H * D * elt + 3 * B * G * H * D * 4)
        b_ms, b_by = bound(nbytes, 10 * D * H * pairs, dtype)
        rows["band_attention_bwd"][name] = dict(
            shape=[B, L, H, D], window=W, dtype="bfloat16", dropout=rate, ms=kernel_ms[rate],
            ms_no_dropout=kernel_ms[0.0], graph_ms=device_ms[rate],
            graph_ms_no_dropout=device_ms[0.0], passes_ms=passes_ms, plain_ms=plain_ms,
            library_ms=library_ms, library_graph_ms=library_graph_ms,
            library_graph_note=library_graph_note,
            library_call="autograd backward of that SDPA call (no dropout)",
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=10 * D * H * pairs,
            earlier_ms=EARLIER_MS["band_attention_bwd"][name], card=card)
        emit("kernel_time", kernel="band_attention_bwd", case=name,
             **rows["band_attention_bwd"][name])
    return rows


# ---------------------------------------------------------------------------
# the LayerNorm kernels: checks and times
# ---------------------------------------------------------------------------

LN_EPS = 1e-5  # RecformerConfig.layer_norm_eps
LN_FWD_TOL = 1e-5  # float32 forward, max abs; bf16: one bf16 ulp of each reference element,
# taken no finer than at LN_ULP_FLOOR: below it an output is a cancellation
# x_hat * gamma ~ -beta whose float32 rounding (~1e-7 absolute, the row
# means summed in another order) is larger than its own bf16 ulp
LN_ULP_FLOOR = 2.0 ** -8
# (rows, H): the pretraining towers (2B x 1024 and 2B x 128 at batch 8), the
# encode chunk (256 x 128), a row count no power of two divides, a narrow row,
# and the backward's persistent grid's edges: one row (every block but one
# idle), a multiple of 8 plus 3 past the item tower (the grid's warps get
# unequal rows), and rows enough that every warp walks a hundred and more
LN_SHAPES = {"sequence_tower": (16384, 768), "item_tower": (2048, 768),
             "encode_chunk": (32768, 768), "ragged_rows": (1000, 768), "narrow": (1000, 64),
             "one_row": (1, 768), "grid_edge": (2051, 768), "many_rows": (131072, 768)}
LN_KERNELS = ("embed_layernorm_fwd", "embed_layernorm_bwd", "layernorm_bwd")


def graph_replays(fn, replays: int = 2) -> list:
    """Copies of the outputs of one call of ``fn`` captured in a CUDA graph,
    after each of ``replays`` replays."""
    graph, out = capture(fn)
    runs = []
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in out])
    del graph
    return runs


def device_kernels(events) -> list:
    """The device-side events of a ``torch.profiler`` trace, without
    ``record_function`` ranges (such as ``Optimizer.step``), which the
    profiler also puts on the device's timeline but which are no kernels."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernels_per_call(fn, warm: bool = True) -> list:
    """The names of the device kernels one call of ``fn`` runs (after a
    warm-up call, unless ``warm`` is False: ``fn`` ran already), from a
    ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in device_kernels(prof.events())]


def bf16_ulp(ref):
    """One bf16 ulp of each element of ``ref`` (2**(e - 8) for |ref| in
    [2**(e-1), 2**e))."""
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def ln_case(gen, M, H, dtype):
    """Inputs of the three LayerNorm kernels: four addends, a block input,
    float32 gamma/beta near their initial values, dout."""
    dev = torch.device("cuda")

    def r(scale):
        return torch.randn(M, H, generator=gen, device=dev) * scale

    adds = [r(0.5).to(dtype) for _ in range(4)]
    x = r(2.0).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(H, generator=gen, device=dev)
    beta = 0.1 * torch.randn(H, generator=gen, device=dev)
    return adds, x, gamma, beta, r(1.0).to(dtype)


def check_ln_bwd(kernel, case, dtype, call, plain, rounded=None):
    """One backward kernel's (dx, dgamma, dbeta) against its plain version,
    each on max|err| / max|ref|; dgamma/dbeta bitwise equal over two calls
    and over two replays of a CUDA graph of one call (the replays also show
    that the kernel's grid barrier survives replay). ``rounded``: the kernel
    given gamma already rounded to x's type, whose dx must equal the one
    from the float32 gamma bit for bit (the kernel rounds gamma itself)."""
    got = call()
    again = call()
    torch.cuda.synchronize()
    want = plain()
    replays = graph_replays(call)
    errs = {n: rel_err(g, w) for n, g, w in zip(("dx", "dgamma", "dbeta"), got, want)}
    abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    stable = all(torch.equal(got[k], run[k]) for run in (again, *replays) for k in (1, 2))
    rounds = None if rounded is None else bool(torch.equal(rounded()[0], got[0]))
    ok = (all(bool(torch.isfinite(g.float()).all()) for g in got) and stable
          and max(errs.values()) <= BWD_TOL[dtype] and rounds is not False)
    emit("ln_kernel_check", kernel=kernel, case=case, dtype=str(dtype).removeprefix("torch."),
         rows=got[0].shape[0], H=got[0].shape[1], rel_err=errs, max_abs_err=abs_err,
         tol_rel=BWD_TOL[dtype], bitwise_stable_calls_and_graph_replays=stable,
         gamma_rounded_in_kernel=rounds, ok=ok)
    if not ok:
        raise AssertionError(f"{kernel} disagrees with its plain version: {case} {dtype} "
                             f"{errs}, stable {stable}, rounds gamma {rounds}")
    return abs_err


def check_ln_kernels(gen):
    """Kernels 3-5 against their plain versions on the card, float32 and
    bf16, at LN_SHAPES. Returns {(kernel, case, dtype): max abs error}."""
    from recformer_tpu_torch.ops import embed_layernorm as tel
    from recformer_tpu_torch.ops import layernorm as tln

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case, (M, H) in LN_SHAPES.items():
            adds, x, gamma, beta, dout = ln_case(gen, M, H, dtype)
            out = tel.embed_layernorm_fwd(*adds, gamma, beta, LN_EPS)
            torch.cuda.synchronize()
            ref = tel.embed_layernorm_plain(*adds, gamma, beta, LN_EPS)
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            ok = bool(torch.isfinite(out.float()).all()) and (
                err <= LN_FWD_TOL if dtype == torch.float32
                else bool((diff <= bf16_ulp(ref.float().abs().clamp_min(LN_ULP_FLOOR))).all()))
            emit("ln_kernel_check", kernel="embed_layernorm_fwd", case=case,
                 dtype=str(dtype).removeprefix("torch."), rows=M, H=H, max_abs_err=err,
                 tol=LN_FWD_TOL if dtype == torch.float32
                 else f"one bf16 ulp of max(|ref|, {LN_ULP_FLOOR})",
                 differing_share=float((diff > 0).float().mean()), ok=ok)
            if not ok:
                raise AssertionError(f"embed_layernorm_fwd disagrees: {case} {dtype} {err}")
            errs[("embed_layernorm_fwd", case, dtype)] = err

            errs[("embed_layernorm_bwd", case, dtype)] = check_ln_bwd(
                "embed_layernorm_bwd", case, dtype,
                lambda: tel.embed_layernorm_bwd(*adds, gamma, dout, LN_EPS),
                lambda: tel.embed_layernorm_bwd_plain(*adds, gamma, dout, LN_EPS))

            # gamma off the bf16 grid: the kernel rounds it, as the JAX VJP does
            assert dtype == torch.float32 or not torch.equal(gamma.to(dtype).float(), gamma)
            errs[("layernorm_bwd", case, dtype)] = check_ln_bwd(
                "layernorm_bwd", case, dtype,
                lambda: tln.layernorm_bwd(x, gamma, dout, LN_EPS),
                lambda: tln.layernorm_bwd_plain(x, gamma, dout, LN_EPS),
                rounded=None if dtype == torch.float32 else
                lambda: tln.layernorm_bwd(x, gamma.to(dtype).float(), dout, LN_EPS))
            del adds, x, dout, out, ref, diff
    torch.cuda.empty_cache()
    return errs


def layer_norm_bwd_call(x, gamma, beta, dout):
    """The autograd backward of ``F.layer_norm`` (native_layer_norm_backward:
    dx, dgamma and dbeta in one call), weights in the input's type."""
    H = x.shape[1]
    args = [x.detach().requires_grad_(), gamma.to(x.dtype).requires_grad_(),
            beta.to(x.dtype).requires_grad_()]
    y = torch.nn.functional.layer_norm(args[0], (H,), args[1], args[2], LN_EPS)
    return lambda: torch.autograd.grad(y, args, dout, retain_graph=True)


def native_layer_norm_bwd_call(x, gamma, beta, dout):
    """``aten.native_layer_norm_backward`` called directly (the kernel behind
    ``F.layer_norm``'s backward: dx, dgamma, dbeta), with the mean and rstd
    of ``native_layer_norm``, weights in the input's type: one call that a
    CUDA graph captures."""
    H = x.shape[1]
    w, b = gamma.to(x.dtype), beta.to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [H], w, b, LN_EPS)
    return lambda: torch.ops.aten.native_layer_norm_backward(dout, x, [H], mean, rstd, w, b,
                                                             [True, True, True])


def time_ln_kernels(gen, card):
    """Kernels 3-5 at their main-path shapes (bf16, H = 768): median of 25
    back-to-back calls from the host (``ms``) and the device time per launch
    from a CUDA graph of 25 (``graph_ms``; at 2,048 rows the host's call
    takes longer than the kernel), the device kernels one call runs (from a
    ``torch.profiler`` trace), the plain version, one PyTorch library call,
    host-timed (``library_ms``) and from a CUDA graph (``library_graph_ms``),
    and the bound (the bytes each input read once and each output written
    once, over the HBM rate; the flops, ~10-20 an element in float32, are
    far below it)."""
    from recformer_tpu_torch.ops import embed_layernorm as tel
    from recformer_tpu_torch.ops import layernorm as tln

    F = torch.nn.functional
    dtype, H = torch.bfloat16, 768
    rows = {k: {} for k in LN_KERNELS}
    for case in ("sequence_tower", "item_tower", "encode_chunk"):
        M = LN_SHAPES[case][0]
        adds, x, gamma, beta, dout = ln_case(gen, M, H, dtype)
        n, elt = M * H, 2
        xsum = adds[0] + adds[1] + adds[2] + adds[3]
        g, bt = gamma.to(dtype), beta.to(dtype)
        layer_norm = lambda: F.layer_norm(xsum, (H,), g, bt, LN_EPS)  # noqa: E731
        timed = {
            "embed_layernorm_fwd": (
                lambda: tel.embed_layernorm_fwd(*adds, gamma, beta, LN_EPS),
                lambda: tel.embed_layernorm_plain(*adds, gamma, beta, LN_EPS),
                layer_norm, layer_norm,
                "F.layer_norm on the pre-summed input (leaves out the four-way sum)",
                5 * n * elt + 2 * H * 4, 10 * n),
            "embed_layernorm_bwd": (
                lambda: tel.embed_layernorm_bwd(*adds, gamma, dout, LN_EPS),
                lambda: tel.embed_layernorm_bwd_plain(*adds, gamma, dout, LN_EPS),
                layer_norm_bwd_call(xsum, gamma, beta, dout),
                native_layer_norm_bwd_call(xsum, gamma, beta, dout),
                "backward of F.layer_norm on the pre-summed input (leaves out the sum): "
                "its autograd call host-timed, aten.native_layer_norm_backward by graph",
                6 * n * elt + 3 * H * 4, 20 * n),
            "layernorm_bwd": (
                lambda: tln.layernorm_bwd(x, gamma, dout, LN_EPS),
                lambda: tln.layernorm_bwd_plain(x, gamma, dout, LN_EPS),
                layer_norm_bwd_call(x, gamma, beta, dout),
                native_layer_norm_bwd_call(x, gamma, beta, dout),
                "backward of F.layer_norm: its autograd call host-timed, "
                "aten.native_layer_norm_backward by graph",
                3 * n * elt + 3 * H * 4, 16 * n),
        }
        if case == "encode_chunk":  # the serving forward runs kernel 3 alone
            timed = {"embed_layernorm_fwd": timed["embed_layernorm_fwd"]}
        for name, (kernel, plain, library, library_graph, library_call, nbytes,
                   flops) in timed.items():
            names = kernels_per_call(kernel)
            kernel_ms = median_launch_ms(kernel)
            device_ms = graph_launch_ms(kernel)
            plain_ms = median_launch_ms(plain, n=10, warmup=1)
            library_ms = median_launch_ms(library)
            library_graph_ms = graph_launch_ms(library_graph)
            b_ms, b_by = bound(nbytes, flops, torch.float32)
            rows[name][case] = dict(rows=M, H=H, dtype="bfloat16", ms=kernel_ms,
                                    graph_ms=device_ms, device_kernels_per_call=len(names),
                                    device_kernel_names=[k[:60] for k in names],
                                    plain_ms=plain_ms, library_ms=library_ms,
                                    library_graph_ms=library_graph_ms,
                                    library_call=library_call, bound_ms=b_ms, bound_by=b_by,
                                    bytes=nbytes, operations=flops, card=card)
            emit("ln_kernel_time", kernel=name, case=case, **rows[name][case])
            if len(names) != 1:
                raise AssertionError(f"{name} ran {len(names)} device kernels a call: {names}")
        del adds, x, dout, xsum, timed, layer_norm
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the two probe kernels (TPU kernels 6 and 7): checks and times
# ---------------------------------------------------------------------------

PROBE_TOL = 1e-2  # max|out - ref| / max|ref|, bf16, every variant; no_softmax's
#                   outputs are of order 1e31 (the -1e30 mask through P.V), so relative only
PROBE_BLOCKS = (256, 128, 16)  # the JAX default, a tile of the card's blocks, kernel 1's warp tile
PROBE_TIME_BLOCKS = (256, 16)
# kernels 6 and 7's CUDA-graph times before their redesign for wgmma and TMA
# (the mma.sync kernels they replace; ms, NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md), kept in the probe_time lines beside this run's
PROBE_EARLIER_MS = {
    "band_ablation": {
        256: {"dots_only": 0.0729, "no_softmax": 0.1087, "no_mask": 0.0969,
              "band_softmax": 0.1375, "full": 0.1402},
        16: {"dots_only": 0.0406, "no_softmax": 0.0485, "no_mask": 0.0438,
             "band_softmax": 0.0565, "full": 0.0596}},
    "band_headpair": {256: {"perhead": 0.1302, "pair": 0.1576},
                      16: {"perhead": 0.0605, "pair": 0.0621}},
}


def probe_inputs(seed, B, L, H, W, G, zero_runs=(), invalid_globals=()):
    """The ablation probe's inputs (``kernel_ablation.make_inputs``) with
    ``keyloc`` 0 over the (batch, start, length) runs of ``zero_runs`` and
    ``gvalid`` 0 at the (batch, global) pairs of ``invalid_globals``."""
    from recformer_tpu_torch.benchmarks import kernel_ablation as ka

    ins = ka.make_inputs(seed, "cuda", B=B, L=L, H=H, W=W, G=G)
    for b, start, n in zero_runs:
        ins["keyloc"][b, W // 2 + start:W // 2 + start + n] = 0
    for b, g in invalid_globals:
        ins["gvalid"][b, 0, g] = 0
    return ins


def check_probes():
    """Both probe kernels against their plain versions on the card, bf16:
    every ablation variant and both head-pair forms at the probes' defaults
    (B 16, L 1024, H 12, D 64, W 64, G 1) at block_q 256, 128 and 16; then
    keyloc with zero runs inside the sequence (one of 80 rows, so some rows
    see no valid key) and invalid globals (a whole batch row's, so those
    rows have nothing valid at all); then the edges: L = 1008 at block_q 48
    (irregular bands, a block of 7 warps), 8 globals, W = 32, and for the
    head pair L = 64 < block_q + W (one band, offsets 0) and L = 208. Then
    the warpgroup tile (block_q 64), rows with nothing valid at block_q 16,
    48, 64 and 256 (batch 2's every key and global off, batch 1's keys off
    over 200 rows with its globals, batch 0's over 80 with its globals on;
    batch 2 is also held alone), eight globals at block_q 256, and bands
    longer than the ring of stages (block_q 512 and 1024: 9 and 17 chunks
    of 64 rows)."""
    from recformer_tpu_torch.benchmarks import headpair_probe as hp
    from recformer_tpu_torch.ops import band_probes as bp

    cases = [("defaults", dict(B=16, L=1024, H=12, W=64, G=1), PROBE_BLOCKS),
             ("zero_keys_invalid_globals",
              dict(B=4, L=1024, H=12, W=64, G=2, zero_runs=((0, 100, 5), (1, 300, 80), (2, 0, 40)),
                   invalid_globals=((1, 0), (1, 1), (3, 1))), PROBE_BLOCKS),
             ("L1008_G8", dict(B=2, L=1008, H=4, W=64, G=8, zero_runs=((0, 500, 70),),
                               invalid_globals=((0, 3), (1, 7))), (48, 16, 112)),
             ("W32", dict(B=2, L=512, H=4, W=32, G=1), (256, 16)),
             ("wgmma_tile", dict(B=16, L=1024, H=12, W=64, G=1), (64,)),
             ("fully_masked",
              dict(B=4, L=768, H=4, W=64, G=2, zero_runs=((0, 100, 80), (1, 500, 200), (2, 0, 768)),
                   invalid_globals=((1, 0), (1, 1), (2, 0), (2, 1))), (16, 48, 64, 256)),
             ("G8", dict(B=4, L=1024, H=12, W=64, G=8, zero_runs=((0, 300, 70),),
                         invalid_globals=((0, 2), (3, 7))), (256,)),
             ("long_band", dict(B=4, L=1024, H=12, W=64, G=1, zero_runs=((1, 600, 90),)),
              (512, 1024))]
    errs = {}
    for case, kw, blocks in cases:
        ins = probe_inputs(7, **kw)
        for bq in blocks:
            for v in bp.ABLATION_VARIANTS:
                args = dict(variant=v, block_q=bq, window=kw["W"], num_heads=kw["H"])
                with torch.no_grad():
                    out = bp.band_ablation(**ins, **args)
                    ref = bp.band_ablation_plain(**ins, **args)
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                # the batch whose rows have nothing valid, held on its own
                alone = rel_err(out[2], ref[2]) if case == "fully_masked" else None
                ok = (out.dtype == torch.bfloat16 and out.shape == ins["q"].shape
                      and bool(torch.isfinite(ref).all()) and err <= PROBE_TOL
                      and (alone is None or alone <= PROBE_TOL))
                errs[("band_ablation", case, v, bq)] = (err, float((out.float() - ref.float())
                                                               .abs().max()))
                emit("probe_check", kernel="band_ablation", case=case, variant=v, block_q=bq,
                     rel_err=err, **({} if alone is None else {"masked_batch_rel_err": alone}),
                     ok=ok)
                if not ok:
                    raise AssertionError(f"band_ablation {case} {v} block_q {bq}: rel_err {err}")
    hp_cases = [("defaults", dict(B=16, L=1024, P=6, W=64), PROBE_BLOCKS),
                ("L1008", dict(B=2, L=1008, P=2, W=64), (48, 16)),
                ("L64", dict(B=2, L=64, P=2, W=64), (16, 64)),
                ("L208_W32", dict(B=2, L=208, P=2, W=32), (16, 208)),
                ("wgmma_tile", dict(B=16, L=1024, P=6, W=64), (64,)),
                ("long_band", dict(B=4, L=1024, P=6, W=64), (512, 1024))]
    for case, kw, blocks in hp_cases:
        q, k, v_ = hp.make_inputs(9, "cuda", B=kw["B"], L=kw["L"], P=kw["P"])
        for bq in blocks:
            ref = bp.band_headpair_plain(q, k, v_, variant="pair", block_q=bq, window=kw["W"])
            for v in bp.HEADPAIR_VARIANTS:
                with torch.no_grad():
                    out = bp.band_headpair(q, k, v_, variant=v, block_q=bq, window=kw["W"])
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                ok = out.shape == q.shape and err <= PROBE_TOL
                errs[("band_headpair", case, v, bq)] = (err, float((out.float() - ref.float())
                                                               .abs().max()))
                emit("probe_check", kernel="band_headpair", case=case, variant=v, block_q=bq,
                     rel_err=err, ok=ok)
                if not ok:
                    raise AssertionError(f"band_headpair {case} {v} block_q {bq}: rel_err {err}")
    torch.cuda.empty_cache()
    return errs


def probe_instructions(ptxas_rows) -> dict:
    """The probes' library holds Hopper's warpgroup MMA and TMA instructions
    (``cuobjdump -sass``: HGMMA, UTMALDG, UTMASTG; the first two must be
    there); beside them, ``-Xptxas -v``'s registers and spills of each of
    its kernels (``ptxas_rows``, from ``_build.ptxas_report``)."""
    from recformer_tpu_torch.ops import _build

    counts = _build.sass_counts("band_probes")
    kernels = [{k: r[k] for k in ("kernel", "registers", "spill_stores", "spill_loads")
                if k in r} for r in ptxas_rows]
    ok = counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
    emit("probe_sass", library="band_probes", sass=counts, ptxas=kernels, ok=ok)
    if not ok:
        raise AssertionError(f"probe_sass: no wgmma or TMA load in the probes' library: {counts}")
    return {"sass": counts, "ptxas": kernels}


def probe_bound(kernel, variant, block_q, B, L, H, W, G, D=64):
    """(bound ms, bound by, bytes, operations) of one probe call in bf16: the
    inputs the variant reads once and its output written once, over the
    card's memory rate; 4*D flops per (query, band key) pair and head (the
    global scores' 2*D per global key for ``full``; ``pair``'s zeros are
    not useful work), over the bf16 tensor-core peak."""
    elt = 2
    if kernel == "band_ablation":
        band = block_q + W
        nbytes = 2 * B * L * H * D * elt + 2 * B * (L + W) * H * D * elt
        ops = 4 * B * H * L * band * D
        if variant in ("no_softmax", "band_softmax", "full"):
            nbytes += B * (L + W) * 4
        if variant == "full":
            nbytes += B * G * H * D * elt + B * G * 4
            ops += 2 * B * H * L * G * D
    else:
        band = min(block_q + W, L)
        nbytes = 4 * B * L * H * D * elt
        ops = 4 * B * H * L * band * D
    ms, by = bound(nbytes, ops, torch.bfloat16)
    return ms, by, nbytes, ops


def time_probes(card):
    """The probes' entry points (``python -m
    recformer_tpu_torch.benchmarks.kernel_ablation`` and
    ``.headpair_probe``) at block_q 256 and 16, each variant's CUDA-graph
    device time and host time beside kernel 1's graph time on the same
    inputs in the same call, the plain versions' host time at block_q 256,
    the bound, the share of the bound (bound / graph time) and the graph
    time before the redesign for wgmma and TMA. Returns the rows and the
    probe kernels' launches."""
    from recformer_tpu_torch.benchmarks import headpair_probe as hp
    from recformer_tpu_torch.benchmarks import kernel_ablation as ka
    from recformer_tpu_torch.ops import band_probes as bp

    reset_counts()
    abl = {bq: ka.main(["--block-q", str(bq), "--iters", "25"]) for bq in PROBE_TIME_BLOCKS}
    hpr = {bq: hp.main(["--block-q", str(bq), "--iters", "25"]) for bq in PROBE_TIME_BLOCKS}
    counts = {k: v for k, v in read_counts().items() if k in PROBE_KERNELS}
    ins = ka.make_inputs(0)
    qkv = hp.make_inputs(0)
    with torch.no_grad():
        abl_plain = {v: median_launch_ms(lambda v=v: bp.band_ablation_plain(
            **ins, variant=v, block_q=256, window=ka.W, num_heads=ka.H), n=5, warmup=1)
            for v in bp.ABLATION_VARIANTS}
        hp_plain = median_launch_ms(lambda: bp.band_headpair_plain(
            *qkv, variant="pair", block_q=256, window=hp.W), n=5, warmup=1)
    del ins, qkv
    torch.cuda.empty_cache()
    rows = {"band_ablation": {}, "band_headpair": {}}
    for bq, r in abl.items():
        for v in bp.ABLATION_VARIANTS:
            b_ms, b_by, nbytes, ops = probe_bound("band_ablation", v, bq, ka.B, ka.L, ka.H,
                                                  ka.W, ka.G)
            rows["band_ablation"][f"{v}@{bq}"] = dict(
                ms=r[f"{v}_ms"], host_ms=r[f"{v}_host_ms"], bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / r[f"{v}_ms"], bytes=nbytes, operations=ops,
                kernel1_ms=r["kernel1_ms"], plain_ms=abl_plain[v] if bq == 256 else None,
                earlier_ms=PROBE_EARLIER_MS["band_ablation"][bq][v])
        emit("probe_time", kernel="band_ablation", block_q=bq,
             graph_ms={v: r[f"{v}_ms"] for v in bp.ABLATION_VARIANTS},
             host_ms={v: r[f"{v}_host_ms"] for v in bp.ABLATION_VARIANTS},
             bound_ms={v: rows["band_ablation"][f"{v}@{bq}"]["bound_ms"]
                       for v in bp.ABLATION_VARIANTS},
             share_of_bound={v: rows["band_ablation"][f"{v}@{bq}"]["share_of_bound"]
                             for v in bp.ABLATION_VARIANTS},
             earlier_graph_ms=PROBE_EARLIER_MS["band_ablation"][bq],
             kernel1_graph_ms=r["kernel1_ms"], kernel1_host_ms=r["kernel1_host_ms"], card=card)
    for bq, r in hpr.items():
        for v in bp.HEADPAIR_VARIANTS:
            b_ms, b_by, nbytes, ops = probe_bound("band_headpair", v, bq, hp.B, hp.L, 2 * hp.P,
                                                  hp.W, 0)
            rows["band_headpair"][f"{v}@{bq}"] = dict(
                ms=r[f"{v}_ms"], host_ms=r[f"{v}_host_ms"], bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / r[f"{v}_ms"], bytes=nbytes, operations=ops,
                plain_ms=hp_plain if bq == 256 else None,
                earlier_ms=PROBE_EARLIER_MS["band_headpair"][bq][v])
        emit("probe_time", kernel="band_headpair", block_q=bq,
             graph_ms={v: r[f"{v}_ms"] for v in bp.HEADPAIR_VARIANTS},
             host_ms={v: r[f"{v}_host_ms"] for v in bp.HEADPAIR_VARIANTS},
             bound_ms=b_ms,
             share_of_bound={v: rows["band_headpair"][f"{v}@{bq}"]["share_of_bound"]
                             for v in bp.HEADPAIR_VARIANTS},
             earlier_graph_ms=PROBE_EARLIER_MS["band_headpair"][bq], card=card)
    missing = [k for k in PROBE_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"probe_time: {missing} never launched")
    return rows, counts


# ---------------------------------------------------------------------------
# the serving path at full base width
# ---------------------------------------------------------------------------

def write_corpus(root, n_items=64, n_users=8, seed=0, hist=(3, 12)):
    """A corpus of ``n_items`` items and ``n_users`` histories of
    ``hist[0]`` to ``hist[1] - 1`` items; val and test hold each history's
    last item."""
    rng = np.random.default_rng(seed)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan", "oak", "tin", "zinc"]
    meta = {f"I{i:03d}": {"make": " ".join(rng.choice(words, 3)),
                          "hue": " ".join(rng.choice(words, 2)), "size": str(i)}
            for i in range(n_items)}
    smap = {f"I{i:03d}": i for i in range(n_items)}
    seqs = {f"u{u}": [int(x) for x in rng.integers(0, n_items, size=rng.integers(*hist))]
            for u in range(n_users)}
    split = {str(u): s for u, s in enumerate(seqs.values())}
    for name, obj in (("meta_data", meta), ("smap", smap), ("train", split),
                      ("val", {u: s[-1:] for u, s in split.items()}),
                      ("test", {u: s[-1:] for u, s in split.items()}),
                      ("sequences", seqs)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return seqs


def run_serving(seed, card):
    from recformer_tpu_torch.cli import serve
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.datasets import EvalDataset
    from recformer_tpu_torch.data.device_pipeline import assemble_for_config
    from recformer_tpu_torch.models.heads import RecformerForSeqRec, cosine_similarity
    from recformer_tpu_torch.training.loops import encode_all_items, evaluate_seqrec
    from recformer_tpu_torch.training.steps import make_encode_items_step

    dev = torch.device("cuda")
    cfg = RecformerConfig.base()
    assert cfg.attention_impl == "pallas" and cfg.compute_dtype == torch.bfloat16
    n_layers = cfg.num_hidden_layers
    model = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda", seed=seed)
    n_items, n_users, enc_bs, eval_bs = 10_000, 256, 256, 16
    table = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_table(cfg, n_items, seed).items()}
    rng = np.random.default_rng(seed + 1)
    hist = {u: [int(x) for x in rng.integers(0, n_items, size=rng.integers(16, 33))]
            for u in range(n_users)}
    labels = {u: [int(rng.integers(0, n_items))] for u in range(n_users)}
    ds = EvalDataset(hist, labels, labels, "val", max_items=cfg.max_item_embeddings - 1)

    # warm-up (cuBLAS handles, allocator): one encode chunk
    make_encode_items_step(cfg, model)(table, torch.arange(enc_bs, device=dev))
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    emb = encode_all_items(model, table, cfg, batch_size=enc_bs)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_launches, enc_tc = all_on_tensor_cores("encode")
    enc_forwards = math.ceil(n_items / enc_bs)
    if tuple(emb.shape) != (n_items, cfg.hidden_size) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"bad catalog embeddings {tuple(emb.shape)}")
    if enc_launches != n_layers * enc_forwards:
        raise AssertionError(f"encode launched the kernel {enc_launches} times, "
                             f"expected {n_layers * enc_forwards}")
    emit("serving_encode", items=n_items, batch=enc_bs, seq_len=cfg.item_seq_len,
         seconds=enc_s, items_per_s=n_items / enc_s, launches=enc_launches,
         tensor_core_launches=enc_tc, forwards=enc_forwards, card=card)

    reset_counts()
    t0 = time.perf_counter()
    metrics = evaluate_seqrec(model, table, ds, emb, cfg, batch_size=eval_bs)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches, eval_tc = all_on_tensor_cores("eval")
    eval_forwards = math.ceil(n_users / eval_bs)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"bad eval metrics {metrics}")
    if eval_launches != n_layers * eval_forwards:
        raise AssertionError(f"eval launched the kernel {eval_launches} times, "
                             f"expected {n_layers * eval_forwards}")
    emit("serving_eval", users=n_users, batch=eval_bs, seq_len=cfg.max_token_num,
         seconds=eval_s, users_per_s=n_users / eval_s, launches=eval_launches,
         tensor_core_launches=eval_tc, forwards=eval_forwards, metrics=metrics, card=card)

    # the kernel path against the plain chunked twin on one eval batch
    plain = RecformerForSeqRec(cfg.replace(attention_impl="chunked")).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    b = next(ds.batches(eval_bs))
    with torch.inference_mode():
        batch = assemble_for_config(table, torch.from_numpy(b.item_ids).to(dev),
                                    torch.from_numpy(b.seq_lens).to(dev), cfg)
        cos = cosine_similarity(model(batch).float(), plain(batch).float())
    del plain
    if float(cos.min()) <= 0.999:
        raise AssertionError(f"kernel path vs chunked twin: min cosine {float(cos.min())}")
    emit("serving_vs_chunked", batch=eval_bs, min_cosine=float(cos.min()))

    with tempfile.TemporaryDirectory() as tmp:
        seqs = write_corpus(tmp, seed=seed)
        out = os.path.join(tmp, "recs.jsonl")
        reset_counts()
        n = serve.main(["--data_path", tmp, "--sequences", os.path.join(tmp, "sequences.json"),
                        "--model_size", "base", "--attention_impl", "pallas",
                        "--batch_size", "4", "--encode_batch_size", "32", "--top_k", "10",
                        "--output", out, "--device", "cuda"])
        serve_launches, serve_tc = all_on_tensor_cores("serve")
        with open(out) as f:
            rows = [json.loads(line) for line in f]
    serve_forwards = math.ceil(64 / 32) + math.ceil(len(seqs) / 4)
    ok = (n == len(seqs) == len(rows)
          and all(len(r["items"]) == 10 and all(math.isfinite(s) for s in r["scores"])
                  and r["scores"] == sorted(r["scores"], reverse=True) for r in rows))
    if not ok:
        raise AssertionError(f"serve CLI returned {n} users, rows {rows[:1]}")
    if serve_launches != n_layers * serve_forwards:
        raise AssertionError(f"serve launched the kernel {serve_launches} times, "
                             f"expected {n_layers * serve_forwards}")
    emit("serving_cli", users=n, launches=serve_launches, tensor_core_launches=serve_tc,
         forwards=serve_forwards, first=rows[0])
    return {"band_attention_fwd": enc_launches + eval_launches + serve_launches,
            "band_attention_fwd_tc": enc_tc + eval_tc + serve_tc}


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in sorted(set(before) | set(after))
            if after.get(k, 0) != before.get(k, 0)}


def run_serve_graph(seed, card):
    """The backbone's CUDA graphs for serving (``utils/graphs.py``) at
    Recformer-base on the benchmark's serving shapes: a rank request's
    (32, 1024) under ``no_grad`` and an encode chunk's (256, 128) under
    ``inference_mode``. The eager call, the capturing call and two replays
    (the second on other inputs) each bitwise equal to ``forward_eager`` on
    the same inputs, kept through the later replays; kernel 1's launches 12
    a call, on the tensor cores, the replays' among them; a weight updated
    in place seen by the next replay; eager and replayed calls host-timed to
    the device's end (median of 10)."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import assemble_for_config
    from recformer_tpu_torch.models.heads import RecformerForSeqRec
    from recformer_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    cfg = RecformerConfig.base()
    n_layers, n_items = cfg.num_hidden_layers, 5_000
    backbone = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda",
                                 seed=seed).longformer
    table = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_table(cfg, n_items, seed).items()}
    rng = np.random.default_rng(seed + 7)
    keys = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
            "item_position_ids")

    def batch(B, L):
        if L == cfg.item_seq_len:  # one item a sequence, as the catalog's
            ids, lens = rng.integers(0, n_items, size=(B, 1)), np.ones(B)
        else:
            ids, lens = rng.integers(0, n_items, size=(B, 50)), rng.integers(5, 41, size=B)
        b = assemble_for_config(table, torch.from_numpy(ids.astype(np.int32)).to(dev),
                                torch.from_numpy(lens.astype(np.int32)).to(dev), cfg, out_len=L)
        return [b[k] for k in keys]

    def same(got, want) -> bool:
        return all(torch.equal(g, w) for g, w in zip(got, want))

    def ms(fn) -> float:
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    reset_counts()
    per_call = {"kernel1.launches": n_layers, "kernel1.tensor_core": n_layers}
    expected = [{**per_call, "serve_graph.eager": 1}, {**per_call, "serve_graph.captures": 1},
                {**per_call, "serve_graph.replays": 1}, {**per_call, "serve_graph.replays": 1}]
    for name, (B, L), mode in (("rank", (32, cfg.max_token_num), torch.no_grad),
                               ("encode", (256, cfg.item_seq_len), torch.inference_mode)):
        a, b = batch(B, L), batch(B, L)
        with mode():
            want_a, want_b = backbone.forward_eager(*a), backbone.forward_eager(*b)
            got, deltas = [], []
            for inputs in (a, a, a, b):  # eager, capture, replay, replay
                before = profiling.counters()
                got.append(backbone(*inputs))
                deltas.append(counter_deltas(before, profiling.counters()))
            torch.cuda.synchronize()
            kept = [same(g, w) for g, w in zip(got, (want_a, want_a, want_a, want_b))]
            w = backbone.encoder.layer[5].intermediate.dense.weight
            saved = w.clone()
            w.mul_(1.01)
            updated = backbone(*a)
            seen = same(updated, backbone.forward_eager(*a)) and not same(updated, want_a)
            w.copy_(saved)
            restored = same(backbone(*a), want_a)
            eager_ms = ms(lambda: backbone.forward_eager(*a))
            graph_ms = ms(lambda: backbone(*a))
        emit("serve_graph", cell=name, batch=B, seq_len=L, mode=mode.__name__,
             bitwise_equal=kept, counts_per_call=deltas, update_seen=seen, restored=restored,
             graphs=len(backbone.serve_graphs), eager_ms=eager_ms, graph_ms=graph_ms,
             speedup=eager_ms / graph_ms, card=card)
        if not all(kept):
            raise AssertionError(f"serve_graph {name}: graphed forward not bitwise equal to "
                                 f"the eager one: {kept}")
        if deltas != expected:
            raise AssertionError(f"serve_graph {name}: counts a call {deltas}, "
                                 f"expected {expected}")
        if not (seen and restored):
            raise AssertionError(f"serve_graph {name}: a weight updated in place was not "
                                 f"seen by the next replay ({seen}, {restored})")
    counts = read_counts()
    return {"band_attention_fwd": counts["band_attention_fwd"],
            "band_attention_fwd_tc": counts["band_attention_fwd_tc"]}


# kernel 1's device ms a launch at dropout 0 before the training graphs
# (my chip runs, PR 18): W 64 at the base shapes, W 128 at (32, 8192)
KERNEL1_BEFORE_MS = {"w64_sequence_tower": (0.0526, 0.0526), "w64_item_tower": (0.1001, 0.1001),
                     "w128_rank8k": (1.20, 1.22)}


def run_train_graph(seed, card):
    """The training micro-step's CUDA graphs (``utils/graphs.py``) at
    Recformer-base on the benchmark's training shapes, each step beside the
    same step run eagerly from the same weights and draws: pretraining at
    batch 8 and accumulation 8 (views (16, 1024) and (16, 128)) over 24
    micro-steps, three updates, and fraud training at batch 16 over 5 steps.
    Every call's metrics, every gradient the optimizer gets and every
    parameter after each update bitwise equal to the eager step's (both
    under PyTorch's deterministic algorithms: by default two eager runs
    differ in the embedding tables' gradients, summed by atomics); one
    capture, replays = calls - 2, and each call's kernel 1-2 launches as
    the code says, all on the tensor cores; the step host-timed to the
    device's end, eager and replayed (median of 5). Then kernel 1's device
    time a launch from a CUDA graph at dropout 0 (W 64 at (16, 1024) and
    (256, 128), H 12; W 128 at (32, 8192), H 16, G 0) beside PR 18's, and at
    W 64 with dropout 0.1, its seed passed as an int and read from device
    memory."""
    import copy

    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import (RecformerForFraudDetection,
                                                  RecformerForPretraining)
    from recformer_tpu_torch.ops.window_attention import band_attention
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_fraud_train_step, make_pretrain_step
    from recformer_tpu_torch.utils.graphs import CudaGraphs
    from recformer_tpu_torch.utils import profiling
    from recformer_tpu_torch.utils.rng import StepRNG, fold_in

    class Eager(CudaGraphs):
        def usable(self, device):
            return False

    dev = torch.device("cuda")
    cfg = RecformerConfig.base()
    n_items, layers = 5_000, cfg.num_hidden_layers
    table = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_table(cfg, n_items, seed).items()}
    rng = np.random.default_rng(seed + 19)
    reset_counts()
    for task, B, accum, calls in (("pretrain", 8, 8, 24), ("fraud", 16, 1, 5)):
        cls = RecformerForPretraining if task == "pretrain" else RecformerForFraudDetection
        graphed = init_model_params(cls(cfg), cfg, device="cuda", seed=seed)
        eager = copy.deepcopy(graphed)
        sides = []
        for model, primitive in ((graphed, None), (eager, Eager())):
            opt = create_optimizer(model, learning_rate=1e-4, warmup_steps=0, total_steps=1000,
                                   grad_accum_steps=accum)
            make = make_pretrain_step if task == "pretrain" else make_fraud_train_step
            step = make(cfg, model, opt)
            if primitive is not None:
                step.graphs.primitive = primitive
            got = {}
            real = opt.step

            def recorded(real=real, model=model, got=got):
                got["grads"] = [None if p.grad is None else p.grad.clone()
                                for p in model.parameters()]
                return real()

            opt.step = recorded
            sides.append((model, opt, step, got))
        batches = []
        for _ in range(3):
            ids = torch.from_numpy(rng.integers(0, n_items, size=(B, 50)).astype(np.int32))
            lens = torch.from_numpy(rng.integers(5, 41, size=B).astype(np.int32))
            labels = torch.from_numpy((np.arange(B) % 4 == 0).astype(np.int32))
            batches.append(tuple(t.to(dev) for t in (ids, lens, labels)))
        valid = torch.ones(B, dtype=torch.bool, device=dev)

        def call(side, k):
            step = sides[side][2]
            ids, lens, labels = batches[k % 3]
            if task == "pretrain":
                return step(StepRNG(fold_in(seed, k), dev), table, ids, lens)
            return step(seed, table, ids, lens, labels, valid)

        def same(a, b) -> bool:
            return all((x is None and y is None) or (x is not None and y is not None
                                                     and torch.equal(x, y))
                       for x, y in zip(a, b))

        # PyTorch's default backward of the token-type and item-position
        # tables (few rows, many duplicate indices) sums by atomics: two eager
        # runs differ there in the last bits. The comparison runs the
        # deterministic kernels, on both sides.
        unequal, deltas = [], []
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for k in range(calls):
                before = profiling.counters()
                got = call(0, k)
                deltas.append(counter_deltas(before, profiling.counters()))
                want = call(1, k)
                ok = (got.keys() == want.keys() and same(got.values(), want.values())
                      and same(sides[0][3]["grads"], sides[1][3]["grads"])
                      and same(list(graphed.parameters()), list(eager.parameters())))
                if not ok:
                    unequal.append(k)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        per_call = 2 * layers if task == "pretrain" else layers
        launches = {"kernel1.launches": per_call, "kernel1.tensor_core": per_call,
                    "kernel2.launches": per_call, "kernel2.tensor_core": per_call}
        expected = [{**launches, "train_graph.eager": 1}, {**launches, "train_graph.captures": 1}]
        expected += [{**launches, "train_graph.replays": 1}] * (calls - 2)
        graph_counts = {k: sum(d.get(k, 0) for d in deltas)
                        for k in ("train_graph.eager", "train_graph.captures",
                                  "train_graph.replays")}
        times = {}
        for name, side in (("replayed", 0), ("eager", 1)):
            ms = []
            for k in range(calls, calls + 5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(side, k)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            times[f"{name}_ms"] = float(np.median(ms))
        emit("train_graph", task=task, batch=B, accumulation=accum, calls=calls,
             updates=sides[0][1].updates, unequal_calls=unequal, counts_per_call=deltas,
             counters=graph_counts, graphs=len(sides[0][2].graphs), **times,
             speedup=times["eager_ms"] / times["replayed_ms"],
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=card)
        if unequal:
            raise AssertionError(f"train_graph {task}: replayed calls {unequal} not bitwise "
                                 f"equal to the eager step")
        if deltas != expected:
            raise AssertionError(f"train_graph {task}: counts a call {deltas}, "
                                 f"expected {expected}")
        del sides, graphed, eager
        torch.cuda.empty_cache()

    # kernel 1 at dropout 0, and with its seed read from device memory
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    H, D = 12, 64
    lengths_rng = np.random.default_rng(1)
    rows = {}
    slot = torch.tensor([5], dtype=torch.int32, device=dev)
    with torch.no_grad():
        for name, (B, L) in BASE_SHAPES.items():
            ops = band_case(gen, B, L, H, D, 64, torch.bfloat16,
                            lengths=lengths_rng.integers(L // 4, L + 1, size=B).tolist())
            common = dict(num_heads=H, window=64, fuse_epilogue=True)
            rows[f"w64_{name}"] = dict(
                shape=[B, L, H, D], ms=graph_launch_ms(lambda: band_attention(**ops, **common)),
                ms_dropout=graph_launch_ms(lambda: band_attention(**ops, **common,
                                                                  dropout_rate=0.1, seed=5)),
                ms_dropout_device_seed=graph_launch_ms(
                    lambda: band_attention(**ops, **common, dropout_rate=0.1, seed=slot)))
        B, L, H = 32, 8192, 16
        lengths = [int(x) for x in np.random.default_rng(seed).integers(2700, L + 1, size=B)]
        ops = mb_band_case(gen, B, L, H, lengths, torch.bfloat16)
        rows["w128_rank8k"] = dict(shape=[B, L, H, D], ms=graph_launch_ms(
            lambda: band_attention(**ops, num_heads=H, window=128, fuse_epilogue=True), n=5))
    for name, row in rows.items():
        lo, hi = KERNEL1_BEFORE_MS[name]
        row.update(before_ms=[lo, hi], within_2pct=0.98 * lo <= row["ms"] <= 1.02 * hi)
        emit("train_graph_kernel1_time", case=name, **row, card=card)
    counts = read_counts()
    return {"band_attention_fwd": counts["band_attention_fwd"],
            "band_attention_fwd_tc": counts["band_attention_fwd_tc"],
            "band_attention_bwd": counts["band_attention_bwd"],
            "band_attention_bwd_tc": counts["band_attention_bwd_tc"]}


MB_KERNEL_CASES = {  # kernel 1-2 at ModernBERT's local layers: W 128, no global column
    "w128_g0_ragged": dict(B=2, L=1000, H=4, lengths=[1000, 613]),
    "w128_g0_padding_tiles": dict(B=2, L=2048, H=16, lengths=[2048, 300]),
    "w128_g0_L8192": dict(B=1, L=8192, H=16, lengths=[5400]),
}


def mb_band_case(gen, B, L, H, lengths, dtype, D=64):
    """Kernel 1-2's operands with no global column (G = 0): the padding rows
    are mask 0, the rest 1."""
    dev = torch.device("cuda")
    q2, k2, v2 = ((torch.randn(B, L, H * D, generator=gen, device=dev) * 0.5).to(dtype)
                  for _ in range(3))
    keyloc = (torch.arange(L, device=dev)[None, :]
              < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    none = q2.new_zeros((B, 0, H * D))
    return dict(q2=q2, k2=k2, v2=v2, keyloc=keyloc, gk=none, gv=none, gvalid=keyloc[:, :0],
                mrow=keyloc, gout=none)


def mb_check_kernels(gen):
    """Kernels 1 and 2 at W 128, G 0 against their plain versions (float32
    and bf16, dropout 0 and 0.1): the forward on the tensor cores in bf16,
    the backward on its CUDA-core passes; each bitwise equal on a second
    call. Returns the largest errors."""
    from recformer_tpu_torch.ops.window_attention import (band_attention, band_attention_bwd,
                                                          window_attention_bwd_plain,
                                                          window_attention_plain)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, kw in MB_KERNEL_CASES.items():
            ops = mb_band_case(gen, dtype=dtype, **kw)
            common = dict(num_heads=kw["H"], window=128, fuse_epilogue=True)
            for rate in (0.0, 0.1):
                drop = dict(dropout_rate=rate, seed=99 + kw["L"])
                before = read_counts()
                with torch.no_grad():
                    out = band_attention(**ops, **common, **drop)
                    again = band_attention(**ops, **common, **drop)
                dout = (torch.randn(out.shape, generator=gen, device="cuda") * 0.5).to(dtype)
                got = band_attention_bwd(**ops, dout=dout, **common, **drop)
                got2 = band_attention_bwd(**ops, dout=dout, **common, **drop)
                torch.cuda.synchronize()
                after = read_counts()
                fwd_tc = after["band_attention_fwd_tc"] - before["band_attention_fwd_tc"]
                bwd_tc = after["band_attention_bwd_tc"] - before["band_attention_bwd_tc"]
                ref = window_attention_plain(**ops, **common, **drop)
                want = window_attention_bwd_plain(**ops, dout=dout, **common, **drop)
                fwd_err = float((out.float() - ref.float()).abs().max())
                errs = {n: rel_err(g, w) for n, g, w in zip(BWD_OUTPUTS[:3], got, want)}
                stable = torch.equal(out, again) and all(
                    torch.equal(a, b) for a, b in zip(got[:3], got2[:3]))
                want_tc = 2 if dtype == torch.bfloat16 else 0
                ok = (fwd_err <= TOL[dtype] and max(errs.values()) <= BWD_TOL[dtype] and stable
                      and fwd_tc == want_tc and bwd_tc == 0
                      and all(tuple(g.shape) == (kw["B"], 0, kw["H"] * 64) for g in got[3:]))
                emit("modernbert_kernel_check", case=name, dtype=str(dtype).removeprefix("torch."),
                     shape=[kw["B"], kw["L"], kw["H"], 64], window=128, globals=0, dropout=rate,
                     fwd_path="tensor_core" if fwd_tc else "cuda_core", fwd_max_abs_err=fwd_err,
                     bwd_path="tensor_core" if bwd_tc else "cuda_core", bwd_rel_err=errs,
                     bitwise_stable=stable, ok=ok)
                if not ok:
                    raise AssertionError(f"kernels 1-2 at W 128, G 0 disagree with their plain "
                                         f"versions: {name} {dtype} rate {rate}")
                key = str(dtype).removeprefix("torch.")
                worst[key] = max(worst.get(key, 0.0), fwd_err, max(errs.values()))
    return worst


def mb_batch(cfg, gen, lengths, L, n_masked=0):
    """A batch of random tokens at (len(lengths), L): ``<s>`` first, types 1
    and 2, item positions, padding past each length; with ``n_masked``, as
    many masked positions a row (its MLM ids, positions and labels) and the
    reference's (batch, corrupted, masked) view."""
    dev = torch.device("cuda")
    B = len(lengths)
    valid = torch.arange(L, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    ids = torch.randint(4, cfg.vocab_size - 1, (B, L), generator=gen, device=dev)
    ids[:, 0] = cfg.bos_token_id
    ids = torch.where(valid, ids, cfg.pad_token_id)
    typ = torch.where(valid, torch.randint(1, 3, (B, L), generator=gen, device=dev), 3)
    typ[:, 0] = 0
    pos = (torch.arange(L, device=dev)[None, :] // 27 + 1).clamp_max(cfg.max_item_embeddings - 2)
    item = torch.where(valid, pos, cfg.max_item_embeddings - 1)
    item[:, 0] = 0
    glob = torch.zeros(B, L, dtype=torch.int64, device=dev)
    glob[:, 0] = 1
    batch = {"input_ids": ids, "attention_mask": valid.long(), "global_attention_mask": glob,
             "token_type_ids": typ, "item_position_ids": item}
    if not n_masked:
        return batch, None
    at = torch.stack([1 + torch.randperm(int(n) - 1, generator=gen, device=dev)[:n_masked]
                      for n in lengths])
    masked = torch.zeros(B, L, dtype=torch.bool, device=dev).scatter_(1, at, True)
    corrupted = torch.where(masked, cfg.mask_token_id, ids)
    full = dict(batch, mlm_input_ids=corrupted, mlm_positions=at,
                mlm_labels=torch.gather(ids, 1, at))
    return full, (batch, corrupted, masked)


def leaf_gap(grads, ref) -> float:
    """The worst leaf's ||g - r|| / max(||r||, the median leaf's ||r||)."""
    norms = {n: float(r.norm()) for n, r in ref.items()}
    med = float(np.median(list(norms.values())))
    return max(float((grads[n] - r).norm()) / max(norms[n], med) for n, r in ref.items())


def time_add_layernorm(gen, card, rows=262144, H=1024):
    """The residual sum + LayerNorm kernel (``ops/add_layernorm.py``) at the
    rank cell's rows (32 x 8,192) of 1,024 in bf16, with and without the
    residual: the sum bitwise the plain one, the output within one bf16 ulp
    of the plain chain (no finer than at LN_ULP_FLOOR), one device kernel a
    call; its device time a launch from a ``torch.profiler`` trace of 20
    calls (``ms``), also a call from a CUDA graph of 10 (``graph_ms``: each
    captured call writes new outputs, and such graphs have read up to 16%
    above ``ms`` in some captures and not in others) and host-timed; the
    plain chain's device time (the yardstick: what the model ran before),
    the library route's (``library_ms``: the plain ``x + d`` then
    ``F.layer_norm``, gamma in the input's type as that route takes it, two
    kernels of about 10 bytes an element with the sum) and the bound (each
    input read once, each output written once, over the HBM rate)."""
    from recformer_tpu_torch.ops import add_layernorm as aln

    dtype, elt = torch.bfloat16, 2
    x = (torch.randn(rows, H, generator=gen, device="cuda") * 2.0).to(dtype)
    d = torch.randn(rows, H, generator=gen, device="cuda").to(dtype)
    w = 1.0 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    w_typed = w.to(dtype)
    out = {}
    with torch.no_grad():
        for name, res in (("residual", d), ("alone", None)):
            kernel = lambda: aln.add_layernorm(x, res, w, LN_EPS)  # noqa: E731
            plain = lambda: aln.add_layernorm_plain(x, res, w, LN_EPS)  # noqa: E731
            library = lambda: torch.nn.functional.layer_norm(  # noqa: E731
                x if res is None else x + res, (H,), w_typed, None, LN_EPS)
            got, want = kernel(), plain()
            got, want = (got, want) if res is not None else ((got,), (want,))
            sum_bitwise = res is None or torch.equal(got[0], want[0])
            ref = want[-1].float()
            err = (got[-1].float() - ref).abs()
            within_ulp = bool((err <= bf16_ulp(ref.abs().clamp_min(LN_ULP_FLOOR))).all())
            del got, want, ref, err
            names = kernels_per_call(kernel)
            ms = sum(device_ms_by_kernel(kernel, n=20).values())
            graph_ms, host = graph_launch_ms(kernel, n=10), host_ms(kernel, n=10)
            plain_ms = graph_launch_ms(plain, n=3)
            library_ms = sum(device_ms_by_kernel(library, n=20).values())
            nbytes = (4 if res is not None else 2) * rows * H * elt + H * 4
            b_ms, b_by = bound(nbytes, 10 * rows * H, torch.float32)
            out[name] = dict(ms=ms, bound_ms=b_ms, share_of_bound=b_ms / ms)
            emit("add_layernorm_time", case=name, rows=rows, H=H, dtype="bfloat16", ms=ms,
                 graph_ms=graph_ms, host_ms=host, plain_chain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=b_ms,
                 bound_by=b_by, share_of_bound=b_ms / ms, bytes=nbytes, sum_bitwise=sum_bitwise,
                 within_one_ulp=within_ulp, device_kernels_per_call=len(names),
                 device_kernel_names=[k[:60] for k in names], card=card)
            if not (sum_bitwise and within_ulp) or len(names) != 1:
                raise AssertionError(f"add_layernorm {name}: sum bitwise {sum_bitwise}, within "
                                     f"one ulp {within_ulp}, device kernels {names}")
    del x, d
    torch.cuda.empty_cache()
    return out


def run_modernbert(seed, card):
    """ModernBERT-large at its published widths (``RecformerConfig.modernbert_large()``):
    kernels 1-2 at W 128 with no global column against their plain versions;
    kernel 1 (W 128) and the global op timed at the rank cell's (32, 8192);
    one pretraining micro-step of 2 users (views (4, 8192) and (4, 128),
    remat ``full``) in float32 against the plain float32 reference (the loss
    and the worst gradient leaf; TF32 off), and in bf16 (its gaps reported,
    its launches counted: kernel 2 on its CUDA-core passes); the rank
    forward at (32, 8192) eager, captured and replayed, the replay bitwise
    equal to ``forward_eager``, each call 18 kernel-1 launches on the tensor
    cores, 10 global-attention launches on a fused backend and 57 residual-sum
    + LayerNorm launches, 28 with the residual (``time_add_layernorm`` first)."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForPretraining, RecformerForSeqRec
    from recformer_tpu_torch.ops.full_attention import full_attention
    from recformer_tpu_torch.ops.window_attention import band_attention
    from recformer_tpu_torch.reference import modernbert as ref
    from recformer_tpu_torch.training.steps import pretrain_loss
    from recformer_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    out = {"kernel_errors": mb_check_kernels(gen), "add_layernorm": time_add_layernorm(gen, card)}
    cfg = RecformerConfig.modernbert_large()
    n_global = sum(cfg.is_global_layer(i) for i in range(cfg.num_hidden_layers))
    n_local = cfg.num_hidden_layers - n_global

    # kernel 1 at W 128 and the global op at the rank cell's shape
    B, L, H, D = 32, cfg.max_token_num, cfg.num_attention_heads, cfg.head_dim
    lengths = [int(x) for x in np.random.default_rng(seed).integers(2700, L + 1, size=B)]
    ops = mb_band_case(gen, B, L, H, lengths, torch.bfloat16)
    n = np.asarray(lengths, np.int64)
    d = np.minimum(64, n - 1)
    pairs = int((n + 2 * (d * n - d * (d + 1) // 2)).sum())
    with torch.no_grad():
        def k1():
            return band_attention(**ops, num_heads=H, window=128, fuse_epilogue=True)

        k1_ms, k1_host = graph_launch_ms(k1, n=5), host_ms(k1, n=5)
        k1_bound, k1_by = bound(float((2 * H * D * 4 * n + 8 * n).sum()), 4 * H * D * pairs,
                                torch.bfloat16)
        q, k, v = (ops[x].view(B, L, H, D) for x in ("q2", "k2", "v2"))
        def g():
            return full_attention(q, k, v, ops["keyloc"])

        g_ms, g_host = graph_launch_ms(g, n=3), host_ms(g, n=3)
        g_bound, g_by = bound(float((2 * H * D * 4 * n + n).sum()),
                              4.0 * H * D * float((n * n).sum()), torch.bfloat16)
    emit("modernbert_kernel_time", shape=[B, L, H, D], lengths=lengths,
         kernel1_w128_ms=k1_ms, kernel1_w128_host_ms=k1_host, kernel1_bound_ms=k1_bound,
         kernel1_bound_by=k1_by, kernel1_share_of_bound=k1_bound / k1_ms,
         global_attn_ms=g_ms, global_attn_host_ms=g_host, global_attn_bound_ms=g_bound,
         global_attn_bound_by=g_by, global_attn_share_of_bound=g_bound / g_ms, card=card)
    out.update(kernel1_w128_ms=k1_ms, global_attn_ms=g_ms)
    del ops, q, k, v

    # one pretraining micro-step against the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(dtype="float32", remat=True)
    model = init_model_params(RecformerForPretraining(cfg32), cfg32, device="cuda", seed=seed)
    state = {n: p.detach().clone() for n, p in model.named_parameters()}
    a, view_a = mb_batch(cfg, gen, [8192, 5000], L, n_masked=64)
    b, view_b = mb_batch(cfg, gen, [128, 61], cfg.item_seq_len, n_masked=6)
    P = {n: t.clone().requires_grad_(True) for n, t in state.items()}
    want = ref.pretrain_loss(P, cfg32, [view_a, view_b])
    want.backward()
    ref_grads = {n: t.grad for n, t in P.items()}
    del P
    gaps = {}
    for name, c in (("float32", cfg32), ("bfloat16", cfg.replace(remat=True))):
        m = model if c is cfg32 else init_model_params(RecformerForPretraining(c), c,
                                                       device="cuda", seed=seed)
        m.load_state_dict(state)
        m.train()
        reset_counts()
        before = profiling.counters()
        loss, _ = pretrain_loss(c, m(a, b), a, b)
        loss.backward()
        torch.cuda.synchronize()
        counts = counter_deltas(before, profiling.counters())
        grads = {n: p.grad for n, p in m.named_parameters()}
        gaps[name] = {"loss": float(loss), "ref_loss": float(want),
                      "loss_gap": abs(float(loss) - float(want)) / abs(float(want)),
                      "grad_gap": leaf_gap(grads, ref_grads),
                      "finite": all(bool(torch.isfinite(t).all()) for t in grads.values())}
        # two towers, each layer's forward run twice under remat 'full'
        expected = {"kernel1.launches": 4 * n_local, "kernel2.launches": 2 * n_local,
                    "global_attn.launches": 4 * n_global, "global_attn.fused": 4 * n_global,
                    "kernel1.tensor_core": 4 * n_local if name == "bfloat16" else 0}
        got = {k: counts.get(k, 0) for k in expected}
        gaps[name]["launches"] = got
        emit("modernbert_pretrain_step", dtype=name, views=[[4, L], [4, cfg.item_seq_len]],
             remat="full", **gaps[name], expected_launches=expected, card=card)
        if not gaps[name]["finite"] or got != expected:
            raise AssertionError(f"modernbert pretrain step {name}: {gaps[name]}, "
                                 f"expected launches {expected}")
        del m, grads
        model = None
        torch.cuda.empty_cache()
    if gaps["float32"]["loss_gap"] > 1e-4 or gaps["float32"]["grad_gap"] > 1e-2:
        raise AssertionError(f"modernbert float32 step against the reference: {gaps['float32']}")
    out["pretrain_step"] = gaps
    del state, ref_grads, a, b, view_a, view_b

    # the rank forward: eager, captured, replayed
    backbone = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda",
                                 seed=seed).longformer
    keys = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
            "item_position_ids")
    batch, _ = mb_batch(cfg, gen, lengths, L)
    inputs = [batch[k] for k in keys]
    # LayerNorms: embeddings.norm, attn_norm in every layer but 0, mlp_norm
    # (after the attention block's residual sum) in every layer, final_norm
    n_layers = cfg.num_hidden_layers
    per_call = {"kernel1.launches": n_local, "kernel1.tensor_core": n_local,
                "global_attn.launches": n_global, "global_attn.fused": n_global,
                "add_layernorm.launches": 2 * n_layers + 1, "add_layernorm.residual": n_layers}
    expected = [{**per_call, "serve_graph.eager": 1}, {**per_call, "serve_graph.captures": 1},
                {**per_call, "serve_graph.replays": 1}]
    with torch.no_grad():
        want = backbone.forward_eager(*inputs)
        got, deltas, wall = [], [], []
        for _ in range(3):  # eager, capture, replay
            before = profiling.counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(backbone(*inputs))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            deltas.append(counter_deltas(before, profiling.counters()))
        equal = [all(torch.equal(x, y) for x, y in zip(g, want)) for g in got]
        replay_ms = host_ms(lambda: backbone(*inputs), n=3, warmup=0)
        eager_ms = host_ms(lambda: backbone.forward_eager(*inputs), n=3, warmup=0)
    emit("modernbert_rank_forward", shape=[B, L], bitwise_equal=equal, counts_per_call=deltas,
         expected=expected, call_ms=wall, eager_ms=eager_ms, replay_ms=replay_ms,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=card)
    if not all(equal) or deltas != expected:
        raise AssertionError(f"modernbert rank forward: equal {equal}, counts {deltas}")
    out.update(rank_replay_ms=replay_ms, rank_eager_ms=eager_ms)
    return out


def ds_batch(cfg, lengths, L, seed):
    """A batch of random tokens at (len(lengths), L) for the deepseek_v3
    backbone: ``<s>`` first, types 1 and 2, item positions, padding past
    each length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    B = len(lengths)
    valid = torch.arange(L, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    ids = torch.where(valid, torch.randint(4, cfg.vocab_size - 300, (B, L), generator=g,
                                           device=dev), cfg.pad_token_id)
    ids[:, 0] = cfg.bos_token_id
    typ = torch.where(valid, torch.randint(1, 3, (B, L), generator=g, device=dev), 3)
    typ[:, 0] = 0
    item = torch.where(valid, torch.randint(1, cfg.max_item_embeddings - 1, (B, L), generator=g,
                                            device=dev), cfg.max_item_embeddings - 1)
    item[:, 0] = 0
    glob = torch.zeros(B, L, dtype=torch.int64, device=dev)
    glob[:, 0] = 1
    return {"input_ids": ids, "attention_mask": valid.long(), "global_attention_mask": glob,
            "token_type_ids": typ, "item_position_ids": item}


def run_deepseek_v3(seed, card):
    """Moonlight-16B-A3B at its published widths and depth
    (``RecformerConfig.moonlight_16b_a3b()``, bf16 weights from
    ``portbench/weights_deepseek_v3.py``, one copy on the card): the grouped
    GEMMs of one routed layer's block of 65,536 tokens timed by CUDA-graph
    replay against their least time; one MoE layer on 8,192 tokens against
    the plain reference's expert loop; the full forward of two histories
    against the plain float32 reference (TF32 off; the pooled states' gap
    and how often the program's top-6 choice differs from the reference's,
    over the valid tokens of the 26 routed layers); the rank forward at
    (32, 8192) eager, captured and replayed, the replay bitwise equal to
    ``forward_eager``, each call 26 MoE launches, 208 grouped GEMMs (two a
    block of 65,536 tokens), 27 causal attention launches on a fused
    backend; last, the program in float32 (its weights upcast, 62.5 GB) on
    the two histories against the reference, which it must match to
    float32 rounding."""
    from portbench.weights_deepseek_v3 import make_weights
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models import deepseek_v3 as ds
    from recformer_tpu_torch.models.heads import RecformerForSeqRec
    from recformer_tpu_torch.ops import moe
    from recformer_tpu_torch.reference import deepseek_v3 as ref
    from recformer_tpu_torch.utils import profiling

    cfg = RecformerConfig.moonlight_16b_a3b()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = RecformerForSeqRec(cfg)
    model.load_state_dict(make_weights(cfg, "seqrec", seed, "cuda"), strict=True, assign=True)
    model.eval()
    backbone = model.longformer
    torch.cuda.synchronize()
    emit("deepseek_v3_weights", seconds=time.perf_counter() - t0,
         gib=torch.cuda.memory_allocated() / 2 ** 30, card=card)
    out = {}

    # the grouped GEMMs of one block at the cell's shape
    E, hs, inter, K = (cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size,
                       cfg.num_experts_per_tok)
    layer = backbone.layers[1].mlp
    T = moe.BLOCK_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(T, hs, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        experts, weights = moe.route(x, layer.gate.weight, layer.gate.e_score_correction_bias, K,
                                     cfg.routed_scaling_factor, True)
        order, offs = moe.expert_offsets(experts.reshape(-1), E)
        rows = x.index_select(0, torch.div(order, K, rounding_mode="floor"))
        w1, w2 = layer.experts.gate_up_proj.transpose(1, 2), layer.experts.down_proj.transpose(1, 2)
        h = moe.grouped_mm(rows, w1, offs)
        a = torch.nn.functional.silu(h[:, :inter]) * h[:, inter:]
        g1_ms = graph_launch_ms(lambda: moe.grouped_mm(rows, w1, offs), n=10)
        g2_ms = graph_launch_ms(lambda: moe.grouped_mm(a, w2, offs), n=10)
        plain = moe.grouped_mm_plain(rows[:4096].float(), w1.float(), torch.clamp(offs, max=4096))
        gemm_err = float((h[:4096].float() - plain).abs().max() / plain.abs().max())
    n_rows = T * K
    ops = 2.0 * n_rows * 3 * hs * inter
    nbytes = 2.0 * (E * 3 * hs * inter + n_rows * (2 * hs + 3 * inter))
    least, by = bound(nbytes, ops, torch.bfloat16)
    loads = torch.diff(offs, prepend=offs.new_zeros(1))
    emit("deepseek_v3_grouped_gemm", rows=n_rows, gate_up_ms=g1_ms, down_ms=g2_ms,
         bound_ms=least, bound_by=by, roofline_share=least / (g1_ms + g2_ms),
         tflops=ops / (g1_ms + g2_ms) / 1e9, rows_per_expert_min=int(loads.min()),
         rows_per_expert_max=int(loads.max()), max_rel_err_vs_plain=gemm_err, card=card)
    out.update(grouped_gemm_ms=g1_ms + g2_ms, grouped_gemm_roofline=least / (g1_ms + g2_ms))
    del rows, h, a, order, w1, w2

    # one MoE layer against the reference's expert loop (float32, TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    xs = x[:8192]
    with torch.no_grad():
        got = layer(xs[None], torch.ones(1, 8192, dtype=torch.long, device="cuda"))[0]
        W = {k: v.float() for k, v in backbone.layers[1].state_dict().items()
             if k.startswith("mlp.")}
        want = ref.moe(W, cfg, xs.float(), ref.Numerics())
    moe_gap = float((got.float() - want).abs().max() / want.abs().max())
    emit("deepseek_v3_moe_layer", tokens=8192, max_rel_err=moe_gap, card=card)
    del W, x, xs, layer
    torch.cuda.empty_cache()

    # the full forward of two histories against the reference, counting
    # routing flips over the valid tokens
    lengths = [8192, 5231]
    batch = ds_batch(cfg, lengths, cfg.max_token_num, seed)
    chosen = {"program": [], "reference": []}
    prog_route, ref_route = ds.route, ref.route

    def rec_prog(*a, **k):
        e, w = prog_route(*a, **k)
        chosen["program"].append(e)
        return e, w

    def rec_ref(*a, **k):
        e, w = ref_route(*a, **k)
        chosen["reference"].append(e)
        return e, w

    keys = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
            "item_position_ids")
    ds.route, ref.route = rec_prog, rec_ref
    try:
        with torch.no_grad():
            pooled = backbone.forward_eager(*(batch[k] for k in keys))[1]
            state = backbone.state_dict()
            want = torch.cat([ref.encode({"longformer." + k: v for k, v in state.items()}, cfg,
                                         {k: v[r:r + 1] for k, v in batch.items()})[1]
                              for r in range(2)])
    finally:
        ds.route, ref.route = prog_route, ref_route
    pooled_gap = float((pooled.float() - want).abs().max() / want.abs().max())
    cos = torch.nn.functional.cosine_similarity(pooled.float(), want, dim=-1)
    flips = total = 0
    for layer_i, pe in enumerate(chosen["program"]):
        pe = pe.view(2, cfg.max_token_num, K)
        for r, n in enumerate(lengths):
            re = chosen["reference"][r * len(chosen["program"]) + layer_i].view(-1, K)[:n]
            a_ = pe[r, :n].sort(-1).values
            b_ = re.sort(-1).values
            flips += int((a_ != b_).any(-1).sum())
            total += n
    flip_share = flips / total
    emit("deepseek_v3_forward_vs_reference", lengths=lengths, pooled_max_rel_err=pooled_gap,
         pooled_cosine=cos.tolist(), routed_token_layers=total, routing_flips=flips,
         routing_flip_share=flip_share, card=card)
    out.update(pooled_gap=pooled_gap, routing_flip_share=flip_share)
    del state, want, pooled, chosen
    torch.cuda.empty_cache()

    # the rank forward: eager, captured, replayed
    L = cfg.max_token_num
    lengths = [int(v) for v in np.random.default_rng(seed).integers(2700, L + 1, size=32)]
    batch = ds_batch(cfg, lengths, L, seed + 1)
    inputs = [batch[k] for k in keys]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers))
    blocks = -(-32 * L // moe.BLOCK_TOKENS)
    per_call = {"moe.launches": n_moe, "moe.grouped_gemm": 2 * blocks * n_moe,
                "global_attn.launches": cfg.num_hidden_layers,
                "global_attn.fused": cfg.num_hidden_layers}
    expected = [{**per_call, "serve_graph.eager": 1}, {**per_call, "serve_graph.captures": 1},
                {**per_call, "serve_graph.replays": 1}]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        want = backbone.forward_eager(*inputs)
        got, deltas, wall = [], [], []
        for _ in range(3):  # eager, capture, replay
            before = profiling.counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(backbone(*inputs))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            deltas.append(counter_deltas(before, profiling.counters()))
        equal = [all(torch.equal(a, b) for a, b in zip(g, want)) for g in got]
        replay_ms = host_ms(lambda: backbone(*inputs), n=3, warmup=0)
    emit("deepseek_v3_rank_forward", shape=[32, L], bitwise_equal=equal,
         counts_per_call=deltas, expected=expected, call_ms=wall, replay_ms=replay_ms,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=card)
    if not all(equal) or deltas != expected:
        raise AssertionError(f"deepseek_v3 rank forward: equal {equal}, counts {deltas}")
    del got, want, batch, inputs

    # the program in float32 at full width (62.5 GB of weights) against the
    # reference: the equations, apart from bf16's rounding and routing flips
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    state = model.state_dict()
    del model, backbone
    for k in list(state):
        state[k] = state.pop(k).float()
    torch.cuda.empty_cache()
    with torch.device("meta"):
        model32 = RecformerForSeqRec(cfg32)
    model32.load_state_dict(state, strict=True, assign=True)
    lengths = [8192, 5231]
    batch = ds_batch(cfg32, lengths, cfg32.max_token_num, seed)
    chosen = {"program": [], "reference": []}
    ds.route, ref.route = rec_prog, rec_ref
    try:
        with torch.no_grad():
            pooled = model32.longformer.forward_eager(*(batch[k] for k in keys))[1]
            want = torch.cat([ref.encode(state, cfg32, {k: v[r:r + 1] for k, v in batch.items()})[1]
                              for r in range(2)])
    finally:
        ds.route, ref.route = prog_route, ref_route
    gap32 = float((pooled - want).abs().max() / want.abs().max())
    flips32 = sum(int((pe.view(2, L, K)[r, :n].sort(-1).values
                       != chosen["reference"][r * len(chosen["program"]) + i].view(-1, K)[:n]
                       .sort(-1).values).any(-1).sum())
                  for i, pe in enumerate(chosen["program"]) for r, n in enumerate(lengths))
    emit("deepseek_v3_float32_vs_reference", lengths=lengths, pooled_max_rel_err=gap32,
         routing_flips=flips32, routing_flip_share=flips32 / total, card=card)
    out.update(pooled_gap_float32=gap32)
    # bf16's pooled gap is reported, not held: its routing flips scatter it
    # from seed to seed (cosine 0.86-0.998 against the reference)
    if moe_gap > 2e-2 or gap32 > 1e-3:
        raise AssertionError(f"deepseek_v3 against the reference: moe {moe_gap}, "
                             f"float32 {gap32}")
    out.update(rank_replay_ms=replay_ms)
    return out


def run_offline_clis(seed, card):
    """``cli.encode_items`` and ``cli.evaluate_seq`` at base width on the card
    under ``--embed_ln_impl pallas`` (kernels 1 and 3): encode_items writes a
    512-item catalog; evaluate_seq encodes afresh and ranks 64 users, then
    ranks them again from encode_items' catalog, which must give the same
    metrics (one seed, deterministic kernels)."""
    from recformer_tpu_torch.cli import encode_items, evaluate_seq
    from recformer_tpu_torch.data.datasets import EvalDataset
    from recformer_tpu_torch.utils.io import load_finetune_artifacts

    n_items, n_users, enc_bs, eval_bs, layers = 512, 64, 256, 16, 12
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(tmp, n_items=n_items, n_users=n_users, seed=seed)
        train, val, test, *_ = load_finetune_artifacts(tmp)
        eval_fw = math.ceil(len(EvalDataset(train, val, test, "test", max_items=50)) / eval_bs)
        enc_fw = math.ceil(n_items / enc_bs)
        npy = os.path.join(tmp, "catalog.npy")
        common = ["--data_path", tmp, "--model_size", "base", "--embed_ln_impl", "pallas",
                  "--device", "cuda"]
        ev_args = common + ["--ckpt", "", "--batch_size", str(eval_bs),
                            "--encode_batch_size", str(enc_bs)]
        for name, call, forwards in (
                ("encode_items", lambda: encode_items.main(
                    common + ["--output", npy, "--batch_size", str(enc_bs)]), enc_fw),
                ("evaluate_seq", lambda: evaluate_seq.main(ev_args), enc_fw + eval_fw),
                ("evaluate_seq_saved_catalog",
                 lambda: evaluate_seq.main(ev_args + ["--item_embeddings", npy]), eval_fw)):
            reset_counts()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            all_on_tensor_cores(name)
            counts = {k: v for k, v in read_counts().items() if v}
            expected = {"band_attention_fwd": layers * forwards,
                        "band_attention_fwd_tc": layers * forwards,
                        "embed_layernorm_fwd": forwards}
            runs[name] = (out, counts)
            emit("offline_cli", cli=name, seconds=secs, launches=counts,
                 expected_launches=expected, card=card)
            if counts != expected:
                raise AssertionError(f"{name}: launches {counts}, expected {expected}")
    emb = runs["encode_items"][0]
    fresh, saved = runs["evaluate_seq"][0], runs["evaluate_seq_saved_catalog"][0]
    ok = (emb.shape == (n_items, 768) and bool(np.isfinite(emb).all())
          and fresh and all(math.isfinite(v) for v in fresh.values()) and saved == fresh)
    emit("offline_clis", items=n_items, users=n_users, metrics=fresh,
         saved_catalog_metrics_equal=saved == fresh, ok=ok)
    if not ok:
        raise AssertionError(f"offline CLIs: catalog {emb.shape}, metrics {fresh} vs {saved}")
    total = {}
    for _, counts in runs.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# the pretraining path at full base width
# ---------------------------------------------------------------------------

def pretrain_world(cfg, seed, n_items=10_000, batch=8):
    """A synthetic 10,000-item table and one batch of histories of 16-50
    items (the history view fills up to its 1024 tokens), on the card."""
    dev = torch.device("cuda")
    table = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_table(cfg, n_items, seed).items()}
    rng = np.random.default_rng(seed + 2)
    S = cfg.max_item_embeddings - 1
    item_ids = torch.from_numpy(rng.integers(0, n_items, size=(batch, S)).astype(np.int32))
    seq_lens = torch.from_numpy(rng.integers(16, S + 1, size=batch).astype(np.int32))
    return table, item_ids.to(dev), seq_lens.to(dev)


KERNELS = ("band_attention_fwd", "band_attention_bwd") + LN_KERNELS
# the probe kernels (TPU kernels 6 and 7), launched by their entry points
PROBE_KERNELS = ("band_ablation", "band_headpair")
# the LayerNorm kernels' device names (embed_layernorm.cu, layernorm_bwd.cu)
LN_KERNEL_NAME = re.compile(r"::(embed_ln_fwd|embed_ln_bwd|ln_bwd)_kernel<")
# the counts a run reads: each kernel's, and the attention kernels' tensor-core
# launches
COUNTERS = KERNELS + ("band_attention_fwd_tc", "band_attention_bwd_tc") + PROBE_KERNELS
# the program's counter (``utils/profiling.py``) behind each count
COUNTER_NAMES = dict(zip(COUNTERS, (
    "kernel1.launches", "kernel2.launches", "kernel3.launches", "kernel4.launches",
    "kernel5.launches", "kernel1.tensor_core", "kernel2.tensor_core", "ablation.launches",
    "headpair.launches")))


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from recformer_tpu_torch.utils import profiling

    profiling.reset_counters()


def read_counts() -> dict:
    """Every count of COUNTERS since the last reset."""
    from recformer_tpu_torch.utils import profiling

    got = profiling.counters()
    return {k: got.get(name, 0) for k, name in COUNTER_NAMES.items()}


def all_on_tensor_cores(what) -> tuple:
    """The attention forward's launches since the last reset, and those of
    them on the tensor cores; raises unless they are all (bf16, base width)."""
    counts = read_counts()
    n, tc = counts["band_attention_fwd"], counts["band_attention_fwd_tc"]
    if tc != n:
        raise AssertionError(f"{what}: {n - tc} of {n} attention forwards left the tensor cores")
    return n, tc


def forward_runs(cfg) -> int:
    """How many times a training step runs each layer's attention forward:
    twice under a remat policy that does not keep the core's output (the
    backward recomputes it), else once."""
    return 2 if cfg.remat and cfg.remat_policy in ("full", "dots") else 1


def launches_per_step(cfg) -> dict:
    """Launches of each kernel one pretraining step makes, by reading the
    code: two towers, each one fused (2B, L) forward and its backward; the
    attention kernels once per layer (the forward twice under ``forward_runs``),
    the embedding kernels once per tower,
    the LayerNorm backward twice per layer (the attention and feed-forward
    blocks); the LM head's LayerNorm is flax's under every flag. In bf16
    at the base head width and window every attention forward and backward
    takes the tensor-core kernels. A step launches no probe kernel."""
    towers, layers = 2, cfg.num_hidden_layers
    emb = towers if cfg.embed_ln_impl == "pallas" else 0
    D = cfg.hidden_size // cfg.num_attention_heads
    tc = sum(tensor_core_shape(cfg.compute_dtype, D, w, 1) for w in cfg.attention_window)
    fwd = forward_runs(cfg)
    return {"band_attention_fwd": fwd * towers * layers, "band_attention_bwd": towers * layers,
            "band_attention_fwd_tc": fwd * towers * tc, "band_attention_bwd_tc": towers * tc,
            "embed_layernorm_fwd": emb, "embed_layernorm_bwd": emb,
            "layernorm_bwd": 2 * towers * layers if cfg.ln_impl == "pallas_bwd" else 0,
            **{k: 0 for k in PROBE_KERNELS}}


def run_pretrain_step(seed, card, phase="pretrain_step", baseline=None, **flags):
    """20 timed base-width pretraining steps (after 2 warm-up steps) with
    dropout 0.1 under ``RecformerConfig.base(**flags)``, launch counts per
    step, then 10 steps on one fixed batch with dropout off, whose loss must
    fall. Returns the launch counts and the rates."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import make_pretrain_batch, mlm_for_config
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_pretrain_step
    from recformer_tpu_torch.utils.rng import StepRNG

    cfg = RecformerConfig.base(**flags)
    assert cfg.fuse_mlm_pass and cfg.attention_probs_dropout_prob == 0.1
    B = 8
    table, item_ids, seq_lens = pretrain_world(cfg, seed, batch=B)
    model = init_model_params(RecformerForPretraining(cfg), cfg, device="cuda", seed=seed)
    opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=1000, total_steps=10_000)
    step = make_pretrain_step(cfg, model, opt)
    rng = StepRNG(seed, "cuda")
    for _ in range(2):
        step(rng, table, item_ids, seq_lens)
    torch.cuda.synchronize()

    n = 20
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(rng, table, item_ids, seq_lens) for _ in range(n)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    expected = launches_per_step(cfg)
    # the device kernels of one step (torch.profiler), and among them the
    # LayerNorm kernels': one device kernel per launch
    names = kernels_per_call(lambda: step(rng, table, item_ids, seq_lens))
    ln_names = [m.group(1) for m in map(LN_KERNEL_NAME.search, names) if m]
    ln_kernels = {k: ln_names.count(k) for k in sorted(set(ln_names))}
    ln_expected = {k: v for k, v in zip(("embed_ln_fwd", "embed_ln_bwd", "ln_bwd"), (
        expected["embed_layernorm_fwd"], expected["embed_layernorm_bwd"],
        expected["layernorm_bwd"])) if v}
    ok = (all(counts[k] == expected[k] * n for k in COUNTERS)
          and all(math.isfinite(x) for x in losses) and ln_kernels == ln_expected)
    rates = dict(steps_per_s=n / secs, examples_per_s=B * n / secs,
                 peak_memory_gib=peak / 2 ** 30, device_kernels_per_step=len(names))
    extra = {}
    if baseline is None:
        # what the whole-word MLM (its greedy selection included) costs a step
        ba, bb = make_pretrain_batch(rng.device, table, item_ids, seq_lens, cfg)
        extra["mlm_selection_ms_per_step"] = median_launch_ms(
            lambda: (mlm_for_config(rng.device, ba, cfg), mlm_for_config(rng.device, bb, cfg)),
            n=10, warmup=2)
    else:
        extra["default_config"] = baseline
    emit(phase, config=f"RecformerConfig.base({', '.join(f'{k}={v!r}' for k, v in flags.items())})",
         batch=B, views=[[2 * B, cfg.max_token_num], [2 * B, cfg.item_seq_len]], steps=n,
         seconds=secs, **rates, **extra,
         launches_per_step={k: counts[k] / n for k in COUNTERS}, expected_per_step=expected,
         layernorm_device_kernels_per_step=ln_kernels,
         loss_first=losses[0], loss_last=losses[-1], card=card, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: launches {counts} over {n} steps (expected "
                             f"{expected} each step), LayerNorm device kernels a step "
                             f"{ln_kernels} (expected {ln_expected}), losses {losses}")

    # one fixed batch, dropout off: the same generator state each step
    cfg0 = cfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model0 = init_model_params(RecformerForPretraining(cfg0), cfg0, device="cuda", seed=seed)
    opt0 = create_optimizer(model0, learning_rate=1e-4, warmup_steps=2, total_steps=100)
    step0 = make_pretrain_step(cfg0, model0, opt0)
    fixed = [float(step0(StepRNG(seed + 5, "cuda"), table, item_ids, seq_lens)["loss"])
             for _ in range(10)]
    falls = all(math.isfinite(x) for x in fixed) and np.mean(fixed[-3:]) < np.mean(fixed[:3])
    fixed_phase = "pretrain_fixed_batch" if baseline is None else f"{phase}_fixed_batch"
    emit(fixed_phase, steps=10, dropout=0.0, losses=fixed, falls=bool(falls), ok=bool(falls))
    if not falls:
        raise AssertionError(f"{fixed_phase}: loss did not fall: {fixed}")
    del model, model0, opt, opt0
    torch.cuda.empty_cache()
    return counts, rates


def run_pretrain_turns(seed, card, blocks=("default", "ln_kernels", "ln_kernels", "default"),
                       steps=6):
    """The default configuration and the LayerNorm kernels' configuration
    timed in turns in one process (``blocks`` of ``steps`` steps each, after
    2 warm-up steps of each), so that drift over the call falls on both."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_pretrain_step
    from recformer_tpu_torch.utils.rng import StepRNG

    flags = {"default": {}, "ln_kernels": dict(embed_ln_impl="pallas", ln_impl="pallas_bwd")}
    runs = {}
    for name, fl in flags.items():
        cfg = RecformerConfig.base(**fl)
        table, item_ids, seq_lens = pretrain_world(cfg, seed)
        model = init_model_params(RecformerForPretraining(cfg), cfg, device="cuda", seed=seed)
        opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=1000, total_steps=10_000)
        runs[name] = (make_pretrain_step(cfg, model, opt), StepRNG(seed, "cuda"),
                      table, item_ids, seq_lens)
        for _ in range(2):
            runs[name][0](*runs[name][1:])
    torch.cuda.synchronize()
    rates = []
    for name in blocks:
        step, *args = runs[name]
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*args)
        torch.cuda.synchronize()
        rates.append((name, steps / (time.perf_counter() - t0)))
    emit("pretrain_turns", steps_per_block=steps, steps_per_s=rates,
         mean_steps_per_s={n: float(np.mean([r for m, r in rates if m == n])) for n in flags},
         card=card)
    del runs
    torch.cuda.empty_cache()


ATTN_PROJ = re.compile(r"\.attention\.self\.(query|key|value)(_global)?\.(weight|bias)$")
LAYERNORM_PARAM = re.compile(r"\.LayerNorm\.(weight|bias)$")


def step_grads(seed, flags_a, flags_b):
    """One deterministic loss and backward in float32 compute from the same
    weights and batch under ``RecformerConfig.base(dtype='float32')``
    replaced with each of two flag sets. Returns the flattened gradients'
    cosine, each tensor's share of b's squared norm, each tensor's relative
    error, and both losses."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import make_pretrain_batch
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.steps import pretrain_loss

    cfg = RecformerConfig.base().replace(dtype="float32")
    table, item_ids, seq_lens = pretrain_world(cfg, seed + 7)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ba, bb = make_pretrain_batch(gen, table, item_ids, seq_lens, cfg)
    model = init_model_params(RecformerForPretraining(cfg), cfg, device="cuda", seed=seed)
    state = {n: t.clone() for n, t in model.state_dict().items()}
    del model

    def grads(flags):
        c = cfg.replace(**flags)
        model = RecformerForPretraining(c).to("cuda")
        model.load_state_dict(state)
        loss, _ = pretrain_loss(c, model(ba, bb), ba, bb)
        loss.backward()
        return {n: p.grad.float() for n, p in model.named_parameters()}, float(loss.detach())

    (ga, loss_a), (gb, loss_b) = grads(flags_a), grads(flags_b)
    return (*grad_stats(ga, gb), loss_a, loss_b)


def grad_stats(ga, gb):
    """Two gradient sets' flattened cosine, each tensor's share of b's
    squared norm and each tensor's relative error; frees both."""
    cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([g.flatten() for g in ga.values()]),
        torch.cat([gb[n].flatten() for n in ga]), dim=0))
    total = sum(float(g.norm() ** 2) for g in gb.values())
    share = {n: float(g.norm() ** 2) / total for n, g in gb.items()}
    rel = {n: float((g - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n, g in ga.items()}
    ga.clear()
    gb.clear()
    torch.cuda.empty_cache()
    return cos, share, rel


def gate_grads(phase, pattern, min_gated, cos, share, rel, min_cos=0.999, **record):
    """cosine > ``min_cos``, and every tensor whose name matches ``pattern``
    and that carries more than 1e-10 of the squared norm within 1e-3
    relative."""
    gated = [n for n in rel if pattern.search(n) and share[n] > 1e-10]
    worst = max(gated, key=rel.get)
    worst_any = max(rel, key=rel.get)
    ok = cos > min_cos and len(gated) >= min_gated and rel[worst] <= 1e-3
    emit(phase, dtype="float32", grad_cosine=cos, min_cosine=min_cos, **record,
         tensors_gated=len(gated),
         worst_gated_tensor=worst, worst_gated_rel_err=rel[worst],
         worst_gated_norm_share=share[worst], worst_tensor=worst_any,
         worst_rel_err=rel[worst_any], worst_tensor_norm_share=share[worst_any], ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: cosine {cos}, {worst} relative error {rel[worst]} "
                             f"({len(gated)} gated)")


def run_pretrain_vs_chunked(seed):
    """The kernel path (both attention kernels' float32 paths) against the
    plain chunked attention: cosine > 0.999, and each attention projection's
    gradient within 1e-3 relative wherever it carries more than rounding (a
    key bias's gradient is zero up to rounding, softmax being
    shift-invariant); the pooled cosine is dominated by the embedding and
    decoder gradients and cannot see a fault in the attention backward
    alone."""
    cos, share, rel, loss_k, loss_c = step_grads(seed, dict(attention_impl="pallas"),
                                                 dict(attention_impl="chunked"))
    gate_grads("pretrain_vs_chunked", ATTN_PROJ, 4 * 12, cos, share, rel,
               loss_kernel=loss_k, loss_chunked=loss_c)


def run_pretrain_ln_kernels_vs_plain(seed):
    """The LayerNorm kernels' configuration (``embed_ln_impl='pallas'``,
    ``ln_impl='pallas_bwd'``: kernels 3-5 in float32) against ``'xla'`` and
    ``'split_bwd'``, which compute the same math in plain PyTorch in float32:
    cosine > 0.999, and every LayerNorm weight and bias gradient (the
    embedding LayerNorm's included, 2 x 12 x 2 + 2 tensors) within 1e-3
    relative."""
    cos, share, rel, loss_k, loss_p = step_grads(
        seed, dict(embed_ln_impl="pallas", ln_impl="pallas_bwd"),
        dict(embed_ln_impl="xla", ln_impl="split_bwd"))
    gate_grads("pretrain_ln_kernels_vs_plain", LAYERNORM_PARAM, 2 * 2 * 12 + 2, cos, share,
               rel, loss_kernels=loss_k, loss_plain=loss_p)


# ---------------------------------------------------------------------------
# the finetuning path at full base width
# ---------------------------------------------------------------------------

def finetune_launches_per_step(cfg) -> dict:
    """Launches of each kernel one finetune or fraud step makes, by reading the code:
    the sequence tower's forward and backward, the attention kernels once
    per layer each (the forward twice under ``forward_runs``; on the tensor
    cores in bf16 at the base head width and window), no other kernel."""
    layers = cfg.num_hidden_layers
    D = cfg.hidden_size // cfg.num_attention_heads
    tc = sum(tensor_core_shape(cfg.compute_dtype, D, w, 1) for w in cfg.attention_window)
    fwd = forward_runs(cfg)
    return {**{k: 0 for k in COUNTERS}, "band_attention_fwd": fwd * layers,
            "band_attention_bwd": layers, "band_attention_fwd_tc": fwd * tc,
            "band_attention_bwd_tc": tc}


def profile_call(fn) -> dict:
    """One call of ``fn`` after a warm-up call and one unprofiled timed call,
    then one under ``torch.profiler``: its device kernels, the device's busy
    time (the union of their intervals) and the idle share against the
    unprofiled wall time (and the profiled one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.events())
    busy = busy_ms(kernels)
    return {"device_kernels": len(kernels), "device_busy_ms": busy, "wall_ms": plain,
            "profiled_wall_ms": wall, "device_idle_share": 1.0 - busy / plain,
            "device_idle_share_profiled": 1.0 - busy / wall}


def finetune_world(cfg, seed, batch=16):
    """``pretrain_world``'s table and histories (16-50 items, so the history
    view fills its 1024 tokens) at ``batch``, and a random catalog of the
    table's items in the compute type, on the card."""
    table, item_ids, seq_lens = pretrain_world(cfg, seed, batch=batch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    catalog = torch.randn(int(table["lengths"].shape[0]) - 1, cfg.hidden_size, generator=gen,
                          device="cuda").to(cfg.compute_dtype)
    return table, item_ids, seq_lens, catalog


def run_finetune_step(seed, card, negatives, phase):
    """20 timed base-width finetune steps (after 2 warm-up steps) at batch
    16, dropout 0.1, accumulation 8 (the CLI's default), the full softmax
    (``negatives`` 0) or the sampled one; launches per step; one profiled
    step; then 20 steps on one fixed batch (targets and negatives drawn
    once) with dropout off, whose loss must fall. Returns the launch counts."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import make_finetune_batch
    from recformer_tpu_torch.models.heads import RecformerForSeqRec
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import finetune_loss, make_finetune_step

    cfg = RecformerConfig.base(finetune_negative_sample_size=negatives)
    assert cfg.attention_probs_dropout_prob == 0.1 and cfg.compute_dtype == torch.bfloat16
    B = 16
    table, item_ids, seq_lens, catalog = finetune_world(cfg, seed, batch=B)
    model = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda", seed=seed)
    opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=100, total_steps=10_000,
                           grad_accum_steps=8)
    step = make_finetune_step(cfg, model, opt)
    for _ in range(2):
        step(seed, table, item_ids, seq_lens, catalog)
    torch.cuda.synchronize()

    n = 20
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(seed, table, item_ids, seq_lens, catalog) for _ in range(n)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    expected = finetune_launches_per_step(cfg)
    prof = profile_call(lambda: step(seed, table, item_ids, seq_lens, catalog))
    ok = (all(counts[k] == expected[k] * n for k in COUNTERS)
          and all(math.isfinite(x) for x in losses))
    emit(phase, config=f"RecformerConfig.base(finetune_negative_sample_size={negatives})",
         batch=B, view=[B, cfg.max_token_num], catalog=list(catalog.shape), steps=n,
         grad_accum_steps=8, seconds=secs, steps_per_s=n / secs, examples_per_s=B * n / secs,
         peak_memory_gib=peak / 2 ** 30, profiled_step=prof,
         launches_per_step={k: counts[k] / n for k in COUNTERS}, expected_per_step=expected,
         loss_first=losses[0], loss_last=losses[-1], card=card, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: launches {counts} over {n} steps (expected {expected} "
                             f"each step), losses {losses}")
    del model, opt, step

    cfg0 = cfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model0 = init_model_params(RecformerForSeqRec(cfg0), cfg0, device="cuda", seed=seed)
    opt0 = create_optimizer(model0, learning_rate=1e-4, warmup_steps=2, total_steps=100)
    batch, labels = make_finetune_batch(torch.Generator(device="cuda").manual_seed(seed + 5),
                                        table, item_ids, seq_lens, cfg0)
    fixed = []
    for _ in range(20):
        loss = finetune_loss(cfg0, model0(batch), catalog, labels,
                             torch.Generator(device="cuda").manual_seed(seed + 6))
        loss.backward()
        opt0.step()
        fixed.append(float(loss.detach()))
    falls = all(math.isfinite(x) for x in fixed) and np.mean(fixed[-3:]) < np.mean(fixed[:3])
    emit(f"{phase}_fixed_batch", steps=20, dropout=0.0, losses=fixed, falls=bool(falls),
         ok=bool(falls))
    if not falls:
        raise AssertionError(f"{phase}_fixed_batch: loss did not fall: {fixed}")
    del model0, opt0
    torch.cuda.empty_cache()
    return counts


def run_finetune_vs_chunked(seed):
    """The float32 gradients of one deterministic finetune loss (full
    softmax over a 10,000-item catalog) through the attention kernels
    against the plain chunked attention, from the same weights and batch:
    cosine > 0.999, each attention projection within 1e-3 relative (the
    gate of pretrain_vs_chunked), and the pooled outputs' cosine."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import make_finetune_batch
    from recformer_tpu_torch.models.heads import RecformerForSeqRec, cosine_similarity
    from recformer_tpu_torch.training.steps import finetune_loss

    cfg = RecformerConfig.base(dtype="float32")
    table, item_ids, seq_lens, catalog = finetune_world(cfg, seed + 7)
    batch, labels = make_finetune_batch(torch.Generator(device="cuda").manual_seed(seed),
                                        table, item_ids, seq_lens, cfg)
    model = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda", seed=seed)
    state = {n: t.clone() for n, t in model.state_dict().items()}
    del model

    def grads(impl):
        c = cfg.replace(attention_impl=impl)
        model = RecformerForSeqRec(c).to("cuda")
        model.load_state_dict(state)
        pooled = model(batch)
        loss = finetune_loss(c, pooled, catalog, labels, None)
        loss.backward()
        return ({n: p.grad.float() for n, p in model.named_parameters()}, float(loss.detach()),
                pooled.detach())

    (ga, loss_k, pooled_k), (gb, loss_c, pooled_c) = grads("pallas"), grads("chunked")
    pooled_cos = float(cosine_similarity(pooled_k, pooled_c).min())
    cos, share, rel = grad_stats(ga, gb)
    gate_grads("finetune_vs_chunked", ATTN_PROJ, 4 * 12, cos, share, rel, loss_kernel=loss_k,
               loss_chunked=loss_c, min_pooled_cosine=pooled_cos)
    if pooled_cos <= 0.999:
        raise AssertionError(f"finetune_vs_chunked: pooled cosine {pooled_cos}")


class _Interrupt(Exception):
    pass


def run_finetune_cli(seed, card):
    """``cli.finetune --model_size base --device cuda`` on a corpus of 512
    items and 32 users with histories of 16-50 items: two epochs a stage,
    dev ranking every epoch, batch 16, accumulation 2, otherwise the
    defaults (1,000 sampled negatives). The outputs must be written, the
    test metrics finite, and kernels 1 and 2 launched exactly as the code
    says. Then a second run is stopped in stage 2 (its log raises at the
    first stage-2 dev row) and continued with ``--resume``: the parameters
    it restores must equal the saved train state bit for bit, and it must
    say where it resumed. Returns the launch counts of the first run and of
    the resumed one."""
    from recformer_tpu_torch.cli import finetune
    from recformer_tpu_torch.training import loops

    n_items, n_users, bs, enc_bs, eval_bs, epochs, layers = 512, 32, 16, 256, 32, 2, 12
    steps = epochs * (n_users // bs)  # a stage
    enc_fw, eval_fw = math.ceil(n_items / enc_bs), math.ceil(n_users / eval_bs)

    def expect(forwards, backwards):
        return {**{k: 0 for k in COUNTERS}, "band_attention_fwd": layers * forwards,
                "band_attention_fwd_tc": layers * forwards,
                "band_attention_bwd": layers * backwards,
                "band_attention_bwd_tc": layers * backwards}

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        write_corpus(data, n_items=n_items, n_users=n_users, seed=seed, hist=(16, 51))
        args = ["--data_path", data, "--model_size", "base", "--device", "cuda",
                "--num_train_epochs", str(epochs), "--verbose", "1", "--batch_size", str(bs),
                "--gradient_accumulation_steps", "2", "--seed", str(seed)]
        out = os.path.join(tmp, "out")
        reset_counts()
        t0 = time.perf_counter()
        metrics = finetune.main(args + ["--output_dir", out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        written = sorted(os.listdir(os.path.join(out, "data")))
        # the initial encode and one a stage-1 epoch; the train steps of both
        # stages; the dev ranking every epoch of both stages, and the test
        expected = expect((1 + epochs) * enc_fw + 2 * steps + (2 * epochs + 1) * eval_fw,
                          2 * steps)
        ok = (counts == expected and written == ["best_model.pt", "config.json",
                                                 "item_embeddings.npy", "test_metrics.json"]
              and bool(metrics) and all(math.isfinite(v) for v in metrics.values()))
        emit("finetune_cli", items=n_items, users=n_users, epochs_per_stage=epochs,
             train_steps=2 * steps, seconds=secs, test_metrics=metrics, written=written,
             launches=counts, expected_launches=expected, card=card, ok=ok)
        if not ok:
            raise AssertionError(f"finetune_cli: written {written}, metrics {metrics}, "
                                 f"launches {counts} (expected {expected})")

        out2 = os.path.join(tmp, "out2")
        real_loop, real_restore = finetune.finetune_two_stage, loops.restore_train_state
        logs, restored = [], {}

        def stop_in_stage2(msg):
            print(msg, flush=True)
            if "[stage2]" in str(msg):
                raise _Interrupt

        def record(msg):
            logs.append(str(msg))
            print(msg, flush=True)

        def checked_restore(path, model, optimizer):
            pos = real_restore(path, model, optimizer)
            saved = torch.load(path, map_location="cpu", weights_only=True)["params"]
            restored["params_bit_equal"] = all(torch.equal(v.cpu(), saved[k])
                                               for k, v in model.state_dict().items())
            return pos

        try:
            finetune.finetune_two_stage = lambda *a, **k: real_loop(*a, **k, log=stop_in_stage2)
            interrupted = False
            try:
                finetune.main(args + ["--output_dir", out2])
            except _Interrupt:
                interrupted = True
            stale = os.path.exists(os.path.join(out2, "data", "loop_state", "loop.json"))
            finetune.finetune_two_stage = lambda *a, **k: real_loop(*a, **k, log=record)
            loops.restore_train_state = checked_restore
            reset_counts()
            resumed = finetune.main(args + ["--output_dir", out2, "--resume"])
            torch.cuda.synchronize()
            resume_counts = read_counts()
        finally:
            finetune.finetune_two_stage, loops.restore_train_state = real_loop, real_restore
        resumed_at = [m for m in logs if "resumed at" in m]
        # stage 2 from its first epoch: its train steps, its dev rankings, the test
        resume_expected = expect(steps + (epochs + 1) * eval_fw, steps)
        ok = (interrupted and stale and restored.get("params_bit_equal") is True
              and len(resumed_at) == 1 and "resumed at stage 2 epoch 0" in resumed_at[0]
              and resume_counts == resume_expected
              and not os.path.exists(os.path.join(out2, "data", "loop_state"))
              and all(math.isfinite(v) for v in resumed.values()))
        emit("finetune_cli_resume", interrupted_in_stage2=interrupted,
             loop_state_left=stale, restored=restored, resumed_at=resumed_at,
             test_metrics=resumed, uninterrupted_test_metrics=metrics,
             launches=resume_counts, expected_launches=resume_expected, ok=ok)
        if not ok:
            raise AssertionError(f"finetune_cli_resume: interrupted {interrupted}, stale "
                                 f"{stale}, {restored}, {resumed_at}, launches "
                                 f"{resume_counts} (expected {resume_expected})")
    return counts, resume_counts


def run_encode_embed_kernel(seed, card):
    """A base-width encode of 2,048 items under ``embed_ln_impl='pallas'``
    (bf16): kernel 3 once per chunk, pooled outputs against the default
    path's from the same weights (cosine > 0.999)."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForSeqRec, cosine_similarity
    from recformer_tpu_torch.training.loops import encode_all_items
    from recformer_tpu_torch.training.steps import make_encode_items_step

    dev = torch.device("cuda")
    cfg = RecformerConfig.base(embed_ln_impl="pallas")
    cfg_d = RecformerConfig.base()
    model = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda", seed=seed)
    plain = RecformerForSeqRec(cfg_d).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    n_items, bs = 2048, 256
    table = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_table(cfg, n_items, seed + 3).items()}
    for c, m in ((cfg, model), (cfg_d, plain)):  # warm-up
        make_encode_items_step(c, m)(table, torch.arange(bs, device=dev))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    emb = encode_all_items(model, table, cfg, batch_size=bs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    emb_d = encode_all_items(plain, table, cfg_d, batch_size=bs)
    cos = cosine_similarity(emb.float(), emb_d.float())
    forwards = math.ceil(n_items / bs)
    ok = (tuple(emb.shape) == (n_items, cfg.hidden_size) and bool(torch.isfinite(emb).all())
          and counts["embed_layernorm_fwd"] == forwards
          and counts["band_attention_fwd"] == cfg.num_hidden_layers * forwards
          and counts["band_attention_fwd_tc"] == counts["band_attention_fwd"]
          and float(cos.min()) > 0.999)
    emit("encode_embed_kernel", items=n_items, batch=bs, seq_len=cfg.item_seq_len,
         seconds=secs, items_per_s=n_items / secs, launches=counts, forwards=forwards,
         min_cosine_vs_default=float(cos.min()), card=card, ok=ok)
    if not ok:
        raise AssertionError(f"encode_embed_kernel: launches {counts}, min cosine "
                             f"{float(cos.min())}")
    del model, plain
    torch.cuda.empty_cache()
    return counts


def run_pretrain_cli(seed, phase="pretrain_cli", extra=(), keep=None):
    """``cli.pretrain --model_size base --device cuda`` (plus ``extra``) on a
    small corpus: one epoch with accumulation 2, dev validation, best and
    last saved; ``best.pt`` is copied into the directory ``keep`` if given."""
    from recformer_tpu_torch.cli import pretrain
    from recformer_tpu_torch.config import RecformerConfig

    with tempfile.TemporaryDirectory() as tmp:
        seqs = write_corpus(tmp, n_users=24, seed=seed)
        with open(os.path.join(tmp, "train.json"), "w") as f:
            json.dump(list(seqs.values()), f)
        with open(os.path.join(tmp, "dev.json"), "w") as f:
            json.dump(list(seqs.values())[:8], f)
        out_dir = os.path.join(tmp, "out")
        reset_counts()
        res = pretrain.main(["--data_path", tmp, "--output_dir", out_dir,
                             "--model_size", "base", "--num_train_epochs", "1",
                             "--batch_size", "8", "--gradient_accumulation_steps", "2",
                             "--warmup_steps", "1", "--seed", str(seed), "--device", "cuda",
                             "--save_top_k", "2", *extra])
        counts = read_counts()
        written = sorted(os.listdir(out_dir))
        topk = sorted(os.listdir(os.path.join(out_dir, "topk")))
        cfg = RecformerConfig.load(os.path.join(out_dir, "config.json"))
        if keep:
            shutil.copy(os.path.join(out_dir, "best.pt"), keep)
    per_step = launches_per_step(cfg)
    # every step runs forward and backward; the one dev validation runs the
    # two towers' forward once more
    expected = {k: v * res["steps"] for k, v in per_step.items()}
    expected["band_attention_fwd"] += per_step["band_attention_fwd"]
    expected["band_attention_fwd_tc"] += per_step["band_attention_fwd_tc"]
    expected["embed_layernorm_fwd"] += per_step["embed_layernorm_fwd"]
    ok = (res["steps"] == 3 and res["updates"] == 1
          and {"best.pt", "last.pt", "state.pt"} <= set(written) and len(topk) == 1
          and counts == expected)
    emit(phase, **res, args=list(extra), ln_impl=cfg.ln_impl, written=written, topk=topk,
         launches=counts, expected_launches=expected, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: {res}, {written}, launches {counts} "
                             f"(expected {expected})")
    return counts


class _SignalAfter(dict):
    """The preemption flag of ``cli.pretrain``, read at every step boundary:
    at the ``n``-th read it sends SIGTERM to this process, which the real
    handler latches before the read returns."""

    def __init__(self, flag, n):
        super().__init__(flag)
        self.flag, self.n, self.reads = flag, n, 0

    def __getitem__(self, key):
        self.reads += 1
        if self.reads == self.n:
            os.kill(os.getpid(), signal.SIGTERM)
            if self.flag["signal"] != signal.SIGTERM:
                raise AssertionError("SIGTERM was not latched by the preemption handler")
        return self.flag[key]


def run_pretrain_preemption(seed):
    """``cli.pretrain --model_size base`` for two epochs of 3 steps with
    ``--save_top_k 1``, stopped by a real SIGTERM after its 5th step: the
    handler latches it, the step boundary saves ``state.pt`` and ``last.pt``
    and returns; ``--resume`` restores step 5, restarts epoch 1 from its
    first batch and runs to the end. The attention kernels' launches of
    both runs as the code says (8 steps, two dev validations)."""
    from recformer_tpu_torch.cli import pretrain
    from recformer_tpu_torch.config import RecformerConfig

    with tempfile.TemporaryDirectory() as tmp:
        seqs = write_corpus(tmp, n_users=24, seed=seed)
        with open(os.path.join(tmp, "train.json"), "w") as f:
            json.dump(list(seqs.values()), f)
        with open(os.path.join(tmp, "dev.json"), "w") as f:
            json.dump(list(seqs.values())[:8], f)
        out_dir = os.path.join(tmp, "out")
        args = ["--data_path", tmp, "--output_dir", out_dir, "--model_size", "base",
                "--num_train_epochs", "2", "--batch_size", "8", "--gradient_accumulation_steps",
                "2", "--warmup_steps", "1", "--seed", str(seed), "--save_top_k", "1",
                "--device", "cuda"]
        real = pretrain._install_preemption_handler
        reset_counts()
        try:
            pretrain._install_preemption_handler = lambda: _SignalAfter(real(), 5)
            first = pretrain.main(args)
        finally:
            pretrain._install_preemption_handler = real
        written = sorted(os.listdir(out_dir))
        second = pretrain.main(args + ["--resume"])
        counts = read_counts()
        topk = sorted(os.listdir(os.path.join(out_dir, "topk")))
        cfg = RecformerConfig.load(os.path.join(out_dir, "config.json"))
    per_step = launches_per_step(cfg)
    expected = {k: v * 8 for k, v in per_step.items()}
    for k in ("band_attention_fwd", "band_attention_fwd_tc", "embed_layernorm_fwd"):
        expected[k] += 2 * per_step[k]
    ok = (first["steps"] == 5 and first.get("preempted") == signal.SIGTERM
          and {"state.pt", "last.pt"} <= set(written) and "config.json" not in written
          and second["steps"] == 8 and "preempted" not in second and len(topk) == 1
          and counts == expected)
    emit("pretrain_cli_preemption", first=first, written_at_preemption=written, resumed=second,
         topk=topk, launches=counts, expected_launches=expected, ok=ok)
    if not ok:
        raise AssertionError(f"pretrain_cli_preemption: {first}, {written}, {second}, {topk}, "
                             f"launches {counts} (expected {expected})")
    return counts

# ---------------------------------------------------------------------------
# the fraud path and checkpoint conversion at full base width
# ---------------------------------------------------------------------------

def build_fraud_corpus(root, seed):
    """``pipelines.synthetic_transactions --scale small --build`` under
    ``root`` (400 + 100 cards of 5-60 transactions and their fraud bursts);
    returns its ``classification_data/`` directory."""
    from recformer_tpu_torch.pipelines import synthetic_transactions

    synthetic_transactions.main(["--out", root, "--scale", "small", "--seed", str(11 + seed),
                                 "--build"])
    return os.path.join(root, "artifacts", "classification_data")


def fraud_world(data, **cfg_kw):
    """The classification split's training cards as the fraud CLI reads
    them: the base config with the split's ``pos_weight``, the tokenized
    item table on the card (no cache) and the training ``FraudDataset``."""
    from recformer_tpu_torch.cli.common import make_tokenizer, table_to_device
    from recformer_tpu_torch.cli.finetune_classification import calculate_pos_weight
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.datasets import FraudDataset

    train = read_json(os.path.join(data, "train.json"), as_int=True)
    meta = read_json(os.path.join(data, "meta_data.json"))
    item2id = read_json(os.path.join(data, "smap.json"))
    ds = FraudDataset(train, max_items=max(len(v[0]) for v in train.values()))
    cfg = RecformerConfig.base(item_num=len(item2id), pos_weight=calculate_pos_weight(ds),
                               **cfg_kw)
    table = table_to_device(make_tokenizer(cfg).encode_corpus_table(meta, item2id), "cuda")
    return cfg, table, ds


def _on_card(b):
    return tuple(torch.from_numpy(a).cuda() for a in (b.item_ids, b.seq_lens, b.labels,
                                                       b.valid))


def fraud_batches(ds, n, seed=0):
    """``n`` training batches of 16 from shuffled passes over ``ds``, on the
    card: (item_ids, seq_lens, labels, valid)."""
    out = []
    while len(out) < n:
        out += [_on_card(b) for b in ds.batches(16, shuffle=True, seed=seed + len(out))]
    return out[:n]


def mixed_fraud_batch(ds):
    """One batch of 16 of ``ds``'s cards, half of them (at most) fraudulent,
    on the card."""
    from recformer_tpu_torch.data.datasets import FraudDataset

    pos = [i for i, y in enumerate(ds.labels) if y][:8]
    neg = [i for i, y in enumerate(ds.labels) if not y][:16 - len(pos)]
    sub = {j: [ds.seqs[i], [ds.labels[i]]] for j, i in enumerate(pos + neg)}
    return _on_card(next(FraudDataset(sub, ds.max_items).batches(16)))


def run_fraud_step(seed, card, data):
    """20 timed base-width fraud steps (after 2 warm-up steps) at batch 16
    over the corpus's training cards with their labels, dropout 0.1 (and
    the head's 0.2), ``pos_weight`` from the split, the head at 1e-3:
    steps/s, examples/s, peak memory, one profiled step, 12 + 12 attention
    launches a step, all on the tensor cores; then 20 steps on one fixed
    batch with every dropout off, whose loss must fall."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.data.device_pipeline import assemble_for_config
    from recformer_tpu_torch.models.heads import RecformerForFraudDetection
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import fraud_loss, make_fraud_train_step

    cfg, table, ds = fraud_world(data)
    assert cfg.attention_probs_dropout_prob == 0.1 and cfg.compute_dtype == torch.bfloat16
    B, n = 16, 20
    batches = fraud_batches(ds, n + 2, seed)
    model = init_model_params(RecformerForFraudDetection(cfg), cfg, device="cuda", seed=seed)
    opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=100, total_steps=10_000,
                           head_lr=1e-3)
    step = make_fraud_train_step(cfg, model, opt)
    for b in batches[:2]:
        step(seed, table, *b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = [step(seed, table, *b) for b in batches[2:]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    expected = finetune_launches_per_step(cfg)
    prof = profile_call(lambda: step(seed, table, *batches[2]))
    positives = sum(int(b[2].sum()) for b in batches[2:])
    lens = torch.cat([b[1][b[3]] for b in batches[2:]])
    ok = (all(counts[k] == expected[k] * n for k in COUNTERS)
          and all(math.isfinite(x) for x in losses))
    emit("fraud_step", config=f"RecformerConfig.base(pos_weight={cfg.pos_weight!r})",
         batch=B, view=[B, cfg.max_token_num], cards=len(ds), positives_in_timed_batches=positives,
         history_items=[int(lens.min()), int(lens.max())], steps=n, seconds=secs,
         steps_per_s=n / secs, examples_per_s=B * n / secs, peak_memory_gib=peak / 2 ** 30,
         profiled_step=prof, launches_per_step={k: counts[k] / n for k in COUNTERS},
         expected_per_step=expected, loss_first=losses[0], loss_last=losses[-1], card=card,
         ok=ok)
    if not ok:
        raise AssertionError(f"fraud_step: launches {counts} over {n} steps (expected "
                             f"{expected} each step), losses {losses}")
    del model, opt, step

    model0 = init_model_params(RecformerForFraudDetection(cfg), cfg, device="cuda", seed=seed)
    opt0 = create_optimizer(model0, learning_rate=1e-4, warmup_steps=2, total_steps=100,
                            head_lr=1e-3)
    ids, lens, labels, valid = mixed_fraud_batch(ds)
    batch = assemble_for_config(table, ids, lens, cfg)
    fixed = []
    for _ in range(20):
        loss = fraud_loss(cfg, model0(batch), labels, valid)  # deterministic: no dropout
        loss.backward()
        opt0.step()
        fixed.append(float(loss.detach()))
    falls = all(math.isfinite(x) for x in fixed) and np.mean(fixed[-3:]) < np.mean(fixed[:3])
    emit("fraud_step_fixed_batch", steps=20, dropout=0.0, positives=int(labels.sum()),
         losses=fixed, falls=bool(falls), ok=bool(falls))
    if not falls:
        raise AssertionError(f"fraud_step_fixed_batch: loss did not fall: {fixed}")
    del model0, opt0
    torch.cuda.empty_cache()
    return counts


def run_fraud_vs_chunked(seed, data):
    """The float32 gradients of one deterministic fraud loss (16 of the
    corpus's cards, half fraudulent, ``pos_weight`` from the split) through
    the attention kernels against the plain chunked attention, from the
    same weights: the gate of pretrain_vs_chunked over the backbone's
    gradients (at the initializer's scale the head's three layers shrink
    the backbone's gradients to about 1e-10 of the head's squared norm, so
    shares are taken within the backbone), the cosine of all gradients
    > 0.999, each head tensor within 1e-3 relative, and the logits within
    1e-3."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.data.device_pipeline import assemble_for_config
    from recformer_tpu_torch.models.heads import RecformerForFraudDetection
    from recformer_tpu_torch.training.steps import fraud_loss

    cfg, table, ds = fraud_world(data, dtype="float32")
    ids, lens, labels, valid = mixed_fraud_batch(ds)
    batch = assemble_for_config(table, ids, lens, cfg)
    model = init_model_params(RecformerForFraudDetection(cfg), cfg, device="cuda", seed=seed)
    state = {n: t.clone() for n, t in model.state_dict().items()}
    del model

    def grads(impl):
        c = cfg.replace(attention_impl=impl)
        model = RecformerForFraudDetection(c).to("cuda")
        model.load_state_dict(state)
        logits = model(batch)
        loss = fraud_loss(c, logits, labels, valid)
        loss.backward()
        return ({n: p.grad.float() for n, p in model.named_parameters()}, float(loss.detach()),
                logits.detach())

    (ga, loss_k, logits_k), (gb, loss_c, logits_c) = grads("pallas"), grads("chunked")
    logits_err = float((logits_k - logits_c).abs().max())
    head = [n for n in ga if not n.startswith("longformer.")]
    head_a, head_b = {n: ga.pop(n) for n in head}, {n: gb.pop(n) for n in head}
    all_cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([g.flatten() for g in (*ga.values(), *head_a.values())]),
        torch.cat([g.flatten() for g in (*gb.values(), *head_b.values())]), dim=0))
    head_rel = {n: float((head_a[n] - head_b[n]).norm() / head_b[n].norm().clamp_min(1e-30))
                for n in head}
    cos, share, rel = grad_stats(ga, gb)
    ok = all_cos > 0.999 and max(head_rel.values()) <= 1e-3 and logits_err <= 1e-3
    gate_grads("fraud_vs_chunked", ATTN_PROJ, 4 * cfg.num_hidden_layers, cos, share, rel,
               loss_kernel=loss_k, loss_chunked=loss_c, all_grad_cosine=all_cos,
               head_rel_err=head_rel, max_logit_abs_err=logits_err,
               positives=int(labels.sum()), head_ok=ok)
    if not ok:
        raise AssertionError(f"fraud_vs_chunked: cosine of all gradients {all_cos}, head "
                             f"{head_rel}, logits differ by {logits_err}")


class _MergeRecord(list):
    """Wraps ``cli.common.merge_params`` (the CLIs' one loader) and records,
    for each load, the names copied, skipped and the model's own."""

    def __enter__(self):
        from recformer_tpu_torch.cli import common

        self.common, self.real = common, common.merge_params

        def recording(source, model, verbose=True):
            copied, skipped = self.real(source, model, verbose)
            self.append((sorted(copied), skipped, sorted(model.state_dict())))
            return copied, skipped

        common.merge_params = recording
        return self

    def __exit__(self, *exc):
        self.common.merge_params = self.real

    def all_copied(self) -> bool:
        return len(self) == 1 and self[0][0] == self[0][2] and not self[0][1]


def run_convert_ckpt(seed, card, best_pt, out):
    """``cli.convert_ckpt --model_size base`` on ``cli.pretrain``'s
    ``best.pt``: every backbone tensor of ``recformer.pt``, ``seqrec.pt`` and
    ``fraud.pt`` bit-equal to the source, the fraud head the seeded
    initialiser's; then ``seqrec.pt`` into ``cli.finetune --pretrain_ckpt``
    for one short epoch a stage (256 items, 32 users), every tensor copied,
    kernels 1 and 2 launched as the code says. Returns those launches."""
    from recformer_tpu_torch.cli import convert_ckpt, finetune
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForFraudDetection
    from recformer_tpu_torch.training.checkpoint import load_torch_checkpoint, restore_params

    t0 = time.perf_counter()
    convert_ckpt.main(["--pretrain_ckpt", best_pt, "--output_dir", out, "--model_size",
                       "base", "--device", "cuda"])
    secs = time.perf_counter() - t0
    src = {k: v for k, v in load_torch_checkpoint(best_pt).items()
           if k.startswith("longformer.")}
    outputs = {n: restore_params(os.path.join(out, f"{n}.pt"))
               for n in ("recformer", "seqrec", "fraud")}
    equal = {}
    for name, sd in outputs.items():
        prefix = "" if name == "recformer" else "longformer."
        equal[name] = all(torch.equal(sd[prefix + k.removeprefix("longformer.")], v)
                          for k, v in src.items())
    cfg = RecformerConfig.base()
    fresh = init_model_params(RecformerForFraudDetection(cfg), cfg, device="cuda").state_dict()
    head = [k for k in outputs["fraud"] if k.startswith("fc")]
    head_seeded = all(torch.equal(outputs["fraud"][k], fresh[k].cpu()) for k in head)
    del fresh

    n_items, n_users, bs, enc_bs, eval_bs = 256, 32, 16, 256, 32
    layers, steps = cfg.num_hidden_layers, n_users // bs
    with tempfile.TemporaryDirectory() as tmp, _MergeRecord() as loads:
        write_corpus(tmp, n_items=n_items, n_users=n_users, seed=seed + 1, hist=(16, 51))
        reset_counts()
        metrics = finetune.main(["--data_path", tmp, "--output_dir", os.path.join(tmp, "out"),
                                 "--model_size", "base", "--device", "cuda",
                                 "--num_train_epochs", "1", "--verbose", "1", "--batch_size",
                                 str(bs), "--gradient_accumulation_steps", "2", "--seed",
                                 str(seed), "--pretrain_ckpt", os.path.join(out, "seqrec.pt")])
        torch.cuda.synchronize()
        counts = read_counts()
    fw = 2 * math.ceil(n_items / enc_bs) + 2 * steps + 3 * math.ceil(n_users / eval_bs)
    expected = {**{k: 0 for k in COUNTERS}, "band_attention_fwd": layers * fw,
                "band_attention_fwd_tc": layers * fw, "band_attention_bwd": layers * 2 * steps,
                "band_attention_bwd_tc": layers * 2 * steps}
    ok = (all(equal.values()) and len(src) == len(outputs["recformer"]) and len(head) == 6
          and head_seeded and loads.all_copied() and counts == expected
          and all(math.isfinite(v) for v in metrics.values()))
    emit("convert_ckpt", seconds=secs, source_backbone_tensors=len(src),
         tensors_written={n: len(sd) for n, sd in outputs.items()},
         backbone_bit_equal=equal, fraud_head_seeded=head_seeded,
         seqrec_into_finetune={"copied": len(loads[0][0]) if loads else 0,
                               "skipped": loads[0][1] if loads else None,
                               "test_metrics": metrics},
         launches=counts, expected_launches=expected, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"convert_ckpt: backbone equal {equal}, head seeded "
                             f"{head_seeded}, loads {[(len(a), b) for a, b, _ in loads]}, "
                             f"launches {counts} (expected {expected}), metrics {metrics}")
    return counts


def run_fraud_cli(seed, card, data, fraud_pt):
    """``cli.finetune_classification --model_size base --device cuda`` on the
    corpus's classification split, from ``cli.convert_ckpt``'s ``fraud.pt``
    (every backbone and head tensor copied): 2 epochs at batch 16, dev and
    test sweeps at 32, the head at 1e-3. Kernels 1 and 2 launched as the
    code says (train steps, dev sweeps, the test sweep), the outputs
    written, finite metrics. Then a second run dies at its second dev sweep
    (after epoch 0 was checkpointed) and is continued with ``--resume``:
    the restored parameters equal the saved train state bit for bit, and
    its test metrics equal the uninterrupted run's. Returns the launches of
    the first run and of the resumed one."""
    from recformer_tpu_torch.cli import finetune_classification as fc
    from recformer_tpu_torch.config import RecformerConfig

    n = {s: len(read_json(os.path.join(data, f"{s}.json"))) for s in ("train", "val", "test")}
    bs, eval_bs, epochs, layers = 16, 32, 2, RecformerConfig.base().num_hidden_layers
    steps = math.ceil(n["train"] / bs)  # an epoch: the last batch padded
    dev_fw, test_fw = math.ceil(n["val"] / eval_bs), math.ceil(n["test"] / eval_bs)

    def expect(epochs_run):
        fw = epochs_run * (steps + dev_fw) + test_fw
        return {**{k: 0 for k in COUNTERS}, "band_attention_fwd": layers * fw,
                "band_attention_fwd_tc": layers * fw,
                "band_attention_bwd": layers * epochs_run * steps,
                "band_attention_bwd_tc": layers * epochs_run * steps}

    args = ["--data_path", data, "--model_size", "base", "--device", "cuda",
            "--num_train_epochs", str(epochs), "--batch_size", str(bs), "--eval_batch_size",
            str(eval_bs), "--head_lr", "1e-3", "--seed", str(seed), "--pretrain_ckpt", fraud_pt]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        with _MergeRecord() as loads:
            reset_counts()
            t0 = time.perf_counter()
            metrics = fc.main(args + ["--output_dir", out])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
        res = os.path.join(out, "classification_data")
        written = sorted(os.listdir(res))
        with open(os.path.join(res, "epoch_metrics.json")) as f:
            epoch_rows = json.load(f)
        expected = expect(epochs)
        numbers = [v for k, v in metrics.items() if k != "confusion"]
        ok = (counts == expected and loads.all_copied()
              and written == ["best_model.pt", "config.json", "epoch_metrics.json",
                              "test_metrics.json"]
              and all(math.isfinite(v) for v in numbers) and len(epoch_rows) == epochs)
        emit("fraud_cli", cards=n, epochs=epochs, train_steps=epochs * steps,
             sweep_batches={"dev": epochs * dev_fw, "test": test_fw}, seconds=secs,
             fraud_pt_tensors_copied=len(loads[0][0]) if loads else 0,
             dev_rows=epoch_rows, test_metrics=metrics, written=written, launches=counts,
             expected_launches=expected, card=card, ok=ok)
        if not ok:
            raise AssertionError(f"fraud_cli: written {written}, metrics {metrics}, loads "
                                 f"{[(len(a), b) for a, b, _ in loads]}, launches {counts} "
                                 f"(expected {expected})")

        out2 = os.path.join(tmp, "out2")
        real_eval, real_restore = fc.evaluate_fraud, fc.restore_train_state
        sweeps, restored = [], {}

        def dies_at_second_sweep(*a, **k):
            sweeps.append(1)
            if len(sweeps) == 2:
                raise _Interrupt
            return real_eval(*a, **k)

        def checked_restore(path, model, optimizer):
            pos = real_restore(path, model, optimizer)
            saved = torch.load(path, map_location="cpu", weights_only=True)["params"]
            restored["params_bit_equal"] = all(torch.equal(v.cpu(), saved[k])
                                               for k, v in model.state_dict().items())
            restored["tensors"] = len(saved)
            return pos

        try:
            fc.evaluate_fraud = dies_at_second_sweep
            interrupted = False
            try:
                fc.main(args + ["--output_dir", out2])
            except _Interrupt:
                interrupted = True
            fc.evaluate_fraud = real_eval
            stale = os.path.exists(os.path.join(out2, "classification_data", "loop_state",
                                                "loop.json"))
            fc.restore_train_state = checked_restore
            reset_counts()
            resumed = fc.main(args + ["--output_dir", out2, "--resume"])
            torch.cuda.synchronize()
            resume_counts = read_counts()
        finally:
            fc.evaluate_fraud, fc.restore_train_state = real_eval, real_restore
        resume_expected = expect(1)
        ok = (interrupted and stale and restored.get("params_bit_equal") is True
              and resume_counts == resume_expected and resumed == metrics
              and not os.path.exists(os.path.join(out2, "classification_data", "loop_state")))
        emit("fraud_cli_resume", interrupted_at_epoch_1_sweep=interrupted,
             loop_state_left=stale, restored=restored, test_metrics=resumed,
             equals_uninterrupted=resumed == metrics, launches=resume_counts,
             expected_launches=resume_expected, ok=ok)
        if not ok:
            raise AssertionError(f"fraud_cli_resume: interrupted {interrupted}, stale {stale}, "
                                 f"{restored}, metrics {resumed} vs {metrics}, launches "
                                 f"{resume_counts} (expected {resume_expected})")
    return counts, resume_counts


def run_fraud(seed, card, pretrain_best):
    """The fraud phases on one synthetic transaction corpus, the conversion
    of ``pretrain_best`` whose ``fraud.pt`` the fraud CLI starts from, and
    the clustering CLI's fraud overlay from its ``recformer.pt``. Returns
    each phase's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = build_fraud_corpus(os.path.join(tmp, "txn"), seed)
        emit("fraud_corpus", seconds=time.perf_counter() - t0,
             cards={s: len(read_json(os.path.join(data, f"{s}.json")))
                    for s in ("train", "val", "test")},
             items=len(read_json(os.path.join(data, "smap.json"))))
        phases = {"fraud_step": run_fraud_step(seed, card, data)}
        run_fraud_vs_chunked(seed, data)
        conv = os.path.join(tmp, "converted")
        phases["convert_ckpt"] = run_convert_ckpt(seed, card, pretrain_best, conv)
        phases["fraud_cli"], phases["fraud_cli_resume"] = run_fraud_cli(
            seed, card, data, os.path.join(conv, "fraud.pt"))
        phases["cluster_fraud_overlay"] = run_cluster_fraud_overlay(
            os.path.join(tmp, "txn"), os.path.join(conv, "recformer.pt"), card)
    return phases


# ---------------------------------------------------------------------------
# the analytics path (cli.cluster) at the smallest paper category's size
# ---------------------------------------------------------------------------

def build_paper_corpus(root, seed):
    """``pipelines.synthetic --scale paper`` under ``root`` (5,300 items and
    11,000 users in ``finetune/``, 8,000 and 16,000 in ``pretrain/``);
    returns the ``finetune/`` directory."""
    from recformer_tpu_torch.pipelines import synthetic

    t0 = time.perf_counter()
    synthetic.main(["--out", root, "--scale", "paper", "--seed", str(7 + seed)])
    secs = time.perf_counter() - t0
    stats = read_json(os.path.join(root, "stats.json"))
    ok = stats["finetune_items"] == 5300 and stats["finetune_users"] == 11_000
    emit("synthetic_corpus", seconds=secs, items=stats["finetune_items"],
         users=stats["finetune_users"], pretrain_items=stats["pretrain_items"],
         pretrain_users=stats["pretrain_users"],
         popularity_baseline=stats["popularity_baseline"], ok=ok)
    if not ok:
        raise AssertionError(f"synthetic_corpus: {stats}")
    return os.path.join(root, "finetune")


def run_native(data, build_seconds, card):
    """The port's host library (``recformer_tpu_torch/native``) against its
    plain twins on the paper corpus: the epoch shuffle of the 11,000
    training histories for seeds 0-3 against the numpy twin, one epoch of
    batches of 64 packed by C++ and by the Python loop, and the 5,300-item
    tokenized table of the C++ tokenizer and packer against the Python
    ``encode_item`` path, array for array; the host ms of each."""
    from recformer_tpu_torch import native
    from recformer_tpu_torch.cli.common import make_tokenizer
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.item_table import ItemTable
    from recformer_tpu_torch.utils.io import load_finetune_artifacts

    train, _, _, meta, item2id, _ = load_finetune_artifacts(data)
    seqs = [train[u] for u in sorted(train)]
    rows, max_len = native.RaggedSequences(seqs), max(len(s) for s in seqs)
    shuffle_equal = all(np.array_equal(rows.epoch_order(True, s),
                                       native.shuffle_order_plain(rows.n, s)) for s in range(4))
    order = rows.epoch_order(True, 0)

    def epoch(pack):
        return [pack(order, start, 64, max_len) for start in range(0, rows.n, 64)]

    pack_equal = all(all(np.array_equal(a, b) for a, b in zip(x, y))
                     for x, y in zip(epoch(rows.pack), epoch(rows.pack_plain)))
    cfg = RecformerConfig.base()
    tok = make_tokenizer(cfg)

    def plain_table():
        return ItemTable.build(tok.tokenize_corpus(meta, item2id), cfg, tok.backend.pad_token_id)

    table, plain = tok.encode_corpus_table(meta, item2id), plain_table()
    table_equal = all(np.array_equal(a, plain.as_arrays()[k])
                      for k, a in table.as_arrays().items())
    timed = {
        "shuffle_order": lambda: rows.epoch_order(True, 1),
        "shuffle_order_plain": lambda: native.shuffle_order_plain(rows.n, 1),
        "pack_epoch": lambda: epoch(rows.pack),
        "pack_epoch_plain": lambda: epoch(rows.pack_plain),
        "corpus_table": lambda: tok.encode_corpus_table(meta, item2id),
        "corpus_table_plain": plain_table,
    }
    ok = shuffle_equal and pack_equal and table_equal
    emit("native", build_seconds=build_seconds, library=os.path.basename(native.library_path()),
         rows=rows.n, items=len(item2id), shuffle_seeds=[0, 1, 2, 3],
         shuffle_equal_numpy_twin=shuffle_equal, pack_equal_python_loop=pack_equal,
         table_equal_python_path=table_equal,
         host_ms={k: host_ms(fn, n=3, warmup=1) for k, fn in timed.items()}, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"native: shuffle {shuffle_equal}, pack {pack_equal}, "
                             f"table {table_equal}")


class _StageTimer(dict):
    """Wraps ``cli.cluster``'s stages (and the silhouette inside the sweep)
    and sums each one's host seconds, the device synchronised at its end;
    ``calls`` counts them."""

    STAGES = (("cli", "tokenize_corpus_cached", "tokenize"),
              ("cli", "encode_all_items", "catalog_encode"),
              ("cli", "extract_embeddings", "history_tower"),
              ("cli", "kmeans_sweep", "sweep"),
              ("clustering", "silhouette_score", "silhouette"),
              ("cli", "kmeans", "final_kmeans"),
              ("cli", "pca_project", "projection"),
              ("cli", "tsne_project", "projection"),
              ("cli", "umap_project", "projection"),
              ("cli", "save_cluster_plots", "plots"))

    def __enter__(self):
        from recformer_tpu_torch.cli import cluster
        from recformer_tpu_torch.utils import clustering

        self.calls = {}
        self.saved = []
        for where, fn_name, stage in self.STAGES:
            mod = cluster if where == "cli" else clustering
            real = getattr(mod, fn_name)
            self.saved.append((mod, fn_name, real))

            def timed(*a, _real=real, _stage=stage, **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                torch.cuda.synchronize()
                self[_stage] = self.get(_stage, 0.0) + time.perf_counter() - t0
                self.calls[_stage] = self.calls.get(_stage, 0) + 1
                return out

            setattr(mod, fn_name, timed)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, real in self.saved:
            setattr(mod, fn_name, real)


def cluster_forwards(data, batch_size=64) -> int:
    """Sequence-tower forwards of one ``cli.cluster`` run, by reading the
    code: the catalog in chunks of 256, every training row in batches."""
    items, users = (len(read_json(os.path.join(data, f))) for f in ("smap.json", "train.json"))
    return math.ceil(items / 256) + math.ceil(users / batch_size)


def run_cluster_cli(data, card):
    """``cli.cluster --model_size base --batch_size 64 --min_clusters 2
    --max_clusters 10 --projection pca`` on the paper corpus, nothing cut:
    the outputs written, the embeddings finite and (users, 768), the labels
    in [0, k), kernel 1 launched 12 x (ceil(items/256) + ceil(users/64))
    times, all on the tensor cores; the time of each stage, the tower's
    users/s and the peak memory. Then the same command again: a cache hit,
    no launch, and byte-equal ``cluster_labels.npy``, ``cluster_stats.json``
    and ``k_sweep.json``. Returns the launches of both runs and the output
    directory."""
    from recformer_tpu_torch.cli import cluster

    out = os.path.join(os.path.dirname(os.path.normpath(data)), "cluster_out")
    args = ["--data_path", data, "--model_size", "base", "--batch_size", "64",
            "--min_clusters", "2", "--max_clusters", "10", "--projection", "pca",
            "--device", "cuda", "--output_dir", out]
    n_users = len(read_json(os.path.join(data, "train.json")))
    fw = 12 * cluster_forwards(data)
    expected = {**{k: 0 for k in COUNTERS}, "band_attention_fwd": fw, "band_attention_fwd_tc": fw}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _StageTimer() as stages:
        t0 = time.perf_counter()
        stats = cluster.main(args)
        secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    emb = np.load(os.path.join(out, "sequence_embeddings.npy"))
    labels = np.load(os.path.join(out, "cluster_labels.npy"))
    sweep = read_json(os.path.join(out, "k_sweep.json"))
    k = sweep["optimal_k"]
    written = sorted(os.listdir(out))
    needed = ["cluster_centers.npy", "cluster_labels.npy", "cluster_stats.json", "k_sweep.json",
              "pca_2d.npy", "sequence_embeddings.npy", "top1_predictions.npy"]
    ok = (counts == expected and set(needed) <= set(written)
          and emb.shape == (n_users, 768) and bool(np.isfinite(emb).all())
          and labels.shape == (n_users,) and int(labels.min()) >= 0 and int(labels.max()) < k
          and len(stats) == k)
    emit("cluster_cli", users=n_users, items=len(read_json(os.path.join(data, "smap.json"))),
         seconds=secs, stage_seconds=dict(stages), stage_calls=stages.calls,
         tower_users_per_s=n_users / stages["history_tower"], peak_memory_gib=peak / 2 ** 30,
         optimal_k=k, sweep=sweep["sweep"], cluster_sizes={c: s["size"] for c, s in stats.items()},
         written=written, launches=counts, expected_launches=expected, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"cluster_cli: launches {counts} (expected {expected}), written "
                             f"{written}, embeddings {emb.shape}, labels {labels.shape} k {k}")

    def contents(name):
        with open(os.path.join(out, name), "rb") as f:
            return f.read()

    kept = {n: contents(n) for n in ("cluster_labels.npy", "cluster_stats.json", "k_sweep.json")}
    reset_counts()
    with _StageTimer() as again:
        t0 = time.perf_counter()
        cluster.main(args)
        secs = time.perf_counter() - t0
    rerun_counts = read_counts()
    equal = {n: contents(n) == b for n, b in kept.items()}
    ok = (all(equal.values()) and not any(rerun_counts.values())
          and "catalog_encode" not in again.calls and "history_tower" not in again.calls)
    emit("cluster_cli_cached", seconds=secs, stage_seconds=dict(again), byte_equal=equal,
         launches=rerun_counts, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"cluster_cli_cached: byte-equal {equal}, launches {rerun_counts}, "
                             f"stages {again.calls}")
    return counts, rerun_counts, out


def run_cluster_kmeans_vs_plain(out, card):
    """The card's Lloyd loop (float32) on ``cluster_cli``'s embeddings at its
    optimal k against the same loop on the CPU in float64, from the same
    k-means++ centres: labels agree on >= 99.9% of users, the inertia within
    1e-4 relative. Also reported: the inertia of one step on the unshifted
    embeddings from the final centres (the JAX step's float32 expansion)
    against its float64 value."""
    from recformer_tpu_torch.utils.clustering import _kmeans_pp_init, _lloyd_step, lloyd

    emb = np.load(os.path.join(out, "sequence_embeddings.npy"))
    k = read_json(os.path.join(out, "k_sweep.json"))["optimal_k"]
    init = _kmeans_pp_init(emb, k, np.random.default_rng(42))  # kmeans' default seed
    t0 = time.perf_counter()
    a32, c32, i32 = lloyd(torch.from_numpy(emb).cuda(), torch.from_numpy(init).cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a64, c64, i64 = lloyd(torch.from_numpy(emb).double(), torch.from_numpy(init).double())
    cpu_s = time.perf_counter() - t0
    agree = float((a32.cpu() == a64).double().mean())
    rel = abs(i32 - i64) / max(abs(i64), 1e-30)
    cli_labels = np.load(os.path.join(out, "cluster_labels.npy"))
    with torch.inference_mode():
        unshifted = float(_lloyd_step(torch.from_numpy(emb).cuda(), c64.float().cuda())[2])
        unshifted64 = float(_lloyd_step(torch.from_numpy(emb).double(), c64)[2])
    ok = agree >= 0.999 and rel <= 1e-4
    emit("cluster_kmeans_vs_plain", users=len(emb), k=k, label_agreement=agree,
         inertia_card_fp32=i32, inertia_cpu_fp64=i64, inertia_rel_err=rel,
         max_centre_abs_err=float((c32.cpu().double() - c64).abs().max()),
         unshifted_step_inertia_rel_err=abs(unshifted - unshifted64) / max(unshifted64, 1e-30),
         equals_cli_labels=bool(np.array_equal(a32.cpu().numpy(), cli_labels)),
         card_seconds=card_s, cpu_fp64_seconds=cpu_s, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"cluster_kmeans_vs_plain: agreement {agree}, inertia {i32} vs "
                             f"{i64} ({rel})")


def run_cluster_vs_chunked(seed, data):
    """The first two batches of 64 of the paper corpus's histories through
    the sequence tower in float32, through the attention kernels and through
    the plain chunked attention, from the same weights: the pooled outputs'
    cosine > 0.999 on every row."""
    from recformer_tpu_torch.cli.common import init_model_params, table_to_device
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.datasets import SequenceDataset
    from recformer_tpu_torch.data.device_pipeline import assemble_for_config
    from recformer_tpu_torch.data.item_table import ItemTable
    from recformer_tpu_torch.models.heads import RecformerForSeqRec, cosine_similarity

    train = read_json(os.path.join(data, "train.json"), as_int=True)
    cfg = RecformerConfig.base(dtype="float32")
    table = table_to_device(ItemTable.load(os.path.join(data, "preprocess",
                                                        "item_table_finetune.npz")), "cuda")
    ds = SequenceDataset(train, max_items=max(len(s) for s in train.values()))
    batches = [b for _, b in zip(range(2), ds.batches(64))]
    state = init_model_params(RecformerForSeqRec(cfg), cfg, "cuda", seed=seed).state_dict()

    def pooled(impl):
        c = cfg.replace(attention_impl=impl)
        model = RecformerForSeqRec(c).to("cuda").eval()
        model.load_state_dict(state)
        with torch.inference_mode():
            return torch.cat([model(assemble_for_config(
                table, torch.from_numpy(b.item_ids).cuda(), torch.from_numpy(b.seq_lens).cuda(),
                c)) for b in batches])

    kern, plain = pooled("pallas"), pooled("chunked")
    cos = cosine_similarity(kern, plain)
    worst = float(cos.min())
    ok = worst > 0.999
    emit("cluster_vs_chunked", batches=[64, 64], view=[64, cfg.max_token_num], dtype="float32",
         min_pooled_cosine=worst, max_abs_err=float((kern - plain).abs().max()), ok=ok)
    if not ok:
        raise AssertionError(f"cluster_vs_chunked: pooled cosine {worst}")


def fraud_labels_by_user(txn_root) -> dict:
    """User i of the fraud corpus's ``finetune_data/`` -> the fraud flag of
    the i-th card in sorted order (``transactional.build_all``'s finetune
    loop)."""
    from recformer_tpu_torch.pipelines import transactional as tr

    edges, labels = tr.make_amount_bins()
    train_rows = tr.read_transactions([os.path.join(txn_root, "txn_train_raw.csv")], edges, labels)
    test_rows = tr.read_transactions([os.path.join(txn_root, "txn_test_raw.csv")], edges, labels)
    encoder = tr.fit_signature_encoder(train_rows + test_rows)
    meta = tr.extract_metadata(train_rows + test_rows, encoder, None)
    cards = tr.extract_card_sequences(train_rows, encoder, meta)
    return {i: flag for i, (_, (_, flag)) in enumerate(sorted(cards.items()))}


def run_cluster_fraud_overlay(txn_root, recformer_pt, card):
    """``cli.cluster --n_clusters 4 --fraud_labels`` on the fraud corpus's
    ``finetune_data/`` from ``convert_ckpt``'s ``recformer.pt``, with
    ``--projection tsne`` and with ``--projection umap``: ``mean_fraud`` in
    every cluster's stats, kernel 1 launched as the code says. Returns the
    launches of both runs."""
    from recformer_tpu_torch.cli import cluster

    data = os.path.join(txn_root, "artifacts", "finetune_data")
    flags = os.path.join(txn_root, "fraud_labels.json")
    with open(flags, "w") as f:
        json.dump(fraud_labels_by_user(txn_root), f)
    n_users = len(read_json(os.path.join(data, "train.json")))
    fw = 12 * cluster_forwards(data)
    total = {k: 0 for k in COUNTERS}
    for projection in ("tsne", "umap"):
        out = os.path.join(txn_root, f"cluster_{projection}")
        reset_counts()
        with _StageTimer() as stages:
            t0 = time.perf_counter()
            cluster.main(["--data_path", data, "--model_size", "base", "--device", "cuda",
                          "--ckpt", recformer_pt, "--n_clusters", "4", "--fraud_labels", flags,
                          "--projection", projection, "--output_dir", out])
            secs = time.perf_counter() - t0
        counts = read_counts()
        stats = read_json(os.path.join(out, "cluster_stats.json"))
        proj = np.load(os.path.join(out, f"{projection}_2d.npy"))
        expected = {**{k: 0 for k in COUNTERS}, "band_attention_fwd": fw,
                    "band_attention_fwd_tc": fw}
        ok = (counts == expected and stats["k"] == 4
              and all("mean_fraud" in c for c in stats["clusters"].values())
              and proj.shape == (n_users, 2) and bool(np.isfinite(proj).all()))
        emit("cluster_fraud_overlay", projection=projection, users=n_users, seconds=secs,
             stage_seconds=dict(stages), clusters=stats["clusters"], launches=counts,
             expected_launches=expected, card=card, ok=ok)
        if not ok:
            raise AssertionError(f"cluster_fraud_overlay ({projection}): launches {counts} "
                                 f"(expected {expected}), stats {stats}, projection {proj.shape}")
        total = {k: total[k] + counts[k] for k in COUNTERS}
    return total


def run_analytics(seed, card, native_build_seconds):
    """The analytics phases on the paper-size synthetic corpus. Returns each
    main-path phase's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        data = build_paper_corpus(os.path.join(tmp, "synthetic"), seed)
        run_native(data, native_build_seconds, card)
        counts, cached, out = run_cluster_cli(data, card)
        run_cluster_kmeans_vs_plain(out, card)
        run_cluster_vs_chunked(seed, data)
    return {"cluster_cli": counts, "cluster_cli_cached": cached}


# ---------------------------------------------------------------------------
# activation recomputation, the pretrain CLI's host flags, the Amazon
# pipeline and the example
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "save_attention", "dots", "dots_attn")
REMAT_GATE = 1e-5  # each gradient's max|err| / max|ref| against no remat, bf16


def policy_config(cfg, policy):
    """``cfg`` under a remat policy (None: no remat)."""
    return cfg if policy is None else cfg.replace(remat=True, remat_policy=policy)


def model_on_card(cls, cfg, state):
    """``cls(cfg)`` built on the card with the parameters ``state``."""
    with torch.device("cuda"):
        model = cls(cfg)
    model.load_state_dict(state)
    return model.eval()


def pretrain_grads(cfg, state, world, seed):
    """The gradients of one base pretraining loss with dropout, drawn from
    ``StepRNG(seed)``, and where its generators end."""
    from recformer_tpu_torch.data.device_pipeline import make_pretrain_batch
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.steps import pretrain_loss
    from recformer_tpu_torch.utils.rng import StepRNG

    model = model_on_card(RecformerForPretraining, cfg, state)
    rng = StepRNG(seed, "cuda")
    batch_a, batch_b = make_pretrain_batch(rng.device, *world, cfg)
    loss, _ = pretrain_loss(cfg, model(batch_a, batch_b, deterministic=False, rng=rng),
                            batch_a, batch_b)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return grads, (rng.host.get_state(), rng.device.get_state())


def worst_rel_err(grads, ref) -> float:
    """The largest max|err| / max|ref| over the gradient tensors (``ref`` on
    the CPU)."""
    worst = 0.0
    for n, r in ref.items():
        r = r.to(grads[n].device)
        worst = max(worst, float((grads[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)))
    return worst


def redraw(seed):
    """A stand-in for ``utils.rng.replay`` that gives the recomputation fresh
    generators (seeded ``seed``) instead of the first run's: the control
    that the gradient gate must fail."""
    from recformer_tpu_torch.utils.rng import replay

    def run(state, fn, *args):
        fresh = [(g, torch.Generator(g.device).manual_seed(seed).get_state()) for g, _ in state]
        return replay(fresh, fn, *args)

    return run


def run_remat_step(seed, card, phase="remat_step", policies=REMAT_POLICIES, **flags):
    """The base pretraining step at batch 8 with dropout 0.1 under
    ``RecformerConfig.base(**flags)``, without remat and under each policy,
    from one set of weights: kernel 1 and 2 launches a step (2 timed steps
    after one warm-up), the peak memory of those steps, host-timed steps/s,
    one profiled step; the gradients of one loss at one ``StepRNG`` seed held
    to no remat's (each tensor within ``REMAT_GATE``), with both generators
    ending where no remat's end. The control, ``full`` with a recomputation
    that redraws, must fail the gate. Returns the launches of the timed
    steps of every policy, summed."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models import encoder
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_pretrain_step
    from recformer_tpu_torch.utils.rng import StepRNG

    base = RecformerConfig.base(**flags)
    assert base.attention_probs_dropout_prob == 0.1 and base.hidden_dropout_prob == 0.1
    B, n = 8, 2
    world = pretrain_world(base, seed, batch=B)
    state = init_model_params(RecformerForPretraining(base), base, device="cpu",
                              seed=seed).state_dict()
    ref, ref_end = pretrain_grads(base, state, world, seed + 1)
    ref = {k: v.cpu() for k, v in ref.items()}
    rows, total = {}, {k: 0 for k in COUNTERS}
    for policy in (None,) + tuple(policies):
        cfg = policy_config(base, policy)
        if policy is None:
            err, same_end = 0.0, True
        else:
            grads, end = pretrain_grads(cfg, state, world, seed + 1)
            err = worst_rel_err(grads, ref)
            same_end = all(torch.equal(a, b) for a, b in zip(end, ref_end))
            del grads
        torch.cuda.empty_cache()
        model = model_on_card(RecformerForPretraining, cfg, state)
        opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=1000, total_steps=10_000)
        step = make_pretrain_step(cfg, model, opt)
        rng = StepRNG(seed, "cuda")
        step(rng, *world)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            step(rng, *world)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_call(lambda: step(rng, *world))
        expected = launches_per_step(cfg)
        per_step = {k: counts[k] / n for k in ("band_attention_fwd", "band_attention_bwd",
                                               "band_attention_fwd_tc", "band_attention_bwd_tc")}
        ok = (all(counts[k] == expected[k] * n for k in COUNTERS) and err <= REMAT_GATE
              and same_end)
        rows[policy or "none"] = dict(
            launches_per_step=per_step, expected_per_step={k: expected[k] for k in per_step},
            peak_memory_gib=peak, steps_per_s=n / secs,
            device_kernels=prof["device_kernels"], device_busy_ms=prof["device_busy_ms"],
            profiled_wall_ms=prof["wall_ms"], max_rel_grad_err=err, generators_end_equal=same_end,
            ok=ok)
        total = {k: total[k] + counts[k] for k in COUNTERS}
        del model, opt, step
        torch.cuda.empty_cache()

    # the control: a recomputation from fresh generators
    real = encoder.replay
    encoder.replay = redraw(seed + 99)
    try:
        grads, end = pretrain_grads(policy_config(base, "full"), state, world, seed + 1)
    finally:
        encoder.replay = real
    control_err = worst_rel_err(grads, ref)
    control_end = all(torch.equal(a, b) for a, b in zip(end, ref_end))
    del grads
    torch.cuda.empty_cache()
    peak = {p: r["peak_memory_gib"] for p, r in rows.items()}
    order = [("full", "save_attention", "<"), ("save_attention", "dots_attn", "<="),
             ("dots_attn", "none", "<="), ("full", "dots", "<"), ("dots", "dots_attn", "<=")]
    order_ok = all((peak[a] < peak[b]) if op == "<" else (peak[a] <= peak[b])
                   for a, b, op in order if a in peak and b in peak)
    ok = all(r["ok"] for r in rows.values()) and control_err > REMAT_GATE and order_ok
    emit(phase, config=f"RecformerConfig.base({', '.join(f'{k}={v!r}' for k, v in flags.items())})",
         batch=B, steps=n, gate=REMAT_GATE, policies=rows,
         control={"recompute": "fresh generators", "max_rel_grad_err": control_err,
                  "generators_end_equal": control_end, "fails_gate": control_err > REMAT_GATE},
         peak_order_ok=order_ok, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: {rows}, control {control_err}, peak order {peak}")
    return total


def run_remat_finetune_step(seed, card, policies=("save_attention", "full")):
    """The base finetune step (batch 16, 1,000 sampled negatives,
    accumulation 8, dropout 0.1) under each remat policy, from one set of
    weights: kernel 1 and 2 launches a step over 3 steps after a warm-up, and
    their peak memory. Returns the launches, summed."""
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForSeqRec
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_finetune_step

    base = RecformerConfig.base(finetune_negative_sample_size=1000)
    B, n = 16, 3
    table, item_ids, seq_lens, catalog = finetune_world(base, seed, batch=B)
    state = init_model_params(RecformerForSeqRec(base), base, device="cpu",
                              seed=seed).state_dict()
    rows, total = {}, {k: 0 for k in COUNTERS}
    for policy in policies:
        cfg = policy_config(base, policy)
        model = model_on_card(RecformerForSeqRec, cfg, state)
        opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=100, total_steps=10_000,
                               grad_accum_steps=8)
        step = make_finetune_step(cfg, model, opt)
        step(seed, table, item_ids, seq_lens, catalog)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        losses = [float(step(seed, table, item_ids, seq_lens, catalog)["loss"]) for _ in range(n)]
        secs = time.perf_counter() - t0
        counts = read_counts()
        expected = finetune_launches_per_step(cfg)
        rows[policy] = dict(
            launches_per_step={k: counts[k] / n for k in ("band_attention_fwd",
                                                          "band_attention_bwd")},
            expected_per_step={k: expected[k] for k in ("band_attention_fwd",
                                                        "band_attention_bwd")},
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30, steps_per_s=n / secs,
            ok=(all(counts[k] == expected[k] * n for k in COUNTERS)
                and all(math.isfinite(x) for x in losses)))
        total = {k: total[k] + counts[k] for k in COUNTERS}
        del model, opt, step
        torch.cuda.empty_cache()
    ok = all(r["ok"] for r in rows.values())
    emit("remat_finetune_step", batch=B, negatives=1000, steps=n, policies=rows, card=card,
         ok=ok)
    if not ok:
        raise AssertionError(f"remat_finetune_step: {rows}")
    return total


AMAZON_WORDS = ("steel", "bolt", "nut", "gear", "led", "cap", "fan", "oak", "tin", "zinc",
                "valve", "pipe", "clamp", "sensor", "meter", "probe", "glove", "tape")


def write_amazon_dump(raw, category, n_items, n_users, reviews, seed):
    """A synthetic raw dump of one category in the Amazon v2 format
    (``<category>_metadata.jsonl.gz``, ``<category>_reviews.jsonl.gz``):
    ``n_items`` items, 1% of them without a title, and ``n_users`` users
    with ``reviews[0]`` to ``reviews[1] - 1`` reviews each, at popularity-
    skewed items."""
    import gzip

    rng = np.random.default_rng(seed)
    words = np.array(AMAZON_WORDS)
    with gzip.open(os.path.join(raw, f"{category}_metadata.jsonl.gz"), "wt") as f:
        for i in range(n_items):
            row = {"asin": f"{category[:3]}{i:06d}", "brand": f"brand{i % 97}",
                   "category": [category, f"sub{i % 13}"]}
            if rng.random() >= 0.01:
                row["title"] = " ".join(rng.choice(words, 4))
            f.write(json.dumps(row) + "\n")
    popularity = 1.0 / np.arange(1, n_items + 1) ** 0.8
    popularity /= popularity.sum()
    counts = rng.integers(*reviews, size=n_users)
    items = rng.choice(n_items, size=int(counts.sum()), p=popularity)
    times = rng.integers(1_300_000_000, 1_600_000_000, size=items.size)
    users = np.repeat(np.arange(n_users), counts)
    with gzip.open(os.path.join(raw, f"{category}_reviews.jsonl.gz"), "wt") as f:
        for u, i, t in zip(users.tolist(), items.tolist(), times.tolist()):
            f.write(json.dumps({"reviewerID": f"U{u:06d}", "asin": f"{category[:3]}{i:06d}",
                                "unixReviewTime": t}) + "\n")
    return int(counts.sum())


def run_amazon_pipeline(root, seed, card):
    """``pipelines.amazon`` on a synthetic raw dump at the smallest paper
    category's scale (5,300 items, 11,000 users of 5-14 reviews) plus a
    second category (1,000 items, 2,000 users) as the pretrain corpus's dev
    split: ``build_pretrain_corpus`` and ``build_finetune_category`` (the
    seeded 1-in-5 user subsample). Returns (pretrain dir, finetune dir)."""
    from recformer_tpu_torch.pipelines import amazon

    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    cats = ("Industrial_and_Scientific", "Musical_Instruments")
    t0 = time.perf_counter()
    n_reviews = [write_amazon_dump(raw, cats[0], 5300, 11_000, (5, 15), seed),
                 write_amazon_dump(raw, cats[1], 1000, 2000, (5, 10), seed + 1)]
    dump_secs = time.perf_counter() - t0
    pre, ft = os.path.join(root, "pretrain"), os.path.join(root, "finetune")
    t0 = time.perf_counter()
    amazon.build_pretrain_corpus(cats, raw, pre)
    pre_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    amazon.build_finetune_category(os.path.join(raw, f"{cats[0]}_reviews.jsonl.gz"),
                                   os.path.join(raw, f"{cats[0]}_metadata.jsonl.gz"), ft)
    ft_secs = time.perf_counter() - t0
    size = {f"pretrain_{k}": len(read_json(os.path.join(pre, f"{k}.json")))
            for k in ("train", "dev", "smap", "meta_data")}
    size.update({f"finetune_{k}": len(read_json(os.path.join(ft, f"{k}.json")))
                 for k in ("train", "val", "test", "umap", "smap", "meta_data")})
    ok = (size["pretrain_train"] == 11_000 and size["pretrain_dev"] == 2000
          and 4000 < size["pretrain_smap"] <= 6300
          and 1800 < size["finetune_umap"] < 2600
          and size["finetune_train"] == size["finetune_val"] == size["finetune_umap"])
    emit("amazon_pipeline", categories=list(cats), reviews=n_reviews, dump_seconds=dump_secs,
         build_pretrain_corpus_seconds=pre_secs, build_finetune_category_seconds=ft_secs,
         **size, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"amazon_pipeline: {size}")
    return pre, ft


def trimmed_copy(src, dst, keep):
    """``src``'s artifacts in ``dst`` with every split's first ``keep``
    entries (lists or dicts) and the whole item metadata."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if not name.endswith(".json"):
            continue
        obj = read_json(os.path.join(src, name))
        if name in keep:
            obj = obj[:keep[name]] if isinstance(obj, list) else dict(
                list(obj.items())[:keep[name]])
        with open(os.path.join(dst, name), "w") as f:
            json.dump(obj, f)
    return dst


def run_pretrain_cli_host_flags(pre, seed, card):
    """``cli.pretrain --model_size base --remat --remat_policy dots_attn
    --steps_per_call 2 --log_dir --mirror_file --profile_dir`` on the Amazon
    pretrain corpus trimmed to 144 histories (18 steps at batch 8) and 16 dev
    histories, validating every 8 steps: the log rows equal the mirror's, at
    the steps the CLI's interval crossings give; the trace names kernel 1's
    and kernel 2's device kernels; launches as the code says."""
    from recformer_tpu_torch.cli import pretrain
    from recformer_tpu_torch.config import RecformerConfig

    with tempfile.TemporaryDirectory() as tmp:
        data = trimmed_copy(pre, os.path.join(tmp, "data"), {"train.json": 144, "dev.json": 16})
        out = os.path.join(tmp, "out")
        logs, mirror, prof = (os.path.join(tmp, n) for n in ("logs", "mirror.jsonl", "prof"))
        reset_counts()
        t0 = time.perf_counter()
        res = pretrain.main(["--data_path", data, "--output_dir", out, "--model_size", "base",
                             "--num_train_epochs", "1", "--batch_size", "8",
                             "--gradient_accumulation_steps", "2", "--warmup_steps", "1",
                             "--valid_step_interval", "8", "--save_top_k", "1",
                             "--seed", str(seed), "--device", "cuda", "--remat",
                             "--remat_policy", "dots_attn", "--steps_per_call", "2",
                             "--log_dir", logs, "--mirror_file", mirror,
                             "--profile_dir", prof])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        cfg = RecformerConfig.load(os.path.join(out, "config.json"))
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(mirror) as f:
            mirrored = [json.loads(line) for line in f]
        traces = os.listdir(prof)
        names = set()
        if len(traces) == 1:
            with open(os.path.join(prof, traces[0])) as f:
                names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "kernel"}
    attention = sorted(n for n in names if "band_" in n)
    per_step = launches_per_step(cfg)
    # each step's forward and backward; three validations (steps 8 and 16,
    # the epoch's end) of two dev batches, each the two towers' forward
    expected = {k: v * res["steps"] for k, v in per_step.items()}
    for k in ("band_attention_fwd", "band_attention_fwd_tc"):
        expected[k] += 3 * 2 * per_step[k] // forward_runs(cfg)
    ok = (res["steps"] == 18 and cfg.remat and cfg.remat_policy == "dots_attn"
          and rows == mirrored and [(r["step"], sorted(r)) for r in rows]
          == [(8, ["dev_accuracy", "step", "time"]), (16, ["dev_accuracy", "step", "time"])]
          and any("band_attention_fwd" in n for n in attention)
          and any("band_bwd" in n for n in attention) and counts == expected)
    emit("pretrain_cli_host_flags", **res, seconds=secs, rows=rows,
         mirror_rows_equal=rows == mirrored, traces=traces, trace_kernels=len(names),
         trace_attention_kernels=attention, launches=counts, expected_launches=expected,
         card=card, ok=ok)
    if not ok:
        raise AssertionError(f"pretrain_cli_host_flags: {res}, rows {rows}, mirror "
                             f"{mirrored}, traces {traces}, attention kernels {attention}, "
                             f"launches {counts} (expected {expected})")
    return counts


def run_finetune_cli_remat(ft, seed, card):
    """``cli.finetune --model_size base --remat --remat_policy save_attention``
    on the Amazon category trimmed to 128 users (its whole catalog), one
    epoch a stage at batch 16: finite test metrics, kernel 1 and 2 launches
    as the code says (kernel 1 not again in the backward)."""
    from recformer_tpu_torch.cli import finetune

    n_users, bs, enc_bs, eval_bs, epochs, layers = 128, 16, 256, 32, 1, 12
    with tempfile.TemporaryDirectory() as tmp:
        data = trimmed_copy(ft, os.path.join(tmp, "data"),
                            {"train.json": n_users, "val.json": n_users, "test.json": n_users})
        n_items = len(read_json(os.path.join(data, "smap.json")))
        reset_counts()
        t0 = time.perf_counter()
        metrics = finetune.main(["--data_path", data, "--output_dir", os.path.join(tmp, "out"),
                                 "--model_size", "base", "--device", "cuda",
                                 "--num_train_epochs", str(epochs), "--verbose", "1",
                                 "--batch_size", str(bs), "--gradient_accumulation_steps", "2",
                                 "--seed", str(seed), "--remat",
                                 "--remat_policy", "save_attention"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
    steps = epochs * (n_users // bs)
    forwards = ((1 + epochs) * math.ceil(n_items / enc_bs) + 2 * steps
                + (2 * epochs + 1) * math.ceil(n_users / eval_bs))
    expected = {**{k: 0 for k in COUNTERS}, "band_attention_fwd": layers * forwards,
                "band_attention_fwd_tc": layers * forwards,
                "band_attention_bwd": layers * 2 * steps,
                "band_attention_bwd_tc": layers * 2 * steps}
    ok = (counts == expected and bool(metrics)
          and all(math.isfinite(v) for v in metrics.values()))
    emit("finetune_cli_remat", items=n_items, users=n_users, epochs_per_stage=epochs,
         train_steps=2 * steps, seconds=secs, test_metrics=metrics, launches=counts,
         expected_launches=expected, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"finetune_cli_remat: metrics {metrics}, launches {counts} "
                             f"(expected {expected})")
    return counts


def run_example(card):
    """``python -m recformer_tpu_torch.examples.synthetic_end_to_end DIR
    --device cuda`` (in this process): its six stages at its own sizes end
    with ``ALL STAGES COMPLETE``. Returns its launches."""
    import contextlib
    import io

    from recformer_tpu_torch.examples import synthetic_end_to_end

    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = synthetic_end_to_end.main([tmp, "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
    lines = log.getvalue().strip().splitlines()
    ok = (bool(lines) and lines[-1] == "ALL STAGES COMPLETE"
          and counts["band_attention_fwd"] > 0 and counts["band_attention_bwd"] > 0
          and all(math.isfinite(v) for v in res["finetune"].values()))
    emit("example", seconds=secs, last_line=lines[-1] if lines else None,
         finetune_test_metrics=res["finetune"], launches=counts, card=card, ok=ok)
    if not ok:
        raise AssertionError(f"example: last lines {lines[-3:]}, launches {counts}")
    return counts


def run_remat_and_host(seed, card):
    """The remat phases, then the Amazon pipeline and the CLIs on its
    output, then the example. Returns each main-path phase's launches."""
    phases = {"remat_step": run_remat_step(seed, card)}
    phases["remat_step_ln_kernels"] = run_remat_step(
        seed, card, phase="remat_step_ln_kernels", policies=("full", "save_attention"),
        embed_ln_impl="pallas", ln_impl="pallas_bwd")
    phases["remat_finetune_step"] = run_remat_finetune_step(seed, card)
    with tempfile.TemporaryDirectory() as tmp:
        pre, ft = run_amazon_pipeline(tmp, seed, card)
        phases["pretrain_cli_host_flags"] = run_pretrain_cli_host_flags(pre, seed, card)
        phases["finetune_cli_remat"] = run_finetune_cli_remat(ft, seed, card)
    phases["example"] = run_example(card)
    return phases


# ---------------------------------------------------------------------------
# data and tensor parallelism over torch.distributed: worlds of ranks on the
# one card (``gloo`` with CUDA tensors: NCCL refuses two ranks on one device)
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 300  # every process group's timeout in the worlds below


def spawn_world(nproc: int, rank_args, timeout: float):
    """``python -m torch.distributed.run --standalone`` over ``nproc`` ranks
    of this script in rank mode with ``rank_args``; returns each rank's
    results and the world's output. A world that fails or outlives
    ``timeout`` is killed whole and raises."""
    import subprocess

    out_dir = tempfile.mkdtemp(prefix="world_")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), os.path.abspath(__file__), "--rank-out", out_dir, *rank_args]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"world of {nproc} ({rank_args}) timed out:\n{out[-8000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"world of {nproc} ({rank_args}) exited {proc.returncode}:\n"
                             f"{out[-8000:]}")
    results = []
    for r in range(nproc):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    return results, out


def digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy()).hexdigest()


def add_counts(per_rank) -> dict:
    return {k: sum(r[k] for r in per_rank) for k in COUNTERS}


def rank_dist_check(mesh) -> dict:
    """Each collective of ``parallel/collectives.py`` on CUDA tensors against
    local arithmetic, bit for bit (sums of two terms are exact in any order)."""
    from recformer_tpu_torch.parallel import collectives as C

    g, n, r = mesh.data_group, mesh.n_data, mesh.data_rank

    def x_of(k):
        return (torch.arange(12, dtype=torch.float32, device="cuda").view(3, 4) + 100.0 * k) / 7

    def w_of(k):
        return torch.linspace(-1, 1, 12 * n, device="cuda").view(3 * n, 4) * (k + 1)

    whole = torch.cat([x_of(k) for k in range(n)])
    rows = slice(3 * r, 3 * r + 3)
    checks = {}
    x = x_of(r).requires_grad_()
    y = C.all_gather(x, g)
    (y * w_of(r)).sum().backward()
    checks["all_gather"] = torch.equal(y, whole)
    checks["all_gather_backward_psum_scatter"] = torch.equal(
        x.grad, sum(w_of(k) for k in range(n))[rows])
    x = x_of(r).requires_grad_()
    y = C.all_gather_local(x, g)
    (y * w_of(r)).sum().backward()
    checks["all_gather_local"] = torch.equal(y, whole) and torch.equal(x.grad, w_of(r)[rows])
    x = x_of(r).requires_grad_()
    y = C.psum(x, g)
    (3 * y).sum().backward()
    checks["psum"] = (torch.equal(y, sum(x_of(k) for k in range(n)))
                      and torch.equal(x.grad, torch.full_like(x, 3.0)))
    checks["pmean"] = torch.equal(C.pmean(x_of(r), g), sum(x_of(k) for k in range(n)) / n)
    x = x_of(r).requires_grad_()
    y = C.copy_to(x, g)
    (y * w_of(r)[:3]).sum().backward()
    checks["copy_to"] = (torch.equal(y, x_of(r))
                         and torch.equal(x.grad, sum(w_of(k)[:3] for k in range(n))))
    checks["pmax"] = torch.equal(C.pmax(x_of(r), g), x_of(n - 1))
    checks["broadcast"] = torch.equal(C.broadcast(x_of(r), 1, g), x_of(1))
    ts = [x_of(r), torch.full((5,), r + 1, dtype=torch.int64, device="cuda")]
    C.all_reduce_(ts, g)
    checks["all_reduce_coalesced"] = (
        torch.equal(ts[0], sum(x_of(k) for k in range(n)))
        and torch.equal(ts[1], torch.full_like(ts[1], n * (n + 1) // 2)))
    return dict(checks=checks, backend=mesh.backend)


_SEEDED = {}


def seeded_model(cls, cfg, seed):
    """``cls(cfg)`` on the card with the weights ``init_model_params`` gives
    it from ``seed`` (drawn once per class and seed in this process, then
    copied: every base configuration has the same parameters)."""
    from recformer_tpu_torch.cli.common import init_model_params

    key = (cls.__name__, seed)
    if key not in _SEEDED:
        _SEEDED[key] = init_model_params(cls(cfg), cfg, device="cpu", seed=seed).state_dict()
    return model_on_card(cls, cfg, _SEEDED[key])


def rank_train(cfg, mesh, seed, batch, warmup, steps, zero=False, lr=5e-5, fixed_seed=None,
               make=None):
    """A model from ``seed`` and ``steps`` timed steps of ``make_pretrain_step``
    (or of ``make(cfg, model, optimizer, mesh)``: the sequence- and
    pipeline-parallel steps) over ``mesh`` (after ``warmup``): launch counts
    and peak memory of this rank, losses, steps/s. ``fixed_seed``: the same
    draws every step."""
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.tensor import shard_model_tp
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_pretrain_step
    from recformer_tpu_torch.utils.rng import StepRNG, fold_in

    table, ids, lens = pretrain_world(cfg, seed, batch=batch)
    model = seeded_model(RecformerForPretraining, cfg, seed)
    if mesh.tensor_parallel:
        shard_model_tp(model, mesh)
    opt = create_optimizer(model, learning_rate=lr,
                           warmup_steps=1000 if fixed_seed is None else 2,
                           total_steps=10_000, mesh=mesh, zero=zero)
    step = (make or make_pretrain_step)(cfg, model, opt, mesh)

    def one():
        s = fixed_seed if fixed_seed is not None else fold_in(seed, opt.micro_steps)
        return step(StepRNG(s, "cuda"), table, ids, lens)

    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = [one()["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    out = dict(steps=steps, seconds=secs, steps_per_s=steps / secs,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches_per_step={k: counts[k] / steps for k in COUNTERS}, counts=counts,
               losses=[float(x) for x in losses], optimizer_state_bytes=opt.state_bytes())
    out["backend"] = mesh.backend
    return out, model, one


_ONE_RANK = {}


class _NoUpdate:
    """An optimizer that takes no step: the gates read the gradients."""

    def step(self):
        pass


def model_axis_step(kind):
    """``make(cfg, model, optimizer, mesh)`` of the sequence-parallel
    (``'sp'``) or pipeline-parallel (``'pp'``, 2 microbatches) step."""
    from recformer_tpu_torch.parallel.pipeline import make_pipeline_pretrain_step
    from recformer_tpu_torch.parallel.sequence import make_sp_pretrain_step

    if kind == "sp":
        return make_sp_pretrain_step
    return lambda cfg, model, opt, mesh: make_pipeline_pretrain_step(cfg, model, opt, mesh, 2)


SP_FLAGS = dict(attention_impl="sequence_parallel", global_kv_mode="full")
PP_FLAGS = dict(scan_layers=True)


def rank_grad_gate(mesh, seed, tp_cfg=None, kind=None) -> dict:
    """One deterministic float32 loss and backward of a base model over the
    mesh (this rank's rows of a global batch of 8; tensor-parallel when
    ``tp_cfg`` is given: the gradients gathered whole; the sequence- or
    pipeline-parallel step's backward when ``kind`` is ``'sp'`` or ``'pp'``:
    the gradients whole on every rank) against the one-rank loss and
    backward on the whole batch, on rank 0: grad_stats."""
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import make_pretrain_batch
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.tensor import gather_state_dict_tp, shard_model_tp
    from recformer_tpu_torch.training.steps import pretrain_backward, pretrain_loss, take_rows
    from recformer_tpu_torch.utils.rng import StepRNG

    cfg = RecformerConfig.base().replace(dtype="float32", hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0)
    pcfg = cfg if tp_cfg is None else tp_cfg(cfg)
    if kind is not None:
        pcfg = cfg.replace(**(SP_FLAGS if kind == "sp" else PP_FLAGS))
    table, ids, lens = pretrain_world(cfg, seed + 7)
    ba, bb = make_pretrain_batch(torch.Generator(device="cuda").manual_seed(seed), table, ids,
                                 lens, cfg)
    model = seeded_model(RecformerForPretraining, pcfg, seed)
    tp = mesh.tensor_parallel
    if tp:
        shard_model_tp(model, mesh)
    if kind is None:
        metrics = pretrain_backward(pcfg, model, take_rows(ba, mesh), take_rows(bb, mesh),
                                    StepRNG(0, "cuda"), mesh)
    else:
        step = model_axis_step(kind)(pcfg, model, _NoUpdate(), mesh)
        metrics = step.backward(take_rows(ba, mesh), take_rows(bb, mesh), StepRNG(0, "cuda"))
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    if tp:
        grads = gather_state_dict_tp(grads, mesh)
    del model
    torch.cuda.empty_cache()
    if mesh.rank != 0:
        return {}
    if seed not in _ONE_RANK:  # the same weights and batch for every gate of a seed
        ref = seeded_model(RecformerForPretraining, cfg, seed)
        loss, _ = pretrain_loss(cfg, ref(ba, bb), ba, bb)
        loss.backward()
        _ONE_RANK[seed] = ({n: p.grad.float() for n, p in ref.named_parameters()},
                           float(loss.detach()))
        del ref
    ref_grads, ref_loss = _ONE_RANK[seed]
    cos, share, rel = grad_stats(grads, dict(ref_grads))
    return dict(cos=cos, share=share, rel=rel, loss=float(metrics["loss"]),
                loss_one_rank=ref_loss)


def rank_zero_bit_equal(mesh, seed, steps=3) -> dict:
    """Plain data-parallel AdamW and ZeRO from one set of weights, handed the
    same reduced gradients each step (one backward a step, shared): the
    parameters after each update bit-equal; each one's AdamW state bytes,
    and the share that the ZeRO rule predicts (whole moments for leaves it
    leaves alone); the host-timed update of each, the backward's launches,
    the losses and the peak (both models and optimizers held)."""
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.device_pipeline import make_pretrain_batch
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.parallel.mesh import zero_shardable
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import pretrain_backward, take_rows
    from recformer_tpu_torch.utils.rng import StepRNG, fold_in

    cfg = RecformerConfig.base()
    table, ids, lens = pretrain_world(cfg, seed, batch=8 * mesh.n_data)
    models = [seeded_model(RecformerForPretraining, cfg, seed) for _ in range(2)]
    opts = [create_optimizer(m, learning_rate=5e-5, warmup_steps=1, total_steps=10_000,
                             weight_decay=0.01, mesh=mesh, zero=z)
            for m, z in zip(models, (False, True))]
    equal, losses, update_s = [], [], {"plain": 0.0, "zero": 0.0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(steps):
        rng = StepRNG(fold_in(seed, i), "cuda")
        ba, bb = make_pretrain_batch(rng.device, table, ids, lens, cfg)
        metrics = pretrain_backward(cfg, models[0], take_rows(ba, mesh), take_rows(bb, mesh),
                                    StepRNG(fold_in(rng.seed, mesh.data_rank), "cuda"), mesh)
        losses.append(float(metrics["loss"]))
        for p, q in zip(models[0].parameters(), models[1].parameters()):
            q.grad = p.grad.clone()
        for name, o in zip(update_s, opts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o.step()
            torch.cuda.synchronize()
            update_s[name] += time.perf_counter() - t0
        equal.append(all(torch.equal(p, q) for p, q in zip(models[0].parameters(),
                                                            models[1].parameters())))
    counts = read_counts()
    params = list(models[0].parameters())
    total = sum(p.numel() for p in params)
    rule = sum(p.numel() / (mesh.n_data if zero_shardable(p, mesh.n_data) else 1)
               for p in params) / total
    out = dict(steps=steps, steps_per_s=None, losses=losses, counts=counts,
               launches_per_step={k: counts[k] / steps for k in COUNTERS},
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               update_ms={k: 1e3 * v / steps for k, v in update_s.items()},
               bit_equal=all(equal), bit_equal_per_update=equal,
               plain_optimizer_state_bytes=opts[0].state_bytes(),
               zero_optimizer_state_bytes=opts[1].state_bytes(), rule_share=rule,
               unsharded=[n for n, p in models[0].named_parameters()
                          if not zero_shardable(p, mesh.n_data)][:8])
    del models, opts
    torch.cuda.empty_cache()
    return out


# the attention kernels' device names (band_attention_{fwd,bwd}.cu)
BAND_KERNEL_NAME = re.compile(r"\b(band_\w*kernel)\b")
SP_SHAPE = (16, 1024, 12, 64)  # the fused history view (B, L, H, D) at window 64
SP_GRADS = ("dq", "dk", "dv", "dq_g", "dk_g", "dv_g")


def rank_sp_attention_check(mesh, seed) -> dict:
    """The sequence-parallel op over the mesh's seq group at the history
    view's shape, window 64, rows padded to 1,024 down to 341 tokens, the CLS
    global on shard 0, against ``chunked_attention`` on the whole inputs on
    this rank, float32 and bf16: the forward's max abs error and each
    gradient's max|err| / max|ref| for one random cotangent."""
    from recformer_tpu_torch.ops.attention import chunked_attention
    from recformer_tpu_torch.parallel.sequence import make_sequence_parallel_attention

    B, L, H, D = SP_SHAPE
    window = 64
    run = make_sequence_parallel_attention(mesh, window)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xs = [(torch.randn(B, L, H, D, generator=gen, device="cuda") * 0.5).to(dtype)
              for _ in range(6)]
        lengths = torch.linspace(L, L // 3, B, device="cuda").long()
        mask = (torch.arange(L, device="cuda")[None] < lengths[:, None]).to(torch.int32)
        mask[:, 0] = 2
        cot = torch.randn(B, L, H, D, generator=gen, device="cuda") * 0.5
        got = []
        for fn in (lambda *a: run(*a, mask), lambda *a: chunked_attention(*a, mask, window)):
            leaves = [x.clone().requires_grad_() for x in xs]
            y = fn(*leaves)
            (y.float() * cot).sum().backward()
            got.append((y.detach(), [x.grad for x in leaves]))
        (y, grads), (y_ref, grads_ref) = got
        out[str(dtype).removeprefix("torch.")] = dict(
            max_abs_err=float((y.float() - y_ref.float()).abs().max()),
            rel_err={n: rel_err(a, b) for n, a, b in zip(SP_GRADS, grads, grads_ref)},
            finite=bool(torch.isfinite(y.float()).all()) and all(
                bool(torch.isfinite(g.float()).all()) for g in grads))
        del got, xs, y, grads, y_ref, grads_ref
        torch.cuda.empty_cache()
    return out


def profiled_step(fn) -> dict:
    """The device kernels of one more call of ``fn`` (``torch.profiler``):
    their count, the attention kernels' device kernels by name, the busy ms
    and the profiled wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.events())
    band = [m.group(1) for m in (BAND_KERNEL_NAME.search(e.name) for e in kernels) if m]
    return dict(device_kernels=len(kernels), device_busy_ms=busy_ms(kernels),
                profiled_wall_ms=wall, band_kernels={b: band.count(b) for b in sorted(set(band))})


def rank_model_axis_step(mesh, seed, kind) -> dict:
    """sp_step / pp_step and their data-parallel worlds: base width, batch 8
    a data rank, dropout 0.1, 1 warm-up + 2 timed steps of the sequence-
    (``kind='sp'``) or pipeline-parallel (``'pp'``, 2 microbatches) step
    (launches a step, peak GiB, steps/s), the device kernels of one more
    step, then its float32 gradient gate against the one-rank step."""
    from recformer_tpu_torch.config import RecformerConfig

    t0 = time.perf_counter()
    cfg = RecformerConfig.base(**(SP_FLAGS if kind == "sp" else PP_FLAGS))
    run, model, one = rank_train(cfg, mesh, seed, 8 * mesh.n_data, warmup=1, steps=2,
                                 make=model_axis_step(kind))
    run["profiled_step"] = profiled_step(one)
    run["describe"] = mesh.describe()
    del model, one
    torch.cuda.empty_cache()
    run["gate"] = rank_grad_gate(mesh, seed, kind=kind)
    run["phase_seconds"] = time.perf_counter() - t0
    return run


def rank_world2(args) -> dict:
    """The phases of the world of 2: dist_check, dp_pretrain_step,
    dp_local_step and zero_step on a data-only mesh, then tp_step and
    sharded_catalog on a model-only mesh, sp_attention_check and sp_step on
    a seq mesh, pp_step on a pipe mesh, the dry run, and the parallel CLIs
    of ``--rank-plan``."""
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.parallel.mesh import make_mesh
    from recformer_tpu_torch.parallel.tensor import tp_config, tp_split_dim

    seed = args.seed
    out = {}
    dp = make_mesh(1, "cuda", timeout_s=RANK_TIMEOUT_S)
    out["dist_check"] = rank_dist_check(dp)

    cfg = RecformerConfig.base()
    run, model, one = rank_train(cfg, dp, seed, 8 * dp.n_data, warmup=1, steps=4)
    del model, one
    torch.cuda.empty_cache()
    run["gate"] = rank_grad_gate(dp, seed)
    out["dp_pretrain_step"] = run

    cfg0 = cfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                       contrastive_gradient="local")
    run, model, one = rank_train(cfg0, dp, seed, 8 * dp.n_data, warmup=0, steps=6, lr=1e-4,
                                 fixed_seed=seed + 5)
    del model, one
    out["dp_local_step"] = run

    out["zero_step"] = rank_zero_bit_equal(dp, seed)

    tp = make_mesh(2, "cuda", timeout_s=RANK_TIMEOUT_S)
    out["tp_step"] = {}
    for kv in ("thin", "full"):
        tcfg = tp_config(cfg.replace(global_kv_mode=kv))
        run, model, one = rank_train(tcfg, tp, seed, 8, warmup=1, steps=1)
        run["replicated_digests"] = {n: digest(p) for n, p in model.named_parameters()
                                     if tp_split_dim(n) is None}
        run["local_heads"] = (model.longformer.encoder.layer[0].attention.self.query.weight
                              .shape[0] // cfg.head_dim)
        del model, one
        torch.cuda.empty_cache()
        run["gate"] = rank_grad_gate(tp, seed, lambda c, kv=kv: tp_config(
            c.replace(global_kv_mode=kv)))
        out["tp_step"][kv] = run
    out["sharded_catalog"] = rank_sharded_catalog(tp, seed)
    sp = make_mesh(2, "cuda", timeout_s=RANK_TIMEOUT_S, axis="seq")
    t0 = time.perf_counter()
    out["sp_attention_check"] = rank_sp_attention_check(sp, seed)
    out["sp_attention_check"]["phase_seconds"] = time.perf_counter() - t0
    out["sp_step"] = rank_model_axis_step(sp, seed, "sp")
    pp = make_mesh(2, "cuda", timeout_s=RANK_TIMEOUT_S, axis="pipe")
    out["pp_step"] = rank_model_axis_step(pp, seed, "pp")
    out["parallel_dryrun"] = rank_dryrun()
    out["parallel_clis"] = rank_clis(args.rank_plan)
    return out


def rank_dryrun() -> dict:
    """``parallel/dryrun.py``'s steps in this world (the module's own
    ``dryrun``, as ``python -m recformer_tpu_torch.parallel.dryrun`` runs
    it): each step's loss and this rank's launches."""
    from recformer_tpu_torch.parallel.dryrun import dryrun

    reset_counts()
    t0 = time.perf_counter()
    losses = dryrun("cuda")
    torch.cuda.synchronize()
    return dict(losses=losses, seconds=time.perf_counter() - t0, counts=read_counts())


def rank_sharded_catalog(mesh, seed) -> dict:
    """``parallel/catalog.py`` over the model group against the dense path on
    this rank: 10,000 and 10,001 rows of 768 (the second with a padding
    row), 64 users, and 64 users whose every score is negative."""
    from recformer_tpu_torch.models.heads import similarity_scores
    from recformer_tpu_torch.parallel.catalog import (shard_rows, sharded_full_softmax_loss,
                                                      sharded_rank, sharded_topk)
    from recformer_tpu_torch.training.losses import seqrec_full_softmax_loss
    from recformer_tpu_torch.training.metrics import MAX_VAL, rank_from_scores

    g, temp, k = mesh.model_group, 0.05, 10
    rng = np.random.default_rng(seed + 11)
    cases = {}
    for name, n, negative in (("10000", 10_000, False), ("10001", 10_001, False),
                              ("10001_all_negative", 10_001, True)):
        pooled = rng.standard_normal((64, 768)).astype(np.float32)
        emb = rng.standard_normal((n, 768)).astype(np.float32)
        if negative:
            pooled, emb = np.abs(pooled) + 0.1, -np.abs(emb) - 0.1
        pooled, emb = torch.from_numpy(pooled).cuda(), torch.from_numpy(emb).cuda()
        labels = torch.from_numpy(rng.integers(0, n, size=64)).cuda()
        scores = similarity_scores(pooled, emb, temp)
        rank_d, valid_d = rank_from_scores(scores, labels), (scores > -MAX_VAL).float().sum(1)
        top_d, ids_d = torch.topk(scores, k, dim=1)
        p = pooled.clone().requires_grad_()
        loss_d = seqrec_full_softmax_loss(p, emb, labels, temp)
        loss_d.backward()
        grad_d = p.grad
        shard = shard_rows(emb, g)
        rank_s, valid_s = sharded_rank(pooled, shard, labels, temp, n, g)
        top_s, ids_s = sharded_topk(pooled, shard, k, temp, n, g)
        p = pooled.clone().requires_grad_()
        loss_s = sharded_full_softmax_loss(p, shard, labels, temp, n, g)
        loss_s.backward()
        cases[name] = dict(
            rows=n, rows_per_rank=shard.shape[0],
            rank_exact=torch.equal(rank_s, rank_d), valid_length_exact=torch.equal(valid_s, valid_d),
            topk_ids_exact=torch.equal(ids_s, ids_d),
            topk_score_max_abs_err=float((top_s - top_d).abs().max()),
            loss_abs_err=float((loss_s - loss_d).abs()),
            grad_pooled_rel_err=float((p.grad - grad_d).norm() / grad_d.norm()),
            padded_ids_returned=int((ids_s >= n).sum()))
    return cases


def rank_world4(args) -> dict:
    """dp_tp_step_ln_kernels: data 2 x model 2 under the LayerNorm kernels
    and ``--remat --remat_policy save_attention``, 2 steps, and the device
    kernels of one profiled step; sp_step_dp (data 2 x seq 2) and
    pp_step_dp (data 2 x pipe 2); the dry run."""
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.parallel.mesh import make_mesh
    from recformer_tpu_torch.parallel.tensor import tp_config

    mesh = make_mesh(2, "cuda", timeout_s=RANK_TIMEOUT_S)
    cfg = tp_config(RecformerConfig.base(embed_ln_impl="pallas", ln_impl="pallas_bwd",
                                         remat=True, remat_policy="save_attention"))
    run, model, one = rank_train(cfg, mesh, args.seed, 8 * mesh.n_data, warmup=1, steps=2)
    names = kernels_per_call(one, warm=False)
    ln = [m.group(1) for m in map(LN_KERNEL_NAME.search, names) if m]
    run["layernorm_device_kernels_per_step"] = {k: ln.count(k) for k in sorted(set(ln))}
    run["device_kernels_per_step"] = len(names)
    del model, one
    torch.cuda.empty_cache()
    out = {"dp_tp_step_ln_kernels": run}
    out["sp_step_dp"] = rank_model_axis_step(
        make_mesh(2, "cuda", timeout_s=RANK_TIMEOUT_S, axis="seq"), args.seed, "sp")
    out["pp_step_dp"] = rank_model_axis_step(
        make_mesh(2, "cuda", timeout_s=RANK_TIMEOUT_S, axis="pipe"), args.seed, "pp")
    out["parallel_dryrun"] = rank_dryrun()
    return out


def rank_clis(plan_path) -> dict:
    """The port's CLIs of the plan at ``plan_path`` (a JSON list of ``{name,
    module, args, float32, preempt}``), one after another in this rank's
    process, in the world already set up (each CLI joins it and leaves it
    up): ``float32`` runs the CLI's config in float32 (the CLIs have no
    dtype flag), ``preempt`` ``"R:N"`` sends SIGTERM to rank R at its N-th
    step boundary. Returns each run's result, this rank's launches and
    peak."""
    import dataclasses
    import gc
    import importlib

    with open(plan_path) as f:
        plan = json.load(f)
    out = {}
    for run in plan:
        mod = importlib.import_module(f"recformer_tpu_torch.cli.{run['module']}")
        saved = {k: getattr(mod, k) for k in ("build_config", "_install_preemption_handler")
                 if hasattr(mod, k)}
        if run.get("float32"):
            build = mod.build_config
            mod.build_config = lambda a, item_num=0, _b=build: dataclasses.replace(
                _b(a, item_num=item_num), dtype="float32")
        if run.get("preempt"):
            rank, n = map(int, run["preempt"].split(":"))
            if int(os.environ["RANK"]) == rank:
                real = mod._install_preemption_handler
                mod._install_preemption_handler = lambda: _SignalAfter(real(), n)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            res = mod.main(run["args"])
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
        torch.cuda.synchronize()
        out[run["name"]] = dict(result=res, counts=read_counts(), seconds=time.perf_counter() - t0,
                                peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank_main(args) -> int:
    """Rank mode (under torchrun): run ``--rank-task`` and write this rank's
    results to ``--rank-out``/rank<r>.json."""
    from recformer_tpu_torch.parallel.mesh import destroy
    from recformer_tpu_torch.parallel.tensor import deterministic_replicas

    deterministic_replicas()  # every world runs tensor parallelism: before any CUDA work
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tasks = {"world2": rank_world2, "world4": rank_world4}
    try:
        out = tasks[args.rank_task](args)
        with open(os.path.join(args.rank_out, f"rank{os.environ['RANK']}.json"), "w") as f:
            json.dump(out, f)
    finally:
        destroy()
    return 0


def check_training(phase, per_rank, expected, card, backend, **extra):
    """Every rank's launches a step equal ``expected``, its losses finite;
    emits the phase line."""
    ok = all(r["launches_per_step"][k] == expected[k] for r in per_rank for k in COUNTERS)
    ok = ok and all(math.isfinite(x) for r in per_rank for x in r["losses"])
    rank0 = per_rank[0]
    emit(phase, backend=backend, world=len(per_rank), steps=rank0["steps"],
         steps_per_s=rank0.get("steps_per_s"),
         peak_memory_gib_per_rank=[r["peak_memory_gib"] for r in per_rank],
         launches_per_step_per_rank=[{k: r["launches_per_step"][k] for k in COUNTERS if
                                      r["launches_per_step"][k]} for r in per_rank],
         expected_per_step={k: v for k, v in expected.items() if v},
         all_on_tensor_cores=all(
             r["launches_per_step"]["band_attention_fwd_tc"] == r["launches_per_step"][
                 "band_attention_fwd"] and r["launches_per_step"]["band_attention_bwd_tc"]
             == r["launches_per_step"]["band_attention_bwd"] for r in per_rank),
         losses_rank0=rank0["losses"], card=card, **extra, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: launches {[r['launches_per_step'] for r in per_rank]}"
                             f" (expected {expected}), losses {[r['losses'] for r in per_rank]}")
    return add_counts([r["counts"] for r in per_rank])


def gate_from(phase, gate, **record):
    gate_grads(phase, ATTN_PROJ, 4 * 12, gate["cos"], gate["share"], gate["rel"],
               loss_parallel=gate["loss"], loss_one_rank=gate["loss_one_rank"], **record)


def model_axis_launches(cfg, kind, S=2, M=2) -> dict:
    """Launches of each kernel one sequence- (``'sp'``) or pipeline-parallel
    (``'pp'``) step makes on each rank, by reading the code: under ``'sp'``
    no attention kernel (the op is plain PyTorch, the item tower the chunked
    twin), the LayerNorm kernels as one rank's step (every rank runs every
    layer on its slice); under ``'pp'`` a stage runs its L/S layers on M
    microbatches a tower, so the per-layer kernels launch M/S times one
    rank's count, and the embedding kernels once a tower on every stage."""
    per = launches_per_step(cfg)
    layer_kernels = ("band_attention_fwd", "band_attention_bwd", "band_attention_fwd_tc",
                     "band_attention_bwd_tc", "layernorm_bwd")
    if kind == "sp":
        return {k: 0 if k.startswith("band_attention") else v for k, v in per.items()}
    return {k: v * M // S if k in layer_kernels else v for k, v in per.items()}


def check_model_axis(phase, per_rank, kind, card, backend, axes: dict, **extra):
    """A sequence- or pipeline-parallel step's launches (``check_training``),
    the device kernels of its profiled step (under ``'pp'`` one tensor-core
    forward device kernel a launch, under ``'sp'`` none), and its float32
    gradient gate against the one-rank step (cosine > 0.9999, dropout 0, a
    global batch of 8). ``axes``: the mesh's shape, recorded with both."""
    from recformer_tpu_torch.config import RecformerConfig

    cfg = RecformerConfig.base(**(SP_FLAGS if kind == "sp" else PP_FLAGS))
    expected = model_axis_launches(cfg, kind)
    band = [r["profiled_step"]["band_kernels"] for r in per_rank]
    want_fwd = expected["band_attention_fwd_tc"]
    counts = check_training(phase, per_rank, expected, card, backend, **axes, **extra,
                            transport=per_rank[0]["describe"].get("p2p"),
                            phase_seconds_per_rank=[r["phase_seconds"] for r in per_rank],
                            profiled_step=[r["profiled_step"] for r in per_rank])
    if not all(b.get("band_attention_fwd_tc_kernel", 0) == want_fwd
               and (want_fwd or not b) for b in band):
        raise AssertionError(f"{phase}: the profiled step's attention kernels {band} "
                             f"(expected {want_fwd} tensor-core forwards)")
    gate_from(f"{phase}_vs_one_rank", per_rank[0]["gate"], min_cos=0.9999, **axes,
              global_batch=8)
    return counts


def run_world2(seed, card, plan_path):
    """dist_check, dp_pretrain_step (+ its gradient gate), dp_local_step,
    zero_step, tp_step (both ``global_kv_mode``s, + gates), sharded_catalog
    and the dry run in one world of 2 ranks on the card, which then runs the
    parallel CLIs of ``plan_path``. Returns the launches and the ranks'
    results."""
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.parallel.tensor import tp_config

    t0 = time.perf_counter()
    ranks, _ = spawn_world(2, ["--rank-task", "world2", "--seed", str(seed), "--rank-plan",
                               plan_path], timeout=1000)
    seconds = time.perf_counter() - t0
    counts = {}
    dist = [r["dist_check"] for r in ranks]
    backend = dist[0]["backend"]
    ok = all(all(d["checks"].values()) for d in dist)
    emit("dist_check", backend=backend, world=2, tensors="cuda", checks=dist[0]["checks"],
         world_seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"dist_check: {dist}")

    cfg = RecformerConfig.base()
    per = [r["dp_pretrain_step"] for r in ranks]
    counts["dp_pretrain_step"] = check_training(
        "dp_pretrain_step", per, launches_per_step(cfg), card, backend, batch_per_rank=8,
        global_batch=16, dropout=0.1, contrastive_gradient="full")
    gate_from("dp_pretrain_step_vs_one_rank", per[0]["gate"], world=2, global_batch=8)

    per = [r["dp_local_step"] for r in ranks]
    counts["dp_local_step"] = check_training("dp_local_step", per, launches_per_step(cfg), card,
                                             backend, dropout=0.0, fixed_batch=True)
    losses = per[0]["losses"]
    falls = bool(np.mean(losses[-3:]) < np.mean(losses[:3]))
    emit("dp_local_step_falls", losses=losses, falls=falls, ok=falls)
    if not falls:
        raise AssertionError(f"dp_local_step: loss did not fall: {losses}")

    per = [r["zero_step"] for r in ranks]
    share = [r["zero_optimizer_state_bytes"] / r["plain_optimizer_state_bytes"] for r in per]
    counts["zero_step"] = check_training(
        "zero_step", per, launches_per_step(cfg), card, backend,
        peak_holds="the plain and the ZeRO model and optimizer",
        update_ms_per_rank=[r["update_ms"] for r in per],
        bit_equal_to_plain_dp=[r["bit_equal_per_update"] for r in per],
        adamw_state_gib_per_rank=[r["zero_optimizer_state_bytes"] / 2 ** 30 for r in per],
        plain_dp_adamw_state_gib_per_rank=[r["plain_optimizer_state_bytes"] / 2 ** 30
                                           for r in per], state_share=share,
        state_share_by_the_rule=per[0]["rule_share"], left_whole=per[0]["unsharded"])
    if not (all(r["bit_equal"] for r in per)
            and all(abs(s - r["rule_share"]) < 1e-6 for s, r in zip(share, per))):
        raise AssertionError(f"zero_step: bit-equal {[r['bit_equal_per_update'] for r in per]},"
                             f" state share {share} (the rule's {per[0]['rule_share']})")

    counts["tp_step"] = {k: 0 for k in COUNTERS}
    for kv in ("thin", "full"):
        per = [r["tp_step"][kv] for r in ranks]
        tcfg = tp_config(cfg.replace(global_kv_mode=kv))
        equal = per[0]["replicated_digests"] == per[1]["replicated_digests"]
        c = check_training(f"tp_step_{kv}", per, launches_per_step(tcfg), card, backend,
                           model=2, batch=8, heads_per_rank=[r["local_heads"] for r in per],
                           replicated_tensors=len(per[0]["replicated_digests"]),
                           replicated_bit_equal_across_ranks=equal)
        counts["tp_step"] = {k: counts["tp_step"][k] + c[k] for k in COUNTERS}
        if not (equal and all(r["local_heads"] == 6 for r in per)):
            raise AssertionError(f"tp_step_{kv}: replicated tensors equal {equal}, heads "
                                 f"{[r['local_heads'] for r in per]}")
        gate_from(f"tp_step_{kv}_vs_one_rank", per[0]["gate"], model=2, global_batch=8)

    cases = ranks[0]["sharded_catalog"]
    # the all-negative users' cosines bunch within ~1e-6 of each other, where
    # the two paths' float32 dot products (GEMMs of 10,001 and 5,001 rows)
    # may order near-ties differently: their gate is no padded id
    ok = all((c["rank_exact"] and c["topk_ids_exact"]) or name.endswith("all_negative")
             for r in ranks for name, c in r["sharded_catalog"].items())
    ok = ok and all(c["valid_length_exact"] and c["topk_score_max_abs_err"] <= 1e-5
                    and c["loss_abs_err"] <= 1e-5 and c["grad_pooled_rel_err"] <= 1e-5
                    and c["padded_ids_returned"] == 0
                    for r in ranks for c in r["sharded_catalog"].values())
    emit("sharded_catalog", backend=backend, world=2, users=64, k=10, cases=cases, ok=ok)
    if not ok:
        raise AssertionError(f"sharded_catalog: {[r['sharded_catalog'] for r in ranks]}")

    checks = [r["sp_attention_check"] for r in ranks]
    ok = all(c[d]["finite"] and c[d]["max_abs_err"] <= TOL[dt]
             and max(c[d]["rel_err"].values()) <= BWD_TOL[dt]
             for c in checks for d, dt in (("float32", torch.float32),
                                           ("bfloat16", torch.bfloat16)))
    emit("sp_attention_check", world=2, seq=2, shape=list(SP_SHAPE), window=64,
         against="chunked_attention on the whole inputs", rank0=checks[0],
         tol_abs={"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16]},
         tol_rel={"float32": BWD_TOL[torch.float32], "bfloat16": BWD_TOL[torch.bfloat16]},
         ok=ok)
    if not ok:
        raise AssertionError(f"sp_attention_check: {checks}")
    counts["sp_step"] = check_model_axis("sp_step", [r["sp_step"] for r in ranks], "sp", card,
                                         backend, dict(seq=2), batch=8, dropout=0.1)
    counts["pp_step"] = check_model_axis("pp_step", [r["pp_step"] for r in ranks], "pp", card,
                                         backend, dict(pipe=2, microbatches=2), batch=8,
                                         dropout=0.1)
    counts["parallel_dryrun_world2"] = check_dryrun(ranks)
    return counts, ranks


def run_world4(seed, card) -> dict:
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.parallel.tensor import tp_config

    t0 = time.perf_counter()
    ranks, _ = spawn_world(4, ["--rank-task", "world4", "--seed", str(seed)], timeout=600)
    emit("world4", world=4, world_seconds=time.perf_counter() - t0, ok=True)
    per = [r["dp_tp_step_ln_kernels"] for r in ranks]
    cfg = tp_config(RecformerConfig.base(embed_ln_impl="pallas", ln_impl="pallas_bwd",
                                         remat=True, remat_policy="save_attention"))
    expected = launches_per_step(cfg)
    ln_expected = {k: v for k, v in zip(("embed_ln_fwd", "embed_ln_bwd", "ln_bwd"), (
        expected["embed_layernorm_fwd"], expected["embed_layernorm_bwd"],
        expected["layernorm_bwd"])) if v}
    ln_ok = all(r["layernorm_device_kernels_per_step"] == ln_expected for r in per)
    counts = check_training("dp_tp_step_ln_kernels", per, expected, card, per[0]["backend"],
                            data=2,
                            model=2, batch_per_data_rank=8, remat_policy="save_attention",
                            layernorm_device_kernels_per_step=per[0][
                                "layernorm_device_kernels_per_step"],
                            layernorm_expected=ln_expected,
                            kernel1_relaunched_in_backward=per[0]["launches_per_step"][
                                "band_attention_fwd"] > 24)
    if not ln_ok:
        raise AssertionError(f"dp_tp_step_ln_kernels: LayerNorm device kernels "
                             f"{[r['layernorm_device_kernels_per_step'] for r in per]} "
                             f"(expected {ln_expected})")
    return {"dp_tp_step_ln_kernels": counts,
            "sp_step_dp": check_model_axis("sp_step_dp", [r["sp_step_dp"] for r in ranks], "sp",
                                           card, per[0]["backend"], dict(data=2, seq=2),
                                           batch_per_data_rank=8, dropout=0.1),
            "pp_step_dp": check_model_axis("pp_step_dp", [r["pp_step_dp"] for r in ranks], "pp",
                                           card, per[0]["backend"],
                                           dict(data=2, pipe=2, microbatches=2),
                                           batch_per_data_rank=8, dropout=0.1),
            "parallel_dryrun_world4": check_dryrun(ranks)}


def prepare_parallel_clis(seed, tmp) -> dict:
    """The corpora, checkpoint and one-rank results of the parallel CLIs, and
    the plan that the world of 2 runs after its other phases, one command
    after another: ``cli.evaluate_seq --sharded_eval 2`` (float32) and
    ``cli.serve``, each against the same command on one rank here;
    ``cli.pretrain --zero`` on 2 data ranks with a SIGTERM on rank 1 alone
    after step 5, then ``--resume``; ``cli.pretrain --tensor_parallel 2``,
    ``--sequence_parallel 2 --attention_impl sequence_parallel`` and
    ``--pipeline 2 --scan_layers --microbatches 2`` (1 epoch of 3 steps, a
    SIGTERM on rank 1 alone after step 2, then ``--resume``)."""
    import dataclasses

    from recformer_tpu_torch.cli import encode_items, evaluate_seq, serve
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForSeqRec

    data = os.path.join(tmp, "catalog")
    os.makedirs(data)
    write_corpus(data, n_items=1001, n_users=64, seed=seed + 3, hist=(16, 51))
    cfg = RecformerConfig.base()
    # random weights spread wide: at the default 0.02 the catalog's cosines
    # bunch up and bf16 ties would reorder the top-k
    wide = cfg.replace(initializer_range=0.5)
    ckpt = os.path.join(tmp, "seqrec.pt")
    torch.save(init_model_params(RecformerForSeqRec(wide), wide, "cuda", seed).state_dict(),
               ckpt)
    common = ["--data_path", data, "--ckpt", ckpt, "--model_size", "base", "--device",
              "cuda"]
    build = evaluate_seq.build_config
    evaluate_seq.build_config = lambda a, item_num=0: dataclasses.replace(
        build(a, item_num=item_num), dtype="float32")
    try:
        one_eval = evaluate_seq.main(common + ["--batch_size", "16"])
    finally:
        evaluate_seq.build_config = build
    emb = os.path.join(tmp, "emb.npy")
    encode_items.main(common + ["--output", emb])
    serve_args = common + ["--sequences", os.path.join(data, "sequences.json"),
                           "--item_embeddings", emb, "--top_k", "10"]
    serve.main(serve_args + ["--output", os.path.join(tmp, "one.jsonl")])

    pre = os.path.join(tmp, "pretrain")
    os.makedirs(pre)
    seqs = write_corpus(pre, n_users=24, seed=seed)
    for name, part in (("train", list(seqs.values())), ("dev", list(seqs.values())[:8])):
        with open(os.path.join(pre, f"{name}.json"), "w") as f:
            json.dump(part, f)
    base_args = ["--data_path", pre, "--model_size", "base", "--warmup_steps", "1",
                 "--seed", str(seed), "--device", "cuda", "--save_top_k", "1"]
    z_out, tp_out = os.path.join(tmp, "zero"), os.path.join(tmp, "tp")
    sp_out, pp_out = os.path.join(tmp, "sp"), os.path.join(tmp, "pp")
    pp_args = base_args + ["--output_dir", pp_out, "--num_train_epochs", "1", "--batch_size",
                           "8", "--gradient_accumulation_steps", "2", "--pipeline", "2",
                           "--scan_layers", "--microbatches", "2"]
    z_args = base_args + ["--output_dir", z_out, "--num_train_epochs", "2", "--batch_size",
                          "4", "--gradient_accumulation_steps", "2", "--zero"]
    plan = [
        dict(name="evaluate_seq", module="evaluate_seq", float32=True,
             args=common + ["--batch_size", "16", "--sharded_eval", "2"]),
        dict(name="serve", module="serve",
             args=serve_args + ["--output", os.path.join(tmp, "two.jsonl")]),
        dict(name="zero", module="pretrain", args=z_args, preempt="1:5"),
        dict(name="zero_resume", module="pretrain", args=z_args + ["--resume"]),
        dict(name="tp", module="pretrain", args=base_args + [
            "--output_dir", tp_out, "--num_train_epochs", "1", "--batch_size", "8",
            "--gradient_accumulation_steps", "2", "--tensor_parallel", "2"]),
        dict(name="sp", module="pretrain", args=base_args + [
            "--output_dir", sp_out, "--num_train_epochs", "1", "--batch_size", "8",
            "--gradient_accumulation_steps", "2", "--sequence_parallel", "2",
            "--attention_impl", "sequence_parallel"]),
        dict(name="pp", module="pretrain", args=pp_args, preempt="1:2"),
        dict(name="pp_resume", module="pretrain", args=pp_args + ["--resume"]),
    ]
    plan_path = os.path.join(tmp, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    torch.cuda.empty_cache()
    return dict(plan=plan, plan_path=plan_path, one_eval=one_eval, tmp=tmp, z_out=z_out,
                tp_out=tp_out, sp_out=sp_out, pp_out=pp_out, cfg=cfg)


def check_parallel_clis(seed, ranks, ctx) -> dict:
    """The parallel CLIs' results (the world of 2's ``parallel_clis``) against
    the one-rank ones; the tensor-parallel ``best.pt`` (whole tensors) into a
    one-rank ``cli.finetune`` for one epoch a stage. Returns their launches
    over the ranks."""
    from recformer_tpu_torch.cli import finetune
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForPretraining

    plan, one_eval, tmp = ctx["plan"], ctx["one_eval"], ctx["tmp"]
    z_out, tp_out, cfg = ctx["z_out"], ctx["tp_out"], ctx["cfg"]
    ranks = [r["parallel_clis"] for r in ranks]
    counts = add_counts([r[run["name"]]["counts"] for r in ranks for run in plan])

    two = ranks[0]["evaluate_seq"]["result"]
    err = max(abs(two[k] - one_eval[k]) for k in one_eval)
    ok = set(one_eval) == set(two) and err <= 1e-5
    emit("parallel_cli_evaluate_seq", world=2, sharded_eval=2, items=1001, users=64,
         dtype="float32", one_rank=one_eval, two_ranks=two, max_abs_err=err,
         launches_per_rank=[r["evaluate_seq"]["counts"]["band_attention_fwd"]
                            for r in ranks], ok=ok)
    if not ok:
        raise AssertionError(f"parallel_cli_evaluate_seq: {one_eval} vs {two}")

    rows = []
    for name in ("one", "two"):
        with open(os.path.join(tmp, f"{name}.jsonl")) as f:
            rows.append([json.loads(l) for l in f])
    same = len(rows[0]) == len(rows[1]) == 64 and all(
        a["items"] == b["items"] for a, b in zip(*rows))
    emit("parallel_cli_serve", world=2, users=64, top_k=10, same_ids=same, ok=same)
    if not same:
        raise AssertionError("parallel_cli_serve: the two ranks' ids differ from one rank's")

    first = [r["zero"]["result"] for r in ranks]
    second = [r["zero_resume"]["result"] for r in ranks]
    ok = ([r["steps"] for r in first] == [5, 5]
          and all(r["preempted"] == signal.SIGTERM for r in first)
          and [r["steps"] for r in second] == [8, 8]
          and all("preempted" not in r for r in second)
          and {"state.pt", "last.pt", "config.json"} <= set(os.listdir(z_out)))
    emit("parallel_cli_pretrain_zero_preemption", world=2, zero=True,
         sigterm="rank 1 only, after step 5", stopped_at_per_rank=[r["steps"] for r in first],
         resumed=second, peak_memory_gib_per_rank=[r["zero"]["peak_memory_gib"]
                                                   for r in ranks], ok=ok)
    if not ok:
        raise AssertionError(f"parallel_cli_pretrain_zero_preemption: {first}, {second}")

    ft = os.path.join(tmp, "finetune")
    os.makedirs(ft)
    write_corpus(ft, n_items=128, n_users=32, seed=seed + 1, hist=(16, 51))

    def into_one_rank_finetune(out_dir, name):
        """``out_dir``'s ``best.pt``, whole, into a one-rank ``cli.finetune``
        for one epoch a stage: the tensors copied and the test metrics."""
        whole = RecformerForPretraining(cfg)
        whole.load_state_dict(torch.load(os.path.join(out_dir, "best.pt"), weights_only=True),
                              strict=True)
        del whole
        with _MergeRecord() as loads:
            metrics = finetune.main(["--data_path", ft, "--output_dir",
                                     os.path.join(ft, name), "--model_size", "base",
                                     "--device", "cuda", "--num_train_epochs", "1",
                                     "--verbose", "1", "--batch_size", "16", "--seed", str(seed),
                                     "--pretrain_ckpt", os.path.join(out_dir, "best.pt")])
        copied = len(loads[0][0]) if loads else 0
        ok = copied == len(loads[0][2]) and all(math.isfinite(v) for v in metrics.values())
        return ok, {"copied": copied, "test_metrics": metrics}

    tp_res = ranks[0]["tp"]["result"]
    loaded_ok, loaded = into_one_rank_finetune(tp_out, "out")
    ok = tp_res["steps"] == 3 and loaded_ok
    emit("parallel_cli_pretrain_tp", world=2, tensor_parallel=2, result=tp_res,
         peak_memory_gib_per_rank=[r["tp"]["peak_memory_gib"] for r in ranks],
         best_pt_whole=True, into_one_rank_finetune=loaded, ok=ok)
    if not ok:
        raise AssertionError(f"parallel_cli_pretrain_tp: {tp_res}, {loaded}")

    sp_res = [r["sp"]["result"] for r in ranks]
    saved = RecformerConfig.load(os.path.join(ctx["sp_out"], "config.json"))
    loaded_ok, loaded = into_one_rank_finetune(ctx["sp_out"], "out_sp")
    ok = ([r["steps"] for r in sp_res] == [3, 3] and loaded_ok
          and (saved.attention_impl, saved.global_kv_mode) == ("sequence_parallel", "full"))
    emit("parallel_cli_pretrain_sp", world=2, sequence_parallel=2, result=sp_res[0],
         seconds_per_rank=[r["sp"]["seconds"] for r in ranks],
         peak_memory_gib_per_rank=[r["sp"]["peak_memory_gib"] for r in ranks],
         launches_per_rank=[{k: v for k, v in r["sp"]["counts"].items() if v} for r in ranks],
         best_pt_whole=True, into_one_rank_finetune=loaded, ok=ok)
    if not ok:
        raise AssertionError(f"parallel_cli_pretrain_sp: {sp_res}, {loaded}")

    first = [r["pp"]["result"] for r in ranks]
    second = [r["pp_resume"]["result"] for r in ranks]
    loaded_ok, loaded = into_one_rank_finetune(ctx["pp_out"], "out_pp")
    ok = ([r["steps"] for r in first] == [2, 2]
          and all(r["preempted"] == signal.SIGTERM for r in first)
          and [r["steps"] for r in second] == [5, 5]
          and all("preempted" not in r for r in second) and loaded_ok)
    emit("parallel_cli_pretrain_pp", world=2, pipeline=2, microbatches=2,
         seconds_per_rank=[r["pp"]["seconds"] + r["pp_resume"]["seconds"] for r in ranks],
         sigterm="rank 1 only, after step 2", stopped_at_per_rank=[r["steps"] for r in first],
         resumed=second[0], peak_memory_gib_per_rank=[r["pp"]["peak_memory_gib"]
                                                      for r in ranks],
         launches_per_rank=[{k: v for k, v in r["pp"]["counts"].items() if v} for r in ranks],
         best_pt_whole=True, into_one_rank_finetune=loaded, ok=ok)
    if not ok:
        raise AssertionError(f"parallel_cli_pretrain_pp: {first}, {second}, {loaded}")
    return {"parallel_clis": counts}


def check_dryrun(ranks) -> dict:
    """parallel_dryrun: every step of the dry run ran, its losses finite and
    equal on every rank; returns the launches over the ranks."""
    per = [r["parallel_dryrun"] for r in ranks]
    names = ["pretrain", "finetune_sampled", "finetune_full", "zero", "local",
             "sequence_parallel_forward", "pipeline_forward"] + (
        ["tensor_parallel", "sequence_parallel", "pipeline_parallel"] if len(ranks) >= 4 else [])
    losses = per[0]["losses"]
    ok = (sorted(losses) == sorted(names) and all(math.isfinite(v) for v in losses.values())
          and all(r["losses"] == losses for r in per))
    emit("parallel_dryrun", world=len(ranks), losses=losses, seconds=per[0]["seconds"], ok=ok)
    if not ok:
        raise AssertionError(f"parallel_dryrun world {len(ranks)}: {per}")
    return add_counts([r["counts"] for r in per])


def run_parallel(seed, card) -> dict:
    """Every parallel phase; returns the launches of each, over all ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        clis = prepare_parallel_clis(seed, tmp)
        counts, ranks = run_world2(seed, card, clis["plan_path"])
        counts.update(check_parallel_clis(seed, ranks, clis))
    counts.update(run_world4(seed, card))
    return counts


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["parallel", "probes", "modernbert", "train_graph",
                                       "deepseek_v3"],
                    default=None,
                    help="build, then run only the parallel phases (30-36), the probes' "
                    "(7b, 7c), kernel_check, kernel_time and modernbert, kernel_check "
                    "and train_graph, or deepseek_v3 (no build); no result line")
    # rank mode: this script as one rank of a world that it started itself
    ap.add_argument("--rank-task", choices=["world2", "world4"], help=argparse.SUPPRESS)
    ap.add_argument("--rank-out", help=argparse.SUPPRESS)
    ap.add_argument("--rank-plan", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    if args.rank_task:
        return rank_main(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from recformer_tpu_torch import native
    from recformer_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("environment", device=kind, card=card, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    if args.only == "deepseek_v3":  # no hand-written kernel on its path
        run_deepseek_v3(args.seed, card)
        emit("command_time", seconds=time.perf_counter() - t_start, limit_seconds=1200)
        return 0
    t0 = time.perf_counter()
    # the probes' source under -Xptxas -v (probe_sass), compiled beside the build
    ptxas = None
    if args.only not in ("parallel", "modernbert", "train_graph"):
        pool = concurrent.futures.ThreadPoolExecutor(1)
        ptxas = pool.submit(_build.ptxas_report, _build.SOURCES["band_probes"])
        pool.shutdown(wait=False)
    _build.build_all()
    for name in _build.SOURCES:
        _build.load_library(name)
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(_build.SOURCES))
    t0 = time.perf_counter()
    native.load_library()  # the host library (g++), timed in the native phase
    native_build_seconds = time.perf_counter() - t0
    if args.only == "parallel":
        run_parallel(args.seed, card)
        emit("command_time", seconds=time.perf_counter() - t_start, limit_seconds=1200)
        return 0
    if args.only == "modernbert":
        emit("ptxas", source="band_attention_fwd.cu",
             kernels=_build.ptxas_report(_build.SOURCES["band_attention_fwd"]))
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        check_kernels(gen)
        time_kernels(gen, card)
        run_modernbert(args.seed, card)
        emit("command_time", seconds=time.perf_counter() - t_start, limit_seconds=1200)
        return 0
    if args.only == "train_graph":
        check_kernels(torch.Generator(device="cuda").manual_seed(args.seed))
        run_train_graph(args.seed, card)
        emit("command_time", seconds=time.perf_counter() - t_start, limit_seconds=1200)
        return 0
    if args.only == "probes":
        check_probes()
        probe_instructions(ptxas.result())
        time_probes(card)
        emit("command_time", seconds=time.perf_counter() - t_start, limit_seconds=1200)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = check_kernels(gen)
    dropout_check(gen, card)
    times = time_kernels(gen, card)
    ln_errs = check_ln_kernels(gen)
    ln_times = time_ln_kernels(gen, card)
    probe_errs = check_probes()
    probe_sass = probe_instructions(ptxas.result())
    probe_times, probe_counts = time_probes(card)
    phases = {"probe_time": probe_counts, "serving": run_serving(args.seed, card),
              "serve_graph": run_serve_graph(args.seed, card),
              "train_graph": run_train_graph(args.seed, card),
              "encode_embed_kernel": run_encode_embed_kernel(args.seed, card),
              "offline_clis": run_offline_clis(args.seed, card)}
    phases["pretrain_step"], default_rates = run_pretrain_step(args.seed, card)
    phases["pretrain_step_ln_kernels"], _ = run_pretrain_step(
        args.seed, card, phase="pretrain_step_ln_kernels", baseline=default_rates,
        embed_ln_impl="pallas", ln_impl="pallas_bwd")
    run_pretrain_turns(args.seed, card)
    run_pretrain_vs_chunked(args.seed)
    run_pretrain_ln_kernels_vs_plain(args.seed)
    with tempfile.TemporaryDirectory() as keep:
        phases["pretrain_cli"] = run_pretrain_cli(args.seed, keep=keep)
        phases["pretrain_cli_ln_impl"] = run_pretrain_cli(
            args.seed, phase="pretrain_cli_ln_impl", extra=("--ln_impl", "pallas_bwd"))
        phases["pretrain_cli_preemption"] = run_pretrain_preemption(args.seed)
        phases["finetune_step"] = run_finetune_step(args.seed, card, 0, "finetune_step")
        phases["finetune_step_sampled"] = run_finetune_step(args.seed, card, 1000,
                                                            "finetune_step_sampled")
        run_finetune_vs_chunked(args.seed)
        phases["finetune_cli"], phases["finetune_cli_resume"] = run_finetune_cli(args.seed,
                                                                                 card)
        phases.update(run_fraud(args.seed, card, os.path.join(keep, "best.pt")))
    phases.update(run_analytics(args.seed, card, native_build_seconds))
    phases.update(run_remat_and_host(args.seed, card))
    phases.update(run_parallel(args.seed, card))
    run_modernbert(args.seed, card)

    sources = {"band_attention_fwd": "band_attention_fwd.cu",
               "band_attention_bwd": "band_attention_bwd.cu",
               "embed_layernorm_fwd": "embed_layernorm.cu",
               "embed_layernorm_bwd": "embed_layernorm.cu", "layernorm_bwd": "layernorm_bwd.cu"}
    replaces = {
        "band_attention_fwd": "recformer_tpu/ops/pallas_attention.py:118",
        "band_attention_bwd": "recformer_tpu/ops/pallas_attention.py:204",
        "embed_layernorm_fwd": "recformer_tpu/ops/pallas_embed.py:27",
        "embed_layernorm_bwd": "recformer_tpu/ops/pallas_embed.py:39",
        "layernorm_bwd": "recformer_tpu/ops/pallas_layernorm.py:41",
    }

    def kernel_row(name):
        if name in LN_KERNELS:
            rows = ln_times[name]
            err = max(e for (k, case, dt), e in ln_errs.items()
                      if k == name and dt == torch.bfloat16 and case in rows)
        else:
            rows = times[name]
            err = max(errs[(n, torch.bfloat16)][name == "band_attention_bwd"] for n in rows)
        # every number but the bound measured in this run: PR 3's times
        # (earlier_ms) stay in the kernel_time lines
        rows = {n: {k: v for k, v in r.items() if k != "earlier_ms"} for n, r in rows.items()}
        head = rows["sequence_tower"]
        by_phase = {p: c[name] for p, c in phases.items() if c.get(name)}
        extra = {}
        if name in ("band_attention_fwd", "band_attention_bwd"):
            tc = sum(c.get(f"{name}_tc", 0) for c in phases.values())
            extra["launches_by_path"] = {"tensor_core": tc,
                                         "cuda_core": sum(by_phase.values()) - tc}
        return dict(
            name=name, route="cuda", source=f"recformer_tpu_torch/ops/csrc/{sources[name]}",
            replaces=replaces[name], launches=sum(by_phase.values()),
            launches_by_phase=by_phase, **extra, max_abs_err=err, ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape="sequence_tower", shapes=rows, card=card)

    def probe_row(name):
        # the row's figures: the reference scripts' default block_q (256) and
        # their last variant; every variant at block_q 256 and 16 under "variants"
        variant = "full" if name == "band_ablation" else "pair"
        # the times before the redesign stay in the probe_time lines: every
        # number here is this run's
        rows = {n: {k: v for k, v in r.items() if k != "earlier_ms"}
                for n, r in probe_times[name].items()}
        head = rows[f"{variant}@256"]
        by_phase = {p: c[name] for p, c in phases.items() if c.get(name)}
        checked = {key: e for key, e in probe_errs.items() if key[0] == name}
        return dict(
            name=name, route="cuda", source="recformer_tpu_torch/ops/csrc/band_probes.cu",
            replaces=("benchmarks/kernel_ablation.py:37" if name == "band_ablation"
                      else "benchmarks/headpair_probe.py:47,64"),
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            max_abs_err=max(a for (_, case, v, _), (_, a) in checked.items()
                            if case == "defaults" and v == variant),
            max_rel_err=max(r for r, _ in checked.values()), ms=head["ms"],
            host_ms=head["host_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=None,
            library_call="none: no single PyTorch call computes this function",
            shape=f"{variant}, block_q 256, the probe's defaults (B 16, L 1024, H 12, D 64, W 64)",
            variants=rows, instructions=probe_sass, card=card)

    kernels = [kernel_row(name) for name in KERNELS] + [probe_row(n) for n in PROBE_KERNELS]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    emit("command_time", seconds=time.perf_counter() - t_start, limit_seconds=1200)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
