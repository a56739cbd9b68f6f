#!/usr/bin/env python3
"""Where the time goes in the port's finetune and fraud steps, on one CUDA card.

    python3 scripts/profile_torch_finetune.py [--steps 8] [--seed 0] \
        [--negatives 1000] [--grad_accum 8] [--task seqrec|fraud]

Runs ``--steps`` Recformer-base finetune steps as ``chip_smoke.py``'s
finetune_step phase does (random weights from ``--seed``, batch 16 over a
10,000-item table with histories of 16-50 items, the history view at
(16, 1024), dropout 0.1, a random bf16 catalog, ``--negatives`` sampled
negatives or the full softmax at 0, AdamW with ``--grad_accum``
micro-steps an update; at the defaults each run of 8 steps holds one
update) under ``torch.profiler``, after a warm-up and one unprofiled timed
run. Prints one JSON line: wall time, device busy time,
the device's idle share, the device kernels launched per step, device time
by group (the attention kernels, GEMMs, the optimizer, the rest) and the
top kernels; then the card line from ``nvidia-smi``.

``--task fraud`` runs ``--steps`` fraud steps as ``chip_smoke.py``'s
fraud_step phase does instead: the synthetic transaction corpus at
``--scale small``, one distinct batch of 16 cards a step with their labels,
the head at 1e-3, one AdamW update a step (the fraud CLI does not
accumulate; ``--negatives`` and ``--grad_accum`` do not apply).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    build_fraud_corpus,
    card_line,
    finetune_world,
    fraud_batches,
    fraud_world,
)
from profile_torch_pretrain import group_of  # noqa: E402  (this script's directory)
from profile_torch_serving import profile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--negatives", type=int, default=1000)
    ap.add_argument("--grad_accum", type=int, default=8)
    ap.add_argument("--task", choices=["seqrec", "fraud"], default="seqrec")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_finetune: CUDA is not available", file=sys.stderr)
        return 1
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForFraudDetection, RecformerForSeqRec
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_finetune_step, make_fraud_train_step

    if args.task == "fraud":
        with tempfile.TemporaryDirectory() as tmp:
            cfg, table, ds = fraud_world(build_fraud_corpus(tmp, args.seed))
        batches = fraud_batches(ds, args.steps, args.seed)
        model = init_model_params(RecformerForFraudDetection(cfg), cfg, device="cuda",
                                  seed=args.seed)
        opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=100, total_steps=10_000,
                               head_lr=1e-3)
        step = make_fraud_train_step(cfg, model, opt)
        profile("fraud", lambda: [step(args.seed, table, *b) for b in batches], top=25,
                groups=group_of, per=args.steps)
        print(card_line(), flush=True)
        return 0
    cfg = RecformerConfig.base(finetune_negative_sample_size=args.negatives)
    table, item_ids, seq_lens, catalog = finetune_world(cfg, args.seed)
    model = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda", seed=args.seed)
    opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=100, total_steps=10_000,
                           grad_accum_steps=args.grad_accum)
    step = make_finetune_step(cfg, model, opt)
    profile(f"finetune negatives={args.negatives} grad_accum={args.grad_accum}",
            lambda: [step(args.seed, table, item_ids, seq_lens, catalog)
                     for _ in range(args.steps)],
            top=25, groups=group_of, per=args.steps)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
