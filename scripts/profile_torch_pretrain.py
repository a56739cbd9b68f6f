#!/usr/bin/env python3
"""Where the time goes in the port's pretraining step, on one CUDA card.

    python3 scripts/profile_torch_pretrain.py [--steps 5] [--seed 0] \
        [--embed_ln_impl xla|pallas] [--ln_impl xla|pallas_bwd|split_bwd]

Runs ``--steps`` Recformer-base pretraining steps as ``chip_smoke.py``'s
pretrain_step phase does (random weights from ``--seed``, batch 8, the views
at (16, 1024) and (16, 128), dropout 0.1, AdamW) under ``torch.profiler``,
after one warm-up step, with the LayerNorm flags given (the LayerNorm
kernels' configuration is ``--embed_ln_impl pallas --ln_impl pallas_bwd``).
Prints one JSON line: wall time, device busy time, the device's idle share,
the device kernels launched per step, device time by group (the attention
kernels, the LayerNorm kernels, GEMMs, the optimizer, the rest) and the top
kernels; then the card line from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, pretrain_world  # noqa: E402
from profile_torch_serving import profile  # noqa: E402  (this script's directory)

# device kernel name -> group, first match wins
GROUPS = (
    ("attention_bwd", ("band_bwd",)),
    ("attention_fwd", ("band_attention_fwd",)),
    ("layernorm_kernels", ("embed_ln_fwd_kernel", "ln_bwd_kernel")),  # embed_ln_bwd too
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("optimizer", ("multi_tensor_apply", "foreach", "adam")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--embed_ln_impl", choices=["xla", "pallas"], default="xla")
    ap.add_argument("--ln_impl", choices=["xla", "pallas_bwd", "split_bwd"], default="xla")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_pretrain: CUDA is not available", file=sys.stderr)
        return 1
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForPretraining
    from recformer_tpu_torch.training.optimizer import create_optimizer
    from recformer_tpu_torch.training.steps import make_pretrain_step
    from recformer_tpu_torch.utils.rng import StepRNG

    cfg = RecformerConfig.base(embed_ln_impl=args.embed_ln_impl, ln_impl=args.ln_impl)
    table, item_ids, seq_lens = pretrain_world(cfg, args.seed)
    model = init_model_params(RecformerForPretraining(cfg), cfg, device="cuda", seed=args.seed)
    opt = create_optimizer(model, learning_rate=5e-5, warmup_steps=1000, total_steps=10_000)
    step = make_pretrain_step(cfg, model, opt)
    rng = StepRNG(args.seed, "cuda")
    profile(f"pretrain embed_ln_impl={cfg.embed_ln_impl} ln_impl={cfg.ln_impl}",
            lambda: [step(rng, table, item_ids, seq_lens) for _ in range(args.steps)],
            top=25, groups=group_of, per=args.steps)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
