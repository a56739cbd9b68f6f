"""Checkpoint conversion: one pretraining checkpoint -> task-ready
checkpoints for the backbone, seq-rec and fraud models.

Counterpart of ``recformer_tpu/cli/convert_ckpt.py`` (after the reference's
``convert_pretrain_ckpt.py``). It reads one torch state dict: ``cli.pretrain``'s
``best.pt``, or a reference ``.bin`` whose Lightning/DeepSpeed prefixes are
stripped. The config comes from ``--config`` or ``--model_size``. Every name
and shape match is copied into each target; the rest keeps its initial value
from the seeded initialiser (the fraud head). It writes, under
``--output_dir``:

- ``recformer.pt``: ``RecformerModel``'s state dict (names without the
  ``longformer.`` prefix), which loads strictly into ``RecformerModel``;
- ``seqrec.pt``: ``RecformerForSeqRec``'s, for ``cli.finetune --pretrain_ckpt``;
- ``fraud.pt``: ``RecformerForFraudDetection``'s, the head at its seeded
  initial values, for ``cli.finetune_classification --pretrain_ckpt``;
- ``config.json``.

``--longformer_ckpt`` re-injects the word-embedding table of an original
Longformer checkpoint (for training with ``--fix_word_embedding``). An orbax
directory is not read: the port's checkpoints are torch files.

    python -m recformer_tpu_torch.cli.convert_ckpt --pretrain_ckpt best.pt \\
        --output_dir converted --model_size base
"""

from __future__ import annotations

import argparse
import os

from ..config import RecformerConfig
from ..models.heads import RecformerForFraudDetection, RecformerForPretraining, RecformerForSeqRec
from ..training.checkpoint import load_torch_checkpoint, merge_params, save_params
from .common import init_model_params

WORD_EMBEDDINGS = "longformer.embeddings.word_embeddings.weight"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pretrain_ckpt", type=str, required=True,
                   help="torch state dict (cli.pretrain's best.pt, a reference .bin)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--config", type=str, default=None, help="config.json path")
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--longformer_ckpt", type=str, default=None,
                   help="optional HF Longformer .bin whose word embeddings "
                        "overwrite the trained ones")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.config:
        config = RecformerConfig.load(args.config)
    elif args.model_size == "tiny":
        config = RecformerConfig.tiny()
    else:
        config = RecformerConfig.base()

    pre = init_model_params(RecformerForPretraining(config), config, args.device)
    merge_params(load_torch_checkpoint(args.pretrain_ckpt), pre)
    if args.longformer_ckpt:
        sd = load_torch_checkpoint(args.longformer_ckpt)
        if WORD_EMBEDDINGS in sd:
            merge_params({WORD_EMBEDDINGS: sd[WORD_EMBEDDINGS]}, pre)
            print("[convert] re-injected original Longformer word embeddings")

    os.makedirs(args.output_dir, exist_ok=True)
    source = pre.state_dict()
    for name, cls in (("recformer", None), ("seqrec", RecformerForSeqRec),
                      ("fraud", RecformerForFraudDetection)):
        if cls is None:  # the backbone: the pretraining model's longformer
            params = pre.longformer
        else:
            params = init_model_params(cls(config), config, args.device)
            merge_params(source, params)
        out = os.path.join(args.output_dir, f"{name}.pt")
        save_params(out, params)
        print(f"[convert] wrote {out}")
    config.save(os.path.join(args.output_dir, "config.json"))


if __name__ == "__main__":
    main()
