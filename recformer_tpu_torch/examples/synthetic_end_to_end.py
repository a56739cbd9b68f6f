"""Complete end-to-end walkthrough on synthetic data through the port's CLIs.

Counterpart of ``examples/synthetic_end_to_end.py``, at that script's sizes
(30 items, 32 users, the tiny model, batch 8). It generates a synthetic item
catalog and user interactions, then runs the six stages:

  1. pretrain (MLM + contrastive)              -> best.pt
  2. convert the pretrain ckpt to task ckpts   (cli.convert_ckpt)
  3. two-stage seq-rec finetune                -> test metrics
  4. eval-only / zero-shot ranking             (cli.evaluate_seq)
  5. fraud classification                      (cli.finetune_classification)
  6. clustering analytics                      (cli.cluster)

and prints ``ALL STAGES COMPLETE``. Every stage takes the windowed-attention
kernels (``--attention_impl pallas``; the JAX example's tiny model keeps
its chunked attention): ``--device cuda`` (the default) runs them on the
card, ``--device cpu`` runs their plain versions on the CPU.

    python -m recformer_tpu_torch.examples.synthetic_end_to_end [workdir] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..utils.io import write_json


def generate_data(root, n_items=30, n_users=32, seed=0):
    """The JAX example's corpora, from ``seed``: finetune artifacts
    (leave-one-out), pretraining sequences and fraud artifacts. Returns
    their three directories."""
    rng = np.random.default_rng(seed)
    words = ["red", "blue", "green", "steel", "wood", "soft", "loud", "mini",
             "mega", "pro"]
    meta = {
        f"I{i:03d}": {
            "make": words[i % len(words)],
            "hue": words[(i * 3 + 1) % len(words)],
            "size": words[(i * 7 + 2) % len(words)],
        }
        for i in range(n_items)
    }
    smap = {f"I{i:03d}": i for i in range(n_items)}

    train, val, test = {}, {}, {}
    for u in range(n_users):
        seq = [int(x) for x in rng.integers(0, n_items, size=rng.integers(5, 10))]
        train[u], val[u], test[u] = seq[:-2], [seq[-2]], [seq[-1]]
    ft = os.path.join(root, "finetune")
    for name, obj in (("train.json", train), ("val.json", val), ("test.json", test),
                      ("meta_data.json", meta), ("smap.json", smap)):
        write_json(obj, os.path.join(ft, name))

    seqs = [[int(x) for x in rng.integers(0, n_items, size=rng.integers(4, 9))]
            for _ in range(n_users)]
    pre = os.path.join(root, "pretrain")
    write_json(seqs, os.path.join(pre, "train.json"))
    write_json(seqs[: n_users // 3], os.path.join(pre, "dev.json"))
    write_json(meta, os.path.join(pre, "meta_data.json"))
    write_json(smap, os.path.join(pre, "smap.json"))

    fraud = os.path.join(root, "fraud")
    for name in ("train.json", "val.json", "test.json"):
        data = {}
        for u in range(n_users // 2):
            seq = [int(x) for x in rng.integers(0, n_items, size=rng.integers(3, 8))]
            data[u] = [seq, [int(rng.random() < 0.3)]]
        write_json(data, os.path.join(fraud, name))
    write_json(meta, os.path.join(fraud, "meta_data.json"))
    write_json(smap, os.path.join(fraud, "smap.json"))
    return ft, pre, fraud


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "recformer_tpu_torch_example"))
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    root = args.workdir
    os.makedirs(root, exist_ok=True)
    ft, pre, fraud = generate_data(root)
    kernels = ["--attention_impl", "pallas", "--device", args.device]
    common = ["--model_size", "tiny", "--batch_size", "8"] + kernels

    print("=== 1. pretrain ===")
    from ..cli.pretrain import main as pretrain_main

    pre_out = os.path.join(root, "pretrain_ckpt")
    pretrain_main(["--data_path", pre, "--output_dir", pre_out,
                   "--num_train_epochs", "2", "--gradient_accumulation_steps", "1",
                   "--warmup_steps", "2", "--valid_step_interval", "100"] + common)

    print("=== 2. convert checkpoint ===")
    from ..cli.convert_ckpt import main as convert_main

    conv_out = os.path.join(root, "converted")
    convert_main(["--pretrain_ckpt", os.path.join(pre_out, "best.pt"),
                  "--output_dir", conv_out,
                  "--config", os.path.join(pre_out, "config.json"), "--device", args.device])

    print("=== 3. two-stage finetune ===")
    from ..cli.finetune import main as finetune_main

    ft_out = os.path.join(root, "finetune_ckpt")
    metrics = finetune_main([
        "--data_path", ft, "--output_dir", ft_out,
        "--pretrain_ckpt", os.path.join(conv_out, "seqrec.pt"),
        "--num_train_epochs", "2", "--verbose", "1",
        "--gradient_accumulation_steps", "1",
        "--finetune_negative_sample_size", "5",
        "--eval_batch_size", "8", "--encode_batch_size", "8"] + common)
    print("finetune test metrics:", json.dumps(metrics, indent=2))

    print("=== 4. zero-shot eval ===")
    from ..cli.evaluate_seq import main as eval_main

    zs = eval_main(["--data_path", ft, "--ckpt", os.path.join(conv_out, "seqrec.pt"),
                    "--model_size", "tiny", "--batch_size", "8",
                    "--encode_batch_size", "8"] + kernels)
    print("zero-shot metrics:", json.dumps(zs, indent=2))

    print("=== 5. fraud classification ===")
    from ..cli.finetune_classification import main as fraud_main

    fr = fraud_main(["--data_path", fraud,
                     "--output_dir", os.path.join(root, "fraud_ckpt"),
                     "--pretrain_ckpt", os.path.join(conv_out, "fraud.pt"),
                     "--num_train_epochs", "1", "--eval_batch_size", "8"] + common)
    print("fraud metrics:", {k: v for k, v in fr.items() if k != "confusion"})

    print("=== 6. clustering ===")
    from ..cli.cluster import main as cluster_main

    stats = cluster_main(["--data_path", ft, "--model_size", "tiny",
                          "--ckpt", os.path.join(conv_out, "seqrec.pt"),
                          "--batch_size", "8", "--min_clusters", "2",
                          "--max_clusters", "4",
                          "--output_dir", os.path.join(root, "clusters")] + kernels)
    print("cluster stats:", json.dumps(stats, indent=2))
    print("ALL STAGES COMPLETE")
    return {"finetune": metrics, "zero_shot": zs, "fraud": fr, "clusters": stats}


if __name__ == "__main__":
    main()
