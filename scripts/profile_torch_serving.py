#!/usr/bin/env python3
"""Where the time goes in the port's serving path, on one CUDA card.

    python3 scripts/profile_torch_serving.py [--chunks 8] [--batches 8] [--seed 0]

Runs Recformer-base (random weights from ``--seed``, bf16 compute, the
windowed-attention kernel) over ``--chunks`` item-encode chunks (256 items,
L=128) and ``--batches`` eval batches (16 users, L=1024) under
``torch.profiler``, after one warm-up and one unprofiled timed run of each.
Prints one JSON line per task: wall time with and without the profiler,
device busy time (the union of kernel intervals), the device's idle share
against each wall time, the kernels launched, and the top kernels by device
time with their shares, then the card line from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_kernels, synthetic_table  # noqa: E402
from recformer_tpu_torch.utils.timing import busy_ms  # noqa: E402


def profile(name, fn, top=15, groups=None, per=1):
    """Profile one call of ``fn`` after a warm-up call and one unprofiled
    timed call (the profiler slows the host, so the idle share is given
    against both wall times). ``groups`` maps a kernel name to a group whose
    device time is summed; ``per`` divides the kernel count (kernels per
    step)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.events())
    busy = busy_ms(kernels)
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(by_kernel.values()) or 1.0
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    line = {"task": name, "wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
            "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
            "device_idle_share_unprofiled": 1.0 - busy / plain_wall_ms,
            "kernel_ms_total": total, "device_kernels": len(kernels) / per}
    if groups is not None:
        by_group = {}
        for k, v in by_kernel.items():
            by_group[groups(k)] = by_group.get(groups(k), 0.0) + v
        line["by_group"] = {g: {"ms": v, "share": v / total} for g, v in by_group.items()}
    line["top_kernels"] = [{"name": k[:120], "ms": v, "share": v / total} for k, v in rows]
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serving: CUDA is not available", file=sys.stderr)
        return 1
    from recformer_tpu_torch.cli.common import init_model_params
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.models.heads import RecformerForSeqRec
    from recformer_tpu_torch.training.steps import make_encode_items_step, make_eval_step

    dev = torch.device("cuda")
    cfg = RecformerConfig.base()
    model = init_model_params(RecformerForSeqRec(cfg), cfg, device="cuda", seed=args.seed)
    n_items = 10_000
    table = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_table(cfg, n_items, args.seed).items()}
    rng = np.random.default_rng(args.seed + 1)
    chunks = torch.from_numpy(rng.integers(0, n_items, size=(args.chunks, 256))
                              .astype(np.int32)).to(dev)
    B, S = 16, 32
    ids = torch.from_numpy(rng.integers(0, n_items, size=(args.batches, B, S))
                           .astype(np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(16, S + 1, size=(args.batches, B))
                            .astype(np.int32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, n_items, size=(args.batches, B))
                              .astype(np.int32)).to(dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    emb = torch.randn(n_items, cfg.hidden_size, device=dev)
    encode = make_encode_items_step(cfg, model)
    evaluate = make_eval_step(cfg, model)

    profile("encode", lambda: [encode(table, c) for c in chunks])
    profile("eval", lambda: [evaluate(table, ids[i], lens[i], labels[i], valid, emb)
                             for i in range(args.batches)])
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(out.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
