"""Head-pair probe of the band products on the card: ``(q . k^T) . v`` over
each query block's band, per head (64-lane tiles) or per head pair (one
128-lane product against block-diagonal K and V)
(``ops/band_probes.py::band_headpair``, TPU kernel 7).

    python -m recformer_tpu_torch.benchmarks.headpair_probe [--block-q 256] [--iters 50]

Counterpart of ``benchmarks/headpair_probe.py``, at its shapes (B 16,
L 1024, 6 head pairs, W 64, bf16, q/k/v ~ 0.3 N(0, 1) from ``--seed``).
Prints one JSON line with the same ``shapes``, ``perhead_ms`` and
``pair_ms`` keys, here the device time per call from a CUDA graph of
``--iters`` calls, plus ``<variant>_host_ms`` (back-to-back calls on the
host's clock) and the card's name and power limit. Runs on ``cuda`` only.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import band_probes
from ..utils.device import resolve_device
from ..utils.timing import card_line, graph_launch_ms, host_ms

B, L, P, W = 16, 1024, 6, 64  # 12 heads = 6 pairs


def make_inputs(seed: int = 0, device="cuda", B=B, L=L, P=P):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(B, L, P * 128, generator=gen, device=device) * 0.3).bfloat16()
            for _ in range(3)]


def variant_call(qkv, variant: str, block_q: int, window: int = W):
    q, k, v = qkv
    return lambda: band_probes.band_headpair(q, k, v, variant=variant, block_q=block_q,
                                             window=window)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--block-q", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    qkv = make_inputs(args.seed, device)
    out = {"shapes": f"B{B} L{L} pairs{P} W{W} block{args.block_q}"}
    with torch.no_grad():
        for v in band_probes.HEADPAIR_VARIANTS:
            fn = variant_call(qkv, v, args.block_q)
            out[v + "_ms"] = graph_launch_ms(fn, args.iters)
            out[v + "_host_ms"] = host_ms(fn, args.iters)
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
