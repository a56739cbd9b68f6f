"""Ablation probe of the windowed-attention forward on the card: time the
band kernel with parts removed (``ops/band_probes.py::band_ablation``, TPU
kernel 6) beside kernel 1 itself on the same inputs.

    python -m recformer_tpu_torch.benchmarks.kernel_ablation [--block-q 256] \\
        [--variants dots_only,no_softmax,no_mask,band_softmax,full] [--iters 50]

Counterpart of ``benchmarks/kernel_ablation.py``, at its shapes (B 16,
L 1024, H 12, D 64, W 64, one global key, bf16, inputs from ``--seed``).
Prints one JSON line with the same ``<variant>_ms`` keys, here the device
time per call from a CUDA graph of ``--iters`` calls, plus
``<variant>_host_ms`` (back-to-back calls on the host's clock),
``kernel1_ms``/``kernel1_host_ms`` (the attention forward kernel on the
same q/k/v, keys and global) and the card's name and power limit. Runs on
``cuda`` only.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import band_probes
from ..ops import window_attention as wa
from ..utils.device import resolve_device
from ..utils.timing import card_line, graph_launch_ms, host_ms

B, L, H, D, W, G = 16, 1024, 12, 64, 64, 1


def make_inputs(seed: int = 0, device="cuda", B=B, L=L, H=H, W=W, G=G) -> dict:
    """The reference script's inputs: q, K and V ~ 0.5 N(0, 1) in bf16, K/V
    and keyloc padded by W/2 rows at each end (keyloc 1 inside, 0 in the
    padding), the first G query rows as global keys and values, all valid."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = lambda: (torch.randn(B, L, H * D, generator=gen, device=device) * 0.5).bfloat16()
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, W // 2, W // 2))
    q = f()
    keyloc = pad(torch.ones(B, L, 1, dtype=torch.int32, device=device))
    return dict(q=q, kpad=pad(f()), vpad=pad(f()), keyloc=keyloc, gk=q[:, :G].contiguous(),
                gv=q[:, :G].contiguous(),
                gvalid=torch.ones(B, 1, G, dtype=torch.int32, device=device))


def variant_call(ins: dict, variant: str, block_q: int, window: int = W, num_heads: int = H):
    return lambda: band_probes.band_ablation(**ins, variant=variant, block_q=block_q,
                                             window=window, num_heads=num_heads)


def kernel1_call(ins: dict, window: int = W, num_heads: int = H):
    """Kernel 1 (``window_attention.band_attention``, no dropout) on the
    probe's q, its unpadded K/V and keyloc, and its global keys: every row a
    local query, so the fused epilogue is off."""
    half = window // 2
    q = ins["q"]
    B_, L_, _ = q.shape
    G_ = ins["gk"].shape[1]
    ops = dict(q2=q, k2=ins["kpad"][:, half:half + L_].contiguous(),
               v2=ins["vpad"][:, half:half + L_].contiguous(),
               keyloc=ins["keyloc"][:, half:half + L_, 0].contiguous(), gk=ins["gk"],
               gv=ins["gv"], gvalid=ins["gvalid"].reshape(B_, G_).contiguous(),
               mrow=torch.ones(B_, L_, dtype=torch.int32, device=q.device),
               gout=torch.zeros_like(ins["gk"]))
    return lambda: wa.band_attention(**ops, num_heads=num_heads, window=window,
                                     fuse_epilogue=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--block-q", type=int, default=256)
    ap.add_argument("--variants", type=str, default=",".join(band_probes.ABLATION_VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    ins = make_inputs(args.seed, device)
    out = {"block_q": args.block_q}
    with torch.no_grad():
        for v in args.variants.split(","):
            fn = variant_call(ins, v, args.block_q)
            out[v + "_ms"] = graph_launch_ms(fn, args.iters)
            out[v + "_host_ms"] = host_ms(fn, args.iters)
        fn = kernel1_call(ins)
        out["kernel1_ms"] = graph_launch_ms(fn, args.iters)
        out["kernel1_host_ms"] = host_ms(fn, args.iters)
    out["shape"] = dict(B=B, L=L, H=H, D=D, W=W, G=G, dtype="bfloat16")
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
