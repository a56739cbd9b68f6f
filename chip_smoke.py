#!/usr/bin/env python3
"""Drive the PyTorch port's serving and pretraining paths once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the paths, from the repository's sources, one
   ``nvcc`` per source, all started together;
3. kernel_check: both attention kernels against their plain PyTorch versions
   on the same inputs, at the shapes of the JAX kernel tests, at the two
   Recformer-base shapes and at the tensor-core versions' edges (L off the
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
   dropout) at the base shapes, median of per-launch CUDA-event times and
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
   defaults (B 16, L 1024, H 12, D 64, W 64) at block_q 256, 128 and 16,
   with keyloc zero runs and invalid globals, and at irregular edges;
7c. probe_time: the probes' entry points (``python -m
   recformer_tpu_torch.benchmarks.kernel_ablation`` / ``.headpair_probe``)
   at block_q 256 and 16, each variant's CUDA-graph and host time beside
   kernel 1's graph time on the same inputs, the plain versions and the
   bound; the launches of this phase are the probe kernels' (their path);
8. serving: Recformer-base (random weights from ``--seed``) encodes a
   synthetic 10,000-item catalog, ranks it for 256 users, and the serve CLI
   answers a few users;
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
    pretrain_turns: both configurations timed in alternating blocks;
11. pretrain_vs_chunked and pretrain_ln_kernels_vs_plain: the float32
    gradients of one deterministic step through the attention kernels
    against the plain chunked attention, and through the LayerNorm kernels
    against the plain split LayerNorm: cosine > 0.999, and each attention
    projection's (each LayerNorm parameter's) gradient within 1e-3 relative;
12. pretrain_cli, pretrain_cli_ln_impl: ``cli.pretrain --model_size base
    --device cuda`` on a small corpus (accumulation 2, dev validation, best
    and last saved), then again with ``--ln_impl pallas_bwd``.

Launch counts, set to 0 just before each path and read just after, show that
the paths ran the kernels (each kernel on its path at least once; the
probes' path is probe_time), as many times as the code says they must (the
attention kernels' tensor-core launches among them: every forward of
serving, and all 24 forwards and 24 backwards of a bf16 step). Then
the kernels line, the card line and, last, the result line. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from recformer_tpu_torch.utils.timing import capture, card_line, graph_launch_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 core
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # forward, on max abs error
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # backward, each output's rel_err
BWD_OUTPUTS = ("dq", "dk", "dv", "dgk", "dgv", "dgout")
BASE_SHAPES = {"item_tower": (256, 128), "sequence_tower": (16, 1024)}  # (B, L), H=12 D=64 W=64


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    """Whether both kernels take their tensor-core versions (the C entry
    points' condition)."""
    return dtype == torch.bfloat16 and D == 64 and window == 64 and G <= 8


def check_case(name, gen, dtype, fuse=True, **kw):
    """Both kernels against their plain versions on one case: the forward at
    dropout 0 and 0.1 (same seed), the backward's six outputs at dropout 0
    and 0.1, each output bitwise equal on a second call, and the backward's
    path (tensor cores exactly where ``tensor_core_shape`` says). Returns the
    forward's max abs error at dropout 0 and the backward's largest abs
    error over its outputs and both rates."""
    from recformer_tpu_torch.ops import window_attention as wa
    from recformer_tpu_torch.ops.window_attention import (band_attention, band_attention_bwd,
                                                          window_attention_bwd_plain,
                                                          window_attention_plain)

    B, L, H, D, window = (kw.pop(x) for x in ("B", "L", "H", "D", "window"))
    ops = band_case(gen, B, L, H, D, window, dtype, **kw)
    common = dict(num_heads=H, window=window, fuse_epilogue=fuse)
    want_path = ("tensor_core" if tensor_core_shape(dtype, D, window, ops["gk"].shape[1])
                 else "cuda_core")
    fwd_err = bwd_err = 0.0
    for rate in (0.0, 0.1):
        drop = dict(dropout_rate=rate, seed=1234 + L)
        tc_before = wa.TC_LAUNCHES
        with torch.no_grad():
            out = band_attention(**ops, **common, **drop)
        torch.cuda.synchronize()
        path = "tensor_core" if wa.TC_LAUNCHES - tc_before == 1 else "cuda_core"
        ref = window_attention_plain(**ops, **common, **drop)
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype] and path == want_path
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
        tc_before = wa.BWD_TC_LAUNCHES
        got = band_attention_bwd(**ops, dout=dout, **common, **drop)
        again = band_attention_bwd(**ops, dout=dout, **common, **drop)
        torch.cuda.synchronize()
        path = "tensor_core" if wa.BWD_TC_LAUNCHES - tc_before == 2 else "cuda_core"
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
    for name, (B, L) in BASE_SHAPES.items():
        cases[name] = dict(B=B, L=L, H=12, D=64, window=64,
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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"band_\w+", e.name)
            k = m.group(0) if m else e.name[:40]
            ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return ms


def time_kernels(gen, card):
    """Both kernels at the two base shapes (bf16; attention dropout 0 and
    0.1), host-timed (median of back-to-back calls) and as device time from a
    CUDA graph, beside the plain versions, SDPA (forward, and its backward,
    both without dropout: the like-for-like figure is the kernels' dropout-0
    time) and the bound; the backward's device time also by pass."""
    from recformer_tpu_torch.ops import window_attention as wa

    H, D, W = 12, 64, 64
    rate = 0.1
    rows = {"band_attention_fwd": {}, "band_attention_bwd": {}}
    rng = np.random.default_rng(1)
    for name, (B, L) in BASE_SHAPES.items():
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
            earlier_ms=EARLIER_MS["band_attention_fwd"][name], card=card)
        emit("kernel_time", kernel="band_attention_fwd", case=name,
             **rows["band_attention_fwd"][name])

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


def kernels_per_call(fn) -> list:
    """The names of the device kernels one call of ``fn`` runs (after a
    warm-up call), from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

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
    head pair L = 64 < block_q + W (one band, offsets 0) and L = 208."""
    from recformer_tpu_torch.benchmarks import headpair_probe as hp
    from recformer_tpu_torch.ops import band_probes as bp

    cases = [("defaults", dict(B=16, L=1024, H=12, W=64, G=1), PROBE_BLOCKS),
             ("zero_keys_invalid_globals",
              dict(B=4, L=1024, H=12, W=64, G=2, zero_runs=((0, 100, 5), (1, 300, 80), (2, 0, 40)),
                   invalid_globals=((1, 0), (1, 1), (3, 1))), PROBE_BLOCKS),
             ("L1008_G8", dict(B=2, L=1008, H=4, W=64, G=8, zero_runs=((0, 500, 70),),
                               invalid_globals=((0, 3), (1, 7))), (48, 16, 112)),
             ("W32", dict(B=2, L=512, H=4, W=32, G=1), (256, 16))]
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
                ok = (out.dtype == torch.bfloat16 and out.shape == ins["q"].shape
                      and bool(torch.isfinite(ref).all()) and err <= PROBE_TOL)
                errs[("band_ablation", case, v, bq)] = (err, float((out.float() - ref.float())
                                                               .abs().max()))
                emit("probe_check", kernel="band_ablation", case=case, variant=v, block_q=bq,
                     rel_err=err, ok=ok)
                if not ok:
                    raise AssertionError(f"band_ablation {case} {v} block_q {bq}: rel_err {err}")
    hp_cases = [("defaults", dict(B=16, L=1024, P=6, W=64), PROBE_BLOCKS),
                ("L1008", dict(B=2, L=1008, P=2, W=64), (48, 16)),
                ("L64", dict(B=2, L=64, P=2, W=64), (16, 64)),
                ("L208_W32", dict(B=2, L=208, P=2, W=32), (16, 208))]
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
    inputs in the same call, the plain versions' host time at block_q 256
    and the bound. Returns the rows and the probe kernels' launches."""
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
                bytes=nbytes, operations=ops, kernel1_ms=r["kernel1_ms"],
                plain_ms=abl_plain[v] if bq == 256 else None)
        emit("probe_time", kernel="band_ablation", block_q=bq,
             graph_ms={v: r[f"{v}_ms"] for v in bp.ABLATION_VARIANTS},
             host_ms={v: r[f"{v}_host_ms"] for v in bp.ABLATION_VARIANTS},
             kernel1_graph_ms=r["kernel1_ms"], kernel1_host_ms=r["kernel1_host_ms"], card=card)
    for bq, r in hpr.items():
        for v in bp.HEADPAIR_VARIANTS:
            b_ms, b_by, nbytes, ops = probe_bound("band_headpair", v, bq, hp.B, hp.L, 2 * hp.P,
                                                  hp.W, 0)
            rows["band_headpair"][f"{v}@{bq}"] = dict(
                ms=r[f"{v}_ms"], host_ms=r[f"{v}_host_ms"], bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, operations=ops, plain_ms=hp_plain if bq == 256 else None)
        emit("probe_time", kernel="band_headpair", block_q=bq,
             graph_ms={v: r[f"{v}_ms"] for v in bp.HEADPAIR_VARIANTS},
             host_ms={v: r[f"{v}_host_ms"] for v in bp.HEADPAIR_VARIANTS}, card=card)
    missing = [k for k in PROBE_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"probe_time: {missing} never launched")
    return rows, counts


# ---------------------------------------------------------------------------
# the serving path at full base width
# ---------------------------------------------------------------------------

def write_corpus(root, n_items=64, n_users=8, seed=0):
    rng = np.random.default_rng(seed)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan", "oak", "tin", "zinc"]
    meta = {f"I{i:03d}": {"make": " ".join(rng.choice(words, 3)),
                          "hue": " ".join(rng.choice(words, 2)), "size": str(i)}
            for i in range(n_items)}
    smap = {f"I{i:03d}": i for i in range(n_items)}
    seqs = {f"u{u}": [int(x) for x in rng.integers(0, n_items, size=rng.integers(3, 12))]
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


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from recformer_tpu_torch.ops import band_probes as bp
    from recformer_tpu_torch.ops import embed_layernorm as tel
    from recformer_tpu_torch.ops import layernorm as tln
    from recformer_tpu_torch.ops import window_attention as wa

    wa.LAUNCHES = wa.TC_LAUNCHES = wa.BWD_LAUNCHES = wa.BWD_TC_LAUNCHES = 0
    tel.LAUNCHES = tel.BWD_LAUNCHES = tln.BWD_LAUNCHES = 0
    bp.ABLATION_LAUNCHES = bp.HEADPAIR_LAUNCHES = 0


def read_counts() -> dict:
    """Every count of COUNTERS since the last reset."""
    from recformer_tpu_torch.ops import band_probes as bp
    from recformer_tpu_torch.ops import embed_layernorm as tel
    from recformer_tpu_torch.ops import layernorm as tln
    from recformer_tpu_torch.ops import window_attention as wa

    return dict(zip(COUNTERS, (wa.LAUNCHES, wa.BWD_LAUNCHES, tel.LAUNCHES, tel.BWD_LAUNCHES,
                               tln.BWD_LAUNCHES, wa.TC_LAUNCHES, wa.BWD_TC_LAUNCHES,
                               bp.ABLATION_LAUNCHES, bp.HEADPAIR_LAUNCHES)))


def all_on_tensor_cores(what) -> tuple:
    """The attention forward's launches since the last reset, and those of
    them on the tensor cores; raises unless they are all (bf16, base width)."""
    counts = read_counts()
    n, tc = counts["band_attention_fwd"], counts["band_attention_fwd_tc"]
    if tc != n:
        raise AssertionError(f"{what}: {n - tc} of {n} attention forwards left the tensor cores")
    return n, tc


def launches_per_step(cfg) -> dict:
    """Launches of each kernel one pretraining step makes, by reading the
    code: two towers, each one fused (2B, L) forward and its backward; the
    attention kernels once per layer, the embedding kernels once per tower,
    the LayerNorm backward twice per layer (the attention and feed-forward
    blocks); the LM head's LayerNorm is flax's under every flag. In bf16
    at the base head width and window every attention forward and backward
    takes the tensor-core kernels. A step launches no probe kernel."""
    towers, layers = 2, cfg.num_hidden_layers
    emb = towers if cfg.embed_ln_impl == "pallas" else 0
    D = cfg.hidden_size // cfg.num_attention_heads
    tc = sum(tensor_core_shape(cfg.compute_dtype, D, w, 1) for w in cfg.attention_window)
    return {"band_attention_fwd": towers * layers, "band_attention_bwd": towers * layers,
            "band_attention_fwd_tc": towers * tc, "band_attention_bwd_tc": towers * tc,
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
                       steps=10):
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
    cos = float(torch.nn.functional.cosine_similarity(
        torch.cat([g.flatten() for g in ga.values()]),
        torch.cat([gb[n].flatten() for n in ga]), dim=0))
    total = sum(float(g.norm() ** 2) for g in gb.values())
    share = {n: float(g.norm() ** 2) / total for n, g in gb.items()}
    rel = {n: float((g - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)) for n, g in ga.items()}
    del ga, gb
    torch.cuda.empty_cache()
    return cos, share, rel, loss_a, loss_b


def gate_grads(phase, pattern, min_gated, cos, share, rel, **record):
    """cosine > 0.999, and every tensor whose name matches ``pattern`` and
    that carries more than 1e-10 of the squared norm within 1e-3 relative."""
    gated = [n for n in rel if pattern.search(n) and share[n] > 1e-10]
    worst = max(gated, key=rel.get)
    worst_any = max(rel, key=rel.get)
    ok = cos > 0.999 and len(gated) >= min_gated and rel[worst] <= 1e-3
    emit(phase, dtype="float32", grad_cosine=cos, **record, tensors_gated=len(gated),
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


def run_pretrain_cli(seed, phase="pretrain_cli", extra=()):
    """``cli.pretrain --model_size base --device cuda`` (plus ``extra``) on a
    small corpus: one epoch with accumulation 2, dev validation, best and
    last saved."""
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
                             *extra])
        counts = read_counts()
        written = sorted(os.listdir(out_dir))
        cfg = RecformerConfig.load(os.path.join(out_dir, "config.json"))
    per_step = launches_per_step(cfg)
    # every step runs forward and backward; the one dev validation runs the
    # two towers' forward once more
    expected = {k: v * res["steps"] for k, v in per_step.items()}
    expected["band_attention_fwd"] += per_step["band_attention_fwd"]
    expected["band_attention_fwd_tc"] += per_step["band_attention_fwd_tc"]
    expected["embed_layernorm_fwd"] += per_step["embed_layernorm_fwd"]
    ok = (res["steps"] == 3 and res["updates"] == 1 and {"best.pt", "last.pt"} <= set(written)
          and counts == expected)
    emit(phase, **res, args=list(extra), ln_impl=cfg.ln_impl, written=written, launches=counts,
         expected_launches=expected, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: {res}, {written}, launches {counts} "
                             f"(expected {expected})")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from recformer_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("environment", device=kind, card=card, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load_library(name)
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(_build.SOURCES))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = check_kernels(gen)
    dropout_check(gen, card)
    times = time_kernels(gen, card)
    ln_errs = check_ln_kernels(gen)
    ln_times = time_ln_kernels(gen, card)
    probe_errs = check_probes()
    probe_times, probe_counts = time_probes(card)
    phases = {"probe_time": probe_counts, "serving": run_serving(args.seed, card),
              "encode_embed_kernel": run_encode_embed_kernel(args.seed, card),
              "offline_clis": run_offline_clis(args.seed, card)}
    phases["pretrain_step"], default_rates = run_pretrain_step(args.seed, card)
    phases["pretrain_step_ln_kernels"], _ = run_pretrain_step(
        args.seed, card, phase="pretrain_step_ln_kernels", baseline=default_rates,
        embed_ln_impl="pallas", ln_impl="pallas_bwd")
    run_pretrain_turns(args.seed, card)
    run_pretrain_vs_chunked(args.seed)
    run_pretrain_ln_kernels_vs_plain(args.seed)
    phases["pretrain_cli"] = run_pretrain_cli(args.seed)
    phases["pretrain_cli_ln_impl"] = run_pretrain_cli(
        args.seed, phase="pretrain_cli_ln_impl", extra=("--ln_impl", "pallas_bwd"))

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
            err = max(errs[(n, torch.bfloat16)][name == "band_attention_bwd"]
                      for n in BASE_SHAPES)
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
        rows = probe_times[name]
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
            variants=rows, card=card)

    kernels = [kernel_row(name) for name in KERNELS] + [probe_row(n) for n in PROBE_KERNELS]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
