#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the path, from the repository's sources;
3. kernel_check: each kernel against its plain PyTorch version on the same
   inputs, in float32 (max abs error <= 1e-4) and bfloat16 (<= 2e-2), at
   the shapes of the JAX kernel tests and at the two Recformer-base shapes;
4. kernel_time: the kernel, its plain version and one PyTorch library call
   (``scaled_dot_product_attention`` with an explicit band+global mask) at
   the base shapes, median of per-launch CUDA-event times, beside the least
   time the card could take for the same work;
5. serving: Recformer-base (random weights from ``--seed``) encodes a
   synthetic 10,000-item catalog, ranks it for 256 users, and the serve CLI
   answers a few users; launch counts show the main path ran the kernel.

Then the kernels line, the card line and, last, the result line. Without
CUDA, or without the package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 core
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BASE_SHAPES = {"item_tower": (256, 128), "sequence_tower": (16, 1024)}  # (B, L), H=12 D=64 W=64


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


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
              extra_global=False, max_globals=1):
    """Operands of the band-attention kernel on the card, built by the
    wrapper's own pre-processing. ``lengths``: valid tokens per row."""
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
    _, ops = prepare_band_inputs(q, k, v, mask, max_globals)
    ops["gout"] = (torch.randn(B, max_globals, H * D, generator=gen, device=dev) * 0.5).to(dtype)
    return ops


def check_case(name, gen, dtype, fuse=True, **kw):
    from recformer_tpu_torch.ops.window_attention import band_attention, window_attention_plain

    B, L, H, D, window = (kw.pop(x) for x in ("B", "L", "H", "D", "window"))
    ops = band_case(gen, B, L, H, D, window, dtype, **kw)
    out = band_attention(**ops, num_heads=H, window=window, fuse_epilogue=fuse)
    torch.cuda.synchronize()
    ref = window_attention_plain(**ops, num_heads=H, window=window, fuse_epilogue=fuse)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    rel = float((diff / ref.float().abs().clamp_min(1e-3)).max())
    ok = bool(torch.isfinite(out.float()).all()) and err <= TOL[dtype]
    emit("kernel_check", case=name, dtype=str(dtype).removeprefix("torch."),
         shape=[B, L, H, D], window=window, fused_epilogue=fuse, max_abs_err=err,
         max_rel_err=rel, tol_abs=TOL[dtype], ok=ok)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {name} {dtype}")
    return err


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


def useful_pairs(ops, window) -> int:
    """(query, key) pairs the local rows need: in-band local keys plus the
    valid global columns (global and padding rows are overwritten)."""
    half = window // 2
    keyloc = torch.nn.functional.pad(ops["keyloc"], (half, half))
    band = keyloc.unfold(1, window + 1, 1).sum(-1)  # (B, L)
    per_row = band + ops["gvalid"].sum(-1, keepdim=True)
    return int((per_row * (ops["mrow"] == 1)).sum())


def sdpa_call(ops, H, D, window):
    """One PyTorch call computing the local rows: SDPA with an explicit
    band+global boolean mask."""
    B, L, HD = ops["q2"].shape
    half = window // 2
    idx = torch.arange(L, device=ops["q2"].device)
    band = (idx[:, None] - idx[None, :]).abs() <= half
    allowed = band[None] & (ops["keyloc"] != 0)[:, None, :]
    gcol = ops["mrow"] == 2  # the kept global row enters as a key column
    allowed = (allowed | gcol[:, None, :])[:, None]  # (B, 1, L, L)
    q, k, v = (ops[n].view(B, L, H, D).transpose(1, 2) for n in ("q2", "k2", "v2"))
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed)


def time_kernels(gen):
    from recformer_tpu_torch.ops.window_attention import band_attention, window_attention_plain

    H, D, W = 12, 64, 64
    rows = {}
    rng = np.random.default_rng(1)
    for name, (B, L) in BASE_SHAPES.items():
        dtype = torch.bfloat16
        ops = band_case(gen, B, L, H, D, W, dtype,
                        lengths=rng.integers(L // 4, L + 1, size=B).tolist())
        kernel_ms = median_launch_ms(
            lambda: band_attention(**ops, num_heads=H, window=W, fuse_epilogue=True))
        plain_ms = median_launch_ms(
            lambda: window_attention_plain(**ops, num_heads=H, window=W, fuse_epilogue=True),
            n=20, warmup=2)
        library_ms = median_launch_ms(sdpa_call(ops, H, D, W))
        elt = ops["q2"].element_size()
        G = ops["gk"].shape[1]
        nbytes = (4 * B * L * H * D * elt + 3 * B * G * H * D * elt
                  + 2 * B * L * 4 + B * G * 4)
        ops_count = 4 * D * H * useful_pairs(ops, W)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_count / PEAK_OPS[dtype] * 1e3
        rows[name] = dict(shape=[B, L, H, D], window=W, dtype="bfloat16", ms=kernel_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          bytes=nbytes, operations=ops_count)
        emit("kernel_time", case=name, **rows[name])
    return rows


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
    from recformer_tpu_torch.ops import window_attention as wa
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

    wa.LAUNCHES = 0
    t0 = time.perf_counter()
    emb = encode_all_items(model, table, cfg, batch_size=enc_bs)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_launches = wa.LAUNCHES
    enc_forwards = math.ceil(n_items / enc_bs)
    if tuple(emb.shape) != (n_items, cfg.hidden_size) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"bad catalog embeddings {tuple(emb.shape)}")
    if enc_launches != n_layers * enc_forwards:
        raise AssertionError(f"encode launched the kernel {enc_launches} times, "
                             f"expected {n_layers * enc_forwards}")
    emit("serving_encode", items=n_items, batch=enc_bs, seq_len=cfg.item_seq_len,
         seconds=enc_s, items_per_s=n_items / enc_s, launches=enc_launches,
         forwards=enc_forwards, card=card)

    wa.LAUNCHES = 0
    t0 = time.perf_counter()
    metrics = evaluate_seqrec(model, table, ds, emb, cfg, batch_size=eval_bs)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = wa.LAUNCHES
    eval_forwards = math.ceil(n_users / eval_bs)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"bad eval metrics {metrics}")
    if eval_launches != n_layers * eval_forwards:
        raise AssertionError(f"eval launched the kernel {eval_launches} times, "
                             f"expected {n_layers * eval_forwards}")
    emit("serving_eval", users=n_users, batch=eval_bs, seq_len=cfg.max_token_num,
         seconds=eval_s, users_per_s=n_users / eval_s, launches=eval_launches,
         forwards=eval_forwards, metrics=metrics, card=card)

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
        wa.LAUNCHES = 0
        n = serve.main(["--data_path", tmp, "--sequences", os.path.join(tmp, "sequences.json"),
                        "--model_size", "base", "--attention_impl", "pallas",
                        "--batch_size", "4", "--encode_batch_size", "32", "--top_k", "10",
                        "--output", out, "--device", "cuda"])
        serve_launches = wa.LAUNCHES
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
    emit("serving_cli", users=n, launches=serve_launches, forwards=serve_forwards,
         first=rows[0])
    return enc_launches + eval_launches + serve_launches


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
    _build.load_library("band_attention_fwd")
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(_build.SOURCES))

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = check_kernels(gen)
    times = time_kernels(gen)
    launches = run_serving(args.seed, card)

    head = times["sequence_tower"]
    kernel = dict(
        name="band_attention_fwd", route="cuda",
        source="recformer_tpu_torch/ops/csrc/band_attention_fwd.cu",
        replaces="recformer_tpu/ops/pallas_attention.py:118",
        launches=launches,
        max_abs_err=max(errs[(n, torch.bfloat16)] for n in BASE_SHAPES),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        shape="sequence_tower", shapes=times, card=card)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
