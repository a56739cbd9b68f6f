#!/usr/bin/env python3
"""Where the LayerNorm backward kernels' time goes, step by step, on one card.

    python3 scripts/profile_torch_ln_bwd.py [--rows 2048 16384]

``ncu`` does not run on the card's machine, so this builds copies of
kernels 4 and 5 (``ops/csrc/embed_layernorm.cu``, ``layernorm_bwd.cu``,
their shared ``row_reduce.cuh`` body) that leave after a step of the body:

- ``rows``: after the rows (dx written; dgamma/dbeta's sums dead, so the
  compiler drops their accumulation too);
- ``block``: after the block's row of partials;
- ``barrier``: after the grid barrier;
- ``full``: the kernel as it is;
- ``empty``: at once (the launch alone).

Each copy is built with ``nvcc`` into ``recformer_tpu_torch/_build/steps/``
and timed by CUDA-graph replay (``chip_smoke.graph_launch_ms``) at each
row count, bf16, H = 768. Prints one JSON line per copy and the card line;
the difference between two steps is what that step adds to a call.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "recformer_tpu_torch", "ops", "csrc")  # the kernels as they are

LEAVE = "  if (M >= 0) return;\n"
# step -> (marker in row_reduce.cuh, text put in its place)
STEPS = {
    "empty": ("  const int stride = gridDim.x * P::kWarps;\n",
              "  const int stride = gridDim.x * P::kWarps;\n" + LEAVE),
    "rows": ("  band::cp_async_wait<0>();\n  __syncwarp();",
             "  band::cp_async_wait<0>();\n" + LEAVE + "  __syncwarp();"),
    "block": ("  // 3. every block's row written", LEAVE + "  // 3. every block's row written"),
    "barrier": ("  grid_barrier(arrivals, open);\n", "  grid_barrier(arrivals, open);\n" + LEAVE),
    "full": None,
}


def copy_sources(step: str, build_root: str) -> str:
    """csrc/ copied under ``build_root/step`` with the step's edit."""
    d = os.path.join(build_root, step)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, os.path.join(d, "csrc"))
    if STEPS[step] is not None:
        marker, text = STEPS[step]
        path = os.path.join(d, "csrc", "row_reduce.cuh")
        with open(path) as f:
            src = f.read()
        if marker not in src:
            raise RuntimeError(f"{step}: marker not found in row_reduce.cuh: {marker!r}")
        with open(path, "w") as f:
            f.write(src.replace(marker, text, 1))
    return d


def point_build_at(d: str) -> None:
    """Make ``_build`` build and load the copy in ``d``."""
    from recformer_tpu_torch.ops import _build

    csrc = os.path.join(d, "csrc")
    _build.SOURCES = {n: os.path.join(csrc, os.path.basename(p)) for n, p in _build.SOURCES.items()}
    _build.HEADERS = tuple(os.path.join(csrc, os.path.basename(h)) for h in _build.HEADERS)
    _build.BUILD_DIR = os.path.join(d, "_build")
    _build._LOADED.clear()


def time_step(step: str, build_root: str, rows) -> dict:
    """One copy's graph device time per call of kernels 4 and 5."""
    from chip_smoke import LN_EPS, graph_launch_ms, ln_case
    from recformer_tpu_torch.ops import embed_layernorm as tel
    from recformer_tpu_torch.ops import layernorm as tln

    point_build_at(os.path.join(build_root, step))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"step": step}
    for M in rows:
        adds, x, gamma, _, dout = ln_case(gen, M, 768, torch.bfloat16)
        out[f"layernorm_bwd_{M}_ms"] = graph_launch_ms(
            lambda: tln.layernorm_bwd(x, gamma, dout, LN_EPS))
        out[f"embed_layernorm_bwd_{M}_ms"] = graph_launch_ms(
            lambda: tel.embed_layernorm_bwd(*adds, gamma, dout, LN_EPS))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[2048, 16384])
    ap.add_argument("--step", choices=list(STEPS), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_ln_bwd: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    from recformer_tpu_torch.ops import _build

    build_root = os.path.join(_build.BUILD_DIR, "steps")
    if args.step:  # one copy, in a process of its own (each loads its libraries once)
        print(json.dumps(time_step(args.step, build_root, args.rows)), flush=True)
        return 0
    jobs = []
    for step in STEPS:  # one nvcc per source and copy, all started together
        point_build_at(copy_sources(step, build_root))
        jobs += [(lib, _build._start_build(lib)) for lib in ("layernorm_bwd", "embed_layernorm")]
    for lib, job in jobs:
        if job is not None:
            _build._finish_build(lib, job)
    for step in STEPS:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--step", step,
                              "--rows", *map(str, args.rows)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
