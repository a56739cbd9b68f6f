"""The benchmark of ``recformer_tpu_torch`` on the card: one run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic and driver by the names in
``BENCHMARK.json``; the driver's set-up makes the corpus and the weights
from the seed, builds the program's entry and warms up the cell's shapes
(``setup_s``, from the process's start); then the cell's units run in a
closed loop for ``--seconds`` (the end-to-end metrics). With ``--trace 1``
the per-layer metrics instead: the same unprofiled window, then a profiled
stretch of the driver's ``profile_units`` units. After the window the
program's state is freed and the driver compares what the timed path
produced with the plain reference (``portbench/reference/``); each number
compared is printed beside its limit, last on standard error and last in
the result line, the one JSON object on standard output's last line.

Exits non-zero without a result when CUDA is missing or has fewer cards
than the cell asks for, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import os
import sys
import time

PROCESS_START = time.perf_counter()

# The command's Python bytecode is cached at a fixed path inside the
# checkout: where the installation ships no compiled bytecode or the
# environment sets PYTHONDONTWRITEBYTECODE, every run would otherwise
# compile torch's sources (and torch._dynamo's, which the optimizer
# imports) again in its set-up. Only a checkout's first run compiles them.
if __name__ == "__main__":
    sys.pycache_prefix = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                      ".pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import torch  # noqa: E402

from . import flops, manifest  # noqa: E402
from .drivers.common import SETUP_MARKS, mark  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "recformer_tpu")


@dataclass
class Window:
    start: int  # the first unit's index
    units: int
    wall_s: float


@dataclass
class TraceContext:
    stretch: object
    window_flops: float
    window_wall_s: float
    kernel_work: dict


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell, bench: dict, seconds: float, trace: bool) -> dict:
    """Set-up, window, (trace), check. Returns the result's parts."""
    dev = cell.device
    cuda = torch.device(dev).type == "cuda"
    SETUP_MARKS.clear()
    mark("imports")
    if cuda:
        torch.empty(1, device=dev)
        mark("CUDA")
    driver = manifest.driver_module(cell.traffic["driver"]).Driver(cell)
    _sync(dev)
    setup_s = time.perf_counter() - PROCESS_START
    ends = [PROCESS_START] + [t for _, t in SETUP_MARKS]
    setup_phases = {name: ends[i + 1] - ends[i] for i, (name, _) in enumerate(SETUP_MARKS)}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    start = driver.units_done
    done_at = []
    t0 = time.perf_counter()
    while True:
        driver.unit()
        done_at.append(time.perf_counter() - t0)
        if done_at[-1] >= seconds:
            break
    _sync(dev)
    window = Window(start, driver.units_done - start, time.perf_counter() - t0)
    # units a second in each quarter of the window (host clock): how steady it ran
    quarters = [sum(1 for t in done_at if q * window.wall_s / 4 <= t < (q + 1) * window.wall_s / 4)
                / (window.wall_s / 4) for q in range(4)]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = driver.end_to_end(window)
    e2e["train_peak_gib"] = window_peak / 2 ** 30
    e2e["setup_s"] = setup_s

    metrics, device, breakdown = {}, {}, None
    wanted = manifest.metrics_of(bench, cell.name, "per_layer" if trace else "end_to_end")
    if trace:
        if not cuda:
            raise RuntimeError("--trace 1 reads the card's profiler trace")
        from . import trace as tr

        driver.align()
        first = driver.units_done
        stretch = tr.profile(driver.unit, driver.profile_units)
        ctx = TraceContext(stretch, driver.window_flops(window.start, window.start + window.units),
                           window.wall_s, driver.kernel_work(first, first + driver.profile_units))
        for m in wanted:
            value = manifest.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = {"busy_s": stretch.busy_s, "window_s": stretch.window_s}
        breakdown = stretch.breakdown()
    else:
        for m in wanted:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())

    t_trace = time.perf_counter()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {', '.join(found)} (JAX or the JAX package)")
    valid_share = driver.valid_share()
    driver.free()
    if cuda:
        torch.cuda.empty_cache()
    # the reference computes in float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    readings = driver.check()
    phases = {"setup_s": setup_s, "window_s": window.wall_s,
              "trace_s": t_trace - t0 - window.wall_s, "check_s": time.perf_counter() - t_check}
    missing = set(cell.limits) - set(readings)
    if missing:
        raise RuntimeError(f"limits name numbers the check does not read: {sorted(missing)}")
    # the numbers compared: those the cell's limits name (all, before it has any)
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in readings.items()
              if k in cell.limits or not cell.limits}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": window.units, "failed": 0, "metrics": metrics,
            "device": device, "breakdown": breakdown, "checks": checks,
            "memory_peak_bytes": peak, "valid_share": valid_share, "window": window,
            "phases": phases, "setup_phases": setup_phases, "readings": readings, "quarters": quarters,
            "driver": driver}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load_manifest()
    spec = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if spec is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: the cell needs {spec['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    cell = manifest.find_cell(bench, args.workload, args.seed, "cuda")
    out = run_cell(cell, bench, args.seconds, bool(args.trace))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"]), **out["device"]}
    w = out["window"]
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"window: {w.units} {manifest.driver_module(cell.traffic['driver']).Driver.unit_name}s "
          f"in {w.wall_s!r} s; valid-token share {out['valid_share']!r}", file=sys.stderr)
    print("phases: " + ", ".join(f"{k} {v!r}" for k, v in out["phases"].items()),
          file=sys.stderr)
    print("set-up by phase (s): " + ", ".join(f"{k} {v!r}" for k, v in out["setup_phases"].items()),
          file=sys.stderr)
    print("units a second by quarter of the window: "
          + " ".join(repr(q) for q in out["quarters"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
