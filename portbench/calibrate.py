"""The readings that a cell's limits are set from, on the card:

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3] [--out FILE]

For each seed, a run of the cell (a short window; a training cell's
readings come from its set-up's first updates) and the program's readings
against the reference; on the control seeds the control's (the reference
computed in fp8, in the program's place); on the fault seeds, for a
training cell, the half-batch fault's (the reference's loss over half the
batch, in the program's place). One JSON line a reading, on standard
output and appended to ``--out``. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import manifest, run


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    bench = manifest.load_manifest()
    controls, faults = set(_ints(args.control_seeds)), set(_ints(args.fault_seeds))

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in _ints(args.seeds):
        t0 = time.perf_counter()
        cell = manifest.find_cell(bench, args.workload, seed, "cuda")
        out = run.run_cell(cell, bench, args.seconds, False)
        d = out.pop("driver")
        emit({"workload": args.workload, "seed": seed, "who": "program",
              "readings": out["readings"],
              "units": out["attempted"], "phases": out["phases"],
              "s": time.perf_counter() - t0})
        if seed in controls:
            emit({"workload": args.workload, "seed": seed, "who": "control_fp8",
                  "readings": d.control()})
        if seed in faults and hasattr(d, "fault"):
            emit({"workload": args.workload, "seed": seed, "who": "fault_half_batch",
                  "readings": d.fault("half_batch")})
        del d, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
