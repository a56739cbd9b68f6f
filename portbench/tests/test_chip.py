"""On the card, at the cells' own sizes: a run is correct, and the control
(the reference computed in fp8, in the program's place) is not.

    python3 -m pytest portbench/tests/test_chip.py -m chip

Skips where no CUDA card is present."""

import json
import subprocess
import sys

import pytest

from portbench import manifest, run

BENCH = manifest.load_manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", "2718281828", "--seconds", "3", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_full_size(card, workload):
    cell = manifest.find_cell(BENCH, workload, 3141592653, "cuda")
    out = run.run_cell(cell, BENCH, 1.0, False)
    readings = out["driver"].control()
    assert any(v > cell.limits[k] for k, v in readings.items() if k in cell.limits), readings
