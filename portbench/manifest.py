"""The manifest (``BENCHMARK.json`` at the checkout's root) and the files it
names: a cell is a (configuration, traffic) pair; the configuration is
``configs/<config>.json``, the traffic ``traffic/<traffic>.json`` (which
names its driver, ``drivers/<driver>.py``), the limits of the cell's
comparison ``limits/<cell>.json``, and each per-layer metric's reader
``metrics/<name before the first dot>.py``. Adding a cell, a configuration
or a metric adds files and entries; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_manifest(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_config(name: str):
    """(RecformerConfig, the file's whole document)."""
    from recformer_tpu_torch.config import RecformerConfig

    doc = _json("configs", f"{name}.json")
    fields = {f.name for f in dataclasses.fields(RecformerConfig)}
    return RecformerConfig(**{k: v for k, v in doc.items() if k in fields}), doc


def load_traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def load_limits(cell: str) -> Dict[str, float]:
    path = os.path.join(HERE, "limits", f"{cell}.json")
    if not os.path.exists(path):
        return {}
    return _json("limits", f"{cell}.json")["limits"]


def driver_module(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<base>.py``'s ``read``,
    loaded by file path (a metric's name may hold dots)."""
    base = name.split(".")[0]
    path = os.path.join(HERE, "metrics", f"{base}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Any
    config_doc: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    device: Any


def find_cell(manifest: dict, workload: str, seed: int, device) -> Cell:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            cfg, doc = load_config(w["config"])
            return Cell(w["name"], w["config"], w["traffic"], w["chips"], cfg, doc,
                        load_traffic(w["traffic"]), load_limits(w["name"]), seed, device)
    raise SystemExit(f"no workload {workload!r} in the manifest")


def metrics_of(manifest: dict, workload: str, section: str) -> List[dict]:
    """The manifest's metrics of ``section`` that ``workload`` reports: those
    that list it, and those without a list (a per-layer metric without one
    goes wherever the end-to-end metric it moves is reported)."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    if section == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
