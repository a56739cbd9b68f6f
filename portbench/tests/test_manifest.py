"""Every entry of ``BENCHMARK.json`` resolves, by name, to the files of its
own: configuration, traffic, driver, limits, metric readers."""

import os
import re

import pytest

from portbench import manifest

BENCH = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_resolves(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    cfg, doc = manifest.load_config(config)
    assert doc["reduced"] == entry["reduced"]
    assert cfg.hidden_size == doc["hidden_size"] and cfg.num_hidden_layers == doc["num_hidden_layers"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(workload):
    cell = manifest.find_cell(BENCH, workload, 1, "cpu")
    driver = manifest.driver_module(cell.traffic["driver"]).Driver
    for attr in ("unit", "end_to_end", "window_flops", "kernel_work", "check", "control", "free"):
        assert callable(getattr(driver, attr))
    assert cell.limits, f"no limits/{workload}.json"
    e2e = manifest.metrics_of(BENCH, workload, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    per_layer = manifest.metrics_of(BENCH, workload, "per_layer")
    assert per_layer
    for m in per_layer:
        assert callable(manifest.metric_reader(m["name"]))
        assert m["moves"] in [e["name"] for e in e2e]


def test_paths_hold_the_benchmark_only():
    assert BENCH["paths"] == ["portbench"]
    assert os.path.isdir(os.path.join(manifest.ROOT, "portbench"))
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]


def test_per_layer_metric_without_a_list_goes_where_what_it_moves_is_reported():
    """A later per-layer metric may leave out ``workloads``: it is then read
    in every cell that reports the end-to-end metric it moves."""
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "later_metric", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "device", "moves": "encode_items_per_s"}])
    for w in BENCH["workloads"]:
        moved = [m["name"] for m in manifest.metrics_of(bench, w["name"], "end_to_end")]
        got = [m["name"] for m in manifest.metrics_of(bench, w["name"], "per_layer")]
        assert ("later_metric" in got) == ("encode_items_per_s" in moved)
