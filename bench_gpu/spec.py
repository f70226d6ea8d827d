"""BENCHMARK.json and the files each of its names leads to.

A cell `<cell>` of `workloads` is `bench_gpu/workloads/<cell>.json`
(the traffic: the configuration's name, the coupling cadence, the
window's call, the checked call, the start, the limits of the check);
its configuration is the file its `configs` entry names; a per-layer
metric `<metric>` is read by `bench_gpu/metrics/<metric>.py`; a kernel
`<K>` is counted by `bench_gpu/work/<K>.py`. Adding a configuration, a
cell or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    """One cell with its workload, configuration and metrics."""

    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether `metric` is reported in `cell`: the cells its "workloads"
    lists, or without that key, every cell (an end-to-end metric) or
    every cell that reports the end-to-end metric it moves (a
    per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(bench: dict, name: str, repo: Path = REPO) -> Cell:
    """The cell `name` of `bench`, resolved to its files."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    workload = load_json(repo / "bench_gpu" / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names {workload['config']!r}"
                         f", BENCHMARK.json {entry['config']!r}")
    config = load_json(repo / conf_entry["file"])
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per = [m for m in bench["per_layer"] if applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), workload, config, e2e, per)


def reader(metric: str, repo: Path = REPO):
    """The read(ctx) function of bench_gpu/metrics/<metric>.py."""
    path = repo / "bench_gpu" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_gpu.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
