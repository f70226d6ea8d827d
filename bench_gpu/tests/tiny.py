"""A tiny benchmark for the harness's tests on the CPU: a copy of
BENCHMARK.json and bench_gpu/'s data files in a temporary directory,
with two small cells beside the real ones (a 256^2 column of 24 disks at
coupling_k 1 and 2, and a 128^2 channel from a seeded flow) whose
limits are the real cells'."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_gpu import spec

COLLAPSE = {
    "name": "tiny_collapse",
    "source": "the column collapse at a test size",
    "reduced": [],
    "reference": "lbm_dem",
    "scene": {"kind": "hex_column", "n_disks": 24, "r": 6.0, "x_frac": 0.22,
              "y_frac": 0.9, "pitch": 1.05, "jitter": 0.02},
    "guarantees": {"mass_drift_rate": 5.960464477539063e-08, "overflow": 0},
}
CHANNEL = {
    "name": "tiny_channel",
    "source": "the channel at a test size",
    "reduced": [],
    "reference": "lbm_dem",
    "scene": {"kind": "fluid"},
    "guarantees": {"mass_drift_rate": 5.960464477539063e-08},
}


def make(tmp: Path, storage: str = "float32") -> Path:
    """A repo-shaped copy under tmp holding the tiny cells
    tiny.k1, tiny.k2 and tiny.channel; returns its root."""
    root = tmp / "repo"
    shutil.copytree(spec.REPO / "bench_gpu", root / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    real = {c["name"]: spec.load_json(spec.REPO / c["file"])
            for c in bench["configs"]}
    big = real["column_collapse_8192"]["sim"]
    sims = {
        "tiny_collapse": dict(big, nx=256, ny=256, max_disks=24,
                              f_storage=storage),
        "tiny_channel": dict(real["channel_4096"]["sim"], nx=128, ny=128,
                             f_storage=storage),
    }
    for conf in (COLLAPSE, CHANNEL):
        c = dict(conf, sim=sims[conf["name"]])
        path = root / "bench_gpu" / "configs" / f"{conf['name']}.json"
        path.write_text(json.dumps(c))
        bench["configs"].append({
            "name": conf["name"], "source": conf["source"],
            "file": f"bench_gpu/configs/{conf['name']}.json", "reduced": [],
            "why": "a test size"})
    k1 = spec.load_json(spec.REPO / "bench_gpu/workloads/collapse8192.k1.json")
    ch = spec.load_json(spec.REPO / "bench_gpu/workloads/channel4096.json")
    cells = {
        "tiny.k1": dict(k1, config="tiny_collapse", chunk=8, first_steps=1,
                        check_steps=24),
        "tiny.k2": dict(k1, config="tiny_collapse", coupling_k=2, chunk=8,
                        first_steps=2, check_steps=24),
        "tiny.channel": dict(ch, config="tiny_channel", chunk=8,
                             first_steps=4, check_steps=40, start=dict(
                                 ch["start"], modes=[[1, 1], [2, 3]])),
    }
    for name, w in cells.items():
        (root / "bench_gpu" / "workloads" / f"{name}.json").write_text(
            json.dumps(w))
        bench["workloads"].append({"name": name, "config": w["config"],
                                   "traffic": name, "chips": 1,
                                   "why": "a test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + list(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
