"""BENCHMARK.json against the contract's characters and shapes, each cell
resolving to its files, and a cell added by new files alone."""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest

from bench_gpu import spec, trace
from bench_gpu.tests import tiny

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_tok")


def names():
    return ([c["name"] for c in BENCH["configs"]]
            + [w["name"] for w in BENCH["workloads"]]
            + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.endswith("_torch")
        assert (spec.REPO / p).is_dir()


@pytest.mark.parametrize("name", names())
def test_name_characters(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        got = [x["name"] for x in group]
        assert len(got) == len(set(got))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for w in m.get("workloads", []):
        assert w in [c["name"] for c in BENCH["workloads"]]


def test_setup_metric():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert len(c["reduced"]) <= 16
    for key in c["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key)
    conf = spec.load_json(spec.REPO / c["file"])
    assert conf["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert NAME.match(w["traffic"])
    cell = spec.cell(BENCH, w["name"])
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    kernels = trace.kernel_files()
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["name"][:-len("_roofline")] in kernels
    assert cell.workload["check_steps"] % cell.workload.get("coupling_k", 1) == 0
    assert set(cell.workload["limits"]) >= {"first_f_gap"}
    assert 1 <= cell.workload["first_steps"] <= cell.workload["check_steps"]


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_cell_added_by_new_files(tmp_path):
    """A configuration, a cell and a per-layer metric added to a copy as
    new files and new entries: every file that was there is unchanged,
    and the new cell resolves with its new metric."""
    root = tiny.make(tmp_path)
    before = _digests(root / "bench_gpu")
    conf = spec.load_json(root / "bench_gpu/configs/tiny_collapse.json")
    conf["name"] = "tiny_wide"
    conf["sim"] = dict(conf["sim"], nx=320)
    (root / "bench_gpu/configs/tiny_wide.json").write_text(json.dumps(conf))
    work = dict(spec.load_json(root / "bench_gpu/workloads/tiny.k1.json"),
                config="tiny_wide")
    (root / "bench_gpu/workloads/tiny_wide.k1.json").write_text(
        json.dumps(work))
    (root / "bench_gpu/metrics/contacts_per_disk.py").write_text(
        "def read(ctx):\n    return 0.5\n")
    bench = spec.load_benchmark(root)
    bench["configs"].append({"name": "tiny_wide", "source": "a test",
                             "file": "bench_gpu/configs/tiny_wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_wide.k1", "config": "tiny_wide",
                               "traffic": "k1", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "contacts_per_disk", "unit": "1",
                               "better": "higher", "source": "device_trace",
                               "layer": "K3 slab DEM", "moves": "mlups",
                               "workloads": ["tiny_wide.k1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root / "bench_gpu")
    assert {k: v for k, v in after.items() if k in before} == before
    cell = spec.cell(spec.load_benchmark(root), "tiny_wide.k1", repo=root)
    assert cell.config["sim"]["nx"] == 320
    assert [m["name"] for m in cell.per_layer] == ["contacts_per_disk"]
    assert spec.reader("contacts_per_disk", repo=root)(None) == 0.5
