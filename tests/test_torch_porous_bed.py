"""The benchmark's fixed porous bed (`porous_bed_4096`, cell
`porous4096.static`) on the CPU: the committed files load, and the
deployment cut to 256^2 and 16 disks of r = 16 (margin, jitter and the
solid fraction kept) runs through the harness's `run_cell` on the
program's plain versions against the plain reference, taking the static
hoist, `correct` under the cell's own limits; the calibration's
`unfixed` fault and the bf16 control fail it. Also the two readers of
the cell's new per-layer metrics on hand-made contexts."""

from __future__ import annotations

import json
import math
import shutil
import time
import types

import pytest

from bench_gpu import calibrate, roofline, run, scenes, spec, trace
from lbmdem_tpu_torch.utils import profiling

CELL = "porous4096.static"
CUT = "porous256.static"
SEED = 2 ** 31 + 11


def solid_fraction(config: dict) -> float:
    sc, sim = config["scene"], config["sim"]
    return sc["n_disks"] * math.pi * sc["r"] ** 2 / (sim["nx"] * sim["ny"])


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """A repo-shaped copy of bench_gpu/ and BENCHMARK.json with the cut
    bed beside the committed cells: its configuration is the committed
    one at 256^2 and 16 disks, its workload the committed one with a
    shorter window call."""
    root = tmp_path_factory.mktemp("porous") / "repo"
    shutil.copytree(spec.REPO / "bench_gpu", root / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "porous_bed_4096")
    conf = spec.load_json(spec.REPO / entry["file"])
    conf = dict(conf, name="porous_bed_256",
                scene=dict(conf["scene"], n_disks=16),
                sim=dict(conf["sim"], nx=256, ny=256, max_disks=16))
    (root / "bench_gpu/configs/porous_bed_256.json").write_text(
        json.dumps(conf))
    w = spec.load_json(spec.REPO / f"bench_gpu/workloads/{CELL}.json")
    (root / f"bench_gpu/workloads/{CUT}.json").write_text(json.dumps(
        dict(w, config="porous_bed_256", chunk=8)))
    bench["configs"].append(dict(entry, name="porous_bed_256",
                                 file="bench_gpu/configs/porous_bed_256.json"))
    bench["workloads"].append({"name": CUT, "config": "porous_bed_256",
                               "traffic": "static_k4", "chips": 1,
                               "why": "a test size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def cut_cell(root):
    return spec.cell(spec.load_benchmark(root), CUT, repo=root)


def run_cpu(c, **plant):
    return run.run_cell(c, SEED, 0.0, False, "cpu", time.perf_counter(),
                        **plant)


@pytest.fixture(scope="module")
def sound(repo):
    """The cut cell's run, with the static hoist's stamps counted."""
    before = profiling.counters()["static_stamps"]
    res = run_cpu(cut_cell(repo))
    return res, profiling.counters()["static_stamps"] - before


def test_the_committed_cell_loads():
    c = spec.cell(spec.load_benchmark(), CELL)
    assert c.chips == 1 and c.config["name"] == "porous_bed_4096"
    assert c.config["scene"] == {"kind": "grid_bed", "n_disks": 4096,
                                 "r": 16.0, "margin": 20.0, "jitter": 2.0,
                                 "fixed": True}
    sim = c.config["sim"]
    assert (sim["nx"], sim["ny"], sim["max_disks"]) == (4096, 4096, 4096)
    assert (sim["bc_west"], sim["bc_east"]) == ("periodic", "periodic")
    assert (sim["bc_south"], sim["bc_north"]) == ("wall", "wall")
    assert sim["f_storage"] == sim["dtype"] == "float32"
    assert c.config["reduced"] == [] and c.config["reference"] == "lbm_dem"
    w = c.workload
    assert (w["chunk"], w["first_steps"], w["check_steps"]) == (200, 4, 24)
    assert w["start"]["kind"] == "flow_modes"
    assert set(w["limits"]) == {"first_f_gap", "f_gap", "f_l2", "x_gap"}
    assert w["limits"]["x_gap"] == 0.0
    assert [m["name"] for m in c.per_layer] == [
        "device_idle_pct", "launches_per_step", "step_mfu",
        "window_peak_gib", "K7_roofline", "static_stamps"]
    assert solid_fraction(c.config) == pytest.approx(0.196, abs=5e-4)


def test_the_cut_keeps_the_solid_fraction(repo):
    c = cut_cell(repo)
    committed = spec.cell(spec.load_benchmark(), CELL)
    assert solid_fraction(c.config) == pytest.approx(
        solid_fraction(committed.config), rel=1e-12)
    assert c.config["scene"]["r"] == 16.0 and c.workload["limits"] == (
        committed.workload["limits"])


def test_the_cut_bed_takes_the_static_hoist(repo):
    c = cut_cell(repo)
    sim, _, _, _ = run.set_up(c, c.config["sim"],
                              scenes.build(c.config, c.workload, SEED),
                              "cpu", time.perf_counter())
    assert sim.static_solid and sim.dem_mode == "drift"


def test_the_cut_bed_is_correct(sound):
    res, stamps = sound
    assert res["correct"], res["check"]
    assert res["numbers"]["x_gap"] == 0.0
    assert res["check"]["x_gap"]["limit"] == 0.0
    assert set(res["check"]) >= {"first_f_gap", "f_gap", "f_l2", "x_gap",
                                 "overflow", "mass_drift_rate"}
    assert stamps == 1


@pytest.mark.parametrize("fault", ["unfixed", "bf16"])
def test_a_fault_fails_the_cut_bed(repo, fault):
    c = cut_cell(repo)
    if fault == "bf16":
        c.config["sim"]["f_storage"] = "bfloat16"
        res = run_cpu(c)
    else:
        res = run_cpu(c, **calibrate.faults(c)["unfixed"])
    assert not res["correct"], res["check"]


def _ctx(kernels, steps=200, window_s=0.1):
    g = roofline.geometry({"nx": 4096, "ny": 4096, "f_storage": "float32",
                           "bc_west": "periodic", "bc_east": "periodic",
                           "bc_south": "wall", "bc_north": "wall"},
                          {"x": [0.0] * 4096}, 3_290_000, 0, 37)
    tr = types.SimpleNamespace(kernels=kernels, steps=steps,
                               window_s=window_s)
    return types.SimpleNamespace(trace=tr, work=trace.kernel_files(),
                                 geometry=g, window_peak_bytes=0)


def test_K7_roofline_reads_K7s_share():
    read = spec.reader("K7_roofline")
    moved, flops = trace.kernel_files()["K7"].per_call(_ctx({}).geometry, 4)
    bound = max(moved / roofline.HBM_BPS, flops / roofline.F32_FLOPS)
    # 50 passes of 4 steps in 0.1 s
    got = read(_ctx({"K7": (0.1, 50)}))
    assert got == pytest.approx(100.0 * bound * 50 / 0.1, rel=1e-12)
    assert 0.0 < got < 100.0
    assert read(_ctx({"K5": (0.1, 50)})) is None


@pytest.mark.parametrize("counters, want", [
    ({"syncs": 3, "sync_wait_s": 0.0, "static_stamps": 1,
      "fallback_steps": 0}, 1),
    ({"syncs": 3, "sync_wait_s": 0.0, "static_stamps": 4,
      "fallback_steps": 0}, 4),
    # a program without the counter reads nothing and does not raise
    ({"syncs": 3, "sync_wait_s": 0.0, "fallback_steps": 0}, None),
])
def test_static_stamps_reads_the_programs_counter(monkeypatch, counters,
                                                  want):
    monkeypatch.setattr(profiling, "counters", lambda: counters)
    assert spec.reader("static_stamps")(_ctx({})) == want
