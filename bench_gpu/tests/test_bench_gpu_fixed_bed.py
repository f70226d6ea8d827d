"""A bed of fixed disks at rest as data files alone (CPU, test sizes):
the grid_bed packing, the program's static hoist through the harness's
set-up, the reference's fixed disks, the check's x_gap and its faults,
K7's work file, and the tiny cells' numbers pinned from before fixed
disks were added."""

from __future__ import annotations

import json
import math
import re
import time

import numpy as np
import pytest
import torch

from bench_gpu import calibrate, run, scenes, spec, trace
from bench_gpu.reference import lbm_dem
from bench_gpu.tests import tiny

SEED = 2 ** 33 + 5

# a 128^2 bed of 16 fixed r = 4 disks at rest, bench.py's static stage
# at a test size
BED_SCENE = {"kind": "grid_bed", "n_disks": 16, "r": 4.0, "margin": 20.0,
             "jitter": 2.0, "fixed": True}
BED_SIM = {"nx": 128, "ny": 128, "tau": 0.8, "gx": 1e-06, "gy": 0.0,
           "bc_west": "periodic", "bc_east": "periodic", "bc_south": "wall",
           "bc_north": "wall", "max_disks": 16, "rho_s": 2.0, "kn": 1.0,
           "kt": 0.0, "gamma_n": 0.0, "gamma_t": 0.0, "mu": 0.0, "n_sub": 10,
           "g_px": 0.0, "g_py": 0.0, "buoyancy": True, "contact_cap": 10,
           "eps_samples": 4, "eps_method": "sample", "eps_r_shift": 0.0,
           "nt_mode": "nt", "smagorinsky": 0.0, "collision": "bgk",
           "dtype": "float32", "f_storage": "float32", "rho0": 1.0,
           "u0x": 0.0, "u0y": 0.0, "out_interval": 0}
BED_WORKLOAD = {"config": "tiny_bed", "chunk": 8, "first_steps": 4,
                "check_steps": 24, "start": {"kind": "rest"},
                "limits": {"first_f_gap": 6e-06, "f_gap": 1e-05,
                           "f_l2": 3e-04, "x_gap": 0.0}}

# the tiny cells' check numbers at SEED, one call of window, from the
# harness before it took fixed disks
PINNED = {
    "tiny.k1": {"first_f_gap": 0.0, "f_gap": 3.8743019104003906e-07,
                "f_l2": 3.873958461474087e-06,
                "v_med": 4.281362786563813e-07, "omega_med": 0.0,
                "disks_off": 0.0, "contacts": 0.0, "contacts_gap": 0.0,
                "overflow": 0.0, "mass_drift_rate": 8.954188432386267e-10},
    "tiny.k2": {"first_f_gap": 0.0, "f_gap": 3.5762786865234375e-07,
                "f_l2": 4.211425215049501e-06,
                "v_med": 3.299059012097919e-07,
                "omega_med": 8.643218224763976e-08, "disks_off": 0.0,
                "contacts": 0.0, "contacts_gap": 0.0, "overflow": 0.0,
                "mass_drift_rate": 8.92956812659218e-10},
    "tiny.channel": {"first_f_gap": 2.682209014892578e-07,
                     "f_gap": 2.980232238769531e-07,
                     "f_l2": 8.90810982804041e-06, "overflow": 0.0,
                     "mass_drift_rate": 9.161074796907679e-09},
}


def add_bed(root):
    """The bed as a configuration file, a workload file and two entries
    of BENCHMARK.json beside the tiny cells: no harness file changes."""
    conf = {"name": "tiny_bed", "source": "bench.py's static stage at a "
            "test size", "reduced": [], "reference": "lbm_dem",
            "scene": BED_SCENE, "sim": BED_SIM,
            "guarantees": {"mass_drift_rate": 5.960464477539063e-08,
                           "overflow": 0}}
    (root / "bench_gpu/configs/tiny_bed.json").write_text(json.dumps(conf))
    (root / "bench_gpu/workloads/tiny.bed.json").write_text(
        json.dumps(BED_WORKLOAD))
    bench = spec.load_benchmark(root)
    bench["configs"].append({"name": "tiny_bed", "source": conf["source"],
                             "file": "bench_gpu/configs/tiny_bed.json",
                             "reduced": [], "why": "a test size"})
    bench["workloads"].append({"name": "tiny.bed", "config": "tiny_bed",
                               "traffic": "tiny.bed", "chips": 1,
                               "why": "a test size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return add_bed(tiny.make(tmp_path_factory.mktemp("bed")))


def cell(root, name):
    return spec.cell(spec.load_benchmark(root), name, repo=root)


def run_cpu(c, seed=SEED, **plant):
    return run.run_cell(c, seed, 0.0, False, "cpu", time.perf_counter(),
                        **plant)


@pytest.mark.parametrize("n, nx", [(16, 128), (4096, 4096), (10, 256)])
def test_grid_bed_packing(n, nx):
    """bench.py's count, radius, margin and jitter: each disk within the
    jitter of its grid cell's centre, inside the margin's box."""
    sc = dict(BED_SCENE, n_disks=n)
    d = scenes.grid_bed(sc, nx, nx, np.random.default_rng(SEED))
    side = math.ceil(math.sqrt(n))
    pitch = (nx - 2 * 20.0) / side
    gy, gx = np.divmod(np.arange(n), side)
    assert len(d["x"]) == n and (d["r"] == 4.0).all()
    for got, g in ((d["x"], gx), (d["y"], gy)):
        off = got - (20.0 + (g + 0.5) * pitch)
        assert np.abs(off).max() <= 2.0 and np.abs(off).max() > 0.5
    assert not (d["vx"].any() or d["vy"].any() or d["omega"].any())


def test_grid_bed_same_seed_same_arrays(repo):
    c = cell(repo, "tiny.bed")
    a, b, o = (scenes.build(c.config, c.workload, s).disks
               for s in (SEED, SEED, SEED + 1))
    for q in ("x", "y", "r", "vx", "vy", "omega", "fixed"):
        assert np.array_equal(a[q], b[q])
    assert not np.array_equal(a["x"], o["x"])
    assert a["fixed"].dtype == bool and a["fixed"].all()


def test_fixed_defaults_to_false(repo):
    c = cell(repo, "tiny.k1")
    d = scenes.build(c.config, c.workload, SEED).disks
    assert d["fixed"].dtype == bool and not d["fixed"].any()


def test_fixed_with_disk_motion_is_refused(repo):
    c = cell(repo, "tiny.bed")
    start = {"kind": "disk_motion", "speed": 0.01, "spin": 0.001}
    with pytest.raises(ValueError, match="fixes"):
        scenes.build(c.config, dict(c.workload, start=start), SEED)


def test_the_program_takes_the_static_hoist(repo):
    c = cell(repo, "tiny.bed")
    sim, _, _, _ = run.set_up(c, c.config["sim"],
                              scenes.build(c.config, c.workload, SEED),
                              "cpu", time.perf_counter())
    assert sim.static_solid and sim.dem_mode == "drift"


def test_the_bed_is_correct(repo):
    res = run_cpu(cell(repo, "tiny.bed"))
    assert res["correct"], res["check"]
    nums = res["numbers"]
    assert nums["x_gap"] == 0.0 and res["check"]["x_gap"]["limit"] == 0.0
    assert not {"v_med", "omega_med", "disks_off"} & set(nums)
    assert res["disk_errors"] is None


def _moved_disk(snap):
    snap["x"][5, 0] += 1e-3


@pytest.mark.parametrize("fault", ["moved_disk", "unfixed"])
def test_a_bed_fault_is_not_correct(repo, fault):
    """One disk's x moved where it is produced, and the program given the
    bed's disks as mobile (the calibration's "unfixed")."""
    c = cell(repo, "tiny.bed")
    plant = ({"alter": _moved_disk} if fault == "moved_disk"
             else calibrate.faults(c)["unfixed"])
    res = run_cpu(c, **plant)
    assert not res["correct"], res["check"]
    if fault == "moved_disk":
        assert res["check"]["x_gap"]["value"] > 0.0


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_tiny_cells_read_what_they_read(repo, name):
    """Every number of the check, to the last digit, as before the
    harness took fixed disks."""
    assert run_cpu(cell(repo, name))["numbers"] == PINNED[name]


def _reference_bed(repo):
    c = cell(repo, "tiny.bed")
    d = scenes.build(c.config, c.workload, SEED).disks
    p = lbm_dem.Params.from_sim(c.config["sim"])
    d0 = lbm_dem.make_disks(d["x"], d["y"], d["r"], d["vx"], d["vy"],
                            d["omega"], p, "cpu", fixed=d["fixed"])
    return p, d0


def test_the_static_bed_is_the_coupled_path_with_infinite_mass(
        repo, monkeypatch):
    """The reference's fixed bed, stamped once, against its coupled path
    with fixed disks of infinite mass: the same f, disks unmoved."""
    p, d0 = _reference_bed(repo)
    f0 = lbm_dem.equilibrium_rest(p, "cpu")
    f_s, d_s, info = lbm_dem.advance(f0, d0, p, 8)
    monkeypatch.setattr(lbm_dem, "_fixed_at_rest", lambda d: False)
    f_c, d_c, _ = lbm_dem.advance(f0, d0, p, 8)
    assert info == {"contacts": 0} and torch.equal(f_s, f_c)
    for q in ("x", "v", "omega", "theta"):
        assert torch.equal(getattr(d_c, q), getattr(d0, q))
    assert d_s is d0


def test_the_reference_refuses_what_it_lacks(repo):
    p, d0 = _reference_bed(repo)
    f0 = lbm_dem.equilibrium_rest(p, "cpu")
    moving = d0._replace(v=d0.v + 1e-3)
    with pytest.raises(NotImplementedError, match="move"):
        lbm_dem.advance(f0, moving, p, 1)
    x = d0.x.clone()
    x[0, 0] = 2.0
    with pytest.raises(NotImplementedError, match="periodic"):
        lbm_dem.advance(f0, d0._replace(x=x), p, 1)


def test_no_fixed_disk_keeps_no_mask():
    z = np.zeros(3)
    p = lbm_dem.Params.from_sim(dict(BED_SIM, max_disks=3))
    d = lbm_dem.make_disks(z + 40, z + 40, z + 4, z, z, z, p, "cpu",
                           fixed=np.zeros(3, bool))
    assert d.fixed is None


K6_RECORD = ("void (anonymous namespace)::temporal_block_kernel<float, "
             "float, false, 1, 2, (anonymous namespace)::NTCell<false, false, "
             "false, (anonymous namespace)::WSteps> >(float const*, float "
             "const*, float*, (anonymous namespace)::NTCell<false, false, "
             "false, (anonymous namespace)::WSteps>, int, int, int, int, "
             "(anonymous namespace)::FluidParams)")
K7_RECORD = ("void (anonymous namespace)::temporal_block_kernel<float, "
             "float, false, 1, 2, (anonymous namespace)::NTCell<false, false, "
             "false, (anonymous namespace)::NoSink> >(float const*, float "
             "const*, float*, (anonymous namespace)::NTCell<false, false, "
             "false, (anonymous namespace)::NoSink>, int, int, int, int, "
             "(anonymous namespace)::FluidParams)")
K5_RECORD = ("void (anonymous namespace)::temporal_block_kernel<float, "
             "float, false, 2, 2, (anonymous namespace)::FluidCell<0, 0, 1> "
             ">(float const*, float const*, float*, (anonymous namespace)::"
             "FluidCell<0, 0, 1>, int, int, int, int, (anonymous namespace)::"
             "FluidParams)")


@pytest.mark.parametrize("record, owner", [(K6_RECORD, "K6"),
                                           (K7_RECORD, "K7"),
                                           (K5_RECORD, "K5")])
def test_each_row_sweep_has_one_owner(record, owner):
    files = trace.kernel_files()
    assert [k for k, m in files.items() if re.search(m.MATCH, record)] == [
        owner]


def test_a_static_chunk_is_attributed_to_K7():
    files = trace.kernel_files()
    names = [K7_RECORD] * 5
    starts = np.arange(5, dtype=np.int64) * 200
    got, glue = trace.attribute(names, starts, starts + 100, files)
    assert got == {"K7": (pytest.approx(5e-7), 5)} and glue == 0.0


def test_K7_work():
    g = {"cells": 2048, "f_bytes": 4, "solid_cells": 300}
    moved, flops = trace.kernel_files()["K7"].per_call(g, 4)
    assert moved == 2 * 9 * 2048 * 4 + 3 * 2048 * 4
    assert flops == 4 * (350 * 300 + 180 * (2048 - 300))
    assert trace.kernel_files()["K7"].per_call(dict(g, f_bytes=2), 4)[0] == (
        2 * 9 * 2048 * 2 + 3 * 2048 * 4)
