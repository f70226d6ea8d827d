"""The check on the CPU at test sizes: the reference against the
program's plain versions, whole runs of the harness that come out
correct, the control (the program's bf16 storage) and the planted
faults that must come out not correct, and the import check."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from bench_gpu import calibrate, check, run, scenes, spec
from bench_gpu.reference import lbm_dem
from bench_gpu.tests import tiny
from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def repo_bf16(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench16"), storage="bfloat16")


def cell(root, name):
    return spec.cell(spec.load_benchmark(root), name, repo=root)


def run_cpu(root, name, seed=2 ** 33 + 5):
    return run.run_cell(cell(root, name), seed, 0.0, False, "cpu",
                        time.perf_counter())


# the start of the tiny column before the cells' start was made faster:
# the disks move but seldom touch in 16 steps
SLOW = {"kind": "disk_motion", "speed": 0.02, "spin": 0.002}


@pytest.mark.parametrize("k, use_kernels", [(1, False), (1, True),
                                            (2, True)])
def test_reference_against_the_programs_plain_versions(repo, k,
                                                       use_kernels):
    """16 steps of the tiny column from moving disks: the reference
    against the program on the CPU (use_kernels=False: the plain path;
    True: each kernel's plain version inside the Verlet cadence and, at
    k = 2, the window)."""
    c = cell(repo, "tiny.k1")
    sim_kw = dict(c.config["sim"], coupling_k=k)
    sc = scenes.build(c.config, dict(c.workload, start=SLOW), 7)
    d = sc.disks
    disks = [DiskSpec(*row) for row in zip(*(d[q].tolist() for q in (
        "x", "y", "r", "vx", "vy", "omega")))]
    sim = Simulation(SimConfig(**sim_kw), disks, device="cpu",
                     use_kernels=use_kernels)
    sim.run(16)
    p = lbm_dem.Params.from_sim(sim_kw)
    d0 = lbm_dem.make_disks(d["x"], d["y"], d["r"], d["vx"], d["vy"],
                            d["omega"], p, "cpu")
    f, dr, _ = lbm_dem.advance(lbm_dem.equilibrium_rest(p, "cpu"), d0, p, 16,
                               k)
    st = sim.state
    assert float((st.f - f).abs().max()) < 1e-6
    assert float((st.disks.v - dr.v).abs().max()) < 1e-6 * float(
        dr.v.abs().max())
    assert float((st.disks.x - dr.x).abs().max()) < 1e-4


@pytest.mark.parametrize("k", [1, 2])
def test_reference_against_the_program_with_live_contacts(repo, k):
    """24 steps of the tiny column from the cells' own start, in which
    disks touch: the reference against each kernel's plain version on
    the CPU. The contact forces are summed in another order on each
    side, so the velocities agree to 1e-5 of the largest."""
    c = cell(repo, "tiny.k1")
    sim_kw = dict(c.config["sim"], coupling_k=k)
    sc = scenes.build(c.config, c.workload, 7)
    d = sc.disks
    disks = [DiskSpec(*row) for row in zip(*(d[q].tolist() for q in (
        "x", "y", "r", "vx", "vy", "omega")))]
    sim = Simulation(SimConfig(**sim_kw), disks, device="cpu")
    sim.run(24)
    p = lbm_dem.Params.from_sim(sim_kw)
    d0 = lbm_dem.make_disks(d["x"], d["y"], d["r"], d["vx"], d["vy"],
                            d["omega"], p, "cpu")
    f, dr, info = lbm_dem.advance(lbm_dem.equilibrium_rest(p, "cpu"), d0, p,
                                  24, k)
    st = sim.state
    assert info["contacts"] > 0 and int(st.n_contacts) == info["contacts"]
    assert float((st.f - f).abs().max()) < 1e-6
    assert float((st.disks.v - dr.v).abs().max()) < 1e-5 * float(
        dr.v.abs().max())
    assert float((st.disks.omega - dr.omega).abs().max()) < 1e-5 * float(
        dr.omega.abs().max())


def test_reference_fluid_against_the_plain_path(repo):
    c = cell(repo, "tiny.channel")
    sim_kw = c.config["sim"]
    sc = scenes.build(c.config, c.workload, 9)
    sim = Simulation(SimConfig(**sim_kw), [], device="cpu",
                     use_kernels=False)
    sim.state = sim.state._replace(f=sc.start_f("cpu"))
    sim.run(24)
    f, _, _ = lbm_dem.advance(sc.start_f("cpu"), None,
                              lbm_dem.Params.from_sim(sim_kw), 24)
    assert float((sim.state.f - f).abs().max()) < 1e-6


@pytest.mark.parametrize("name", ["tiny.k1", "tiny.k2", "tiny.channel"])
def test_a_sound_run_is_correct(repo, name):
    res = run_cpu(repo, name)
    assert res["correct"], res["check"]
    assert res["attempted"] == len(res["check"]) and res["failed"] == 0
    assert list(res["metrics"]) == ["mlups", "peak_mem_gib", "setup_s"]


@pytest.mark.parametrize("name", ["tiny.k1", "tiny.k2", "tiny.channel"])
def test_the_control_is_not_correct(repo_bf16, name):
    """The program's own bf16 storage, the step below the configuration's
    float32, fails the check at the real cells' limits."""
    res = run_cpu(repo_bf16, name)
    assert not res["correct"], res["check"]
    over = [k for k, c in res["check"].items() if c["value"] > c["limit"]]
    assert "first_f_gap" in over, res["check"]


def _unchanged(orig):
    def chunk(self, n):
        return None

    return chunk


def _half_batch(orig):
    """Half the work left out: every other disk keeps its state, and on
    a fluid the upper half of the lattice keeps its populations."""
    def chunk(self, n):
        # the program writes f into its two buffers in turn: copy it
        before = self.state._replace(f=self.state.f.clone())
        orig(self, n)
        st = self.state
        if st.disks.x.shape[0] > 1 and self.grid is not None:
            d, b = st.disks, before.disks
            keep = torch.zeros_like(d.active)
            keep[::2] = True
            k2 = keep[:, None]
            self.state = st._replace(disks=d._replace(
                x=torch.where(k2, b.x, d.x), v=torch.where(k2, b.v, d.v),
                omega=torch.where(keep, b.omega, d.omega)))
        else:
            f = st.f.clone()
            f[:, f.shape[1] // 2:] = before.f[:, f.shape[1] // 2:]
            self.state = st._replace(f=f)

    return chunk


def _altered(orig):
    """One answer altered where it is produced: one population of one
    cell after each call."""
    def chunk(self, n):
        orig(self, n)
        f = self.state.f.clone()
        f[1, f.shape[1] // 3, f.shape[2] // 5] += 1e-3
        self.state = self.state._replace(f=f)

    return chunk


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("name", ["tiny.k1", "tiny.k2", "tiny.channel"])
def test_a_broken_timed_path_is_not_correct(repo, monkeypatch, name, fault):
    monkeypatch.setattr(Simulation, "_run_chunk",
                        fault(Simulation._run_chunk))
    res = run_cpu(repo, name)
    assert not res["correct"], res["check"]


def _fastest_disk(snap):
    """One disk of 24 altered where it is produced: the fastest, whose
    error then is over 1e-3 of the median speed (the calibration's one
    disk in 64 leaves only the first disk here, which may be slow)."""
    i = int(snap["v"].norm(dim=1).argmax())
    snap["v"][i] *= 1.0 + 1e-3
    snap["omega"][i] *= 1.0 + 1e-3


@pytest.mark.parametrize("fault", ["contact", "minority"])
@pytest.mark.parametrize("name", ["tiny.k1", "tiny.k2"])
def test_a_planted_disk_fault_is_not_correct(repo, name, fault):
    """The calibration's planted faults: the program's contact law off
    (its kn and gamma_n 25 % high), and a minority of disks altered where
    they are produced. Each fails disks_off."""
    c = cell(repo, name)
    plant = (calibrate.faults(c)["contact"] if fault == "contact"
             else {"alter": _fastest_disk})
    res = run.run_cell(c, 2 ** 33 + 5, 0.0, False, "cpu", time.perf_counter(),
                       **plant)
    assert not res["correct"], res["check"]
    assert res["check"]["disks_off"]["value"] > res["check"]["disks_off"][
        "limit"], res["check"]


def test_forbidden_modules():
    assert run.forbidden_modules(["lbmdem_tpu_torch", "lbmdem_tpu_torch.ops",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["jax.numpy", "lbmdem_tpu.ops.lbm",
                                  "flax"]) == ["flax", "jax", "lbmdem_tpu"]


def test_the_harness_loads_no_jax_and_the_reference_not_the_program():
    code = ("import sys; import bench_gpu.reference.lbm_dem, "
            "bench_gpu.check, bench_gpu.scenes, bench_gpu.roofline; "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'lbmdem_tpu_torch'], 'program loaded'; "
            "import bench_gpu.run, bench_gpu.trace, lbmdem_tpu_torch; "
            "from bench_gpu.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload",
                          "channel4096", "--seed", "1", "--seconds", "1"],
                         cwd=spec.REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and bench_gpu/ the
    command exits non-zero and prints nothing on standard output."""
    import shutil

    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.REPO / "bench_gpu", tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload",
                          "channel4096", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "lbmdem_tpu_torch" in out.stderr


def test_storage_round_trip():
    sim = {"f_storage": "bfloat16", "rho0": 1.0}
    p = lbm_dem.Params.from_sim({"nx": 8, "ny": 4, "tau": 0.8, "gx": 0.0,
                                 "gy": 0.0, "bc_west": "periodic",
                                 "bc_east": "periodic", "bc_south": "wall",
                                 "bc_north": "wall", "dtype": "float32",
                                 "rho0": 1.0})
    f = lbm_dem.equilibrium_rest(p, "cpu")
    g = check.to_storage(f, sim)
    assert g.dtype == torch.bfloat16 and float(g.abs().max()) == 0.0
    assert torch.allclose(torch.stack([check.physical(g, sim, i)
                                       for i in range(9)]), f)
