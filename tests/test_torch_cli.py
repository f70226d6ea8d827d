"""The port's CLI (python -m lbmdem_tpu_torch.cli) on the CPU against the
JAX package's CLI, the example decks through it, and the rule that no
module of the port imports JAX."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import lbmdem_tpu.cli as jcli
from lbmdem_tpu.config import load_param_file as jload
from lbmdem_tpu.config import load_particle_file as jload_disks
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu.utils import checkpoint as jckpt
from lbmdem_tpu_torch import (Simulation, cli, load_param_file,
                              load_particle_file)
from lbmdem_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")
DECKS = sorted(glob.glob(os.path.join(EXAMPLES, "*.par")))
BASELINE = {"poiseuille.par", "sedimentation.par", "dkt.par",
            "settling_column.par", "column_collapse.par"}

# the deck of the JAX package's tests/test_aux.py::test_cli_end_to_end
DECK = ("nx 32\nny 64\ntau 0.8\nsteps 20\nout_interval 10\n"
        "bc west wall\nbc east wall\nbc south wall\nbc north wall\n"
        "kn 0.5\ngamma_n 0.5\nrho_s 2.0\nn_sub 5\ng_py -1e-4\n"
        "particles d.txt\ndtype float64\n")
FLAGS = ["--checkpoint-every", "10", "--log-forces"]


def _deck(tmp_path):
    (tmp_path / "run.par").write_text(DECK)
    (tmp_path / "d.txt").write_text("16 50 3.0\n")
    return str(tmp_path / "run.par")


def _run(tmp_path, out, *extra):
    assert cli.main([_deck(tmp_path), "--device", "cpu", "--out",
                     str(tmp_path / out), *FLAGS, *extra]) == 0
    return tmp_path / out


def _csv(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def test_cli_matches_jax_cli(tmp_path, capsys):
    """The deck of the JAX CLI's end-to-end test, through both CLIs on
    the CPU (the port's auto path is the plain path there, as the JAX
    CLI's is off the TPU): the same files, the forces.csv header and
    rows, the metrics columns, the trajectories and forces within 1e-9
    (float64), and a restart.npz that restores in the other package."""
    deck = _deck(tmp_path)
    assert jcli.main([deck, "--out", str(tmp_path / "j"), "--no-pallas",
                      *FLAGS]) == 0
    out = _run(tmp_path, "t")
    assert "done: 20 steps" in capsys.readouterr().out
    jd = tmp_path / "j"
    assert sorted(os.listdir(out)) == sorted(os.listdir(jd))
    assert {"metrics.csv", "trajectories.csv", "forces.csv", "restart.npz",
            "fluid_00000010.vtk", "particles_00000020.vtk"} <= set(
                os.listdir(out))
    flog = (out / "forces.csv").read_text().splitlines()
    assert flog[0] == (jd / "forces.csv").read_text().splitlines()[0] == \
        "step,id,fx,fy,torque"
    assert len(flog) == 3 and float(flog[-1].split(",")[3]) > 0.0
    for name in ("forces.csv", "trajectories.csv"):
        np.testing.assert_allclose(_csv(out / name), _csv(jd / name),
                                   rtol=0, atol=1e-9, err_msg=name)
    m = (out / "metrics.csv").read_text().splitlines()
    jm = (jd / "metrics.csv").read_text().splitlines()
    assert m[0] == jm[0] and len(m) == len(jm) == 3
    for name in ("fluid_00000010.vtk", "fluid_00000020.vtk"):
        assert (out / name).stat().st_size == (jd / name).stat().st_size
    # each package restores the other's checkpoint
    cfg, pf = load_param_file(deck)
    sim = Simulation(cfg, load_particle_file(pf), device="cpu",
                     use_kernels=False)
    st = ckpt.load_state(str(jd / "restart.npz"), sim.state)
    jcfg, jpf = jload(deck)
    js = JSim(jcfg, jload_disks(jpf))
    jst = jckpt.load_state(str(out / "restart.npz"), js.state)
    assert int(st.step) == int(jst.step) == 20
    np.testing.assert_allclose(st.f.numpy(), np.asarray(jst.f), rtol=0,
                               atol=1e-9)


def test_cli_sync_io_equals_async(tmp_path):
    """--sync-io writes inline; the default overlaps the writes with the
    next chunk: the same files, byte for byte."""
    a = _run(tmp_path, "async")
    s = _run(tmp_path, "sync", "--sync-io")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(s))
    for n in names:
        if n.endswith(".npz"):
            continue
        if n == "metrics.csv":  # its last column is the wall-clock MLUPS
            ra = [r.rsplit(",", 1)[0] for r in (a / n).read_text().split()]
            rs = [r.rsplit(",", 1)[0] for r in (s / n).read_text().split()]
            assert ra == rs
            continue
        assert (a / n).read_bytes() == (s / n).read_bytes(), n


def test_cli_kernels_and_plain_path(tmp_path, capsys):
    """--kernels on the CPU (the kernels' plain versions, Verlet
    cadence) and --no-kernels agree on the deck within 1e-9 (float64);
    --restore continues from a checkpoint to the run's end."""
    k = _run(tmp_path, "k", "--kernels")
    p = _run(tmp_path, "p", "--no-kernels")
    np.testing.assert_allclose(_csv(k / "trajectories.csv"),
                               _csv(p / "trajectories.csv"), rtol=0,
                               atol=1e-9)
    deck = _deck(tmp_path)
    r = tmp_path / "r"
    assert cli.main([deck, "--device", "cpu", "--out", str(r), "--steps",
                     "30", "--restore", str(p / "restart.npz")]) == 0
    text = capsys.readouterr().out
    assert "restored from" in text and "done: 10 steps" in text
    rows = _csv(r / "trajectories.csv")
    assert rows[:, 0].tolist() == [30.0]


def test_cli_refuses_what_it_cannot_run(tmp_path, capsys):
    """--kernels on a deck the kernels cannot take is an error naming
    the reason. --distributed runs (one process: its line on stderr, the
    deck on a 2 x 2 mesh). Paranoid mode and
    bf16 storage, which a mesh refused so before, run there (2 steps on
    the plain sharded step; 4 bf16 steps on the kernels' plain
    versions); bf16 on the CPU's auto path, the plain sharded step,
    raises ValueError, as the JAX CLI does."""
    deck = os.path.join(EXAMPLES, "schafer_turek.par")
    with pytest.raises(SystemExit) as e:
        cli.main([deck, "--kernels", "--device", "cpu", "--out",
                  str(tmp_path / "x")])
    assert e.value.code == 2
    assert "exceeds the" in capsys.readouterr().err
    assert cli.main([deck, "--mesh", "2x2", "--device", "cpu", "--paranoid",
                     "--steps", "2", "--out", str(tmp_path / "p")]) == 0
    assert "done: 2 steps" in capsys.readouterr().out
    bf16 = tmp_path / "bf16.par"
    bf16.write_text("nx 256\nny 64\ntau 0.8\nsteps 4\nf_storage bfloat16\n")
    assert cli.main([str(bf16), "--mesh", "2x2", "--device", "cpu",
                     "--kernels", "--out", str(tmp_path / "b")]) == 0
    assert "done: 4 steps" in capsys.readouterr().out
    with pytest.raises(ValueError, match="raw f32"):
        cli.main([str(bf16), "--mesh", "2x2", "--device", "cpu", "--out",
                  str(tmp_path / "x")])
    # --distributed: a group of one process (gloo), in a process of its
    # own so that this one stays outside any group
    r = subprocess.run(
        [sys.executable, "-m", "lbmdem_tpu_torch.cli", deck, "--distributed",
         "--mesh", "2x2", "--device", "cpu", "--paranoid", "--steps", "2",
         "--out", str(tmp_path / "d")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "distributed: process 0/1, 1 local / 1 global devices" in r.stderr
    assert "done: 2 steps" in r.stdout
    assert (tmp_path / "d" / "metrics.csv").exists()


def test_cli_paranoid_and_profile(tmp_path, capsys):
    """--paranoid chunk runs the deck healthy; --profile leaves a Chrome
    trace."""
    out = _run(tmp_path, "pp", "--kernels", "--paranoid", "chunk",
               "--profile", str(tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "done: 20 steps" in capsys.readouterr().out
    assert (out / "metrics.csv").exists()


def test_cli_as_a_module(tmp_path):
    """python -m lbmdem_tpu_torch.cli, as a user starts it."""
    deck = _deck(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "lbmdem_tpu_torch.cli", deck, "--device",
         "cpu", "--steps", "4", "--out", str(tmp_path / "m")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 4 steps" in r.stdout


@pytest.mark.parametrize("deck", DECKS, ids=os.path.basename)
def test_deck_parses_like_jax(deck):
    """Every example deck parses in the port to the JAX package's config
    and disks."""
    import dataclasses

    cfg, pf = load_param_file(deck)
    jcfg, jpf = jload(deck)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if pf:
        d = load_particle_file(pf, units=cfg.units)
        jd = jload_disks(jpf, units=jcfg.units)
        assert [dataclasses.asdict(x) for x in d] == \
            [dataclasses.asdict(x) for x in jd]


@pytest.mark.parametrize(
    "deck", sorted(d for d in DECKS if os.path.basename(d) in BASELINE),
    ids=os.path.basename)
def test_baseline_deck_steps_through_the_cli(deck, tmp_path):
    """The five BASELINE decks step twice through the CLI's auto path on
    the CPU (column_collapse.par, the 4096^2 headline deck, only parses,
    as in tests/test_examples.py)."""
    cfg, _ = load_param_file(deck)
    if cfg.nx * cfg.ny > 512 * 1024:
        return
    out = tmp_path / "o"
    assert cli.main([deck, "--device", "cpu", "--steps", "2", "--out",
                     str(out)]) == 0
    m = (out / "metrics.csv").read_text().splitlines()
    row = dict(zip(m[0].split(","), m[-1].split(",")))
    assert int(row["step"]) == 2 and int(row["nan"]) == 0
    assert int(row["overflow"]) == 0
    assert abs(float(row["mass"]) / (cfg.nx * cfg.ny) - 1.0) < 1e-5


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """No module of lbmdem_tpu_torch/, and not chip_smoke.py, imports
    jax or anything of the JAX package lbmdem_tpu."""
    files = glob.glob(os.path.join(ROOT, "lbmdem_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lbmdem_tpu"), (path, mod)
