"""Multi-process runs of the port (`lbmdem_tpu_torch/parallel/launch.py`,
the CLI's --distributed) on the CPU: two gloo processes, started here
on a free port of 127.0.0.1 as torchrun starts them (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK), each holding 2 shards of a
4-position mesh, against a one-process mesh of the same shape
(`Mesh(["cpu"] * 4, dims)`, which every rank also runs), under
torch.equal:

- meshes 2 x 2 (rows on different ranks: the y exchange crosses them)
  and 1 x 4 (the x exchange crosses them);
- the sharded fluid step on the kernels' plain versions at k = 1 (K4 and
  the edge fixups), 4 and 8 (K5 on frames, one and two row sweeps), two
  calls each;
- 16 steps of a small coupled column through Simulation(mesh=...).run
  (the cadence chunk: the binning overflow, the force sums over the
  shards), and the state handed across by interop.mesh_state_from_numpy;
- the same column at coupling_k = 4 (the window: K1 + K6 per shard, the
  stacked force sums of its k steps over the ranks) and with
  f_storage="bfloat16" (16-row bf16 frames), and an all-fixed bed
  through the static hoist (K7 on frames over solid windows stamped
  once), 5 steps;
- the plain sharded step with paranoid mode (the halo exchange of the
  post-collision frames, the paranoid minimum over the ranks);
- the CLI with --distributed on a small coupled deck: rank 0's files
  equal the one-process --mesh 2x2 run's (metrics.csv but for its
  wall-clock MLUPS column);
- a single process: init_distributed / process_info, idempotent.

The pair of processes runs once per module and records each check;
the whole file takes about a minute."""

import csv
import json
import os
import socket
import subprocess
import sys

import pytest

from lbmdem_tpu_torch import cli

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

_WORKER = r'''
import json, sys
import torch
torch.set_num_threads(1)
from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation
from lbmdem_tpu_torch.interop import mesh_state_from_numpy, state_to_numpy
from lbmdem_tpu_torch.parallel import (Mesh, init_distributed, make_mesh,
                                       make_sharded_step, process_info,
                                       unshard)

init_distributed(device="cpu")
rank = process_info()[0]
res = {"info": list(process_info())}


def equal(a, b):
    """Two SimStates under torch.equal, field by field."""
    return (torch.equal(a.f, b.f) and all(torch.equal(x, y) for x, y in
                                          zip(a.disks, b.disks))
            and all(torch.equal(getattr(a, k), getattr(b, k)) for k in
                    ("step", "overflow", "n_contacts", "fail_step")))


def meshes(dims):
    n = dims[0] * dims[1]
    return Mesh(["cpu"] * n, dims), make_mesh(["cpu"] * n, dims)


for dims in ((2, 2), (1, 4)):
    tag = f"{dims[0]}x{dims[1]}"
    one, many = meshes(dims)
    res[f"ranks-{tag}"] = many.ranks
    cfg = SimConfig(nx=128 * dims[1], ny=32 * dims[0], tau=0.7, gy=-1e-5,
                    bc_west="wall", bc_east="wall", uw_north=0.05)
    for k in (1, 4, 8):
        sims = [Simulation(cfg, mesh=m) for m in (one, many)]
        for s in sims:
            step = make_sharded_step(s.cfg, None, s.mesh, True, temporal_k=k)
            for _ in range(2):
                s._advance(step)
        res[f"fluid-k{k}-{tag}"] = equal(sims[0].state, sims[1].state)
    ccfg = SimConfig(nx=128 * dims[1], ny=64 * dims[0], tau=0.8,
                     g_py=-1e-4, buoyancy=True, rho_s=2.0, kn=0.5,
                     gamma_n=0.5, n_sub=5, bc_west="wall", bc_east="wall",
                     out_interval=8)
    disks = [DiskSpec(40.0 + 21.0 * i, 20.0 + 9.0 * j + 3.0 * (i % 2), 3.0)
             for i in range(4) for j in range(3)]
    sims = [Simulation(ccfg, disks, mesh=m) for m in (one, many)]
    for s in sims:
        s.run(16)
    res[f"coupled-{tag}"] = (equal(sims[0].state, sims[1].state)
                             and float(sims[0].state.disks.v.abs().max()) > 0)
    # the window: K1 + K6 per shard, K3w per replica, the stacked (k, ...)
    # force sums over the ranks
    wins = [Simulation(ccfg.replace(coupling_k=4), disks, mesh=m)
            for m in (one, many)]
    for s in wins:
        s.run(16)
    res[f"window-{tag}"] = (equal(wins[0].state, wins[1].state)
                            and not torch.equal(wins[0].state.f,
                                                sims[0].state.f))
    # bf16 storage: K1 + K2 on 16-row bf16 frames with the edge fixups
    bf = [Simulation(ccfg.replace(f_storage="bfloat16"), disks, mesh=m)
          for m in (one, many)]
    for s in bf:
        s.run(16)
    res[f"bf16-{tag}"] = (equal(bf[0].state, bf[1].state)
                          and bf[0].state.f.dtype == torch.bfloat16)
    # an all-fixed bed: the static hoist (solid windows stamped once,
    # K7 on frames), one disk on an x seam and one beside the y seam
    scfg = SimConfig(nx=128 * dims[1], ny=64 * dims[0], tau=0.8,
                     max_disks=3, kn=2.0, gamma_n=1.0, n_sub=10, gx=1e-5,
                     g_py=0.0, bc_west="wall", bc_east="wall",
                     uw_north=0.02, out_interval=5)
    sdisks = [DiskSpec(128.0, 20.0, 5.0, fixed=True),
              DiskSpec(60.0, 16.0, 4.0, fixed=True),
              DiskSpec(200.0, 32.0 * dims[0] - 2.0, 4.0, fixed=True)]
    stat = [Simulation(scfg, sdisks, mesh=m) for m in (one, many)]
    for s in stat:
        s.run(5)
    res[f"static-{tag}"] = (equal(stat[0].state, stat[1].state)
                            and stat[0].static_solid and stat[1].static_solid)
    moved = mesh_state_from_numpy(state_to_numpy(sims[0].state), many)
    res[f"interop-{tag}"] = (equal(unshard(moved, many), sims[0].state)
                             and all(f is None for p, f in enumerate(moved.f)
                                     if many.ranks[p] != rank))
    pcfg = SimConfig(nx=16 * dims[1], ny=16 * dims[0], tau=0.8,
                     dtype="float64", g_py=-1e-4, buoyancy=True, rho_s=2.5,
                     kn=0.5, gamma_n=0.5, n_sub=5, bc_west="wall",
                     bc_east="wall", paranoia=True)
    pdisks = [DiskSpec(9.0, 9.0, 2.5), DiskSpec(5.2, 3.5, 1.5, vx=0.01)]
    sims = [Simulation(pcfg, pdisks, mesh=m, use_kernels=False)
            for m in (one, many)]
    for s in sims:
        s.run(4)
    res[f"plain-{tag}"] = (equal(sims[0].state, sims[1].state)
                           and int(sims[1].state.fail_step) == -1)
with open(sys.argv[1] + f"/rank{rank}.json", "w") as fh:
    json.dump(res, fh)
print("WORKER_OK", rank, flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(argv, cwd, timeout=240):
    """Run argv in two processes of one gloo group, as torchrun starts
    them; returns [(rc, stdout, stderr)] by rank."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, cwd=cwd, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    """Each rank's record of the checks, {name: result}, from one run of
    the worker in two processes."""
    d = tmp_path_factory.mktemp("dist")
    outs = _two_ranks([sys.executable, "-c", _WORKER, str(d)], ROOT)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"WORKER_OK {r}" in out, (
            f"rank {r}: rc={rc}\n{err[-3000:]}")
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


def test_two_ranks_hold_the_mesh_in_rank_order(checks):
    """process_info is the JAX tuple; the positions go to the ranks in
    blocks in rank order: rank 0 the first row of a 2 x 2 mesh, the
    first two columns of a 1 x 4."""
    for r, res in enumerate(checks):
        assert res["info"] == [r, 2, 1, 2]
        assert res["ranks-2x2"] == res["ranks-1x4"] == [0, 0, 1, 1]


@pytest.mark.parametrize("dims", ["2x2", "1x4"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_two_ranks_fluid_equals_one_process(checks, dims, k):
    """Two calls of the sharded fluid step at temporal_k = k: every
    rank's gathered state equals the one-process mesh's."""
    assert all(res[f"fluid-k{k}-{dims}"] for res in checks)


@pytest.mark.parametrize("dims", ["2x2", "1x4"])
@pytest.mark.parametrize("what", ["coupled", "interop", "plain"])
def test_two_ranks_coupled_equals_one_process(checks, dims, what):
    """16 coupled steps of a column (the disks move), the state handed
    onto the two-rank mesh from numpy (each rank holds only its own
    shards), and 4 paranoid steps of the plain sharded step in float64:
    each equal to the one-process mesh."""
    assert all(res[f"{what}-{dims}"] for res in checks)


@pytest.mark.parametrize("dims", ["2x2", "1x4"])
@pytest.mark.parametrize("what", ["window", "static", "bf16"])
def test_two_ranks_window_static_bf16_equal_one_process(checks, dims, what):
    """The column at coupling_k = 4 (16 steps: four windows, the stacked
    (k, ...) force sums across the ranks), an all-fixed bed through the
    static hoist (run(5): K7 passes of 4 and 1 over solid windows stamped
    once) and the column with f_storage="bfloat16" (16 steps on 16-row
    bf16 frames, on the CPU the kernels' plain versions): each equal to
    the one-process mesh."""
    assert all(res[f"{what}-{dims}"] for res in checks)


def _deck(tmp_path):
    (tmp_path / "disks.txt").write_text(
        "".join(f"{40 + 21 * i} {20 + 9 * j + 3 * (i % 2)} 3.0\n"
                for i in range(8) for j in range(4)))
    deck = tmp_path / "column.par"
    deck.write_text("nx 256\nny 128\ntau 0.8\nsteps 16\nout_interval 8\n"
                    "kn 0.5\ngamma_n 0.5\nrho_s 2.0\nn_sub 5\ng_py -1e-4\n"
                    "buoyancy 1\nbc west wall\nbc east wall\n"
                    "bc south wall\nbc north wall\nparticles disks.txt\n")
    return str(deck)


def _rows(path):
    with open(path, newline="") as fh:
        return [{k: v for k, v in row.items() if k != "mlups"}
                for row in csv.DictReader(fh)]


def test_cli_distributed_files_equal_one_process(tmp_path):
    """`python -m lbmdem_tpu_torch.cli deck --distributed --mesh 2x2
    --device cpu --kernels` in two processes: each prints its line on
    stderr, rank 0 writes the files, and they equal the one-process
    --mesh 2x2 run's byte for byte (metrics.csv row for row, but for
    the wall-clock MLUPS)."""
    deck = _deck(tmp_path)
    args = [deck, "--mesh", "2x2", "--device", "cpu", "--kernels"]
    assert cli.main(args + ["--out", str(tmp_path / "one")]) == 0
    outs = _two_ranks([sys.executable, "-m", "lbmdem_tpu_torch.cli", *args,
                       "--distributed", "--out", str(tmp_path / "two")],
                      ROOT)
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {r}: rc={rc}\n{err[-3000:]}"
        assert (f"distributed: process {r}/2, 1 local / 2 global devices"
                in err)
    assert "done: 16 steps" in outs[0][1] and "done:" not in outs[1][1]
    one, two = tmp_path / "one", tmp_path / "two"
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two))
    assert "fluid_00000016.vtk" in names and "trajectories.csv" in names
    for name in names:
        if name == "metrics.csv":
            assert _rows(one / name) == _rows(two / name)
        else:
            assert (one / name).read_bytes() == (two / name).read_bytes(), name


def test_init_distributed_single_process():
    """The launch path with a group of one (the same code path a
    multi-process launch takes), in a process of its own: process 0 of
    1 with the CPU as its device, idempotent, and make_mesh over the
    default devices holds every position."""
    code = f"""
from lbmdem_tpu_torch.parallel import init_distributed, make_mesh, process_info
init_distributed(coordinator_address='127.0.0.1:{_free_port()}',
                 num_processes=1, process_id=0, device='cpu')
assert process_info() == (0, 1, 1, 1), process_info()
init_distributed()  # idempotent
m = make_mesh(shape=(2, 2))
assert m.ranks == [0] * 4 and not m.distributed and len(m.positions()) == 4
print('DIST_OK')
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert "DIST_OK" in r.stdout, r.stderr[-2000:]
