"""A lattice mesh spread over processes, one per card, timed against one
card in the same call.

    python -m lbmdem_tpu_torch.tools.mesh_ranks --ranks 4 \\
        --out chiprun_out/mesh_ranks.json

builds the kernels once, then starts `--ranks` processes as torchrun
starts them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR 127.0.0.1, a free
MASTER_PORT): one per card on NCCL, or with `--device cpu` gloo
processes on the CPU (a rehearsal at a small `--n`). They form one
group (`parallel.init_distributed`) and a 2 x 2 mesh over every rank's
device (`make_mesh`), and run, in turns with one card (one, ranks,
ranks, one, one, ranks; rank 0 alone runs the one-card turns while the
others wait):

- fluid: bench.py's fluid/4096 stage (n^2, tau 0.8, gx 1e-6, periodic x,
  walls in y): one card's run(400) against the ranks' mesh run(400) (K5
  at TEMPORAL_K, one halo exchange per pass) and 400 steps of
  make_sharded_step(temporal_k=8);
- slice: BASELINE config 5, the column collapse (n^2, `--disks` disks):
  one card's run(100) against the ranks' mesh run(100);
- window: the same column at coupling_k = 4 (K1 + K6 on every shard's
  frame, the window DEM per rank, the stacked force sums of the k steps
  over the ranks): run(100);
- static: bench.py's static scene (n^2, (n / 64)^2 fixed disks of r = 4
  on a jittered grid, tau 0.8, gx 1e-6: solid windows stamped once, K7
  on the frames): run(400).

Before the turns each mesh is held against one card after 16 steps:
the fluid's f equal (torch.equal), the column's and the window's f
within 5e-6, disk x within 1e-5 and v within 1e-6, the static bed's f
within 2e-6 and its disks equal (chip_smoke.py's mesh bars). MLUPS is the
wall clock of each turn, the ranks started together at a barrier. Writes
rank 0's JSON record (every reading, the ratios, the checks, the cards'
names and power limits) to --out and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ORDER = ("one", "ranks", "ranks", "one", "one", "ranks")


def static_bed(n: int, n_disks: int):
    """bench.py's static scene: n_disks fixed disks of r = 4 at rest on a
    jittered square grid from default_rng(0), tau 0.8, gx 1e-6, periodic
    x, walls in y (chip_smoke.static_bed)."""
    import numpy as np

    from lbmdem_tpu_torch import DiskSpec, SimConfig

    rng = np.random.default_rng(0)
    side = int(np.ceil(np.sqrt(n_disks)))
    pitch = (n - 40.0) / side
    disks = []
    for i in range(n_disks):
        gy, gx = divmod(i, side)
        disks.append(DiskSpec(20.0 + (gx + 0.5) * pitch + rng.uniform(-2, 2),
                              20.0 + (gy + 0.5) * pitch + rng.uniform(-2, 2),
                              4.0, fixed=True))
    return SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                     max_disks=n_disks), disks


def _worker(args) -> dict:
    import torch
    import torch.distributed as dist

    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.parallel import (init_distributed, local_devices,
                                           make_mesh, make_sharded_step)

    init_distributed(device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = local_devices()[0]
    lead = rank == 0

    def barrier():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()

    def mesh():
        if dev.type == "cuda":
            return make_mesh(shape=(2, 2))
        return make_mesh(["cpu"] * 4, (2, 2))

    n = args.n
    out = {"ranks": world, "n": n, "device": str(dev), "checks": {}}
    column = column_collapse(nx=n, ny=n, n_disks=args.disks)
    # (config, disks, timed steps, bars (f, disk x, disk v) of the check)
    scenes = {
        "fluid": (SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                            out_interval=10**9), [], 400, None),
        "slice": (*column, 100, (5e-6, 1e-5, 1e-6)),
        "window": (column[0].replace(coupling_k=4), column[1], 100,
                   (5e-6, 1e-5, 1e-6)),
        "static": (*static_bed(n, (n // 64) ** 2), 400, (2e-6, 0.0, 0.0)),
    }
    for name, (cfg, disks, steps, bars) in scenes.items():
        cfg = cfg.replace(out_interval=10**9)
        one = Simulation(cfg, disks, device=dev) if lead else None
        sh = Simulation(cfg, disks, mesh=mesh())
        if lead:
            one.run(16)
        sh.run(16)
        got = sh.state  # a collective: every rank gathers
        if lead:
            a = one.state
            ef = float((a.f - got.f).abs().max())
            chk = {"f_equal": bool(torch.equal(a.f, got.f)), "f_err": ef}
            if disks:
                chk["x_err"] = float((a.disks.x - got.disks.x).abs().max())
                chk["v_err"] = float((a.disks.v - got.disks.v).abs().max())
                chk["ok"] = (ef <= bars[0] and chk["x_err"] <= bars[1]
                             and chk["v_err"] <= bars[2])
                if name == "static":
                    chk["ok"] = chk["ok"] and sh.static_solid
            else:
                chk["ok"] = chk["f_equal"]
            out["checks"][name] = chk
        del got
        kinds = ["ranks"] if disks else ["ranks", "ranks k=8"]
        step8 = (None if disks else
                 make_sharded_step(sh.cfg, None, sh.mesh, True, temporal_k=8))
        reads = {k: [] for k in ["one", *kinds]}
        for who in ORDER:
            for kind in (["one"] if who == "one" else kinds):
                barrier()
                t0 = time.perf_counter()
                if kind == "one":
                    if lead:
                        one.run(steps)
                elif kind == "ranks":
                    sh.run(steps)
                else:
                    for _ in range(steps // 8):
                        sh._advance(step8)
                    sh._sync()
                barrier()
                reads[kind].append(n * n * steps
                                   / (time.perf_counter() - t0) / 1e6)
        rec = {"steps": steps, "mlups": reads}
        for kind in kinds:
            rec[f"{kind} / one"] = [m / o for m, o in
                                    zip(reads[kind], reads["one"])]
        out[name] = rec
        del one, sh
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mesh_ranks", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=4096, help="lattice side")
    ap.add_argument("--disks", type=int, default=10000)
    ap.add_argument("--out", default=None, help="JSON record (rank 0's)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:  # a rank: its record into the file the parent names
        import torch.distributed as dist

        rec = _worker(args)
        dist.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            with open(args.worker, "w") as fh:
                json.dump(rec, fh)
        return 0
    if args.ranks not in (1, 2, 4):
        ap.error("the 2 x 2 mesh splits over 1, 2 or 4 ranks")
    cards = ""
    if args.device == "cuda":
        from lbmdem_tpu_torch import kernels

        kernels.library()  # build once, before the ranks load it
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    rec_path = os.path.abspath(args.out or "mesh_ranks.json") + ".rank0"
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(args.ranks))
    cmd = [sys.executable, "-m", "lbmdem_tpu_torch.tools.mesh_ranks",
           "--device", args.device, "--n", str(args.n), "--disks",
           str(args.disks), "--worker", rec_path]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)))
             for r in range(args.ranks)]
    try:
        rcs = [p.wait(timeout=3000) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        print(f"mesh_ranks: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(rec_path) as fh:
        rec = json.load(fh)
    os.remove(rec_path)
    rec["cards"] = cards.splitlines()
    text = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    ok = all(c["ok"] for c in rec["checks"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
