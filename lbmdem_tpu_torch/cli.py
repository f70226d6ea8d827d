"""Command-line entry point, as the JAX package's `lbmdem_tpu/cli.py`:

    python -m lbmdem_tpu_torch.cli run.par --out out/

runs a reference-format deck on the card (`--device cpu` runs it on the
CPU). The step loop runs in out_interval chunks; each interval writes
the VTK snapshots, appends the metrics CSV and the particle trajectory
log and, with --checkpoint-every, a restart checkpoint, on a background
writer unless --sync-io.

The path is chosen per deck, as the JAX CLI chooses its Pallas path: on
the card the CUDA kernels where `kernels_supported` passes, otherwise the
plain path with a note on stderr; on the CPU the plain path. --kernels
asks for the kernels (an error where they cannot take the deck; on the
CPU they run as their plain versions), --no-kernels for the plain path.

--mesh YxX shards the lattice over a Y x X mesh of devices in this
process (the JAX CLI's --mesh): on the card over the visible cards,
taken in turn, so a mesh larger than the host's cards puts several
shards on a card; with --device cpu every shard on the CPU. --mesh auto
takes every visible card. On a mesh the auto path takes the pre-haloed
kernels where `kernels_supported(..., mesh)` passes, else the plain
sharded step.

--distributed joins a torch.distributed group first
(`parallel.init_distributed`: the topology from what torchrun sets;
NCCL on the card, gloo with --device cpu) and the mesh then spans every
process's devices in rank order (--mesh auto: every global card), one
process per card:

    torchrun --nproc-per-node 4 -m lbmdem_tpu_torch.cli run.par \
        --distributed --mesh 2x2

Every rank runs the same loop; rank 0 alone writes the output files and
prints the step lines, which equal a one-process mesh's.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lbmdem_tpu_torch",
        description="2D coupled LBM-DEM solver in PyTorch with CUDA kernels "
                    "for NVIDIA Hopper",
    )
    ap.add_argument("paramfile", help="reference-format parameter file")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--steps", type=int, default=None, help="override steps")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=None, help="use the hand-written CUDA kernels "
                    "(default: auto - on the card when the config supports "
                    "them); --no-kernels takes the plain path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default; an error without one) "
                         "or on the CPU")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="N", help="write restart checkpoint every N steps")
    ap.add_argument("--restore", default=None, metavar="CKPT",
                    help="resume from checkpoint file")
    ap.add_argument("--ascii-vtk", action="store_true")
    ap.add_argument("--log-forces", action="store_true",
                    help="append per-disk hydrodynamic force/torque to "
                         "forces.csv at every output interval (drag/lift "
                         "time series; one extra IMB observation per "
                         "dump - Simulation.hydro_forces)")
    ap.add_argument("--sync-io", action="store_true",
                    help="write snapshots inline instead of overlapping "
                         "file I/O with the next chunk's device execution "
                         "(utils/async_io.py)")
    ap.add_argument("--paranoid", nargs="?", const="step", default=None,
                    choices=("step", "chunk"),
                    help="validate f/rho/disks on the device during the "
                         "run and abort at the failing step. Bare "
                         "--paranoid = per-step (exact step, forfeits the "
                         "fast chunk structures); --paranoid chunk "
                         "validates at kernel-chunk granularity (the "
                         "reported step is the end of the failing block)")
    ap.add_argument("--mesh", default=None, metavar="YxX",
                    help="shard the lattice over a Y x X mesh of devices "
                         "('auto': every visible card, with --distributed "
                         "every process's; with --device cpu the shards "
                         "share the CPU)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed group first (one process "
                         "per card on NCCL, gloo with --device cpu; the "
                         "topology from torchrun's RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT, LOCAL_RANK; see "
                         "parallel/launch.py); the mesh spans every "
                         "process's devices and rank 0 writes the files")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="record a torch.profiler trace of the run into "
                         "LOGDIR/trace.json, with the program's lbmdem.* "
                         "spans (lbmdem.sync.* for each wait on the "
                         "device; their counts: utils/profiling.counters)")
    ap.add_argument("--scenario", default=None,
                    help="run a built-in scenario instead of a paramfile "
                         "(poiseuille|sedimentation|dkt|settling_column|"
                         "column_collapse); paramfile arg is ignored")
    args = ap.parse_args(argv)

    rank = 0
    if args.distributed:
        from lbmdem_tpu_torch.parallel import init_distributed, process_info

        init_distributed(device=args.device)
        rank, pn, loc, glob = process_info()
        print(f"distributed: process {rank}/{pn}, {loc} local / "
              f"{glob} global devices", file=sys.stderr)
    writes = rank == 0  # the one rank that prints and writes the files
    mesh = None
    if args.mesh:
        from lbmdem_tpu_torch.parallel import make_mesh

        if args.mesh == "auto":
            if args.device == "cpu":
                ap.error("--mesh auto takes the visible cards; give YxX "
                         "with --device cpu")
            mesh = make_mesh()
        else:
            try:
                ysz, xsz = (int(t) for t in args.mesh.lower().split("x"))
            except ValueError:
                ap.error(f"--mesh {args.mesh!r}: expected YxX or auto")
            mesh = make_mesh(["cpu"] * (ysz * xsz) if args.device == "cpu"
                             else None, shape=(ysz, xsz))

    from lbmdem_tpu_torch.config import load_param_file, load_particle_file
    from lbmdem_tpu_torch.simulation import (Simulation, derive_config,
                                             kernels_supported)
    from lbmdem_tpu_torch.utils import checkpoint as ckpt
    from lbmdem_tpu_torch.utils.async_io import AsyncWriter
    from lbmdem_tpu_torch.utils.io_vtk import (
        append_force_csv, append_particle_csv, write_fluid_vtk,
        write_particles_vtk,
    )
    from lbmdem_tpu_torch.utils.metrics import MetricsLogger

    if args.scenario:
        from lbmdem_tpu_torch.models import make_scenario

        cfg, disks = make_scenario(args.scenario)
    else:
        cfg, pfile = load_param_file(args.paramfile)
        disks = load_particle_file(pfile, units=cfg.units) if pfile else []
    if args.steps is not None:
        cfg = cfg.replace(steps=args.steps)
    if args.paranoid:
        cfg = cfg.replace(
            paranoia=True if args.paranoid == "step" else args.paranoid
        )
    on_card = args.device == "cuda"
    if args.kernels is None or args.kernels:
        reason = kernels_supported(derive_config(cfg, disks)[0], args.device,
                                   mesh)
        if args.kernels and reason is not None:
            ap.error(f"--kernels: {reason}")
        if args.kernels is None:
            # auto: the kernels on the card where they take the deck;
            # the plain path on the CPU (there the kernels would run as
            # their plain versions)
            args.kernels = on_card and reason is None
            if on_card and reason is not None:
                print(f"note: the kernels cannot take this deck; using the "
                      f"plain path ({reason})", file=sys.stderr)

    sim = Simulation(cfg, disks, device=args.device, use_kernels=args.kernels,
                     mesh=mesh)
    if mesh is not None:
        print(f"mesh: {mesh.shape['y']}x{mesh.shape['x']} shards on "
              f"{len(mesh.replicas)} device(s), "
              f"{'kernels' if args.kernels else 'plain path'}",
              file=sys.stderr)
    cfg = sim.cfg  # Simulation derives max_disks/window/tile_cap
    if args.restore:
        sim.state = ckpt.load_state(args.restore, sim.state)
        step = int(sim.state.step)
        if writes:
            print(f"restored from {args.restore} at step {step}")

    if writes:
        os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.csv")
                           if writes else None)
    writer = AsyncWriter(max_pending=0 if args.sync_io else 2)

    def emit(fn, *a, **kw):
        # --sync-io: run inline; default: overlap file work with the next
        # chunk (the arguments are host copies, never the live state).
        # Across processes every rank makes the snapshot's reads (each a
        # collective gather) and rank 0 alone writes.
        if not writes:
            return
        if args.sync_io:
            fn(*a, **kw)
        else:
            writer.submit(fn, *a, **kw)

    def snapshot(s: Simulation):
        step = int(s.state.step)
        row = logger.log(s)
        if writes:
            print(f"step {step:8d}  mass={row['mass']:.6e}  "
                  f"max_u={row['max_u']:.4f}  "
                  f"contacts={int(row['n_contacts'])}  "
                  f"overflow={int(row['overflow'])}  "
                  f"{row['mlups']:.0f} MLUPS", flush=True)
        if row["nan"]:
            raise RuntimeError(f"NaN in distributions at step {step}")
        rho, ux, uy = s.macroscopic()
        eps = s.solid_fraction() if cfg.max_disks else None
        emit(
            write_fluid_vtk,
            os.path.join(args.out, f"fluid_{step:08d}.vtk"),
            rho, ux, uy, eps, binary=not args.ascii_vtk,
        )
        if cfg.max_disks:
            d = s.disk_arrays()
            emit(
                write_particles_vtk,
                os.path.join(args.out, f"particles_{step:08d}.vtk"), d,
            )
            emit(
                append_particle_csv,
                os.path.join(args.out, "trajectories.csv"), step, d,
            )
            if args.log_forces:
                # hydro_forces() reads back here; only the file append
                # rides the asynchronous writer
                F, T = s.hydro_forces()
                emit(
                    append_force_csv,
                    os.path.join(args.out, "forces.csv"), step,
                    d["active"], F, T,
                )
        if args.checkpoint_every and step % args.checkpoint_every == 0:
            # copy every leaf to the host BEFORE queueing: the next
            # chunk's steps overwrite the state's f buffers
            emit(
                ckpt.save_state,
                os.path.join(args.out, "restart.npz"), ckpt.to_host(s.state),
                s.cfg,
            )

    remaining = cfg.steps - int(sim.state.step)
    if remaining <= 0:
        print("nothing to do (steps already completed)", file=sys.stderr)
        return 0
    run_failed = False
    try:
        if args.profile and writes:
            from lbmdem_tpu_torch.utils.profiling import trace

            with trace(args.profile):
                mlups = sim.run(remaining, callback=snapshot)
        else:
            mlups = sim.run(remaining, callback=snapshot)
    except BaseException:
        run_failed = True
        raise
    finally:
        try:
            writer.close()  # drain pending frames; surface write errors
        except Exception:
            if not run_failed:  # never mask a run() failure
                raise
    if writes:
        print(f"done: {remaining} steps, {mlups:.0f} MLUPS overall")
    return 0


def _main(argv=None) -> int:
    """main, then leave the process group that --distributed joined."""
    try:
        return main(argv)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_main())
