"""Stage ablation of the coupled step on the card: where a step's time
goes.

Counterpart of the JAX package's `tools/ablate.py`. Each variant is the
coupled step with one stage replaced by a cheap substitute that keeps
the dataflow alike (every remaining stage still consumes values derived
from the ablated stage's inputs); the marginal cost of a stage is the
difference between the "full" variant's time and its "no-<stage>"
variant's. The f32 variants run the split step - K1 stamp, K8
`fused_step_imb`, K9 `reduce_hydro_forces`, then the DEM - and "fused"
runs the production K2 step beside them; with ABLATE_F_STORAGE=bfloat16
every variant runs the K2 step (the split pair is f32-only; the reduce
ablates through zeroed counts, "full" is "fused" and timed once, and
"no-lbm" has no counterpart); with
ABLATE_COUPLING_K = k > 1 the variants run the window step (K1 once, K6,
k DEM updates).

PyTorch runs eagerly: nothing is dead-code eliminated or hoisted, so
the substitutes only keep the variants' shapes alike. The marginals are
differences of separately timed runs; each row prints the spread of its
3 timed chunks beside the best. The eager step is bound by the host's
launches as much as by the card, so on the card each row also prints
the device time per step of PROFILED_STEPS more calls under
torch.profiler (the sum of their kernels' times), and the marginals are
given in both. Each
row also prints the kernel launches per step from the wrappers'
counters. The slab DEM reads one scalar (its overflow) per step, as
`Simulation`'s step does.

    python -m lbmdem_tpu_torch.tools.ablate [nx] [n_disks] [chunk] [names]

`nx` (default 4096) is the side of the column_collapse scene with
`n_disks` (10000) disks; `chunk` (50) steps per timed chunk; `names` a
comma-separated subset of the variants. ABLATE_EPS (sample | ramp |
exact), ABLATE_F_STORAGE (float32 | bfloat16) and ABLATE_COUPLING_K (1)
set the scene's options, as in the JAX tool.
It runs on the card and raises without one.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from lbmdem_tpu_torch.models import column_collapse
from lbmdem_tpu_torch.ops import dem, fused_lbm, slab_dem, stamp
from lbmdem_tpu_torch.simulation import BIN_MARGIN, Simulation

# the kernel wrappers whose launches a row reports
WRAPPERS = {"K1": stamp.stamp_fields, "K2": fused_lbm.fused_step_imb_reduce,
            "K3": slab_dem.subcycle_slabs,
            "K6": fused_lbm.fused_step_imb_reduce_multi,
            "K3w": slab_dem.subcycle_slabs_window,
            "K8": fused_lbm.fused_step_imb,
            "K9": stamp.reduce_hydro_forces}


# calls per variant under torch.profiler (its device-time column)
PROFILED_STEPS = 10


def _tiny(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * 1e-30


def build_variants(cfg, grid, axis: str = "y") -> dict:
    """name -> step(state, lists, counts, entry_slots, f_out) -> SimState.

    The tile lists are passed in, built once outside the timed loop (at
    the Verlet cadence in production); the "full+bin" variant rebuilds
    them every step. Each step writes the new populations into `f_out`
    (the second f buffer) and returns the state holding it."""
    n = cfg.max_disks
    plane = (cfg.ny, cfg.nx)

    def inputs(state, lists, counts, entry_slots, do_bin, do_gather,
               do_stamp):
        """(tile_data, counts, entry_slots, solid) of one step."""
        d = state.disks
        if do_bin:
            lists, counts, entry_slots, _ = stamp.build_tile_lists(
                d.x, d.active, cfg, margin=BIN_MARGIN)
        if do_gather:
            tile_data = stamp.gather_tile_data(lists, d.x, d.v, d.omega, d.r,
                                               d.active)
        else:
            n_tiles, cap = lists.shape
            tile_data = (torch.zeros((n_tiles, 1, cap * 8),
                                     dtype=torch.float32, device=d.x.device)
                         + torch.sum(_tiny(d.x)) + torch.sum(_tiny(lists)))
        if do_stamp:
            solid = stamp.stamp_fields(tile_data, counts, cfg)
        else:
            solid = (torch.zeros((3,) + plane, dtype=torch.float32,
                                 device=d.x.device)
                     + torch.sum(_tiny(tile_data)))
        return tile_data, counts, entry_slots, solid

    def ablated_dem(state, d, fh):
        """Positions and velocities advanced by a live function of fh."""
        nd = d._replace(x=d.x + _tiny(fh).to(d.x.dtype),
                        v=d.v + _tiny(fh).to(d.x.dtype))
        return nd, state.overflow, state.n_contacts

    def finish(state, fnew, disks, ovf, nc, steps=1):
        return state._replace(f=fnew, disks=disks, step=state.step + steps,
                              overflow=torch.maximum(state.overflow, ovf),
                              n_contacts=nc)

    def split_step(state, d, solid, tile_data, counts, entry_slots, do_lbm,
                   do_reduce, f_out):
        """K8 then K9, each or its substitute: (f', F, T)."""
        eps, usx, usy = solid[0], solid[1], solid[2]
        if do_lbm:
            fnew, phix, phiy = fused_lbm.fused_step_imb(
                state.f, eps, usx, usy, cfg, f_out)
        else:
            # one pass over f (the floor's cost), live in the solid stack
            # through one scalar reduction, and one phi plane
            live = torch.sum(solid) * 1e-30
            fnew = torch.add(state.f, live.to(state.f.dtype), out=f_out)
            phix = torch.zeros(plane, dtype=torch.float32,
                               device=d.x.device) + live
            phiy = phix
        if do_reduce:
            fh, th = stamp.reduce_hydro_forces(
                d.x, d.r, d.active, eps, phix, phiy, cfg, tile_data, counts,
                entry_slots)
        else:
            live = torch.zeros((n,), dtype=torch.float32,
                               device=d.x.device) + torch.sum(
                _tiny(phix[0]) + _tiny(phiy[0]) + _tiny(eps[0]))
            fh = torch.stack([live, live], 1).to(d.x.dtype)
            th = live.to(d.x.dtype)
        return fnew, fh, th

    def assemble(do_bin, do_stamp, do_lbm, do_reduce, dem_kind,
                 do_gather=True):
        def step(state, lists, counts, entry_slots, f_out):
            d = state.disks
            if do_lbm == "floor":
                # one f pass + a disk touch: the irreducible floor
                torch.add(state.f, 1e-30, out=f_out)
                return state._replace(
                    f=f_out, disks=d._replace(x=d.x + _tiny(d.v).to(d.x.dtype)),
                    step=state.step + 1)
            tile_data, counts, entry_slots, solid = inputs(
                state, lists, counts, entry_slots, do_bin, do_gather,
                do_stamp)
            if do_lbm == "fused":
                # the production step, K2 (the only coupled step on bf16
                # storage): its reduce ablates through zeroed counts (no
                # slot is reduced, the partials stay live)
                rcounts = counts if do_reduce else torch.zeros_like(counts)
                fnew, partials = fused_lbm.fused_step_imb_reduce(
                    state.f, solid, tile_data, rcounts, cfg, f_out)
                fh, th = stamp.gather_partials(partials, entry_slots,
                                               d.x.dtype)
            else:
                fnew, fh, th = split_step(state, d, solid, tile_data, counts,
                                          entry_slots, do_lbm, do_reduce,
                                          f_out)
            if dem_kind == "slab":
                return finish(state, fnew, *slab_dem.dem_subcycle(
                    d, fh, th, grid, cfg, axis))
            if dem_kind == "xla":  # the cell-list DEM
                return finish(state, fnew, *dem.dem_subcycle(d, fh, th, grid,
                                                             cfg))
            if dem_kind == "build":
                # build_slabs only: the slab build apart from K3 + unslab
                slabs, slot, _, kmax, _, _, _ = slab_dem.build_slabs(
                    d, fh, th, dem.body_forces(d, cfg), grid, axis,
                    kt=cfg.kt > 0.0)
                live = (_tiny(slabs[0, 0, 0, :2].sum()) + _tiny(slot[0])
                        + _tiny(kmax)).to(d.x.dtype)
                disks = d._replace(x=d.x + _tiny(fh).to(d.x.dtype) + live,
                                   v=d.v + _tiny(fh).to(d.x.dtype))
                return finish(state, fnew, disks, state.overflow,
                              state.n_contacts)
            return finish(state, fnew, *ablated_dem(state, d, fh))

        return step

    def assemble_window(ck, do_bin, do_stamp, do_reduce, dem_kind,
                        do_gather=True):
        """The coupling_k window step (K1 once, K6, ck DEM updates); the
        reduce ablates through zeroed counts (no slot is reduced, the
        partials stay live through the DEM)."""

        def step(state, lists, counts, entry_slots, f_out):
            d = state.disks
            tile_data, counts, entry_slots, solid = inputs(
                state, lists, counts, entry_slots, do_bin, do_gather,
                do_stamp)
            rcounts = counts if do_reduce else torch.zeros_like(counts)
            fnew, parts = fused_lbm.fused_step_imb_reduce_multi(
                state.f, solid, tile_data, rcounts, cfg, ck, f_out)
            forces = [stamp.gather_partials(parts[t], entry_slots, d.x.dtype)
                      for t in range(ck)]
            if dem_kind == "slab":
                return finish(state, fnew, *slab_dem.dem_subcycle_window(
                    d, forces, grid, cfg, axis), steps=ck)
            acc = forces[0][0]
            for fh, _ in forces[1:]:
                acc = acc + fh
            return finish(state, fnew, *ablated_dem(state, d, acc), steps=ck)

        return step

    floor = assemble(False, False, "floor", False, None)
    ck = cfg.coupling_k
    if ck > 1:
        return {
            "floor": floor,
            "full": assemble_window(ck, False, True, True, "slab"),
            "full+bin": assemble_window(ck, True, True, True, "slab"),
            "no-stamp": assemble_window(ck, False, False, True, "slab"),
            "no-reduce": assemble_window(ck, False, True, False, "slab"),
            "no-dem": assemble_window(ck, False, True, True, None),
            "no-gather": assemble_window(ck, False, True, True, "slab",
                                         do_gather=False),
        }
    # the split pair is f32-only: on bf16 storage every variant runs the
    # K2 step, "full" and "fused" are one variant (timed once), and
    # "no-lbm" has no counterpart
    bf16 = cfg.f_storage == "bfloat16"
    lbm = "fused" if bf16 else True
    fused = assemble(False, True, "fused", True, "slab")
    table = {
        "floor": floor,
        "fused": fused,
        "full": fused if bf16 else assemble(False, True, True, True, "slab"),
        "full+bin": assemble(True, True, lbm, True, "slab"),
        "no-stamp": assemble(False, False, lbm, True, "slab"),
        "no-lbm": assemble(False, True, False, True, "slab"),
        "no-reduce": assemble(False, True, lbm, False, "slab"),
        "no-dem": assemble(False, True, lbm, True, None),
        "no-gather": assemble(False, True, lbm, True, "slab",
                              do_gather=False),
        "dem-build": assemble(False, True, lbm, True, "build"),
        "xla-dem": assemble(False, True, lbm, True, "xla"),
    }
    if bf16:
        del table["no-lbm"]
    return table


def make_sim(nx: int = 4096, n_disks: int = 10000, device="cuda",
             env=None) -> Simulation:
    """The column_collapse scene of side nx with n_disks disks and the
    ABLATE_* options of `env` (default os.environ)."""
    env = os.environ if env is None else env
    cfg, disks = column_collapse(nx=nx, ny=nx, n_disks=n_disks)
    cfg = cfg.replace(out_interval=10**9,
                      eps_method=env.get("ABLATE_EPS", "sample"),
                      f_storage=env.get("ABLATE_F_STORAGE", "float32"),
                      coupling_k=int(env.get("ABLATE_COUPLING_K", "1")))
    return Simulation(cfg, disks, device=device)


def _device_ms(fn):
    """(fn(), the summed kernel time in ms of the call) under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(a.self_device_time_total for a in prof.key_averages()
             if a.device_type == DeviceType.CUDA)
    return out, us / 1e3


def run_variants(sim: Simulation, chunk: int = 50, names=None,
                 log=print) -> dict:
    """Time each variant from the scene's initial state: one warm chunk
    of `chunk` steps, then 3 timed chunks (CUDA events on the card, the
    host clock on the CPU), then on the card PROFILED_STEPS profiled
    calls. Prints one row per variant and the marginals; returns {name:
    {"ms": best ms per LBM step, "chunks": the 3 chunks' ms per step, "device_ms": the
    profiled chunk's kernel time per step (None on the CPU), "launches":
    kernel launches per step of the timed chunks}}."""
    cfg = sim.cfg
    variants = build_variants(cfg, sim.grid, sim.dem_axis)
    if names:
        variants = {k: variants[k] for k in names}
    s0 = sim.state
    d0 = s0.disks
    lists, counts, entry_slots, _ = stamp.build_tile_lists(
        d0.x, d0.active, cfg, margin=BIN_MARGIN)
    cuda = s0.f.device.type == "cuda"
    results = {}
    timed = {}  # step -> the name it was timed under
    for name, step in variants.items():
        if step in timed:  # the same variant under a second name
            results[name] = results[timed[step]]
            log(f"{name:10s} is {timed[step]} (timed once)")
            continue
        timed[step] = name
        state = s0._replace(f=s0.f.clone())
        spare = torch.empty_like(s0.f)

        def run_chunk(state, spare, n=chunk, _step=step):
            for _ in range(n):
                new = _step(state, lists, counts, entry_slots, spare)
                spare = state.f
                state = new
            return state, spare

        state, spare = run_chunk(state, spare)
        if cuda:
            torch.cuda.synchronize()
        n0 = {k: w.launches for k, w in WRAPPERS.items()}
        times = []
        for _ in range(3):
            state = state._replace(step=torch.zeros_like(state.step))
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state, spare = run_chunk(state, spare)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                state, spare = run_chunk(state, spare)
                times.append(1e3 * (time.perf_counter() - t0))
        # window mode: one call advances coupling_k LBM steps (the floor
        # stays one f pass per call)
        spc = cfg.coupling_k if name != "floor" else 1
        per = [t / chunk / spc for t in times]
        launches = {k: (w.launches - n0[k]) / (3 * chunk * spc)
                    for k, w in WRAPPERS.items() if w.launches > n0[k]}
        dev = None
        if cuda:  # a short chunk: the profiler's cost grows with events
            n_prof = min(chunk, PROFILED_STEPS)
            (state, spare), dms = _device_ms(
                lambda: run_chunk(state, spare, n_prof))
            dev = dms / n_prof / spc
        results[name] = {"ms": min(per), "chunks": per, "device_ms": dev,
                         "launches": launches}
        dtxt = "" if dev is None else f"; device {dev:.3f} ms/step"
        log(f"{name:10s} {min(per):8.3f} ms/step  (chunks "
            f"{', '.join(f'{p:.3f}' for p in per)}{dtxt}; launches/step "
            f"{launches}; overflow {int(state.overflow)})")
    full = results.get("full")
    if full is not None:
        spread = max(full["chunks"]) - min(full["chunks"])
        log(f"marginals vs full (slab DEM, lists prebuilt; differences of "
            f"separately timed runs, full's chunk spread {spread:.3f} ms; "
            f"wall, then device where profiled):")

        def diff(a, b):
            ms = f"{a['ms'] - b['ms']:8.3f} ms"
            if a["device_ms"] is not None and b["device_ms"] is not None:
                ms += f"  {a['device_ms'] - b['device_ms']:8.3f} ms"
            return ms

        for name, r in results.items():
            if name.startswith("no-"):
                log(f"  {name[3:]:8s} {diff(full, r)}")
            elif name == "full+bin":
                log(f"  binning  {diff(r, full)} (per-step rebuild)")
            elif name == "xla-dem":
                log(f"  xla-dem  {diff(r, full)} (cell-list DEM vs slab)")
            elif name == "fused" and r is not full:
                log(f"  fused    {diff(r, full)} (K2 vs K8 + K9)")
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    nx = int(argv[0]) if len(argv) > 0 else 4096
    nd = int(argv[1]) if len(argv) > 1 else 10000
    chunk = int(argv[2]) if len(argv) > 2 else 50
    names = argv[3].split(",") if len(argv) > 3 else None
    sim = make_sim(nx, nd)
    print(f"column_collapse {nx}x{nx}, {nd} disks, eps_method "
          f"{sim.cfg.eps_method}, coupling_k {sim.cfg.coupling_k}, chunk "
          f"{chunk}, on {torch.cuda.get_device_name(0)}", flush=True)
    run_variants(sim, chunk, names,
                 log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
