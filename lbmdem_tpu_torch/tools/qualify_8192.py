"""Qualify the coupled main path at 8192^2 with 40 000 disks on the card.

Counterpart of the JAX package's `tools/qualify_8192.py`: the column
collapse (`models.column_collapse(nx=8192, ny=8192, n_disks)`, f32,
sample coverage, coupling_k = 1) through `Simulation`: K1, K2 and the
slab DEM K3 every step. On the card the slab DEM's gate is int32 slot
indices only (`slab_dem.slab_supported`), so nothing is patched: the
tool asserts that the deck takes it. It prints the DEM axis, the slab
plane (R x C, bands), the cold run(50), the best of 3 x run(50) (each
ended by a device sync) as MLUPS beside the card's name and power
limit, and the peak memory, then checks the state: overflow 0, every
population finite and none zero (the reference once left zeros outside
the occupied bands at this size; zeros are finite), mass drift within
1e-5 (bf16 storage 1e-4).

    python -m lbmdem_tpu_torch.tools.qualify_8192 [n_disks] [--device cpu]

n_disks defaults to 40 000. It runs on the card unless given --device
cpu, and raises without a card. `run_stage` serves
`qualify_k8` (the coupling_k window tiers) and `chip_smoke.py`'s 8192^2
phase.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.models import column_collapse
from lbmdem_tpu_torch.ops import slab_dem
from lbmdem_tpu_torch.simulation import Simulation
from lbmdem_tpu_torch.tools.common import (describe_path, device_label, gate,
                                           require_device, sync)

N = 8192
N_DISKS = 40000


def scene(nx: int = N, n_disks: int = N_DISKS, k: int = 1,
          storage: str = "float32", eps: str = "sample"):
    """(cfg, disks): the column collapse of side nx with n_disks disks,
    coupling_k k, f_storage `storage` and eps_method `eps`; out_interval
    past any run, as the JAX tools set it."""
    cfg, disks = column_collapse(nx=nx, ny=nx, n_disks=n_disks)
    return cfg.replace(out_interval=10**9, f_storage=storage,
                       eps_method=eps, coupling_k=k), disks


def make_sim(nx: int = N, n_disks: int = N_DISKS, k: int = 1,
             storage: str = "float32", eps: str = "sample",
             device="cuda") -> Simulation:
    """Simulation(*scene(...)) on `device` (the kernel path)."""
    device = require_device(device)
    return Simulation(*scene(nx, n_disks, k, storage, eps), device=device)


def state_checks(sim: Simulation) -> dict:
    """The state's sanity, plane by plane (one float64 plane at a time
    at 8192^2): overflow, finiteness, the physical populations' minimum
    and zero count (bf16 storage holds the shifted ones, which are 0 at
    rest), and |sum f / (nx ny) - 1|."""
    cfg, st = sim.cfg, sim.state
    shift = cfg.rho0 if st.f.dtype == torch.bfloat16 else 0.0
    w = lattice.W
    mass, fmin, zeros, finite = 0.0, float("inf"), 0, True
    for i in range(9):
        plane = st.f[i].float()
        if shift:
            plane = plane + float(np.float32(w[i] * shift))
        finite = finite and bool(torch.isfinite(plane).all())
        fmin = min(fmin, float(plane.min()))
        zeros += int((plane == 0).sum())
        mass += float(plane.double().sum())
    return {"overflow": int(st.overflow), "finite": finite, "f_min": fmin,
            "zeros": zeros,
            "mass_drift": abs(mass / (cfg.nx * cfg.ny) - 1.0)}


def check_state(sim: Simulation, log=print) -> dict:
    """state_checks, printed and gated: overflow 0, finite, no zero
    population, mass drift < 1e-5 (bf16 storage 1e-4)."""
    c = state_checks(sim)
    bar = 1e-4 if sim.cfg.f_storage == "bfloat16" else 1e-5
    log(f"overflow {c['overflow']}; finite {c['finite']}; min population "
        f"{c['f_min']:.6e}, zero populations {c['zeros']}; mass drift "
        f"{c['mass_drift']:.3e} (bar {bar:g})")
    gate(c["overflow"] == 0, f"overflow {c['overflow']}")
    gate(c["finite"], "non-finite populations")
    gate(c["zeros"] == 0 and c["f_min"] > 0.0,
         f"{c['zeros']} zero populations (a partial write?)")
    gate(c["mass_drift"] < bar, f"mass drift {c['mass_drift']}")
    return c


def describe_slab(sim: Simulation) -> str:
    """The DEM axis, the slab plane R x C and its bands, and which DEM
    the deck takes."""
    ncs, ncl, R, C, nb = slab_dem.slab_dims(sim.grid, sim.dem_axis)
    return (f"axis={sim.dem_axis} plane R*C={R}x{C}={R * C} bands={nb}; "
            f"{describe_path(sim)}")


def run_stage(sim: Simulation, chunk: int, repeats: int = 3,
              log=print) -> dict:
    """Qualify one stage: assert the slab DEM, run(chunk) cold, the best
    of `repeats` x run(chunk), the peak memory and check_state. Returns
    {"cold_s", "best_s", "mlups", "peak_gib", **state_checks}."""
    cfg = sim.cfg
    log(describe_slab(sim))
    gate(slab_dem.slab_supported(sim.grid, sim.dem_axis, kt=cfg.kt > 0.0,
                                 device=sim.device),
         "the deck does not take the slab DEM")
    cuda = sim.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(sim.device)
    t0 = time.perf_counter()
    sim.run(chunk)
    cold = time.perf_counter() - t0
    log(f"cold run({chunk}): {cold:.2f} s")
    best = float("inf")
    for _ in range(repeats):
        sync(sim.device)
        t0 = time.perf_counter()
        sim.run(chunk)
        sync(sim.device)
        best = min(best, time.perf_counter() - t0)
    mlups = cfg.nx * cfg.ny * chunk / best / 1e6
    peak = (torch.cuda.max_memory_allocated(sim.device) / 2**30 if cuda
            else None)
    mem = f"{peak:.2f} GiB" if cuda else "not measured on the CPU"
    log(f"MLUPS: {mlups:.1f} (best of {repeats} x run({chunk}), "
        f"{best / chunk * 1e3:.3f} ms per step) on "
        f"{device_label(sim.device)}; peak memory {mem}")
    checks = check_state(sim, log)
    return {"cold_s": cold, "best_s": best, "mlups": mlups,
            "peak_gib": peak, **checks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="qualify_8192")
    ap.add_argument("n_disks", nargs="?", type=int, default=N_DISKS)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    sim = make_sim(n_disks=args.n_disks, device=args.device)
    res = run_stage(sim, 50, log=lambda s: print(s, flush=True))
    print("QUALIFIED OK", flush=True)
    return res


if __name__ == "__main__":
    main()
