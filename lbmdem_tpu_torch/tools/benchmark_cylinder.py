"""Schafer-Turek 2D-1 benchmark: steady cylinder drag/lift at Re = 20.

Counterpart of the JAX package's `tools/benchmark_cylinder.py`: an
external check of the coupled stack (Zou/He inlet/outlet, half-way
bounce-back walls, IMB obstacle coupling, the hydro force reduce)
against the published interval of Schafer & Turek (1996), "Benchmark
computations of laminar flow around a cylinder", case 2D-1:

    cD = 5.5700 .. 5.5900   (converged value 5.5795)
    cL = 0.0104 .. 0.0110   (converged value 0.0106)

with cD = 2 Fx / (rho u_mean^2 D), u_mean = (2/3) u_max. At D = 20
cells the diffuse IMB interface (partially saturated boundary cells act
as a slightly larger cylinder) reads cD ~4 % high; the bias shrinks on
grid doubling (--scale 2) and `--r-shift` calibrates the hydrodynamic
radius per resolution (the reference's records: -0.35 at D = 20, -0.14
at D = 40). `--unsteady` runs case 2D-2 (Re = 100, vortex shedding, TRT)
and measures the Strouhal number from the lift's zero crossings
(published St 0.295 .. 0.305).

The decks run on the plain path (`use_kernels=False`): ny = 82 * scale
gives stamp tiles of 2 or 4 rows, which `kernels_supported` refuses.

    python -m lbmdem_tpu_torch.tools.benchmark_cylinder [--scale 2] \
        [--steps N] [--trt] [--eps-method M] [--r-shift S] \
        [--nt-mode M] [--unsteady] [--device cpu]

It runs on the card in float32 unless given --device cpu (float64 on
the CPU), and raises without a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from lbmdem_tpu_torch.models import make_scenario
from lbmdem_tpu_torch.simulation import Simulation
from lbmdem_tpu_torch.tools.common import (describe_path, device_label,
                                           require_device, sync)


def measure_strouhal(hist, D, u_mean, tail_frac=0.6):
    """Strouhal number from a (step, cD, cL) history: mean period
    between upward zero crossings of the mean-removed lift signal over
    the last (1 - tail_frac) of the run, averaged first-to-last
    crossing (endpoint quantization ~ sample_interval / (n_periods *
    period)). Returns (St, n_periods, cD_max, cL_max) or None if fewer
    than 3 crossings (not yet periodic)."""
    tail = np.asarray(hist)[int(tail_frac * len(hist)):]  # (m, 3)
    cl_sig = tail[:, 2] - tail[:, 2].mean()
    up = np.where((cl_sig[:-1] < 0) & (cl_sig[1:] >= 0))[0]
    if len(up) < 3:
        return None
    period = (tail[up[-1], 0] - tail[up[0], 0]) / (len(up) - 1)
    return (D / (period * u_mean), len(up) - 1,
            float(tail[:, 1].max()), float(tail[:, 2].max()))


def main(argv=None):
    """The benchmark. Returns (cD, cL) at the end of the steady case, or
    for --unsteady measure_strouhal's result (None when the shedding is
    not yet periodic)."""
    ap = argparse.ArgumentParser(prog="benchmark_cylinder")
    ap.add_argument("--device", default="cuda",
                    help="cuda (float32) or cpu (float64)")
    ap.add_argument("--scale", type=int, default=1,
                    help="grid refinement factor (1 -> 440x82, D=20)")
    ap.add_argument("--steps", type=int, default=0,
                    help="override total steps (0 -> auto by scale)")
    ap.add_argument("--trt", action="store_true",
                    help="steady 2D-1 with TRT collision (Lambda=3/16 "
                         "exact mid-link channel walls): how much of the "
                         "D=20 cD bias is wall slip vs the diffuse IMB "
                         "interface")
    ap.add_argument("--eps-method", default=None,
                    choices=("sample", "exact", "ramp"),
                    help="override the coverage model")
    ap.add_argument("--r-shift", type=float, default=0.0,
                    help="eps_r_shift hydrodynamic-radius calibration "
                         "(cells, in [-1, 0])")
    ap.add_argument("--nt-mode", default=None, choices=("nt", "lambda"),
                    help="NT blend weighting (cfg.nt_mode)")
    ap.add_argument("--unsteady", action="store_true",
                    help="2D-2 case: Re=100 vortex shedding (TRT); "
                         "measures the Strouhal number from the lift zero "
                         "crossings (published St = 0.295..0.305)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    cpu = device.type == "cpu"

    s = args.scale
    cfg, disks = make_scenario(
        "schafer_turek", nx=440 * s, ny=82 * s, r=10.0 * s,
        cx=40.0 * s - 0.5, cy=40.0 * s - 0.5,
        u_max=0.075 / s,  # keep Re fixed: u ~ 1/s, D ~ s, nu fixed
    )
    cfg = cfg.replace(dtype="float64" if cpu else "float32",
                      out_interval=10**9)
    if args.trt:
        cfg = cfg.replace(collision="trt")
    if args.eps_method:
        cfg = cfg.replace(eps_method=args.eps_method)
    if args.r_shift:
        cfg = cfg.replace(eps_r_shift=args.r_shift)
    if args.nt_mode:
        cfg = cfg.replace(nt_mode=args.nt_mode)
    if args.unsteady:
        # Re = 100: nu = u_mean D / 100; TRT keeps the coarse grid
        # well-behaved at the resulting tau ~ 0.53
        u_mean = (2.0 / 3.0) * cfg.u_inlet
        nu = u_mean * 2.0 * disks[0].r / 100.0
        cfg = cfg.replace(tau=3.0 * nu + 0.5, collision="trt")
    steps = args.steps or (50000 if args.unsteady else 30000) * s * s
    sim = Simulation(cfg, disks, device=device, use_kernels=False)

    u_mean = (2.0 / 3.0) * cfg.u_inlet
    D = 2.0 * disks[0].r
    denom = 0.5 * cfg.rho0 * u_mean * u_mean * D

    label = device_label(device)
    print(f"{label}; {describe_path(sim)}; grid "
          f"{cfg.nx}x{cfg.ny}, D={D:.0f}, u_max={cfg.u_inlet}, "
          f"tau={cfg.tau:.4f} ({cfg.collision}), "
          f"Re={u_mean * D / cfg.nu:.1f}, steps={steps}", flush=True)
    t0 = time.perf_counter()
    # unsteady: ~8 samples per shedding period (~1330 steps at scale 1)
    # over the run; the St estimate averages first-to-last crossing over
    # all periods, so the per-endpoint quantization stays well under 1 %
    chunk = max(steps // (400 if args.unsteady else 10), 1)
    done = 0
    hist = []
    while done < steps:
        sim.run(chunk)
        done += chunk
        F, _ = sim.hydro_forces()
        cd = float(F[0, 0]) / denom
        cl = float(F[0, 1]) / denom
        hist.append((done, cd, cl))
        if not args.unsteady or done % (10 * chunk) == 0:
            print(f"  step {done}: cD={cd:.4f} cL={cl:.5f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    sync(device)
    secs = time.perf_counter() - t0
    print(f"{steps} steps in {secs:.1f} s: "
          f"{cfg.nx * cfg.ny * steps / secs / 1e6:.2f} MLUPS with the force "
          f"reads, on {label}", flush=True)
    if args.unsteady:
        res = measure_strouhal(hist, D, u_mean)
        if res is not None:
            st, n_per, cd_max, cl_max = res
            print(f"FINAL St={st:.4f} cD_max={cd_max:.4f} "
                  f"cL_max={cl_max:.4f} ({n_per} periods measured)")
            print("published 2D-2: St in [0.2950, 0.3050], cD_max ~ 3.23, "
                  "cL_max ~ 1.0")
        else:
            tail = np.array(hist[int(0.6 * len(hist)):])
            print(f"shedding not (yet) periodic; "
                  f"cL range [{tail[:, 2].min():.4f}, {tail[:, 2].max():.4f}]")
        return res
    cd, cl = hist[-1][1], hist[-1][2]
    dcd = abs(hist[-1][1] - hist[-2][1]) if len(hist) > 1 else float("nan")
    print(f"FINAL cD={cd:.4f} cL={cl:.5f} (last-interval dcD={dcd:.1e})")
    print("published 2D-1: cD in [5.57, 5.59] (5.5795), "
          "cL in [0.0104, 0.0110] (0.0106)")
    print(f"cD deviation from 5.5795: {abs(cd - 5.5795) / 5.5795:.2%}")
    return cd, cl


if __name__ == "__main__":
    main()
