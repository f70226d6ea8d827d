"""Physics validation of the port on the card: each leg holds a run of
the kernels (or, for the untileable cylinder decks, the plain path)
against a golden, a published benchmark or the plain PyTorch version.

Counterpart of the JAX package's `tools/validate_tpu.py`, with its legs,
gates and stage names:

    settling   one disk settling, vy within 1 % of the float64 golden
               (tests/golden/settling_r5_nx128_f64.csv)        K1 K2 K3
    dkt        early DKT trajectory within 0.1 cell of the float64
               golden, drafting over the whole run           K1 K2 K3
    dktlit     dkt_study at nx = 128, float32 on the kernels, with
               the literature window and PIN_NX128           K1 K2 K3
    periodic   a shift by nx/2 on a periodic axis shifts the trajectory
               (< 1e-3), with a seam crossing       K1 ghosts, K2, K3
    cavity     lid-driven cavity at Re = 100 within 4 % of the Ghia,
               Ghia & Shin (1982) extrema                    K5 (K4)
    trt        TRT (Lambda = 3/16) body-force Poiseuille within 2e-4 of
               the parabola, BGK more than 50x off              K5
    cylinder   Schafer-Turek 2D-1 at scale 2, cD within 2 %  plain path
    rshift     the calibrated eps_r_shift points (D = 20, D = 40), cD
               within 1.5 %                                   plain path
    shedding   2D-2 Strouhal number in [0.290, 0.310]          plain path
    friction   the slab DEM with springs against the cell-list DEM, 3
               handoffs, < 3e-5                               K3 kt
    static     K7 (k = 4) against 4 plain coupled steps, < 2e-6    K7
    couplingk  settling at coupling_k = 4 (env COUPLING_K) within 1 %
               of the per-step golden                    K1 K6 K3w
    collapse   collapse_study's 4 aspects, the fit pinned at
               (0.60, 1.32)                          K1 K2 K3 kt
    all        settling, dkt, periodic, cavity, trt, cylinder

    python -m lbmdem_tpu_torch.tools.validate [legs ...] [--device cpu]

With no leg it runs "all", then friction, static and shedding. Each leg
prints the path it took beside its result and its seconds; a failed
gate raises and the command exits non-zero. It runs on the card unless
given --device cpu (the plain versions, float32; the cylinder legs in
float64), and raises without a card. The long legs (cylinder, rshift,
shedding, collapse) take minutes to tens of minutes on the card: run
one per command.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from lbmdem_tpu_torch.config import DiskSpec, SimConfig, window_for_radius
from lbmdem_tpu_torch.ops import dem, fused_static, imb, lbm, slab_dem
from lbmdem_tpu_torch.ops.dem import DemGrid
from lbmdem_tpu_torch.simulation import Simulation, make_step_fn
from lbmdem_tpu_torch.tools.common import (describe_path, device_label,
                                           gate, golden, require_device)


def _settling_cfg(**kw) -> SimConfig:
    """The settling golden's deck: one r = 5 disk in a closed 128x192
    channel, float32."""
    return SimConfig(nx=128, ny=192, tau=0.65, dtype="float32", g_py=-2e-5,
                     rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                     bc_west="wall", bc_east="wall", **kw)


def _back_half_err(vy, gold) -> float:
    """max |vy - vy_gold| over the back half of the rows, over the
    golden's velocity scale there (the settling gate's measure)."""
    half = len(vy) // 2
    vy_g = gold[half:, 4]
    return float(np.abs(np.asarray(vy[half:]) - vy_g).max()
                 / np.abs(vy_g).max())


def _step_rows(sim, n_rows: int, every: int = 100):
    """n_rows rows of the disks' (x, v) after each `every` steps of the
    per-step step (make_step_fn: a fresh binning every step, no Verlet
    cadence), the two f buffers swapped after each step."""
    step = make_step_fn(sim.cfg, sim.grid, dem_axis=sim.dem_axis,
                        dem_mode=sim.dem_mode)
    s = sim.state
    spare = torch.empty_like(s.f)
    rows = []
    for _ in range(n_rows):
        for _ in range(every):
            new = step(s, spare)
            spare, s = s.f, new
        rows.append((s.disks.x.cpu().numpy(), s.disks.v.cpu().numpy()))
    sim.state = s
    return rows


def settling(device="cuda"):
    """Single-disk settling against the float64 golden: instantaneous
    vy over the back half within 1 % of the golden's velocity scale."""
    gold = golden("settling_r5_nx128_f64.csv")
    sim = Simulation(_settling_cfg(), [DiskSpec(64.3, 150.0, 5.0)],
                     device=device)
    print(f"settling: {describe_path(sim)}")
    rows = np.array([(x[0, 1], v[0, 1])
                     for x, v in _step_rows(sim, gold.shape[0])])
    err = _back_half_err(rows[:, 1], gold)
    print(f"settling velocity: {rows[-1, 1]:.6e} vs golden {gold[-1, 4]:.6e}")
    print(f"max |dv|/scale over back half: {err:.4%}")
    y_err = abs(rows[-1, 0] - gold[-1, 2])
    print(f"final y: {rows[-1, 0]:.4f} vs golden {gold[-1, 2]:.4f} "
          f"(|dy| = {y_err:.4f} cells)")
    gate(err < 0.01, f"settling-velocity parity {err:.4%} exceeds 1%")
    gate(int(sim.state.overflow) == 0, "settling overflow")
    print("SETTLING OK")
    return {"err": err, "vy": float(rows[-1, 1]), "path": describe_path(sim)}


def dkt(device="cuda"):
    """DKT against the float64 golden: the early (pre-kissing) y
    trajectories within 0.1 cell, and the drafting signature (the gap
    closes by more than 3 cells) over the whole run."""
    gold = golden("dkt_nx128_f64.csv")
    cfg = SimConfig(nx=128, ny=256, tau=0.56, dtype="float32", g_py=-1e-4,
                    rho_s=2.0, kn=1.0, gamma_n=1.0, mu=0.1, n_sub=10,
                    buoyancy=True, bc_west="wall", bc_east="wall")
    disks = [DiskSpec(64.2, 220.0, 5.0), DiskSpec(63.8, 204.0, 5.0)]
    sim = Simulation(cfg, disks, device=device)
    print(f"dkt: {describe_path(sim)}")
    rows = np.array([(x[0, 1], x[1, 1])
                     for x, _ in _step_rows(sim, gold.shape[0])])
    half = len(rows) // 2
    err = np.abs(rows[:half] - gold[:half, [2, 4]]).max()
    print(f"DKT early-phase max |dy|: {err:.4f} cells (budget 0.1)")
    gap0 = 16.0
    gap1 = rows[-1, 0] - rows[-1, 1]
    print(f"DKT drafting: gap {gap0} -> {gap1:.2f} "
          f"(golden {gold[-1, 2] - gold[-1, 4]:.2f})")
    gate(err < 0.1, f"DKT early trajectory diverged: {err}")
    gate(gap1 < gap0 - 3.0, "no drafting")
    print("DKT OK")
    return {"err": float(err), "gap": float(gap1), "path": describe_path(sim)}


def dkt_literature(device="cuda"):
    """dkt_study at the published configuration, nx = 128, float32 on
    the kernels: the literature window and the recorded pin
    (t_kiss 1.505 s +-15 %, drafting ratio 1.139 +-10 %)."""
    from lbmdem_tpu_torch.tools.dkt_study import (PIN_NX128,
                                                  check_literature, run_study)

    m = run_study(nx=128, dtype="float32", use_kernels=True,
                  sample_every=50, device=device)
    check_literature(m, pin=PIN_NX128)
    print(f"DKT literature: t_kiss={m['t_kiss_s']:.3f} s, draft ratio "
          f"{m['draft_ratio']:.3f}, post-kiss |dx| "
          f"{m['max_dx_post_kiss_cm']:.3f} cm ({m['path']})")
    print("DKT-LITERATURE OK")
    return {k: m[k] for k in ("t_kiss_s", "draft_ratio",
                              "max_dx_post_kiss_cm", "steps", "path")}


def cavity(device="cuda"):
    """Lid-driven cavity at Re = 100 on the kernels (K5 passes of the
    pure-fluid chunk of Simulation.run) against the Ghia, Ghia & Shin (1982)
    centreline extrema: u_min = -0.2109 on the vertical centreline,
    v_max = 0.1753 and v_min = -0.2453 on the horizontal one
    (normalized by the lid speed); a 128^2 D2Q9 BGK solution with
    half-way bounce-back lands within a few %; budget 4 %."""
    n, u_lid = 128, 0.1
    nu = u_lid * n / 100.0  # Re = U L / nu = 100
    cfg = SimConfig(nx=n, ny=n, tau=3.0 * nu + 0.5, dtype="float32",
                    bc_west="wall", bc_east="wall", uw_north=u_lid,
                    out_interval=5000)
    sim = Simulation(cfg, [], device=device)
    print(f"cavity: {describe_path(sim)}")
    prev = None
    for i in range(40):  # up to 200k steps; diffusive time ~ L^2/nu = 128k
        sim.run(5000)
        _, ux, uy = sim.macroscopic()
        if prev is not None:
            d = max(np.abs(ux - prev[0]).max(), np.abs(uy - prev[1]).max())
            if d < 5e-6:  # above the f32 limit-cycle floor
                break
        prev = (ux, uy)
    converged = d < 5e-6
    print(f"cavity: {'steady' if converged else 'NOT converged'} after "
          f"{(i + 1) * 5000} steps (d={d:.2e})")
    gate(d < 1e-5, f"cavity far from steady state (d={d:.2e})")
    # centerlines: cell centers at (j+0.5)/n; x=0.5 is between columns
    u_c = 0.5 * (ux[:, n // 2 - 1] + ux[:, n // 2]) / u_lid
    v_c = 0.5 * (uy[n // 2 - 1, :] + uy[n // 2, :]) / u_lid
    checks = [
        ("u_min (vert centerline)", float(u_c.min()), -0.2109),
        ("v_max (horiz centerline)", float(v_c.max()), 0.1753),
        ("v_min (horiz centerline)", float(v_c.min()), -0.2453),
    ]
    out = {"steps": (i + 1) * 5000, "d": float(d), "path": describe_path(sim)}
    for name, got, ref in checks:
        err = abs(got - ref) / abs(ref)
        print(f"cavity {name}: {got:.4f} vs Ghia {ref:.4f} ({err:.2%})")
        gate(err < 0.04, f"cavity {name} off by {err:.2%} (budget 4%)")
        out[name.split()[0]] = got
    y_min = (float(np.argmin(u_c)) + 0.5) / n
    print(f"cavity u_min location y={y_min:.4f} (Ghia 0.4531)")
    gate(abs(y_min - 0.4531) < 0.05, f"cavity u_min at y={y_min:.4f}")
    gate(bool(torch.isfinite(sim.state.f).all()), "cavity: non-finite f")
    print("CAVITY OK")
    return out


def periodic(device="cuda"):
    """Periodic-DEM invariance on the kernels: shifting the scene by
    nx/2 along the periodic axis shifts the trajectory (ghost stamping,
    the wrapped reduce, min-image contacts), through a seam crossing."""
    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32",
                    window=window_for_radius(4.0), max_disks=3,
                    kn=0.5, gamma_n=0.2, n_sub=4, out_interval=10**9,
                    bc_west="periodic", bc_east="periodic")
    rows = [(255.3, 32.0, 4.0, 0.06, 0.0, 0.0),
            (6.0, 44.0, 4.0, -0.02, 0.0, 0.01),
            (100.0, 30.0, 3.0, 0.0, -0.01, 0.0)]
    sh, L = 128, cfg.nx
    outs = []
    for shift in (0, sh):
        disks = [DiskSpec((x + shift) % L, y, r, vx, vy, om)
                 for x, y, r, vx, vy, om in rows]
        sim = Simulation(cfg, disks, device=device)
        if not outs:
            print(f"periodic: {describe_path(sim)}")
        sim.run(50)
        outs.append(sim.state.disks.x[:3].cpu().numpy())
        gate(int(sim.state.overflow) == 0, "periodic leg overflow")
    dx = (outs[1][:, 0] - outs[0][:, 0] - sh) % L
    dx = np.minimum(dx, L - dx)
    dy = np.abs(outs[1][:, 1] - outs[0][:, 1])
    print(f"periodic invariance: max|dx mod L|={dx.max():.2e} "
          f"max|dy|={dy.max():.2e} crosser at x={outs[0][0, 0]:.2f}")
    gate(dx.max() < 1e-3 and dy.max() < 1e-3, "PERIODIC INVARIANCE FAIL")
    gate(outs[0][0, 0] < 20.0, "seam crossing did not happen")
    print("PERIODIC OK")
    return {"dx": float(dx.max()), "dy": float(dy.max()),
            "crosser_x": float(outs[0][0, 0]), "path": describe_path(sim)}


def _poiseuille_err(prof, cfg: SimConfig) -> float:
    """max |u_x(y) - parabola| / max parabola of a body-force channel's
    mean profile (cell centres at y = j + 1/2, walls at 0 and ny)."""
    y = np.arange(cfg.ny) + 0.5
    analytic = cfg.gx / (2.0 * cfg.nu) * y * (cfg.ny - y)
    return float(np.abs(prof - analytic).max() / analytic.max())


def trt(device="cuda"):
    """TRT on the kernels: Lambda = 3/16 pins the bounce-back wall
    exactly mid-link, so body-force Poiseuille sits on the analytic
    parabola to float32 roundoff while BGK at the same tau carries a
    real slip error. gx = 5e-5 lifts the signal above the float32 noise
    of the velocity moment (u_max 1.9e-2, laminar Re ~ 2)."""
    errs = {}
    for coll in ("trt", "bgk"):
        cfg = SimConfig(nx=128, ny=32, tau=1.5, gx=5e-5, dtype="float32",
                        collision=coll, out_interval=10**9)
        sim = Simulation(cfg, device=device)
        if not errs:
            print(f"trt: {describe_path(sim)}")
        sim.run(12000)
        _, ux, _ = sim.macroscopic()
        errs[coll] = _poiseuille_err(ux.mean(axis=1), cfg)
    print(f"poiseuille tau=1.5 rel err: trt {errs['trt']:.2e} "
          f"bgk {errs['bgk']:.2e}")
    gate(errs["trt"] < 2e-4, "TRT(3/16) wall not exact")
    gate(errs["bgk"] > 50 * errs["trt"], "BGK/TRT contrast missing")
    print("TRT OK")
    return {**errs, "path": describe_path(sim)}


def trt_coupled(device="cuda", kernel: str = "K7"):
    """The trt leg's deck (128 x 32, tau 1.5, gx 5e-5, float32, 12 000
    steps) through a coupled kernel over an empty solid, in passes of
    k = 4: K7 (fused_step_imb_static_multi on a zero solid stack) or K6
    (fused_step_imb_reduce_multi on a zero solid stack with a binning of
    no disk). Their collide is the NT-blended one (under TRT the pair
    form of the TPU kernels), so the same gates hold as on the fluid
    kernels: TRT (Lambda = 3/16) within 2e-4 of the parabola, BGK more
    than 50 times off. Returns the errors, the kernel's launches per
    collision (0 on the CPU: the plain version) and the path."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    if kernel not in ("K6", "K7"):
        raise ValueError(f"kernel must be K6 or K7, got {kernel!r}")
    device = require_device(device)
    errs, launches = {}, {}
    wrapper = (fused_lbm.fused_step_imb_reduce_multi if kernel == "K6"
               else fused_static.fused_step_imb_static_multi)
    for coll in ("trt", "bgk"):
        cfg = SimConfig(nx=128, ny=32, tau=1.5, gx=5e-5, dtype="float32",
                        collision=coll, out_interval=10**9)
        f = lbm.init_equilibrium(cfg, device)
        out = torch.empty_like(f)
        solid = torch.zeros((3, cfg.ny, cfg.nx), device=device)
        if kernel == "K6":  # the binning of one inactive disk
            z = torch.zeros((1, 2), device=device)
            td, cnt, _, _ = stamp.bin_disks_to_tiles(
                z, z, z[:, 0], z[:, 0] + 1.0,
                torch.zeros(1, dtype=torch.bool, device=device),
                cfg.replace(max_disks=1, tile_cap=8))

            def step(f, out):
                return fused_lbm.fused_step_imb_reduce_multi(
                    f, solid, td, cnt, cfg, 4, out)[0]
        else:
            def step(f, out):
                return fused_static.fused_step_imb_static_multi(
                    f, solid, cfg, 4, out)
        n0 = wrapper.launches
        for _ in range(12000 // 4):
            f, out = step(f, out), f
        launches[coll] = wrapper.launches - n0
        _, ux, _ = lbm.moments(f, cfg.gx, cfg.gy)
        errs[coll] = _poiseuille_err(ux.mean(dim=1).double().cpu().numpy(),
                                     cfg)
    path = (f"{kernel if device.type == 'cuda' else kernel + ' plain version'}"
            f" (k = 4) over an empty solid, float32, {device.type}")
    print(f"trt-coupled: {path}")
    print(f"poiseuille tau=1.5 rel err: trt {errs['trt']:.2e} "
          f"bgk {errs['bgk']:.2e}")
    gate(errs["trt"] < 2e-4, "TRT(3/16) wall not exact")
    gate(errs["bgk"] > 50 * errs["trt"], "BGK/TRT contrast missing")
    print("TRT-COUPLED OK")
    return {**errs, "launches": launches, "path": path}


def _cylinder_argv(device, *args):
    return ["--device", str(torch.device(device).type), *args]


def cylinder(device="cuda"):
    """Schafer-Turek 2D-1 at scale 2 (880x164, D = 40, 120k steps) on
    the plain path: cD within 2 % of the published converged 5.5795."""
    from lbmdem_tpu_torch.tools.benchmark_cylinder import main as cyl

    cd, cl = cyl(_cylinder_argv(device, "--scale", "2"))
    dev = abs(cd - 5.5795) / 5.5795
    gate(dev < 0.02, f"scale-2 cylinder drag off by {dev:.2%} (budget 2%)")
    gate(0.008 < cl < 0.013, f"scale-2 lift {cl:.4f} implausible")
    print("CYLINDER OK")
    return {"cd": cd, "cl": cl}


def rshift(device="cuda"):
    """The eps_r_shift hydrodynamic-radius calibration at both recorded
    points, on the plain path: D = 20 with s = -0.35 and D = 40 (scale
    2, 120k steps) with s = -0.14, each cD within 1.5 % of 5.5795."""
    from lbmdem_tpu_torch.tools.benchmark_cylinder import main as cyl

    cd, _ = cyl(_cylinder_argv(device, "--r-shift=-0.35"))
    dev = abs(cd - 5.5795) / 5.5795
    gate(dev < 0.015, f"calibrated D=20 drag off by {dev:.2%} (budget 1.5%)")
    cd40, _ = cyl(_cylinder_argv(device, "--scale=2", "--r-shift=-0.14"))
    dev40 = abs(cd40 - 5.5795) / 5.5795
    gate(dev40 < 0.015,
         f"calibrated D=40 drag off by {dev40:.2%} (budget 1.5%)")
    print("RSHIFT OK")
    return {"cd20": cd, "cd40": cd40}


def shedding(device="cuda"):
    """Schafer-Turek 2D-2 (Re = 100 vortex shedding, TRT) on the plain
    path: the Strouhal number, the discretization-robust observable,
    within [0.290, 0.310] (published 0.2950 .. 0.3050); the force maxima
    carry the D = 20 interface bias and are printed only."""
    from lbmdem_tpu_torch.tools.benchmark_cylinder import main as cyl

    res = cyl(_cylinder_argv(device, "--unsteady"))
    gate(res is not None, "2D-2 shedding not periodic")
    st = res[0]
    gate(0.290 <= st <= 0.310, f"2D-2 Strouhal {st} off the interval")
    print("SHEDDING OK")
    return {"st": float(st), "cd_max": res[2], "cl_max": res[3]}


def friction(device="cuda"):
    """The slab DEM with history springs (slab_dem.dem_subcycle: K3 with
    its spring channels) against the cell-list subcycle
    (dem.dem_subcycle), both on the device, over 3 LBM-step handoffs
    (the cross-step spring rematch included): x, v, omega < 3e-5."""
    device = require_device(device)
    cfg = SimConfig(nx=128, ny=128, tau=0.8, dtype="float32", g_py=-2e-4,
                    rho_s=2.5, kn=2.0, gamma_n=1.0, kt=0.5, gamma_t=0.2,
                    mu=0.2, n_sub=6, bc_west="wall", bc_east="wall")
    specs = [DiskSpec(30.0, 5.8, 3.0), DiskSpec(35.5, 6.2, 3.0, omega=0.2),
             DiskSpec(60.0, 40.0, 3.0, vx=0.03),
             DiskSpec(65.5, 41.0, 3.0, vx=-0.03)]
    disks = dem.make_disk_state(specs, cfg, "float32", device=device)
    grid = DemGrid.build(cfg, 3.0)
    z2 = torch.zeros((4, 2), dtype=torch.float32, device=device)
    z1 = torch.zeros((4,), dtype=torch.float32, device=device)
    path = (f"slab DEM ({'K3 kt' if device.type == 'cuda' else 'K3 kt plain'}"
            f") vs cell-list DEM, float32, {device.type}")
    print(f"friction: {path}")
    dr = dp = disks
    for _ in range(3):
        dr, _, nc_r = dem.dem_subcycle(dr, z2, z1, grid, cfg)
        dp, ovf, nc_p = slab_dem.dem_subcycle(dp, z2, z1, grid, cfg)
    gate(int(ovf) == 0, "friction: slab overflow")
    gate(int(nc_p) == int(nc_r) and int(nc_p) > 0,
         f"friction: contacts {int(nc_p)} vs {int(nc_r)}")
    ex, ev, eo = (float((getattr(dp, k) - getattr(dr, k)).abs().max())
                  for k in ("x", "v", "omega"))
    print(f"friction slab: nc={int(nc_p)} max|dx|={ex:.2e} "
          f"max|dv|={ev:.2e} max|dom|={eo:.2e}")
    gate(ex < 3e-5 and ev < 3e-5 and eo < 3e-5, "FRICTION PARITY FAIL")
    print("FRICTION OK")
    return {"nc": int(nc_p), "dx": ex, "dv": ev, "domega": eo, "path": path}


def static_multi(device="cuda"):
    """K7 (fused_step_imb_static_multi, k = 4) against 4 plain coupled
    steps (imb.collide_imb, lbm.stream, lbm.apply_bounce_back) over the
    same solid stack (imb.stamp_solid_fraction), both on the device:
    max |df| < 2e-6."""
    device = require_device(device)
    cfg = SimConfig(nx=256, ny=128, tau=0.7, dtype="float32", max_disks=2,
                    window=9, gx=1e-5, bc_west="wall", bc_east="wall")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    xs = t([[64.3, 32.1], [128.0, 40.0]])
    vs = t(np.zeros((2, 2)))
    om = t(np.zeros((2,)))
    r = t([4.0, 3.0])
    act = t([True, True], torch.bool)
    eps, usx, usy = imb.stamp_solid_fraction(xs, vs, om, r, act, cfg)
    rng = np.random.default_rng(7)
    f = lbm.equilibrium(
        t((1.0 + 0.01 * rng.standard_normal((cfg.ny, cfg.nx))).astype(
            np.float32)),
        t((0.02 * rng.standard_normal((cfg.ny, cfg.nx))).astype(np.float32)),
        t((0.02 * rng.standard_normal((cfg.ny, cfg.nx))).astype(np.float32)),
    )
    ref = f
    for _ in range(4):
        fpost, _, _ = imb.collide_imb(ref, eps, usx, usy, cfg)
        ref = lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg)
    solid = torch.stack([eps, usx, usy]).contiguous()
    got = fused_static.fused_step_imb_static_multi(
        f.contiguous(), solid, cfg, 4, torch.empty_like(f))
    err = float((got - ref).abs().max())
    path = (f"{'K7' if device.type == 'cuda' else 'K7 plain version'} "
            f"(k = 4) vs 4 plain steps, float32, {device.type}")
    print(f"static: {path}")
    print(f"static-multi k=4: max|df|={err:.2e}")
    gate(err < 2e-6, "STATIC TEMPORAL KERNEL PARITY FAIL")
    print("STATIC-MULTI OK")
    return {"err": err, "path": path}


def coupling_k(device="cuda", ck=None):
    """Settling with coupling_k = ck (default: env COUPLING_K, else 4):
    k coupled steps per K6 pass over the window-start solid stack, a
    force reduce per inner step, K3w per inner step. The speed tier
    holds the same 1 % settling-velocity budget against the float64
    per-step golden over the back half (rows every 100 steps of run)."""
    gold = golden("settling_r5_nx128_f64.csv")
    ck = int(os.environ.get("COUPLING_K", "4")) if ck is None else ck
    sim = Simulation(_settling_cfg(coupling_k=ck, out_interval=10**9),
                     [DiskSpec(64.3, 150.0, 5.0)], device=device)
    print(f"couplingk: {describe_path(sim)}")
    vy = []
    t0 = time.perf_counter()
    for _ in range(gold.shape[0]):
        sim.run(100)
        vy.append(float(sim.state.disks.v[0, 1]))
    secs = time.perf_counter() - t0
    err = _back_half_err(vy, gold)
    print(f"coupling_k={ck} settling velocity: {vy[-1]:.6e} vs golden "
          f"{gold[-1, 4]:.6e}; max |dv|/scale {err:.4%} ({len(vy) * 100} "
          f"steps in {secs:.2f} s on {device_label(sim.device)}); "
          f"overflow {int(sim.state.overflow)}")
    gate(int(sim.state.overflow) == 0, "coupling_k settling overflow")
    gate(err < 0.01,
         f"coupling_k settling parity {err:.4%} exceeds the 1% budget")
    print("COUPLING-K OK")
    return {"err": err, "k": ck, "path": describe_path(sim)}


def collapse(device="cuda"):
    """collapse_study's four aspects at 1024x576 (kt = 25 springs,
    float32 on the kernels): monotone runout, the exponent in the
    literature band, settled deposits, and the fit pinned at the
    recorded (lambda, alpha) = (0.60, 1.32)."""
    from lbmdem_tpu_torch.tools.collapse_study import (PIN, check_scaling,
                                                       print_table,
                                                       run_study)

    results = run_study(device=device)
    print_table(results)
    lam, alpha = check_scaling(results, pin=PIN)
    print(f"collapse scaling: dL/L0 = {lam:.2f} * a^{alpha:.2f} over "
          f"a = {[round(r['aspect'], 2) for r in results]}")
    print("COLLAPSE OK")
    return {"lambda": lam, "alpha": alpha, "results": results}


def main(device="cuda"):
    """The "all" stage: settling, dkt, periodic, cavity, trt, cylinder."""
    settling(device)
    dkt(device)
    periodic(device)
    cavity(device)
    trt(device)
    cylinder(device)
    print("PHYSICS VALIDATION OK")


STAGES = {"settling": settling, "all": main,
          "dkt": dkt, "periodic": periodic,
          "cavity": cavity, "trt": trt, "cylinder": cylinder,
          "friction": friction, "static": static_multi,
          "shedding": shedding, "collapse": collapse,
          "dktlit": dkt_literature, "rshift": rshift,
          "couplingk": coupling_k}


def run_legs(names, device="cuda"):
    """Run the named legs in order, each timed; returns {name: (result,
    seconds)}. A failed gate raises."""
    device = require_device(device)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        res = STAGES[name](device)
        secs = time.perf_counter() - t0
        print(f"leg {name}: {secs:.1f} s on {device_label(device)}",
              flush=True)
        out[name] = (res, secs)
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="validate", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("legs", nargs="*",
                    help="legs to run (none: all, friction, static, "
                         "shedding)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    unknown = [n for n in args.legs if n not in STAGES]
    if unknown:
        ap.error(f"unknown legs {unknown}; have {sorted(STAGES)}")
    if args.legs:
        run_legs(args.legs, args.device)
        print("SELECTED VALIDATION OK")
    else:
        run_legs(["all", "friction", "static", "shedding"], args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
