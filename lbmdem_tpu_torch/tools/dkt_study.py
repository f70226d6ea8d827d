"""Drafting-kissing-tumbling against the published literature case.

Counterpart of the JAX package's `tools/dkt_study.py`. The canonical 2D
DKT configuration of the Feng, Hu & Joseph (1994) lineage, reused by
most particulate-flow validations since (Feng & Michaelides 2004 JCP
195; Niu et al. 2006 Phys. Lett. A; Glowinski et al. 2001 variants):

  channel 2 cm x 8 cm, two rigid circles d = 0.2 cm,
  rho_s / rho_f = 1.01, nu = 0.01 cm^2/s, g = 980 cm/s^2,
  released horizontally centered (with the customary ~0.001 cm
  symmetry-breaking offset) at heights 7.2 and 6.8 cm.

The trailing (upper) disk drafts in the leading disk's wake, falls
faster, kisses, and the unstable doublet tumbles apart. Published
kissing times spread across methods (t_kiss ~ 1-3 s in the FEM/DLM/LBM
literature; Feng & Michaelides 2004 report ~2 s at this density ratio),
so the study asserts the method-independent signatures:

  1. drafting: the trailing disk's mean settling speed exceeds the
     leading disk's from release to kissing (wake shielding),
  2. kissing: first contact inside the cross-method window
     0.8 s < t_kiss < 3.5 s,
  3. gap closure: the surface gap shrinks from d at release to contact
     with no rebound (smoothed) before the kiss,
  4. tumbling: within 2 s after the kiss the doublet breaks laterally
     (|dx| between centers exceeds d/2),

and, with a pin, the recorded calibration of the configuration
(PIN_NX128: kissing at 1.505 s, drafting ratio 1.139).

    python -m lbmdem_tpu_torch.tools.dkt_study [--fast | --kernels] \
        [--device cpu]

Default: nx = 120, float64 on the plain path, pinned; --fast nx = 80
(unpinned); --kernels nx = 128, float32 on the kernels (K1, K2, K3),
pinned. It runs on the card unless given --device cpu, and raises
without a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from lbmdem_tpu_torch.config import DiskSpec, SimConfig
from lbmdem_tpu_torch.simulation import Simulation
from lbmdem_tpu_torch.tools.common import (describe_path, device_label,
                                           gate, require_device)

# --- physical configuration (cgs units, the literature case) ---
WIDTH_CM = 2.0
HEIGHT_CM = 8.0
D_CM = 0.2
RHO_RATIO = 1.01
NU_CM2S = 0.01
G_CMS2 = 980.0
Y0_TRAIL = 7.2
Y0_LEAD = 6.8
X_OFF = 0.001  # customary symmetry-breaking offset (cm)


def build(nx=120, tau=0.55, dtype="float64", n_sub=10):
    """(cfg, disks, dt_s, dx_cm): the literature DKT deck in lattice
    units at `nx` cells across the 2 cm channel. dt follows from
    matching nu: nu_lat = (tau - 1/2)/3 = nu_phys * dt / dx^2."""
    dx = WIDTH_CM / nx
    ny = int(round(HEIGHT_CM / dx))
    nu_lat = (tau - 0.5) / 3.0
    dt = nu_lat * dx * dx / NU_CM2S
    g_lat = G_CMS2 * dt * dt / dx
    r_lat = 0.5 * D_CM / dx
    # contact stiffness: stiff enough that contact overlap stays well
    # under a cell at the drafting impact speed (spring-dashpot)
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, dtype=dtype, rho_s=RHO_RATIO,
        g_py=-g_lat, buoyancy=True, kn=2.0, gamma_n=1.0, gamma_t=0.3,
        mu=0.1, n_sub=n_sub, bc_west="wall", bc_east="wall",
        max_disks=2, out_interval=10 ** 9,
    )
    disks = [
        DiskSpec((WIDTH_CM / 2 - X_OFF) / dx, Y0_TRAIL / dx, r_lat),
        DiskSpec((WIDTH_CM / 2 + X_OFF) / dx, Y0_LEAD / dx, r_lat),
    ]
    return cfg, disks, dt, dx


def run_study(nx=120, tau=0.55, dtype="float64", use_kernels=False,
              t_max_s=5.0, sample_every=25, verbose=True, device="cuda"):
    """Run until kiss + 2 s (or t_max_s); return a dict of phase
    metrics in PHYSICAL units (seconds / cm). Every `sample_every` steps
    the disk positions and the contact count are read to the host (the
    sampling defines the measurement)."""
    device = require_device(device)
    cfg, disks, dt, dx = build(nx=nx, tau=tau, dtype=dtype)
    sim = Simulation(cfg, disks, device=device, use_kernels=use_kernels)
    if verbose:
        print(f"DKT nx={nx}: {describe_path(sim)}", flush=True)
    max_steps = int(t_max_s / dt)
    rows = []  # (t_s, y_trail, y_lead, x_trail, x_lead, n_contacts)
    t_kiss = None
    steps_after_kiss = int(2.0 / dt)
    kiss_step = None
    step = 0
    t0 = time.perf_counter()
    while step < max_steps:
        sim.run(sample_every)
        step += sample_every
        st = sim.state
        x = st.disks.x.cpu().numpy()
        nc = int(st.n_contacts)
        rows.append((step * dt, x[0, 1] * dx, x[1, 1] * dx,
                     x[0, 0] * dx, x[1, 0] * dx, nc))
        if t_kiss is None and nc >= 1:
            t_kiss = step * dt
            kiss_step = step
            if verbose:
                print(f"kiss at t={t_kiss:.3f} s (step {step})",
                      flush=True)
        if kiss_step is not None and step >= kiss_step + steps_after_kiss:
            break
        # stop early if the pair approaches the bottom wall
        if min(x[0, 1], x[1, 1]) * dx < 1.0:
            break
    wall_s = time.perf_counter() - t0
    rows = np.array(rows)
    t = rows[:, 0]
    gap = rows[:, 1] - rows[:, 2] - D_CM  # surface gap (cm)
    dx_lat = np.abs(rows[:, 3] - rows[:, 4])  # lateral separation (cm)
    pre = t < (t_kiss if t_kiss is not None else t[-1])
    # mean settling speeds over the drafting phase (release -> kiss)
    if pre.sum() >= 2:
        vy_trail = (rows[pre][-1, 1] - rows[pre][0, 1]) / (
            t[pre][-1] - t[pre][0])
        vy_lead = (rows[pre][-1, 2] - rows[pre][0, 2]) / (
            t[pre][-1] - t[pre][0])
    else:
        vy_trail = vy_lead = float("nan")
    # smoothed gap monotonicity before the kiss: compare a coarse
    # moving average (the raw gap carries sub-cell stamp noise)
    k = max(1, pre.sum() // 10)
    g_s = np.convolve(gap[pre], np.ones(k) / k, mode="valid")
    rebound = float((np.diff(g_s) > 0.05 * D_CM).sum())
    out = {
        "t_kiss_s": t_kiss,
        "vy_trail_cms": vy_trail,
        "vy_lead_cms": vy_lead,
        "draft_ratio": vy_trail / vy_lead if vy_lead else float("nan"),
        "gap0_cm": gap[0],
        "rebound_events": rebound,
        "max_dx_post_kiss_cm": (
            float(dx_lat[t >= t_kiss].max()) if t_kiss is not None else 0.0
        ),
        "t_end_s": float(t[-1]),
        "rows": rows,
        "dt_s": dt,
        "dx_cm": dx,
        "steps": step,
        "wall_s": wall_s,
        "path": describe_path(sim),
    }
    if verbose:
        print(f"drafting speeds: trail {vy_trail:.3f} lead {vy_lead:.3f} "
              f"cm/s (ratio {out['draft_ratio']:.3f})")
        print(f"post-kiss lateral separation max "
              f"{out['max_dx_post_kiss_cm']:.3f} cm")
        print(f"{step} steps in {wall_s:.1f} s on {device_label(device)}",
              flush=True)
    return out


# Recorded calibration of the published-geometry runs at production
# resolution (the reference's nx = 120 f64 plain path and nx = 128 f32
# kernel path agree: the anchors are not precision-marginal): kissing at
# 1.505 s, drafting ratio 1.139.
PIN_NX128 = (1.505, 1.139)


def check_literature(m, pin=None):
    """The external-anchor gates (numbers from the DKT literature, not
    from this repo - the module docstring gives the provenance); raises
    GateFailed.

    pin=(t_kiss_s, draft_ratio): additionally pin the recorded
    calibration of a specific configuration (+-15% / +-10%), so a
    regression cannot hide inside the wide cross-method literature
    window. The literature window stays the outer gate; the pin guards
    this framework's own trajectory."""
    gate(m["t_kiss_s"] is not None, "no kiss: DKT never made contact")
    if pin is not None:
        t_ref, r_ref = pin
        gate(abs(m["t_kiss_s"] - t_ref) <= 0.15 * t_ref,
             f"kissing time drifted off the recorded calibration: "
             f"t={m['t_kiss_s']:.3f} s vs pinned {t_ref:.3f} s +-15%")
        gate(abs(m["draft_ratio"] - r_ref) <= 0.10 * r_ref,
             f"draft ratio drifted off the recorded calibration: "
             f"{m['draft_ratio']:.3f} vs pinned {r_ref:.3f} +-10%")
    gate(0.8 < m["t_kiss_s"] < 3.5,
         f"kissing at t={m['t_kiss_s']:.2f} s outside the published "
         f"cross-method window [0.8, 3.5] s (Feng & Michaelides 2004 "
         f"~2 s at rho_s/rho_f=1.01; FEM/DLM studies bracket it)")
    # drafting: the trailing disk must fall measurably faster (wake
    # shielding); published velocity plots show a 10-50% excess during
    # the drafting phase at this density ratio
    gate(m["draft_ratio"] > 1.05,
         f"no drafting: trailing/leading settling-speed ratio "
         f"{m['draft_ratio']:.3f} (literature: clearly > 1)")
    # gap closes from d to contact without rebound before the kiss
    gate(abs(m["gap0_cm"] - D_CM) < 0.02, "bad release geometry")
    gate(m["rebound_events"] == 0,
         f"gap rebounded before kissing ({m['rebound_events']} events)")
    # tumbling: the vertical doublet is unstable - it must break
    # laterally by more than d/2 within 2 s of the kiss
    gate(m["max_dx_post_kiss_cm"] > 0.5 * D_CM,
         f"no tumbling: post-kiss lateral separation "
         f"{m['max_dx_post_kiss_cm']:.3f} cm < d/2")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dkt_study")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--fast", action="store_true",
                    help="nx=80 float64 on the plain path (CPU-test size)")
    ap.add_argument("--kernels", action="store_true",
                    help="nx=128 float32 on the kernels")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    pin = None
    if args.fast:
        m = run_study(nx=80, device=device)
    elif args.kernels:
        m = run_study(nx=128, dtype="float32", use_kernels=True,
                      device=device)
        pin = PIN_NX128  # recorded on this config (f32 kernel path)
    else:
        m = run_study(device=device)
        pin = PIN_NX128  # the f64 plain path tracks the f32 value closely
    check_literature(m, pin=pin)
    print(f"t_kiss={m['t_kiss_s']:.3f} s, draft ratio "
          f"{m['draft_ratio']:.3f}, post-kiss |dx| "
          f"{m['max_dx_post_kiss_cm']:.3f} cm")
    print("DKT LITERATURE ANCHOR OK")
    return m


if __name__ == "__main__":
    main()
