"""The five benchmark configurations from BASELINE.json, as constructors.

A copy of the JAX package's `lbmdem_tpu/models/scenarios.py`.

Each returns (SimConfig, [DiskSpec]) in lattice units, sized so the
defaults run quickly but scale by passing nx/ny/n_disks overrides.
These are the framework's "model zoo": the same scenarios the
reference validates against (SURVEY.md SS4 physics benchmarks).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from lbmdem_tpu_torch.config import DiskSpec, SimConfig

Scene = Tuple[SimConfig, List[DiskSpec]]


def poiseuille(nx: int = 64, ny: int = 64, tau: float = 0.9, g: float = 1e-6) -> Scene:
    """#1: gravity-driven channel flow, zero particles (pure LBM)."""
    cfg = SimConfig(nx=nx, ny=ny, tau=tau, gx=g, steps=20 * ny * ny,
                    out_interval=2000)
    return cfg, []


def single_disk_sedimentation(
    nx: int = 128,
    ny: int = 512,
    r: float = 8.0,
    rho_s: float = 1.25,
    tau: float = 0.65,
    g: float = 2e-5,
) -> Scene:
    """#2: one disk settling in a closed channel (IMB coupling).

    Settling velocity vs the drag balance is THE parity metric
    (BASELINE.json `metric`). Terminal Re ~ O(1-10) with defaults.
    """
    kn = 0.5  # stiff enough that wall impact at terminal v stays <1% r
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=8000, out_interval=200,
        bc_west="wall", bc_east="wall",
        rho_s=rho_s, kn=kn, gamma_n=1.0, mu=0.3, n_sub=20,
        g_py=-g, buoyancy=True, max_disks=1,
    )
    return cfg, [DiskSpec(x=nx / 2.0 + 0.317, y=0.8 * ny, r=r)]


def dkt(
    nx: int = 160,
    ny: int = 640,
    r: float = 8.0,
    rho_s: float = 1.5,
    tau: float = 0.65,
    g: float = 2e-5,
) -> Scene:
    """#3: drafting-kissing-tumbling - two disks, trailing one drafts
    into the leader's wake, they kiss, then tumble apart."""
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=20000, out_interval=200,
        bc_west="wall", bc_east="wall",
        rho_s=rho_s, kn=1.0, gamma_n=1.0, mu=0.1, n_sub=20,
        g_py=-g, buoyancy=True, max_disks=2,
    )
    disks = [
        DiskSpec(x=nx / 2.0 + 0.2, y=0.85 * ny, r=r),          # trailing
        DiskSpec(x=nx / 2.0 - 0.2, y=0.85 * ny - 2.5 * r, r=r),  # leading
    ]
    return cfg, disks


def _pack_disks(
    x0: float, x1: float, y0: float, y1: float, r: float, n: int, seed: int = 0
) -> List[DiskSpec]:
    """Hex-pack up to n disks with small jitter inside a box."""
    rng = np.random.default_rng(seed)
    pitch = 2.0 * r * 1.05
    rows = []
    y = y0 + r
    row = 0
    disks: List[DiskSpec] = []
    while y < y1 - r and len(disks) < n:
        x = x0 + r + (0.5 * pitch if row % 2 else 0.0)
        while x < x1 - r and len(disks) < n:
            jx, jy = rng.uniform(-0.02 * r, 0.02 * r, 2)
            disks.append(DiskSpec(x=x + jx, y=y + jy, r=r))
            x += pitch
        y += pitch * math.sqrt(3.0) / 2.0
        row += 1
    return disks


def settling_column(
    nx: int = 512,
    ny: int = 1024,
    n_disks: int = 1000,
    r: float = 4.0,
    rho_s: float = 2.0,
    tau: float = 0.6,
    g: float = 1e-5,
) -> Scene:
    """#4: ~1k-disk settling column (cell-list broadphase + contacts)."""
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=20000, out_interval=500,
        bc_west="wall", bc_east="wall",
        rho_s=rho_s, kn=2.0, gamma_n=2.0, gamma_t=0.5, mu=0.4, n_sub=20,
        g_py=-g, buoyancy=True, max_disks=n_disks,
    )
    disks = _pack_disks(0, nx, 0.45 * ny, ny, r, n_disks)
    return cfg, disks


def column_collapse(
    nx: int = 4096,
    ny: int = 4096,
    n_disks: int = 10000,
    r: float = 8.0,
    rho_s: float = 2.5,
    tau: float = 0.55,
    g: float = 1e-5,
    kt: float = 0.0,
    mu: float = 0.5,
) -> Scene:
    """#5: submerged granular column collapse at 4096^2 with 10k disks
    (the headline benchmark config; shard over the ICI mesh). kt > 0
    switches tangential friction to Cundall-Strack history springs
    (on the card the slab DEM kernel takes them at any size; on the CPU
    ~2048^2-class cell grids are the last before the cell-list subcycle
    - slab_dem.slab_supported)."""
    # kn sized so bottom-of-column overlap stays ~5% of r; n_sub=10
    # (dt_dem = 0.1) resolves the contact period 2 pi sqrt(m/kn) ~ 20
    # lattice times by ~200 points.
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=20000, out_interval=1000,
        bc_west="wall", bc_east="wall",
        rho_s=rho_s, kn=50.0, gamma_n=60.0, gamma_t=15.0, mu=mu, kt=kt,
        n_sub=10, g_py=-g, buoyancy=True, max_disks=n_disks,
    )
    # initial column against the west wall, ~aspect ratio 2
    width = 0.22 * nx
    disks = _pack_disks(0, width, 0, 0.9 * ny, r, n_disks)
    return cfg, disks


def cavity(nx: int = 128, ny: int = 128, tau: float = 0.6, u_lid: float = 0.1) -> Scene:
    """Lid-driven cavity (moving north wall - moving-wall bounce-back,
    SURVEY C6; plain-JAX path)."""
    cfg = SimConfig(nx=nx, ny=ny, tau=tau, steps=50 * nx * nx // 100,
                    out_interval=1000, bc_west="wall", bc_east="wall",
                    uw_north=u_lid)
    return cfg, []


def cylinder(
    nx: int = 256, ny: int = 128, r: float = 8.0, tau: float = 0.55,
    g: float = 2e-7,
) -> Scene:
    """Flow past a fixed cylinder: body-force-driven periodic-x channel
    with an infinite-mass obstacle disk (DiskSpec.fixed). At the default
    parameters the channel centerline reaches u ~ 0.025 (Re ~ 25, steady
    twin-vortex wake); drag is observable via Simulation.hydro_forces.
    The slight y-offset seeds asymmetry so higher-Re variants shed."""
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=20000, out_interval=500, gx=g,
        bc_west="periodic", bc_east="periodic",
        max_disks=1, n_sub=1,
    )
    disks = [DiskSpec(x=0.25 * nx, y=0.5 * ny + 0.01 * ny, r=r, fixed=True)]
    return cfg, disks


def porous_bed(
    nx: int = 256, ny: int = 256, r: float = 6.0, pitch: int = 32,
    tau: float = 0.8, g: float = 1e-7,
) -> Scene:
    """Darcy flow through a square array of fixed cylinders (a porous
    bed): fully periodic, body-force driven. Permeability follows from
    the superficial velocity: K = <u> nu / g. All disks fixed -> the
    DEM runs in contact-free drift mode."""
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=20000, out_interval=500, gx=g,
        bc_west="periodic", bc_east="periodic",
        bc_south="periodic", bc_north="periodic",
        max_disks=(nx // pitch) * (ny // pitch), n_sub=1,
    )
    disks = [
        DiskSpec(x=(i + 0.5) * pitch, y=(j + 0.5) * pitch, r=r, fixed=True)
        for i in range(nx // pitch)
        for j in range(ny // pitch)
    ]
    return cfg, disks


def schafer_turek(
    nx: int = 440, ny: int = 82, r: float = 10.0, cx: float = 39.5,
    cy: float = 39.5, u_max: float = 0.075, tau: float = 0.65,
) -> Scene:
    """Schafer-Turek 2D-1 benchmark: steady flow past a cylinder in a
    channel at Re = 20 (u_mean D / nu with u_mean = 2/3 u_max).

    Canonical geometry at dx = 5 mm: channel 2.2 x 0.41 m -> 440 x 82,
    cylinder D = 0.1 m at (0.2, 0.2) -> r = 10 at (39.5, 39.5) (the
    intentional 2.44% blockage asymmetry of the benchmark). Parabolic
    Zou/He inlet, pressure outlet. Published drag/lift coefficients:
    cD = 5.5795, cL = 0.0106 (tools/benchmark_cylinder.py measures
    ours). ny = 82 is not 8-divisible: runs on the XLA path."""
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=40000, out_interval=1000,
        bc_west="inlet", bc_east="outlet", u_inlet=u_max,
        inlet_profile="poiseuille", max_disks=1, n_sub=1,
    )
    return cfg, [DiskSpec(x=cx, y=cy, r=r, fixed=True)]


def suspension_channel(
    nx: int = 512, ny: int = 128, n_disks: int = 24, r: float = 4.0,
    u_max: float = 0.08, rho_s: float = 1.05, tau: float = 0.6,
) -> Scene:
    """Dilute suspension transport through an open channel: parabolic
    Zou/He inlet, pressure outlet, near-neutrally-buoyant mobile disks
    seeded in the upstream half are carried by the flow and deactivate
    as they leave through the outlet (dem.cull_open_boundaries) -
    the two boundary columns always stamp as pure fluid so the open
    closure stays consistent (imb.mask_open_columns)."""
    cfg = SimConfig(
        nx=nx, ny=ny, tau=tau, steps=3 * int(nx / (0.5 * u_max)),
        out_interval=500,
        bc_west="inlet", bc_east="outlet", u_inlet=u_max,
        inlet_profile="poiseuille",
        rho_s=rho_s, kn=1.0, gamma_n=1.0, mu=0.2, n_sub=5,
        buoyancy=True, max_disks=n_disks,
    )
    # dilute seeding in the upstream half, off the walls; slight row
    # stagger so disks sample different streamlines
    rng = np.random.default_rng(7)
    disks: List[DiskSpec] = []
    ncols = max(1, int(math.ceil(n_disks / 4)))
    for i in range(n_disks):
        cx = (0.06 + 0.38 * (i % ncols) / max(ncols - 1, 1)) * nx
        cy = (0.2 + 0.6 * ((i // ncols) + 0.5) / 4.0) * ny
        jx, jy = rng.uniform(-0.5 * r, 0.5 * r, 2)
        disks.append(DiskSpec(x=cx + jx, y=cy + jy, r=r))
    return cfg, disks


SCENARIOS = {
    "poiseuille": poiseuille,
    "suspension_channel": suspension_channel,
    "cavity": cavity,
    "cylinder": cylinder,
    "porous_bed": porous_bed,
    "schafer_turek": schafer_turek,
    "sedimentation": single_disk_sedimentation,
    "dkt": dkt,
    "settling_column": settling_column,
    "column_collapse": column_collapse,
}


def make_scenario(name: str, **overrides) -> Scene:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name](**overrides)
