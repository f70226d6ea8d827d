"""Discrete-element method for circular disks: the parts the slab DEM
path uses, in plain PyTorch.

Counterpart of the JAX package's `lbmdem_tpu/ops/dem.py`: the
broadphase grid geometry (`DemGrid`), the disk state (`DiskState`,
`make_disk_state`), cell ids, the spring-dashpot pair law (C14), wall
contacts (C15) and body forces (C16 inputs). The cell-list subcycle
(`dem_subcycle`) and `cull_open_boundaries` are not ported yet
(ROADMAP.md, modules to port, item 9): the port always takes the slab
subcycle of `ops/slab_dem.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from lbmdem_tpu_torch.config import SimConfig, WALL


@dataclasses.dataclass(frozen=True)
class DemGrid:
    """Static broadphase grid geometry."""

    cell_size: float
    ncx: int
    ncy: int
    capacity: int
    skin: float = 1.0
    # periodic wrap lengths (0.0 = that axis has walls)
    wrap_lx: float = 0.0
    wrap_ly: float = 0.0
    cell_sx: float = 0.0  # per-axis cell size (0 -> cell_size)
    cell_sy: float = 0.0

    @property
    def csx(self) -> float:
        return self.cell_sx or self.cell_size

    @property
    def csy(self) -> float:
        return self.cell_sy or self.cell_size

    @staticmethod
    def build(cfg: SimConfig, r_max: float, capacity: int = 8,
              skin: float = 1.0) -> "DemGrid":
        """Cells of side >= 2 r_max + skin; on a wrapped axis the cells
        tile the domain exactly (same rule as the JAX twin)."""
        cell = max(2.0 * float(r_max) + skin, 1.0)
        lx, ly = cfg.wrap_lx, cfg.wrap_ly

        def axis(n, L, name):
            if not L:
                return max(int(n / cell) + 1, 1), cell
            nc = max(int(n / cell), 1)
            if nc < 3:
                raise ValueError(
                    f"periodic {name}-extent {n} holds only {nc} DEM "
                    f"cells of size ~{cell:.1f}; need >= 3 for wrapped "
                    f"3x3 adjacency (smaller disks or a larger domain)"
                )
            return nc, n / nc

        ncx, csx = axis(cfg.nx, lx, "x")
        ncy, csy = axis(cfg.ny, ly, "y")
        return DemGrid(cell_size=cell, ncx=ncx, ncy=ncy, capacity=capacity,
                       skin=skin, wrap_lx=lx, wrap_ly=ly,
                       cell_sx=csx, cell_sy=csy)


class DiskState(NamedTuple):
    """SoA disk state, fixed capacity N = cfg.max_disks (field names and
    shapes as the JAX `DiskState`)."""

    x: torch.Tensor  # (N, 2) centers
    v: torch.Tensor  # (N, 2) velocities
    theta: torch.Tensor  # (N,)
    omega: torch.Tensor  # (N,)
    r: torch.Tensor  # (N,)
    mass: torch.Tensor  # (N,) rho_s * pi r^2
    inertia: torch.Tensor  # (N,) 0.5 m r^2
    active: torch.Tensor  # (N,) bool
    mobile: torch.Tensor  # (N,) bool; False = infinite mass (fixed)
    ct_j: torch.Tensor  # (N, contact_cap) int32 spring partner ids
    ct_xi: torch.Tensor  # (N, contact_cap) spring stretch
    wall_xi: torch.Tensor  # (N, 4) wall spring stretch (W/E/S/N)


def _cell_ids(x: torch.Tensor, active: torch.Tensor,
              grid: DemGrid) -> torch.Tensor:
    """(N,) int32 broadphase cell id (clipped into the grid), -1 for
    inactive disks."""
    cx = torch.clamp(torch.floor((x[:, 0] + 0.5) / grid.csx), 0, grid.ncx - 1)
    cy = torch.clamp(torch.floor((x[:, 1] + 0.5) / grid.csy), 0, grid.ncy - 1)
    cid = (cy * grid.ncx + cx).to(torch.int32)
    return torch.where(active, cid, torch.full_like(cid, -1))


def _pair_force(pxi, vi, omi, ri, xj, vj, omj, rj, mask, cfg: SimConfig):
    """Spring-dashpot force/torque on disk i from disk(s)/wall(s) j with
    the tangential dashpot and Coulomb cap (kt == 0). n points from j
    to i. Returns (F (..., 2), T (...,), touching)."""
    d = pxi - xj
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    dist = torch.clamp(dist, min=1e-12)
    delta = ri + rj - dist
    touching = mask & (delta > 0)
    n = d / dist[..., None]
    t = torch.stack([-n[..., 1], n[..., 0]], dim=-1)
    li = ri - 0.5 * delta
    lj = rj - 0.5 * delta
    vrel = vi - vj - (omi * li + omj * lj)[..., None] * t
    vn = torch.sum(vrel * n, dim=-1)
    vt = torch.sum(vrel * t, dim=-1)
    fn = cfg.kn * delta - cfg.gamma_n * vn
    ft_cap = cfg.mu * torch.abs(fn)
    ft = torch.clamp(-cfg.gamma_t * vt, -ft_cap, ft_cap)
    fn = torch.where(touching, fn, torch.zeros_like(fn))
    ft = torch.where(touching, ft, torch.zeros_like(ft))
    F = fn[..., None] * n + ft[..., None] * t
    T = -li * ft
    return F, T, touching


def wall_forces(disks: DiskState, cfg: SimConfig):
    """Disk-wall contacts (C15): the pair law against a radius-0 mirror
    point on each wall plane (-0.5 / n-0.5). Returns (F, T)."""
    F = torch.zeros_like(disks.x)
    T = torch.zeros_like(disks.omega)
    zero = torch.zeros_like(disks.omega)
    walls = [
        (cfg.bc_west == WALL, -0.5, 0),
        (cfg.bc_east == WALL, cfg.nx - 0.5, 0),
        (cfg.bc_south == WALL, -0.5, 1),
        (cfg.bc_north == WALL, cfg.ny - 0.5, 1),
    ]
    for on, wpos, axis in walls:
        if not on:
            continue
        xj = disks.x.clone()
        xj[:, axis] = wpos
        Fw, Tw, _ = _pair_force(disks.x, disks.v, disks.omega, disks.r, xj,
                                torch.zeros_like(disks.v), zero, zero,
                                disks.active, cfg)
        F = F + Fw
        T = T + Tw
    return F, T


def body_forces(disks: DiskState, cfg: SimConfig) -> torch.Tensor:
    """Gravity + optional analytic buoyancy on each disk: (N, 2). The
    gravity components enter as scalars (no host-to-device copy)."""
    m_eff = disks.mass
    if cfg.buoyancy:
        m_eff = disks.mass - cfg.rho0 * math.pi * disks.r * disks.r
    return (torch.stack([m_eff * cfg.g_px, m_eff * cfg.g_py], dim=1)
            * disks.active[:, None])


def make_disk_state(specs, cfg: SimConfig, dtype=None,
                    device="cpu") -> DiskState:
    """Fixed-capacity DiskState from a list of DiskSpec; unused slots
    are inactive and parked far outside the domain."""
    dt = np.dtype(dtype or cfg.dtype)
    n = max(cfg.max_disks, len(specs), 1)
    x = np.zeros((n, 2), dt)
    v = np.zeros((n, 2), dt)
    theta = np.zeros((n,), dt)
    om = np.zeros((n,), dt)
    r = np.ones((n,), dt)  # inactive slots keep r=1 to avoid div-by-zero
    active = np.zeros((n,), bool)
    mobile = np.ones((n,), bool)
    rho = np.full((n,), cfg.rho_s, np.float64)
    for i, s in enumerate(specs):
        x[i] = (s.x, s.y)
        v[i] = (s.vx, s.vy)
        om[i] = s.omega
        r[i] = s.r
        active[i] = True
        mobile[i] = not getattr(s, "fixed", False)
        if getattr(s, "rho_s", 0.0):
            rho[i] = s.rho_s
    x[len(specs):] = (-1e6, -1e6)
    mass = rho * np.pi * r * r
    inertia = 0.5 * mass * r * r

    def t(a):
        return torch.as_tensor(a, device=device)

    return DiskState(
        x=t(x), v=t(v), theta=t(theta), omega=t(om), r=t(r),
        mass=t(mass.astype(dt)), inertia=t(inertia.astype(dt)),
        active=t(active), mobile=t(mobile),
        ct_j=torch.full((n, cfg.contact_cap), -1, dtype=torch.int32,
                        device=device),
        ct_xi=t(np.zeros((n, cfg.contact_cap), dt)),
        wall_xi=t(np.zeros((n, 4), dt)),
    )
