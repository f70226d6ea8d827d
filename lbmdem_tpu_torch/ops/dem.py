"""Discrete-element method for circular disks, plain PyTorch.

Counterpart of the JAX package's `lbmdem_tpu/ops/dem.py`: the
broadphase grid geometry (`DemGrid`), the disk state (`DiskState`,
`make_disk_state`), cell ids, the spring-dashpot pair law with the
optional tangential history spring (C14), wall contacts (C15), body
forces (C16 inputs), the outflow cull of Zou/He channels, and the
cell-list subcycle `dem_subcycle`: a fixed-capacity cell table, a
3x3-patch candidate list pruned by gap to contact_cap slots, history springs re-matched by partner id (kt > 0),
minimum-image contacts on periodic axes, and n_sub velocity-Verlet
substeps. The JAX package runs it as XLA code, so it has no kernel here
either; `Simulation` takes it past the slab DEM's gate
(`slab_dem.slab_supported`) and the stage-ablation tool's "xla-dem"
variant.

The cell table's and the pruned list's slot orders follow disk order
(stable sorts); the JAX sorts are not stable, so the two packages agree
on each cell's and each disk's set and, up to summation order, on the
forces.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

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


def _min_image(d: torch.Tensor, lx: float, ly: float) -> torch.Tensor:
    """Minimum-image displacement (..., 2) under periodic wrap lengths
    (0 = no wrap on that axis)."""
    if not (lx or ly):
        return d
    cx, cy = d[..., 0], d[..., 1]
    if lx:
        cx = cx - lx * torch.round(cx / lx)
    if ly:
        cy = cy - ly * torch.round(cy / ly)
    return torch.stack([cx, cy], dim=-1)


def build_cell_table(x: torch.Tensor, active: torch.Tensor,
                     grid: DemGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket disks into cells: (table (ncells, K) int32 - the k-th disk
    of cell c, -1 if none -, overflow () int32 - the active disks past a
    cell's capacity K)."""
    from lbmdem_tpu_torch.ops.stamp import _segment_ranks

    k = grid.capacity
    ncells = grid.ncx * grid.ncy
    cid = _cell_ids(x, active, grid).to(torch.int64)
    scid, order, rank = _segment_ranks(cid)
    valid = (scid >= 0) & (rank < k)
    slot = torch.where(valid, scid * k + rank,
                       torch.full_like(scid, ncells * k))
    table = torch.full((ncells * k + 1,), -1, dtype=torch.int32,
                       device=x.device)
    table[slot] = order.to(torch.int32)
    overflow = torch.sum((scid >= 0) & (rank >= k)).to(torch.int32)
    return table[:ncells * k].reshape(ncells, k), overflow


def candidate_list(disks: DiskState, table: torch.Tensor,
                   grid: DemGrid) -> torch.Tensor:
    """Per-disk candidate neighbours from the 3x3 cell patch: (N, 9K)
    int32, -1 = empty, self or an inactive row. Periodic axes wrap the
    patch across the seam (cells tile a wrapped axis exactly); wall axes
    drop the cells outside the grid."""
    k = grid.capacity
    dev = disks.x.device
    cx = torch.clamp(torch.floor((disks.x[:, 0] + 0.5) / grid.csx), 0,
                     grid.ncx - 1).to(torch.int64)
    cy = torch.clamp(torch.floor((disks.x[:, 1] + 0.5) / grid.csy), 0,
                     grid.ncy - 1).to(torch.int64)
    # the patch in the JAX order (dx fastest), made on the device: a
    # tensor from a Python list would be a host-to-device copy that
    # synchronises the stream
    patch = torch.arange(9, device=dev)
    nbx = cx[:, None] + (patch % 3 - 1)[None, :]  # (N, 9)
    nby = cy[:, None] + (patch // 3 - 1)[None, :]
    valid = torch.ones_like(nbx, dtype=torch.bool)
    if grid.wrap_lx:
        nbx = torch.remainder(nbx, grid.ncx)
    else:
        valid = valid & (nbx >= 0) & (nbx < grid.ncx)
    if grid.wrap_ly:
        nby = torch.remainder(nby, grid.ncy)
    else:
        valid = valid & (nby >= 0) & (nby < grid.ncy)
    cidn = torch.where(valid, nby * grid.ncx + nbx, torch.zeros_like(nbx))
    cand = torch.where(valid[:, :, None], table[cidn],
                       torch.full((), -1, dtype=table.dtype, device=dev))
    cand = cand.reshape(disks.x.shape[0], 9 * k)
    idx = torch.arange(disks.x.shape[0], dtype=cand.dtype, device=dev)
    cand = torch.where(cand == idx[:, None], -1, cand)
    return torch.where(disks.active[:, None], cand, -1)


def prune_candidates(disks: DiskState, cand: torch.Tensor, cap: int,
                     skin: float, wrap=(0.0, 0.0)):
    """Keep the candidates with surface gap <= skin (minimum-image gaps
    on periodic axes), compacted to the front of a (N, cap) list in slot
    order: (tight (N, cap) int32, overflow () int32 - kept candidates
    past cap). The JAX twin compacts with top_k over the 0/1 mask, which
    keeps tied entries in index order; a stable descending sort does the
    same."""
    mask = cand >= 0
    j = cand.clamp(min=0).to(torch.int64)
    dt = disks.x.dtype
    packed = torch.cat([disks.x, disks.r[:, None],
                        disks.active[:, None].to(dt)], dim=1)
    g = packed[j]  # (N, S, 4)
    d = _min_image(disks.x[:, None, :] - g[..., 0:2], *wrap)
    dist2 = torch.sum(d * d, dim=-1)
    reach = disks.r[:, None] + g[..., 2] + skin
    keep = mask & (g[..., 3] > 0) & (dist2 <= reach * reach)
    order = torch.sort(keep.to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :cap]
    hit = torch.gather(keep, 1, order)
    tight = torch.where(hit, torch.gather(cand, 1, order), -1)
    overflow = (torch.sum(keep, dtype=torch.int32)
                - torch.sum(hit, dtype=torch.int32))
    return tight, overflow


def _pair_force(pxi, vi, omi, ri, xj, vj, omj, rj, mask, cfg: SimConfig,
                xi=None, h=0.0):
    """Spring-dashpot force/torque on disk i from disk(s)/wall(s) j. n
    points from j to i. With kt > 0 the tangential history spring: `xi`
    is the stretch carried per slot, advanced by v_t * h (h = 0
    evaluates without advancing), with the Coulomb cap mu |F_n| and
    slip-consistent truncation; with kt == 0 a tangential dashpot with
    the same cap. Returns (F (..., 2), T (...,), touching, xi')."""
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
    zero = torch.zeros((), dtype=fn.dtype, device=fn.device)
    if cfg.kt > 0.0:
        xi_t = torch.where(touching, xi + vt * h, zero)
        ft = torch.clamp(-cfg.kt * xi_t - cfg.gamma_t * vt, -ft_cap, ft_cap)
        xi_new = torch.where(touching, -(ft + cfg.gamma_t * vt) / cfg.kt,
                             zero)
    else:
        ft = torch.clamp(-cfg.gamma_t * vt, -ft_cap, ft_cap)
        xi_new = torch.zeros_like(vt if xi is None else xi)
    fn = torch.where(touching, fn, zero)
    ft = torch.where(touching, ft, zero)
    F = fn[..., None] * n + ft[..., None] * t
    T = -li * ft
    return F, T, touching, xi_new


def contact_forces_from_candidates(disks: DiskState, cand, cfg: SimConfig,
                                   xi=None, h=0.0):
    """Spring-dashpot forces over the fixed candidate slots, neighbours
    at their minimum image on periodic axes: (F (N, 2), T (N,), xi' (N,
    S), n_contacts () int32 - each contact counted once)."""
    dt = disks.x.dtype
    mask = cand >= 0
    j = cand.clamp(min=0).to(torch.int64)
    if xi is None:
        xi = torch.zeros(cand.shape, dtype=dt, device=disks.x.device)
    packed = torch.cat([disks.x, disks.v, disks.omega[:, None],
                        disks.r[:, None], disks.active[:, None].to(dt)],
                       dim=1)
    g = packed[j]  # (N, S, 7)
    wrap = (cfg.wrap_lx, cfg.wrap_ly)
    xj = g[..., 0:2]
    if wrap[0] or wrap[1]:
        xj = disks.x[:, None, :] - _min_image(disks.x[:, None, :] - xj, *wrap)
    F, T, touching, xi_new = _pair_force(
        disks.x[:, None, :], disks.v[:, None, :], disks.omega[:, None],
        disks.r[:, None], xj, g[..., 2:4], g[..., 4], g[..., 5],
        mask & (g[..., 6] > 0), cfg, xi=xi, h=h)
    nc = (torch.sum(touching, dtype=torch.int32) // 2).to(torch.int32)
    return torch.sum(F, dim=1), torch.sum(T, dim=1), xi_new, nc


def contact_forces(disks: DiskState, table, grid: DemGrid, cfg: SimConfig):
    """Disk-disk contact forces via the cell list: (F, T, n_contacts)."""
    cand = candidate_list(disks, table, grid)
    F, T, _, nc = contact_forces_from_candidates(disks, cand, cfg)
    return F, T, nc


def _wall_forces_xi(disks: DiskState, cfg: SimConfig, wall_xi=None, h=0.0):
    """Disk-wall contacts (C15): the pair law against a radius-0 mirror
    point on each wall plane (-0.5 / n-0.5), with the per-wall history
    stretch wall_xi (N, 4) W/E/S/N. Returns (F, T, wall_xi')."""
    F = torch.zeros_like(disks.x)
    T = torch.zeros_like(disks.omega)
    zero = torch.zeros_like(disks.omega)
    if wall_xi is None:
        wall_xi = torch.zeros((disks.x.shape[0], 4), dtype=disks.x.dtype,
                              device=disks.x.device)
    xi_new = wall_xi.clone()
    walls = [
        (0, cfg.bc_west == WALL, -0.5, 0),
        (1, cfg.bc_east == WALL, cfg.nx - 0.5, 0),
        (2, cfg.bc_south == WALL, -0.5, 1),
        (3, cfg.bc_north == WALL, cfg.ny - 0.5, 1),
    ]
    for slot, on, wpos, axis in walls:
        if not on:
            continue
        xj = disks.x.clone()
        xj[:, axis] = wpos
        Fw, Tw, _, xw = _pair_force(disks.x, disks.v, disks.omega, disks.r,
                                    xj, torch.zeros_like(disks.v), zero, zero,
                                    disks.active, cfg, xi=wall_xi[:, slot],
                                    h=h)
        F = F + Fw
        T = T + Tw
        xi_new[:, slot] = xw
    return F, T, xi_new


def wall_forces(disks: DiskState, cfg: SimConfig):
    """Disk-wall contacts without history: (F, T)."""
    F, T, _ = _wall_forces_xi(disks, cfg)
    return F, T


def body_forces(disks: DiskState, cfg: SimConfig) -> torch.Tensor:
    """Gravity + optional analytic buoyancy on each disk: (N, 2). The
    gravity components enter as scalars (no host-to-device copy)."""
    m_eff = disks.mass
    if cfg.buoyancy:
        m_eff = disks.mass - cfg.rho0 * math.pi * disks.r * disks.r
    return (torch.stack([m_eff * cfg.g_px, m_eff * cfg.g_py], dim=1)
            * disks.active[:, None])


def cull_open_boundaries(disks: DiskState, cfg: SimConfig) -> DiskState:
    """Deactivate mobile disks advected fully past an open x end (Zou/He
    channels, cfg.bc_west == "inlet"): once the whole footprint is
    outside (centre beyond the boundary plane by more than the radius)
    the slot is parked far outside at rest, like an unused slot of
    make_disk_state. A disk that straddles the boundary keeps coupling
    with its in-domain part. Fixed disks are exempt."""
    x0 = disks.x[:, 0]
    gone = (disks.active & disks.mobile
            & ((x0 - disks.r > cfg.nx - 0.5) | (x0 + disks.r < -0.5)))
    g2 = gone[:, None]
    return disks._replace(
        active=disks.active & ~gone,
        x=torch.where(g2, -1.0e6, disks.x),
        v=torch.where(g2, 0.0, disks.v),
        omega=torch.where(gone, 0.0, disks.omega),
    )


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


def dem_subcycle(disks: DiskState, f_hydro, t_hydro, grid: DemGrid,
                 cfg: SimConfig):
    """n_sub velocity-Verlet DEM substeps per LBM step on the cell list
    (C16): the cell table and the gap-pruned candidate list are built
    once per LBM step (the grid skin keeps them valid through the
    subcycle), history springs re-match to the new list by partner id,
    and each substep is kick-drift, force, kick. Fixed disks (mobile
    False) get no kicks and drift at their prescribed v/omega. Returns
    (new disks with ct_j = the candidate list and ct_xi/wall_xi the
    stretches, overflow () int32, n_contacts () int32)."""
    dt = disks.x.dtype
    h = 1.0 / cfg.n_sub
    free = disks.active & disks.mobile
    zero = torch.zeros((), dtype=dt, device=disks.x.device)
    inv_m = torch.where(free, 1.0 / disks.mass, zero)
    inv_i = torch.where(free, 1.0 / disks.inertia, zero)
    act = disks.active.to(dt)
    act2 = act[:, None]

    table, ovf = build_cell_table(disks.x, disks.active, grid)
    cand = candidate_list(disks, table, grid)
    cand, ovf_p = prune_candidates(disks, cand, cfg.contact_cap, grid.skin,
                                   (cfg.wrap_lx, cfg.wrap_ly))
    ovf = torch.maximum(ovf, ovf_p)
    body_f = body_forces(disks, cfg)

    if cfg.kt > 0.0:
        # a pair that persists keeps its stretch; new pairs start at 0
        same = ((cand[:, :, None] == disks.ct_j[:, None, :])
                & (disks.ct_j[:, None, :] >= 0))
        xi = torch.sum(torch.where(same, disks.ct_xi[:, None, :], zero),
                       dim=2)
    else:
        xi = torch.zeros(cand.shape, dtype=dt, device=disks.x.device)
    wxi = disks.wall_xi

    def total_force(d: DiskState, xi, wxi, h_adv):
        Fc, Tc, xi2, nc = contact_forces_from_candidates(d, cand, cfg, xi,
                                                         h_adv)
        Fw, Tw, wxi2 = _wall_forces_xi(d, cfg, wxi, h_adv)
        F = Fc + Fw + f_hydro + body_f
        return F * act2, (Tc + Tw + t_hydro) * act, xi2, wxi2, nc

    F, T, _, _, nc = total_force(disks, xi, wxi, 0.0)
    d = disks
    for _ in range(cfg.n_sub):
        vh = d.v + (0.5 * h) * F * inv_m[:, None]
        omh = d.omega + (0.5 * h) * T * inv_i
        d = d._replace(x=d.x + h * vh * act2, theta=d.theta + h * omh * act)
        F, T, xi, wxi, n2 = total_force(d._replace(v=vh, omega=omh), xi, wxi,
                                        h)
        d = d._replace(v=(vh + (0.5 * h) * F * inv_m[:, None]) * act2,
                       omega=(omh + (0.5 * h) * T * inv_i) * act)
        nc = torch.maximum(nc, n2)
    return d._replace(ct_j=cand, ct_xi=xi, wall_xi=wxi), ovf, nc
