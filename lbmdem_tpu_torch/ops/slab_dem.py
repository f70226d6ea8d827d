"""DEM subcycle over slab planes (K3) and the glue around it.

Counterpart of the JAX package's `lbmdem_tpu/ops/pallas_dem.py`, per-step
flavour (baked hydro + body force channels, kt = 0, wall axes):

- `build_slabs` slots each active disk into a dense (K, R, C) grid of
  broadphase cells (rank-major planes, 8-row empty guard bands) and
  packs the 11 state channels (NCH, K, R, C), with `slot_of_disk`,
  `kmax` and the occupancy band table (`n_occ`, `band_offs`);
- `subcycle_slabs` is K3: the CUDA kernel `csrc/slab_dem.cu` for CUDA
  tensors, `subcycle_slabs_plain` (the same phases on whole planes,
  partners by `torch.roll`) for CPU tensors;
- `_unslab` gathers the integrated channels back to disk order and
  `_leftover_fallback` integrates, contact-free, the active disks the
  slab could not slot (rank >= SLAB_K).

Cell ranks come from `torch.sort(stable=True)`: within one cell the
slots follow disk order, where the JAX package's unstable sort may
order them otherwise (the cells' sets agree).

The history-spring channels (kt > 0), periodic axes and the slim window
flavour of the kernel (K3w, coupling_k > 1) are not ported yet
(ROADMAP.md, modules to port, items 9 and 10).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import not_ported
from lbmdem_tpu_torch.ops import dem as dem_ops
from lbmdem_tpu_torch.ops.dem import DemGrid, DiskState
from lbmdem_tpu_torch.ops.stamp import _segment_ranks

SLAB_K = 4  # slots per broadphase cell

# state plane channels; _MINV is 1/mass, 0 for fixed and empty slots
_X, _Y, _VX, _VY, _OM, _TH, _R, _FHX, _FHY, _THQ, _MINV = range(11)
_NCH = 11


def slab_dims(grid: DemGrid, axis: str) -> Tuple[int, int, int, int, int]:
    """(ncs, ncl, R, C, nb): row/lane cell counts, padded plane rows (8
    empty guard rows top and bottom), padded lane count and the number
    of 8-row bands. axis='x' puts the lattice x cells on the rows."""
    ncs, ncl = (grid.ncy, grid.ncx) if axis == "y" else (grid.ncx, grid.ncy)
    C = -(-ncl // 128) * 128
    ncs_pad = -(-ncs // 8) * 8
    return ncs, ncl, ncs_pad + 16, C, ncs_pad // 8


def choose_axis(disks, cfg: SimConfig) -> str:
    """Plane row axis: the lattice axis with the SMALLER relative initial
    disk extent gets the 8-cell band granularity."""
    if not disks:
        return "y"
    xs = [d.x for d in disks]
    ys = [d.y for d in disks]
    span_x = (max(xs) - min(xs)) / max(cfg.nx, 1)
    span_y = (max(ys) - min(ys)) / max(cfg.ny, 1)
    return "x" if span_x < span_y else "y"


def slab_supported(grid: DemGrid, axis: str = "y") -> bool:
    """The JAX feasibility gate for kt = 0 (plane size and TPU VMEM
    budget), kept so both packages take the slab path on the same
    scenes."""
    ncs, ncl, R, C, nb = slab_dims(grid, axis)
    wrap_s = grid.wrap_ly if axis == "y" else grid.wrap_lx
    if wrap_s and ncs < 8:
        return False
    if R * C > 270000:
        return False
    return (_NCH * SLAB_K + 3 * SLAB_K + 1) * R * C * 4 <= 72 * 2**20


def build_slabs(disks: DiskState, f_hydro, t_hydro, body_f, grid: DemGrid,
                axis: str = "y"):
    """(slabs (NCH, K, R, C), slot_of_disk (N,) i32 (-1 = not slotted),
    overflow () i32, kmax () i32 - max occupied rank + 1, n_occ () i32,
    band_offs (nb,) i32 - the plane-row offsets of the occupied 8-row
    bands, ascending, then R). The slabs keep the disks' dtype; empty
    slots hold all-zero rows (r = 0)."""
    n = disks.x.shape[0]
    dev = disks.x.device
    dt = disks.x.dtype
    ncs, ncl, R, C, nb = slab_dims(grid, axis)
    cid = dem_ops._cell_ids(disks.x, disks.active, grid).to(torch.int64)
    scid, order, rank = _segment_ranks(cid)
    valid = (scid >= 0) & (rank < SLAB_K)
    kmax = torch.clamp(torch.max(torch.where(valid, rank, torch.full_like(
        rank, -1))) + 1, 0, SLAB_K).to(torch.int32)
    cy = torch.div(scid, grid.ncx, rounding_mode="floor")
    cx = scid - cy * grid.ncx
    cs, cl = (cy, cx) if axis == "y" else (cx, cy)
    nslots = SLAB_K * R * C
    slot = torch.where(valid, rank * (R * C) + (cs + 8) * C + cl,
                       torch.full_like(rank, nslots))
    overflow = torch.sum((scid >= 0) & (rank >= SLAB_K)).to(torch.int32)
    slot_of_disk = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slot_of_disk[order] = torch.where(valid, slot, torch.full_like(
        slot, -1)).to(torch.int32)

    band = torch.where(valid, torch.div(cs, 8, rounding_mode="floor"),
                       torch.full_like(cs, nb))
    occ = torch.zeros((nb + 1,), dtype=torch.bool, device=dev)
    occ.index_fill_(0, band, True)  # a scalar fill: no host-to-device copy
    occ = occ[:nb]
    n_occ = torch.sum(occ).to(torch.int32)
    bids = torch.arange(nb, device=dev)
    band_offs = torch.sort(torch.where(occ, bids * 8 + 8, torch.full_like(
        bids, R))).values.to(torch.int32)

    f_hydro = f_hydro.expand(n, 2)
    t_hydro = t_hydro.expand(n)
    body_f = body_f.expand(n, 2)
    fields = torch.stack([
        disks.x[:, 0], disks.x[:, 1], disks.v[:, 0], disks.v[:, 1],
        disks.omega, disks.theta,
        torch.where(disks.active, disks.r, torch.zeros_like(disks.r)),
        (f_hydro[:, 0] + body_f[:, 0]).to(dt),
        (f_hydro[:, 1] + body_f[:, 1]).to(dt),
        t_hydro.to(dt),
        torch.where(disks.mobile & disks.active, 1.0 / disks.mass,
                    torch.zeros_like(disks.mass)),
    ])[:, order]  # (NCH, N), slot-ordered
    dense = torch.zeros((_NCH, nslots + 1), dtype=dt, device=dev)
    dense[:, slot] = fields
    slabs = dense[:, :nslots].reshape(_NCH, SLAB_K, R, C).contiguous()
    return slabs, slot_of_disk, overflow, kmax, n_occ, band_offs


def _walls(cfg: SimConfig):
    """(on, position, lattice axis) of the W/E/S/N wall mirror planes."""
    return [
        (cfg.bc_west == WALL, -0.5, 0),
        (cfg.bc_east == WALL, cfg.nx - 0.5, 0),
        (cfg.bc_south == WALL, -0.5, 1),
        (cfg.bc_north == WALL, cfg.ny - 0.5, 1),
    ]


def _pair(xi, yi, vxi, vyi, omi, ri, xj, yj, vxj, vyj, omj, rj, ok,
          cfg: SimConfig):
    """The slab kernel's pair law (n = d * (1/dist) as on the card):
    (dfx, dfy, dtq, touching) of j on i, zero where not touching."""
    dx = xi - xj
    dyv = yi - yj
    dist = torch.clamp(torch.sqrt(dx * dx + dyv * dyv), min=1e-12)
    delta = ri + rj - dist
    touching = ok & (delta > 0) & (ri > 0)
    inv = 1.0 / dist
    nx_, ny_ = dx * inv, dyv * inv
    tx_, ty_ = -ny_, nx_
    li = ri - 0.5 * delta
    lj = rj - 0.5 * delta
    larm = omi * li + omj * lj
    vrx = vxi - vxj - larm * tx_
    vry = vyi - vyj - larm * ty_
    vn = vrx * nx_ + vry * ny_
    vt = vrx * tx_ + vry * ty_
    fn = cfg.kn * delta - cfg.gamma_n * vn
    cap = cfg.mu * torch.abs(fn)
    ft = torch.minimum(torch.maximum(-cfg.gamma_t * vt, -cap), cap)
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    fn = torch.where(touching, fn, zero)
    ft = torch.where(touching, ft, zero)
    return (fn * nx_ + ft * tx_, fn * ny_ + ft * ty_, -li * ft, touching)


def _force_plain(s, kmax: int, ncl: int, cfg: SimConfig):
    """One force evaluation on whole planes: ((3, K, R, C) forces,
    directed touching count)."""
    K, R, C = s.shape[1:]
    col = torch.arange(C, device=s.device)[None, :]
    lane_ok = {dc: (col + dc >= 0) & (col + dc < ncl) for dc in (-1, 0, 1)}
    F = torch.zeros((3, K, R, C), dtype=s.dtype, device=s.device)
    nc = torch.zeros((), dtype=torch.int64, device=s.device)
    st = s[[_X, _Y, _VX, _VY, _OM, _R], :kmax]  # (6, kmax, R, C)
    # partner planes of every (k2, dy, dc), in the kernel's loop order:
    # shifted[c, j][s][l] = st[c, k2][s + dy][l + dc]
    shifts = [(k2, dy, dc) for k2 in range(kmax) for dy in (-1, 0, 1)
              for dc in (-1, 0, 1)]
    shifted = torch.stack([torch.roll(st[:, k2], shifts=(-dy, -dc),
                                      dims=(1, 2)) for k2, dy, dc in shifts],
                          dim=1)  # (6, 9 * kmax, R, C)
    okd = torch.stack([lane_ok[dc].expand(R, C) for _, _, dc in shifts])
    for k in range(kmax):
        mine = [p[k] for p in st]
        ok = okd & (shifted[5] > 0)
        ok[9 * k + 4] = False  # (k2, dy, dc) = (k, 0, 0): the disk itself
        dfx, dfy, dtq, tt = _pair(*mine, *shifted, ok, cfg)
        # accumulate sequentially, in the kernel's order
        fx = torch.zeros((R, C), dtype=s.dtype, device=s.device)
        fy = torch.zeros_like(fx)
        tq = torch.zeros_like(fx)
        for j in range(len(shifts)):
            fx, fy, tq = fx + dfx[j], fy + dfy[j], tq + dtq[j]
        nc = nc + torch.sum(tt)
        zero = torch.zeros_like(fx)
        for on, wpos, waxis in _walls(cfg):
            if not on:
                continue
            xj = torch.full_like(fx, wpos) if waxis == 0 else mine[0]
            yj = mine[1] if waxis == 0 else torch.full_like(fx, wpos)
            dfx, dfy, dtq, _ = _pair(*mine, xj, yj, zero, zero, zero, zero,
                                     torch.ones_like(fx, dtype=torch.bool),
                                     cfg)
            fx, fy, tq = fx + dfx, fy + dfy, tq + dtq
        act = (mine[5] > 0).to(s.dtype)
        F[0, k] = (fx + s[_FHX, k]) * act
        F[1, k] = (fy + s[_FHY, k]) * act
        F[2, k] = (tq + s[_THQ, k]) * act
    return F, nc


def subcycle_slabs_plain(slabs, kmax, cfg: SimConfig, ncl: int):
    """Plain version of K3: force(h = 0), then n_sub x (kick-drift,
    force, kick) on whole planes. Returns (new slabs, n_contacts () i32:
    max over evaluations of the directed count, halved)."""
    out = slabs.clone()
    R = out.shape[2]
    # every slot outside the real cells (rows [8, R - 8), lanes [0, ncl))
    # is empty and no phase changes it: work on a view of the real cells
    # plus one empty guard row on each side
    s = out[:, :, 7:R - 7, :ncl]
    km = int(kmax)
    h = float(np.float32(1.0 / cfg.n_sub)) if s.dtype == torch.float32 \
        else 1.0 / cfg.n_sub
    half_h = 0.5 * h
    F, nc = _force_plain(s, km, ncl, cfg)
    nc_max = nc
    for _ in range(cfg.n_sub):
        r, minv = s[_R], s[_MINV]
        inv_i = minv * 2.0 / torch.clamp(r * r, min=1e-12)
        a = (r > 0).to(s.dtype)
        vxh = s[_VX] + half_h * F[0] * minv
        vyh = s[_VY] + half_h * F[1] * minv
        omh = s[_OM] + half_h * F[2] * inv_i
        s[_X] = s[_X] + h * vxh * a
        s[_Y] = s[_Y] + h * vyh * a
        s[_TH] = s[_TH] + h * omh * a
        s[_VX], s[_VY], s[_OM] = vxh, vyh, omh
        F, nc = _force_plain(s, km, ncl, cfg)
        nc_max = torch.maximum(nc_max, nc)
        s[_VX] = (s[_VX] + half_h * F[0] * minv) * a
        s[_VY] = (s[_VY] + half_h * F[1] * minv) * a
        s[_OM] = (s[_OM] + half_h * F[2] * inv_i) * a
    return out, (nc_max // 2).to(torch.int32)


def _dem_params(cfg: SimConfig) -> kernels.DemParams:
    f32 = np.float32
    h = f32(1.0 / cfg.n_sub)
    walls = _walls(cfg)
    return kernels.DemParams(
        kn=f32(cfg.kn), gn=f32(cfg.gamma_n), gt=f32(cfg.gamma_t),
        mu=f32(cfg.mu), h=h, half_h=f32(0.5) * h,
        wall_pos=(ctypes.c_float * 4)(*[f32(p) for _, p, _ in walls]),
        wall_on=(ctypes.c_int * 4)(*[int(on) for on, _, _ in walls]),
    )


def check_dem_cfg(cfg: SimConfig) -> None:
    """Raise for contact models and boundaries the slab port lacks."""
    if cfg.kt > 0.0:
        raise not_ported("tangential history springs (kt > 0)", 9)
    if cfg.wrap_lx or cfg.wrap_ly:
        raise not_ported("periodic disks (periodic slab DEM and ghosts)", 9)


def subcycle_slabs(slabs, kmax, n_occ, band_offs, grid: DemGrid,
                   cfg: SimConfig, axis: str):
    """K3: the n_sub-substep subcycle of the slab planes. Returns (slabs
    after the subcycle, n_contacts () i32).

    CPU tensors take the plain version (a new tensor); CUDA tensors take
    the kernel csrc/slab_dem.cu, which updates `slabs` IN PLACE (the
    caller's tensor is returned) and keeps kmax/n_occ on the device."""
    check_dem_cfg(cfg)
    ncs, ncl, R, C, nb = slab_dims(grid, axis)
    if tuple(slabs.shape) != (_NCH, SLAB_K, R, C):
        raise ValueError(f"subcycle_slabs: slabs {tuple(slabs.shape)} != "
                         f"{(_NCH, SLAB_K, R, C)}")
    if slabs.device.type == "cpu":
        return subcycle_slabs_plain(slabs, kmax, cfg, ncl)
    kmax = kmax.reshape(1)
    n_occ = n_occ.reshape(1)
    kernels.require_cuda_f32("subcycle_slabs", slabs, kmax, n_occ, band_offs)
    if slabs.dtype != torch.float32:
        raise ValueError("subcycle_slabs: the CUDA kernel takes float32")
    fscr = torch.empty((3, SLAB_K, R, C), dtype=torch.float32,
                       device=slabs.device)
    counters = torch.zeros((cfg.n_sub + 1,), dtype=torch.int32,
                           device=slabs.device)
    code = kernels.library().lbm_dem_subcycle(
        slabs.data_ptr(), fscr.data_ptr(), counters.data_ptr(),
        kmax.data_ptr(), n_occ.data_ptr(), band_offs.data_ptr(), nb, SLAB_K,
        R, C, ncl, cfg.n_sub, _dem_params(cfg), kernels.stream())
    kernels.check(code, "slab DEM kernel (K3)")
    subcycle_slabs.launches += 1
    return slabs, (torch.max(counters) // 2).to(torch.int32)


subcycle_slabs.launches = 0


def _unslab(out, slot, disks: DiskState):
    """New DiskState: the 6 integrated channels (_X.._TH) gathered back
    to disk order for slotted active disks; the rest keep `disks`."""
    ok = (slot >= 0) & disks.active
    g = out[:6].reshape(6, -1)[:, slot.clamp(min=0).to(torch.int64)]
    dt = disks.x.dtype

    def pick(ch, old):
        return torch.where(ok, g[ch].to(dt), old)

    return disks._replace(
        x=torch.stack([pick(_X, disks.x[:, 0]), pick(_Y, disks.x[:, 1])], 1),
        v=torch.stack([pick(_VX, disks.v[:, 0]), pick(_VY, disks.v[:, 1])],
                      1),
        omega=pick(_OM, disks.omega),
        theta=pick(_TH, disks.theta),
    )


def _leftover_fallback(new, disks, leftover, overflow, f_hydro, t_hydro,
                       body_f, cfg: SimConfig):
    """Velocity-Verlet without disk-disk contacts (hydro + body + walls)
    for the active disks the slab could not slot. The check of
    `overflow` reads one scalar from the device each step; with no
    overflow nothing else runs."""
    if int(overflow) == 0:
        return new
    h = 1.0 / cfg.n_sub
    inv_m = torch.where(leftover & disks.mobile, 1.0 / disks.mass,
                        torch.zeros_like(disks.mass))
    inv_i = torch.where(leftover & disks.mobile, 1.0 / disks.inertia,
                        torch.zeros_like(disks.inertia))
    lo2 = leftover[:, None]

    def force(d):
        Fw, Tw = dem_ops.wall_forces(d, cfg)
        return (Fw + f_hydro + body_f) * lo2, (Tw + t_hydro) * leftover

    d = disks
    F, T = force(d)
    for _ in range(cfg.n_sub):
        vh = d.v + (0.5 * h) * F * inv_m[:, None]
        omh = d.omega + (0.5 * h) * T * inv_i
        d = d._replace(x=d.x + h * vh * lo2,
                       theta=d.theta + h * omh * leftover)
        F, T = force(d._replace(v=vh, omega=omh))
        d = d._replace(
            v=torch.where(lo2, vh + (0.5 * h) * F * inv_m[:, None], d.v),
            omega=torch.where(leftover, omh + (0.5 * h) * T * inv_i, d.omega),
        )
    return new._replace(
        x=torch.where(lo2, d.x, new.x), v=torch.where(lo2, d.v, new.v),
        omega=torch.where(leftover, d.omega, new.omega),
        theta=torch.where(leftover, d.theta, new.theta),
    )


def dem_subcycle(disks: DiskState, f_hydro, t_hydro, grid: DemGrid,
                 cfg: SimConfig, axis: str = "y"):
    """One LBM step of DEM on the slab path: build_slabs -> K3 ->
    _unslab -> leftover fallback. Returns (new disks, overflow () i32,
    n_contacts () i32)."""
    body_f = dem_ops.body_forces(disks, cfg)
    slabs, slot, overflow, kmax, n_occ, band_offs = build_slabs(
        disks, f_hydro, t_hydro, body_f, grid, axis)
    out, nc = subcycle_slabs(slabs, kmax, n_occ, band_offs, grid, cfg, axis)
    new = _unslab(out, slot, disks)
    leftover = disks.active & (slot < 0)
    new = _leftover_fallback(new, disks, leftover, overflow, f_hydro,
                             t_hydro, body_f, cfg)
    return new, overflow, nc
