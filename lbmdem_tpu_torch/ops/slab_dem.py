"""DEM subcycle over slab planes (K3, K3w) and the glue around it.

Counterpart of the JAX package's `lbmdem_tpu/ops/pallas_dem.py`, in two
flavours:

- per step (`dem_subcycle`): `build_slabs` slots each active disk into
  a dense (K, R, C) grid of broadphase cells (rank-major planes, 8-row
  empty guard bands) and packs the 11 state channels (NCH, K, R, C),
  hydro + body forces baked in, with `slot_of_disk`, `kmax` and the
  occupancy band table (`n_occ`, `band_offs`); `subcycle_slabs` is K3:
  the CUDA kernel `csrc/slab_dem.cu` for CUDA tensors,
  `subcycle_slabs_plain` (the same phases on whole planes, partners by
  `torch.roll`) for CPU tensors;
- per coupling_k window (`dem_subcycle_window`): ONE slim 8-channel
  build (`bake_forces=False`, _MINV at channel 7), all k inner steps'
  force planes in one scatter (`_force_planes_window`), k chained K3w
  subcycles (`subcycle_slabs_window`, each reading its own (3, K, R, C)
  force planes), ONE unslab and the slot-staleness detector.

Tangential history springs (cfg.kt > 0) ride the slabs: a contact
between the disk at slot (k, s, l) and the partner at (k2, s + dy,
l + dc) is a fixed (dy, dc, k2) relation for a whole subcycle, so each
rank carries 9 * SLAB_K pair-spring channels (one per partner slot) and
4 wall-spring channels (51 channels per step, 48 in the slim layout),
advanced in place by every force evaluation after the first. Across
steps the springs are re-matched by partner id through
`DiskState.ct_j/ct_xi` (`_partner_ids`, `_rematch_xi`; `_unslab`
compacts them back), the cell-list DEM's carry, so the two DEMs
interoperate mid-run. A window freezes the partner map at its start.

On a periodic axis the cells tile the domain exactly, the 3 x 3 patch
wraps by modular cell row or lane, and the pair law takes the minimum
image; partner coordinates stay raw.

`_unslab` gathers the integrated channels 0-5 (the same in both
layouts) and the springs back to disk order and `_leftover_fallback`
integrates, contact-free, the active disks the slab could not slot
(rank >= SLAB_K).

Cell ranks come from `torch.sort(stable=True)`: within one cell the
slots follow disk order, where the JAX package's unstable sort may
order them otherwise (the cells' sets agree).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import dem as dem_ops
from lbmdem_tpu_torch.ops.dem import DemGrid, DiskState
from lbmdem_tpu_torch.ops.stamp import _segment_ranks

SLAB_K = 4  # slots per broadphase cell

# state plane channels; _MINV is 1/mass, 0 for fixed and empty slots
_X, _Y, _VX, _VY, _OM, _TH, _R, _FHX, _FHY, _THQ, _MINV = range(11)
_NCH = 11
# the slim window layout: no baked force channels, _MINV at channel 7
_MINV_SLIM = 7
_NCH_SLIM = 8
# kt > 0 appends per-rank spring channels: 9 * SLAB_K pair springs
# (channel _XI0 + dir * SLAB_K + k2 holds rank k's stretch against rank k2
# of the (dy, dc) cell, dir = (dy + 1) * 3 + (dc + 1)) and 4 wall springs
# (W/E/S/N, as DiskState.wall_xi); in the slim layout they start at 8
_XI0 = _NCH
_NXI = 9 * SLAB_K
_XIW = _XI0 + _NXI
_NCH_KT = _XIW + 4
_XI0_SLIM = _NCH_SLIM


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


def _wrap_sl(grid: DemGrid, axis: str) -> Tuple[float, float]:
    """(row, lane) wrap lengths of the slab orientation (0 = walls)."""
    return ((grid.wrap_ly, grid.wrap_lx) if axis == "y"
            else (grid.wrap_lx, grid.wrap_ly))


def slab_supported(grid: DemGrid, axis: str = "y", kt: bool = False,
                   device=None) -> bool:
    """Whether the slab DEM takes this grid; past the gate the cell-list
    DEM runs. A wrapped row axis needs >= 8 cell rows. On the card that
    and int32 slot indices are all the kernel needs. Elsewhere (device
    None or the CPU) the JAX feasibility gate holds as well (plane size,
    and a byte budget of the state planes plus force scratch that halves
    with the spring channels of kt), so both packages take the same DEM
    on the same scene where their runs are compared."""
    ncs, ncl, R, C, nb = slab_dims(grid, axis)
    wrap_s, _ = _wrap_sl(grid, axis)
    if wrap_s and ncs < 8:
        return False
    if device is not None and torch.device(device).type == "cuda":
        return SLAB_K * R * C < 2**31
    if R * C > 270000:
        return False
    nch = _NCH_KT if kt else _NCH
    bytes_ = (nch * SLAB_K + 3 * SLAB_K + 1) * R * C * 4
    return bytes_ <= (48 if kt else 72) * 2**20


def _partner_ids(slot, grid: DemGrid, axis: str):
    """(N, _NXI) int32 partner disk id of each (dy, dc, k2) slab slot of
    each disk (-1 = empty, outside the grid, or the disk itself), in the
    spring channels' order dir * SLAB_K + k2. Wrapped axes take modular
    adjacency (the cells tile a wrapped axis exactly)."""
    ncs, ncl, R, C, _ = slab_dims(grid, axis)
    wrap_s, wrap_l = _wrap_sl(grid, axis)
    n = slot.shape[0]
    dev = slot.device
    nslots = SLAB_K * R * C
    slotted = slot >= 0
    sl64 = slot.to(torch.int64)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    dos = torch.full((nslots + 1,), -1, dtype=torch.int32, device=dev)
    dos[torch.where(slotted, sl64, nslots)] = torch.where(slotted, iota, -1)
    p = sl64.clamp(min=0)
    k_i = torch.div(p, R * C, rounding_mode="floor")
    rem = p - k_i * (R * C)
    prow = torch.div(rem, C, rounding_mode="floor")
    row = prow - 8  # the real cell row (without the guard band)
    lane = rem - prow * C
    cols = []
    for dy in (-1, 0, 1):
        rs = row + dy
        if wrap_s:
            rs = torch.remainder(rs, ncs)
            ok_y = torch.ones_like(slotted)
        else:
            ok_y = (rs >= 0) & (rs < ncs)
        for dc in (-1, 0, 1):
            ls = lane + dc
            if wrap_l:
                ls = torch.remainder(ls, ncl)
                ok = ok_y
            else:
                ok = ok_y & (ls >= 0) & (ls < ncl)
            base = (rs + 8) * C + ls
            for k2 in range(SLAB_K):
                ps = torch.where(ok & slotted, k2 * (R * C) + base, nslots)
                # never its own partner, also where a wrapped neighbour
                # cell is the cell itself
                cols.append(torch.where(ps == p, nslots, ps))
    return dos[torch.stack(cols, dim=1)]


def _rematch_xi(j36, ct_j, ct_xi):
    """(N, _NXI) carried stretch of each fresh partner slot: the springs
    of DiskState.ct_j/ct_xi re-matched by partner id (a pair that
    persists keeps its stretch, a new pair starts at 0)."""
    same = ((j36[:, :, None] == ct_j[:, None, :]) & (ct_j[:, None, :] >= 0)
            & (j36[:, :, None] >= 0))
    return torch.sum(torch.where(same, ct_xi[:, None, :],
                                 torch.zeros((), dtype=ct_xi.dtype,
                                             device=ct_xi.device)), dim=2)


def build_slabs(disks: DiskState, f_hydro, t_hydro, body_f, grid: DemGrid,
                axis: str = "y", kt: bool = False, bake_forces: bool = True):
    """(slabs (NCH, K, R, C), slot_of_disk (N,) i32 (-1 = not slotted),
    overflow () i32, kmax () i32 - max occupied rank + 1, n_occ () i32,
    band_offs (nb,) i32 - the plane-row offsets of the occupied 8-row
    bands, ascending, then R -, j36 - the (N, _NXI) partner-id map when
    kt, else None). The slabs keep the disks' dtype; empty slots hold
    all-zero rows (r = 0).

    kt: the slabs carry the rematched pair springs and the wall springs
    after the 1/mass channel (_NCH_KT channels, or 48 when slim).
    bake_forces=False: the slim window layout (no hydro + body channels;
    f_hydro and t_hydro are not read)."""
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

    fields = [
        disks.x[:, 0], disks.x[:, 1], disks.v[:, 0], disks.v[:, 1],
        disks.omega, disks.theta,
        torch.where(disks.active, disks.r, torch.zeros_like(disks.r)),
    ]
    if bake_forces:
        f_hydro = f_hydro.expand(n, 2)
        t_hydro = t_hydro.expand(n)
        body_f = body_f.expand(n, 2)
        fields += [(f_hydro[:, 0] + body_f[:, 0]).to(dt),
                   (f_hydro[:, 1] + body_f[:, 1]).to(dt), t_hydro.to(dt)]
    fields.append(torch.where(disks.mobile & disks.active, 1.0 / disks.mass,
                              torch.zeros_like(disks.mass)))
    j36 = None
    if kt:
        j36 = _partner_ids(slot_of_disk, grid, axis)
        xi0 = _rematch_xi(j36, disks.ct_j, disks.ct_xi).to(dt)
        fields += list(xi0.unbind(1)) + list(disks.wall_xi.to(dt).unbind(1))
    nch = len(fields)
    packed = torch.stack(fields)[:, order]  # (nch, N), slot-ordered
    dense = torch.zeros((nch, nslots + 1), dtype=dt, device=dev)
    dense[:, slot] = packed
    slabs = dense[:, :nslots].reshape(nch, SLAB_K, R, C).contiguous()
    return slabs, slot_of_disk, overflow, kmax, n_occ, band_offs, j36


def _force_planes_window(slot_of_disk, forces, body_f, slab_shape):
    """(k, 3, K, R, C) hydro + body force planes of ALL k inner steps of
    a window in one column scatter into zeros. forces = [(f_hydro (N, 2),
    t_hydro (N,)), ...] per inner step; slot -1 (not slotted) goes to a
    dropped column, never wrapped to the last slot."""
    n = slot_of_disk.shape[0]
    body_f = body_f.expand(n, 2)
    dt = forces[0][0].dtype
    rows = []
    for f_hydro, t_hydro in forces:
        f_hydro = f_hydro.expand(n, 2)
        rows += [f_hydro[:, 0] + body_f[:, 0], f_hydro[:, 1] + body_f[:, 1],
                 t_hydro.expand(n)]
    K, R, C = slab_shape[1:]
    nslots = K * R * C
    tgt = torch.where(slot_of_disk >= 0, slot_of_disk.to(torch.int64),
                      torch.full_like(slot_of_disk, nslots, dtype=torch.int64))
    dense = torch.zeros((len(rows), nslots + 1), dtype=dt,
                        device=slot_of_disk.device)
    dense[:, tgt] = torch.stack(rows).to(dt)
    return dense[:, :nslots].reshape(len(forces), 3, K, R, C).contiguous()


def _walls(cfg: SimConfig):
    """(on, position, lattice axis) of the W/E/S/N wall mirror planes."""
    return [
        (cfg.bc_west == WALL, -0.5, 0),
        (cfg.bc_east == WALL, cfg.nx - 0.5, 0),
        (cfg.bc_south == WALL, -0.5, 1),
        (cfg.bc_north == WALL, cfg.ny - 0.5, 1),
    ]


def _pair(xi, yi, vxi, vyi, omi, ri, xj, yj, vxj, vyj, omj, rj, ok,
          cfg: SimConfig, min_image: bool = True, spring=None, adv=0.0):
    """The slab kernel's pair law (n = d * (1/dist) as on the card):
    (dfx, dfy, dtq, touching, xi') of j on i, zero where not touching.
    min_image: the minimum-image displacement on periodic axes (wall
    mirror points pass False). spring/adv (kt > 0): the carried
    tangential stretch and the step it advances by (0 evaluates without
    advancing); xi' is the slip-consistently truncated new stretch, None
    without a spring."""
    dx = xi - xj
    dyv = yi - yj
    if min_image and cfg.wrap_lx:
        dx = dx - cfg.wrap_lx * torch.round(dx / cfg.wrap_lx)
    if min_image and cfg.wrap_ly:
        dyv = dyv - cfg.wrap_ly * torch.round(dyv / cfg.wrap_ly)
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
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    xi_new = None
    if spring is not None:
        xi_t = torch.where(touching, spring + vt * adv, zero)
        ft = torch.minimum(torch.maximum(
            -cfg.kt * xi_t - cfg.gamma_t * vt, -cap), cap)
        xi_new = torch.where(touching, -(ft + cfg.gamma_t * vt) / cfg.kt,
                             zero)
    else:
        ft = torch.minimum(torch.maximum(-cfg.gamma_t * vt, -cap), cap)
    fn = torch.where(touching, fn, zero)
    ft = torch.where(touching, ft, zero)
    return (fn * nx_ + ft * tx_, fn * ny_ + ft * ty_, -li * ft, touching,
            xi_new)


def _force_plain(s, hyd, kmax: int, wrap_l: bool, cfg: SimConfig, xi0=None,
                 adv=0.0, write_xi: bool = False):
    """One force evaluation on whole planes, plus the hydro + body
    planes `hyd` (3, K, R, C): ((3, K, R, C) forces, directed touching
    count). `s` is a view of the real cells (with one empty guard row on
    each side of a wall row axis, none on a wrapped one), so rolling it
    gives the 3 x 3 patch with modular adjacency on wrapped axes. xi0:
    the first spring channel (kt > 0); the springs advance by `adv` and,
    with write_xi, are written back into `s`."""
    K, R, C = s.shape[1:]
    col = torch.arange(C, device=s.device)[None, :]
    lane_ok = {dc: (torch.ones_like(col, dtype=torch.bool) if wrap_l else
                    (col + dc >= 0) & (col + dc < C)) for dc in (-1, 0, 1)}
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
    xi_ch = None
    if xi0 is not None:  # spring channel of every (k2, dy, dc)
        xi_ch = [xi0 + ((dy + 1) * 3 + (dc + 1)) * SLAB_K + k2
                 for k2, dy, dc in shifts]
    for k in range(kmax):
        mine = [p[k] for p in st]
        ok = okd & (shifted[5] > 0)
        ok[9 * k + 4] = False  # (k2, dy, dc) = (k, 0, 0): the disk itself
        spring = None if xi_ch is None else s[xi_ch, k]
        dfx, dfy, dtq, tt, xi_new = _pair(*mine, *shifted, ok, cfg,
                                          spring=spring, adv=adv)
        live = mine[5] > 0  # empty slots keep their channels
        if write_xi and xi_ch is not None:
            s[xi_ch, k] = torch.where(live, xi_new, spring)
        # accumulate sequentially, in the kernel's order
        fx = torch.zeros((R, C), dtype=s.dtype, device=s.device)
        fy = torch.zeros_like(fx)
        tq = torch.zeros_like(fx)
        for j in range(len(shifts)):
            fx, fy, tq = fx + dfx[j], fy + dfy[j], tq + dtq[j]
        nc = nc + torch.sum(tt)
        zero = torch.zeros_like(fx)
        for w, (on, wpos, waxis) in enumerate(_walls(cfg)):
            if not on:
                continue
            xj = torch.full_like(fx, wpos) if waxis == 0 else mine[0]
            yj = mine[1] if waxis == 0 else torch.full_like(fx, wpos)
            wch = None if xi0 is None else xi0 + _NXI + w
            wspring = None if wch is None else s[wch, k]
            dfx, dfy, dtq, _, xi_new = _pair(
                *mine, xj, yj, zero, zero, zero, zero,
                torch.ones_like(fx, dtype=torch.bool), cfg, min_image=False,
                spring=wspring, adv=adv)
            if write_xi and wch is not None:
                s[wch, k] = torch.where(live, xi_new, wspring)
            fx, fy, tq = fx + dfx, fy + dfy, tq + dtq
        act = (mine[5] > 0).to(s.dtype)
        F[0, k] = (fx + hyd[0, k]) * act
        F[1, k] = (fy + hyd[1, k]) * act
        F[2, k] = (tq + hyd[2, k]) * act
    return F, nc


def subcycle_slabs_plain(slabs, kmax, cfg: SimConfig, grid: DemGrid,
                         axis: str = "y", forces3=None):
    """Plain version of K3 (forces3 None: baked force channels) and of
    K3w (slim slabs, hydro + body forces from the (3, K, R, C) planes
    `forces3`): force(h = 0), then n_sub x (kick-drift, force, kick) on
    whole planes; with cfg.kt > 0 the spring channels advance in every
    force evaluation but the first. Returns (new slabs, n_contacts ()
    i32: max over evaluations of the directed count, halved)."""
    out = slabs.clone()
    R = out.shape[2]
    ncs, ncl = slab_dims(grid, axis)[:2]
    wrap_s, wrap_l = _wrap_sl(grid, axis)
    # every slot outside the real cells (rows [8, 8 + ncs), lanes [0,
    # ncl)) is empty and no phase changes it: work on a view of the real
    # cells, with one empty guard row on each side of a wall row axis
    rows = slice(8, 8 + ncs) if wrap_s else slice(7, R - 7)
    s = out[:, :, rows, :ncl]
    if forces3 is None:
        hyd, ch_minv, xi0 = s[_FHX:_THQ + 1], _MINV, _XI0
    else:
        hyd, ch_minv, xi0 = forces3[:, :, rows, :ncl], _MINV_SLIM, _XI0_SLIM
    if not cfg.kt > 0.0:
        xi0 = None
    km = int(kmax)
    h = float(np.float32(1.0 / cfg.n_sub)) if s.dtype == torch.float32 \
        else 1.0 / cfg.n_sub
    half_h = 0.5 * h
    F, nc = _force_plain(s, hyd, km, bool(wrap_l), cfg, xi0)
    nc_max = nc
    for _ in range(cfg.n_sub):
        r, minv = s[_R], s[ch_minv]
        inv_i = minv * 2.0 / torch.clamp(r * r, min=1e-12)
        a = (r > 0).to(s.dtype)
        vxh = s[_VX] + half_h * F[0] * minv
        vyh = s[_VY] + half_h * F[1] * minv
        omh = s[_OM] + half_h * F[2] * inv_i
        s[_X] = s[_X] + h * vxh * a
        s[_Y] = s[_Y] + h * vyh * a
        s[_TH] = s[_TH] + h * omh * a
        s[_VX], s[_VY], s[_OM] = vxh, vyh, omh
        F, nc = _force_plain(s, hyd, km, bool(wrap_l), cfg, xi0, h, True)
        nc_max = torch.maximum(nc_max, nc)
        s[_VX] = (s[_VX] + half_h * F[0] * minv) * a
        s[_VY] = (s[_VY] + half_h * F[1] * minv) * a
        s[_OM] = (s[_OM] + half_h * F[2] * inv_i) * a
    return out, (nc_max // 2).to(torch.int32)


def _dem_params(cfg: SimConfig, grid: DemGrid, axis: str) -> kernels.DemParams:
    f32 = np.float32
    h = f32(1.0 / cfg.n_sub)
    walls = _walls(cfg)
    wrap_s, wrap_l = _wrap_sl(grid, axis)
    return kernels.DemParams(
        kn=f32(cfg.kn), gn=f32(cfg.gamma_n), gt=f32(cfg.gamma_t),
        mu=f32(cfg.mu), h=h, half_h=f32(0.5) * h, kt=f32(cfg.kt),
        wrap_lx=f32(cfg.wrap_lx), wrap_ly=f32(cfg.wrap_ly),
        wall_pos=(ctypes.c_float * 4)(*[f32(p) for _, p, _ in walls]),
        wall_on=(ctypes.c_int * 4)(*[int(on) for on, _, _ in walls]),
        wrap_s=int(bool(wrap_s)), wrap_l=int(bool(wrap_l)),
        ncs=slab_dims(grid, axis)[0],
    )


def _launch(slabs, forces3, kmax, n_occ, band_offs, grid: DemGrid,
            cfg: SimConfig, axis: str, what: str):
    """Launch K3 (forces3 None) or K3w on CUDA slabs, in place; returns
    n_contacts () i32."""
    ncs, ncl, R, C, nb = slab_dims(grid, axis)
    kmax = kmax.reshape(1)
    n_occ = n_occ.reshape(1)
    extra = () if forces3 is None else (forces3,)
    kernels.require_cuda_f32(what, slabs, kmax, n_occ, band_offs, *extra)
    if slabs.dtype != torch.float32:
        raise ValueError(f"{what}: the CUDA kernel takes float32")
    fscr = torch.empty((3, SLAB_K, R, C), dtype=torch.float32,
                       device=slabs.device)
    counters = torch.zeros((cfg.n_sub + 1,), dtype=torch.int32,
                           device=slabs.device)
    lib = kernels.library()
    args = (fscr.data_ptr(), counters.data_ptr(), kmax.data_ptr(),
            n_occ.data_ptr(), band_offs.data_ptr(), nb, SLAB_K, R, C, ncl,
            cfg.n_sub, _dem_params(cfg, grid, axis), kernels.stream())
    if forces3 is None:
        code = lib.lbm_dem_subcycle(slabs.data_ptr(), *args)
    else:
        code = lib.lbm_dem_subcycle_window(slabs.data_ptr(),
                                           forces3.data_ptr(), *args)
    kernels.check(code, what)
    return (torch.max(counters) // 2).to(torch.int32)


def _check_slabs(slabs, nch: int, grid: DemGrid, axis: str, what: str):
    ncs, ncl, R, C, nb = slab_dims(grid, axis)
    if tuple(slabs.shape) != (nch, SLAB_K, R, C):
        raise ValueError(f"{what}: slabs {tuple(slabs.shape)} != "
                         f"{(nch, SLAB_K, R, C)}")


def subcycle_slabs(slabs, kmax, n_occ, band_offs, grid: DemGrid,
                   cfg: SimConfig, axis: str):
    """K3: the n_sub-substep subcycle of the slab planes (11 channels, or
    51 with the springs of cfg.kt > 0). Returns (slabs after the
    subcycle, n_contacts () i32).

    CPU tensors take the plain version (a new tensor); CUDA tensors take
    the kernel csrc/slab_dem.cu, which updates `slabs` IN PLACE (the
    caller's tensor is returned) and keeps kmax/n_occ on the device."""
    _check_slabs(slabs, _NCH_KT if cfg.kt > 0.0 else _NCH, grid, axis,
                 "subcycle_slabs")
    if slabs.device.type == "cpu":
        return subcycle_slabs_plain(slabs, kmax, cfg, grid, axis)
    nc = _launch(slabs, None, kmax, n_occ, band_offs, grid, cfg, axis,
                 "slab DEM kernel (K3)")
    subcycle_slabs.launches += 1
    return slabs, nc


def subcycle_slabs_window(slabs, forces3, kmax, n_occ, band_offs,
                          grid: DemGrid, cfg: SimConfig, axis: str):
    """K3w: one inner step's subcycle of the slim window slabs (8
    channels, or 48 with the springs of cfg.kt > 0), with that step's
    hydro + body forces from the planes `forces3` (3, K, R, C). Returns
    (slabs after the subcycle, n_contacts () i32).

    CPU tensors take the plain version (a new tensor); CUDA tensors take
    the kernel csrc/slab_dem.cu (lbm_dem_subcycle_window), which updates
    `slabs` IN PLACE."""
    _check_slabs(slabs, _NCH_SLIM + (_NXI + 4 if cfg.kt > 0.0 else 0), grid,
                 axis, "subcycle_slabs_window")
    if tuple(forces3.shape) != (3,) + tuple(slabs.shape[1:]):
        raise ValueError(f"subcycle_slabs_window: forces3 "
                         f"{tuple(forces3.shape)} != "
                         f"{(3,) + tuple(slabs.shape[1:])}")
    if slabs.device.type == "cpu":
        return subcycle_slabs_plain(slabs, kmax, cfg, grid, axis, forces3)
    nc = _launch(slabs, forces3, kmax, n_occ, band_offs, grid, cfg, axis,
                 "window slab DEM kernel (K3w)")
    subcycle_slabs_window.launches += 1
    return slabs, nc


subcycle_slabs.launches = 0
subcycle_slabs_window.launches = 0


def _unslab(out, slot, disks: DiskState, cfg: SimConfig, j36, overflow,
            slim: bool = False):
    """(new DiskState, overflow): the 6 integrated channels (_X.._TH)
    gathered back to disk order for slotted active disks; the rest keep
    `disks`. With cfg.kt > 0 also the springs: the nonzero pair springs
    compact to the (N, contact_cap) carry ct_j/ct_xi (partner id and
    stretch, slot order kept: the JAX top_k over the 0/1 mask keeps tied
    entries in index order, as a stable descending sort does), springs
    past contact_cap are counted into overflow, and wall_xi takes the
    wall channels. slim: the window layout (springs from channel 8)."""
    ok = (slot >= 0) & disks.active
    idx = slot.clamp(min=0).to(torch.int64)
    g = out[:6].reshape(6, -1)[:, idx]
    dt = disks.x.dtype

    def pick(ch, old):
        return torch.where(ok, g[ch].to(dt), old)

    new = disks._replace(
        x=torch.stack([pick(_X, disks.x[:, 0]), pick(_Y, disks.x[:, 1])], 1),
        v=torch.stack([pick(_VX, disks.v[:, 0]), pick(_VY, disks.v[:, 1])],
                      1),
        omega=pick(_OM, disks.omega),
        theta=pick(_TH, disks.theta),
    )
    if not cfg.kt > 0.0:
        return new, overflow
    xi0 = _XI0_SLIM if slim else _XI0
    gx = out[xi0:xi0 + _NXI + 4].reshape(_NXI + 4, -1)[:, idx].T.to(dt)
    xi36 = gx[:, :_NXI]
    keep = (j36 >= 0) & (xi36 != 0.0) & ok[:, None]
    cap = cfg.contact_cap
    k_eff = min(cap, _NXI)
    order = torch.sort(keep.to(torch.uint8), dim=1, descending=True,
                       stable=True).indices[:, :k_eff]
    hit = torch.gather(keep, 1, order)
    ct_j = torch.where(hit, torch.gather(j36, 1, order), -1)
    ct_xi = torch.where(hit, torch.gather(xi36, 1, order),
                        torch.zeros((), dtype=dt, device=out.device))
    if cap > k_eff:
        n = ct_j.shape[0]
        ct_j = torch.cat([ct_j, torch.full((n, cap - k_eff), -1,
                                           dtype=ct_j.dtype,
                                           device=out.device)], 1)
        ct_xi = torch.cat([ct_xi, torch.zeros((n, cap - k_eff), dtype=dt,
                                              device=out.device)], 1)
    ovf_ct = (torch.sum(keep, dtype=torch.int32)
              - torch.sum(hit, dtype=torch.int32))
    wall_xi = torch.where(ok[:, None], gx[:, _NXI:], disks.wall_xi)
    return (new._replace(ct_j=ct_j, ct_xi=ct_xi, wall_xi=wall_xi),
            torch.maximum(overflow, ovf_ct))


def _merge(mask, src: DiskState, dst: DiskState) -> DiskState:
    """dst with the integrated fields of the disks in `mask` from src."""
    m2 = mask[:, None]
    return dst._replace(
        x=torch.where(m2, src.x, dst.x), v=torch.where(m2, src.v, dst.v),
        omega=torch.where(mask, src.omega, dst.omega),
        theta=torch.where(mask, src.theta, dst.theta),
    )


def _fallback_integrate(disks, leftover, f_hydro, t_hydro, body_f,
                        cfg: SimConfig) -> DiskState:
    """n_sub velocity-Verlet substeps without disk-disk contacts (hydro
    + body + walls) of the disks in `leftover`; the others keep their
    state."""
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
    return d


def _leftover_fallback(new, disks, leftover, overflow, f_hydro, t_hydro,
                       body_f, cfg: SimConfig):
    """Velocity-Verlet without disk-disk contacts (hydro + body + walls)
    for the active disks the slab could not slot. The check of
    `overflow` (the build's count of such disks) reads one scalar from
    the device each step; with no overflow nothing else runs."""
    if int(overflow) == 0:
        return new
    return _merge(leftover, _fallback_integrate(
        disks, leftover, f_hydro, t_hydro, body_f, cfg), new)


def dem_subcycle(disks: DiskState, f_hydro, t_hydro, grid: DemGrid,
                 cfg: SimConfig, axis: str = "y"):
    """One LBM step of DEM on the slab path: build_slabs -> K3 ->
    _unslab -> leftover fallback. Returns (new disks, overflow () i32,
    n_contacts () i32)."""
    body_f = dem_ops.body_forces(disks, cfg)
    slabs, slot, ovf_slot, kmax, n_occ, band_offs, j36 = build_slabs(
        disks, f_hydro, t_hydro, body_f, grid, axis, kt=cfg.kt > 0.0)
    out, nc = subcycle_slabs(slabs, kmax, n_occ, band_offs, grid, cfg, axis)
    new, overflow = _unslab(out, slot, disks, cfg, j36, ovf_slot)
    leftover = disks.active & (slot < 0)
    new = _leftover_fallback(new, disks, leftover, ovf_slot, f_hydro,
                             t_hydro, body_f, cfg)
    return new, overflow, nc


def dem_subcycle_window(disks: DiskState, forces, grid: DemGrid,
                        cfg: SimConfig, axis: str = "y"):
    """len(forces) chained DEM subcycles, one per inner step of a
    coupling_k window (forces = [(f_hydro, t_hydro), ...] per inner
    step), with ONE slim slab build and ONE unslab for the window.
    Returns (new disks, overflow () i32, n_contacts () i32 of the last
    inner step).

    Slot assignments, and with cfg.kt > 0 the springs' partner map, stay
    frozen at the window-start positions: the adjacency holds while a
    disk travels less than grid.skin / 2 over the window. The staleness
    detector counts the active disks that travelled further into
    `overflow` after the fact (the window has already integrated with the
    frozen contact set; a run whose overflow trips should be re-run with
    a smaller coupling_k). The leftover fallback reads the build's
    overflow once per window (one host sync) and, when some disk was not
    slotted, integrates it per inner step."""
    body_f = dem_ops.body_forces(disks, cfg)
    slabs, slot, ovf_slot, kmax, n_occ, band_offs, j36 = build_slabs(
        disks, None, None, body_f, grid, axis, kt=cfg.kt > 0.0,
        bake_forces=False)
    f3all = _force_planes_window(slot, forces, body_f, slabs.shape)
    for t in range(len(forces)):
        slabs, nc = subcycle_slabs_window(slabs, f3all[t], kmax, n_occ,
                                          band_offs, grid, cfg, axis)
    new, overflow = _unslab(slabs, slot, disks, cfg, j36, ovf_slot, slim=True)
    if int(ovf_slot) != 0:
        leftover = disks.active & (slot < 0)
        d_fb = disks
        for f_hydro, t_hydro in forces:
            d_fb = _fallback_integrate(d_fb, leftover, f_hydro, t_hydro,
                                       body_f, cfg)
        new = _merge(leftover, d_fb, new)
    trav2 = torch.where(disks.active, torch.sum((new.x - disks.x) ** 2, -1),
                        torch.zeros_like(disks.r))
    stale = torch.sum(trav2 > (0.5 * float(grid.skin)) ** 2).to(torch.int32)
    return new, torch.maximum(overflow, stale), nc
