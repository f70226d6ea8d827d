"""Tile-binned solid-fraction stamp (K1) and the binning glue around it.

Counterpart of the JAX package's `lbmdem_tpu/ops/pallas_stamp.py`:

- `build_tile_lists` buckets each disk's stamp window into the <= 2x2
  stamp tiles it intersects (fixed-capacity per-tile lists, overflow
  counted), `gather_tile_data` packs the per-tile disk records,
  `gather_partials` sums each disk's <= 4 per-tile force partials back
  through the binning's inverse map. The data contracts are the JAX
  ones: `lists`/`entry_slots` slot numbering tile*cap + rank, and
  `tile_data` (n_tiles, 1, cap*8).
- `stamp_fields` is K1: the CUDA kernel `csrc/stamp.cu` for CUDA tensors,
  `stamp_fields_plain` for CPU tensors.
- `reduce_hydro_forces` is K9, the standalone hydro-force reduce of the
  split coupled step: per (tile, slot) partials of cov * phi / max(eps,
  eps_min), then `gather_partials`; the CUDA kernel `lbm_reduce_hydro` of
  `csrc/imb_split.cu` for CUDA tensors, `hydro_partials_plain` for CPU
  tensors.

Coverage takes every eps_method of the JAX package (sample, ramp, exact),
in `cov_field` and in `csrc/coverage.cuh` alike. The kernels' sample
method first classifies a cell against the disk (all-in, all-out, or
ring) and runs the sample loop on ring cells only; `sample_consts`
computes the constants of that test and `sample_class` is its plain
twin, for the tests.

Ranks come from `torch.sort(stable=True)`, so within a tile the slots
follow disk order. The JAX sorts are not stable: the two packages may
order one tile's slots differently, and agree on each tile's set.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops.imb import _EPS_MIN, exact_coverage, sqrt_rn

# stamp tile rows / columns: the JAX chains (coupled lattice tile rows,
# then sub-8 rows for tiny grids; 128-column granule), kept so that the
# two packages bin entry by entry alike
_TILE_ROWS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
_TILE_COLS = (128, 64, 32, 16, 8, 4, 2, 1)
# plain-version tile chunk (bounds the (tiles, cap, W, W) temporaries)
_PLAIN_TILES = 64
# lanes of the reduce kernel's warp per slot, whose order the plain
# reduce follows
_LANES = 32
# eps_method -> the kernels' CovMethod (csrc/coverage.cuh)
COV_METHODS = {"sample": 0, "ramp": 1, "exact": 2}
# relative margin on r^2 of the sample method's fast path: ~500x the f32
# rounding of the sample loop's test (a few 2^-24 of max(d^2, r^2))
COV_MARGIN = 2.0 ** -12


def tile_shape(cfg: SimConfig) -> Tuple[int, int]:
    """(th, tw) of the stamp tiles of cfg's lattice."""
    return (next(t for t in _TILE_ROWS if cfg.ny % t == 0),
            next(t for t in _TILE_COLS if cfg.nx % t == 0))


def tile_dims(cfg: SimConfig) -> Tuple[int, int]:
    """(th, tw) of the stamp tiles; the tile must hold a stamp window."""
    th, tw = tile_shape(cfg)
    if cfg.window > min(th, tw):
        raise ValueError(
            f"stamp window {cfg.window} exceeds tile {th}x{tw}; disks too "
            f"large for the tiled stamp on this lattice")
    return th, tw


def band_height(window: int, th: int) -> int:
    """8-aligned per-disk row band covering a stamp window (the TPU
    kernels' band; the CUDA kernels clip to the window itself)."""
    bh = (window + 7 + 7) & ~7
    return th if bh >= th else bh


def default_tile_cap(tile_h: int, tile_w: int, r_min: float,
                     window: int) -> int:
    """Per-tile disk capacity: dense packing of the smallest disks over
    the tile plus its window margin, with headroom."""
    area = (tile_h + window) * (tile_w + window)
    per_disk = max((2.0 * r_min) ** 2 * 0.85, 1.0)
    cap = int(1.5 * area / per_disk) + 16
    return min((cap + 7) & ~7, 4096)


def _segment_ranks(keys: torch.Tensor):
    """Stable sort of int keys + each element's rank within its run of
    equal keys: (sorted keys, order, rank)."""
    skeys, order = torch.sort(keys, stable=True)
    iota = torch.arange(keys.shape[0], device=keys.device)
    is_start = torch.ones_like(skeys, dtype=torch.bool)
    is_start[1:] = skeys[1:] != skeys[:-1]
    first = torch.cummax(torch.where(is_start, iota, torch.zeros_like(iota)),
                         dim=0).values
    return skeys, order, iota - first


def build_tile_lists(xp, active, cfg: SimConfig, margin: int = 0,
                     origin: Tuple[int, int] = (0, 0)):
    """Bucket disks into per-tile lists by stamp-window intersection.

    Returns (lists (n_tiles, cap) i32, counts (n_tiles, 1, 1) i32,
    entry_slots (N, 4) i32 - the slot tile*cap + rank of each of the
    disk's <= 4 tile entries, -1 if unused - and overflow () i32).
    `margin` widens the test by that many cells per side (Verlet-cadence
    rebuilds); origin = (oy, ox): the lattice's cell (0, 0) in the
    positions' frame (a shard's canvas in global coordinates)."""
    th, tw = tile_dims(cfg)
    nty, ntx = cfg.ny // th, cfg.nx // tw
    n_tiles = nty * ntx
    cap = cfg.tile_cap
    if cap <= 0:
        raise ValueError("cfg.tile_cap must be set (Simulation derives it)")
    n = xp.shape[0]
    dev = xp.device
    window = cfg.window + 2 * margin
    if window > min(th, tw):
        raise ValueError(
            f"stamp window {cfg.window} + margins exceeds tile {th}x{tw}")
    half = window // 2
    bx = torch.floor(xp[:, 0] + 0.5).to(torch.int64) - half - origin[1]
    by = torch.floor(xp[:, 1] + 0.5).to(torch.int64) - half - origin[0]
    ty0 = torch.div(by, th, rounding_mode="floor")
    ty1 = torch.div(by + window - 1, th, rounding_mode="floor")
    tx0 = torch.div(bx, tw, rounding_mode="floor")
    tx1 = torch.div(bx + window - 1, tw, rounding_mode="floor")
    tys = torch.stack([ty0, ty0, ty1, ty1], 1)  # (N, 4)
    txs = torch.stack([tx0, tx1, tx0, tx1], 1)
    dup = torch.stack([torch.zeros_like(tx0, dtype=torch.bool), tx1 == tx0,
                       ty1 == ty0, (tx1 == tx0) | (ty1 == ty0)], 1)
    ok = ((tys >= 0) & (tys < nty) & (txs >= 0) & (txs < ntx) & ~dup
          & active[:, None])
    tid = torch.where(ok, tys * ntx + txs, torch.full_like(tys, -1)).reshape(-1)
    disk_of = torch.arange(n, device=dev).repeat_interleave(4)

    stid, order, rank = _segment_ranks(tid)
    valid = (stid >= 0) & (rank < cap)
    drop = n_tiles * cap
    slot = torch.where(valid, stid * cap + rank, torch.full_like(stid, drop))
    lists = torch.full((drop + 1,), -1, dtype=torch.int32, device=dev)
    lists[slot] = disk_of[order].to(torch.int32)
    lists = lists[:drop].reshape(n_tiles, cap)
    overflow = torch.sum((stid >= 0) & (rank >= cap)).to(torch.int32)
    counts = torch.sum(lists >= 0, dim=1, dtype=torch.int32).reshape(
        n_tiles, 1, 1)
    entry_slots = torch.full((4 * n,), -1, dtype=torch.int32, device=dev)
    entry_slots[order] = torch.where(valid, slot,
                                     torch.full_like(slot, -1)).to(torch.int32)
    return lists, counts, entry_slots.reshape(n, 4), overflow


def gather_tile_data(lists, xp, vp, omega, r, active) -> torch.Tensor:
    """Per-tile disk records (n_tiles, 1, cap*8) in the disks' dtype,
    [x, y, vx, vy, omega, r, active, 0], gathered at the CURRENT
    positions (the lists may be older); empty slots are all zero."""
    n_tiles, cap = lists.shape
    dt = xp.dtype
    packed = torch.stack(
        [xp[:, 0], xp[:, 1], vp[:, 0], vp[:, 1], omega.to(dt), r.to(dt),
         active.to(dt), torch.zeros_like(r, dtype=dt)], dim=1)
    j = lists.clamp(min=0).to(torch.int64)
    data = torch.where((lists >= 0)[..., None], packed[j],
                       torch.zeros((), dtype=dt, device=xp.device))
    return data.reshape(n_tiles, 1, cap * 8)


def bin_disks_to_tiles(xp, vp, omega, r, active, cfg: SimConfig):
    """Fresh lists + data in one call: (tile_data, counts, entry_slots,
    overflow)."""
    lists, counts, entry_slots, overflow = build_tile_lists(xp, active, cfg)
    tile_data = gather_tile_data(lists, xp, vp, omega, r, active)
    return tile_data, counts, entry_slots, overflow


def remap_entry_slots(entry_slots, cap: int, ntx_src: int, oy_t: int,
                      ox_t: int, nty_dst: int, ntx_dst: int):
    """Renumber binning entry slots from a source tile grid (ntx_src
    tiles per row) into the (nty_dst, ntx_dst) sub-grid at tile offset
    (oy_t, ox_t): the JAX pallas_stamp.remap_entry_slots. A shard bins
    its disks once on its stamp canvas and its fused step reduces over
    the interior tiles only, so the inverse map is renumbered over them;
    entries in the canvas apron become -1 (a neighbouring shard reduces
    those cells)."""
    t = torch.div(entry_slots, cap, rounding_mode="floor")
    rank = entry_slots - t * cap
    iy = torch.div(t, ntx_src, rounding_mode="floor") - oy_t
    ix = t - torch.div(t, ntx_src, rounding_mode="floor") * ntx_src - ox_t
    ok = ((entry_slots >= 0) & (iy >= 0) & (iy < nty_dst) & (ix >= 0)
          & (ix < ntx_dst))
    return torch.where(ok, (iy * ntx_dst + ix) * cap + rank,
                       torch.full_like(entry_slots, -1))


def gather_partials(flat, entry_slots, dtype):
    """Sum each disk's <= 4 per-tile partials (rows of `flat`, (n_tiles
    * cap, 4) [fx, fy, tq, 0]) via the binning's inverse map: (F (N, 2),
    T (N,))."""
    pos = entry_slots
    got = torch.where((pos >= 0)[..., None],
                      flat[pos.clamp(min=0).to(torch.int64)],
                      torch.zeros((), dtype=flat.dtype, device=flat.device))
    tot = torch.sum(got, dim=1)
    return tot[:, :2].to(dtype), tot[:, 2].to(dtype)


def cov_method(cfg: SimConfig) -> int:
    """The kernels' CovMethod code of cfg.eps_method."""
    if cfg.eps_method not in COV_METHODS:
        raise ValueError(f"unknown eps_method {cfg.eps_method!r}")
    return COV_METHODS[cfg.eps_method]


def shift_radius(rr, r_shift: float):
    """The eps_r_shift calibration of the radii rr (csrc/coverage.cuh
    shift_radius): max(rr + r_shift, 0.05) where rr > 0; an empty slot
    (rr == 0) stays 0."""
    if not r_shift:
        return rr
    return torch.where(rr > 0, torch.clamp(rr + r_shift, min=0.05),
                       torch.zeros_like(rr))


@functools.lru_cache(maxsize=None)
def sample_consts(ns: int):
    """Float32 constants of the sample method's fast path for ns samples
    per axis: (full, half, lo, hi) - the sample loop's sum when every
    sample hits (ns^2 additions of 1/ns^2 in the loop's order: 1.0 for
    ns = 4, not for every ns), the largest |sample offset|, and the
    relative margins 1 -+ COV_MARGIN on r^2."""
    inv_s2 = np.float32(1.0 / (ns * ns))
    full = np.float32(0.0)
    for _ in range(ns * ns):
        full = np.float32(full + inv_s2)
    offs = ((np.arange(ns) + 0.5) / ns - 0.5).astype(np.float32)
    return (full, np.float32(np.abs(offs).max()),
            np.float32(1.0 - COV_MARGIN), np.float32(1.0 + COV_MARGIN))


def sample_class(relx, rely, rr, ns: int):
    """The fast path's classification of cells against a disk of
    (shifted) radius rr, as csrc/coverage.cuh cov_sample_fast computes it:
    -1 all-out (the nearest sample lies outside r with a margin), +1
    all-in (the farthest lies inside), 0 ring (the sample loop decides).
    All-out is tested first, so an empty slot (rr == 0) is all-out. For
    the tests: cov_field gives 0 on every all-out cell and
    sample_consts(ns)[0] on every all-in one."""
    _, half, lo, hi = (float(c) for c in sample_consts(ns))
    ax, ay = relx.abs(), rely.abs()
    r2 = rr * rr
    nx_ = torch.clamp(ax - half, min=0.0)
    ny_ = torch.clamp(ay - half, min=0.0)
    fx, fy = ax + half, ay + half
    out = (nx_ * nx_ + ny_ * ny_) >= r2 * hi
    inn = (fx * fx + fy * fy) <= r2 * lo
    return torch.where(out, -1, torch.where(inn, 1, 0)).to(torch.int8)


@functools.lru_cache(maxsize=64)
def cov_params(cfg: SimConfig) -> kernels.CovParams:
    """The kernels' CovParams of cfg: method, samples, eps_r_shift and the
    sample method's fast-path constants (sample_consts)."""
    full, half, lo, hi = sample_consts(cfg.eps_samples)
    return kernels.CovParams(
        method=cov_method(cfg), ns=cfg.eps_samples,
        r_shift=float(cfg.eps_r_shift), full=full, half=half, lo=lo, hi=hi)


def cov_field(relx, rely, rr, cfg: SimConfig):
    """Coverage of one disk per cell (broadcasting) under cfg.eps_method:
    the plain twin of csrc/coverage.cuh and of the JAX
    pallas_stamp._cov_field, operation by operation, so the kernels agree
    with it bitwise (sample: the same t-form; ramp: clip((r + 1/2) - d,
    0, 1); exact: imb.exact_coverage). Empty slots (rr == 0) give 0."""
    ns = cfg.eps_samples
    dt = relx.dtype
    zero = torch.zeros((), dtype=dt, device=relx.device)
    rr = shift_radius(rr, cfg.eps_r_shift)
    if cfg.eps_method == "ramp":
        d = sqrt_rn(rely * rely + relx * relx)
        return torch.where(rr > 0, torch.clamp(rr + 0.5 - d, 0.0, 1.0), zero)
    if cfg.eps_method == "exact":
        return exact_coverage(relx, rely, rr)
    inv_s2 = torch.tensor(np.float32(1.0 / (ns * ns)), dtype=dt)
    offs = ((np.arange(ns) + 0.5) / ns - 0.5).astype(np.float32)
    r2 = rr * rr
    ts = [r2 - (rely + float(sy)) * (rely + float(sy)) for sy in offs]
    dx2s = [(relx + float(sx)) * (relx + float(sx)) for sx in offs]
    inv_s2 = inv_s2.to(relx.device)
    cov = None
    for t in ts:
        for dx2 in dx2s:
            term = torch.where(dx2 <= t, inv_s2, zero)
            cov = term if cov is None else cov + term
    if ns % 2:
        cov = torch.where(rr > 0, cov, zero)
    return cov


def tile_windows(tile_data, counts, cfg: SimConfig, t0: int, t1: int,
                 origin: Tuple[int, int] = (0, 0)):
    """Per-(tile, slot) stamp windows of tiles [t0, t1), clipped to their
    tile - the shared geometry of the plain stamp and the plain reduce.

    origin = (oy, ox): the lattice's cell (0, 0) sits at (oy, ox) of the
    frame the disk records were gathered in (a shard's stamp canvas);
    the tiles are the lattice's, the coordinates the frame's.

    Returns (rec (T, cap, 8) disk records, relx (T, cap, 1, W), rely
    (T, cap, W, 1), cell (T, cap, W, W) int64 flat cell index of the
    lattice (clipped into it), inside (T, cap, W, W) bool: the slot holds
    a disk and the cell lies in the window and the tile)."""
    oy, ox = origin
    th, tw = tile_dims(cfg)
    ntx = cfg.nx // tw
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    W = cfg.window
    half = W // 2
    dev = tile_data.device
    dt = tile_data.dtype
    rec = tile_data.reshape(n_tiles, cap, 8)[t0:t1]
    tiles = torch.arange(t0, t1, device=dev)
    y0 = ((tiles // ntx) * th + oy)[:, None, None]
    x0 = ((tiles % ntx) * tw + ox)[:, None, None]
    slot_ok = (torch.arange(cap, device=dev)[None, :]
               < counts.reshape(n_tiles)[t0:t1, None])
    px, py = rec[..., 0], rec[..., 1]
    ar = torch.arange(W, device=dev)
    rows = (torch.floor(py + 0.5).to(torch.int64) - half)[..., None] + ar
    cols = (torch.floor(px + 0.5).to(torch.int64) - half)[..., None] + ar
    in_r = (rows >= y0) & (rows < y0 + th)  # (T, cap, W)
    in_c = (cols >= x0) & (cols < x0 + tw)
    inside = slot_ok[..., None, None] & in_r[..., :, None] & in_c[..., None, :]
    relx = (cols.to(dt) - px[..., None])[..., None, :]
    rely = (rows.to(dt) - py[..., None])[..., :, None]
    cell = ((rows - oy).clamp(0, cfg.ny - 1)[..., :, None] * cfg.nx
            + (cols - ox).clamp(0, cfg.nx - 1)[..., None, :])
    return rec, relx, rely, cell, inside


def stamp_fields_plain(tile_data, counts, cfg: SimConfig,
                       origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain version of K1: loops over chunks of tiles, evaluates each
    binned disk's window clipped to its tile, and scatter-adds into the
    (3, ny, nx) fields [eps_raw, us_x, us_y]. origin: see
    tile_windows."""
    n_tiles = tile_data.shape[0]
    dt = tile_data.dtype
    acc = torch.zeros((cfg.ny * cfg.nx, 3), dtype=dt, device=tile_data.device)
    for t0 in range(0, n_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, n_tiles)
        rec, relx, rely, cell, inside = tile_windows(tile_data, counts, cfg,
                                                     t0, t1, origin)
        vx, vy, om, rr = (rec[..., c, None, None] for c in (2, 3, 4, 5))
        cov = cov_field(relx, rely, rr, cfg)
        cov = torch.where(inside, cov, torch.zeros((), dtype=dt,
                                                   device=cov.device))
        usx = vx - om * rely
        usy = vy + om * relx
        vals = torch.stack([cov, cov * usx, cov * usy], dim=-1)
        acc.index_add_(0, cell.reshape(-1), vals.reshape(-1, 3))
    eps = acc[:, 0]
    inv = 1.0 / torch.clamp(eps, min=_EPS_MIN)
    return torch.stack([eps, acc[:, 1] * inv, acc[:, 2] * inv]).reshape(
        3, cfg.ny, cfg.nx)


def stamp_fields(tile_data, counts, cfg: SimConfig,
                 origin: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """K1: the (3, ny, nx) solid fields [eps_raw, us_x, us_y] stamped
    from the tile binning; origin = (oy, ox) is the lattice's cell (0, 0)
    in the frame of the disk records (a shard's canvas offset, the
    records global). CPU tensors take the plain version; CUDA tensors
    take the kernel csrc/stamp.cu (or raise)."""
    cp = cov_params(cfg)
    if tile_data.device.type == "cpu":
        return stamp_fields_plain(tile_data, counts, cfg, origin)
    th, tw = tile_dims(cfg)
    kernels.require_cuda_f32("stamp_fields", tile_data, counts)
    if counts.dtype != torch.int32 or tile_data.dtype != torch.float32:
        raise ValueError("stamp_fields: tile_data f32 and counts i32")
    out = torch.empty((3, cfg.ny, cfg.nx), dtype=torch.float32,
                      device=tile_data.device)
    cap = tile_data.shape[2] // 8
    code = kernels.library().lbm_stamp(
        tile_data.data_ptr(), counts.data_ptr(), out.data_ptr(), cfg.ny,
        cfg.nx, th, tw, cfg.nx // tw, cap, cfg.window, cp,
        float(np.float32(_EPS_MIN)), int(origin[0]), int(origin[1]),
        kernels.stream())
    kernels.check(code, "stamp kernel (K1)")
    stamp_fields.launches += 1
    return out


def _lane_order_sum(vals, inside):
    """Sums of vals (K, T, cap, W, W) over each slot's inside cells in the
    order of the reduce kernel (csrc/imb.cuh reduce_kernel), so the plain
    partials equal the kernel's bit for bit: the inside cells in
    row-major order are dealt to the warp's 32 lanes (cell c to lane
    c % 32, in c order), each lane sums from +0, then a shuffle-down tree
    adds lane l + o into lane l for o = 16, 8, 4, 2, 1. Returns (K, T,
    cap)."""
    K, T, cap, W, _ = vals.shape
    ins = inside.reshape(T, cap, W * W)
    n_it = -(-W * W // _LANES)
    dump = n_it * _LANES  # one spare slot takes every outside cell
    pos = torch.where(ins, torch.cumsum(ins, -1) - 1,
                      torch.full((), dump, device=ins.device))
    buf = torch.zeros((K, T, cap, dump + 1), dtype=vals.dtype,
                      device=vals.device)
    buf.scatter_(-1, pos.expand(K, T, cap, W * W),
                 vals.reshape(K, T, cap, W * W))
    buf = buf[..., :dump].reshape(K, T, cap, n_it, _LANES)
    acc = torch.zeros((K, T, cap, _LANES), dtype=vals.dtype,
                      device=vals.device)
    for i in range(n_it):
        acc = acc + buf[..., i, :]
    o = _LANES // 2
    while o:
        acc = acc[..., :o] + acc[..., o:2 * o]
        o //= 2
    return acc[..., 0]


def reduce_partials_plain(w, tile_data, counts, cfg: SimConfig,
                          origin: Tuple[int, int] = (0, 0)):
    """Per-(tile, slot) [fx, fy, tq, 0] partials of cov * w over each
    binned disk's window clipped to its tile: (n_tiles * cap, 4), each
    sum taken in the reduce kernel's order (_lane_order_sum). origin:
    see tile_windows."""
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    dt = w.dtype
    wflat = w.reshape(2, -1)
    parts = []
    for t0 in range(0, n_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, n_tiles)
        rec, relx, rely, cell, inside = tile_windows(tile_data, counts, cfg,
                                                     t0, t1, origin)
        cov = cov_field(relx, rely, rec[..., 5, None, None], cfg)
        cov = torch.where(inside, cov, torch.zeros((), dtype=dt,
                                                   device=w.device))
        fx_c = cov * wflat[0][cell]
        fy_c = cov * wflat[1][cell]
        sums = _lane_order_sum(torch.stack(
            [fx_c, fy_c, relx * fy_c - rely * fx_c]), inside)
        parts.append(torch.cat([sums, torch.zeros_like(sums[:1])]).movedim(
            0, -1))
    return torch.cat(parts).reshape(n_tiles * cap, 4)


def hydro_partials_plain(eps_raw, phi_x, phi_y, tile_data, counts,
                         cfg: SimConfig, origin: Tuple[int, int] = (0, 0)):
    """Plain version of K9's partials: reduce_partials_plain over the
    momentum exchange w = phi / max(eps_raw, eps_min)."""
    share_den = 1.0 / torch.clamp(eps_raw, min=_EPS_MIN)
    return reduce_partials_plain(
        torch.stack([phi_x * share_den, phi_y * share_den]), tile_data,
        counts, cfg, origin)


def reduce_hydro_forces(xp, r, active, eps_raw, phi_x, phi_y, cfg: SimConfig,
                        tile_data, counts, entry_slots):
    """K9: per-disk hydrodynamic force (N, 2) and torque (N,) from the raw
    momentum exchange (phi_x, phi_y) of fused_lbm.fused_step_imb and the
    stamp binning (tile_data, counts, entry_slots): each binned disk
    reduces cov * phi / max(eps_raw, eps_min) over its window clipped to
    the tile into a per-(tile, slot) partial, and gather_partials sums a
    disk's <= 4 partials. r and active are the JAX entry's arguments; the
    radii come from tile_data.

    CPU tensors take the plain version; CUDA tensors take the kernel
    lbm_reduce_hydro of csrc/imb_split.cu (or raise)."""
    cp = cov_params(cfg)
    if eps_raw.device.type == "cpu":
        partials = hydro_partials_plain(eps_raw, phi_x, phi_y, tile_data,
                                        counts, cfg)
        return gather_partials(partials, entry_slots, xp.dtype)
    what = "standalone hydro reduce kernel (K9)"
    kernels.require_cuda_f32(what, eps_raw, phi_x, phi_y, tile_data, counts)
    if (eps_raw.dtype, phi_x.dtype, phi_y.dtype, tile_data.dtype,
            counts.dtype) != (torch.float32,) * 4 + (torch.int32,):
        raise ValueError(f"{what}: f32 fields and tile_data, i32 counts")
    for t in (eps_raw, phi_x, phi_y):
        if tuple(t.shape) != (cfg.ny, cfg.nx):
            raise ValueError(f"{what}: fields must be ({cfg.ny}, {cfg.nx}), "
                             f"got {tuple(t.shape)}")
    th, tw = tile_dims(cfg)
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    partials = torch.empty((n_tiles * cap, 4), dtype=torch.float32,
                           device=eps_raw.device)
    offsets = torch.empty(n_tiles + 1, dtype=torch.int32,
                          device=eps_raw.device)
    code = kernels.library().lbm_reduce_hydro(
        eps_raw.data_ptr(), phi_x.data_ptr(), phi_y.data_ptr(),
        tile_data.data_ptr(), counts.data_ptr(), partials.data_ptr(),
        offsets.data_ptr(), cfg.ny,
        cfg.nx, th, tw, cfg.nx // tw, n_tiles, cap, cfg.window, cp,
        float(np.float32(_EPS_MIN)), kernels.stream())
    kernels.check(code, what)
    reduce_hydro_forces.launches += 1
    return gather_partials(partials, entry_slots, xp.dtype)


stamp_fields.launches = 0
reduce_hydro_forces.launches = 0
