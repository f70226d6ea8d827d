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

Ranks come from `torch.sort(stable=True)`, so within a tile the slots
follow disk order. The JAX sorts are not stable: the two packages may
order one tile's slots differently, and agree on each tile's set.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops import not_ported
from lbmdem_tpu_torch.ops.imb import _EPS_MIN

# stamp tile rows / columns: the JAX chains (coupled lattice tile rows,
# then sub-8 rows for tiny grids; 128-column granule), kept so that the
# two packages bin entry by entry alike
_TILE_ROWS = (256, 128, 64, 32, 16, 8, 4, 2, 1)
_TILE_COLS = (128, 64, 32, 16, 8, 4, 2, 1)
# plain-version tile chunk (bounds the (tiles, cap, W, W) temporaries)
_PLAIN_TILES = 64


def tile_dims(cfg: SimConfig) -> Tuple[int, int]:
    """(th, tw) of the stamp tiles; the tile must hold a stamp window."""
    th = next(t for t in _TILE_ROWS if cfg.ny % t == 0)
    tw = next(t for t in _TILE_COLS if cfg.nx % t == 0)
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


def build_tile_lists(xp, active, cfg: SimConfig, margin: int = 0):
    """Bucket disks into per-tile lists by stamp-window intersection.

    Returns (lists (n_tiles, cap) i32, counts (n_tiles, 1, 1) i32,
    entry_slots (N, 4) i32 - the slot tile*cap + rank of each of the
    disk's <= 4 tile entries, -1 if unused - and overflow () i32).
    `margin` widens the test by that many cells per side (Verlet-cadence
    rebuilds)."""
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
    bx = torch.floor(xp[:, 0] + 0.5).to(torch.int64) - half
    by = torch.floor(xp[:, 1] + 0.5).to(torch.int64) - half
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


def cov_field(relx, rely, rr, cfg: SimConfig):
    """Sample coverage of one disk per cell (broadcasting): the plain
    twin of csrc/coverage.cuh and of the JAX pallas_stamp._cov_field, in
    the same t-form so sample membership agrees bitwise."""
    ns = cfg.eps_samples
    dt = relx.dtype
    if cfg.eps_r_shift:
        rr = torch.where(rr > 0, torch.clamp(rr + cfg.eps_r_shift, min=0.05),
                         torch.zeros_like(rr))
    inv_s2 = torch.tensor(np.float32(1.0 / (ns * ns)), dtype=dt)
    offs = ((np.arange(ns) + 0.5) / ns - 0.5).astype(np.float32)
    r2 = rr * rr
    ts = [r2 - (rely + float(sy)) * (rely + float(sy)) for sy in offs]
    dx2s = [(relx + float(sx)) * (relx + float(sx)) for sx in offs]
    zero = torch.zeros((), dtype=dt, device=relx.device)
    inv_s2 = inv_s2.to(relx.device)
    cov = None
    for t in ts:
        for dx2 in dx2s:
            term = torch.where(dx2 <= t, inv_s2, zero)
            cov = term if cov is None else cov + term
    if ns % 2:
        cov = torch.where(rr > 0, cov, zero)
    return cov


def tile_windows(tile_data, counts, cfg: SimConfig, t0: int, t1: int):
    """Per-(tile, slot) stamp windows of tiles [t0, t1), clipped to their
    tile - the shared geometry of the plain stamp and the plain reduce.

    Returns (rec (T, cap, 8) disk records, relx (T, cap, 1, W), rely
    (T, cap, W, 1), cell (T, cap, W, W) int64 flat cell index (clipped
    into the domain), inside (T, cap, W, W) bool: the slot holds a disk
    and the cell lies in the window and the tile)."""
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
    y0 = ((tiles // ntx) * th)[:, None, None]
    x0 = ((tiles % ntx) * tw)[:, None, None]
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
    cell = (rows.clamp(0, cfg.ny - 1)[..., :, None] * cfg.nx
            + cols.clamp(0, cfg.nx - 1)[..., None, :])
    return rec, relx, rely, cell, inside


def stamp_fields_plain(tile_data, counts, cfg: SimConfig) -> torch.Tensor:
    """Plain version of K1: loops over chunks of tiles, evaluates each
    binned disk's window clipped to its tile, and scatter-adds into the
    (3, ny, nx) fields [eps_raw, us_x, us_y]."""
    n_tiles = tile_data.shape[0]
    dt = tile_data.dtype
    acc = torch.zeros((cfg.ny * cfg.nx, 3), dtype=dt, device=tile_data.device)
    for t0 in range(0, n_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, n_tiles)
        rec, relx, rely, cell, inside = tile_windows(tile_data, counts, cfg,
                                                     t0, t1)
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


def check_stamp_cfg(cfg: SimConfig) -> None:
    """Raise for coverage models the port does not stamp yet."""
    if cfg.eps_method != "sample":
        raise not_ported(f"eps_method={cfg.eps_method!r} coverage", 9)


def stamp_fields(tile_data, counts, cfg: SimConfig) -> torch.Tensor:
    """K1: the (3, ny, nx) solid fields [eps_raw, us_x, us_y] stamped
    from the tile binning. CPU tensors take the plain version; CUDA
    tensors take the kernel csrc/stamp.cu (or raise)."""
    check_stamp_cfg(cfg)
    if tile_data.device.type == "cpu":
        return stamp_fields_plain(tile_data, counts, cfg)
    th, tw = tile_dims(cfg)
    kernels.require_cuda_f32("stamp_fields", tile_data, counts)
    if counts.dtype != torch.int32 or tile_data.dtype != torch.float32:
        raise ValueError("stamp_fields: tile_data f32 and counts i32")
    out = torch.empty((3, cfg.ny, cfg.nx), dtype=torch.float32,
                      device=tile_data.device)
    cap = tile_data.shape[2] // 8
    code = kernels.library().lbm_stamp(
        tile_data.data_ptr(), counts.data_ptr(), out.data_ptr(), cfg.ny,
        cfg.nx, th, tw, cfg.nx // tw, cap, cfg.window, cfg.eps_samples,
        float(cfg.eps_r_shift), float(np.float32(_EPS_MIN)), kernels.stream())
    kernels.check(code, "stamp kernel (K1)")
    stamp_fields.launches += 1
    return out


stamp_fields.launches = 0
