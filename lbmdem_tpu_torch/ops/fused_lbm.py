"""The coupled LBM step with the hydro-force reduce fused in (K2).

Counterpart of `fused_step_imb_reduce` in the JAX package's
`lbmdem_tpu/ops/pallas_lbm.py`: one step of NT-blended BGK collide
(+ Guo forcing), pull streaming and half-way bounce-back (static or
moving walls), plus the per-(stamp tile, slot) partials [fx, fy, tq, 0]
of cov * phi / max(eps_raw, eps_min) that `stamp.gather_partials`
turns into per-disk forces.

`fused_step_imb_reduce` takes the plain version for CPU tensors and the
CUDA kernel `csrc/imb_reduce.cu` for CUDA tensors. Both write the new
populations into the caller's second f buffer `out`, never into `f`.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import imb, lbm, not_ported
from lbmdem_tpu_torch.ops.stamp import (_PLAIN_TILES, check_stamp_cfg,
                                        cov_field, tile_dims, tile_windows)


def check_step_cfg(cfg: SimConfig) -> None:
    """Raise for lattice options the fused step does not take yet."""
    check_stamp_cfg(cfg)
    if cfg.trt_lambda > 0.0:
        raise not_ported("TRT collision (collision='trt')", 9)
    if cfg.smagorinsky > 0.0:
        raise not_ported("Smagorinsky LES", 9)
    if cfg.bc_west == "inlet":
        raise not_ported("Zou/He inlet/outlet boundaries", 9)
    if cfg.f_storage != "float32":
        raise not_ported("f_storage='bfloat16'", 9)
    if cfg.nt_mode != "nt":
        raise not_ported(f"nt_mode={cfg.nt_mode!r}", 9)


def reduce_partials_plain(w, tile_data, counts, cfg: SimConfig):
    """Per-(tile, slot) [fx, fy, tq, 0] partials of cov * w over each
    binned disk's window clipped to its tile: (n_tiles * cap, 4)."""
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    dt = w.dtype
    wflat = w.reshape(2, -1)
    parts = []
    for t0 in range(0, n_tiles, _PLAIN_TILES):
        t1 = min(t0 + _PLAIN_TILES, n_tiles)
        rec, relx, rely, cell, inside = tile_windows(tile_data, counts, cfg,
                                                     t0, t1)
        cov = cov_field(relx, rely, rec[..., 5, None, None], cfg)
        cov = torch.where(inside, cov, torch.zeros((), dtype=dt,
                                                   device=w.device))
        fx_c = cov * wflat[0][cell]
        fy_c = cov * wflat[1][cell]
        fx = torch.sum(fx_c, dim=(2, 3))
        fy = torch.sum(fy_c, dim=(2, 3))
        tq = torch.sum(relx * fy_c - rely * fx_c, dim=(2, 3))
        parts.append(torch.stack([fx, fy, tq, torch.zeros_like(fx)], dim=-1))
    return torch.cat(parts).reshape(n_tiles * cap, 4)


def fused_step_imb_reduce_plain(f, solid, tile_data, counts, cfg: SimConfig,
                                out):
    """Plain version of K2: imb.collide_imb -> lbm.stream ->
    lbm.apply_bounce_back into `out`, plus the plain per-(tile, slot)
    reduce. Returns (out, partials)."""
    eps, usx, usy = solid[0], solid[1], solid[2]
    fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy, cfg)
    out.copy_(lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg))
    share_den = 1.0 / torch.clamp(eps, min=imb._EPS_MIN)
    w = torch.stack([phix * share_den, phiy * share_den])
    return out, reduce_partials_plain(w, tile_data, counts, cfg)


def _params(cfg: SimConfig) -> kernels.LbmParams:
    f32 = np.float32
    walls = ((cfg.bc_south == WALL) | (cfg.bc_north == WALL) << 1
             | (cfg.bc_west == WALL) << 2 | (cfg.bc_east == WALL) << 3)
    return kernels.LbmParams(
        tau=f32(cfg.tau), tm=f32(cfg.tau - 0.5), half_gx=f32(0.5 * cfg.gx),
        half_gy=f32(0.5 * cfg.gy), gx=f32(cfg.gx), gy=f32(cfg.gy),
        guo_pref=f32(1.0 - 0.5 / cfg.tau), eps_min=f32(imb._EPS_MIN),
        forced=int(cfg.gx != 0.0 or cfg.gy != 0.0), walls=int(walls),
        uw_west=cfg.uw_west, uw_east=cfg.uw_east, uw_south=cfg.uw_south,
        uw_north=cfg.uw_north, rho0=cfg.rho0,
    )


def fused_step_imb_reduce(f, solid, tile_data, counts, cfg: SimConfig, out):
    """K2: one coupled step of f (9, ny, nx) over the solid stack
    (3, ny, nx) [eps_raw, us_x, us_y], written into `out` (the other f
    buffer, same shape), with the hydro partials (n_tiles * cap, 4) of
    the stamp binning (tile_data, counts). Returns (out, partials).

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_reduce.cu (two launches: collide-stream-BB, then reduce)."""
    check_step_cfg(cfg)
    if out.shape != f.shape or out.data_ptr() == f.data_ptr():
        raise ValueError("fused_step_imb_reduce: `out` must be a second "
                         "f-shaped buffer")
    if f.device.type == "cpu":
        return fused_step_imb_reduce_plain(f, solid, tile_data, counts, cfg,
                                           out)
    kernels.require_cuda_f32("fused_step_imb_reduce", f, solid, tile_data,
                             counts, out)
    if f.dtype != torch.float32 or counts.dtype != torch.int32:
        raise ValueError("fused_step_imb_reduce: f32 fields, i32 counts")
    th, tw = tile_dims(cfg)
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    w = torch.empty((2, cfg.ny, cfg.nx), dtype=torch.float32, device=f.device)
    partials = torch.empty((n_tiles * cap, 4), dtype=torch.float32,
                           device=f.device)
    code = kernels.library().lbm_imb_step(
        f.data_ptr(), solid.data_ptr(), tile_data.data_ptr(),
        counts.data_ptr(), out.data_ptr(), w.data_ptr(), partials.data_ptr(),
        cfg.ny, cfg.nx, th, tw, cfg.nx // tw, n_tiles, cap, cfg.window,
        cfg.eps_samples, float(cfg.eps_r_shift), _params(cfg),
        kernels.stream())
    kernels.check(code, "fused IMB step kernel (K2)")
    fused_step_imb_reduce.launches += 1
    return out, partials


fused_step_imb_reduce.launches = 0
