"""The coupled LBM step with the hydro-force reduce fused in (K2), its
temporal block over a frozen solid stack (K6), and the split step that
emits phi for a separate reduce (K8).

Counterpart of `fused_step_imb_reduce` in the JAX package's
`lbmdem_tpu/ops/pallas_lbm.py`: one step of the NT-blended collide (BGK
or TRT, optional Smagorinsky LES, nt_mode "nt" or "lambda", Guo
forcing), pull streaming, half-way bounce-back (static or moving walls)
and the Zou/He inlet/outlet, on f32 or shifted-bf16 storage
(`cfg.f_storage`), plus the per-(stamp tile, slot) partials
[fx, fy, tq, 0] of cov * phi / max(eps_raw, eps_min) that
`stamp.gather_partials` turns into per-disk forces.

`fused_step_imb_reduce_multi` (K6, the coupling_k window) runs k such
steps over the window-start solid stack and binning, with the reduce
after every inner collide: the counterpart of the JAX
`fused_step_imb_reduce_multi`. The k inner steps stay in float32; bf16
storage rounds once, at the end of the window, as the JAX kernel does.

`fused_step_imb` (K8) is the counterpart of the JAX `fused_step_imb`:
one f32 coupled step with every lattice option (BGK/TRT, LES, nt_mode,
Guo forcing, static and moving walls, Zou/He, periodic axes) that returns
the raw momentum exchange (phi_x, phi_y) instead of reducing it; the
standalone reduce is `stamp.reduce_hydro_forces` (K9). Only the
stage-ablation tool (`tools/ablate.py`) runs the pair.

Each wrapper takes its plain version for CPU tensors and its CUDA
kernel (`csrc/imb_reduce.cu`, `csrc/imb_multi.cu`, `csrc/imb_split.cu`)
for CUDA tensors. All write the new populations into the caller's second
f buffer `out`, never into `f`.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops import fused_fluid, imb, lbm, not_ported
from lbmdem_tpu_torch.ops.stamp import (cov_method, hydro_partials_plain,
                                        tile_dims)

# K6's largest temporal block: cfg.coupling_k's range (the JAX kernel's
# 8-row solid halo; here the shared-memory windows, 129 KB at k = 8)
MAX_K = 8


def fused_step_imb_reduce_plain(f, solid, tile_data, counts, cfg: SimConfig,
                                out):
    """Plain version of K2: from_storage, imb.collide_imb -> lbm.stream ->
    lbm.apply_bounce_back -> lbm.apply_open_boundaries, to_storage into
    `out`, plus the plain per-(tile, slot) reduce. Returns (out,
    partials)."""
    out, partials = fused_step_imb_reduce_multi_plain(f, solid, tile_data,
                                                      counts, cfg, 1, out)
    return out, partials[0]


def fused_step_imb_reduce_multi_plain(f, solid, tile_data, counts,
                                      cfg: SimConfig, k: int, out):
    """Plain version of K6: from_storage, k x (imb.collide_imb ->
    lbm.stream -> lbm.apply_bounce_back -> lbm.apply_open_boundaries) over
    the one solid stack with the plain reduce after every collide,
    to_storage. Returns (out, partials (k, n_tiles * cap, 4))."""
    eps, usx, usy = solid[0], solid[1], solid[2]
    g = lbm.from_storage(f, cfg)
    parts = []
    for _ in range(k):
        fpost, phix, phiy = imb.collide_imb(g, eps, usx, usy, cfg)
        g = lbm.apply_open_boundaries(
            lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg)
        parts.append(hydro_partials_plain(eps, phix, phiy, tile_data, counts,
                                          cfg))
    out.copy_(lbm.to_storage(g, cfg))
    return out, torch.stack(parts)


def _check_args(f, out, what: str) -> None:
    if out.shape != f.shape or out.data_ptr() == f.data_ptr():
        raise ValueError(f"{what}: `out` must be a second f-shaped buffer")


def _launch(f, solid, tile_data, counts, cfg: SimConfig, k: int, out,
            what: str):
    """Launch K2 (k None) or K6 (k steps); returns the partials
    (k or 1, n_tiles * cap, 4)."""
    want = fused_fluid.check_storage(what, cfg, f, out)
    kernels.require_cuda_f32(what, solid, tile_data, counts)
    if (solid.device != f.device or solid.dtype != torch.float32
            or counts.dtype != torch.int32):
        raise ValueError(f"{what}: f32 solid stack on f's device, i32 counts")
    th, tw = tile_dims(cfg)
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    nk = k or 1
    w = torch.empty((nk, 2, cfg.ny, cfg.nx), dtype=torch.float32,
                    device=f.device)
    partials = torch.empty((nk, n_tiles * cap, 4), dtype=torch.float32,
                           device=f.device)
    u_in = (fused_fluid._inlet_profile(cfg, f.device).data_ptr()
            if cfg.bc_west == "inlet" else None)
    head = (f.data_ptr(), solid.data_ptr(), u_in, tile_data.data_ptr(),
            counts.data_ptr(), out.data_ptr(), w.data_ptr(),
            partials.data_ptr(), cfg.ny, cfg.nx, th, tw, cfg.nx // tw,
            n_tiles, cap, cfg.window, cfg.eps_samples,
            float(cfg.eps_r_shift), cov_method(cfg))
    tail = (int(want == torch.bfloat16), int(cfg.nt_mode == "lambda"),
            fused_fluid._params(cfg),
            np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)),
            np.float32(imb._EPS_MIN), kernels.stream())
    lib = kernels.library()
    if k is None:
        code = lib.lbm_imb_step(*head, *tail)
    else:
        code = lib.lbm_imb_multi(*head, k, *tail)
    kernels.check(code, what)
    return partials


def fused_step_imb_reduce(f, solid, tile_data, counts, cfg: SimConfig, out):
    """K2: one coupled step of f (9, ny, nx) in storage form (f32, or
    shifted bf16 under f_storage="bfloat16") over the f32 solid stack
    (3, ny, nx) [eps_raw, us_x, us_y], written into `out` (the other f
    buffer, same shape), with the hydro partials (n_tiles * cap, 4) of
    the stamp binning (tile_data, counts). Returns (out, partials).

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_reduce.cu (two launches: collide-stream-BB, then reduce)."""
    _check_args(f, out, "fused_step_imb_reduce")
    if f.device.type == "cpu":
        return fused_step_imb_reduce_plain(f, solid, tile_data, counts, cfg,
                                           out)
    partials = _launch(f, solid, tile_data, counts, cfg, None, out,
                       "fused IMB step kernel (K2)")
    fused_step_imb_reduce.launches += 1
    return out, partials[0]


def fused_step_imb_reduce_multi(f, solid, tile_data, counts, cfg: SimConfig,
                                k: int, out):
    """K6: k coupled steps of f over ONE solid stack and binning (the
    window-start ones of a coupling_k window), written into `out`, with
    the hydro partials of every inner step: (out, partials (k, n_tiles *
    cap, 4)). partials[t] keeps K2's slot numbering tile * cap + rank,
    so stamp.gather_partials(partials[t], ...) gives inner step t's
    forces.

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_multi.cu (two launches: k collide-stream-BB steps in
    shared memory, then the reduce of every inner step)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"coupled temporal block k={k} outside 1..{MAX_K}")
    _check_args(f, out, "fused_step_imb_reduce_multi")
    if f.device.type == "cpu":
        return fused_step_imb_reduce_multi_plain(f, solid, tile_data, counts,
                                                 cfg, k, out)
    partials = _launch(f, solid, tile_data, counts, cfg, k, out,
                       "coupled temporal-block kernel (K6)")
    fused_step_imb_reduce_multi.launches += 1
    return out, partials


def fused_step_imb_plain(f, eps, usx, usy, cfg: SimConfig, out):
    """Plain version of K8: imb.collide_imb -> lbm.stream ->
    lbm.apply_bounce_back -> lbm.apply_open_boundaries into `out`, with
    phi from the collide. Returns (out, phi_x, phi_y)."""
    fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy, cfg)
    out.copy_(lbm.apply_open_boundaries(
        lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg))
    return out, phix, phiy


def fused_step_imb(f, eps, usx, usy, cfg: SimConfig, out, prehalo=False):
    """K8: one coupled step of f (9, ny, nx) float32 over the solid fields
    eps_raw, us_x, us_y (ny, nx), written into `out` (the other f buffer,
    same shape; the JAX entry's out_buf). Returns (out, phi_x, phi_y), the
    raw momentum exchange (ny, nx) for stamp.reduce_hydro_forces.

    float32 only, as the JAX kernel (bf16 storage runs through the fused
    reduce step). CPU tensors take the plain version; CUDA tensors take
    the kernel lbm_imb_split_step of csrc/imb_split.cu (or raise)."""
    if prehalo:
        raise not_ported("the prehalo argument of the split coupled step "
                         "(multi-chip halo exchange)", 12)
    if f.dtype != torch.float32:
        raise ValueError(f"fused_step_imb is float32-only (got {f.dtype}); "
                         f"bf16 storage runs through fused_step_imb_reduce")
    plane = (cfg.ny, cfg.nx)
    if (tuple(f.shape) != (9,) + plane
            or any(tuple(t.shape) != plane for t in (eps, usx, usy))):
        raise ValueError(f"fused_step_imb: f (9, {cfg.ny}, {cfg.nx}) and "
                         f"eps/usx/usy {plane}")
    _check_args(f, out, "fused_step_imb")
    if f.device.type == "cpu":
        return fused_step_imb_plain(f, eps, usx, usy, cfg, out)
    what = "split coupled step kernel (K8)"
    kernels.require_cuda_f32(what, f, eps, usx, usy, out)
    if any(t.dtype != torch.float32 for t in (eps, usx, usy, out)):
        raise ValueError(f"{what}: float32 fields")
    phi = torch.empty((2,) + plane, dtype=torch.float32, device=f.device)
    u_in = (fused_fluid._inlet_profile(cfg, f.device).data_ptr()
            if cfg.bc_west == "inlet" else None)
    code = kernels.library().lbm_imb_split_step(
        f.data_ptr(), eps.data_ptr(), usx.data_ptr(), usy.data_ptr(), u_in,
        out.data_ptr(), phi.data_ptr(), cfg.ny, cfg.nx,
        int(cfg.nt_mode == "lambda"), fused_fluid._params(cfg),
        np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)), kernels.stream())
    kernels.check(code, what)
    fused_step_imb.launches += 1
    return out, phi[0], phi[1]


fused_step_imb_reduce.launches = 0
fused_step_imb_reduce_multi.launches = 0
fused_step_imb.launches = 0
