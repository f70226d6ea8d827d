"""k coupled LBM steps in one pass over a constant solid stack (K7): the
static-solid hoist of scenes whose disks are all fixed and at rest.

Counterpart of `fused_step_imb_static_multi` in the JAX package's
`lbmdem_tpu/ops/pallas_lbm.py`: k x (NT-blended collide, pull streaming,
half-way bounce-back with static or moving walls, Zou/He inlet/outlet)
over the (3, ny, nx) stack [eps_raw, us_x, us_y] stamped once for the
run, with BGK or TRT, Smagorinsky LES, Guo forcing, nt_mode "nt" or
"lambda", on f32 or shifted-bf16 storage. No hydro reduce follows.

CPU tensors take the plain version; CUDA tensors take the kernel of
`csrc/imb_static.cu` or raise. Both write into the caller's second f
buffer `out`, never into `f`, and keep the k inner steps in float32,
rounding to the storage type once per call (as K5 does).
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops import fused_fluid, imb, lbm, not_ported

# largest k per pass: the JAX kernel's 8-row solid halo; here the
# shared-memory rings of the row sweep (85 KB at k = 8)
MAX_K = 8
# strip of the row sweep (csrc/tblock.cuh): threads per level (64, 128
# or 256) and output rows per block, chosen by timing at 4096^2 (PERF.md
# section 6)
STRIP = (128, 64)


def check_static_cfg(cfg: SimConfig, prehalo=False, edges=None) -> None:
    """Raise for options of the JAX static-solid kernel that are not
    ported."""
    if prehalo or edges is not None:
        raise not_ported("the prehalo/edges arguments of the static-solid "
                         "kernel (multi-chip halo exchange)", 12)


def fused_step_imb_static_multi_plain(f, solid, cfg: SimConfig, k: int, out):
    """Plain version of K7: from_storage, k x (imb.collide_imb ->
    lbm.stream -> lbm.apply_bounce_back -> lbm.apply_open_boundaries),
    to_storage, into `out`."""
    g = lbm.from_storage(f, cfg)
    eps, usx, usy = solid[0], solid[1], solid[2]
    for _ in range(k):
        fpost, _, _ = imb.collide_imb(g, eps, usx, usy, cfg)
        g = lbm.apply_open_boundaries(
            lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg)
    return out.copy_(lbm.to_storage(g, cfg))


def fused_step_imb_static_multi(f, solid, cfg: SimConfig, k: int, out,
                                prehalo=False, edges=None):
    """K7: k coupled steps of f (9, ny, nx) in storage form over the
    constant solid stack (3, ny, nx) [eps_raw, us_x, us_y], written into
    `out` (the other f buffer, same shape). Returns out.

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_static.cu (lbm_imb_static_multi)."""
    check_static_cfg(cfg, prehalo, edges)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"static-solid temporal block k={k} outside "
                         f"1..{MAX_K}")
    if f.shape != (9, cfg.ny, cfg.nx) or solid.shape != (3, cfg.ny, cfg.nx):
        raise ValueError(f"fused_step_imb_static_multi: f (9, {cfg.ny}, "
                         f"{cfg.nx}) and solid (3, {cfg.ny}, {cfg.nx}), got "
                         f"{tuple(f.shape)} and {tuple(solid.shape)}")
    if out.shape != f.shape or out.data_ptr() == f.data_ptr():
        raise ValueError("fused_step_imb_static_multi: `out` must be a "
                         "second f-shaped buffer")
    if f.device.type == "cpu":
        return fused_step_imb_static_multi_plain(f, solid, cfg, k, out)
    what = "static-solid temporal-block kernel (K7)"
    want = fused_fluid.check_storage(what, cfg, f, out)
    kernels.require_cuda_f32(what, solid)
    if solid.device != f.device or solid.dtype != torch.float32:
        raise ValueError(f"{what}: solid must be float32 on f's device")
    u_in = (fused_fluid._inlet_profile(cfg, f.device).data_ptr()
            if cfg.bc_west == "inlet" else None)
    lib = kernels.library()
    kernels.setting("lbm_imb_static_strip", *STRIP)
    code = lib.lbm_imb_static_multi(
        f.data_ptr(), solid.data_ptr(), out.data_ptr(), u_in, cfg.ny, cfg.nx,
        k, int(want == torch.bfloat16), int(cfg.nt_mode == "lambda"),
        fused_fluid._params(cfg), np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)),
        kernels.stream())
    kernels.check(code, what)
    fused_step_imb_static_multi.launches += 1
    return out


fused_step_imb_static_multi.launches = 0
