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

On a shard of the lattice mesh (`prehalo`, `edges`, `ny_glob`: the JAX
entry's multi-chip arguments) f is the shard's pre-haloed frame
(`fused_fluid.frame_shape`: 8 halo rows per side on f32, 16 on bf16) and
the solid stack its window (`fused_fluid.solid_shape`: 8 rows in both
storages), `out` the (9, ny, nx) interior; the walls and Zou/He closures
of the shard's global edges run at every inner step, as in K5's
pre-haloed mode. k <= 8 in both storages, the solid window's cone (the
JAX kernel's bound).
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops import fused_fluid, imb, lbm

# largest k per pass: the JAX kernel's 8-row solid halo; here the
# shared-memory rings of the row sweep (85 KB at k = 8)
MAX_K = 8
# strip of the row sweep (csrc/tblock.cuh): threads per level (64, 128
# or 256) and output rows per block, chosen by timing at 4096^2 (PERF.md
# section 6)
STRIP = (128, 64)


def check_static_cfg(cfg: SimConfig, prehalo=False, edges=None,
                     ny_glob=None) -> str:
    """The pre-halo mode of the arguments; raise for what the
    static-solid kernel does not take: edges without a pre-haloed frame,
    a frame without edges (or, where ny_glob is passed, without the
    global height)."""
    mode = fused_fluid.check_fluid_cfg(cfg, prehalo, edges)
    if mode:
        fused_fluid.check_edges(mode, edges, ny_glob)
    return mode


def fused_step_imb_static_multi_plain(f, solid, cfg: SimConfig, k: int, out):
    """Plain version of K7: from_storage, k x (the coupled collide
    fused_fluid.coupled_collide ->
    lbm.stream -> lbm.apply_bounce_back -> lbm.apply_open_boundaries),
    to_storage, into `out`."""
    g = lbm.from_storage(f, cfg)
    eps, usx, usy = solid[0], solid[1], solid[2]
    collide = fused_fluid.coupled_collide(cfg)
    for _ in range(k):
        fpost, _, _ = collide(g, eps, usx, usy, cfg)
        g = lbm.apply_open_boundaries(
            lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg)
    return out.copy_(lbm.to_storage(g, cfg))


def fused_step_imb_static_multi_prehalo_plain(f, solid, cfg: SimConfig,
                                              k: int, mode: str, edges,
                                              ny_glob: int, out):
    """Plain version of K7 on a pre-haloed frame (the JAX
    _imb_static_multi_kernel with its mesh-position flags):
    fused_fluid.frame_steps_plain with the coupled collide over the solid
    window on the f frame's rows (fused_fluid.solid_frame), then the
    interior into `out`."""
    sf = fused_fluid.solid_frame(solid, cfg)
    collide = fused_fluid.coupled_collide(cfg)
    g = fused_fluid.frame_steps_plain(
        lbm.from_storage(f, cfg), cfg, k, mode, edges, ny_glob,
        lambda g, t: collide(g, sf[0], sf[1], sf[2], cfg)[0])
    return out.copy_(lbm.to_storage(fused_fluid.frame_interior(g, cfg, mode),
                                    cfg))


def fused_step_imb_static_multi(f, solid, cfg: SimConfig, k: int, out,
                                prehalo=False, edges=None, ny_glob: int = 0):
    """K7: k coupled steps of f (9, ny, nx) in storage form over the
    constant solid stack (3, ny, nx) [eps_raw, us_x, us_y], written into
    `out` (the other f buffer, same shape). Returns out.

    prehalo ("y" or True, "yx"), edges and ny_glob: a shard's pre-haloed
    frame and solid window, its global edges (south, north, west, east,
    global row offset; a "y" shard holds both x edges) and the global
    lattice height (the module docstring); `out` is the (9, ny, nx)
    interior.

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_static.cu (lbm_imb_static_multi, or
    lbm_imb_static_multi_prehalo on a frame)."""
    mode = check_static_cfg(cfg, prehalo, edges, ny_glob)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"static-solid temporal block k={k} outside "
                         f"1..{MAX_K}")
    shape = fused_fluid.frame_shape(cfg, mode)
    sshape = fused_fluid.solid_shape(cfg, mode)
    if tuple(f.shape) != shape or tuple(solid.shape) != sshape:
        raise ValueError(f"fused_step_imb_static_multi: f {shape} and solid "
                         f"{sshape}, got {tuple(f.shape)} and "
                         f"{tuple(solid.shape)}")
    if (tuple(out.shape) != (9, cfg.ny, cfg.nx)
            or out.data_ptr() == f.data_ptr()):
        raise ValueError(f"fused_step_imb_static_multi: `out` must be a "
                         f"second (9, {cfg.ny}, {cfg.nx}) f buffer")
    if f.device.type == "cpu":
        if mode:
            return fused_step_imb_static_multi_prehalo_plain(
                f, solid, cfg, k, mode, edges, ny_glob, out)
        return fused_step_imb_static_multi_plain(f, solid, cfg, k, out)
    what = "static-solid temporal-block kernel (K7)"
    want = fused_fluid.check_storage(what, cfg, f, out)
    kernels.require_cuda_f32(what, solid)
    if solid.device != f.device or solid.dtype != torch.float32:
        raise ValueError(f"{what}: solid must be float32 on f's device")
    lib = kernels.library()
    tm = np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode))
    q = fused_fluid._pair_params(cfg)
    lam = int(cfg.nt_mode == "lambda")
    bf16 = int(want == torch.bfloat16)
    kernels.setting("lbm_imb_static_strip", *STRIP)
    if mode:
        pitch, hx = fused_fluid._frame_args(f, cfg, mode)
        p, u_in = fused_fluid.edge_params(cfg, edges, ny_glob, f.device)
        with torch.cuda.device(f.device):
            code = lib.lbm_imb_static_multi_prehalo(
                f.data_ptr(), solid.data_ptr(), out.data_ptr(), u_in, cfg.ny,
                cfg.nx, pitch, hx, k, bf16, lam, p, q, tm, kernels.stream())
    else:
        u_in = (fused_fluid._inlet_profile(cfg, f.device).data_ptr()
                if cfg.bc_west == "inlet" else None)
        code = lib.lbm_imb_static_multi(
            f.data_ptr(), solid.data_ptr(), out.data_ptr(), u_in, cfg.ny,
            cfg.nx, k, bf16, lam, fused_fluid._params(cfg), q, tm,
            kernels.stream())
    kernels.check(code, what)
    fused_step_imb_static_multi.launches += 1
    return out


fused_step_imb_static_multi.launches = 0
