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
for CUDA tensors. Under TRT the kernels collide in the pair form of the
JAX kernels' `_collide_window` and so do the plain versions
(`fused_fluid.coupled_collide`: `collide_imb_pairs`); under BGK both sum
in index order (`imb.collide_imb`). All write the new populations into
the caller's second f buffer `out`, never into `f`.

K2, K6 and K8 also take a shard of the lattice mesh (`prehalo` and, for
K2 and K6, `origin`: the JAX entries' multi-chip arguments): f is the
shard's pre-haloed frame (`fused_fluid.frame_shape`: 8 halo rows per
side on f32, 16 on bf16) and the solid stack its window (3, ny + 16, nx
[+ 256]) (`fused_fluid.solid_shape`, 8 rows in both storages, as the
JAX solid window keeps the f32 granule); cfg is the shard's local
config. The one-step kernels (K2, K8) skip the y walls
("y") or all walls ("yx") and the Zou/He closures, which the caller
fixes on the shards at a global edge; K6 runs the walls and closures of
the shard's global edges itself at every inner step, gated by `edges`
= (south, north, west, east, global row offset), with the inlet profile
of `ny_glob` rows. The binning is that of the interior tiles of the
shard's stamp canvas: the interior's cell (0, 0) is the cell `origin` of
the disk records' frame. The partials keep K2's slot numbering over the
interior tiles. K2 and K6 take f32 or shifted-bf16 frames, K8 f32 (as
the JAX kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch import kernels
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops import fused_fluid, imb, lbm
from lbmdem_tpu_torch.ops.fused_fluid import HX, HY, frame_hy
from lbmdem_tpu_torch.ops.stamp import (cov_params, hydro_partials_plain,
                                        tile_dims)

# K6's largest temporal block: cfg.coupling_k's range (the JAX kernel's
# 8-row solid halo; here the shared-memory rings, 85 KB at k = 8)
MAX_K = 8
# strip of K6's row sweep (csrc/tblock.cuh): threads per level (64, 128
# or 256: the strip's columns plus 2k halo columns; narrowed at launch
# to at most 512 threads in all) and output rows per block, chosen by
# timing at 4096^2 (PERF.md section 6)
MULTI_STRIP = (128, 128)
# block size of the one-step push kernel of K2 and K8 (32 x 4 cells),
# chosen by timing 128, 256 and 512 at 4096^2 (PERF.md section 6)
STEP_THREADS = 128


def fused_step_imb_reduce_plain(f, solid, tile_data, counts, cfg: SimConfig,
                                out):
    """Plain version of K2: from_storage, the coupled collide
    (fused_fluid.coupled_collide: imb.collide_imb, under TRT the pair
    form collide_imb_pairs) -> lbm.stream ->
    lbm.apply_bounce_back -> lbm.apply_open_boundaries, to_storage into
    `out`, plus the plain per-(tile, slot) reduce. Returns (out,
    partials)."""
    out, partials = fused_step_imb_reduce_multi_plain(f, solid, tile_data,
                                                      counts, cfg, 1, out)
    return out, partials[0]


def fused_step_imb_reduce_multi_plain(f, solid, tile_data, counts,
                                      cfg: SimConfig, k: int, out):
    """Plain version of K6: from_storage, k x (the coupled collide ->
    lbm.stream -> lbm.apply_bounce_back -> lbm.apply_open_boundaries) over
    the one solid stack with the plain reduce after every collide,
    to_storage. Returns (out, partials (k, n_tiles * cap, 4))."""
    eps, usx, usy = solid[0], solid[1], solid[2]
    collide = fused_fluid.coupled_collide(cfg)
    g = lbm.from_storage(f, cfg)
    parts = []
    for _ in range(k):
        fpost, phix, phiy = collide(g, eps, usx, usy, cfg)
        g = lbm.apply_open_boundaries(
            lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg)
        parts.append(hydro_partials_plain(eps, phix, phiy, tile_data, counts,
                                          cfg))
    out.copy_(lbm.to_storage(g, cfg))
    return out, torch.stack(parts)


def fused_step_imb_prehalo_plain(f, eps, usx, usy, cfg: SimConfig,
                                 mode: str, out, edge_post=None):
    """Plain version of K8 on a pre-haloed frame (f a frame, the solid
    fields the solid window's planes; the K2 plain version's step, in
    either storage): the coupled collide of the interior and its ring of one
    cell, pull streaming, the x walls in "y" mode, into `out` (9, ny,
    nx), the edges' post-collision populations into `edge_post`. Returns
    (out, phi_x, phi_y) of the interior."""
    h, w, hy = cfg.ny, cfg.nx, frame_hy(cfg)
    rows = slice(hy - 1, hy + h + 1)
    srows = slice(HY - 1, HY + h + 1)
    cols = slice(HX - 1, HX + w + 1) if mode == "yx" else slice(None)
    fpost, phix, phiy = fused_fluid.coupled_collide(cfg)(
        lbm.from_storage(f, cfg)[:, rows, cols], eps[srows, cols],
        usx[srows, cols], usy[srows, cols], cfg)
    fnew = fused_fluid.stream_frame(fpost, mode, h, w)
    if mode == "y":
        fused_fluid.x_walls_frame(fnew, fpost, cfg, h)
    fused_fluid.edge_post_plain(fpost, mode, h, w, edge_post, cfg)
    out.copy_(lbm.to_storage(fnew, cfg))
    c = slice(1, 1 + w) if mode == "yx" else slice(None)
    return out, phix[1:1 + h, c], phiy[1:1 + h, c]


def fused_step_imb_reduce_prehalo_plain(f, solid, tile_data, counts,
                                        cfg: SimConfig, mode: str, origin,
                                        out, edge_post=None):
    """Plain version of K2 on a pre-haloed frame: K8's
    (fused_step_imb_prehalo_plain), then the plain reduce of the
    interior's momentum exchange over the interior tiles, at `origin`.
    Returns (out, partials)."""
    out, phix, phiy = fused_step_imb_prehalo_plain(
        f, solid[0], solid[1], solid[2], cfg, mode, out, edge_post)
    eps = fused_fluid.frame_interior(solid, cfg, mode, HY)[0]
    partials = hydro_partials_plain(eps, phix, phiy, tile_data, counts, cfg,
                                    origin)
    return out, partials


def fused_step_imb_reduce_multi_prehalo_plain(f, solid, tile_data, counts,
                                              cfg: SimConfig, k: int,
                                              mode: str, origin, edges,
                                              ny_glob: int, out):
    """Plain version of K6 on a pre-haloed frame (the JAX
    _imb_reduce_multi_kernel with its mesh-position flags):
    fused_fluid.frame_steps_plain with the coupled collide over the solid
    window, the plain reduce of the interior's momentum exchange over the
    interior tiles at `origin` after every collide, then the interior
    into `out` (the solid window on the f frame's rows: solid_frame).
    Returns (out, partials (k, n_tiles * cap, 4))."""
    eps_i = fused_fluid.frame_interior(solid, cfg, mode, HY)[0]
    sf = fused_fluid.solid_frame(solid, cfg)
    coupled = fused_fluid.coupled_collide(cfg)
    parts = []

    def collide(g, t):
        fpost, phix, phiy = coupled(g, sf[0], sf[1], sf[2], cfg)
        parts.append(hydro_partials_plain(
            eps_i, fused_fluid.frame_interior(phix[None], cfg, mode)[0],
            fused_fluid.frame_interior(phiy[None], cfg, mode)[0], tile_data,
            counts, cfg, origin))
        return fpost

    g = fused_fluid.frame_steps_plain(lbm.from_storage(f, cfg), cfg, k, mode,
                                      edges, ny_glob, collide)
    out.copy_(lbm.to_storage(fused_fluid.frame_interior(g, cfg, mode), cfg))
    return out, torch.stack(parts)


def _check_args(f, out, what: str) -> None:
    if out.shape != f.shape or out.data_ptr() == f.data_ptr():
        raise ValueError(f"{what}: `out` must be a second f-shaped buffer")


def _prehalo_buffers(f, solid, tile_data, counts, cfg: SimConfig,
                     mode: str, origin, out, what: str, nk: int):
    """Check a pre-haloed K2/K6 launch's operands and allocate its phi
    scratch, partials (nk, n_tiles * cap, 4) and tile offsets. Returns
    (partials, phi scratch, offsets, dims, tm) for the C entries."""
    fused_fluid.check_storage(what, cfg, f, out)
    kernels.require_cuda_f32(what, solid, tile_data, counts)
    if (solid.device != f.device or solid.dtype != torch.float32
            or counts.dtype != torch.int32):
        raise ValueError(f"{what}: f32 solid window on f's device, i32 "
                         f"counts")
    th, tw = tile_dims(cfg)
    n_tiles = tile_data.shape[0]
    cap = tile_data.shape[2] // 8
    w = torch.empty((nk, 2, cfg.ny, cfg.nx), dtype=torch.float32,
                    device=f.device)
    partials = torch.empty((nk, n_tiles * cap, 4), dtype=torch.float32,
                           device=f.device)
    offsets = torch.empty(n_tiles + 1, dtype=torch.int32, device=f.device)
    pitch, hx = fused_fluid._frame_args(f, cfg, mode)
    dims = (cfg.ny, cfg.nx, pitch, hx, int(origin[0]), int(origin[1]), th,
            tw, cfg.nx // tw, n_tiles, cap, cfg.window, cov_params(cfg))
    tm = (np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)),
          np.float32(imb._EPS_MIN))
    return partials, w, offsets, dims, tm


def _launch_k2_prehalo(f, solid, tile_data, counts, cfg: SimConfig,
                       mode: str, origin, out, edge_post):
    """Launch K2 on a pre-haloed frame, handing out edge_post; returns
    the partials (1, n_tiles * cap, 4)."""
    what = "fused IMB step kernel (K2)"
    partials, w, offsets, dims, tm = _prehalo_buffers(
        f, solid, tile_data, counts, cfg, mode, origin, out, what, 1)
    lam = int(cfg.nt_mode == "lambda")
    with torch.cuda.device(f.device):
        erow, ecol = fused_fluid.edge_ptrs(edge_post, cfg, f.device)
        code = kernels.library().lbm_imb_step_prehalo(
            f.data_ptr(), solid.data_ptr(), tile_data.data_ptr(),
            counts.data_ptr(), out.data_ptr(), w.data_ptr(), erow, ecol,
            partials.data_ptr(), offsets.data_ptr(), *dims,
            int(f.dtype == torch.bfloat16), lam,
            fused_fluid._params(cfg, 12 if mode == "y" else 0, 0),
            fused_fluid._pair_params(cfg), *tm, STEP_THREADS,
            kernels.stream())
    kernels.check(code, what)
    return partials


def _launch_k6_prehalo(f, solid, tile_data, counts, cfg: SimConfig,
                       mode: str, origin, out, k: int, edges,
                       ny_glob: int):
    """Launch K6 on a pre-haloed frame, k steps with the shard's edges
    in the kernel; returns the partials (k, n_tiles * cap, 4)."""
    what = "coupled temporal-block kernel (K6)"
    partials, w, offsets, dims, tm = _prehalo_buffers(
        f, solid, tile_data, counts, cfg, mode, origin, out, what, k)
    lam = int(cfg.nt_mode == "lambda")
    with torch.cuda.device(f.device):
        p, u_in = fused_fluid.edge_params(cfg, edges, ny_glob, f.device)
        kernels.setting("lbm_imb_multi_strip", *MULTI_STRIP)
        code = kernels.library().lbm_imb_multi_prehalo(
            f.data_ptr(), solid.data_ptr(), u_in, tile_data.data_ptr(),
            counts.data_ptr(), out.data_ptr(), w.data_ptr(),
            partials.data_ptr(), offsets.data_ptr(), *dims, k,
            int(f.dtype == torch.bfloat16), lam, p,
            fused_fluid._pair_params(cfg), *tm, kernels.stream())
    kernels.check(code, what)
    return partials


def _open_edges(cfg: SimConfig, device):
    """(u_in, edge) pointers of the one-step kernel: under Zou/He the
    inlet profile and a (9, ny, 2) f32 scratch that carries the boundary
    columns' post-stream populations to their closures; else None."""
    if cfg.bc_west != "inlet":
        return None, None
    edge = torch.empty((9, cfg.ny, 2), dtype=torch.float32, device=device)
    return fused_fluid._inlet_profile(cfg, device).data_ptr(), edge


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
    offsets = torch.empty(n_tiles + 1, dtype=torch.int32, device=f.device)
    lib = kernels.library()
    ptrs = (f.data_ptr(), solid.data_ptr())
    bins = (tile_data.data_ptr(), counts.data_ptr(), out.data_ptr(),
            w.data_ptr())
    dims = (cfg.ny, cfg.nx, th, tw, cfg.nx // tw, n_tiles, cap, cfg.window,
            cov_params(cfg))
    tail = (int(want == torch.bfloat16), int(cfg.nt_mode == "lambda"),
            fused_fluid._params(cfg), fused_fluid._pair_params(cfg),
            np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)),
            np.float32(imb._EPS_MIN))
    if k is None:
        u_in, edge = _open_edges(cfg, f.device)
        code = lib.lbm_imb_step(
            *ptrs, u_in, *bins, None if edge is None else edge.data_ptr(),
            partials.data_ptr(), offsets.data_ptr(), *dims, *tail,
            STEP_THREADS, kernels.stream())
    else:
        u_in = (fused_fluid._inlet_profile(cfg, f.device).data_ptr()
                if cfg.bc_west == "inlet" else None)
        kernels.setting("lbm_imb_multi_strip", *MULTI_STRIP)
        code = lib.lbm_imb_multi(*ptrs, u_in, *bins, partials.data_ptr(),
                                 offsets.data_ptr(), *dims, k, *tail,
                                 kernels.stream())
    kernels.check(code, what)
    return partials


def fused_step_imb_reduce(f, solid, tile_data, counts, cfg: SimConfig, out,
                          prehalo=False, origin=(0, 0), edge_post=None):
    """K2: one coupled step of f (9, ny, nx) in storage form (f32, or
    shifted bf16 under f_storage="bfloat16") over the f32 solid stack
    (3, ny, nx) [eps_raw, us_x, us_y], written into `out` (the other f
    buffer, same shape), with the hydro partials (n_tiles * cap, 4) of
    the stamp binning (tile_data, counts). Returns (out, partials).

    prehalo ("y" or True, "yx") and origin: a shard's pre-haloed frame
    and solid window, its interior binning in canvas coordinates (the
    module docstring); `out` is the (9, ny, nx) interior, and edge_post
    = (rows (9, 2, nx), cols (9, ny, 2)) f32 buffers, when given, receive
    the post-collision populations of the interior's first and last rows
    and columns (the sources of the caller's wall fixups).

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_reduce.cu (two launches: the collide-push step, then the
    reduce; under Zou/He a third closes the open columns; on a frame
    lbm_imb_step_prehalo, two launches)."""
    mode = fused_fluid.check_fluid_cfg(cfg, prehalo)
    if mode:
        _check_prehalo_shapes(f, solid, cfg, mode, out,
                              "fused_step_imb_reduce")
        if f.device.type == "cpu":
            return fused_step_imb_reduce_prehalo_plain(
                f, solid, tile_data, counts, cfg, mode, origin, out,
                edge_post)
        partials = _launch_k2_prehalo(f, solid, tile_data, counts, cfg,
                                      mode, origin, out, edge_post)
        fused_step_imb_reduce.launches += 1
        return out, partials[0]
    if tuple(origin) != (0, 0) or edge_post is not None:
        raise ValueError("origin and edge_post are a shard's: they need "
                         "prehalo='y' or 'yx'")
    _check_args(f, out, "fused_step_imb_reduce")
    if f.device.type == "cpu":
        return fused_step_imb_reduce_plain(f, solid, tile_data, counts, cfg,
                                           out)
    partials = _launch(f, solid, tile_data, counts, cfg, None, out,
                       "fused IMB step kernel (K2)")
    fused_step_imb_reduce.launches += 1
    return out, partials[0]


def _check_prehalo_shapes(f, solid, cfg: SimConfig, mode: str, out,
                          what: str) -> None:
    shape = fused_fluid.frame_shape(cfg, mode)
    sshape = fused_fluid.solid_shape(cfg, mode)
    if tuple(f.shape) != shape or tuple(solid.shape) != sshape:
        raise ValueError(f"{what}: a pre-haloed f {shape} and solid window "
                         f"{sshape}, got {tuple(f.shape)} and "
                         f"{tuple(solid.shape)}")
    if (tuple(out.shape) != (9, cfg.ny, cfg.nx)
            or out.data_ptr() == f.data_ptr()):
        raise ValueError(f"{what}: `out` must be a second (9, {cfg.ny}, "
                         f"{cfg.nx}) f buffer")


def fused_step_imb_reduce_multi(f, solid, tile_data, counts, cfg: SimConfig,
                                k: int, out, prehalo=False, origin=(0, 0),
                                edges=None, ny_glob: int = 0):
    """K6: k coupled steps of f over ONE solid stack and binning (the
    window-start ones of a coupling_k window), written into `out`, with
    the hydro partials of every inner step: (out, partials (k, n_tiles *
    cap, 4)). partials[t] keeps K2's slot numbering tile * cap + rank,
    so stamp.gather_partials(partials[t], ...) gives inner step t's
    forces.

    prehalo ("y" or True, "yx"), origin, edges and ny_glob: a shard's
    pre-haloed frame and solid window, its interior binning (the module
    docstring), its global edges (south, north, west, east, global row
    offset; a "y" shard holds both x edges) where the walls and Zou/He
    closures run at every inner step, and the global lattice height;
    `out` is the (9, ny, nx) interior.

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/imb_multi.cu (two launches: the row sweep of k collide-stream-BB
    steps, then the reduce of every inner step; on a frame
    lbm_imb_multi_prehalo)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"coupled temporal block k={k} outside 1..{MAX_K}")
    mode = fused_fluid.check_fluid_cfg(cfg, prehalo, edges)
    if mode:
        what = "fused_step_imb_reduce_multi"
        fused_fluid.check_edges(mode, edges, ny_glob)
        _check_prehalo_shapes(f, solid, cfg, mode, out, what)
        if f.device.type == "cpu":
            return fused_step_imb_reduce_multi_prehalo_plain(
                f, solid, tile_data, counts, cfg, k, mode, origin, edges,
                ny_glob, out)
        partials = _launch_k6_prehalo(f, solid, tile_data, counts, cfg,
                                      mode, origin, out, k, edges, ny_glob)
        fused_step_imb_reduce_multi.launches += 1
        return out, partials
    if tuple(origin) != (0, 0):
        raise ValueError("origin is a shard's: it needs prehalo='y' or 'yx'")
    _check_args(f, out, "fused_step_imb_reduce_multi")
    if f.device.type == "cpu":
        return fused_step_imb_reduce_multi_plain(f, solid, tile_data, counts,
                                                 cfg, k, out)
    partials = _launch(f, solid, tile_data, counts, cfg, k, out,
                       "coupled temporal-block kernel (K6)")
    fused_step_imb_reduce_multi.launches += 1
    return out, partials


def fused_step_imb_plain(f, eps, usx, usy, cfg: SimConfig, out):
    """Plain version of K8: the coupled collide -> lbm.stream ->
    lbm.apply_bounce_back -> lbm.apply_open_boundaries into `out`, with
    phi from the collide. Returns (out, phi_x, phi_y)."""
    fpost, phix, phiy = fused_fluid.coupled_collide(cfg)(f, eps, usx, usy,
                                                         cfg)
    out.copy_(lbm.apply_open_boundaries(
        lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg))
    return out, phix, phiy


def _launch_split_prehalo(f, eps, usx, usy, cfg: SimConfig, mode: str, out,
                          edge_post, phi, what: str) -> None:
    """Launch K8 on a pre-haloed frame into `out` and `phi`."""
    pitch, hx = fused_fluid._frame_args(f, cfg, mode)
    erow, ecol = fused_fluid.edge_ptrs(edge_post, cfg, f.device)
    with torch.cuda.device(f.device):
        code = kernels.library().lbm_imb_split_step_prehalo(
            f.data_ptr(), eps.data_ptr(), usx.data_ptr(), usy.data_ptr(),
            out.data_ptr(), phi.data_ptr(), erow, ecol, cfg.ny, cfg.nx,
            pitch, hx, int(cfg.nt_mode == "lambda"),
            fused_fluid._params(cfg, 12 if mode == "y" else 0, 0),
            fused_fluid._pair_params(cfg),
            np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)), STEP_THREADS,
            kernels.stream())
    kernels.check(code, what)


def fused_step_imb(f, eps, usx, usy, cfg: SimConfig, out, prehalo=False,
                   edge_post=None):
    """K8: one coupled step of f (9, ny, nx) float32 over the solid fields
    eps_raw, us_x, us_y (ny, nx), written into `out` (the other f buffer,
    same shape; the JAX entry's out_buf). Returns (out, phi_x, phi_y), the
    raw momentum exchange (ny, nx) for stamp.reduce_hydro_forces.

    prehalo ("y" or True, "yx"): f and the solid fields are a shard's
    pre-haloed frames (the module docstring), `out` the (9, ny, nx)
    interior and phi the interior's; the y walls ("y") or all walls
    ("yx") and the Zou/He closures are left to the caller, which may ask
    for the post-collision populations of the interior's first and last
    rows and columns in edge_post = (rows (9, 2, nx), cols (9, ny, 2))
    f32 buffers, as K2's pre-haloed step hands them out.

    float32 only, as the JAX kernel (bf16 storage runs through the fused
    reduce step). CPU tensors take the plain version; CUDA tensors take
    the kernel lbm_imb_split_step of csrc/imb_split.cu (on a frame
    lbm_imb_split_step_prehalo), or raise."""
    mode = fused_fluid.prehalo_mode(prehalo)
    if f.dtype != torch.float32:
        raise ValueError(f"fused_step_imb is float32-only (got {f.dtype}); "
                         f"bf16 storage runs through fused_step_imb_reduce")
    if edge_post is not None and not mode:
        raise ValueError("edge_post is for a pre-haloed frame")
    plane = (cfg.ny, cfg.nx)
    fshape = fused_fluid.frame_shape(cfg, mode)
    if (tuple(f.shape) != fshape
            or any(tuple(t.shape) != fshape[1:] for t in (eps, usx, usy))):
        raise ValueError(f"fused_step_imb: f {fshape} and eps/usx/usy "
                         f"{fshape[1:]}")
    if tuple(out.shape) != (9,) + plane or out.data_ptr() == f.data_ptr():
        raise ValueError(f"fused_step_imb: `out` must be a second (9, "
                         f"{cfg.ny}, {cfg.nx}) f buffer")
    if f.device.type == "cpu":
        if mode:
            return fused_step_imb_prehalo_plain(f, eps, usx, usy, cfg, mode,
                                                out, edge_post)
        return fused_step_imb_plain(f, eps, usx, usy, cfg, out)
    what = "split coupled step kernel (K8)"
    kernels.require_cuda_f32(what, f, eps, usx, usy, out)
    if any(t.dtype != torch.float32 for t in (eps, usx, usy, out)):
        raise ValueError(f"{what}: float32 fields")
    phi = torch.empty((2,) + plane, dtype=torch.float32, device=f.device)
    if mode:
        _launch_split_prehalo(f, eps, usx, usy, cfg, mode, out, edge_post,
                              phi, what)
        fused_step_imb.launches += 1
        return out, phi[0], phi[1]
    u_in, edge = _open_edges(cfg, f.device)
    code = kernels.library().lbm_imb_split_step(
        f.data_ptr(), eps.data_ptr(), usx.data_ptr(), usy.data_ptr(), u_in,
        out.data_ptr(), phi.data_ptr(),
        None if edge is None else edge.data_ptr(), cfg.ny, cfg.nx,
        int(cfg.nt_mode == "lambda"), fused_fluid._params(cfg),
        fused_fluid._pair_params(cfg),
        np.float32(imb.nt_tm(cfg.tau, cfg.nt_mode)), STEP_THREADS,
        kernels.stream())
    kernels.check(code, what)
    fused_step_imb.launches += 1
    return out, phi[0], phi[1]


fused_step_imb_reduce.launches = 0
fused_step_imb_reduce_multi.launches = 0
fused_step_imb.launches = 0
