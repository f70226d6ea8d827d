"""The pure-fluid LBM step as one kernel (K4) and k steps per pass (K5).

Counterpart of `fused_step_fluid` and `fused_step_fluid_multi` in the
JAX package's `lbmdem_tpu/ops/pallas_lbm.py`: collide (BGK or TRT,
optional Smagorinsky LES, Guo forcing), pull streaming, half-way
bounce-back with moving walls and the Zou/He inlet/outlet, on f32 or
shifted-bf16 storage (`cfg.f_storage`).

CPU tensors take the plain versions; CUDA tensors take the kernels of
`csrc/fluid.cu` or raise. Both write into the caller's second f buffer
`out`, never into `f`. K5 keeps the k inner steps in float32 and rounds
to the storage type once per call. The plain versions compute what the
kernels compute, operation for operation: `collide_pairs` (the pair-form
collide of the JAX kernels' `_collide_window`), then the stream, walls
and Zou/He of `lbm.step_pure_fluid`, on bf16 storage in the shifted form
(`compute_form`), rounded once per call. `lbm.collide` and
`lbm.step_pure_fluid` stay the plain path's (the JAX oracle's twins).

Pre-haloed mode (`prehalo`, the lattice mesh of `parallel/`): f is a
shard's frame with `frame_hy(cfg)` exchanged halo rows per side (HY = 8
on f32 storage, HY_BF16 = 16 on shifted bf16: the JAX row granule of
each) and, in "yx" mode, HX = 128 halo columns per side; cfg is the
shard's local config and the output is the (9, ny, nx) interior. K4
skips the y walls ("y") or every wall ("yx") and the Zou/He closures:
the caller fixes the shards that hold a global edge afterwards, from the
post-collision populations K4 hands out (on bf16 the shifted ones, in
f32). K5 runs every wall and the Zou/He closures itself at each inner
step, gated by `edges` = (south, north, west, east, global row offset of
the shard), with the inlet profile taken at the global row (`ny_glob`
rows in all); on a frame it takes k up to the frame's halo rows (MAX_K:
8 on f32, 16 on bf16), deeper than one row sweep through f32 scratch
frames. Both keep the JAX shapes, so the parity tests feed both
packages one array.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lbmdem_tpu_torch import kernels, lattice
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import imb, lbm
from lbmdem_tpu_torch.ops.imb import sqrt_rn

# largest k per pass, the TPU kernel's (on a frame its halo rows): f32 8,
# bf16 16
MAX_K = {"float32": 8, "bfloat16": 16}

# steps per row sweep (csrc/fluid.cu kSweepK): a larger k runs as
# ceil(k / SWEEP_K) sweeps through f32 scratch planes (on a frame scratch
# frames), one pass bit for bit
SWEEP_K = 4

# K5's strip, threads per level and output rows per block, from
# chip_smoke.py's sweep at 4096^2
STRIP = (128, 64)

# halo of a pre-haloed frame (the JAX shapes: its DMA row granules and
# lane granule): rows per side of an f32 frame and of the coupled
# kernels' solid window in both storages, of a bf16 frame, and columns
# per side in "yx" mode
HY = 8
HY_BF16 = 16
HX = 128


def frame_hy(cfg: SimConfig) -> int:
    """Halo rows per side of cfg's pre-haloed f frame: HY_BF16 on bf16
    storage, else HY (the JAX pallas_lbm._storage's hy)."""
    return HY_BF16 if cfg.f_storage == "bfloat16" else HY


def prehalo_mode(prehalo) -> str:
    """"" (no halo), "y" or "yx" from a JAX-style prehalo argument
    (False, True or "y", "yx")."""
    if prehalo is False or prehalo is None:
        return ""
    if prehalo is True or prehalo == "y":
        return "y"
    if prehalo == "yx":
        return "yx"
    raise ValueError(f"prehalo must be False, True, 'y' or 'yx', got "
                     f"{prehalo!r}")


def frame_shape(cfg: SimConfig, mode: str):
    """The (9, rows, cols) input frame of a shard of cfg's (local) size
    in pre-halo mode `mode` ("" is the lattice itself)."""
    return (9, cfg.ny + (2 * frame_hy(cfg) if mode else 0),
            cfg.nx + (2 * HX if mode == "yx" else 0))


def solid_shape(cfg: SimConfig, mode: str):
    """The (3, rows, cols) solid window of a shard in pre-halo mode
    `mode`: HY rows per side in both storages."""
    return (3, cfg.ny + (2 * HY if mode else 0),
            cfg.nx + (2 * HX if mode == "yx" else 0))


def check_fluid_cfg(cfg: SimConfig, prehalo=False, edges=None) -> str:
    """The pre-halo mode of the arguments; raise for edges without a
    pre-haloed frame."""
    mode = prehalo_mode(prehalo)
    if not mode and edges is not None:
        raise ValueError("edges are the mesh position of a pre-haloed "
                         "shard (prehalo='y' or 'yx')")
    return mode


def storage_dtype(cfg: SimConfig) -> torch.dtype:
    """The dtype of f in storage: bfloat16, or the compute dtype."""
    if cfg.f_storage == "bfloat16":
        return torch.bfloat16
    return lbm.torch_dtype(cfg)


def check_storage(what: str, cfg: SimConfig, f, out) -> torch.dtype:
    """The storage dtype of cfg, after checking that f and out are
    contiguous CUDA tensors of it on one device (float64 is for the
    plain path)."""
    if f.dtype == torch.float64:
        raise NotImplementedError(
            f"{what}: the kernels take float32 or bfloat16 storage; float64 "
            f"runs on the plain path (Simulation(..., use_kernels=False))")
    want = storage_dtype(cfg)
    for t in (f, out):
        if t.device != f.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{what}: f and out must be contiguous {want} "
                             f"tensors on one CUDA device (f_storage="
                             f"{cfg.f_storage!r})")
    return want


# the direction pairs (i, opp(i)) with i < opp(i): (1, 3), (2, 4), (5, 7),
# (6, 8)
PAIRS = tuple((i, int(lattice.OPP[i])) for i in range(1, 9)
              if i < int(lattice.OPP[i]))


@functools.lru_cache(maxsize=64)
def pair_consts(cfg: SimConfig, dtype: torch.dtype = torch.float32) -> dict:
    """The scalars of collide_pairs that the JAX kernel's trace folds from
    Python floats, in the compute dtype (the kernels' PairParams take the
    float32 ones): a Python float expression is evaluated in double and
    rounded once; a product with a float32 weight is a float32 product
    (NumPy's scalar rule). The weights are the float32 table in float32
    and the double one in float64. Per pair representative k (PAIRS[k][0]):
    eg9 = 9 e.g, w3eg = w 3 e.g, and without LES gw = w force_pref (gw0
    for the rest population) and godd = w3eg opref, opref the odd Guo
    prefactor (TRT's force_pref_m, else force_pref); tm, the NT blend's
    tau - 1/2 (or 3/16 / (tau - 1/2)) without LES."""
    dt = np.float32 if dtype == torch.float32 else np.float64
    w = lattice.W.astype(dt)
    tau, trt = cfg.tau, cfg.trt_lambda
    inv_tau = 1.0 / tau
    inv_tau_m = 1.0 / (0.5 + trt / (tau - 0.5)) if trt > 0.0 else inv_tau
    force_pref = 1.0 - 0.5 * inv_tau
    opref = 1.0 - 0.5 * inv_tau_m
    egs = [int(lattice.E[i, 0]) * cfg.gx + int(lattice.E[i, 1]) * cfg.gy
           for i, _ in PAIRS]
    w3eg = [w[i] * dt(3.0 * eg) for (i, _), eg in zip(PAIRS, egs)]
    return dict(
        inv_tau=float(dt(inv_tau)), inv_tau_m=float(dt(inv_tau_m)),
        gw0=float(w[0] * dt(force_pref)),
        gw=[float(w[i] * dt(force_pref)) for i, _ in PAIRS],
        eg9=[float(dt(9.0 * eg)) for eg in egs],
        w3eg=[float(x) for x in w3eg],
        godd=[float(x * dt(opref)) for x in w3eg],
        half_gx=float(dt(0.5 * cfg.gx)), half_gy=float(dt(0.5 * cfg.gy)),
        gx=float(dt(cfg.gx)), gy=float(dt(cfg.gy)),
        tau=float(dt(tau)), tau_sq=float(dt(tau * tau)),
        trt=float(dt(trt)), tm=float(dt(imb.nt_tm(tau, cfg.nt_mode))),
        les_c=float(dt(18.0 * np.sqrt(2.0) * cfg.smagorinsky ** 2)),
        w=[float(x) for x in w])


def collide_pairs(g, cfg: SimConfig, shift: float = 0.0):
    """The pure-fluid collide of K4 and K5 (csrc/d2q9.cuh
    fluid_collide_t), operation for operation: the uncoupled branch of
    the JAX kernels' pallas_lbm._collide_window. Per direction pair the
    sum S = f_i + f_opp and the difference D = f_i - f_opp give rho and
    j; the equilibria split into even and odd parts E +- O; BGK relaxes
    f - (E +- O), TRT the even and odd parts (S/2 - E at 1/tau, D/2 - O
    at 1/tau-); Guo's source splits the same way. Smagorinsky's tau is
    per cell from all nine equilibria. shift != 0: g holds the shifted
    populations f - w shift (bf16 storage) and so does the result. g is
    (9, ...) in float32 or float64; returns the post-collision
    populations."""
    return _collide_window(g, cfg, shift)[0]


def collide_imb_pairs(f, eps_raw, us_x, us_y, cfg: SimConfig,
                      shift: float = 0.0):
    """The NT-blended collide in the pair form (csrc/imb.cuh
    collide_cell_pairs for TRT), operation for operation: the coupled
    branch of the JAX kernels' pallas_lbm._collide_window with eps
    given. collide_pairs' moments, equilibria and TRT parts, blended
    with the solid: B = eps tm / ((1 - eps) + tm) (tm = tau - 1/2, or
    3/16 / (tau - 1/2) under nt_mode="lambda", per cell with LES), the
    relaxation and Guo's source scaled by 1 - B, and per pair with W + Q
    = O_s + O - D and P = E_s - E (the equilibria at u_s) the source
    B (W + Q + P) and B (P - W - Q), phi -= e_i 2 B (W + Q). The plain
    K2, K6, K7 and K8 take it under TRT; under BGK they keep
    imb.collide_imb. Returns (f_post, phi_x, phi_y)."""
    return _collide_window(f, cfg, shift, (eps_raw, us_x, us_y))


def coupled_collide(cfg: SimConfig):
    """The collide of the coupled kernels' plain versions (K2, K6, K7,
    K8): collide_imb_pairs under TRT (the kernels' pair form), else
    imb.collide_imb (the kernels' index-order sums). Called as
    collide(f, eps_raw, us_x, us_y, cfg) -> (f_post, phi_x, phi_y)."""
    return collide_imb_pairs if cfg.trt_lambda > 0.0 else imb.collide_imb


def _eu(i: int, ux, uy):
    """e_i . u as +-adds (the components are -1, 0, +1)."""
    ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
    t = None
    if ex:
        t = ux if ex > 0 else -ux
    if ey:
        t = (uy if ey > 0 else -uy) if t is None else (
            t + uy if ey > 0 else t - uy)
    return t


def _collide_window(g, cfg: SimConfig, shift: float = 0.0, solid=None):
    """pallas_lbm._collide_window on (9, ...) planes: (post-collision
    populations, phi_x, phi_y), phi None without a solid (eps_raw, us_x,
    us_y)."""
    c = pair_consts(cfg, g.dtype)
    w = c["w"]
    les, trt = cfg.smagorinsky > 0.0, cfg.trt_lambda > 0.0
    forced = cfg.gx != 0.0 or cfg.gy != 0.0
    coupled = solid is not None
    f = g.unbind(0)
    S, D = {}, {}
    rho_g, jx, jy = f[0], None, None
    for i, o in PAIRS:
        S[i] = f[i] + f[o]
        rho_g = rho_g + S[i]
        D[i] = f[i] - f[o]
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        if ex:
            jx = (D[i] if ex > 0 else -D[i]) if jx is None else (
                jx + D[i] if ex > 0 else jx - D[i])
        if ey:
            jy = (D[i] if ey > 0 else -D[i]) if jy is None else (
                jy + D[i] if ey > 0 else jy - D[i])
    rho = rho_g + shift if shift else rho_g
    inv_rho = torch.reciprocal(rho)
    ux = (jx + c["half_gx"]) * inv_rho
    uy = (jy + c["half_gy"]) * inv_rho
    usq = ux * ux + uy * uy
    rho_b = rho_g if shift else rho
    rho3 = 3.0 * rho

    def eo_parts(i, ux_, uy_, m15_):
        t = _eu(i, ux_, uy_)
        return (w[i] * (rho_b + rho * (4.5 * (t * t) + m15_)),
                (w[i] * rho3) * t, t)

    m15 = -1.5 * usq
    feq0 = w[0] * (rho_b + rho * m15)
    E, O, eu = {}, {}, {}
    for i, _ in PAIRS:
        E[i], O[i], eu[i] = eo_parts(i, ux, uy, m15)
    tau = c["tau"]
    if les:  # ops/lbm.smagorinsky_tau on the pair-form equilibria
        feq = [feq0] * 9
        for i, o in PAIRS:
            feq[i], feq[o] = E[i] + O[i], E[i] - O[i]
        pxx, pyy, pxy = (torch.zeros_like(rho) for _ in range(3))
        for i in range(1, 9):
            ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
            ne = f[i] - feq[i]
            if ex:
                pxx = pxx + ne
            if ey:
                pyy = pyy + ne
            if ex and ey:
                pxy = pxy + ne if ex * ey > 0 else pxy - ne
        pnorm = sqrt_rn(pxx * pxx + pyy * pyy + 2.0 * pxy * pxy)
        tau = 0.5 * (tau + sqrt_rn(c["tau_sq"] + c["les_c"] * pnorm / rho))
    if coupled:
        eps_raw, usx, usy = solid
        eps = torch.clamp(eps_raw, 0.0, 1.0)
        tm = c["tm"]
        if les:  # imb.nt_weight on the per-cell tau; 3/16 / tm divides
            tm = tau - 0.5
            if cfg.nt_mode == "lambda":
                tm = tm.new_tensor(0.1875) / tm
        B = eps * tm / ((1.0 - eps) + tm)
        omb = 1.0 - B
        m15_s = -1.5 * (usx * usx + usy * usy)
        feq0_s = w[0] * (rho_b + rho * m15_s)
        phix = torch.zeros_like(rho)
        phiy = torch.zeros_like(rho)
    if les:
        inv_tau = torch.reciprocal(tau)
        force_pref = 1.0 - 0.5 * inv_tau
        if trt:
            inv_tau_m = torch.reciprocal(
                0.5 + rho.new_tensor(c["trt"]) / (tau - 0.5))
            opref = 1.0 - 0.5 * inv_tau_m
        else:
            opref = force_pref
    else:
        inv_tau, inv_tau_m = c["inv_tau"], c["inv_tau_m"]
    if forced:
        ug3 = 3.0 * (ux * c["gx"] + uy * c["gy"])
    out = [None] * 9
    relax = omb * inv_tau if coupled else inv_tau
    out[0] = f[0] - relax * (f[0] - feq0)
    if coupled:
        out[0] = out[0] + B * (feq0_s - feq0)
    if forced:
        gw0 = w[0] * force_pref if les else c["gw0"]
        src0 = gw0 * (-ug3)
        out[0] = out[0] + (omb * src0 if coupled else src0)
    for k, (i, o) in enumerate(PAIRS):
        if trt:
            ne_e = inv_tau * (0.5 * S[i] - E[i])
            ne_o = inv_tau_m * (0.5 * D[i] - O[i])
            rt_i, rt_o = ne_e + ne_o, ne_e - ne_o
        if coupled:
            Es, Os, _ = eo_parts(i, usx, usy, m15_s)
            P = Es - E[i]
            WQ = (Os + O[i]) - D[i]
            if trt:
                fi = f[i] - omb * rt_i + B * (WQ + P)
                fo = f[o] - omb * rt_o + B * (P - WQ)
            else:
                fi = f[i] - relax * (f[i] - (E[i] + O[i])) + B * (WQ + P)
                fo = f[o] - relax * (f[o] - (E[i] - O[i])) + B * (P - WQ)
            pair_phi = (2.0 * B) * WQ
            ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
            if ex:
                phix = phix - pair_phi if ex > 0 else phix + pair_phi
            if ey:
                phiy = phiy - pair_phi if ey > 0 else phiy + pair_phi
        elif trt:
            fi, fo = f[i] - rt_i, f[o] - rt_o
        else:
            fi = f[i] - inv_tau * (f[i] - (E[i] + O[i]))
            fo = f[o] - inv_tau * (f[o] - (E[i] - O[i]))
        if forced:
            gw = w[i] * force_pref if les else c["gw"][k]
            even = gw * (c["eg9"][k] * eu[i] - ug3)
            src_i = src_o = even
            if c["w3eg"][k] != 0.0:
                odd = c["w3eg"][k] * opref if les else c["godd"][k]
                src_i, src_o = even + odd, even - odd
            if coupled:
                fi, fo = fi + omb * src_i, fo + omb * src_o
            else:
                fi, fo = fi + src_i, fo + src_o
        out[i], out[o] = fi, fo
    if not coupled:
        return torch.stack(out), None, None
    return torch.stack(out), phix, phiy


def compute_form(f, cfg: SimConfig):
    """(populations, shift) in the form the kernels compute in: f32
    storage as it is; bf16 storage as its shifted populations in float32
    with shift rho0 (the kernels never unshift); float64 as it is."""
    if f.dtype == torch.bfloat16:
        return f.to(torch.float32), float(np.float32(cfg.rho0))
    return f, 0.0


def step_pairs(g, cfg: SimConfig, shift: float = 0.0):
    """One pure-fluid step of K4 and K5's arithmetic: collide_pairs, then
    the stream, bounce-back and Zou/He of lbm.step_pure_fluid (on shifted
    populations with the closures' shift)."""
    fpost = collide_pairs(g, cfg, shift)
    fnew = lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg)
    return lbm.apply_open_boundaries(fnew, cfg, shift)


def fused_step_fluid_plain(f, cfg: SimConfig, out):
    """Plain version of K4: step_pairs in the kernels' compute form
    (compute_form), rounded to storage once, into `out`."""
    g, shift = compute_form(f, cfg)
    return out.copy_(step_pairs(g, cfg, shift))


def fused_step_fluid_multi_plain(f, cfg: SimConfig, k: int, out):
    """Plain version of K5: k x step_pairs in the kernels' compute form
    (compute_form), rounded to storage once, into `out`."""
    g, shift = compute_form(f, cfg)
    for _ in range(k):
        g = step_pairs(g, cfg, shift)
    return out.copy_(g)


def stream_frame(fpost, mode: str, h: int, w: int):
    """Pull streaming of the (h, w) interior from the post-collision
    populations of the interior and its ring of one cell: fpost holds
    rows -1..h and, in "yx" mode, columns -1..w (in "y" mode all w
    columns, wrapped periodically as the shard spans the lattice)."""
    outs = []
    for i in range(9):
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        p = fpost[i, 1 - ey:1 - ey + h]
        if mode == "yx":
            outs.append(p[:, 1 - ex:1 - ex + w])
        else:
            outs.append(torch.roll(p, ex, dims=1) if ex else p)
    return torch.stack(outs)


def x_walls_frame(fnew, fpost, cfg: SimConfig, h: int):
    """The west and east bounce-back of a "y"-mode shard (the JAX
    _stream_and_bb's x-wall rule, the one a 1D mesh keeps in the
    kernel); fpost as in stream_frame. In place."""
    opp = lattice.OPP
    for side, idxs, col, uw in ((cfg.bc_west, lattice.IN_E, 0, cfg.uw_west),
                                (cfg.bc_east, lattice.IN_W, -1, cfg.uw_east)):
        if side != WALL:
            continue
        for i in (int(j) for j in idxs):
            fnew[i, :, col] = (fpost[int(opp[i]), 1:1 + h, col]
                               + lattice.wall_corr(i, 0.0, uw, cfg.rho0))
    return fnew


def edge_post_plain(fpost, mode: str, h: int, w: int, edge_post,
                    cfg: SimConfig, shifted: bool = False) -> None:
    """Fill `edge_post` = (rows (9, 2, w), cols (9, h, 2)) with the
    post-collision populations of the interior's first and last rows and
    columns, fpost as in stream_frame; on bf16 storage the shifted ones
    fpost - w rho0 in f32, unrounded, as the kernels hand them out (the
    bounce-back is shift-invariant: w_opp(i) = w_i), or fpost as it is
    where it is `shifted` already."""
    if edge_post is None:
        return
    rows, cols = edge_post
    c = slice(1, 1 + w) if mode == "yx" else slice(None)
    inner = fpost[:, 1:1 + h, c]
    shift = None if shifted else lbm.storage_shift(cfg)
    if shift is not None:
        inner = inner - shift.to(inner.device)
    rows[:, 0] = inner[:, 0]
    rows[:, 1] = inner[:, -1]
    cols[:, :, 0] = inner[:, :, 0]
    cols[:, :, 1] = inner[:, :, -1]


def fused_step_fluid_prehalo_plain(f, cfg: SimConfig, mode: str, out,
                                   edge_post=None):
    """Plain version of K4 on a pre-haloed frame: the collide of the
    interior and its ring (collide_pairs in the kernels' compute form),
    pull streaming, the x walls in "y" mode, into `out` (9, ny, nx), the
    edges' post-collision populations into `edge_post`. No y walls and no
    Zou/He: the sharded caller fixes the global edges."""
    h, w, hy = cfg.ny, cfg.nx, frame_hy(cfg)
    g, shift = compute_form(f, cfg)
    g = g[:, hy - 1:hy + h + 1]
    if mode == "yx":
        g = g[:, :, HX - 1:HX + w + 1]
    fpost = collide_pairs(g, cfg, shift)
    fnew = stream_frame(fpost, mode, h, w)
    if mode == "y":
        x_walls_frame(fnew, fpost, cfg, h)
    edge_post_plain(fpost, mode, h, w, edge_post, cfg, shifted=True)
    return out.copy_(fnew)


def fused_step_fluid_multi_prehalo_plain(f, cfg: SimConfig, k: int, mode: str,
                                         edges, ny_glob: int, out):
    """Plain version of K5 on a pre-haloed frame (the JAX
    _stream_and_bb_window with its mesh-position flags): frame_steps_plain
    with collide_pairs in the kernels' compute form, then the interior
    into `out`."""
    g, shift = compute_form(f, cfg)
    g = frame_steps_plain(g, cfg, k, mode, edges, ny_glob,
                          lambda g, t: collide_pairs(g, cfg, shift), shift)
    return out.copy_(frame_interior(g, cfg, mode))


def frame_interior(g, cfg: SimConfig, mode: str, hy=None):
    """The (planes, ny, nx) interior of a pre-haloed frame of hy halo
    rows (default: cfg's f frame's, frame_hy; the solid window's: HY)."""
    hy = frame_hy(cfg) if hy is None else hy
    hx = HX if mode == "yx" else 0
    return g[:, hy:hy + cfg.ny, hx:hx + cfg.nx]


def solid_frame(solid, cfg: SimConfig):
    """The solid window (3, ny + 2 HY, cols) on the f frame's rows: on
    bf16 padded with frame_hy - HY zero rows (pure fluid) per side, as
    the JAX kernels pad it (pallas_lbm.py:952-958); no step of a cone of
    k <= HY reaches those rows."""
    pad = frame_hy(cfg) - HY
    if not pad:
        return solid
    z = solid.new_zeros((solid.shape[0], pad, solid.shape[2]))
    return torch.cat([z, solid, z], dim=1)


def frame_steps_plain(g, cfg: SimConfig, k: int, mode: str, edges,
                      ny_glob: int, collide, shift: float = 0.0):
    """k steps of a whole pre-haloed frame g (9, ny + 2 hy, nx [+ 256]), the
    plain form of the pre-haloed temporal blocks (K5, K6, K7): each step
    collide(g, t) -> post-collision frame, streamed with periodic rolls
    (the garbage that wraps in at the frame's edge stays in the halo, one
    cell deeper per step), bounce-back at the shard's wall rows and
    columns across the frame where `edges` = (south, north, west, east[,
    global row offset]) says it holds that global edge, and the Zou/He
    closures on every frame row at the global row offset (the inlet
    profile of ny_glob rows), with `shift` on shifted populations.
    Returns the frame after k steps."""
    h, w, hy = cfg.ny, cfg.nx, frame_hy(cfg)
    hx = HX if mode == "yx" else 0
    s_on, n_on, w_on, e_on = (bool(e) for e in edges[:4])
    oy = int(edges[4]) if len(edges) > 4 else 0
    opp = lattice.OPP
    if ny_glob <= 0:
        raise ValueError("a pre-haloed frame needs ny_glob, the global "
                         "lattice height")
    u_in = lbm.inlet_profile_array(cfg.replace(ny=ny_glob))
    u_rows = torch.as_tensor(u_in[frame_profile_rows(cfg, oy, ny_glob)],
                             dtype=g.dtype, device=g.device)
    rho_o = cfg.rho_outlet or cfg.rho0
    for t in range(k):
        fpost = collide(g, t)
        g = lbm.stream(fpost)
        for on, side, idxs, sl, uwx, uwy in (
                (s_on, cfg.bc_south, lattice.IN_N, (hy, slice(None)),
                 cfg.uw_south, 0.0),
                (n_on, cfg.bc_north, lattice.IN_S, (hy + h - 1, slice(None)),
                 cfg.uw_north, 0.0),
                (w_on, cfg.bc_west, lattice.IN_E, (slice(None), hx), 0.0,
                 cfg.uw_west),
                (e_on, cfg.bc_east, lattice.IN_W, (slice(None), hx + w - 1),
                 0.0, cfg.uw_east)):
            if not (on and side == WALL):
                continue
            for i in (int(j) for j in idxs):
                g[(i,) + sl] = (fpost[(int(opp[i]),) + sl]
                                + lattice.wall_corr(i, uwx, uwy, cfg.rho0))
        if cfg.bc_west == "inlet":
            cw, ce = hx, hx + w - 1
            if w_on:
                n1, n5, n8 = lbm.zou_he_inlet(
                    tuple(g[i, :, cw] for i in range(9)), u_rows, shift)
                g[1, :, cw], g[5, :, cw], g[8, :, cw] = n1, n5, n8
            if e_on:
                n3, n7, n6 = lbm.zou_he_outlet(
                    tuple(g[i, :, ce] for i in range(9)), rho_o, shift)
                g[3, :, ce], g[7, :, ce], g[6, :, ce] = n3, n7, n6
    return g


def check_edges(mode: str, edges, ny_glob=None) -> None:
    """The edge flags a pre-haloed temporal block (K5, K6, K7) needs:
    (south, north, west, east[, global row offset]); a "y" shard spans
    the lattice's width, so it holds both x edges. K6 and K7 pass their
    ny_glob, which must then be given (the inlet profile's global
    height); K5 defaults to the shard's own height."""
    if edges is None or len(edges) not in (4, 5):
        raise ValueError("a pre-haloed temporal block needs edges = (south, "
                         "north, west, east[, global row offset])")
    if mode == "y" and not (edges[2] and edges[3]):
        raise ValueError("a 'y' shard spans the lattice's width: it holds "
                         "both x edges (edges[2] = edges[3] = 1)")
    if ny_glob is not None and ny_glob <= 0:
        raise ValueError("a pre-haloed temporal block needs ny_glob, the "
                         "global lattice height")


def edge_params(cfg: SimConfig, edges, ny_glob: int, device):
    """(FluidParams, inlet profile pointer or None) of a pre-haloed
    temporal block on the shard that `edges` places: the walls and Zou/He
    sides of its global edges, the profile at its frame rows."""
    s_on, n_on, w_on, e_on = (int(bool(e)) for e in edges[:4])
    oy = int(edges[4]) if len(edges) > 4 else 0
    p = _params(cfg, s_on | n_on << 1 | w_on << 2 | e_on << 3,
                w_on | e_on << 1)
    u_in = (_frame_profile(cfg, oy, ny_glob, device).data_ptr()
            if cfg.bc_west == "inlet" else None)
    return p, u_in


@functools.lru_cache(maxsize=256)
def _params(cfg: SimConfig, walls_mask: int = 15,
            open_mask=None) -> kernels.FluidParams:
    """The kernels' FluidParams of cfg. On a pre-haloed shard the walls
    and the Zou/He sides are masked to those the kernel runs there
    (walls_mask: bit 0 south, 1 north, 2 west, 3 east; open_mask: bit 0
    the west inlet, 1 the east outlet; None on the lattice, where `open`
    is 1 under Zou/He)."""
    f32 = np.float32
    tau = cfg.tau
    trt = cfg.trt_lambda
    tau_m = lbm.trt_tau_minus(tau, trt) if trt > 0.0 else tau
    walls = ((cfg.bc_south == WALL) | (cfg.bc_north == WALL) << 1
             | (cfg.bc_west == WALL) << 2 | (cfg.bc_east == WALL) << 3)
    # the half-way wall terms in the order of csrc/d2q9.cuh FluidParams.bb
    sides = ((lattice.IN_N, cfg.uw_south, 0.0),
             (lattice.IN_S, cfg.uw_north, 0.0),
             (lattice.IN_E, 0.0, cfg.uw_west),
             (lattice.IN_W, 0.0, cfg.uw_east))
    bb = [f32(lattice.wall_corr(int(i), uwx, uwy, cfg.rho0))
          for idxs, uwx, uwy in sides for i in idxs]
    return kernels.FluidParams(
        tau=f32(tau), tau_sq=f32(tau * tau), half_gx=f32(0.5 * cfg.gx),
        half_gy=f32(0.5 * cfg.gy), gx=f32(cfg.gx), gy=f32(cfg.gy),
        guo_pref=f32(1.0 - 0.5 / tau), trt_magic=f32(trt),
        trt_hp=f32(0.5 / tau), trt_hm=f32(0.5 / tau_m),
        trt_pe=f32((1.0 - 0.5 / tau) * 0.5),
        trt_po=f32((1.0 - 0.5 / tau_m) * 0.5),
        les_c=f32(18.0 * np.sqrt(2.0) * cfg.smagorinsky * cfg.smagorinsky),
        rho0=f32(cfg.rho0), rho_out=f32(cfg.rho_outlet or cfg.rho0),
        bb=(ctypes.c_float * 12)(*bb),
        forced=int(cfg.gx != 0.0 or cfg.gy != 0.0), trt=int(trt > 0.0),
        les=int(cfg.smagorinsky > 0.0), walls=int(walls) & walls_mask,
        open=(int(cfg.bc_west == "inlet") if open_mask is None
              else (3 if cfg.bc_west == "inlet" else 0) & open_mask),
    )


@functools.lru_cache(maxsize=64)
def _pair_params(cfg: SimConfig) -> kernels.PairParams:
    """The kernels' PairParams of cfg: pair_consts in float32."""
    c = pair_consts(cfg)
    arr = lambda xs: (ctypes.c_float * len(xs))(*xs)  # noqa: E731
    return kernels.PairParams(
        inv_tau=c["inv_tau"], inv_tau_m=c["inv_tau_m"],
        gw=arr([c["gw0"], *c["gw"]]), eg9=arr(c["eg9"]), w3eg=arr(c["w3eg"]),
        godd=arr(c["godd"]))


@functools.lru_cache(maxsize=64)
def _inlet_profile(cfg: SimConfig, device: torch.device):
    """The (ny,) f32 inlet profile on the card (lbm.inlet_profile_array),
    made once per configuration and device: a host-to-device copy per
    launch would synchronise the stream."""
    return torch.as_tensor(lbm.inlet_profile_array(cfg), dtype=torch.float32,
                           device=device)


def frame_profile_rows(cfg: SimConfig, oy: int, ny_glob: int):
    """The global rows of a shard's frame rows -hy .. ny + hy - 1 whose
    local row 0 is global row oy, wrapped on a periodic y axis and
    clamped on a wall axis (whose halo rows no output needs)."""
    hy = frame_hy(cfg)
    rows = np.arange(cfg.ny + 2 * hy) - hy + oy
    if cfg.bc_south != WALL:
        return np.mod(rows, ny_glob)
    return np.clip(rows, 0, ny_glob - 1)


@functools.lru_cache(maxsize=256)
def _frame_profile(cfg: SimConfig, oy: int, ny_glob: int,
                   device: torch.device):
    """The (ny + 2 hy,) f32 inlet profile at a shard's frame rows, on the
    card, made once per shard."""
    u = lbm.inlet_profile_array(cfg.replace(ny=ny_glob))
    return torch.as_tensor(u[frame_profile_rows(cfg, oy, ny_glob)],
                           dtype=torch.float32, device=device)


def edge_ptrs(edge_post, cfg: SimConfig, device):
    """(rows, cols) pointers of an edge_post pair for the C launchers
    (None where it is None), after checking its shapes."""
    if edge_post is None:
        return None, None
    rows, cols = edge_post
    for t, shape in ((rows, (9, 2, cfg.nx)), (cols, (9, cfg.ny, 2))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"edge_post: contiguous f32 {shape} buffers on "
                             f"f's device")
    return rows.data_ptr(), cols.data_ptr()


def _frame_args(f, cfg: SimConfig, mode: str):
    """(pitch, halo columns) of a frame for the C launchers: the row
    length of f and the column of its interior's first cell."""
    return f.shape[2], (HX if mode == "yx" else 0)


def _scratch(f, k: int):
    """K5's f32 scratch for k steps: ceil(k / SWEEP_K) - 1 planes (at most
    two, used in turn) of f's shape, the lattice's or the frame's; None
    for one sweep."""
    n_mid = min(-(-k // SWEEP_K) - 1, 2)
    return (torch.empty((n_mid, *f.shape), dtype=torch.float32,
                        device=f.device) if n_mid else None)


def _launch(f, cfg: SimConfig, k: int, out, what: str, mode: str = "",
            edges=None, ny_glob: int = 0, edge_post=None) -> None:
    """Launch K4 (k None) or K5 (k steps) on the lattice or, in pre-halo
    mode `mode`, on a shard's frame."""
    want = check_storage(what, cfg, f, out)
    bf16 = int(want == torch.bfloat16)
    q = _pair_params(cfg)
    lib = kernels.library()
    kernels.setting("lbm_fluid_strip", *STRIP)
    u_in = (_inlet_profile(cfg, f.device).data_ptr()
            if cfg.bc_west == "inlet" else None)
    with torch.cuda.device(f.device):
        if mode and k is None:  # the caller fixes the global edges
            pitch, hx = _frame_args(f, cfg, mode)
            erow, ecol = edge_ptrs(edge_post, cfg, f.device)
            code = lib.lbm_fluid_step_prehalo(
                f.data_ptr(), out.data_ptr(), erow, ecol, cfg.ny, cfg.nx,
                pitch, hx, bf16, _params(cfg, 12 if mode == "y" else 0, 0), q,
                kernels.stream())
        elif mode:
            pitch, hx = _frame_args(f, cfg, mode)
            p, u_in = edge_params(cfg, edges, ny_glob, f.device)
            mid = _scratch(f, k)
            code = lib.lbm_fluid_multi_prehalo(
                f.data_ptr(), out.data_ptr(),
                None if mid is None else mid.data_ptr(), u_in, cfg.ny,
                cfg.nx, pitch, hx, k, bf16, p, q, kernels.stream())
        elif k is None:
            code = lib.lbm_fluid_step(f.data_ptr(), out.data_ptr(), u_in,
                                      cfg.ny, cfg.nx, bf16, _params(cfg), q,
                                      kernels.stream())
        else:
            mid = _scratch(f, k)
            code = lib.lbm_fluid_multi(f.data_ptr(), out.data_ptr(),
                                       None if mid is None else mid.data_ptr(),
                                       u_in, cfg.ny, cfg.nx, k, bf16,
                                       _params(cfg), q, kernels.stream())
    kernels.check(code, what)


def _check_args(f, cfg: SimConfig, out, what: str, mode: str = "") -> None:
    shape = frame_shape(cfg, mode)
    if tuple(f.shape) != shape:
        raise ValueError(f"{what}: f must be {shape}, got {tuple(f.shape)}")
    if (tuple(out.shape) != (9, cfg.ny, cfg.nx)
            or out.data_ptr() == f.data_ptr()):
        raise ValueError(f"{what}: `out` must be a second (9, {cfg.ny}, "
                         f"{cfg.nx}) f buffer")


def fused_step_fluid(f, cfg: SimConfig, out, prehalo=False, edge_post=None):
    """K4: one pure-fluid step of f (9, ny, nx) in storage form, written
    into `out` (the other f buffer, same shape). Returns out.

    prehalo ("y" or True, "yx"): f is a shard's pre-haloed frame
    (frame_shape), `out` its (9, ny, nx) interior; the y walls ("y") or
    all walls ("yx") and the Zou/He closures are left to the caller,
    which may ask for the post-collision populations of the interior's
    first and last rows and columns in edge_post = (rows (9, 2, nx),
    cols (9, ny, 2)) f32 buffers (the bounce-back's sources; on bf16 the
    shifted populations, unrounded).

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/fluid.cu (lbm_fluid_step, or lbm_fluid_step_prehalo on a
    frame)."""
    mode = check_fluid_cfg(cfg, prehalo)
    _check_args(f, cfg, out, "fused_step_fluid", mode)
    if edge_post is not None and not mode:
        raise ValueError("edge_post is for a pre-haloed frame")
    if f.device.type == "cpu":
        if mode:
            return fused_step_fluid_prehalo_plain(f, cfg, mode, out,
                                                  edge_post)
        return fused_step_fluid_plain(f, cfg, out)
    _launch(f, cfg, None, out, "pure-fluid step kernel (K4)", mode,
            edge_post=edge_post)
    fused_step_fluid.launches += 1
    return out


def fused_step_fluid_multi(f, cfg: SimConfig, k: int, out, prehalo=False,
                           edges=None, ny_glob: int = 0):
    """K5: k pure-fluid steps in one pass (1 <= k <= MAX_K[f_storage]),
    written into `out`. Returns out. k == 1 is K4, as in the JAX entry.

    prehalo ("y" or True, "yx"): f is a shard's pre-haloed frame, `out`
    its interior (k up to the frame's halo rows, MAX_K); `edges` =
    (south, north, west, east[, global row offset]) flags the global
    edges the shard holds, where the walls and the Zou/He closures run
    at every inner step, and `ny_glob` is the global lattice height (the
    inlet profile's).

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/fluid.cu (lbm_fluid_multi, or lbm_fluid_multi_prehalo on a
    frame; k > SWEEP_K as several row sweeps, through f32 scratch planes
    or, on a frame, scratch frames)."""
    mode = check_fluid_cfg(cfg, prehalo, edges)
    if not 1 <= k <= MAX_K[cfg.f_storage]:
        raise ValueError(f"temporal block k={k} outside "
                         f"1..{MAX_K[cfg.f_storage]} for f_storage="
                         f"{cfg.f_storage!r}")
    if mode:
        check_edges(mode, edges)
    if k == 1 and not mode:
        return fused_step_fluid(f, cfg, out)
    _check_args(f, cfg, out, "fused_step_fluid_multi", mode)
    if f.device.type == "cpu":
        if mode:
            return fused_step_fluid_multi_prehalo_plain(
                f, cfg, k, mode, edges, ny_glob or cfg.ny, out)
        return fused_step_fluid_multi_plain(f, cfg, k, out)
    _launch(f, cfg, k, out, "temporal-block fluid kernel (K5)", mode, edges,
            ny_glob or cfg.ny)
    fused_step_fluid_multi.launches += 1
    return out


fused_step_fluid.launches = 0
fused_step_fluid_multi.launches = 0
