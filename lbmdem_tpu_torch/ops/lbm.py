"""Pure-fluid D2Q9 LBM ops, plain PyTorch reference implementation.

Counterpart of the JAX package's `lbmdem_tpu/ops/lbm.py`, function for
function: equilibrium (C2), BGK/TRT collide (C3), pull streaming (C4),
moments with the Guo half-force shift (C5), half-way bounce-back with
moving walls (C6), Guo forcing (C7), Smagorinsky LES (C8) and the
Zou/He open boundaries. It is the plain version the fused coupled
kernel (`ops/fused_lbm.py`) is held against.

Array convention: `f` has shape (9, ny, nx), indexed [i, y, x]; cell
(iy, ix) center at (x=ix, y=iy) lattice units. See `lattice.py`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.config import SimConfig, WALL


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """(9, 1, 1) lattice constant in `like`'s dtype and device."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)[:, None, None]


def equilibrium(rho: torch.Tensor, ux: torch.Tensor,
                uy: torch.Tensor) -> torch.Tensor:
    """f_eq_i = w_i rho [1 + 3(e.u) + 9/2 (e.u)^2 - 3/2 u^2]  (C2)."""
    w = _const(lattice.W, rho)
    ex = _const(lattice.EX, rho)
    ey = _const(lattice.EY, rho)
    eu = ex * ux + ey * uy
    usq = ux * ux + uy * uy
    return w * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq)


def moments(
    f: torch.Tensor, gx: float = 0.0, gy: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rho = sum_i f_i; u = (sum_i f_i e_i + F/2) / rho  (C5)."""
    ex = _const(lattice.EX, f)
    ey = _const(lattice.EY, f)
    rho = torch.sum(f, dim=0)
    inv_rho = 1.0 / rho
    ux = (torch.sum(f * ex, dim=0) + 0.5 * gx) * inv_rho
    uy = (torch.sum(f * ey, dim=0) + 0.5 * gy) * inv_rho
    return rho, ux, uy


def storage_shift(cfg: SimConfig):
    """Per-population storage shift (9, 1, 1) float32, or None for plain
    storage. f_storage='bfloat16' stores g_i = f_i - w_i*rho0."""
    if cfg.f_storage == "bfloat16":
        return torch.as_tensor(
            (lattice.W * cfg.rho0).astype(np.float32))[:, None, None]
    return None


def to_storage(f: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Physical f -> storage representation (shifted bf16 when
    cfg.f_storage='bfloat16', identity otherwise)."""
    s = storage_shift(cfg)
    if s is None:
        return f
    return (f - s.to(f.device)).to(torch.bfloat16)


def from_storage(fs: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Storage representation -> physical f."""
    s = storage_shift(cfg)
    if s is None:
        return fs
    return fs.to(torch.float32) + s.to(fs.device)


def smagorinsky_tau(f, feq, rho, tau0: float, cs_const: float):
    """Effective relaxation time from the non-equilibrium stress (C8):
    tau_eff = 1/2 (tau0 + sqrt(tau0^2 + 18 sqrt(2) Cs^2 ||Pi|| / rho))."""
    ex = _const(lattice.EX, f)
    ey = _const(lattice.EY, f)
    fneq = f - feq
    pxx = torch.sum(fneq * ex * ex, dim=0)
    pyy = torch.sum(fneq * ey * ey, dim=0)
    pxy = torch.sum(fneq * ex * ey, dim=0)
    pnorm = torch.sqrt(pxx * pxx + pyy * pyy + 2.0 * pxy * pxy)
    c = 18.0 * np.sqrt(2.0) * cs_const * cs_const
    return 0.5 * (tau0 + torch.sqrt(tau0 * tau0 + c * pnorm / rho))


def _guo_proj(ux, uy, gx: float, gy: float) -> torch.Tensor:
    """w_i [3 (e_i - u) + 9 (e_i . u) e_i] . F without the relaxation
    prefactor (BGK and TRT scale it differently)."""
    w = _const(lattice.W, ux)
    ex = _const(lattice.EX, ux)
    ey = _const(lattice.EY, ux)
    eu = ex * ux + ey * uy
    proj = 3.0 * ((ex - ux) * gx + (ey - uy) * gy) + 9.0 * eu * (ex * gx + ey * gy)
    return w * proj


def guo_force_term(ux, uy, tau, gx: float, gy: float) -> torch.Tensor:
    """Guo forcing source S_i = (1 - 1/(2 tau)) * _guo_proj (C7)."""
    return (1.0 - 0.5 / tau) * _guo_proj(ux, uy, gx, gy)


def trt_tau_minus(tau, trt_magic: float):
    """Odd-moment relaxation time from the magic parameter:
    Lambda = (tau+ - 1/2)(tau- - 1/2)."""
    return 0.5 + trt_magic / (tau - 0.5)


def collide(f, tau: float, gx: float = 0.0, gy: float = 0.0,
            smagorinsky: float = 0.0, trt_magic: float = 0.0):
    """BGK/TRT relaxation + optional Guo forcing + optional LES."""
    rho, ux, uy = moments(f, gx, gy)
    feq = equilibrium(rho, ux, uy)
    tau_eff = (smagorinsky_tau(f, feq, rho, tau, smagorinsky)
               if smagorinsky > 0.0 else tau)
    forced = gx != 0.0 or gy != 0.0
    if trt_magic <= 0.0:
        fpost = f - (f - feq) / tau_eff
        if forced:
            fpost = fpost + guo_force_term(ux, uy, tau_eff, gx, gy)
        return fpost
    opp = lattice.OPP
    tau_m = trt_tau_minus(tau_eff, trt_magic)
    ne = f - feq
    ne_o = ne[opp]
    fpost = f - (0.5 / tau_eff) * (ne + ne_o) - (0.5 / tau_m) * (ne - ne_o)
    if forced:
        S = _guo_proj(ux, uy, gx, gy)
        S_o = S[opp]
        fpost = (fpost + (1.0 - 0.5 / tau_eff) * 0.5 * (S + S_o)
                 + (1.0 - 0.5 / tau_m) * 0.5 * (S - S_o))
    return fpost


def stream(fpost: torch.Tensor) -> torch.Tensor:
    """Periodic pull streaming: f_i(x, t+1) = f_i^post(x - e_i, t) (C4),
    a circular shift by +e_i per population; walls are applied after by
    `apply_bounce_back`."""
    out = []
    for i in range(lattice.Q):
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        out.append(torch.roll(fpost[i], shifts=(ey, ex), dims=(0, 1)))
    return torch.stack(out)


def apply_bounce_back(fnew, fpost, cfg: SimConfig, wall_speed=None):
    """Half-way bounce-back at wall sides (C6):
        f_i(x_b, t+1) = f_opp(i)^post(x_b, t) + 6 w_i rho0 (e_i . u_w)
    in the order south, north, west, east (at a corner the x-wall rule
    wins). Returns a new tensor; `fnew` is not modified."""
    opp = lattice.OPP
    if wall_speed is None:
        wall_speed = (cfg.uw_west, cfg.uw_east, cfg.uw_south, cfg.uw_north)
    uw_w, uw_e, uw_s, uw_n = wall_speed
    fnew = fnew.clone()

    def fix(idxs, sl_y, sl_x, uwx, uwy):
        for i in idxs:
            i = int(i)
            corr = lattice.wall_corr(i, uwx, uwy, cfg.rho0)
            fnew[i, sl_y, sl_x] = fpost[int(opp[i]), sl_y, sl_x] + torch.as_tensor(
                corr, dtype=fnew.dtype, device=fnew.device)

    all_ = slice(None)
    if cfg.bc_south == WALL:
        fix(lattice.IN_N, 0, all_, uw_s, 0.0)
    if cfg.bc_north == WALL:
        fix(lattice.IN_S, cfg.ny - 1, all_, uw_n, 0.0)
    if cfg.bc_west == WALL:
        fix(lattice.IN_E, all_, 0, 0.0, uw_w)
    if cfg.bc_east == WALL:
        fix(lattice.IN_W, all_, cfg.nx - 1, 0.0, uw_e)
    return fnew


def inlet_profile_array(cfg: SimConfig) -> np.ndarray:
    """(ny,) inlet x-velocity profile ('poiseuille' is zero at the
    half-way wall planes y = -1/2 and ny - 1/2)."""
    y = np.arange(cfg.ny, dtype=np.float64) + 0.5
    H = float(cfg.ny)
    if cfg.inlet_profile == "poiseuille":
        return (4.0 * cfg.u_inlet / (H * H) * y * (H - y)).astype(cfg.dtype)
    return np.full(cfg.ny, cfg.u_inlet, cfg.dtype)


def zou_he_inlet(fs, uw, shift=0.0):
    """Zou/He west-inlet closure: the unknown populations (1, 5, 8) of a
    cell with prescribed u = (uw, 0), from its post-stream knowns.
    `shift` != 0: shifted-storage inputs and outputs."""
    f0, f1, f2, f3, f4, f5, f6, f7, f8 = fs
    knowns = f0 + f2 + f4 + 2.0 * (f3 + f6 + f7)
    if shift:
        knowns = knowns + shift
    rho_w = knowns / (1.0 - uw)
    d24 = 0.5 * (f2 - f4)
    ru = rho_w * uw
    return (f3 + (2.0 / 3.0) * ru,
            f7 - d24 + (1.0 / 6.0) * ru,
            f6 + d24 + (1.0 / 6.0) * ru)


def zou_he_outlet(fs, rho_o, shift=0.0):
    """Zou/He east-outlet closure (prescribed rho = rho_o, v = 0): the
    populations (3, 7, 6)."""
    f0, f1, f2, f3, f4, f5, f6, f7, f8 = fs
    knowns = f0 + f2 + f4 + 2.0 * (f1 + f5 + f8)
    if shift:
        knowns = knowns + shift
    ue = -1.0 + knowns / rho_o
    d24 = 0.5 * (f2 - f4)
    rue = rho_o * ue
    return (f1 - (2.0 / 3.0) * rue,
            f5 + d24 - (1.0 / 6.0) * rue,
            f8 - d24 - (1.0 / 6.0) * rue)


def apply_open_boundaries(fnew, cfg: SimConfig):
    """Zou/He open boundaries, applied after bounce-back so the wall
    corners supply the tangential knowns."""
    if cfg.bc_west != "inlet":
        return fnew
    u_in = torch.as_tensor(inlet_profile_array(cfg), dtype=fnew.dtype,
                           device=fnew.device)
    f1, f5, f8 = zou_he_inlet(tuple(fnew[i, :, 0] for i in range(9)), u_in)
    rho_o = torch.as_tensor(cfg.rho_outlet or cfg.rho0, dtype=fnew.dtype,
                            device=fnew.device)
    f3, f7, f6 = zou_he_outlet(tuple(fnew[i, :, -1] for i in range(9)), rho_o)
    fnew = fnew.clone()
    for i, v in ((1, f1), (5, f5), (8, f8)):
        fnew[i, :, 0] = v
    for i, v in ((3, f3), (7, f7), (6, f6)):
        fnew[i, :, -1] = v
    return fnew


def step_pure_fluid(f, cfg: SimConfig, wall_speed=None):
    """One pure-fluid LBM step: collide-stream-BB (+ Zou/He)."""
    fpost = collide(f, cfg.tau, cfg.gx, cfg.gy, cfg.smagorinsky,
                    cfg.trt_lambda)
    fnew = stream(fpost)
    fnew = apply_bounce_back(fnew, fpost, cfg, wall_speed)
    return apply_open_boundaries(fnew, cfg)


def torch_dtype(cfg: SimConfig) -> torch.dtype:
    """The compute dtype named by cfg.dtype."""
    return {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]


def init_equilibrium(cfg: SimConfig, device="cpu") -> torch.Tensor:
    """Initial distributions at (rho0, u0)."""
    dt = torch_dtype(cfg)
    shape = (cfg.ny, cfg.nx)
    rho = torch.full(shape, cfg.rho0, dtype=dt, device=device)
    ux = torch.full(shape, cfg.u0x, dtype=dt, device=device)
    uy = torch.full(shape, cfg.u0y, dtype=dt, device=device)
    return equilibrium(rho, ux, uy)
