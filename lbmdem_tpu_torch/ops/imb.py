"""Noble-Torczynski immersed-moving-boundary (IMB) coupling, plain
PyTorch.

Counterpart of the JAX package's `lbmdem_tpu/ops/imb.py`: coverage
(C9), the periodic ghost disks, the NT-blended collision with its
momentum-exchange field (C10) and the per-disk force/torque gather
(C12).

Sign convention: phi = -B sum_i Omega_i e_i is the force per cell on
the solid phase.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops.lbm import (_const, equilibrium, guo_force_term,
                                      moments, smagorinsky_tau)

_EPS_MIN = 1e-7


def sqrt_rn(x):
    """Square root rounded once to x's precision, as IEEE sqrt (and the
    kernels' __fsqrt_rn) gives it. The CPU's float32 torch.sqrt is not
    correctly rounded on every build (and its vector and scalar paths
    may disagree), so a float32 x takes the root in float64 and rounds
    to float32 once, which is exact for a float32 argument."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def exact_coverage(relx, rely, rr):
    """Analytic circle-cell overlap area (the "exact" eps_method); see
    the JAX twin for the derivation. Empty slots (rr == 0) give 0."""
    ax = torch.abs(relx)
    ay = torch.abs(rely)
    A = torch.maximum(ax, ay)
    Bc = torch.minimum(ax, ay)
    d2 = relx * relx + rely * rely
    d = sqrt_rn(d2)
    rc = rr - 1.0 / (24.0 * torch.clamp(rr, min=1e-6))
    S = d * (rc - d)
    C1 = 0.5 * (A - Bc)
    C2 = 0.5 * (A + Bc)
    t1 = S + C1
    t2 = S + C2
    t3 = S - C1
    t4 = S - C2
    u = torch.clamp(t1, min=0.0)
    v = torch.clamp(t2, min=0.0)
    p = torch.clamp(t3, min=0.0)
    q = torch.clamp(t4, min=0.0)
    inv_b = 1.0 / torch.clamp(Bc, min=1e-4)
    alpha = torch.clamp(t2 * inv_b, 0.0, 1.0)
    beta = torch.clamp(t3 * inv_b, 0.0, 1.0)
    num = alpha * (v + u) - beta * (p + q)
    cov = num * (0.5 / torch.clamp(A, min=1e-6))
    cov = torch.clamp(cov, 0.0, 1.0)
    full = (rr > 0.81).to(relx.dtype)
    return torch.where(d2 < 0.01, full, cov)


def _coverage_window(x, y, r, active, window: int, ns: int,
                     method: str = "sample", r_shift: float = 0.0):
    """Coverage of each disk's window cells plus its base cell indices.

    x, y, r, active: (N,). Returns (cov (N, W, W), by (N,), bx (N,)):
    cov[n, wy, wx] is the area fraction of cell (by+wy, bx+wx) inside
    disk n. The sample form (r^2 - dy^2, then dx^2 <= t) is the JAX
    oracle's, kept bitwise."""
    dt = x.dtype
    dev = x.device
    if r_shift:
        r = torch.where(r > 0, torch.clamp(r + r_shift, min=0.05),
                        torch.zeros_like(r))
    half = window // 2
    bx = torch.floor(x + 0.5).to(torch.int32) - half
    by = torch.floor(y + 0.5).to(torch.int32) - half
    cells = torch.arange(window, dtype=dt, device=dev)
    offs = (torch.arange(ns, dtype=dt, device=dev) + 0.5) / ns - 0.5
    if method in ("ramp", "exact"):
        cy = (by.to(dt)[:, None] + cells[None, :]) - y[:, None]  # (N, W)
        cx = (bx.to(dt)[:, None] + cells[None, :]) - x[:, None]
        if method == "ramp":
            d = torch.sqrt(cy[:, :, None] ** 2 + cx[:, None, :] ** 2)
            cov = torch.clamp(r[:, None, None] + 0.5 - d, 0.0, 1.0)
        else:
            cov = exact_coverage(
                cx[:, None, :].expand(-1, window, window),
                cy[:, :, None].expand(-1, window, window),
                r[:, None, None],
            )
    else:
        px = ((bx.to(dt)[:, None, None] + cells[None, :, None])
              + offs[None, None, :]) - x[:, None, None]  # (N, W, ns)
        py = ((by.to(dt)[:, None, None] + cells[None, :, None])
              + offs[None, None, :]) - y[:, None, None]
        dx2 = px * px
        t = r[:, None, None] * r[:, None, None] - py * py
        inside = dx2[:, None, :, None, :] <= t[:, :, None, :, None]
        cov = torch.mean(inside.to(dt), dim=(3, 4))  # (N, Wy, Wx)
    return cov * active.to(dt)[:, None, None], by, bx


def _window_cells(by, bx, window: int):
    """(iy, ix) (N, W, W) int64 cell indices of each disk's window."""
    ar = torch.arange(window, dtype=torch.int64, device=by.device)
    iy = (by.to(torch.int64)[:, None, None] + ar[None, :, None]).expand(
        -1, window, window)
    ix = (bx.to(torch.int64)[:, None, None] + ar[None, None, :]).expand(
        -1, window, window)
    return iy, ix


def stamp_solid_fraction(xp, vp, omega, r, active, cfg: SimConfig):
    """Solid fraction + coverage-weighted solid velocity fields (C9):
    (eps_raw, us_x, us_y), each (ny, nx). eps_raw is the unclipped sum
    of per-disk coverages; u_s includes the rigid rotation v + omega x r.
    One scatter-add over all disks' windows."""
    W, ns = cfg.window, cfg.eps_samples
    dt = xp.dtype
    cov, by, bx = _coverage_window(xp[:, 0], xp[:, 1], r, active, W, ns,
                                   cfg.eps_method, cfg.eps_r_shift)
    iy, ix = _window_cells(by, bx, W)
    # negative indices wrap in torch as in JAX: mask, then clip
    valid = (iy >= 0) & (iy < cfg.ny) & (ix >= 0) & (ix < cfg.nx)
    cov = torch.where(valid, cov, torch.zeros_like(cov))
    iy = iy.clamp(0, cfg.ny - 1)
    ix = ix.clamp(0, cfg.nx - 1)
    relx = ix.to(dt) - xp[:, 0, None, None]
    rely = iy.to(dt) - xp[:, 1, None, None]
    om = omega[:, None, None]
    usx = vp[:, 0, None, None] + om * (-rely)
    usy = vp[:, 1, None, None] + om * relx
    vals = torch.stack([cov, cov * usx, cov * usy], dim=-1).reshape(-1, 3)
    fields = torch.zeros((cfg.ny * cfg.nx, 3), dtype=dt, device=xp.device)
    fields.index_add_(0, (iy * cfg.nx + ix).reshape(-1), vals)
    fields = fields.reshape(cfg.ny, cfg.nx, 3)
    eps = fields[..., 0]
    inv = 1.0 / torch.clamp(eps, min=_EPS_MIN)
    return eps, fields[..., 1] * inv, fields[..., 2] * inv


def mask_open_columns(eps, usx, usy):
    """Zero the solid fields on the open-boundary columns (x = 0 and
    nx-1) so the Zou/He closures see pure fluid there."""
    out = []
    for a in (eps, usx, usy):
        a = a.clone()
        a[:, 0] = 0.0
        a[:, -1] = 0.0
        out.append(a)
    return tuple(out)


# --- periodic ghost disks -------------------------------------------
#
# The stamp and reduce work in absolute cell coordinates, so a disk whose
# window crosses a periodic edge also gets a "ghost": a min-image shifted
# copy appended to the arrays fed to binning, stamping and reduction. The
# ghosts' hydro forces fold back into their parents afterwards.


def default_ghost_cap(n: int, cfg: SimConfig, margin: int = 0) -> int:
    """Per-block ghost capacity: the expected near-edge disk count for a
    uniform spatial distribution, with 4x headroom (overflow is
    counted, never silent)."""
    t = cfg.window // 2 + margin + 2
    frac = 0.0
    if cfg.wrap_lx:
        frac = max(frac, 2.0 * t / cfg.wrap_lx)
    if cfg.wrap_ly:
        frac = max(frac, 2.0 * t / cfg.wrap_ly)
    cap = int(4.0 * n * frac) + 8
    return min((cap + 7) & ~7, max(n, 8))


def ghost_selection(x, active, cfg: SimConfig, margin: int = 0):
    """Fixed-capacity selection of the disks that need a periodic ghost.

    Returns (parent (G,) i32 with -1 = empty slot, axes (G, 2) i32 with
    1 where the ghost shifts on that axis, overflow () i32). G is
    cfg.ghost_cap slots per block (x edge, y edge, corner); no periodic
    axis gives G == 0. `margin` widens the near-edge test so that a
    selection stays valid while disks travel < margin cells (the
    Verlet cadence). Within a block the parents are in disk order, as
    jax.lax.top_k lists the tied flags."""
    lx, ly = cfg.wrap_lx, cfg.wrap_ly
    dev = x.device
    i32 = torch.int32
    if not (lx or ly):
        return (torch.zeros((0,), dtype=i32, device=dev),
                torch.zeros((0, 2), dtype=i32, device=dev),
                torch.zeros((), dtype=i32, device=dev))
    cap = cfg.ghost_cap
    if cap <= 0:
        raise ValueError("cfg.ghost_cap must be set (Simulation derives it)")
    t = cfg.window // 2 + margin + 2
    kk = min(cap, x.shape[0])
    pad = torch.full((cap - kk,), -1, dtype=i32, device=dev)

    def pack(flag):
        # a stable descending sort puts the flagged rows first, in order
        order = torch.sort(flag.to(torch.uint8), descending=True,
                           stable=True).indices[:kk]
        hit = flag[order]
        parent = torch.where(hit, order.to(i32), -1)
        ovf = torch.sum(flag, dtype=i32) - torch.sum(hit, dtype=i32)
        return torch.cat([parent, pad]), ovf

    near_x = active & ((x[:, 0] < t) | (x[:, 0] > lx - 1 - t)) if lx else None
    near_y = active & ((x[:, 1] < t) | (x[:, 1] > ly - 1 - t)) if ly else None
    blocks = []
    if lx:
        blocks.append((near_x, (0,)))
    if ly:
        blocks.append((near_y, (1,)))
    if lx and ly:
        blocks.append((near_x & near_y, (0, 1)))
    parents, axes = [], []
    ovf = torch.zeros((), dtype=i32, device=dev)
    for flag, shifted in blocks:
        p, o = pack(flag)
        parents.append(p)
        ax = torch.zeros((cap, 2), dtype=i32, device=dev)
        for a in shifted:
            ax[:, a].fill_(1)
        axes.append(ax)
        ovf = ovf + o
    return torch.cat(parents), torch.cat(axes), ovf


def apply_ghosts(parent, axes, x, v, omega, r, active, cfg: SimConfig):
    """Append min-image shifted ghost rows to the disk arrays.

    The shift side follows the parent's CURRENT position (a parent in
    the west half gets its ghost at +L, in the east half at -L), so a
    stale selection stays right across a seam crossing. Returns
    (x, v, omega, r, active) with N + G rows; empty slots are inactive
    and parked far outside the domain."""
    if parent.shape[0] == 0:
        return x, v, omega, r, active
    j = parent.clamp(min=0).to(torch.int64)
    gx = x[j]
    cols = [gx[:, 0], gx[:, 1]]
    for a, L in ((0, cfg.wrap_lx), (1, cfg.wrap_ly)):
        if L:
            c = cols[a]
            shifted = torch.where(c < 0.5 * (L - 1.0), c + L, c - L)
            cols[a] = torch.where(axes[:, a] > 0, shifted, c)
    gxy = torch.stack(cols, dim=1)
    g_act = (parent >= 0) & active[j]
    gxy = torch.where(g_act[:, None], gxy, torch.full_like(gxy, -1e6))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.cat([x, gxy]),
            torch.cat([v, torch.where(g_act[:, None], v[j], zero)]),
            torch.cat([omega, torch.where(g_act, omega[j], zero)]),
            torch.cat([r, torch.where(g_act, r[j], torch.ones_like(r[j]))]),
            torch.cat([active, g_act]))


def fold_ghost_forces(F, T, parent, n: int):
    """Sum the ghost rows' hydro forces (F[n:], T[n:]) into their
    parents: (F (n, 2), T (n,)). Empty slots add into a spare row that
    is dropped, as the JAX scatter's mode="drop" does."""
    if parent.shape[0] == 0:
        return F, T
    j = torch.where(parent >= 0, parent, n).to(torch.int64)
    Fs = torch.cat([F[:n], torch.zeros_like(F[:1])]).index_add_(0, j, F[n:])
    Ts = torch.cat([T[:n], torch.zeros_like(T[:1])]).index_add_(0, j, T[n:])
    return Fs[:n], Ts[:n]


def wrap_positions(x, active, cfg: SimConfig):
    """Wrap ACTIVE disk centers into the periodic domain [-1/2, L-1/2).
    Inactive slots stay parked outside the domain. Callers wrap only at
    ghost-selection points, so tile lists never see the +-L jump."""
    lx, ly = cfg.wrap_lx, cfg.wrap_ly
    if not (lx or ly):
        return x
    cols = [x[:, 0], x[:, 1]]
    for a, L in ((0, lx), (1, ly)):
        if L:
            c = cols[a]
            cols[a] = c - L * torch.floor((c + 0.5) / L)
    return torch.where(active[:, None], torch.stack(cols, dim=1), x)


def periodic_ghosts(x, v, omega, r, active, cfg: SimConfig, margin: int = 0):
    """Wrap, select and augment in one call: (x_wrapped, (x, v, omega,
    r, active) with the ghost rows appended, parent, axes, overflow)."""
    xw = wrap_positions(x, active, cfg)
    parent, axes, ovf = ghost_selection(xw, active, cfg, margin)
    aug = apply_ghosts(parent, axes, xw, v, omega, r, active, cfg)
    return xw, aug, parent, axes, ovf


def nt_tm(tau, mode: str = "nt"):
    """The NT blend's tm = tau - 1/2 ("nt") or 3/16 / (tau - 1/2)
    ("lambda"); tau a Python scalar or a tensor."""
    tm = tau - 0.5
    if mode == "lambda":
        tm = 0.1875 / tm
    return tm


def nt_weight(eps, tau, mode: str = "nt"):
    """Noble-Torczynski blending B(eps, tau) = eps tm / ((1-eps) + tm)."""
    tm = nt_tm(tau, mode)
    return eps * tm / ((1.0 - eps) + tm)


def collide_imb(f, eps_raw, us_x, us_y, cfg: SimConfig):
    """NT-blended BGK/TRT collision (C10) + momentum-exchange field (C12).

    f <- f - (1-B)[(f - f_eq)/tau - S_i] + B Omega_i,
    Omega_i = f_opp - f_i + f_i^eq(rho, u_s) - f_opp^eq(rho, u).
    Returns (f_post, phi_x, phi_y)."""
    tau = cfg.tau
    rho, ux, uy = moments(f, cfg.gx, cfg.gy)
    feq = equilibrium(rho, ux, uy)
    tau_eff = (smagorinsky_tau(f, feq, rho, tau, cfg.smagorinsky)
               if cfg.smagorinsky > 0.0 else tau)
    eps = torch.clamp(eps_raw, 0.0, 1.0)
    B = nt_weight(eps, tau_eff, cfg.nt_mode)
    feq_s = equilibrium(rho, us_x, us_y)
    opp = lattice.OPP
    omega_s = f[opp] - f + feq_s - feq[opp]
    trt = cfg.trt_lambda
    forced = cfg.gx != 0.0 or cfg.gy != 0.0
    if trt <= 0.0:
        fpost = f - (1.0 - B) * (f - feq) / tau_eff + B * omega_s
        if forced:
            fpost = fpost + (1.0 - B) * guo_force_term(
                ux, uy, tau_eff, cfg.gx, cfg.gy)
    else:
        from lbmdem_tpu_torch.ops.lbm import _guo_proj, trt_tau_minus

        tau_m = trt_tau_minus(tau_eff, trt)
        ne = f - feq
        ne_o = ne[opp]
        relax = (0.5 / tau_eff) * (ne + ne_o) + (0.5 / tau_m) * (ne - ne_o)
        fpost = f - (1.0 - B) * relax + B * omega_s
        if forced:
            S = _guo_proj(ux, uy, cfg.gx, cfg.gy)
            S_o = S[opp]
            src = (1.0 - 0.5 / tau_eff) * 0.5 * (S + S_o) + (
                1.0 - 0.5 / tau_m) * 0.5 * (S - S_o)
            fpost = fpost + (1.0 - B) * src
    ex = _const(lattice.EX, f)
    ey = _const(lattice.EY, f)
    phi_x = -torch.sum(B * omega_s * ex, dim=0)
    phi_y = -torch.sum(B * omega_s * ey, dim=0)
    return fpost, phi_x, phi_y


def reduce_hydro_forces(xp, r, active, eps_raw, phi_x, phi_y,
                        cfg: SimConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-disk hydrodynamic force (N, 2) and torque (N,) from phi
    (C12): each disk gathers phi over its window, weighted by its share
    of the cell's total coverage."""
    W, ns = cfg.window, cfg.eps_samples
    dt = phi_x.dtype
    fields = torch.stack([eps_raw, phi_x, phi_y], dim=-1)  # (ny, nx, 3)
    cov, by, bx = _coverage_window(xp[:, 0], xp[:, 1], r, active, W, ns,
                                   cfg.eps_method, cfg.eps_r_shift)
    iy, ix = _window_cells(by, bx, W)
    valid = (iy >= 0) & (iy < cfg.ny) & (ix >= 0) & (ix < cfg.nx)
    g = fields[iy.clamp(0, cfg.ny - 1), ix.clamp(0, cfg.nx - 1)]  # (N,W,W,3)
    tot = torch.where(valid, g[..., 0], torch.ones_like(g[..., 0]))
    share = cov * valid.to(dt) / torch.clamp(tot, min=_EPS_MIN)
    fx_c = g[..., 1] * share
    fy_c = g[..., 2] * share
    relx = ix.to(dt) - xp[:, 0, None, None]
    rely = iy.to(dt) - xp[:, 1, None, None]
    fx = torch.sum(fx_c, dim=(1, 2))
    fy = torch.sum(fy_c, dim=(1, 2))
    tq = torch.sum(relx * fy_c - rely * fx_c, dim=(1, 2))
    return torch.stack([fx, fy], dim=1), tq
