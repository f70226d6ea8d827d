"""Plain reference of the coupled D2Q9 LBM-DEM solver, in PyTorch.

The benchmark's yardstick for `correct`: the same semantics as the
program under test, written as straightforward tensor code, with no
kernel, no Verlet cadence, no slab layout and nothing the program made.
It is a frozen copy of the solver's plain formulas (the D2Q9 lattice,
BGK collide with Guo forcing, pull streaming, half-way bounce-back at
resting walls; the Noble-Torczynski blend with "sample" coverage, the
coverage-weighted force and torque gather; the spring-dashpot DEM with
Coulomb-capped tangential dashpot, wall contacts, gravity with
buoyancy, n_sub velocity-Verlet substeps on a cell-list broadphase;
fixed disks, of infinite mass and inertia, which no force moves, and a
bed of fixed disks at rest, whose solid is stamped once and whose
forces feed back into nothing), taken from
`lbmdem_tpu_torch/ops/{lbm,imb,dem}.py` at commit caccc23. It imports
neither the program nor JAX.

Options outside that set (TRT, LES, history springs, disks whose stamp
window crosses a periodic edge, fixed disks that move, open
boundaries, moving walls, ramp or exact coverage, the "lambda" blend)
raise NotImplementedError: a configuration that needs them brings a
reference of its own.

    p = Params.from_sim(sim_dict)
    f = equilibrium_rest(p, device)           # or a given start f
    disks = make_disks(x, y, r, vx, vy, omega, p, device, fixed=None)
    f, disks, info = advance(f, disks, p, steps, coupling_k)
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

# D2Q9: e_i, w_i and the opposite index of each direction
E = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1], [1, 1], [-1, 1],
              [-1, -1], [1, -1]], dtype=np.int64)
W = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=np.float64)
OPP = [0, 3, 4, 1, 2, 7, 8, 5, 6]
IN_E, IN_W, IN_N, IN_S = (1, 5, 8), (3, 6, 7), (2, 5, 6), (4, 7, 8)
EPS_MIN = 1e-7

# the SimConfig fields this reference implements, with the only value
# it takes where it takes one
_FIXED = {"collision": "bgk", "smagorinsky": 0.0, "kt": 0.0,
          "eps_method": "sample", "eps_r_shift": 0.0, "nt_mode": "nt",
          "uw_west": 0.0, "uw_east": 0.0, "uw_south": 0.0, "uw_north": 0.0,
          "u0x": 0.0, "u0y": 0.0}
_FREE = ("nx", "ny", "tau", "gx", "gy", "bc_west", "bc_east", "bc_south",
         "bc_north", "rho_s", "kn", "gamma_n", "gamma_t", "mu", "n_sub",
         "g_px", "g_py", "buoyancy", "contact_cap", "eps_samples", "dtype",
         "rho0", "max_disks", "f_storage", "out_interval", "coupling_k",
         "steps", "paranoia")


@dataclasses.dataclass(frozen=True)
class Params:
    """What the reference reads of a configuration (lattice units)."""

    nx: int
    ny: int
    tau: float
    gx: float
    gy: float
    walls: tuple  # (west, east, south, north) True where a wall
    rho0: float
    rho_s: float
    kn: float
    gamma_n: float
    gamma_t: float
    mu: float
    n_sub: int
    g_px: float
    g_py: float
    buoyancy: bool
    eps_samples: int
    dtype: torch.dtype

    @staticmethod
    def from_sim(sim: dict) -> "Params":
        """From a configuration's "sim" table (SimConfig's fields, each
        stated). Raises NotImplementedError for options outside this
        reference and KeyError for a field the table leaves out."""
        for k, v in sim.items():
            if k in _FIXED:
                if v != _FIXED[k]:
                    raise NotImplementedError(f"reference: {k}={v!r}")
            elif k not in _FREE:
                raise NotImplementedError(f"reference: unknown field {k!r}")
        for side in ("bc_west", "bc_east", "bc_south", "bc_north"):
            if sim[side] not in ("wall", "periodic"):
                raise NotImplementedError(f"reference: {side}={sim[side]!r}")
        walls = tuple(sim[s] == "wall" for s in
                      ("bc_west", "bc_east", "bc_south", "bc_north"))
        return Params(
            nx=int(sim["nx"]), ny=int(sim["ny"]), tau=float(sim["tau"]),
            gx=float(sim["gx"]), gy=float(sim["gy"]), walls=walls,
            rho0=float(sim["rho0"]), rho_s=float(sim.get("rho_s", 0.0)),
            kn=float(sim.get("kn", 0.0)),
            gamma_n=float(sim.get("gamma_n", 0.0)),
            gamma_t=float(sim.get("gamma_t", 0.0)),
            mu=float(sim.get("mu", 0.0)), n_sub=int(sim.get("n_sub", 1)),
            g_px=float(sim.get("g_px", 0.0)),
            g_py=float(sim.get("g_py", 0.0)),
            buoyancy=bool(sim.get("buoyancy", False)),
            eps_samples=int(sim.get("eps_samples", 4)),
            dtype={"float32": torch.float32,
                   "float64": torch.float64}[sim["dtype"]])


def _c(a, like: torch.Tensor) -> torch.Tensor:
    """A (9, 1, 1) lattice constant in like's dtype and device."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32),
                           dtype=like.dtype, device=like.device)[:, None, None]


def _ex(like):
    return _c(E[:, 0], like)


def _ey(like):
    return _c(E[:, 1], like)


def _w(like):
    return torch.as_tensor(W, dtype=like.dtype,
                           device=like.device)[:, None, None]


# --- fluid -----------------------------------------------------------

def equilibrium(rho, ux, uy):
    """f_eq_i = w_i rho [1 + 3 e.u + 9/2 (e.u)^2 - 3/2 u^2]."""
    eu = _ex(rho) * ux + _ey(rho) * uy
    usq = ux * ux + uy * uy
    return _w(rho) * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq)


def equilibrium_rest(p: Params, device) -> torch.Tensor:
    """The start of a scene at rest: f_eq(rho0, 0) everywhere."""
    shape = (p.ny, p.nx)
    rho = torch.full(shape, p.rho0, dtype=p.dtype, device=device)
    zero = torch.zeros(shape, dtype=p.dtype, device=device)
    return equilibrium(rho, zero, zero)


def moments(f, gx: float, gy: float):
    """rho = sum f_i; u = (sum f_i e_i + F/2) / rho."""
    rho = torch.sum(f, dim=0)
    inv = 1.0 / rho
    ux = (torch.sum(f * _ex(f), dim=0) + 0.5 * gx) * inv
    uy = (torch.sum(f * _ey(f), dim=0) + 0.5 * gy) * inv
    return rho, ux, uy


def guo(ux, uy, tau: float, gx: float, gy: float):
    """Guo's source (1 - 1/(2 tau)) w_i [3 (e_i - u) + 9 (e_i.u) e_i].F."""
    ex, ey = _ex(ux), _ey(ux)
    eu = ex * ux + ey * uy
    proj = 3.0 * ((ex - ux) * gx + (ey - uy) * gy) + 9.0 * eu * (
        ex * gx + ey * gy)
    return (1.0 - 0.5 / tau) * (_w(ux) * proj)


def collide(f, p: Params):
    """BGK relaxation with Guo forcing (pure fluid)."""
    rho, ux, uy = moments(f, p.gx, p.gy)
    feq = equilibrium(rho, ux, uy)
    post = f - (f - feq) / p.tau
    if p.gx != 0.0 or p.gy != 0.0:
        post = post + guo(ux, uy, p.tau, p.gx, p.gy)
    return post


def stream(post):
    """Pull streaming with periodic wrap: f_i(x) = post_i(x - e_i)."""
    return torch.stack([torch.roll(post[i], shifts=(int(E[i, 1]),
                                                    int(E[i, 0])),
                                   dims=(0, 1)) for i in range(9)])


def bounce_back(fnew, post, p: Params):
    """Half-way bounce-back at the resting walls, south, north, west,
    east in that order (the x walls win at a corner)."""
    west, east, south, north = p.walls
    for on, idxs, sl in ((south, IN_N, (0, slice(None))),
                         (north, IN_S, (p.ny - 1, slice(None))),
                         (west, IN_E, (slice(None), 0)),
                         (east, IN_W, (slice(None), p.nx - 1))):
        if on:
            for i in idxs:
                fnew[i][sl] = post[OPP[i]][sl]
    return fnew


def fluid_step(f, p: Params):
    """One pure-fluid step: collide, stream, bounce back."""
    post = collide(f, p)
    return bounce_back(stream(post), post, p)


# --- solid coupling ----------------------------------------------------

def window_cells(r_max: float) -> int:
    """A stamp window (cells per axis) that covers a disk of radius
    r_max from the cell nearest its centre, with a cell of slack."""
    return 2 * (int(math.ceil(r_max + 0.5)) + 1) + 1


def coverage(x, y, r, window: int, ns: int):
    """Sample coverage of each disk's window cells: (cov (N, W, W), by,
    bx); cov[n, a, b] is the share of ns x ns sample points of cell
    (by + a, bx + b) inside disk n (a point is inside where dx^2 <= r^2 -
    dy^2)."""
    dt = x.dtype
    half = window // 2
    bx = torch.floor(x + 0.5).to(torch.int32) - half
    by = torch.floor(y + 0.5).to(torch.int32) - half
    cells = torch.arange(window, dtype=dt, device=x.device)
    offs = (torch.arange(ns, dtype=dt, device=x.device) + 0.5) / ns - 0.5
    px = ((bx.to(dt)[:, None, None] + cells[None, :, None])
          + offs[None, None, :]) - x[:, None, None]
    py = ((by.to(dt)[:, None, None] + cells[None, :, None])
          + offs[None, None, :]) - y[:, None, None]
    t = r[:, None, None] * r[:, None, None] - py * py
    inside = (px * px)[:, None, :, None, :] <= t[:, :, None, :, None]
    return torch.mean(inside.to(dt), dim=(3, 4)), by, bx


def _cells(by, bx, window: int, p: Params):
    """Each window cell's clipped (iy, ix) and whether it is inside."""
    ar = torch.arange(window, dtype=torch.int64, device=by.device)
    iy = (by.to(torch.int64)[:, None, None] + ar[None, :, None]).expand(
        -1, window, window)
    ix = (bx.to(torch.int64)[:, None, None] + ar[None, None, :]).expand(
        -1, window, window)
    valid = (iy >= 0) & (iy < p.ny) & (ix >= 0) & (ix < p.nx)
    return iy.clamp(0, p.ny - 1), ix.clamp(0, p.nx - 1), valid


def stamp(d: "Disks", p: Params, window: int):
    """(eps_raw, us_x, us_y) (ny, nx): the summed coverage and the
    coverage-weighted rigid-body velocity v + omega x r."""
    dt = d.x.dtype
    cov, by, bx = coverage(d.x[:, 0], d.x[:, 1], d.r, window, p.eps_samples)
    iy, ix, valid = _cells(by, bx, window, p)
    cov = torch.where(valid, cov, torch.zeros_like(cov))
    relx = ix.to(dt) - d.x[:, 0, None, None]
    rely = iy.to(dt) - d.x[:, 1, None, None]
    om = d.omega[:, None, None]
    usx = d.v[:, 0, None, None] + om * (-rely)
    usy = d.v[:, 1, None, None] + om * relx
    vals = torch.stack([cov, cov * usx, cov * usy], dim=-1).reshape(-1, 3)
    fields = torch.zeros((p.ny * p.nx, 3), dtype=dt, device=d.x.device)
    fields.index_add_(0, (iy * p.nx + ix).reshape(-1), vals)
    fields = fields.reshape(p.ny, p.nx, 3)
    eps = fields[..., 0]
    inv = 1.0 / torch.clamp(eps, min=EPS_MIN)
    return eps, fields[..., 1] * inv, fields[..., 2] * inv


def collide_nt(f, eps_raw, usx, usy, p: Params):
    """The Noble-Torczynski blend of BGK and the solid's bounce-back
    term, and the force per cell on the solid phase:
    f' = f - (1-B)[(f - f_eq)/tau - S] + B Omega, Omega_i = f_opp - f_i
    + f_eq_i(rho, u_s) - f_eq_opp(rho, u), B = eps (tau - 1/2) / ((1 -
    eps) + tau - 1/2), phi = -sum_i B Omega_i e_i."""
    rho, ux, uy = moments(f, p.gx, p.gy)
    feq = equilibrium(rho, ux, uy)
    eps = torch.clamp(eps_raw, 0.0, 1.0)
    tm = p.tau - 0.5
    B = eps * tm / ((1.0 - eps) + tm)
    omega = f[OPP] - f + equilibrium(rho, usx, usy) - feq[OPP]
    post = f - (1.0 - B) * (f - feq) / p.tau + B * omega
    if p.gx != 0.0 or p.gy != 0.0:
        post = post + (1.0 - B) * guo(ux, uy, p.tau, p.gx, p.gy)
    phix = -torch.sum(B * omega * _ex(f), dim=0)
    phiy = -torch.sum(B * omega * _ey(f), dim=0)
    return post, phix, phiy


def hydro_forces(d: "Disks", eps_raw, phix, phiy, p: Params, window: int):
    """Per-disk force (N, 2) and torque (N,): phi over the disk's window
    cells, each weighted by the disk's share of the cell's coverage."""
    dt = phix.dtype
    fields = torch.stack([eps_raw, phix, phiy], dim=-1)
    cov, by, bx = coverage(d.x[:, 0], d.x[:, 1], d.r, window, p.eps_samples)
    iy, ix, valid = _cells(by, bx, window, p)
    g = fields[iy, ix]
    tot = torch.where(valid, g[..., 0], torch.ones_like(g[..., 0]))
    share = cov * valid.to(dt) / torch.clamp(tot, min=EPS_MIN)
    fx = g[..., 1] * share
    fy = g[..., 2] * share
    relx = ix.to(dt) - d.x[:, 0, None, None]
    rely = iy.to(dt) - d.x[:, 1, None, None]
    F = torch.stack([fx.sum(dim=(1, 2)), fy.sum(dim=(1, 2))], dim=1)
    return F, torch.sum(relx * fy - rely * fx, dim=(1, 2))


# --- DEM ---------------------------------------------------------------

class Disks(NamedTuple):
    """Disk state; every disk active. `fixed` (N,) bool marks the disks
    of infinite mass and inertia; None where every disk is mobile."""

    x: torch.Tensor  # (N, 2)
    v: torch.Tensor  # (N, 2)
    theta: torch.Tensor
    omega: torch.Tensor
    r: torch.Tensor
    mass: torch.Tensor
    inertia: torch.Tensor
    fixed: Optional[torch.Tensor] = None


def make_disks(x, y, r, vx, vy, omega, p: Params, device,
               fixed=None) -> Disks:
    """Disks from float64 numpy arrays: positions, velocities and spin in
    the configuration's dtype, mass rho_s pi r^2 and inertia m r^2 / 2
    worked out in float64 and rounded once; `fixed`, a bool array, marks
    fixed disks (kept only where some disk is fixed)."""
    nd = np.dtype({torch.float32: "float32", torch.float64: "float64"}
                  [p.dtype])
    mass = p.rho_s * np.pi * r * r
    inertia = 0.5 * mass * r * r

    def t(a):
        return torch.as_tensor(np.asarray(a).astype(nd), device=device)

    n = len(x)
    fixed = (None if fixed is None or not np.any(fixed)
             else torch.as_tensor(np.asarray(fixed, dtype=bool),
                                  device=device))
    return Disks(x=t(np.stack([x, y], 1)), v=t(np.stack([vx, vy], 1)),
                 theta=t(np.zeros(n)), omega=t(omega), r=t(r), mass=t(mass),
                 inertia=t(inertia), fixed=fixed)


def _sqrt(x):
    """sqrt rounded once to x's precision (float32 through float64)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def neighbour_pairs(d: Disks, skin: float = 1.0):
    """(N, S) candidate partners with surface gap <= skin, -1 padded,
    found on a uniform grid of cells of side 2 r_max + skin (each disk
    against its 3 x 3 cell patch). Exact: no capacity limits."""
    dev = d.x.device
    n = d.x.shape[0]
    cell = 2.0 * float(d.r.max()) + skin
    cx = torch.floor((d.x[:, 0] + 0.5) / cell).to(torch.int64)
    cy = torch.floor((d.x[:, 1] + 0.5) / cell).to(torch.int64)
    cx, cy = cx - cx.min(), cy - cy.min()
    # a ring of empty cells around the occupied ones: no patch wraps
    ncx = int(cx.max()) + 3
    ncell = (int(cy.max()) + 3) * ncx
    cid = (cy + 1) * ncx + (cx + 1)
    order = torch.argsort(cid, stable=True)
    scid = cid[order]
    start = torch.searchsorted(scid, torch.arange(ncell, device=dev))
    count = torch.bincount(scid, minlength=ncell)
    kmax = int(count.max())
    ar = torch.arange(kmax, device=dev)
    cands = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            c = cid + dy * ncx + dx
            s, m = start[c], count[c]
            idx = (s[:, None] + ar[None, :]).clamp(max=n - 1)
            cands.append(torch.where(ar[None, :] < m[:, None], order[idx], -1))
    cand = torch.cat(cands, dim=1)
    cand = torch.where(cand == torch.arange(n, device=dev)[:, None], -1,
                       cand)
    j = cand.clamp(min=0)
    dd = d.x[:, None, :] - d.x[j]
    reach = d.r[:, None] + d.r[j] + skin
    keep = (cand >= 0) & (torch.sum(dd * dd, -1) <= reach * reach)
    width = max(int(keep.sum(1).max()), 1)
    order2 = torch.sort(keep.to(torch.uint8), dim=1, descending=True,
                        stable=True).indices[:, :width]
    return torch.where(torch.gather(keep, 1, order2),
                       torch.gather(cand, 1, order2), -1)


def pair_force(xi, vi, omi, ri, xj, vj, omj, rj, mask, p: Params):
    """Spring-dashpot force and torque on i from j (n from j to i): fn =
    kn delta - gamma_n v_n, ft = clip(-gamma_t v_t, +-mu |fn|).
    Returns (F, T, touching)."""
    dvec = xi - xj
    dist = torch.clamp(_sqrt(torch.sum(dvec * dvec, dim=-1)), min=1e-12)
    delta = ri + rj - dist
    touching = mask & (delta > 0)
    n = dvec / dist[..., None]
    t = torch.stack([-n[..., 1], n[..., 0]], dim=-1)
    li = ri - 0.5 * delta
    lj = rj - 0.5 * delta
    vrel = vi - vj - (omi * li + omj * lj)[..., None] * t
    vn = torch.sum(vrel * n, dim=-1)
    vt = torch.sum(vrel * t, dim=-1)
    fn = p.kn * delta - p.gamma_n * vn
    cap = p.mu * torch.abs(fn)
    ft = torch.clamp(-p.gamma_t * vt, -cap, cap)
    zero = torch.zeros((), dtype=fn.dtype, device=fn.device)
    fn = torch.where(touching, fn, zero)
    ft = torch.where(touching, ft, zero)
    return fn[..., None] * n + ft[..., None] * t, -li * ft, touching


def contact_forces(d: Disks, cand, p: Params):
    """Disk-disk and disk-wall forces, torques and the number of
    disk-disk contacts (each counted once)."""
    j = cand.clamp(min=0)
    F, T, touching = pair_force(
        d.x[:, None, :], d.v[:, None, :], d.omega[:, None], d.r[:, None],
        d.x[j], d.v[j], d.omega[j], d.r[j], cand >= 0, p)
    F, T = F.sum(dim=1), T.sum(dim=1)
    nc = torch.sum(touching, dtype=torch.int32) // 2
    zero = torch.zeros_like(d.omega)
    on = torch.ones_like(d.omega, dtype=torch.bool)
    for wall, pos, axis in zip(p.walls, (-0.5, p.nx - 0.5, -0.5, p.ny - 0.5),
                               (0, 0, 1, 1)):
        if wall:
            xj = d.x.clone()
            xj[:, axis] = pos
            Fw, Tw, _ = pair_force(d.x, d.v, d.omega, d.r, xj,
                                   torch.zeros_like(d.v), zero, zero, on, p)
            F = F + Fw
            T = T + Tw
    return F, T, nc


def body_forces(d: Disks, p: Params):
    """Gravity, less the displaced fluid's weight under buoyancy."""
    m = d.mass - p.rho0 * math.pi * d.r * d.r if p.buoyancy else d.mass
    return torch.stack([m * p.g_px, m * p.g_py], dim=1)


def dem_step(d: Disks, fh, th, p: Params):
    """One LBM step of disk motion: n_sub velocity-Verlet substeps of
    kick-drift, force, kick under the hydrodynamic, contact and body
    forces; the neighbour list holds for the step (disks travel far
    less than the skin). A fixed disk's inverse mass and inertia are 0.
    Returns (disks, contacts)."""
    h = 1.0 / p.n_sub
    cand = neighbour_pairs(d)
    body = body_forces(d, p)

    def force(s):
        Fc, Tc, nc = contact_forces(s, cand, p)
        return Fc + fh + body, Tc + th, nc

    inv_m = (1.0 / d.mass)[:, None]
    inv_i = 1.0 / d.inertia
    if d.fixed is not None:
        inv_m = torch.where(d.fixed[:, None], 0.0, inv_m)
        inv_i = torch.where(d.fixed, 0.0, inv_i)
    F, T, nc = force(d)
    for _ in range(p.n_sub):
        vh = d.v + (0.5 * h) * F * inv_m
        omh = d.omega + (0.5 * h) * T * inv_i
        d = d._replace(x=d.x + h * vh, theta=d.theta + h * omh)
        F, T, n2 = force(d._replace(v=vh, omega=omh))
        d = d._replace(v=vh + (0.5 * h) * F * inv_m,
                       omega=omh + (0.5 * h) * T * inv_i)
        nc = torch.maximum(nc, n2)
    return d, nc


# --- the run -----------------------------------------------------------

def _fixed_at_rest(d: Disks) -> bool:
    """Whether every disk is fixed; raises NotImplementedError for a
    fixed disk that moves (a prescribed motion)."""
    if d.fixed is None:
        return False
    if bool((d.v[d.fixed] != 0).any() | (d.omega[d.fixed] != 0).any()):
        raise NotImplementedError("reference: fixed disks that move")
    return bool(d.fixed.all())


def _check_seams(d: Disks, p: Params, window: int) -> None:
    """Raise NotImplementedError where a disk's stamp window crosses a
    periodic edge (the program would stamp a ghost there)."""
    half = window // 2
    for axis, n, periodic in ((0, p.nx, not p.walls[0]),
                              (1, p.ny, not p.walls[2])):
        lo = torch.floor(d.x[:, axis] + 0.5) - half
        if periodic and bool(((lo < 0) | (lo + window > n)).any()):
            raise NotImplementedError(
                "reference: a disk's window crosses a periodic edge")


def advance(f, d: Optional[Disks], p: Params, steps: int,
            coupling_k: int = 1):
    """`steps` steps from (f, d). Without disks: pure fluid. With disks:
    windows of coupling_k steps, each stamping the solid once from the
    window-start disks, then coupling_k coupled fluid steps over that
    solid (collide, stream, bounce back, forces from each step's phi at
    the window-start positions), then coupling_k DEM steps, the t-th
    under the t-th step's forces (coupling_k = 1: exact per-step
    coupling). Every disk fixed at rest: one stamp for the whole run and
    coupled fluid steps over it, with no force gather and no DEM (the
    forces move nothing). Returns (f, d, {"contacts": of the last DEM
    step, 0 on a fixed bed})."""
    if d is None:
        for _ in range(steps):
            f = fluid_step(f, p)
        return f, d, {}
    window = window_cells(float(d.r.max()))
    _check_seams(d, p, window)
    if _fixed_at_rest(d):
        eps, usx, usy = stamp(d, p, window)
        for _ in range(steps):
            post, _, _ = collide_nt(f, eps, usx, usy, p)
            f = bounce_back(stream(post), post, p)
            del post
        return f, d, {"contacts": 0}
    if steps % coupling_k:
        raise ValueError("steps must be a multiple of coupling_k")
    nc = torch.zeros((), dtype=torch.int32, device=f.device)
    for _ in range(steps // coupling_k):
        eps, usx, usy = stamp(d, p, window)
        forces = []
        for _ in range(coupling_k):
            post, phix, phiy = collide_nt(f, eps, usx, usy, p)
            f = bounce_back(stream(post), post, p)
            del post
            forces.append(hydro_forces(d, eps, phix, phiy, p, window))
        for fh, th in forces:
            d, nc = dem_step(d, fh, th, p)
    return f, d, {"contacts": int(nc)}


def solid_cells(d: Disks, p: Params) -> int:
    """Lattice cells with some coverage at the disks' positions."""
    eps, _, _ = stamp(d, p, window_cells(float(d.r.max())))
    return int((eps > 0).sum())
