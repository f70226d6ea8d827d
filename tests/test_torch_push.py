"""The push-streaming rule of the one-step kernel (csrc/imb.cuh
coupled_step_kernel, K2 and K8) written plainly and held bit for bit
against the pull the plain versions take: lbm.stream +
lbm.apply_bounce_back + lbm.apply_open_boundaries.

From the source cell x, post-collision population i goes to slot i of
x + e_i (wrapped on an axis without walls); where x + e_i lies past a
wall it goes to x's own slot opp(i) plus that wall's term, the x-wall's
where it is past two. The Zou/He columns are then closed from the pushed
populations. Every destination slot must have exactly one writer. Over
walls, corners with four moving walls, periodic axes and Zou/He, on odd
lattices, in float32 and float64."""

import zlib

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import SimConfig, lattice
from lbmdem_tpu_torch.ops import lbm

CASES = [
    ("walls-lid", dict(bc_west="wall", bc_east="wall", uw_north=0.05)),
    ("walls-all-moving", dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                              uw_south=-0.02, uw_west=0.03, uw_east=-0.04)),
    ("periodic", dict(bc_south="periodic", bc_north="periodic")),
    ("periodic-x-walls-y", dict(uw_south=0.01)),
    ("zou-he-walls", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                          inlet_profile="poiseuille", uw_north=0.02)),
    ("zou-he-periodic-y", dict(bc_west="inlet", bc_east="outlet",
                               u_inlet=0.04, bc_south="periodic",
                               bc_north="periodic", rho_outlet=1.01)),
]


def _wall_term(cfg, side: str, slot: int, dtype):
    uwx, uwy = {"s": (cfg.uw_south, 0.0), "n": (cfg.uw_north, 0.0),
                "w": (0.0, cfg.uw_west), "e": (0.0, cfg.uw_east)}[side]
    return torch.as_tensor(lattice.wall_corr(slot, uwx, uwy, cfg.rho0),
                           dtype=dtype)


def push(fpost, cfg):
    """The push formulation: returns (f', writers per slot)."""
    _, ny, nx = fpost.shape
    out = torch.full_like(fpost, float("nan"))
    writers = torch.zeros(fpost.shape, dtype=torch.int64)
    y = torch.arange(ny)[:, None].expand(ny, nx)
    x = torch.arange(nx)[None, :].expand(ny, nx)
    wall = {k: getattr(cfg, "bc_" + n) == "wall"
            for k, n in (("s", "south"), ("n", "north"), ("w", "west"),
                         ("e", "east"))}
    one = torch.ones((), dtype=torch.int64)
    for i in range(9):
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        o = int(lattice.OPP[i])
        side_y = "s" if ey < 0 else ("n" if ey > 0 else None)
        side_x = "w" if ex < 0 else ("e" if ex > 0 else None)
        edge_y = {"s": y == 0, "n": y == ny - 1, None: None}[side_y]
        edge_x = {"w": x == 0, "e": x == nx - 1, None: None}[side_x]
        none = torch.zeros_like(y, dtype=torch.bool)
        past_y = edge_y if side_y and wall[side_y] else none
        past_x = edge_x if side_x and wall[side_x] else none
        past = past_x | past_y
        # streamed: slot i of x + e_i
        keep = ~past
        dy, dx = (y + ey) % ny, (x + ex) % nx
        out[i][dy[keep], dx[keep]] = fpost[i][keep]
        writers[i].index_put_((dy[keep], dx[keep]), one, accumulate=True)
        # bounced: own slot opp(i) plus the wall's term (x wall first)
        if bool(past.any()):
            ty = (_wall_term(cfg, side_y, o, fpost.dtype) if side_y
                  else torch.zeros((), dtype=fpost.dtype))
            tx = (_wall_term(cfg, side_x, o, fpost.dtype) if side_x
                  else torch.zeros((), dtype=fpost.dtype))
            val = fpost[i] + torch.where(past_x, tx, ty)
            out[o][past] = val[past]
            writers[o].index_put_((y[past], x[past]), one, accumulate=True)
    if cfg.bc_west == "inlet":  # close the open columns from the push
        u_in = torch.as_tensor(lbm.inlet_profile_array(cfg),
                               dtype=fpost.dtype)
        rho_o = torch.as_tensor(cfg.rho_outlet or cfg.rho0,
                                dtype=fpost.dtype)
        west = lbm.zou_he_inlet(tuple(out[i, :, 0] for i in range(9)), u_in)
        east = lbm.zou_he_outlet(tuple(out[i, :, -1] for i in range(9)),
                                 rho_o)
        for i, v in zip((1, 5, 8), west):
            out[i, :, 0] = v
        for i, v in zip((3, 7, 6), east):
            out[i, :, -1] = v
    return out, writers


def pull(fpost, cfg):
    return lbm.apply_open_boundaries(
        lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg)


@pytest.mark.parametrize("shape", [(7, 11), (9, 5)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label,kw", CASES, ids=[c[0] for c in CASES])
def test_push_equals_pull_bitwise(label, kw, dtype, shape):
    ny, nx = shape
    cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype=dtype, **kw)
    rng = np.random.default_rng(
        zlib.crc32(f"{label}{dtype}{shape}".encode()))
    fpost = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.1 * rng.standard_normal((9, ny, nx))), dtype=getattr(
            torch, dtype))
    got, writers = push(fpost, cfg)
    assert torch.equal(writers, torch.ones_like(writers))
    want = pull(fpost, cfg)
    assert torch.equal(got, want)
