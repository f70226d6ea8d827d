"""The row sweep of the temporal block (csrc/tblock.cuh
temporal_block_kernel, K5's body and K6's and K7's), written plainly
with K5's plain collide (`fused_fluid.collide_pairs`, cell by cell) and
pull, and held against k chained plain pure-fluid steps
(`fused_step_fluid_multi_plain`) bit for bit.

A block owns a strip of T - 2k output columns (plus k halo columns on
each side) and `rows` output rows; sweep row j is global row y0 - k + j.
At phase ph, level t collides rows [ROWS ph - LAG t, + ROWS), LAG = ROWS
+ 1, that lie in [t, h + 2k - t), at the columns [t, T - t): level 0
loads them from f (wrapped), level t > 0 pulls them from level t - 1's
ring of 2 ROWS + 2 rows (slot j mod RING). Level k streams rows [k, k +
h) into the output the same way. Every cell carries its unwrapped global
coordinate, where bounce-back and Zou/He fire. The model checks that
every row a pull reads is in its ring slot, was written in an earlier
phase and has the columns the pull needs, and that every output cell is
written once. Over walls with a moving lid, periodic axes, Zou/He
(walls and periodic y), forcing and TRT + LES, on lattices smaller than
and not a multiple of a strip; one sweep up to k = 8 (K6 and K7 run
that deep), and K5's schedule: ceil(k / SWEEP_K) sweeps of near equal
depth, as csrc/fluid.cu chains them through its unrounded f32 scratch
(up to bf16's k = 16)."""

import zlib

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import SimConfig, lattice
from lbmdem_tpu_torch.config import WALL
from lbmdem_tpu_torch.ops import fused_fluid, lbm


def _bb_terms(cfg, dtype):
    """{(side, i): term} of the half-way bounce-back
    (lbm.apply_bounce_back)."""
    sides = {"s": (lattice.IN_N, cfg.uw_south, 0.0),
             "n": (lattice.IN_S, cfg.uw_north, 0.0),
             "w": (lattice.IN_E, 0.0, cfg.uw_west),
             "e": (lattice.IN_W, 0.0, cfg.uw_east)}
    return {(side, int(i)): torch.as_tensor(
        lattice.wall_corr(int(i), uwx, uwy, cfg.rho0), dtype=dtype)
        for side, (idxs, uwx, uwy) in sides.items() for i in idxs}


def _pull(post, gy, gx, cfg, bb, u_in):
    """d2q9.cuh stream_pull of one row: post[dy + 1] is the (9, n)
    post-collision row gy + dy at the columns gx - 1 .. gx + 1 (n + 2
    entries); returns the (9, n) pulled row at the columns gx."""
    n = gx.numel()
    v = [post[1 - int(lattice.E[i, 1])][i, 1 - int(lattice.E[i, 0]):
                                         1 - int(lattice.E[i, 0]) + n]
         for i in range(9)]
    mid = post[1][:, 1:n + 1]
    opp = lattice.OPP
    rules = []
    if cfg.bc_south == WALL and gy == 0:
        rules.append(("s", lattice.IN_N, torch.ones(n, dtype=torch.bool)))
    if cfg.bc_north == WALL and gy == cfg.ny - 1:
        rules.append(("n", lattice.IN_S, torch.ones(n, dtype=torch.bool)))
    if cfg.bc_west == WALL:
        rules.append(("w", lattice.IN_E, gx == 0))
    if cfg.bc_east == WALL:
        rules.append(("e", lattice.IN_W, gx == cfg.nx - 1))
    for side, idxs, where in rules:
        for i in idxs:
            i = int(i)
            v[i] = torch.where(where, mid[int(opp[i])] + bb[(side, i)], v[i])
    if cfg.bc_west == "inlet":
        rho_o = torch.as_tensor(cfg.rho_outlet or cfg.rho0, dtype=mid.dtype)
        for col, fn, arg, slots in (
                (gx == 0, lbm.zou_he_inlet, u_in[gy % cfg.ny], (1, 5, 8)),
                (gx == cfg.nx - 1, lbm.zou_he_outlet, rho_o, (3, 7, 6))):
            if bool(col.any()):
                new = fn(tuple(x[col] for x in v), arg)
                for i, val in zip(slots, new):
                    v[i] = v[i].clone()
                    v[i][col] = val
    return torch.stack(v)


def sweep(f, cfg, k: int, T: int, rows: int, ROWS: int = 1):
    """The kernel's row sweep over every block: f' after k steps."""
    ny, nx = cfg.ny, cfg.nx
    RING, LAG = 2 * ROWS + 2, ROWS + 1
    W = T - 2 * k
    assert W >= 1 and k <= 8  # tblock.cuh kTBMaxK
    dt = f.dtype
    bb = _bb_terms(cfg, dt)
    u_in = torch.as_tensor(lbm.inlet_profile_array(cfg), dtype=dt)
    out = torch.full_like(f, float("nan"))
    writes = torch.zeros((ny, nx), dtype=torch.int64)
    for by in range(-(-ny // rows)):
        y0 = by * rows
        h = min(rows, ny - y0)
        n0 = h + 2 * k
        nph = (h + k - 1 + LAG * k) // ROWS + 1
        for bx in range(-(-nx // W)):
            gxs = bx * W - k + torch.arange(T)  # unwrapped, per lane
            ring = torch.full((k, RING, 9, T), float("nan"), dtype=dt)
            tag = [[None] * RING for _ in range(k)]  # (row, phase, lanes)

            def read(lt, j, lanes, ph):
                """Level lt's rows j - 1 .. j + 1 at lanes - 1 .. + 1."""
                rows_ = []
                lo, hi = int(lanes[0]) - 1, int(lanes[-1]) + 2
                for dy in (-1, 0, 1):
                    row, at, have = tag[lt][(j + dy) % RING]
                    assert row == j + dy and at < ph, (lt, j, dy, row, at)
                    assert have[0] <= lo and hi <= have[1], (have, lo, hi)
                    rows_.append(ring[lt, (j + dy) % RING, :, lo:hi])
                return rows_

            for ph in range(nph):
                for t in range(k):
                    for r in range(ROWS):
                        j = ROWS * ph - LAG * t + r
                        if not t <= j < n0 - t:
                            continue
                        lanes = torch.arange(t, T - t)
                        gy = y0 - k + j
                        if t == 0:
                            v = f[:, gy % ny][:, gxs[lanes] % nx]
                        else:
                            v = _pull(read(t - 1, j, lanes, ph), gy,
                                      gxs[lanes], cfg, bb, u_in)
                        v = fused_fluid.collide_pairs(v, cfg)
                        ring[t, j % RING, :, t:T - t] = v
                        tag[t][j % RING] = (j, ph, (t, T - t))
                for r in range(ROWS):  # level k: the store
                    jo = ROWS * ph - LAG * k + r
                    if not k <= jo < k + h:
                        continue
                    lanes = torch.arange(k, T - k)
                    gx = gxs[lanes]
                    keep = gx < nx
                    v = _pull(read(k - 1, jo, lanes, ph), y0 - k + jo, gx, cfg,
                              bb, u_in)
                    out[:, y0 - k + jo, gx[keep]] = v[:, keep]
                    writes[y0 - k + jo, gx[keep]] += 1
    assert torch.equal(writes, torch.ones_like(writes))
    return out


def sweeps(f, cfg, k: int, T: int, rows: int, ROWS: int = 1):
    """k steps as csrc/fluid.cu's K5 runs them: n = ceil(k / SWEEP_K)
    sweeps, the first k % n of them one step deeper."""
    n = -(-k // fused_fluid.SWEEP_K)
    for i in range(n):
        f = sweep(f, cfg, k // n + (i < k % n), T, rows, ROWS)
    return f


CASES = {
    "walls-lid": dict(bc_west="wall", bc_east="wall", uw_north=0.08,
                      uw_south=-0.02),
    "periodic": dict(bc_south="periodic", bc_north="periodic", gx=1e-5,
                     gy=-2e-5),
    "periodic-x-walls-y": dict(gx=2e-5),
    "zou-he": dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                   inlet_profile="poiseuille", uw_north=0.02),
    "zou-he-periodic-y": dict(bc_west="inlet", bc_east="outlet",
                              u_inlet=0.05, bc_south="periodic",
                              bc_north="periodic", rho_outlet=1.01),
    "trt-les": dict(collision="trt", smagorinsky=0.16, gx=1e-5,
                    bc_west="wall", bc_east="wall", uw_north=0.05),
}

# (k, threads per level T, output rows per block, rows per level and
# phase, lattice (ny, nx), K5's schedule of sweeps or one sweep); every
# lattice is narrower than a strip or no multiple of one
SWEEPS = [(1, 16, 5, 1, (13, 21), False), (2, 16, 4, 1, (9, 30), False),
          (4, 16, 3, 1, (13, 21), False), (4, 32, 7, 2, (9, 30), False),
          (8, 32, 5, 1, (13, 21), False), (8, 32, 4, 2, (9, 30), False),
          (7, 32, 6, 1, (9, 30), True), (16, 32, 5, 2, (13, 21), True)]


@pytest.mark.parametrize("sweep_args", SWEEPS, ids=[
    f"k{k}-T{t}-r{r}-R{rr}-{s[0]}x{s[1]}{'-k5' if k5 else ''}"
    for k, t, r, rr, s, k5 in SWEEPS])
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_sweep_equals_chained_steps(case, sweep_args):
    """k chained plain steps, f32 (TRT + LES in f64), torch.equal."""
    k, T, rows, ROWS, (ny, nx), k5 = sweep_args
    kw = CASES[case]
    dtype = "float64" if case == "trt-les" else "float32"
    cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype=dtype, **kw)
    rng = np.random.default_rng(zlib.crc32(f"{case}{sweep_args}".encode()))
    f = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, ny, nx))),
        dtype=getattr(torch, dtype))
    got = (sweeps if k5 else sweep)(f, cfg, k, T, rows, ROWS)
    want = fused_fluid.fused_step_fluid_multi_plain(f, cfg, k,
                                                    torch.empty_like(f))
    assert torch.equal(got, want)
    assert float((want - f).abs().max()) > 0
