"""K5 on pre-haloed frames deeper than one row sweep (f32 k 5-8, bf16
k 5-16) and the sharded fluid step at temporal_k = 8, on the CPU,
against the JAX package.

- The plain K5 on a frame (`fused_step_fluid_multi(prehalo=...)`, what
  the kernel's chained sweeps compute) against the interpret-mode Pallas
  `fused_step_fluid_multi(f_ext, local_cfg, k, prehalo=..., edges=...,
  ny_glob=...)` at the smallest legal shard (64 x 128): modes "y" and
  "yx", walls with a moving lid, a Zou/He channel on shards off row 0.
  Bars: f32 5e-6, bf16 3e-4 (the reference's fused-step bars,
  `__graft_entry__.py`).
- `make_sharded_step(..., use_kernels=True, temporal_k=8)` on 2 x 2 and
  4 x 1 CPU meshes (the kernels' plain versions), 2 passes, against the
  JAX `make_sharded_step(..., True, temporal_k=8)` on its 8-device CPU
  mesh. Bar 1e-6, the bar of tests/test_sharding.py's temporal-block
  test; and against 16 single steps of one device.
- K5's schedule on a frame (csrc/fluid.cu launch_multi_prehalo) written
  plainly: ceil(k / 4) sweeps, each keeping only the interior and the
  rings the later sweeps' cone reads, every other scratch cell NaN, equal
  to k steps of the whole frame under torch.equal; and k past the
  frame's halo rows a ValueError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import lbm as jlbm, pallas_lbm as pk
from lbmdem_tpu.parallel import (make_mesh as jmake_mesh,
                                 make_sharded_step as jsharded_step,
                                 shard_state as jshard_state)
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu_torch import Simulation
from lbmdem_tpu_torch.ops import fused_fluid
from lbmdem_tpu_torch.parallel import make_mesh, make_sharded_step

from torch_parity_util import npy, perturbed_f, to_torch_cfg, tt

H, W = 64, 128  # the smallest legal shard
WALLS = dict(bc_west="wall", bc_east="wall", uw_north=0.04, gy=-1e-5)
ZOU_HE = dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
              inlet_profile="poiseuille")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _frame(cfg, mode, seed):
    """A seeded frame (9, H + 2 hy, W [+ 256]) in storage form, as one
    torch tensor and one jnp array of the same values."""
    tcfg = to_torch_cfg(cfg)
    f = perturbed_f(fused_fluid.frame_shape(tcfg, mode), seed, np.float32,
                    amp=0.05)
    if cfg.f_storage != "bfloat16":
        return tt(f), jnp.asarray(f)
    g = (tt(f) - tt(np.asarray(jlbm.storage_shift(cfg)))).to(torch.bfloat16)
    return g, jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)


# (storage, mode, lattice options, edges (south, north, west, east,
# global row offset of ny_glob = 4 H rows), k)
CASES = [
    ("float32", "y", "walls", (1, 1, 1, 1, 0), 5),
    ("float32", "yx", "walls", (1, 0, 0, 1, 0), 8),
    ("float32", "y", "zou-he", (0, 0, 1, 1, H), 5),
    ("float32", "yx", "zou-he", (0, 1, 1, 0, 3 * H), 8),
    ("bfloat16", "y", "walls", (0, 1, 1, 1, 3 * H), 8),
    ("bfloat16", "yx", "walls", (1, 0, 1, 0, 0), 16),
    ("bfloat16", "y", "zou-he", (0, 0, 1, 1, 2 * H), 16),
    ("bfloat16", "yx", "zou-he", (0, 0, 1, 0, H), 8),
]
IDS = [f"{s[:4]}-{m}-{o}-{''.join(map(str, e[:4]))}-k{k}"
       for s, m, o, e, k in CASES]


@pytest.mark.parametrize("storage,mode,opt,edges,k", CASES, ids=IDS)
def test_k5_deep_frame_matches_pallas(storage, mode, opt, edges, k):
    """K5 on a frame with k past one sweep: k inner steps in f32 with the
    walls and Zou/He closures of the shard's global edges at every step,
    one rounding on bf16."""
    cfg = JCfg(nx=W, ny=H, tau=0.7, dtype="float32", f_storage=storage,
               **(ZOU_HE if opt == "zou-he" else WALLS))
    f, jf = _frame(cfg, mode, 10 + k)
    want = pk.fused_step_fluid_multi(
        jf, cfg, k, prehalo=True if mode == "y" else "yx",
        edges=jnp.asarray(edges, jnp.int32), ny_glob=4 * H)
    out = torch.empty((9, H, W), dtype=f.dtype)
    got = fused_fluid.fused_step_fluid_multi(f, to_torch_cfg(cfg), k, out,
                                             prehalo=mode, edges=edges,
                                             ny_glob=4 * H)
    assert got is out and got.dtype == f.dtype
    bar = 3e-4 if storage == "bfloat16" else 5e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=bar)


def test_k5_deep_frame_limits():
    """k past the frame's halo rows (8 on f32, 16 on bf16) is a
    ValueError, as the one-device K5 gives outside its range."""
    cfg = to_torch_cfg(JCfg(nx=W, ny=H, tau=0.7, dtype="float32"))
    f = torch.zeros(fused_fluid.frame_shape(cfg, "y"))
    with pytest.raises(ValueError, match="outside 1..8"):
        fused_fluid.fused_step_fluid_multi(f, cfg, 9, torch.empty(9, H, W),
                                           prehalo="y", edges=(1, 1, 1, 1))
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    with pytest.raises(ValueError, match="outside 1..8"):
        make_sharded_step(cfg.replace(ny=128, nx=256), None, mesh, True,
                          temporal_k=9)
    bcfg = cfg.replace(ny=128, nx=256, f_storage="bfloat16")
    make_sharded_step(bcfg, None, mesh, True, temporal_k=16)
    with pytest.raises(ValueError, match="outside 1..16"):
        make_sharded_step(bcfg, None, mesh, True, temporal_k=17)


FLUID = dict(nx=256, ny=64, tau=0.7, gy=-1e-5, dtype="float32",
             bc_west="wall", bc_east="wall", uw_north=0.05)


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)])
def test_sharded_step_k8_matches_jax_mesh(dims):
    """Two passes of make_sharded_step(temporal_k=8) - one exchange per 8
    steps, the walls and the moving lid in the kernel by the shards' edge
    flags - against the JAX sharded Pallas step at temporal_k = 8
    (interpret mode, the 8-device CPU mesh of tests/conftest.py), and
    against 16 single steps of one device: atol 1e-6."""
    jcfg = JCfg(**FLUID)
    js = JSim(jcfg, use_pallas=True)
    jmesh = jmake_mesh(jax.devices()[:dims[0] * dims[1]], dims)
    jstep = jax.jit(jsharded_step(js.cfg, None, jmesh, use_pallas=True,
                                  temporal_k=8))
    jst = jshard_state(js.state, jmesh)
    sh = Simulation(to_torch_cfg(jcfg),
                    mesh=make_mesh(["cpu"] * (dims[0] * dims[1]), dims))
    one = Simulation(to_torch_cfg(jcfg), device="cpu")
    step = make_sharded_step(sh.cfg, None, sh.mesh, True, temporal_k=8)
    for _ in range(2):
        jst = jstep(jst)
        sh._advance(step)
    for _ in range(16):
        one.step()
    got = sh.state
    assert int(got.step) == int(jst.step) == 16
    np.testing.assert_allclose(npy(got.f), np.asarray(jst.f), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(npy(got.f), npy(one.state.f), rtol=0,
                               atol=1e-6)


def _sweep_chain(g, cfg, k, mode, edges, ny_glob, shift):
    """K5's schedule on a frame (csrc/fluid.cu launch_multi_prehalo),
    written plainly: ceil(k / SWEEP_K) sweeps of near equal depth, each
    but the last keeping only the interior and the `rest` rings the later
    sweeps' cone reads ("y" mode: rows only) in an f32 frame whose other
    cells are NaN, as the kernel's scratch leaves them unwritten."""
    hy, hx = fused_fluid.frame_hy(cfg), fused_fluid.HX if mode == "yx" else 0
    n = -(-k // fused_fluid.SWEEP_K)
    rest = k
    for i in range(n):
        ki = k // n + (i < k % n)
        rest -= ki
        g = fused_fluid.frame_steps_plain(
            g, cfg, ki, mode, edges, ny_glob,
            lambda a, t: fused_fluid.collide_pairs(a, cfg, shift), shift)
        if rest:
            keep = torch.full_like(g, float("nan"))
            rows = slice(hy - rest, hy + cfg.ny + rest)
            cols = (slice(hx - rest, hx + cfg.nx + rest) if mode == "yx"
                    else slice(None))
            keep[:, rows, cols] = g[:, rows, cols]
            g = keep
    return fused_fluid.frame_interior(g, cfg, mode)


@pytest.mark.parametrize("storage,mode,opt,edges,k", CASES + [
    ("float32", "yx", "walls", (0, 0, 0, 0, H), 7),
    ("bfloat16", "yx", "zou-he", (1, 0, 1, 0, 0), 13),
    ("bfloat16", "y", "walls", (1, 1, 1, 1, 0), 10)], ids=IDS + [
    "floa-yx-walls-0000-k7", "bflo-yx-zou-he-1010-k13",
    "bflo-y-walls-1111-k10"])
def test_k5_deep_frame_sweep_cones(storage, mode, opt, edges, k):
    """The chained sweeps' scratch frames hold enough of the cone: with
    every cell outside the kept rings NaN, the interior after the chain
    equals k steps of the whole frame under torch.equal."""
    cfg = to_torch_cfg(JCfg(nx=W, ny=H, tau=0.7, dtype="float32",
                            f_storage=storage,
                            **(ZOU_HE if opt == "zou-he" else WALLS)))
    f, _ = _frame(cfg, mode, 30 + k)
    g, shift = fused_fluid.compute_form(f, cfg)
    want = fused_fluid.frame_interior(
        fused_fluid.frame_steps_plain(
            g, cfg, k, mode, edges, 4 * H,
            lambda a, t: fused_fluid.collide_pairs(a, cfg, shift), shift),
        cfg, mode)
    got = _sweep_chain(g, cfg, k, mode, edges, 4 * H, shift)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
