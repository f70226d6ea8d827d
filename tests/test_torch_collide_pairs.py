"""The pair-form pure-fluid collide of K4 and K5 (`fused_fluid.collide_pairs`,
csrc/d2q9.cuh fluid_collide_t) on the CPU against the JAX package.

- collide_pairs against the uncoupled branch of the JAX kernels'
  `pallas_lbm._collide_window` on the same seeded planes, for every
  BGK/TRT x LES x forced combination, on physical and on bf16-shifted
  populations: atol 1e-7 + rtol 1e-6.
- The plain K4 and K5 (halo-free, on pre-haloed frames, and on frames
  deeper than one sweep) against the interpret-mode Pallas
  `fused_step_fluid` / `fused_step_fluid_multi`: f32 atol 5e-6, bf16
  3e-4 (one bf16 ulp of |g| <~ 0.06).
- The trt validation leg on the CPU (`validate.trt("cpu")`): TRT with
  Lambda = 3/16 holds body-force Poiseuille within 2e-4 of the parabola
  and BGK's slip error is over 50 times TRT's; the leg raises where a
  gate fails."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import pallas_lbm as pk
from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.ops import fused_fluid
from lbmdem_tpu_torch.tools import validate

from torch_parity_util import npy, perturbed_f, to_torch_cfg, tt


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _f32(a):
    """An array of either package (f32 or bf16) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


COMBOS = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("trt,les,forced,shifted", COMBOS, ids=[
    "-".join(n for n, on in zip(("trt", "les", "forced", "shift"), c) if on)
    or "bgk" for c in COMBOS])
def test_collide_pairs_matches_pallas_window(trt, les, forced, shifted):
    kw = dict(nx=64, ny=16, tau=0.8, dtype="float32")
    if trt:
        kw["collision"] = "trt"
    if les:
        kw["smagorinsky"] = 0.16
    if forced:
        kw.update(gx=1e-5, gy=-2e-5)
    cfg = JCfg(**kw)
    seed = sum(b << i for i, b in enumerate((trt, les, forced, shifted)))
    f = perturbed_f((9, cfg.ny, cfg.nx), seed, np.float32, amp=0.05)
    shift = 0.0
    if shifted:
        shift = float(cfg.rho0)
        f = (f - lattice.W[:, None, None].astype(np.float32)
             * np.float32(shift)).astype(np.float32)
    outs, phi = pk._collide_window([jnp.asarray(f[i]) for i in range(9)],
                                   cfg, shift=shift)
    assert phi is None
    want = np.stack([np.asarray(o) for o in outs])
    got = fused_fluid.collide_pairs(tt(f), to_torch_cfg(cfg), shift)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(npy(got), want, rtol=1e-6, atol=1e-7)
    assert float(np.abs(want - f).max()) > 1e-4  # the collide moved f


# lattice options: every collide option, with walls, a moving lid,
# periodic y and Zou/He among them
OPTS = {
    "bgk-forced-lid": dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                           gx=1e-5, gy=-2e-5),
    "trt-forced": dict(collision="trt", gx=2e-5, bc_south="periodic",
                       bc_north="periodic"),
    "bgk-les": dict(smagorinsky=0.16, gy=1e-5),
    "trt-les-zou-he": dict(collision="trt", smagorinsky=0.16,
                           bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                           inlet_profile="poiseuille"),
}
BARS = {"float32": 5e-6, "bfloat16": 3e-4}


def _inputs(cfg, shape, seed):
    """A seeded f (shape) in cfg's storage form for both packages: a
    torch tensor and a jnp array of the same values."""
    f = tt(perturbed_f(shape, seed, np.float32, amp=0.05))
    if cfg.f_storage == "bfloat16":
        f = fused_fluid.lbm.to_storage(f, to_torch_cfg(cfg))
        return f, jnp.asarray(_f32(f)).astype(jnp.bfloat16)
    return f, jnp.asarray(npy(f))


def _close(got, want, cfg):
    assert got.dtype == (torch.bfloat16 if cfg.f_storage == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=BARS[cfg.f_storage])


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_plain_k4_k5_match_pallas(opt, storage):
    """Two K4 steps and one K5 pass (f32 k = 8, bf16 k = 16: the deepest
    pass of each, one rounding) on the lattice."""
    cfg = JCfg(nx=128, ny=16, tau=0.8, dtype="float32", f_storage=storage,
               **OPTS[opt])
    tcfg = to_torch_cfg(cfg)
    f, jf = _inputs(cfg, (9, cfg.ny, cfg.nx), 3)
    got, want = f, jf
    for _ in range(2):
        got = fused_fluid.fused_step_fluid(got, tcfg, torch.empty_like(got))
        want = pk.fused_step_fluid(want, cfg)
    _close(got, want, cfg)
    k = fused_fluid.MAX_K[storage]
    got = fused_fluid.fused_step_fluid_multi(f, tcfg, k, torch.empty_like(f))
    _close(got, pk.fused_step_fluid_multi(jf, cfg, k), cfg)


# (mode, edges (south, north, west, east), the shard's row of 4): the
# south-west corner shard of a 2D mesh, the last shard of a 1D one
FRAMES = [("yx", (1, 0, 1, 0), 0), ("y", (0, 1, 1, 1), 3)]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,edges,row", FRAMES,
                         ids=[m for m, _, _ in FRAMES])
def test_plain_prehalo_k4_k5_match_pallas(mode, edges, row, storage):
    """On a shard's pre-haloed frame: K4 (the walls it skips left to the
    caller, its edge populations those of collide_pairs), K5 at k = 4
    (one sweep) and at the frame's depth (f32 8, bf16 16: sweeps through
    scratch frames on the card)."""
    opts = dict(OPTS["trt-les-zou-he"], uw_north=0.03)
    cfg = JCfg(nx=128, ny=16 if storage == "float32" else 32, tau=0.7,
               dtype="float32", f_storage=storage, **opts)
    tcfg = to_torch_cfg(cfg)
    f, jf = _inputs(cfg, fused_fluid.frame_shape(tcfg, mode), 5)
    jmode = True if mode == "y" else "yx"
    out = torch.empty((9, cfg.ny, cfg.nx), dtype=f.dtype)
    edge = (torch.empty((9, 2, cfg.nx)), torch.empty((9, cfg.ny, 2)))
    got = fused_fluid.fused_step_fluid(f, tcfg, out, prehalo=mode,
                                       edge_post=edge)
    _close(got, pk.fused_step_fluid(jf, cfg, prehalo=jmode), cfg)
    g, shift = fused_fluid.compute_form(f, tcfg)
    hy = fused_fluid.frame_hy(tcfg)
    hx = fused_fluid.HX if mode == "yx" else 0
    post = fused_fluid.collide_pairs(
        g[:, hy:hy + cfg.ny, hx:hx + cfg.nx], tcfg, shift)
    assert torch.equal(edge[0][:, 0], post[:, 0])
    assert torch.equal(edge[1][:, :, 1], post[:, :, -1])
    ny_glob = 4 * cfg.ny
    edges = (*edges, row * cfg.ny)
    for k in (4, fused_fluid.MAX_K[storage]):
        got = fused_fluid.fused_step_fluid_multi(
            f, tcfg, k, torch.empty_like(out), prehalo=mode, edges=edges,
            ny_glob=ny_glob)
        want = pk.fused_step_fluid_multi(
            jf, cfg, k, prehalo=jmode, edges=jnp.asarray(edges, jnp.int32),
            ny_glob=ny_glob)
        _close(got, want, cfg)


def test_trt_leg_passes_on_cpu():
    """The trt leg of the validation tool on the plain versions of K5 and
    K4: both gates hold (each raises GateFailed when it fails)."""
    res = validate.trt("cpu")
    assert res["trt"] < 2e-4 and res["bgk"] > 50 * res["trt"]
    assert "K5" in res["path"]
