"""The pair-form coupled collide of K2, K6, K7 and K8 under TRT
(`fused_fluid.collide_imb_pairs`, csrc/imb.cuh collide_cell_pairs) on
the CPU against the JAX package.

- collide_imb_pairs against the coupled branch of the JAX kernels'
  `pallas_lbm._collide_window` (eps given) on the same seeded planes,
  for every BGK/TRT x LES x forced x shift x nt_mode combination, with
  eps_raw that holds 0, 1, fractions and values outside [0, 1]: equal
  bit for bit (f and phi), in float32 (the eager trace keeps float32
  under LES; in float64 its LES constant is a float32 one).
- The plain K2, K6, K7 and K8 take it under TRT and keep
  imb.collide_imb under BGK (`fused_fluid.coupled_collide`); under TRT
  they are held against their interpret-mode Pallas kernels (f32 5e-6,
  bf16 3e-4; partials 1e-6 of the largest, bf16 5e-6).
- The trt leg's deck (128 x 32, tau 1.5, gx 5e-5, f32, 12 000 steps)
  through the plain K7 with a zero solid stack: TRT within 2e-4 of the
  parabola, BGK over 50 times off (`validate.trt_coupled`).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import pallas_lbm as pk
from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.ops import fused_fluid, fused_lbm, fused_static, imb
from lbmdem_tpu_torch.tools import validate

from torch_parity_util import npy, perturbed_f, to_torch_cfg, tt


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _solid(shape, seed, dtype):
    """eps_raw with exact 0s, 1s, values outside [0, 1] and fractions,
    and a solid velocity field."""
    rng = np.random.default_rng(seed)
    eps = rng.uniform(-0.2, 1.2, shape)
    pick = rng.integers(0, 4, shape)
    eps = np.where(pick == 0, 0.0, np.where(pick == 1, 1.0, eps))
    usx = rng.uniform(-0.03, 0.03, shape)
    usy = rng.uniform(-0.03, 0.03, shape)
    return [a.astype(dtype) for a in (eps, usx, usy)]


COMBOS = list(itertools.product((False, True), repeat=5))


@pytest.mark.parametrize("trt,les,forced,shifted,lam", COMBOS, ids=[
    "-".join(n for n, on in zip(("trt", "les", "forced", "shift", "lambda"),
                                c) if on) or "bgk" for c in COMBOS])
def test_collide_imb_pairs_matches_pallas_window(trt, les, forced, shifted,
                                                 lam):
    kw = dict(nx=64, ny=16, tau=0.8, dtype="float32")
    if trt:
        kw["collision"] = "trt"
    if les:
        kw["smagorinsky"] = 0.16
    if forced:
        kw.update(gx=1e-5, gy=-2e-5)
    if lam:
        kw["nt_mode"] = "lambda"
    cfg = JCfg(**kw)
    seed = sum(b << i for i, b in enumerate((trt, les, forced, shifted, lam)))
    f = perturbed_f((9, cfg.ny, cfg.nx), seed, np.float32, amp=0.05)
    shift = 0.0
    if shifted:
        shift = float(cfg.rho0)
        f = (f - lattice.W[:, None, None].astype(np.float32)
             * np.float32(shift)).astype(np.float32)
    eps, usx, usy = _solid((cfg.ny, cfg.nx), 100 + seed, np.float32)
    outs, phi = pk._collide_window(
        [jnp.asarray(f[i]) for i in range(9)], cfg, jnp.asarray(eps),
        jnp.asarray(usx), jnp.asarray(usy), shift=shift)
    want = np.stack([np.asarray(o) for o in outs])
    assert want.dtype == np.float32
    got, phix, phiy = fused_fluid.collide_imb_pairs(
        tt(f), tt(eps), tt(usx), tt(usy), to_torch_cfg(cfg), shift)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(npy(got), want)
    np.testing.assert_array_equal(npy(phix), np.asarray(phi[0]))
    np.testing.assert_array_equal(npy(phiy), np.asarray(phi[1]))
    assert float(np.abs(np.asarray(phi)).max()) > 1e-5  # phi is live
    assert float(np.abs(want - f).max()) > 1e-4  # the collide moved f


def test_coupled_collide_choice():
    """Under TRT the coupled kernels' plain versions collide in the pair
    form, under BGK in imb.collide_imb's index order; the two agree
    within rounding."""
    bgk = to_torch_cfg(JCfg(nx=64, ny=16, tau=0.8, dtype="float32"))
    trt = bgk.replace(collision="trt")
    assert fused_fluid.coupled_collide(bgk) is imb.collide_imb
    assert fused_fluid.coupled_collide(trt) is fused_fluid.collide_imb_pairs
    f = tt(perturbed_f((9, 16, 64), 7, np.float32, amp=0.05))
    eps, usx, usy = (tt(a) for a in _solid((16, 64), 8, np.float32))
    for cfg in (bgk, trt):
        a, ax, ay = imb.collide_imb(f, eps, usx, usy, cfg)
        b, bx, by = fused_fluid.collide_imb_pairs(f, eps, usx, usy, cfg)
        for x, y in ((a, b), (ax, bx), (ay, by)):
            np.testing.assert_allclose(npy(x), npy(y), rtol=0, atol=2e-7)


FAST = list(itertools.product((False, True), ("nt", "lambda"), (False, True),
                              ("float32", "float64")))


@pytest.mark.parametrize("les,nt_mode,guo,dtype", FAST, ids=[
    "-".join(str(x) for x in c) for c in FAST])
def test_fluid_cells_take_the_fluid_terms_pairs(les, nt_mode, guo, dtype):
    """The fluid-cell rule of csrc/imb.cuh collide_cell_pairs (the TRT
    instantiations of K2, K6, K7, K8): where eps_raw <= 0, B is +0 and
    1 - B is 1, so collide_imb_pairs gives the uncoupled pair form's
    populations (collide_pairs) under torch.equal and phi is 0; the
    solid cells need the blend."""
    ny, nx = 12, 17
    cfg = to_torch_cfg(JCfg(nx=nx, ny=ny, tau=0.8, dtype=dtype,
                            collision="trt", nt_mode=nt_mode,
                            smagorinsky=0.16 if les else 0.0,
                            gx=2e-5 if guo else 0.0, gy=-1e-5 if guo else 0.0))
    rng = np.random.default_rng(sum(map(ord, f"{les}{nt_mode}{guo}{dtype}")))
    dt = getattr(torch, dtype)
    f = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.1 * rng.standard_normal((9, ny, nx))), dtype=dt)
    kind = rng.integers(0, 3, (ny, nx))
    eps_raw = torch.as_tensor(np.choose(kind, [
        np.zeros((ny, nx)), -rng.uniform(1e-9, 1e-3, (ny, nx)),
        rng.uniform(1e-6, 1.2, (ny, nx))]), dtype=dt)
    usx = torch.as_tensor(rng.uniform(-0.05, 0.05, (ny, nx)), dtype=dt)
    usy = torch.as_tensor(rng.uniform(-0.05, 0.05, (ny, nx)), dtype=dt)
    fpost, phix, phiy = fused_fluid.collide_imb_pairs(f, eps_raw, usx, usy,
                                                      cfg)
    want = fused_fluid.collide_pairs(f, cfg)
    fluid = eps_raw <= 0
    assert 0 < int(fluid.sum()) < fluid.numel()
    assert torch.equal(fpost[:, fluid], want[:, fluid])
    assert bool((phix[fluid] == 0).all()) and bool((phiy[fluid] == 0).all())
    assert not torch.equal(fpost[:, ~fluid], want[:, ~fluid])
    assert float(phix[~fluid].abs().max()) > 0.0


# the TRT options of the kernels' Pallas parity, f32 and bf16
TRT_OPTS = {"trt": dict(collision="trt", gy=-1e-5),
            "trt-les-lambda": dict(collision="trt", smagorinsky=0.12,
                                   nt_mode="lambda", gx=2e-5, gy=-1e-5,
                                   uw_north=0.03)}


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", sorted(TRT_OPTS))
def test_plain_coupled_trt_match_pallas(opt, storage):
    """The plain K2, K6 (k = 4), K7 (k = 4) and K8 (f32) under TRT, which
    collide in the pair form, against the interpret-mode Pallas
    fused_step_imb_reduce, fused_step_imb_reduce_multi,
    fused_step_imb_static_multi and fused_step_imb: f' 5e-6 (bf16 3e-4),
    forces 1e-6 of the largest |F|, phi 1e-6."""
    from test_torch_breadth import (_assert_forces, _f_bar, _kernel_case,
                                    _solid, _storage)

    cfg, arrs, f = _kernel_case(dict(TRT_OPTS[opt], f_storage=storage))
    tcfg = to_torch_cfg(cfg)
    jf, tf = _storage(f, cfg)
    solid, (td, cnt, es), (ttd, tcnt, tes) = _solid(cfg, arrs)
    ts = tt(np.asarray(solid))
    bar = _f_bar(cfg)

    def close(j, t):
        np.testing.assert_allclose(np.asarray(j, np.float32),
                                   npy(t.to(torch.float32)), **bar)

    jnew, jparts = pk.fused_step_imb_reduce(jf, solid, None, None, cfg, td,
                                            cnt)
    tnew, tparts = fused_lbm.fused_step_imb_reduce(tf, ts, ttd, tcnt, tcfg,
                                                   torch.empty_like(tf))
    close(jnew, tnew)
    _assert_forces(jparts, es, tparts, tes)
    jnew, jparts = pk.fused_step_imb_reduce_multi(jf, solid, cfg, 4, td, cnt)
    tnew, tparts = fused_lbm.fused_step_imb_reduce_multi(
        tf, ts, ttd, tcnt, tcfg, 4, torch.empty_like(tf))
    close(jnew, tnew)
    for t in range(4):
        _assert_forces(jparts[t], es, tparts[t], tes, f"inner step {t}")
    close(pk.fused_step_imb_static_multi(jf, solid, cfg, 4),
          fused_static.fused_step_imb_static_multi(tf, ts, tcfg, 4,
                                                   torch.empty_like(tf)))
    if storage == "float32":
        jnew, jpx, jpy = pk.fused_step_imb(jf, solid[0], solid[1], solid[2],
                                           cfg)
        tnew, tpx, tpy = fused_lbm.fused_step_imb(
            tf, ts[0], ts[1], ts[2], tcfg, torch.empty_like(tf))
        close(jnew, tnew)
        for j, t in ((jpx, tpx), (jpy, tpy)):
            np.testing.assert_allclose(np.asarray(j), npy(t), rtol=0,
                                       atol=1e-6)


def test_trt_deck_on_plain_k7():
    """The trt leg's deck through the plain K7 over a zero solid stack
    (its collide the pair form under TRT): TRT within 2e-4 of the
    parabola and BGK more than 50 times off (the gates raise). The
    parent's index-order TRT collide read 21.3x here."""
    res = validate.trt_coupled("cpu", "K7")
    assert res["trt"] < 2e-4 and res["bgk"] > 50 * res["trt"]
    assert "K7 plain version" in res["path"]
