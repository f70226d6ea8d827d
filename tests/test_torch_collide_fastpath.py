"""The fluid-cell rule of the NT collide (csrc/imb.cuh relax_cell, the
collide of K2, K6, K7 and K8) held on the plain version: where eps_raw
<= 0, eps clamps to 0, the blend weight B is 0 and 1 - B is 1, so every
B * Omega_i term adds +-0 and the post-collision populations of
imb.collide_imb are its fluid terms alone, under torch.equal (which
treats +0 and -0 as equal):

    BGK  f - (f - f_eq) / tau  (+ the Guo term)
    TRT  f - relax             (+ the TRT source)

and phi is 0 there. The kernels' fluid branch computes exactly these
terms, in the same operations and order. Over BGK/TRT x LES x nt_mode x
Guo forcing, in float32 and float64, on random f with eps_raw zero,
negative and positive."""

import itertools
import zlib

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import SimConfig, lattice
from lbmdem_tpu_torch.ops import imb, lbm

CASES = list(itertools.product(("bgk", "trt"), (False, True),
                               ("nt", "lambda"), (False, True)))


def _fluid_terms(f, cfg):
    """The fluid part of imb.collide_imb, written as its B = 0 terms."""
    rho, ux, uy = lbm.moments(f, cfg.gx, cfg.gy)
    feq = lbm.equilibrium(rho, ux, uy)
    tau_eff = (lbm.smagorinsky_tau(f, feq, rho, cfg.tau, cfg.smagorinsky)
               if cfg.smagorinsky > 0.0 else cfg.tau)
    forced = cfg.gx != 0.0 or cfg.gy != 0.0
    if cfg.trt_lambda <= 0.0:
        out = f - (f - feq) / tau_eff
        if forced:
            out = out + lbm.guo_force_term(ux, uy, tau_eff, cfg.gx, cfg.gy)
        return out
    opp = lattice.OPP
    tau_m = lbm.trt_tau_minus(tau_eff, cfg.trt_lambda)
    ne = f - feq
    ne_o = ne[opp]
    relax = (0.5 / tau_eff) * (ne + ne_o) + (0.5 / tau_m) * (ne - ne_o)
    out = f - relax
    if forced:
        S = lbm._guo_proj(ux, uy, cfg.gx, cfg.gy)
        S_o = S[opp]
        out = out + ((1.0 - 0.5 / tau_eff) * 0.5 * (S + S_o)
                     + (1.0 - 0.5 / tau_m) * 0.5 * (S - S_o))
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("collision,les,nt_mode,guo", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_fluid_cells_take_the_fluid_terms(collision, les, nt_mode, guo,
                                          dtype):
    ny, nx = 12, 17
    cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype=dtype, collision=collision,
                    smagorinsky=0.16 if les else 0.0, nt_mode=nt_mode,
                    gx=2e-5 if guo else 0.0, gy=-1e-5 if guo else 0.0)
    rng = np.random.default_rng(
        zlib.crc32(f"{collision}{les}{nt_mode}{guo}{dtype}".encode()))
    dt = getattr(torch, dtype)
    f = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.1 * rng.standard_normal((9, ny, nx))), dtype=dt)
    # a third each: eps_raw 0, negative (a stamp's rounding), positive
    kind = rng.integers(0, 3, (ny, nx))
    eps_raw = torch.as_tensor(np.choose(kind, [
        np.zeros((ny, nx)), -rng.uniform(1e-9, 1e-3, (ny, nx)),
        rng.uniform(1e-6, 1.2, (ny, nx))]), dtype=dt)
    usx = torch.as_tensor(rng.uniform(-0.05, 0.05, (ny, nx)), dtype=dt)
    usy = torch.as_tensor(rng.uniform(-0.05, 0.05, (ny, nx)), dtype=dt)
    fpost, phix, phiy = imb.collide_imb(f, eps_raw, usx, usy, cfg)
    want = _fluid_terms(f, cfg)
    fluid = eps_raw <= 0
    assert 0 < int(fluid.sum()) < fluid.numel()
    assert torch.equal(fpost[:, fluid], want[:, fluid])
    assert bool((phix[fluid] == 0).all()) and bool((phiy[fluid] == 0).all())
    # the solid cells do need the NT terms
    assert not torch.equal(fpost[:, ~fluid], want[:, ~fluid])
    assert float(phix[~fluid].abs().max()) > 0.0
