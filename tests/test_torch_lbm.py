"""ops/lbm.py of the port against the JAX oracle lbmdem_tpu/ops/lbm.py,
in float32 and float64.

Tolerances: both sides evaluate the same expressions in the same
order; they may still sum the 9 populations in another order, so f64
agrees to 1e-13 and f32 to 2e-6 (a few ulp of O(1) values)."""

import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import lbm as jlbm
from lbmdem_tpu_torch.ops import lbm as tlbm

from torch_parity_util import DTYPES, jx, npy, perturbed_f, to_torch_cfg, tt

TOL = {"float32": 2e-6, "float64": 1e-13}


def _cfg(**kw):
    base = dict(nx=24, ny=16, tau=0.8, bc_west="wall", bc_east="wall")
    base.update(kw)
    return JCfg(**base)


def _f(dtype, seed=0, shape=(9, 16, 24)):
    return perturbed_f(shape, seed, dtype)


def _close(a, b, dtype, tol=None):
    np.testing.assert_allclose(npy(a), npy(b), rtol=0,
                               atol=tol if tol is not None else TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_moments_and_equilibrium(dtype):
    f = _f(dtype)
    jr = jlbm.moments(f, 1e-4, -2e-5)
    tr = tlbm.moments(tt(f), 1e-4, -2e-5)
    for a, b in zip(jr, tr):
        _close(a, b, dtype)
    _close(jlbm.equilibrium(*jr), tlbm.equilibrium(*tr), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [
    dict(), dict(gx=1e-4, gy=-3e-5), dict(smagorinsky=0.1),
    dict(trt_magic=3 / 16), dict(trt_magic=0.25, gx=2e-5)],
    ids=["bgk", "guo", "les", "trt", "trt-guo"])
def test_collide(dtype, kw):
    f = _f(dtype, seed=1)
    args = (0.7, kw.get("gx", 0.0), kw.get("gy", 0.0),
            kw.get("smagorinsky", 0.0), kw.get("trt_magic", 0.0))
    _close(jlbm.collide(f, *args), tlbm.collide(tt(f), *args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_and_moving_wall_bounce_back(dtype):
    """Pull streaming is a permutation and the half-way bounce-back a
    copy plus a constant: both exact. Moving north (lid) and west walls
    exercise lattice.wall_corr; corners check the x-wall-wins order."""
    cfg = _cfg(uw_north=0.05, uw_west=-0.02, uw_south=0.01)
    fpost = _f(dtype, seed=2)
    js = jlbm.stream(fpost)
    ts = tlbm.stream(tt(fpost))
    _close(js, ts, dtype, 0.0)
    _close(jlbm.apply_bounce_back(js, fpost, cfg),
           tlbm.apply_bounce_back(ts, tt(fpost), to_torch_cfg(cfg)), dtype,
           0.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("profile", ["uniform", "poiseuille"])
def test_open_boundaries(dtype, profile):
    cfg = _cfg(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
               inlet_profile=profile, rho_outlet=1.01, dtype=dtype)
    f = _f(dtype, seed=3)
    _close(jlbm.apply_open_boundaries(jx(f), cfg),
           tlbm.apply_open_boundaries(tt(f), to_torch_cfg(cfg)), dtype)
    np.testing.assert_array_equal(jlbm.inlet_profile_array(cfg),
                                  tlbm.inlet_profile_array(to_torch_cfg(cfg)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [
    dict(uw_north=0.1), dict(gx=1e-5, bc_west="periodic",
                             bc_east="periodic"),
    dict(bc_west="inlet", bc_east="outlet", u_inlet=0.04,
         inlet_profile="poiseuille")],
    ids=["cavity", "channel", "zou-he"])
def test_step_pure_fluid(dtype, kw):
    cfg = _cfg(dtype=dtype, **kw)
    f = np.asarray(jlbm.init_equilibrium(cfg))
    jf, tf = f, tt(f)
    for _ in range(3):
        jf = jlbm.step_pure_fluid(jf, cfg)
        tf = tlbm.step_pure_fluid(tf, to_torch_cfg(cfg))
    _close(jf, tf, dtype, 2 * TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_equilibrium(dtype):
    cfg = _cfg(dtype=dtype, u0x=0.02, u0y=-0.01, rho0=1.1)
    t = tlbm.init_equilibrium(to_torch_cfg(cfg))
    assert t.dtype == {"float32": torch.float32,
                       "float64": torch.float64}[dtype]
    _close(jlbm.init_equilibrium(cfg), t, dtype)


def test_storage_shift_bf16_roundtrip():
    """Shifted bf16 storage g = f - w rho0: both packages round the same
    f32 values to the same bf16 (round to nearest even) and back."""
    cfg = _cfg(f_storage="bfloat16", rho0=1.0)
    f = _f("float32", seed=4)
    js = np.asarray(jlbm.to_storage(f, cfg).astype(np.float32))
    ts = tlbm.to_storage(tt(f), to_torch_cfg(cfg))
    assert ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(js, ts.float().numpy())
    np.testing.assert_array_equal(
        np.asarray(jlbm.from_storage(jlbm.to_storage(f, cfg), cfg)),
        tlbm.from_storage(ts, to_torch_cfg(cfg)).numpy())
    plain = tt(f)  # float32 storage is the identity
    assert tlbm.to_storage(plain, to_torch_cfg(_cfg())) is plain


@pytest.mark.parametrize("dtype", DTYPES)
def test_smagorinsky_and_trt_tau(dtype):
    f = _f(dtype, seed=5)
    rho, ux, uy = jlbm.moments(f)
    feq = jlbm.equilibrium(rho, ux, uy)
    tr = [tt(a) for a in (rho, ux, uy)]
    _close(jlbm.smagorinsky_tau(f, feq, rho, 0.6, 0.15),
           tlbm.smagorinsky_tau(tt(f), tlbm.equilibrium(*tr), tr[0], 0.6,
                                0.15), dtype)
    assert jlbm.trt_tau_minus(0.8, 0.25) == tlbm.trt_tau_minus(0.8, 0.25)
