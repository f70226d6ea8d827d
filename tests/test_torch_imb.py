"""ops/imb.py of the port (main-path half) against the JAX oracle
lbmdem_tpu/ops/imb.py, in float32 and float64.

Tolerances: coverage is a sum of exact 1/16 steps (sample) or the same
closed form (ramp, exact), and the scatter-add runs in the same disk
order, so f64 agrees to 1e-12 and f32 to 1e-6 (the JAX stamp bar).
Forces sum a window of products in another order: 1e-12 / 2e-6
relative to the largest |F|."""

import jax
import numpy as np
import pytest

from lbmdem_tpu.config import SimConfig as JCfg, window_for_radius
from lbmdem_tpu.ops import imb as jimb
from lbmdem_tpu_torch.ops import imb as timb

from torch_parity_util import (DTYPES, TORCH_DT, jx, npy, perturbed_f,
                               random_disks, to_torch_cfg, tt)

TOL = {"float32": 1e-6, "float64": 1e-12}


def _setup(dtype, method="sample", seed=1, n=20, **kw):
    cfg = JCfg(nx=96, ny=64, tau=0.8, dtype=dtype, max_disks=n,
               window=window_for_radius(4.0), eps_method=method,
               bc_west="wall", bc_east="wall", **kw)
    x, v, om, r, act = random_disks(n, 96, 64, seed, n_inactive=3)
    # two disks straddling the domain edge: windows partly outside
    x[0] = (0.7, 30.0)
    x[1] = (94.6, 63.2)
    arrs = [a.astype(dtype) for a in (x, v, om, r)] + [act]
    return cfg, arrs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["sample", "ramp", "exact"])
def test_coverage_window(dtype, method):
    cfg, (x, v, om, r, act) = _setup(dtype, method)
    jc, jby, jbx = jax.vmap(
        lambda a, b, c, d: jimb._coverage_window(
            a, b, c, d, cfg.window, 4, np.dtype(dtype), method))(
        x[:, 0], x[:, 1], r, act.astype(dtype))
    tc, tby, tbx = timb._coverage_window(tt(x[:, 0]), tt(x[:, 1]), tt(r),
                                         tt(act), cfg.window, 4, method)
    np.testing.assert_allclose(npy(jc), npy(tc), rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(npy(jby), npy(tby))
    np.testing.assert_array_equal(npy(jbx), npy(tbx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["sample", "ramp", "exact"])
def test_stamp_solid_fraction(dtype, method):
    cfg, (x, v, om, r, act) = _setup(dtype, method)
    j = jimb.stamp_solid_fraction(jx(x), jx(v), jx(om), jx(r), jx(act), cfg)
    t = timb.stamp_solid_fraction(tt(x), tt(v), tt(om), tt(r), tt(act),
                                  to_torch_cfg(cfg))
    for a, b in zip(j, t):
        assert b.dtype == TORCH_DT[dtype]
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=TOL[dtype])


def test_stamp_r_shift_and_open_columns():
    cfg, (x, v, om, r, act) = _setup("float64", eps_r_shift=-0.4)
    j = jimb.stamp_solid_fraction(jx(x), jx(v), jx(om), jx(r), jx(act), cfg)
    t = timb.stamp_solid_fraction(tt(x), tt(v), tt(om), tt(r), tt(act),
                                  to_torch_cfg(cfg))
    for a, b in zip(jimb.mask_open_columns(*j), timb.mask_open_columns(*t)):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=1e-12)
    assert float(t[0][:, 0].abs().sum()) > 0  # the mask had work to do


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [
    dict(), dict(gx=1e-4, gy=-2e-5), dict(collision="trt"),
    dict(smagorinsky=0.12), dict(nt_mode="lambda")],
    ids=["bgk", "guo", "trt", "les", "lambda"])
def test_collide_imb(dtype, kw):
    cfg, (x, v, om, r, act) = _setup(dtype, **kw)
    eps, usx, usy = jimb.stamp_solid_fraction(jx(x), jx(v), jx(om), jx(r),
                                              jx(act), cfg)
    f = perturbed_f((9, 64, 96), 7, dtype)
    j = jimb.collide_imb(jx(f), eps, usx, usy, cfg)
    t = timb.collide_imb(tt(f), tt(eps), tt(usx), tt(usy), to_torch_cfg(cfg))
    for a, b in zip(j, t):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0,
                                   atol=2 * TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_hydro_forces(dtype):
    cfg, (x, v, om, r, act) = _setup(dtype, seed=3)
    eps, usx, usy = jimb.stamp_solid_fraction(jx(x), jx(v), jx(om), jx(r),
                                              jx(act), cfg)
    f = perturbed_f((9, 64, 96), 8, dtype)
    _, phix, phiy = jimb.collide_imb(jx(f), eps, usx, usy, cfg)
    jF, jT = jimb.reduce_hydro_forces(jx(x), jx(r), jx(act), eps, phix, phiy,
                                      cfg)
    tF, tT = timb.reduce_hydro_forces(tt(x), tt(r), tt(act), tt(eps),
                                      tt(phix), tt(phiy), to_torch_cfg(cfg))
    scale = float(np.abs(npy(jF)).max())
    assert scale > 0
    tol = {"float32": 2e-6, "float64": 1e-12}[dtype] * scale
    np.testing.assert_allclose(npy(jF), npy(tF), rtol=0, atol=tol)
    np.testing.assert_allclose(npy(jT), npy(tT), rtol=0, atol=10 * tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_nt_weight_and_exact_coverage(dtype):
    rng = np.random.default_rng(4)
    eps = rng.uniform(0, 1, 50).astype(dtype)
    for mode in ("nt", "lambda"):
        np.testing.assert_allclose(npy(jimb.nt_weight(jx(eps), 0.6, mode)),
                                   npy(timb.nt_weight(tt(eps), 0.6, mode)),
                                   rtol=0, atol=TOL[dtype])
    rel = rng.uniform(-6, 6, (2, 200)).astype(dtype)
    rr = rng.uniform(1, 5, 200).astype(dtype)
    np.testing.assert_allclose(
        npy(jimb.exact_coverage(jx(rel[0]), jx(rel[1]), jx(rr))),
        npy(timb.exact_coverage(tt(rel[0]), tt(rel[1]), tt(rr))),
        rtol=0, atol=TOL[dtype])
    # the empty-slot convention: r == 0 covers nothing, even at d = 0
    z = tt(np.zeros(3, dtype))
    assert float(timb.exact_coverage(z, z, z).abs().sum()) == 0.0
