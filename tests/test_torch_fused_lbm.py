"""ops/fused_lbm.py of the port (K2's plain version) against the JAX
package: the Pallas fused_step_imb_reduce in interpret mode, and the
oracle chain collide_imb -> stream -> apply_bounce_back +
imb.reduce_hydro_forces.

Bars: f' 5e-6 against the Pallas kernel (its pair-symmetric algebra
rounds differently; __graft_entry__.py's fused-vs-oracle bar), per-disk
forces 1e-6 relative to the largest |F| (gather order differs), torque
2e-6 relative to the largest |T|. Against the oracle in f64: 1e-13 on
f' and 1e-12 relative on forces."""

import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg, window_for_radius
from lbmdem_tpu.ops import imb as jimb, lbm as jlbm
from lbmdem_tpu.ops import pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu_torch.ops import fused_lbm, stamp

from torch_parity_util import (DTYPES, jx, npy, perturbed_f, random_disks,
                               to_torch_cfg, tt)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _setup(dtype="float32", n=24, seed=2, **kw):
    kw = {"bc_west": "wall", "bc_east": "wall", **kw}
    cfg = JCfg(nx=256, ny=128, tau=0.8, dtype=dtype, max_disks=n,
               window=window_for_radius(4.0), tile_cap=32, **kw)
    x, v, om, r, act = random_disks(n, 256, 128, seed, n_inactive=3)
    x[0] = (1.2, 64.0)    # on the west wall
    x[1] = (200.0, 126.8)  # on the (moving) north wall
    x[2] = (127.7, 63.9)  # straddles 4 stamp tiles
    arrs = [a.astype(dtype) for a in (x, v, om, r)] + [act]
    f = perturbed_f((9, 128, 256), seed + 10, dtype)
    return cfg, arrs, f


def _port_step(cfg, arrs, f):
    """Port: binning, K1 plain, K2 plain; per-disk forces."""
    tcfg = to_torch_cfg(cfg)
    x, v, om, r, act = [tt(a) for a in arrs]
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, tcfg)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, tcfg)
    fin = tt(f)
    out = torch.empty_like(fin)
    launches = fused_lbm.fused_step_imb_reduce.launches
    fnew, parts = fused_lbm.fused_step_imb_reduce(fin, solid, td, cnt, tcfg,
                                                  out)
    assert fused_lbm.fused_step_imb_reduce.launches == launches  # CPU path
    assert fnew is out
    np.testing.assert_array_equal(npy(fin), f)  # f itself is not written
    # slots past a tile's count carry zero partials
    cap = cfg.tile_cap
    live = np.arange(cap)[None, :] < npy(cnt).reshape(-1, 1)
    assert not npy(parts).reshape(-1, cap, 4)[~live].any()
    F, T = stamp.gather_partials(parts, es, x.dtype)
    return solid, fnew, F, T


def test_plain_matches_pallas_interpret():
    """K2's plain version against the TPU kernel in interpret mode."""
    cfg, arrs, f = _setup()
    xs = [jx(a) for a in arrs]
    je, jux, juy, _ = ps.stamp_solid_fraction(*xs, cfg)
    td, cnt, es, _ = ps.bin_disks_to_tiles(*xs, cfg)
    jf, jparts = pk.fused_step_imb_reduce(jx(f), je, jux, juy, cfg, td, cnt)
    jF, jT = ps.gather_partials(jparts, es, np.float32)
    _, tf, tF, tT = _port_step(cfg, arrs, f)
    np.testing.assert_allclose(npy(jf), npy(tf), rtol=0, atol=5e-6)
    fs = float(np.abs(npy(jF)).max())
    ts = float(np.abs(npy(jT)).max())
    assert fs > 0 and ts > 0
    np.testing.assert_allclose(npy(jF), npy(tF), rtol=0, atol=1e-6 * fs)
    np.testing.assert_allclose(npy(jT), npy(tT), rtol=0, atol=2e-6 * ts)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [dict(uw_north=0.05),
                                dict(uw_north=0.03, uw_west=-0.01, gx=2e-5,
                                     gy=-1e-5)],
                         ids=["lid", "walls-guo"])
def test_plain_matches_oracle_chain(dtype, kw):
    """K2's plain version against collide_imb -> stream -> bounce-back
    (moving north wall; moving west wall with Guo forcing) and the
    oracle's per-disk force gather."""
    cfg, arrs, f = _setup(dtype, seed=4, **kw)
    xs = [jx(a) for a in arrs]
    eps, usx, usy = jimb.stamp_solid_fraction(*xs, cfg)
    fpost, phix, phiy = jimb.collide_imb(jx(f), eps, usx, usy, cfg)
    jf = jlbm.apply_bounce_back(jlbm.stream(fpost), fpost, cfg)
    jF, jT = jimb.reduce_hydro_forces(xs[0], xs[3], xs[4], eps, phix, phiy,
                                      cfg)
    solid, tf, tF, tT = _port_step(cfg, arrs, f)
    ftol = {"float32": 5e-6, "float64": 1e-13}[dtype]
    rel = {"float32": 1e-6, "float64": 1e-12}[dtype]
    np.testing.assert_allclose(npy(eps), npy(solid[0]), rtol=0, atol=rel)
    np.testing.assert_allclose(npy(jf), npy(tf), rtol=0, atol=ftol)
    fs = float(np.abs(npy(jF)).max())
    ts = float(np.abs(npy(jT)).max())
    np.testing.assert_allclose(npy(jF), npy(tF), rtol=0, atol=rel * fs)
    np.testing.assert_allclose(npy(jT), npy(tT), rtol=0, atol=2 * rel * ts)


@pytest.mark.parametrize("kw,what", [
    (dict(collision="trt"), "TRT"), (dict(smagorinsky=0.1), "LES"),
    (dict(bc_west="inlet", bc_east="outlet", u_inlet=0.02), "Zou/He"),
    (dict(f_storage="bfloat16"), "bfloat16"),
    (dict(nt_mode="lambda"), "nt_mode")])
def test_lattice_options_match_oracle_chain(kw, what):
    """Each lattice option and bf16 storage (named by `what`): K2's
    plain version against the JAX oracle chain from_storage ->
    collide_imb -> stream -> bounce-back -> open boundaries -> to_storage
    and the oracle's force gather. Bars: f' 5e-6 (3e-4 in bf16 storage),
    forces 1e-6 of the largest |F|."""
    import torch
    from lbmdem_tpu_torch.ops import lbm as tlbm

    cfg, arrs, f = _setup(**kw)
    xs = [jx(a) for a in arrs]
    fs = jlbm.to_storage(jx(f), cfg)
    eps, usx, usy = jimb.stamp_solid_fraction(*xs, cfg)
    if cfg.bc_west == "inlet":
        eps, usx, usy = jimb.mask_open_columns(eps, usx, usy)
    fpost, phix, phiy = jimb.collide_imb(jlbm.from_storage(fs, cfg), eps,
                                         usx, usy, cfg)
    jf = jlbm.to_storage(jlbm.apply_open_boundaries(
        jlbm.apply_bounce_back(jlbm.stream(fpost), fpost, cfg), cfg), cfg)
    jF, _ = jimb.reduce_hydro_forces(xs[0], xs[3], xs[4], eps, phix, phiy,
                                     cfg)
    tcfg = to_torch_cfg(cfg)
    td, cnt, es, _ = stamp.bin_disks_to_tiles(*[tt(a) for a in arrs], tcfg)
    solid = stamp.stamp_fields(td, cnt, tcfg)
    if cfg.bc_west == "inlet":
        solid[:, :, 0].zero_()
        solid[:, :, -1].zero_()
    fin = tlbm.to_storage(tt(f), tcfg)
    tf, parts = fused_lbm.fused_step_imb_reduce(fin, solid, td, cnt, tcfg,
                                                torch.empty_like(fin))
    tF, _ = stamp.gather_partials(parts, es, torch.float32)
    tol = 3e-4 if cfg.f_storage == "bfloat16" else 5e-6
    assert tf.dtype == fin.dtype
    np.testing.assert_allclose(np.asarray(jf, np.float32),
                               npy(tf.to(torch.float32)), rtol=0, atol=tol)
    scale = float(np.abs(npy(jF)).max())
    assert scale > 0
    np.testing.assert_allclose(npy(jF), npy(tF), rtol=0, atol=1e-6 * scale)


def test_out_must_be_a_second_buffer():
    cfg, arrs, f = _setup()
    tcfg = to_torch_cfg(cfg)
    td, cnt, _, _ = stamp.bin_disks_to_tiles(*[tt(a) for a in arrs], tcfg)
    solid = stamp.stamp_fields(td, cnt, tcfg)
    fin = tt(f)
    with pytest.raises(ValueError, match="second"):
        fused_lbm.fused_step_imb_reduce(fin, solid, td, cnt, tcfg, fin)
