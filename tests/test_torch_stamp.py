"""ops/stamp.py of the port (binning glue + K1's plain version) against
the JAX package: the Pallas stamp lbmdem_tpu/ops/pallas_stamp.py in
interpret mode, and the oracle imb.stamp_solid_fraction.

The JAX binning sorts are not stable, so slot order within a tile may
differ: lists and records compare as sets per tile. Stamp bar 1e-6
(test_pallas_stamp.py's); f64 1e-12 (sums of exact 1/16 steps)."""

import numpy as np
import pytest

from lbmdem_tpu.config import SimConfig as JCfg, window_for_radius
from lbmdem_tpu.ops import imb as jimb
from lbmdem_tpu.ops import pallas_stamp as ps
from lbmdem_tpu_torch.ops import stamp

from torch_parity_util import (DTYPES, jx, npy, random_disks, to_torch_cfg,
                               tt)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _setup(dtype="float32", n=24, seed=1, cap=32, **kw):
    cfg = JCfg(nx=256, ny=128, tau=0.8, dtype=dtype, max_disks=n,
               window=window_for_radius(4.0), tile_cap=cap,
               bc_west="wall", bc_east="wall", **kw)
    x, v, om, r, act = random_disks(n, 256, 128, seed, n_inactive=4)
    x[0] = (1.0, 1.0)  # windows reaching outside the domain
    x[1] = (254.5, 126.0)
    x[2] = (127.6, 64.2)  # straddles 4 tiles
    return cfg, [a.astype(dtype) for a in (x, v, om, r)] + [act]


@pytest.mark.parametrize("nx,ny,r", [(256, 128, 4.0), (4096, 4096, 8.0),
                                     (96, 64, 2.0), (384, 192, 4.0)])
def test_tile_geometry_matches(nx, ny, r):
    cfg = JCfg(nx=nx, ny=ny, window=window_for_radius(r), tile_cap=8)
    th, tw = stamp.tile_dims(to_torch_cfg(cfg))
    assert (th, tw) == ps.tile_dims(cfg)
    w = cfg.window + 4
    assert stamp.band_height(cfg.window, th) == ps.band_height(cfg.window, th)
    assert stamp.default_tile_cap(th, tw, r, w) == \
        ps.default_tile_cap(th, tw, r, w)


def _tile_sets(lists):
    return [set(int(d) for d in row if d >= 0) for row in npy(lists)]


@pytest.mark.parametrize("margin", [0, 2])
def test_build_tile_lists_as_sets(margin):
    cfg, (x, v, om, r, act) = _setup()
    jl, jc, je, jo = ps.build_tile_lists(jx(x), jx(act), cfg, margin=margin)
    tl, tc, te, to = stamp.build_tile_lists(tt(x), tt(act), to_torch_cfg(cfg),
                                            margin=margin)
    np.testing.assert_array_equal(npy(jc), npy(tc))
    assert int(jo) == int(to) == 0
    assert _tile_sets(jl) == _tile_sets(tl)
    cap = cfg.tile_cap
    te_n, tl_n = npy(te), npy(tl).reshape(-1)
    for d in range(x.shape[0]):
        jt = sorted(int(s) // cap for s in npy(je)[d] if s >= 0)
        tt_ = sorted(int(s) // cap for s in te_n[d] if s >= 0)
        assert jt == tt_, d
        for s in te_n[d]:  # the inverse map points back at the disk
            if s >= 0:
                assert tl_n[s] == d
    # the slot order within a tile follows disk order (stable sort)
    for row in npy(tl):
        live = row[row >= 0]
        assert (np.diff(live) > 0).all()


def test_bin_overflow_counted():
    cfg, _ = _setup(cap=2)
    x = np.array([[64.0 + i, 64.0] for i in range(6)], np.float32)
    act = np.ones(6, bool)
    jo = ps.build_tile_lists(jx(x), jx(act), cfg)[3]
    to = stamp.build_tile_lists(tt(x), tt(act), to_torch_cfg(cfg))[3]
    assert int(to) == int(jo) > 0


def test_gather_tile_data_as_sets():
    cfg, (x, v, om, r, act) = _setup()
    jl = ps.build_tile_lists(jx(x), jx(act), cfg)[0]
    tl = stamp.build_tile_lists(tt(x), tt(act), to_torch_cfg(cfg))[0]
    jd = npy(ps.gather_tile_data(jl, jx(x), jx(v), jx(om), jx(r), jx(act)))
    td = npy(stamp.gather_tile_data(tl, tt(x), tt(v), tt(om), tt(r),
                                    tt(act)))
    assert jd.shape == td.shape
    for a, b in zip(jd.reshape(jd.shape[0], -1, 8),
                    td.reshape(td.shape[0], -1, 8)):
        np.testing.assert_array_equal(np.unique(a, axis=0),
                                      np.unique(b, axis=0))


def _port_stamp(x, v, om, r, act, cfg):
    tcfg = to_torch_cfg(cfg)
    td, cnt, _, ovf = stamp.bin_disks_to_tiles(tt(x), tt(v), tt(om), tt(r),
                                               tt(act), tcfg)
    assert int(ovf) == 0
    return stamp.stamp_fields(td, cnt, tcfg)


def test_stamp_plain_matches_pallas_interpret():
    """K1's plain version against the TPU kernel run in interpret mode."""
    cfg, arrs = _setup()
    je, jux, juy, jo = ps.stamp_solid_fraction(*[jx(a) for a in arrs], cfg)
    assert int(jo) == 0
    launches = stamp.stamp_fields.launches
    t = _port_stamp(*arrs, cfg)
    assert stamp.stamp_fields.launches == launches  # CPU: no kernel launch
    for a, b in zip((je, jux, juy), t):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stamp_plain_matches_oracle(dtype):
    """K1's plain version against the per-disk scatter oracle."""
    cfg, arrs = _setup(dtype, seed=5)
    j = jimb.stamp_solid_fraction(*[jx(a) for a in arrs], cfg)
    t = _port_stamp(*arrs, cfg)
    tol = {"float32": 1e-6, "float64": 1e-12}[dtype]
    for a, b in zip(j, t):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=tol)


def test_stamp_r_shift_matches_oracle():
    cfg, arrs = _setup("float64", seed=6, eps_r_shift=-0.3)
    j = jimb.stamp_solid_fraction(*[jx(a) for a in arrs], cfg)
    t = _port_stamp(*arrs, cfg)
    for a, b in zip(j, t):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=1e-12)


def test_gather_partials_matches():
    cfg, (x, v, om, r, act) = _setup()
    _, _, te, _ = stamp.build_tile_lists(tt(x), tt(act), to_torch_cfg(cfg))
    n_rows = (256 // 128) * (128 // 128) * cfg.tile_cap
    flat = np.random.default_rng(3).standard_normal((n_rows, 4)).astype(
        np.float32)
    jF, jT = ps.gather_partials(jx(flat), jx(te), np.float32)
    tF, tT = stamp.gather_partials(tt(flat), te, tt(flat).dtype)
    np.testing.assert_array_equal(npy(jF), npy(tF))
    np.testing.assert_array_equal(npy(jT), npy(tT))


def test_stamp_rejects_unported_coverage():
    cfg, (x, v, om, r, act) = _setup(eps_method="ramp")
    tcfg = to_torch_cfg(cfg)
    td, cnt, _, _ = stamp.bin_disks_to_tiles(tt(x), tt(v), tt(om), tt(r),
                                             tt(act), tcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        stamp.stamp_fields(td, cnt, tcfg)
