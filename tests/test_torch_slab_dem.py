"""ops/slab_dem.py and ops/dem.py of the port (K3's plain version and
its glue) against the JAX package: the Pallas slab subcycle
lbmdem_tpu/ops/pallas_dem.py in interpret mode, and the cell-list
oracle dem.dem_subcycle.

The JAX cell ranks come from an unstable sort, so slabs compare as sets
per cell. Bars: x/v/omega 2e-5 in f32 (test_pallas_dem.py's
slab-vs-oracle bar), 1e-12 in f64 (same pairs, other summation order);
contact counts equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.ops import dem as jdem, pallas_dem
from lbmdem_tpu.ops.dem import DemGrid as JGrid
from lbmdem_tpu_torch.ops import dem as tdem, slab_dem
from lbmdem_tpu_torch.ops.dem import DemGrid as TGrid
from lbmdem_tpu_torch.utils import profiling

from torch_parity_util import (DTYPES, jx, npy, to_torch_cfg,
                               to_torch_disks, tt)


def _cfg(dtype="float32", **kw):
    base = dict(nx=128, ny=128, tau=0.8, dtype=dtype, max_disks=24, kn=2.0,
                gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0, n_sub=6,
                bc_west="wall", bc_east="wall", g_py=-1e-4, buoyancy=False)
    base.update(kw)
    return JCfg(**base)


def _specs(n=24, seed=3, lo=20.0, hi=60.0, r=3.0, cfg=None):
    """A dense random cluster (many contacts), plus disks on the walls."""
    rng = np.random.default_rng(seed)
    specs = [JDisk(rng.uniform(lo, hi), rng.uniform(lo, hi), r,
                   rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                   rng.uniform(-0.01, 0.01)) for _ in range(n - 2)]
    specs.append(JDisk(2.2, 90.0, r, vx=-0.02))            # on the west wall
    specs.append(JDisk(100.0, cfg.ny - 3.0, r, vy=0.03))   # on the north wall
    return specs


def _states(cfg, specs, dtype):
    jd = jdem.make_disk_state(specs, cfg, dtype)
    td = tdem.make_disk_state(to_torch_disks(specs), to_torch_cfg(cfg), dtype)
    return jd, td


def _forces(n, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1e-3, 1e-3, (n, 2)).astype(dtype),
            rng.uniform(-1e-4, 1e-4, n).astype(dtype))


def test_disk_state_and_grid_match():
    cfg = _cfg(max_disks=30)
    specs = _specs(cfg=cfg) + [JDisk(50.0, 50.0, 2.0, fixed=True, rho_s=3.0)]
    jd, td = _states(cfg, specs, "float64")
    for k in jdem.DiskState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jd, k)),
                                      npy(getattr(td, k)), err_msg=k)
    assert dataclasses.asdict(JGrid.build(cfg, 3.0)) == \
        dataclasses.asdict(TGrid.build(to_torch_cfg(cfg), 3.0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cell_ids_pair_wall_body_forces(dtype):
    cfg = _cfg(dtype, buoyancy=True)
    jd, td = _states(cfg, _specs(cfg=cfg), dtype)
    grid = JGrid.build(cfg, 3.0)
    np.testing.assert_array_equal(
        npy(jdem._cell_ids(jd.x, jd.active, grid)),
        npy(tdem._cell_ids(td.x, td.active, TGrid.build(to_torch_cfg(cfg),
                                                        3.0))))
    tol = {"float32": 1e-6, "float64": 1e-13}[dtype]
    jF, jT, _ = jdem.wall_forces(jd, cfg)
    tF, tT = tdem.wall_forces(td, to_torch_cfg(cfg))
    assert float(np.abs(npy(jF)).max()) > 0  # the wall disks touch
    np.testing.assert_allclose(npy(jF), npy(tF), rtol=0, atol=tol)
    np.testing.assert_allclose(npy(jT), npy(tT), rtol=0, atol=tol)
    np.testing.assert_allclose(npy(jdem.body_forces(jd, cfg)),
                               npy(tdem.body_forces(td, to_torch_cfg(cfg))),
                               rtol=0, atol=tol)
    # the pair law between the first disk and all others
    m = jnp.arange(jd.x.shape[0]) > 0
    jp = jdem._pair_force(jd.x[0], jd.v[0], jd.omega[0], jd.r[0], jd.x,
                          jd.v, jd.omega, jd.r, m, cfg, jd.x.dtype)
    tp = tdem._pair_force(td.x[0], td.v[0], td.omega[0], td.r[0], td.x,
                          td.v, td.omega, td.r, tt(np.asarray(m)),
                          to_torch_cfg(cfg))
    for a, b in zip((jp[0], jp[1], jp[3]), tp):
        np.testing.assert_allclose(npy(a), npy(b), rtol=0, atol=tol)


@pytest.mark.parametrize("nx,ny,r,axis", [(128, 128, 3.0, "y"),
                                          (4096, 4096, 8.0, "x"),
                                          (256, 96, 2.5, "x")])
def test_slab_geometry_matches(nx, ny, r, axis):
    cfg = _cfg(nx=nx, ny=ny)
    jg, tg = JGrid.build(cfg, r), TGrid.build(to_torch_cfg(cfg), r)
    assert pallas_dem.slab_dims(jg, axis) == slab_dem.slab_dims(tg, axis)
    assert pallas_dem.slab_supported(jg, axis) == \
        slab_dem.slab_supported(tg, axis)
    specs = _specs(cfg=cfg)
    assert pallas_dem.choose_axis(specs, cfg) == slab_dem.choose_axis(
        to_torch_disks(specs), to_torch_cfg(cfg))


@pytest.mark.parametrize("axis", ["y", "x"])
def test_build_slabs_as_sets(axis):
    cfg = _cfg()
    jd, td = _states(cfg, _specs(cfg=cfg), "float32")
    fh, th = _forces(24, np.float32)
    jg = JGrid.build(cfg, 3.0)
    body = jdem.body_forces(jd, cfg)
    js, jslot, jovf, jk, jn, jb, _ = pallas_dem.build_slabs(
        jd, jx(fh), jx(th), body, jg, axis)
    ts, tslot, tovf, tk, tn, tb, _ = slab_dem.build_slabs(
        td, tt(fh), tt(th), tdem.body_forces(td, to_torch_cfg(cfg)),
        TGrid.build(to_torch_cfg(cfg), 3.0), axis)
    assert int(jovf) == int(tovf) == 0
    assert int(jk) == int(tk) and int(jn) == int(tn) > 0
    np.testing.assert_array_equal(npy(jb), npy(tb))
    nch, K, R, C = js.shape
    np.testing.assert_array_equal(npy(jslot) % (R * C), npy(tslot) % (R * C))
    jr = npy(js).reshape(nch, K, R * C).transpose(2, 1, 0)
    tr = npy(ts).reshape(nch, K, R * C).transpose(2, 1, 0)
    for a, b in zip(jr, tr):  # per cell: its K records as a set
        np.testing.assert_array_equal(np.unique(a, axis=0),
                                      np.unique(b, axis=0))


def _subcycle_both(cfg, specs, dtype, axis, jax_fn):
    jd, td = _states(cfg, specs, dtype)
    n = len(specs)
    fh, th = _forces(n, dtype)
    r_max = max(s.r for s in specs)
    jg = JGrid.build(cfg, r_max)
    args = (jd, jx(fh), jx(th), jg, cfg)
    if jax_fn is pallas_dem.dem_subcycle:
        jr = jax.jit(jax_fn, static_argnums=(3, 4, 5))(*args, axis)
    else:
        jr = jax.jit(jax_fn, static_argnums=(3, 4))(*args)
    launches = slab_dem.subcycle_slabs.launches
    tr = slab_dem.dem_subcycle(td, tt(fh), tt(th),
                               TGrid.build(to_torch_cfg(cfg), r_max),
                               to_torch_cfg(cfg), axis)
    assert slab_dem.subcycle_slabs.launches == launches  # CPU: no kernel
    return jd, jr, tr


def _assert_disks_close(jr, tr, tol):
    (jdd, jovf, jnc), (tdd, tovf, tnc) = jr, tr
    assert int(jovf) == int(tovf) == 0
    assert int(tnc) > 0 and int(jnc) == int(tnc)
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jdd, k)),
                                   npy(getattr(tdd, k)), rtol=0, atol=tol,
                                   err_msg=k)


def test_plain_matches_pallas_interpret():
    """K3's plain version (with build_slabs/_unslab) against the TPU
    kernel in interpret mode, on the slice's plane orientation (x)."""
    cfg = _cfg()
    _, jr, tr = _subcycle_both(cfg, _specs(cfg=cfg), "float32", "x",
                               pallas_dem.dem_subcycle)
    _assert_disks_close(jr, tr, 2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", ["y", "x"])
def test_plain_matches_cell_list_oracle(dtype, axis):
    cfg = _cfg(dtype, n_sub=10)
    _, jr, tr = _subcycle_both(cfg, _specs(cfg=cfg, seed=5), dtype, axis,
                               jdem.dem_subcycle)
    _assert_disks_close(jr, tr, {"float32": 2e-5, "float64": 1e-12}[dtype])


def test_fixed_disks_drift_in_slab():
    """Fixed disks (minv 0) keep their prescribed v/omega and drift."""
    cfg = _cfg("float64", max_disks=4)
    specs = [JDisk(40.0, 40.0, 3.0, vx=0.01, omega=0.002, fixed=True),
             JDisk(45.5, 40.0, 3.0), JDisk(80.0, 80.0, 3.0, vy=-0.02),
             JDisk(84.0, 83.0, 3.0)]
    jd, jr, tr = _subcycle_both(cfg, specs, "float64", "y", jdem.dem_subcycle)
    _assert_disks_close(jr, tr, 1e-12)
    np.testing.assert_allclose(npy(tr[0].v[0]), [0.01, 0.0], atol=0)


def test_leftover_fallback_matches():
    """Active disks the slab cannot slot integrate contact-free with
    walls + hydro + body forces, as the JAX fallback."""
    cfg = _cfg("float64", buoyancy=True)
    jd, td = _states(cfg, _specs(cfg=cfg), "float64")
    fh, th = _forces(24, np.float64)
    leftover = np.zeros(24, bool)
    leftover[[3, 22, 23]] = True
    jb = jdem.body_forces(jd, cfg)
    jnew = pallas_dem._leftover_fallback(jd, jd, jx(leftover), jnp.int32(3),
                                         jx(fh), jx(th), jb, cfg)
    tnew = slab_dem._leftover_fallback(
        td, td, tt(leftover), tt(np.int32(3)), tt(fh), tt(th),
        tdem.body_forces(td, to_torch_cfg(cfg)), to_torch_cfg(cfg))
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jnew, k)),
                                   npy(getattr(tnew, k)), rtol=0, atol=1e-13)
    assert float(abs(npy(tnew.x) - npy(td.x)).max()) > 0
    same = slab_dem._leftover_fallback(td, td, tt(leftover), tt(np.int32(0)),
                                       tt(fh), tt(th), tt(np.asarray(jb)),
                                       to_torch_cfg(cfg))
    assert same is td  # no overflow: nothing to integrate


def test_slab_overflow_counted_and_fallback_runs():
    """Five disks in one broadphase cell: one cannot be slotted (K = 4);
    it is counted and still moves."""
    cfg = _cfg("float64", max_disks=5, g_py=-1e-2)
    # apart (no contacts), all in broadphase cell (8, 8) of side 7
    specs = [JDisk(56.0 + 1.2 * i, 57.0 + 1.2 * i, 0.4) for i in range(5)]
    jd, td = _states(cfg, specs, "float64")
    z2, z1 = tt(np.zeros((5, 2))), tt(np.zeros(5))
    new, ovf, _ = slab_dem.dem_subcycle(td, z2, z1,
                                        TGrid.build(to_torch_cfg(cfg), 3.0),
                                        to_torch_cfg(cfg), "y")
    assert int(ovf) == 1
    assert (npy(new.x)[:, 1] < npy(td.x)[:, 1]).all()  # every disk fell


def _wall_overflow_scene():
    """Five apart disks in one broadphase cell at the west wall, in disk
    order away from it: the last, which touches the wall, is the one the
    slab cannot slot (K = 4)."""
    cfg = to_torch_cfg(_cfg(max_disks=5, g_py=-1e-2))
    specs = [JDisk(5.2 - 1.3 * i, 43.0 + 1.3 * i, 0.6, vx=-0.01 * i)
             for i in range(5)]
    td = tdem.make_disk_state(to_torch_disks(specs), cfg, "float32")
    return cfg, td, TGrid.build(cfg, 3.0)


def test_window_leftover_moves_as_chained_fallback():
    """In a coupling_k = 4 window the unslotted disk moves exactly as 4
    chained _fallback_integrate calls, one per inner step's forces."""
    cfg, td, grid = _wall_overflow_scene()
    rng = np.random.default_rng(7)
    forces = [(tt(rng.uniform(-1e-2, 1e-2, (5, 2)).astype(np.float32)),
               tt(rng.uniform(-1e-3, 1e-3, 5).astype(np.float32)))
              for _ in range(4)]
    body_f = tdem.body_forces(td, cfg)
    slot = slab_dem.build_slabs(td, None, None, body_f, grid, "y",
                                bake_forces=False)[1]
    leftover = td.active & (slot < 0)
    assert npy(leftover).tolist() == [False] * 4 + [True]
    new, ovf, _ = slab_dem.dem_subcycle_window(td, forces, grid, cfg, "y")
    d = td
    for fh, th in forces:
        d = slab_dem._fallback_integrate(d, leftover, fh, th, body_f, cfg)
    assert int(ovf) == 1
    assert not torch.equal(d.x[4], td.x[4])
    for k in ("x", "v", "omega", "theta"):
        assert torch.equal(getattr(new, k)[4], getattr(d, k)[4]), k


def test_window_with_overflow_matches_pallas():
    """The overflow scene's coupling_k = 4 window against the Pallas
    dem_subcycle_window in interpret mode, which chains the unslotted
    disk's fallback through the inner steps as well: every disk's x, v,
    omega and theta at the slab bar (2e-5), overflow 1 on both."""
    cfg = _cfg(max_disks=5, g_py=-1e-2)
    specs = [JDisk(5.2 - 1.3 * i, 43.0 + 1.3 * i, 0.6, vx=-0.01 * i)
             for i in range(5)]
    jd, td = _states(cfg, specs, "float32")
    rng = np.random.default_rng(7)
    forces = [(rng.uniform(-1e-2, 1e-2, (5, 2)).astype(np.float32),
               rng.uniform(-1e-3, 1e-3, 5).astype(np.float32))
              for _ in range(4)]
    jnew, jovf, _ = jax.jit(pallas_dem.dem_subcycle_window,
                            static_argnums=(2, 3, 4))(
        jd, [(jx(a), jx(b)) for a, b in forces], JGrid.build(cfg, 3.0), cfg,
        "y")
    tnew, tovf, _ = slab_dem.dem_subcycle_window(
        td, [(tt(a), tt(b)) for a, b in forces],
        TGrid.build(to_torch_cfg(cfg), 3.0), to_torch_cfg(cfg), "y")
    assert int(jovf) == int(tovf) == 1
    assert not torch.equal(tnew.x[4], td.x[4])  # the unslotted disk moved
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jnew, k)),
                                   npy(getattr(tnew, k)), rtol=0, atol=2e-5,
                                   err_msg=k)


def test_fallback_steps_counts_overflow_steps():
    """counters()["fallback_steps"] counts the steps in which the
    fallback integrated a disk: each step of the overflow scene, each
    inner step of its window, and no step of a scene without overflow."""
    cfg = _cfg("float64", max_disks=5, g_py=-1e-2)
    specs = [JDisk(56.0 + 1.2 * i, 57.0 + 1.2 * i, 0.4) for i in range(5)]
    tcfg = to_torch_cfg(cfg)
    td = tdem.make_disk_state(to_torch_disks(specs), tcfg, "float64")
    grid = TGrid.build(tcfg, 3.0)
    z2, z1 = tt(np.zeros((5, 2))), tt(np.zeros(5))
    c0 = profiling.counters()["fallback_steps"]
    d = td
    for _ in range(3):
        d, ovf, _ = slab_dem.dem_subcycle(d, z2, z1, grid, tcfg, "y")
        assert int(ovf) == 1
    assert profiling.counters()["fallback_steps"] - c0 == 3
    slab_dem.dem_subcycle_window(d, [(z2, z1)] * 4, grid, tcfg, "y")
    assert profiling.counters()["fallback_steps"] - c0 == 3 + 4
    apart = tdem.make_disk_state(to_torch_disks(specs[:4]), tcfg, "float64")
    _, ovf, _ = slab_dem.dem_subcycle(apart, z2, z1, grid, tcfg, "y")
    assert int(ovf) == 0
    assert profiling.counters()["fallback_steps"] - c0 == 3 + 4


@pytest.mark.parametrize("kw,what", [
    (dict(kt=0.5), "kt > 0"),
    (dict(bc_west="periodic", bc_east="periodic"), "periodic")])
def test_kt_and_periodic_match_cell_list_oracle(kw, what):
    """History springs and a periodic axis (named by `what`): one subcycle of the slab path against the
    JAX cell-list oracle at the slab bars (2e-5; 3e-5 with kt)."""
    cfg = _cfg(**kw)
    jd, td = _states(cfg, _specs(cfg=cfg), "float32")
    fh, th = _forces(24, np.float32)
    jn, jovf, jnc = jdem.dem_subcycle(jd, jx(fh), jx(th),
                                      JGrid.build(cfg, 3.0), cfg)
    tn, tovf, tnc = slab_dem.dem_subcycle(
        td, tt(fh), tt(th), TGrid.build(to_torch_cfg(cfg), 3.0),
        to_torch_cfg(cfg), "y")
    assert int(jovf) == int(tovf) == 0 and int(jnc) == int(tnc) > 0
    tol = 3e-5 if cfg.kt > 0 else 2e-5
    for name in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(npy(getattr(jn, name)),
                                   npy(getattr(tn, name)), rtol=0, atol=tol,
                                   err_msg=name)
