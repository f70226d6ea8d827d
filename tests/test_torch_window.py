"""The port's coupling_k window path against the JAX package on CPU: K6's
plain version against the Pallas fused_step_imb_reduce_multi in
interpret mode, K3w's plain version (with the slim slab build and
_force_planes_window) against the Pallas dem_subcycle_window in
interpret mode, the window step and Simulation.run against the plain-JAX
windowed oracle (make_step_fn(use_pallas=False, coupling_k=k)), and a
coupling_k=4 settling run against the f64 per-step golden.

Bars: K6 f 1e-6 against the Pallas kernel (tests/test_pallas.py's
kernel-vs-windowed-oracle bar), per-disk forces 1e-6 relative to the
largest |F| and torques 2e-6 relative to the largest |T| (K2's bars:
the gather order differs); K3w x/v/omega 2e-5 with equal contacts
(test_pallas_dem.py's slab bar); float64 window step and run 1e-9 (the
same arithmetic in other summation orders, ~1e-15 per step); settling
vy within 1 % of the golden's scale (tools/validate_tpu.py's couplingk
leg)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.models import column_collapse
from lbmdem_tpu.ops import dem as jdem, pallas_dem
from lbmdem_tpu.ops import pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu.ops.dem import DemGrid as JGrid
from lbmdem_tpu.simulation import Simulation as JSim, make_step_fn as jstep_fn
from lbmdem_tpu_torch import Simulation, simulation
from lbmdem_tpu_torch.ops import dem as tdem, fused_lbm, slab_dem, stamp
from lbmdem_tpu_torch.ops.dem import DemGrid as TGrid

from torch_parity_util import (jx, npy, perturbed_f, to_torch_cfg,
                               to_torch_disks, tt)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _counters():
    return (stamp.stamp_fields.launches,
            fused_lbm.fused_step_imb_reduce.launches,
            fused_lbm.fused_step_imb_reduce_multi.launches,
            slab_dem.subcycle_slabs.launches,
            slab_dem.subcycle_slabs_window.launches)


def test_k6_plain_matches_pallas_interpret():
    """K6's plain version against the TPU kernel in interpret mode, at
    the JAX quick-lane size (128x32, k = 2): the same solid stack, each
    package binning for itself; forces compared after gather_partials,
    in disk order, for every inner step."""
    k = 2
    cfg = JCfg(nx=128, ny=32, tau=0.8, dtype="float32", g_py=-1e-4,
               buoyancy=True, rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=2,
               bc_west="wall", bc_east="wall", uw_north=0.02)
    disks = [JDisk(40.0, 16.0, 3.0, vx=0.01, vy=-0.02, omega=0.003),
             JDisk(100.2, 20.1, 2.5, vx=0.01),
             JDisk(70.0, 24.0, 2.0, omega=0.004), JDisk(2.4, 9.0, 2.0)]
    js = JSim(cfg, disks, use_pallas=True)
    cfg, d = js.cfg, js.state.disks
    f = perturbed_f((9, cfg.ny, cfg.nx), 21, np.float32)
    lists, counts, es, ovf = ps.build_tile_lists(d.x, d.active, cfg)
    assert int(ovf) == 0
    td = ps.gather_tile_data(lists, d.x, d.v, d.omega, d.r, d.active)
    solid, _ = ps.stamp_solid_fraction(d.x, d.v, d.omega, d.r, d.active, cfg,
                                       binned=(td, counts, None, None),
                                       as_stack=True)
    jf, jparts = pk.fused_step_imb_reduce_multi(jx(f), solid, cfg, k, td,
                                                counts)

    tcfg = to_torch_cfg(cfg)
    x, v, om, r, act = (tt(np.asarray(a)) for a in
                        (d.x, d.v, d.omega, d.r, d.active))
    tdp, cnt, esp, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, tcfg)
    assert int(ovf) == 0
    n0 = _counters()
    fin = tt(f)
    out = torch.empty_like(fin)
    tf, parts = fused_lbm.fused_step_imb_reduce_multi(
        fin, tt(np.asarray(solid)), tdp, cnt, tcfg, k, out)
    assert _counters() == n0  # CPU tensors: the plain version
    assert tf is out and parts.shape == (k, tdp.shape[0] * tcfg.tile_cap, 4)
    np.testing.assert_array_equal(npy(fin), f)  # f itself is not written
    np.testing.assert_allclose(np.asarray(jf), npy(tf), rtol=0, atol=1e-6)
    for t in range(k):
        jF, jT = ps.gather_partials(jparts[t], es, np.float32)
        tF, tT = stamp.gather_partials(parts[t], esp, torch.float32)
        fs, ts = float(np.abs(jF).max()), float(np.abs(jT).max())
        assert fs > 0 and ts > 0
        np.testing.assert_allclose(np.asarray(jF), npy(tF), rtol=0,
                                   atol=1e-6 * fs, err_msg=f"step {t}")
        np.testing.assert_allclose(np.asarray(jT), npy(tT), rtol=0,
                                   atol=2e-6 * ts, err_msg=f"step {t}")
    # the inner steps see different f, so their forces differ
    assert not np.array_equal(npy(parts[0]), npy(parts[1]))


def _dem_cfg(dtype="float32", **kw):
    base = dict(nx=128, ny=128, tau=0.8, dtype=dtype, max_disks=24, kn=2.0,
                gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0, n_sub=6,
                bc_west="wall", bc_east="wall", g_py=-1e-4, buoyancy=True)
    base.update(kw)
    return JCfg(**base)


def _dense_specs(cfg, n=24, seed=3, r=3.0):
    """A dense random cluster (many contacts), plus disks on two walls."""
    rng = np.random.default_rng(seed)
    specs = [JDisk(rng.uniform(20.0, 60.0), rng.uniform(20.0, 60.0), r,
                   rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                   rng.uniform(-0.01, 0.01)) for _ in range(n - 2)]
    specs.append(JDisk(2.2, 90.0, r, vx=-0.02))
    specs.append(JDisk(100.0, cfg.ny - 3.0, r, vy=0.03))
    return specs


def _window_forces(n, k, dtype, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1e-3, 1e-3, (n, 2)).astype(dtype),
             rng.uniform(-1e-4, 1e-4, n).astype(dtype)) for _ in range(k)]


def test_force_planes_window_matches_jax():
    """All k force planes in one scatter; an unslotted disk (-1) lands
    nowhere (never wrapped onto the last slot)."""
    cfg = _dem_cfg()
    specs = _dense_specs(cfg)
    jd = jdem.make_disk_state(specs, cfg, "float32")
    td = tdem.make_disk_state(to_torch_disks(specs), to_torch_cfg(cfg),
                              "float32")
    grid = TGrid.build(to_torch_cfg(cfg), 3.0)
    slabs, slot, _, _, _, _ = slab_dem.build_slabs(
        td, None, None, tdem.body_forces(td, to_torch_cfg(cfg)), grid, "x",
        bake_forces=False)
    assert slabs.shape[0] == 8
    slot = slot.clone()
    slot[5] = -1
    forces = _window_forces(24, 3, np.float32)
    body = np.asarray(jdem.body_forces(jd, cfg))
    jp = pallas_dem._force_planes_window(
        jnp.asarray(npy(slot)), [(jx(a), jx(b)) for a, b in forces],
        jx(body), tuple(slabs.shape))
    tp = slab_dem._force_planes_window(
        slot, [(tt(a), tt(b)) for a, b in forces], tt(body), slabs.shape)
    assert tp.shape == (3, 3) + tuple(slabs.shape[1:])
    np.testing.assert_array_equal(np.asarray(jp), npy(tp))
    assert float(tp.reshape(3, 3, -1)[:, :, -1].abs().max()) == 0.0
    assert int((tp[0, 0] != 0).sum()) == 23  # 24 disks, one unslotted


def test_k3w_plain_matches_pallas_interpret():
    """K3w's plain version, chained over a 2-step window on one slim slab
    build, against the TPU kernel in interpret mode on a packed cluster
    with wall contacts (the slice's plane orientation, x)."""
    cfg = _dem_cfg()
    specs = _dense_specs(cfg, seed=6)  # no disk travels past skin / 2
    jd = jdem.make_disk_state(specs, cfg, "float32")
    td = tdem.make_disk_state(to_torch_disks(specs), to_torch_cfg(cfg),
                              "float32")
    forces = _window_forces(24, 2, np.float32)
    jr = jax.jit(pallas_dem.dem_subcycle_window, static_argnums=(2, 3, 4))(
        jd, [(jx(a), jx(b)) for a, b in forces], JGrid.build(cfg, 3.0), cfg,
        "x")
    n0 = _counters()
    tr = slab_dem.dem_subcycle_window(
        td, [(tt(a), tt(b)) for a, b in forces],
        TGrid.build(to_torch_cfg(cfg), 3.0), to_torch_cfg(cfg), "x")
    assert _counters() == n0  # CPU tensors: the plain version
    (jdd, jovf, jnc), (tdd, tovf, tnc) = jr, tr
    assert int(jovf) == int(tovf) == 0
    assert int(tnc) > 0 and int(jnc) == int(tnc)
    for name in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jdd, name)),
                                   npy(getattr(tdd, name)), rtol=0,
                                   atol=2e-5, err_msg=name)
    assert float((tdd.x - td.x).abs().max()) > 0


def test_window_staleness_counted():
    """A disk that travels beyond skin / 2 over the window is counted
    into overflow after the fact (the slot-staleness detector)."""
    cfg = _dem_cfg("float64", g_py=0.0, buoyancy=False)
    fast = JDisk(64.0, 64.0, 3.0, vx=1.0)  # 4 cells in 4 inner steps
    specs = [fast, JDisk(20.0, 100.0, 3.0)]
    tcfg = to_torch_cfg(cfg)
    td = tdem.make_disk_state(to_torch_disks(specs), tcfg, "float64")
    grid = TGrid.build(tcfg, 3.0)
    assert 0.5 * grid.skin < 4.0
    n = td.x.shape[0]
    z = [(torch.zeros((n, 2), dtype=torch.float64),
          torch.zeros(n, dtype=torch.float64))] * 4
    new, ovf, _ = slab_dem.dem_subcycle_window(td, z, grid, tcfg, "x")
    assert int(ovf) == 1
    np.testing.assert_allclose(npy(new.x)[0], [68.0, 64.0], atol=1e-12)


def _contact_scene():
    """A square pack on the floor, each disk 0.1 into its neighbours:
    contacts from the first step (f64)."""
    cfg, _ = column_collapse(nx=128, ny=128, n_disks=30, r=3.0)
    rng = np.random.default_rng(9)
    disks = [JDisk(10.0 + 5.9 * i + rng.uniform(-0.05, 0.05),
                   2.6 + 5.9 * j + rng.uniform(-0.05, 0.05), 3.0,
                   rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02))
             for i in range(6) for j in range(5)]
    return cfg.replace(dtype="float64", g_py=-1e-3), disks


def _assert_state_close(jst, tst, tol):
    np.testing.assert_allclose(np.asarray(jst.f), npy(tst.f), rtol=0,
                               atol=tol)
    for name in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jst.disks, name)),
                                   npy(getattr(tst.disks, name)), rtol=0,
                                   atol=tol, err_msg=name)
    assert int(jst.overflow) == int(tst.overflow) == 0
    assert int(jst.n_contacts) == int(tst.n_contacts)
    assert int(jst.step) == int(tst.step)


@pytest.mark.parametrize("k", [2, 4])
def test_window_step_matches_windowed_oracle(k):
    """Two windows of make_step_fn(..., coupling_k=k) (fresh binning,
    the plain versions of K1, K6 and K3w) against the JAX oracle of the
    same windowed semantics, in float64, on a packed scene with
    contacts."""
    cfg, disks = _contact_scene()
    js = JSim(cfg, disks)
    jstep = jax.jit(jstep_fn(js.cfg, js.grid, False, dem_axis=js.dem_axis,
                             coupling_k=k))
    sim = Simulation(to_torch_cfg(cfg.replace(coupling_k=k)),
                     to_torch_disks(disks), device="cpu")
    assert sim.dem_axis == js.dem_axis
    tstep = simulation.make_step_fn(sim.cfg, sim.grid, None, sim.dem_axis,
                                    coupling_k=k)
    jst, tst = js.state, sim.state
    n0 = _counters()
    for _ in range(2):
        jst = jstep(jst)
        tst = tstep(tst, torch.empty_like(tst.f))
    assert _counters() == n0
    assert int(tst.n_contacts) > 0 and int(tst.step) == 2 * k
    _assert_state_close(jst, tst, 1e-9)


@pytest.mark.parametrize("k", [4, 8])
def test_run_matches_windowed_oracle_split(k):
    """Simulation.run(19) at coupling_k=k (two cadence blocks of 8 steps
    as 8 // k windows each, then 3 per-step steps) against the JAX
    oracle composed in the same split, in float64. The CPU path
    launches no kernel."""
    cfg, disks = column_collapse(nx=128, ny=128, n_disks=40, r=4.0)
    cfg = cfg.replace(dtype="float64")
    js = JSim(cfg, disks)
    wstep = jax.jit(jstep_fn(js.cfg, js.grid, False, dem_axis=js.dem_axis,
                             coupling_k=k))
    pstep = jax.jit(jstep_fn(js.cfg, js.grid, False, dem_axis=js.dem_axis))
    jst = js.state
    for _ in range(2 * (simulation.BIN_CADENCE // k)):
        jst = wstep(jst)
    for _ in range(3):
        jst = pstep(jst)
    sim = Simulation(to_torch_cfg(cfg.replace(coupling_k=k)),
                     to_torch_disks(disks), device="cpu")
    n0 = _counters()
    assert sim.run(19) > 0
    assert _counters() == n0
    _assert_state_close(jst, sim.state, 1e-9)


def test_settling_coupling_k4_within_golden():
    """test_settling_golden's scene (one disk settling in a closed 64x192
    channel, f64) at coupling_k=4 for 1000 steps: the frozen window
    geometry keeps the settling velocity within 1 % of the per-step f64
    golden, measured as max |vy - vy_gold| / max |vy_gold| over the
    rows (tools/validate_tpu.py's couplingk measure)."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig

    cfg = SimConfig(nx=64, ny=192, tau=0.65, dtype="float64", g_py=-2e-5,
                    rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                    bc_west="wall", bc_east="wall", out_interval=100,
                    coupling_k=4)
    sim = Simulation(cfg, [DiskSpec(32.3, 150.0, 5.0)], device="cpu")
    vy = []
    sim.run(1000, callback=lambda s: vy.append(float(s.state.disks.v[0, 1])))
    gold = np.loadtxt(os.path.join(GOLDEN, "settling_r5_f64.csv"))[:len(vy), 2]
    assert len(vy) == 10
    err = np.abs(np.asarray(vy) - gold).max() / np.abs(gold).max()
    assert err < 0.01, err
    assert err > 0.0  # the window is an approximation of per-step coupling
    assert int(sim.state.overflow) == 0
