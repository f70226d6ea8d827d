"""The port's split coupled step and the stage-ablation path against the
JAX package on CPU: K8's plain version against the Pallas
fused_step_imb and K9's against the Pallas reduce_hydro_forces (both in
interpret mode), K8 + K9 against K2, the ramp and exact coverage of the
stamp and of Simulation against the JAX oracle, the cell-list DEM
against lbmdem_tpu.ops.dem.dem_subcycle, and the ablation tool's
variants.

Bars: K8 f' rtol 1e-6 + atol 1e-7, phi rtol 1e-5 + atol 5e-8
(tests/test_pallas.py); K9 and the stamp atol 1e-6
(tests/test_pallas_stamp.py); K8 + K9 against K2 f' equal, forces 1e-6;
float64 runs 1e-9 (the same arithmetic in other summation orders); the
cell-list DEM 1e-12 in float64."""

import jax
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.config import window_for_radius
from lbmdem_tpu.ops import dem as jdem, imb as jimb
from lbmdem_tpu.ops import pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu.simulation import Simulation as JSim, make_step_fn as jstep_fn
from lbmdem_tpu_torch import Simulation, simulation
from lbmdem_tpu_torch.ops import dem, fused_lbm, slab_dem, stamp
from lbmdem_tpu_torch.ops.dem import DemGrid as TGrid
from lbmdem_tpu_torch.tools import ablate

from torch_parity_util import (jx, npy, perturbed_f, random_disks,
                               to_torch_cfg, to_torch_disks, tt)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(ps, "_INTERPRET", True)


# --- K8 --------------------------------------------------------------

_ONE_DISK = dict(nx=128, ny=32, dtype="float32", max_disks=1, window=13)
_WALLS = dict(bc_west="wall", bc_east="wall")
K8_CASES = {  # (cfg keywords, disk x, y, vx, vy, omega, r)
    "bgk": (dict(tau=0.8, gy=-1e-5, **_WALLS),
            (64.0, 16.0, 0.01, -0.02, 0.005, 4.0)),
    "lambda": (dict(tau=0.8, gy=-1e-5, nt_mode="lambda", **_WALLS),
               (64.0, 16.0, 0.01, -0.02, 0.005, 4.0)),
    "trt": (dict(tau=0.9, collision="trt", gy=-1e-5),
            (40.0, 16.0, -0.01, 0.02, -0.004, 4.0)),
    "les": (dict(tau=0.6, smagorinsky=0.16, gx=2e-5, **_WALLS),
            (50.0, 14.0, 0.02, 0.0, 0.003, 4.0)),
    "moving-wall": (dict(tau=0.8, uw_north=0.05, uw_south=-0.02, **_WALLS),
                    (70.0, 18.0, 0.0, 0.01, 0.0, 4.0)),
    "zou-he": (dict(tau=0.7, bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                    inlet_profile="poiseuille"),
               (48.0, 16.0, 0.0, 0.0, 0.0, 5.0)),
    "periodic": (dict(tau=0.8, gx=1e-5, bc_south="periodic",
                      bc_north="periodic"),
                 (126.5, 30.5, 0.01, 0.01, 0.002, 4.0)),
}


def _k8_inputs(case):
    kw, (x, y, vx, vy, om, r) = K8_CASES[case]
    cfg = JCfg(**_ONE_DISK, **kw)
    eps, usx, usy = jimb.stamp_solid_fraction(
        jx([[x, y]], np.float32), jx([[vx, vy]], np.float32),
        jx([om], np.float32), jx([r], np.float32), jx([True]), cfg)
    f = perturbed_f((9, cfg.ny, cfg.nx), 5, np.float32)
    return cfg, f, eps, usx, usy


@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_plain_matches_pallas_interpret(case):
    """K8's plain version against the TPU kernel in interpret mode over
    its lattice options."""
    cfg, f, eps, usx, usy = _k8_inputs(case)
    jf, jphix, jphiy = pk.fused_step_imb(jx(f), eps, usx, usy, cfg)
    tcfg = to_torch_cfg(cfg)
    out = torch.empty((9, cfg.ny, cfg.nx), dtype=torch.float32)
    n0 = fused_lbm.fused_step_imb.launches
    res, phix, phiy = fused_lbm.fused_step_imb(tt(f), tt(eps), tt(usx),
                                               tt(usy), tcfg, out)
    assert res is out and fused_lbm.fused_step_imb.launches == n0
    np.testing.assert_allclose(npy(out), np.asarray(jf), rtol=1e-6, atol=1e-7)
    for a, b in ((phix, jphix), (phiy, jphiy)):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-5,
                                   atol=5e-8)
    assert float(np.abs(npy(phix)).max()) > 0


def test_k8_takes_float32_only():
    cfg, f, eps, usx, usy = _k8_inputs("bgk")
    tcfg = to_torch_cfg(cfg)
    fields = [tt(a) for a in (eps, usx, usy)]
    for dt in (torch.bfloat16, torch.float64):
        g = tt(f).to(dt)
        with pytest.raises(ValueError, match="float32"):
            fused_lbm.fused_step_imb(g, *fields, tcfg, torch.empty_like(g))
    g = tt(f)
    # the multi-chip argument is ported (tests/test_torch_mesh_window.py):
    # a pre-haloed K8 wants a frame, not the lattice
    with pytest.raises(ValueError, match="eps/usx/usy"):
        fused_lbm.fused_step_imb(g, *fields, tcfg, torch.empty_like(g),
                                 prehalo=True)
    with pytest.raises(ValueError, match="second"):
        fused_lbm.fused_step_imb(g, *fields, tcfg, g)


# --- K9, the stamp's coverage methods, K8 + K9 against K2 ---------------

def _reduce_setup(method="sample", seed=3, **kw):
    """256x64 (two 128-column stamp tiles), 16 disks of r 2-4 (two
    inactive), the JAX oracle's stamp and a collide's phi."""
    cfg = JCfg(nx=256, ny=64, tau=0.8, dtype="float32", max_disks=16,
               window=window_for_radius(4.0), tile_cap=24, eps_method=method,
               bc_west="wall", bc_east="wall", **kw)
    x, v, om, r, act = random_disks(16, 256, 64, seed, n_inactive=2)
    x[0] = (127.6, 32.2)  # straddles both tiles
    arrs = [a.astype(np.float32) for a in (x, v, om, r)] + [act]
    eps, usx, usy = jimb.stamp_solid_fraction(*[jx(a) for a in arrs], cfg)
    f = perturbed_f((9, 64, 256), 7, np.float32)
    _, phix, phiy = jimb.collide_imb(jx(f), eps, usx, usy, cfg)
    return cfg, arrs, f, eps, usx, usy, phix, phiy


K9_CASES = {"sample": ("sample", {}), "ramp": ("ramp", {}),
            "exact": ("exact", {}), "sample-r-shift": ("sample",
                                                       dict(eps_r_shift=-0.4))}


@pytest.mark.parametrize("case", list(K9_CASES))
def test_k9_plain_matches_pallas_interpret(case):
    method, kw = K9_CASES[case]
    cfg, arrs, _, eps, _, _, phix, phiy = _reduce_setup(method, **kw)
    x, v, om, r, act = arrs
    jb = ps.bin_disks_to_tiles(*[jx(a) for a in arrs], cfg)
    jF, jT = ps.reduce_hydro_forces(jx(x), jx(r), jx(act), eps, phix, phiy,
                                    cfg, jb[0], jb[1], jb[2])
    tcfg = to_torch_cfg(cfg)
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(*[tt(a) for a in arrs], tcfg)
    assert int(ovf) == 0
    n0 = stamp.reduce_hydro_forces.launches
    tF, tT = stamp.reduce_hydro_forces(tt(x), tt(r), tt(act), tt(eps),
                                       tt(phix), tt(phiy), tcfg, td, cnt, es)
    assert stamp.reduce_hydro_forces.launches == n0
    assert float(np.abs(npy(tF)).max()) > 0
    np.testing.assert_allclose(npy(tF), np.asarray(jF), rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(tT), np.asarray(jT), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["ramp", "exact"])
def test_stamp_ramp_exact_match_pallas_interpret(method):
    """K1's plain version under ramp and exact coverage against the TPU
    stamp kernel in interpret mode."""
    cfg, arrs, *_ = _reduce_setup(method, seed=4)
    je, jux, juy, jo = ps.stamp_solid_fraction(*[jx(a) for a in arrs], cfg)
    assert int(jo) == 0
    tcfg = to_torch_cfg(cfg)
    td, cnt, _, _ = stamp.bin_disks_to_tiles(*[tt(a) for a in arrs], tcfg)
    solid = stamp.stamp_fields(td, cnt, tcfg)
    for a, b in zip((je, jux, juy), solid):
        np.testing.assert_allclose(npy(b), np.asarray(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["sample", "ramp"])
def test_k8_k9_match_k2(method):
    """The split step (K8, then K9 on its phi) computes what K2 computes:
    the same f' and, through gather_partials, the same forces."""
    cfg, arrs, f, *_ = _reduce_setup(method, seed=8, gx=1e-5)
    tcfg = to_torch_cfg(cfg)
    x, v, om, r, act = (tt(a) for a in arrs)
    td, cnt, es, _ = stamp.bin_disks_to_tiles(x, v, om, r, act, tcfg)
    solid = stamp.stamp_fields(td, cnt, tcfg)
    fa, fb = torch.empty((9, 64, 256)), torch.empty((9, 64, 256))
    _, phix, phiy = fused_lbm.fused_step_imb(tt(f), solid[0], solid[1],
                                             solid[2], tcfg, fa)
    F8, T8 = stamp.reduce_hydro_forces(x, r, act, solid[0], phix, phiy, tcfg,
                                       td, cnt, es)
    _, parts = fused_lbm.fused_step_imb_reduce(tt(f), solid, td, cnt, tcfg,
                                               fb)
    F2, T2 = stamp.gather_partials(parts, es, torch.float32)
    assert torch.equal(fa, fb)
    assert float(F2.abs().max()) > 0
    np.testing.assert_allclose(npy(F8), npy(F2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(T8), npy(T2), rtol=0, atol=1e-6)


# --- ramp and exact coverage through Simulation -------------------------

def _contact_scene(method):
    """A 128^2 square pack on the floor, each disk 0.1 into its
    neighbours (contacts from the first step), float64."""
    rng = np.random.default_rng(9)
    disks = [JDisk(10.0 + 5.9 * i + rng.uniform(-0.05, 0.05),
                   2.6 + 5.9 * j + rng.uniform(-0.05, 0.05), 3.0,
                   rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02))
             for i in range(5) for j in range(4)]
    cfg = JCfg(nx=128, ny=128, tau=0.6, dtype="float64", max_disks=20,
               bc_west="wall", bc_east="wall", rho_s=2.5, kn=50.0,
               gamma_n=60.0, gamma_t=15.0, mu=0.5, n_sub=10, g_py=-1e-3,
               buoyancy=True, eps_method=method)
    return cfg, disks


def _assert_state_close(jst, tst, tol):
    np.testing.assert_allclose(np.asarray(jst.f), npy(tst.f), rtol=0,
                               atol=tol)
    for name in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jst.disks, name)),
                                   npy(getattr(tst.disks, name)), rtol=0,
                                   atol=tol, err_msg=name)
    assert int(jst.overflow) == int(tst.overflow) == 0
    assert int(jst.n_contacts) == int(tst.n_contacts) > 0
    assert int(jst.step) == int(tst.step)


@pytest.mark.parametrize("method", ["ramp", "exact"])
def test_simulation_ramp_exact_match_oracle(method):
    """Simulation on CPU tensors in float64 with ramp or exact coverage:
    two per-step steps (K1, K2, K3 plain versions) and then one
    coupling_k = 4 window (K1, K6, K3w) against the JAX oracle steps."""
    cfg, disks = _contact_scene(method)
    js = JSim(cfg, disks)
    wstep = jax.jit(jstep_fn(js.cfg, js.grid, False, dem_axis=js.dem_axis,
                             coupling_k=4))
    sim = Simulation(to_torch_cfg(cfg.replace(coupling_k=4)),
                     to_torch_disks(disks), device="cpu")
    for _ in range(2):
        js.step()
        sim.step()
    _assert_state_close(js.state, sim.state, 1e-9)
    tstep = simulation.make_step_fn(sim.cfg, sim.grid, None, sim.dem_axis,
                                    coupling_k=4)
    jst = wstep(js.state)
    tst = tstep(sim.state, torch.empty_like(sim.state.f))
    _assert_state_close(jst, tst, 1e-9)


# --- the cell-list DEM ---------------------------------------------------

def _dem_case(kt, bcs):
    """24 disks of r 3 packed 0.1 into each other on a 64^2 box, with
    random motion; on the periodic box a column sits across each seam."""
    periodic = bcs == "periodic"
    kw = (dict(bc_west="periodic", bc_east="periodic", bc_south="periodic",
               bc_north="periodic") if periodic
          else dict(bc_west="wall", bc_east="wall"))
    cfg = JCfg(nx=64, ny=64, tau=0.8, dtype="float64", max_disks=24, kn=5.0,
               gamma_n=1.0, gamma_t=0.3, mu=0.4, kt=kt, rho_s=2.0, n_sub=10,
               g_py=-1e-3, contact_cap=10, **kw)
    rng = np.random.default_rng(13)
    x0 = 61.3 if periodic else 3.2
    y0 = 60.8 if periodic else 3.1
    disks = [JDisk((x0 + 5.9 * i) % 64.0, (y0 + 5.9 * j) % 64.0, 3.0,
                   rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                   rng.uniform(-0.01, 0.01))
             for i in range(6) for j in range(4)]
    return cfg, disks


def _assert_history_equal(jd, td, tol):
    """ct_j as a set of partners per disk, each partner's ct_xi."""
    jj, tj = np.asarray(jd.ct_j), npy(td.ct_j)
    jxi, txi = np.asarray(jd.ct_xi), npy(td.ct_xi)
    for i in range(jj.shape[0]):
        a = {int(p): jxi[i, s] for s, p in enumerate(jj[i]) if p >= 0}
        b = {int(p): txi[i, s] for s, p in enumerate(tj[i]) if p >= 0}
        assert a.keys() == b.keys(), i
        for p in a:
            assert abs(a[p] - b[p]) <= tol, (i, p)
    np.testing.assert_allclose(np.asarray(jd.wall_xi), npy(td.wall_xi),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("bcs", ["walls", "periodic"])
@pytest.mark.parametrize("kt", [0.0, 0.8])
def test_cell_list_dem_matches_jax(kt, bcs):
    """Three chained dem_subcycle calls (the history springs re-match by
    partner id from the second on) against the JAX cell-list DEM in
    float64, with random hydro forces."""
    cfg, disks = _dem_case(kt, bcs)
    jd = jdem.make_disk_state(disks, cfg)
    tcfg = to_torch_cfg(cfg)
    td = dem.make_disk_state(to_torch_disks(disks), tcfg)
    jgrid = jdem.DemGrid.build(cfg, 3.0)
    tgrid = TGrid.build(tcfg, 3.0)
    jsub = jax.jit(lambda d, fh, th: jdem.dem_subcycle(d, fh, th, jgrid, cfg))
    jF, jT, jnc = jdem.contact_forces(
        jd, jdem.build_cell_table(jd.x, jd.active, jgrid)[0], jgrid, cfg)
    tF, tT, tnc = dem.contact_forces(
        td, dem.build_cell_table(td.x, td.active, tgrid)[0], tgrid, tcfg)
    assert int(jnc) == int(tnc) > 0
    np.testing.assert_allclose(npy(tF), np.asarray(jF), rtol=0, atol=1e-12)
    np.testing.assert_allclose(npy(tT), np.asarray(jT), rtol=0, atol=1e-12)
    rng = np.random.default_rng(17)
    touched = 0
    for _ in range(3):
        fh = rng.uniform(-1e-3, 1e-3, (24, 2))
        th = rng.uniform(-1e-4, 1e-4, 24)
        jd, jovf, jnc = jsub(jd, jx(fh), jx(th))
        td, tovf, tnc = dem.dem_subcycle(td, tt(fh), tt(th), tgrid, tcfg)
        assert int(jovf) == int(tovf) == 0
        assert int(jnc) == int(tnc)
        touched = max(touched, int(tnc))
        for name in ("x", "v", "omega", "theta"):
            np.testing.assert_allclose(npy(getattr(td, name)),
                                       np.asarray(getattr(jd, name)), rtol=0,
                                       atol=1e-12, err_msg=name)
        _assert_history_equal(jd, td, 1e-12)
    assert touched > 0
    if kt > 0:
        assert float(np.abs(npy(td.ct_xi)).max()) > 0


def test_cell_list_overflow_counted():
    """A cell over its capacity and a pruned list over contact_cap are
    counted, as in the JAX twin."""
    cfg, disks = _dem_case(0.0, "walls")
    cfg = cfg.replace(contact_cap=2)
    tcfg = to_torch_cfg(cfg)
    td = dem.make_disk_state(to_torch_disks(disks), tcfg)
    jd = jdem.make_disk_state(disks, cfg)
    for cap in (1, 8):
        jt, jo = jdem.build_cell_table(jd.x, jd.active,
                                       jdem.DemGrid.build(cfg, 3.0, cap))
        tt_, to = dem.build_cell_table(td.x, td.active,
                                       TGrid.build(tcfg, 3.0, cap))
        assert int(jo) == int(to)
        assert [set(r[r >= 0]) for r in np.asarray(jt)] == \
            [set(r[r >= 0]) for r in npy(tt_)]
    grid = TGrid.build(tcfg, 3.0)
    cand = dem.candidate_list(td, dem.build_cell_table(td.x, td.active,
                                                       grid)[0], grid)
    _, ovf = dem.prune_candidates(td, cand, 2, grid.skin)
    jgrid = jdem.DemGrid.build(cfg, 3.0)
    jc = jdem.candidate_list(jd, jdem.build_cell_table(jd.x, jd.active,
                                                       jgrid)[0], jgrid)
    _, jovf = jdem.prune_candidates(jd, jc, 2, jgrid.skin)
    assert int(ovf) == int(jovf) > 0


def test_simulation_takes_cell_list_past_slab_gate(monkeypatch):
    """Where the slab gate rejects the grid, the step runs the cell-list
    DEM: the packed scene's run(5) in float64 with the gate closed,
    against the JAX oracle (whose per-step path is the cell-list DEM);
    and a real scene past the gate (a long channel of small disks)
    constructs and steps."""
    cfg, disks = _contact_scene("sample")
    monkeypatch.setattr(slab_dem, "slab_supported", lambda *a, **k: False)
    calls = [0]
    sub = dem.dem_subcycle

    def counted(*a, **k):
        calls[0] += 1
        return sub(*a, **k)

    monkeypatch.setattr(dem, "dem_subcycle", counted)
    js = JSim(cfg, disks)
    js.run(5)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    sim.run(5)
    assert calls[0] == 5
    _assert_state_close(js.state, sim.state, 1e-9)
    monkeypatch.undo()
    chan = to_torch_cfg(JCfg(nx=4352, ny=16, tau=0.8, dtype="float32",
                             g_py=-1e-4, rho_s=2.0, n_sub=4, bc_west="wall",
                             bc_east="wall"))
    small = [to_torch_disks([JDisk(100.0 + 2.2 * i, 3.0 + 5.0 * j, 0.5)])[0]
             for i in range(4) for j in range(3)]
    sim = Simulation(chan, small, device="cpu")
    assert not slab_dem.slab_supported(sim.grid, sim.dem_axis)
    sim.run(2)
    assert int(sim.state.overflow) == 0
    assert bool(torch.isfinite(sim.state.disks.x).all())
    assert float(sim.state.disks.x[0, 1]) < 3.0  # it fell


# --- the stage-ablation tool --------------------------------------------

@pytest.mark.parametrize("ck", [1, 2])
def test_ablation_variants_run(ck):
    """Every f32 variant (coupling_k 1: the split step and the fused one;
    coupling_k 2: the window set) takes 2 calls on a 128^2 column
    collapse from one state; "full" (K8 + K9) and "fused" (K2) end in
    the same state."""
    sim = ablate.make_sim(128, 40, device="cpu",
                          env={"ABLATE_COUPLING_K": str(ck)})
    variants = ablate.build_variants(sim.cfg, sim.grid, sim.dem_axis)
    assert len(variants) == (11 if ck == 1 else 7)
    d0 = sim.state.disks
    tiles = stamp.build_tile_lists(d0.x, d0.active, sim.cfg,
                                   margin=simulation.BIN_MARGIN)[:3]
    ends = {}
    for name, step in variants.items():
        state = sim.state._replace(f=sim.state.f.clone())
        spare = torch.empty_like(state.f)
        for _ in range(2):
            new = step(state, *tiles, spare)
            spare, state = state.f, new
        steps = 2 if name == "floor" else 2 * ck
        assert int(state.step) == steps, name
        assert bool(torch.isfinite(state.f).all()), name
        assert int(state.overflow) == 0, name
        ends[name] = state
    if ck == 1:
        a, b = ends["full"], ends["fused"]
        assert torch.equal(a.f, b.f)
        for name in ("x", "v", "omega", "theta"):
            assert torch.equal(getattr(a.disks, name),
                               getattr(b.disks, name)), name
        assert not torch.equal(a.disks.x, d0.x)


def test_ablation_runner_and_bf16(capsys):
    """run_variants prints a row per variant and the marginals; on bf16
    storage every variant runs the K2 step ("full" is "fused"), the
    reduce ablated through zeroed counts, and "no-lbm" has no row."""
    sim = ablate.make_sim(128, 40, device="cpu")
    res = ablate.run_variants(sim, chunk=1, names=["full", "no-dem",
                                                   "fused"])
    assert list(res) == ["full", "no-dem", "fused"]
    assert all(len(r["chunks"]) == 3 and r["ms"] > 0 for r in res.values())
    out = capsys.readouterr().out
    assert "marginals vs full" in out and "  dem " in out
    sim = ablate.make_sim(128, 40, device="cpu",
                          env={"ABLATE_F_STORAGE": "bfloat16"})
    assert sim.state.f.dtype == torch.bfloat16
    variants = ablate.build_variants(sim.cfg, sim.grid, sim.dem_axis)
    assert "no-lbm" not in variants and "xla-dem" in variants
    assert variants["full"] is variants["fused"]
    res = ablate.run_variants(sim, chunk=1, names=["full", "no-reduce",
                                                   "fused"])
    assert all(r["ms"] > 0 for r in res.values())
    assert res["fused"] is res["full"]  # one variant, timed once
    assert "is full (timed once)" in capsys.readouterr().out
    d0 = sim.state.disks
    tiles = stamp.build_tile_lists(d0.x, d0.active, sim.cfg,
                                   margin=ablate.BIN_MARGIN)[:3]
    ends = [variants[name](sim.state, *tiles, torch.empty_like(sim.state.f))
            for name in ("full", "fused", "no-reduce")]
    assert torch.equal(ends[0].f, ends[1].f)
    assert torch.equal(ends[0].disks.v, ends[1].disks.v)
    assert bool(torch.isfinite(ends[2].f.float()).all())
