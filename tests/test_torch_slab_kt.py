"""The slab DEM's history springs (cfg.kt > 0) and periodic axes in the
port against the JAX package on CPU: the glue (`slab_supported`,
`_partner_ids`, `_rematch_xi`, `build_slabs(kt=True)`, `_unslab`'s spring
compaction) against `lbmdem_tpu/ops/pallas_dem.py`, K3's and K3w's plain
versions against the JAX cell-list oracle `dem.dem_subcycle` (the XLA
oracle the JAX slab tests compare with, not the interpret-mode kernel),
and Simulation(device="cpu") on a cut-down friction column, on the
periodic-channel deck and across a JAX state with live springs.

The JAX cell ranks come from an unstable sort, so slab contents compare
as sets per cell and springs as {(i, j): stretch} sets. Bars
(tests/test_pallas_dem.py): x/v/omega 2e-5 against the oracle, 3e-5 with
kt (springs and wall springs too), equal contact counts; float64
Simulation runs 1e-9."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.config import load_param_file, load_particle_file
from lbmdem_tpu.models import column_collapse
from lbmdem_tpu.ops import dem as jdem, pallas_dem
from lbmdem_tpu.ops.dem import DemGrid as JGrid
from lbmdem_tpu.simulation import Simulation as JSim, make_step_fn as jstep_fn
from lbmdem_tpu_torch import Simulation
from lbmdem_tpu_torch.ops import dem as tdem, slab_dem
from lbmdem_tpu_torch.ops.dem import DemGrid as TGrid

from torch_parity_util import (jax_state_to_numpy, jx, npy, to_torch_cfg,
                               to_torch_disks, tt)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _cfg(**kw):
    base = dict(nx=128, ny=128, tau=0.8, dtype="float32", max_disks=24,
                kn=2.0, gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0,
                n_sub=6, bc_west="wall", bc_east="wall", g_py=-1e-4,
                buoyancy=False)
    base.update(kw)
    return JCfg(**base)


# the contact scene of the JAX kt tests (the first disk lowered onto the
# south wall, sliding): a spinning neighbour, a head-on pair, a vertical
# pair, a free flier
KT_SPECS = [
    JDisk(30.0, 2.3, 3.0, vx=0.02), JDisk(35.5, 3.0, 3.0, omega=0.2),
    JDisk(60.0, 40.0, 3.0, vx=0.03), JDisk(65.5, 41.0, 3.0, vx=-0.03),
    JDisk(90.0, 90.0, 2.5, vy=-0.05), JDisk(90.0, 84.5, 2.5),
    JDisk(15.0, 100.0, 2.5), JDisk(100.3, 20.0, 3.0, omega=-0.1),
]


def _kt_cfg(**kw):
    return _cfg(**{**dict(max_disks=8, kt=0.5, gamma_t=0.2, mu=0.8, n_sub=4,
                          g_py=-2e-4), **kw})


def _states(cfg, specs, dtype="float32"):
    tcfg = to_torch_cfg(cfg)
    return (jdem.make_disk_state(specs, cfg, dtype),
            tdem.make_disk_state(to_torch_disks(specs), tcfg, dtype), tcfg)


def _grids(cfg, r):
    return JGrid.build(cfg, r), TGrid.build(to_torch_cfg(cfg), r)


def _spring_set(d):
    """{(i, j): xi} of the nonzero pair springs of a DiskState carry (the
    cell-list DEM stores its whole candidate list with zero stretches for
    pairs that do not touch, the slab only live springs)."""
    ct_j, ct_xi = npy(d.ct_j), npy(d.ct_xi)
    return {(i, int(ct_j[i, s])): float(ct_xi[i, s])
            for i in range(ct_j.shape[0]) for s in range(ct_j.shape[1])
            if ct_j[i, s] >= 0 and ct_xi[i, s] != 0.0}


def _assert_springs(a, b, tol, what=""):
    sa, sb = _spring_set(a), _spring_set(b)
    assert set(sa) == set(sb), f"{what}: spring pairs diverge"
    for k in sa:
        assert abs(sa[k] - sb[k]) < tol, (what, k, sa[k], sb[k])
    return sa


def _assert_disks(jd, td, tol, what="", fields=("x", "v", "omega", "theta")):
    for name in fields:
        np.testing.assert_allclose(npy(getattr(jd, name)),
                                   npy(getattr(td, name)), rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


def _zeros(n, dtype=np.float32):
    return np.zeros((n, 2), dtype), np.zeros((n,), dtype)


# --- the glue ---

@pytest.mark.parametrize("nx,ny,r,axis,periodic", [
    (128, 128, 3.0, "y", False), (2048, 2048, 8.0, "x", False),
    (4096, 4096, 8.0, "x", False), (4096, 4096, 4.0, "y", False),
    (128, 256, 6.0, "x", True), (128, 96, 3.5, "y", True),
    (64, 96, 3.5, "x", True)])
def test_slab_gate_matches_with_kt_and_wrap(nx, ny, r, axis, periodic):
    """slab_supported with and without the kt budget, and the wrapped
    row axis' 8-row rule, against the JAX gate (so both packages take
    the slab path on the same scenes)."""
    kw = dict(bc_west="periodic", bc_east="periodic") if periodic else {}
    cfg = _cfg(nx=nx, ny=ny, **kw)
    jg, tg = _grids(cfg, r)
    assert pallas_dem._wrap_sl(jg, axis) == slab_dem._wrap_sl(tg, axis)
    for kt in (False, True):
        assert pallas_dem.slab_supported(jg, axis, kt=kt) == \
            slab_dem.slab_supported(tg, axis, kt=kt), kt


def test_kt_gate_is_narrower():
    """The deck the friction example is sized for passes the kt gate; the
    4096^2 column passes only the kt = 0 gate."""
    cfg = _cfg(nx=2048, ny=2048)
    assert slab_dem.slab_supported(_grids(cfg, 8.0)[1], "x", kt=True)
    cfg = _cfg(nx=4096, ny=4096)
    g = _grids(cfg, 8.0)[1]
    assert slab_dem.slab_supported(g, "x") and \
        not slab_dem.slab_supported(g, "x", kt=True)


def test_card_gate_keeps_only_what_the_kernel_needs():
    """Asked for the card, the gate drops the plane budget (the 4096^2
    column with springs passes) and keeps the wrapped row axis' 8-row
    rule; asked for the CPU it is the default gate."""
    g = _grids(_cfg(nx=4096, ny=4096), 8.0)[1]
    assert slab_dem.slab_supported(g, "x", kt=True, device="cuda")
    assert slab_dem.slab_supported(g, "x", kt=True, device="cuda:0")
    assert not slab_dem.slab_supported(g, "x", kt=True, device="cpu")
    cfg = _cfg(nx=32, ny=96, bc_west="periodic", bc_east="periodic")
    g = _grids(cfg, 3.5)[1]
    assert slab_dem.slab_dims(g, "x")[0] < 8
    assert not slab_dem.slab_supported(g, "x", device="cuda")
    assert slab_dem.slab_supported(g, "y", device="cuda")


def _carry(jd, td, seed=9, cap=None):
    """Seeded springs in both states' carries: partner ids from the real
    neighbourhood, some stale."""
    rng = np.random.default_rng(seed)
    n, cap = jd.ct_j.shape
    ct_j = rng.integers(-1, n, (n, cap)).astype(np.int32)
    ct_xi = rng.uniform(-0.1, 0.1, (n, cap)).astype(np.float32)
    wall = rng.uniform(-0.05, 0.05, (n, 4)).astype(np.float32)
    jd = jd._replace(ct_j=jx(ct_j), ct_xi=jx(ct_xi), wall_xi=jx(wall))
    td = td._replace(ct_j=tt(ct_j), ct_xi=tt(ct_xi), wall_xi=tt(wall))
    return jd, td


@pytest.mark.parametrize("axis,kw", [
    ("y", {}), ("x", {}),
    ("y", dict(nx=128, ny=96, bc_west="periodic", bc_east="periodic")),
    ("x", dict(nx=128, ny=96, bc_west="periodic", bc_east="periodic",
               bc_south="periodic", bc_north="periodic"))],
    ids=["y-walls", "x-walls", "y-wrap-lanes", "x-wrap-both"])
def test_partner_ids_and_rematch_as_sets(axis, kw):
    """_partner_ids on wall and wrapped axes and _rematch_xi against JAX.
    The two packages may rank a cell's disks differently, so each disk's
    partners compare as the set of (direction, partner id) and the
    rematched stretches per (direction, partner)."""
    cfg = _cfg(max_disks=40, **kw)
    rng = np.random.default_rng(4)
    specs = [JDisk(rng.uniform(0.0, cfg.nx - 1.0),
                   rng.uniform(1.0, cfg.ny - 2.0), 2.0) for _ in range(40)]
    jd, td, tcfg = _states(cfg, specs)
    jd, td = _carry(jd, td)
    jg, tg = _grids(cfg, 2.0)
    z2, z1 = _zeros(40)
    jb = jdem.body_forces(jd, cfg)
    jout = pallas_dem.build_slabs(jd, jx(z2), jx(z1), jb, jg, axis, kt=True)
    tout = slab_dem.build_slabs(td, tt(z2), tt(z1),
                                tdem.body_forces(td, tcfg), tg, axis, kt=True)
    assert int(jout[2]) == int(tout[2]) == 0
    j36 = pallas_dem._partner_ids(jout[1], 40, jg, axis)
    t36 = slab_dem._partner_ids(tout[1], tg, axis)
    np.testing.assert_array_equal(npy(tout[6]), npy(t36))
    jxi = npy(pallas_dem._rematch_xi(j36, jd.ct_j, jd.ct_xi))
    txi = npy(slab_dem._rematch_xi(t36, td.ct_j, td.ct_xi))
    j36, t36 = npy(j36), npy(t36)
    assert (j36 >= 0).sum() > 20 and np.abs(jxi).max() > 0
    K = slab_dem.SLAB_K
    for i in range(40):
        assert i not in t36[i]  # never its own partner
        for d in range(9):
            js = {(int(p), float(x)) for p, x in
                  zip(j36[i, d * K:(d + 1) * K], jxi[i, d * K:(d + 1) * K])
                  if p >= 0}
            ts = {(int(p), float(x)) for p, x in
                  zip(t36[i, d * K:(d + 1) * K], txi[i, d * K:(d + 1) * K])
                  if p >= 0}
            assert js == ts, (i, d)


@pytest.mark.parametrize("slim", [False, True], ids=["step", "slim"])
def test_build_slabs_kt_as_sets(slim):
    """build_slabs(kt=True) in both layouts (51 channels, 48 slim): per
    cell, the set of records of the state channels plus each record's
    multiset of nonzero rematched springs, and the wall springs."""
    cfg = _kt_cfg()
    jd, td, tcfg = _states(cfg, KT_SPECS)
    jd, td = _carry(jd, td, seed=3)
    jg, tg = _grids(cfg, 3.0)
    z2, z1 = _zeros(8)
    js = pallas_dem.build_slabs(jd, jx(z2), jx(z1), jdem.body_forces(jd, cfg),
                                jg, "y", kt=True, bake_forces=not slim)[0]
    ts = slab_dem.build_slabs(td, tt(z2), tt(z1), tdem.body_forces(td, tcfg),
                              tg, "y", kt=True, bake_forces=not slim)[0]
    nch = 48 if slim else slab_dem._NCH_KT
    assert js.shape == tuple(ts.shape) and ts.shape[0] == nch
    base = 8 if slim else slab_dem._XI0

    def records(s):
        s = npy(s).reshape(nch, slab_dem.SLAB_K, -1)
        out = {}
        for k, c in zip(*np.nonzero(s[slab_dem._R] > 0)):
            rec = s[:, k, c]
            xi = tuple(sorted(float(v) for v in rec[base:base + 36] if v))
            out.setdefault(int(c), set()).add(
                (tuple(rec[:base]), xi, tuple(rec[base + 36:])))
        return out

    jr, tr = records(js), records(ts)
    assert jr == tr and sum(len(v) for v in jr.values()) == 8


def test_unslab_compaction_matches_jax():
    """_unslab's spring compaction to the (N, contact_cap) carry against
    JAX on the same slab tensor, slot map and partner map: ct_j, ct_xi and
    wall_xi entry by entry (a stable descending sort keeps top_k's order)
    and the ovf_ct overflow when contact_cap truncates."""
    rng = np.random.default_rng(3)
    specs = [JDisk(rng.uniform(20.0, 60.0), rng.uniform(20.0, 60.0), 3.0)
             for _ in range(24)]  # a dense cluster: several partners each
    for cap, want_ovf in ((10, 0), (2, None)):
        cfg = _kt_cfg(max_disks=24, contact_cap=cap)
        jd, td, tcfg = _states(cfg, specs)
        tg = _grids(cfg, 3.0)[1]
        z2, z1 = _zeros(24)
        slabs, slot, ovf, _, _, _, j36 = slab_dem.build_slabs(
            td, tt(z2), tt(z1), tdem.body_forces(td, tcfg), tg, "y", kt=True)
        rng = np.random.default_rng(6)
        xi = slabs[slab_dem._XI0:slab_dem._XIW]
        live = (slabs[slab_dem._R] > 0)[None].expand_as(xi)
        fill = tt(rng.uniform(-0.2, 0.2, tuple(xi.shape)).astype(np.float32))
        fill = torch.where(tt(rng.random(tuple(xi.shape)) < 0.5), fill,
                           torch.zeros(()))
        slabs[slab_dem._XI0:slab_dem._XIW] = torch.where(live, fill, xi)
        slabs[slab_dem._XIW:] = torch.where(
            live[:4], tt(rng.uniform(-0.1, 0.1, tuple(live[:4].shape))
                         .astype(np.float32)), slabs[slab_dem._XIW:])
        jn, jovf = pallas_dem._unslab(jx(slabs), jx(slot), jd, cfg, jx(j36),
                                      jnp.zeros((), jnp.int32))
        tn, tovf = slab_dem._unslab(slabs, slot, td, tcfg, j36, ovf)
        for name in ("ct_j", "ct_xi", "wall_xi", "x", "v"):
            np.testing.assert_array_equal(npy(getattr(jn, name)),
                                          npy(getattr(tn, name)), err_msg=name)
        assert int(jovf) == int(tovf)
        if want_ovf is None:
            assert int(tovf) > 0
        else:
            assert int(tovf) == want_ovf and (npy(tn.ct_j) >= 0).sum() > 0


# --- K3's plain version against the cell-list oracle ---

@pytest.mark.parametrize("mu", [0.8, 0.05])
def test_slab_kt_history_matches_oracle(mu):
    """In-slab Cundall-Strack springs against the JAX oracle over two LBM
    steps: the cross-step rematch through ct_j/ct_xi, the slip-consistent
    truncation (mu = 0.05 makes the Coulomb cap bind) and wall springs."""
    cfg = _kt_cfg(mu=mu)
    jd, td, tcfg = _states(cfg, KT_SPECS)
    jg, tg = _grids(cfg, 3.0)
    z2, z1 = _zeros(8)
    for step in range(2):
        jd, _, jnc = jdem.dem_subcycle(jd, jx(z2), jx(z1), jg, cfg)
        td, ovf, tnc = slab_dem.dem_subcycle(td, tt(z2), tt(z1), tg, tcfg,
                                             "y")
        assert int(ovf) == 0 and int(jnc) == int(tnc)
        _assert_disks(jd, td, 3e-5, f"step {step}",
                      ("x", "v", "omega", "wall_xi"))
        springs = _assert_springs(jd, td, 3e-5, f"step {step}")
    assert springs and np.abs(npy(td.wall_xi)).max() > 0


WRAP_X = dict(nx=128, ny=96, max_disks=6, bc_west="periodic",
              bc_east="periodic")
WRAP_X_SPECS = [
    JDisk(126.0, 40.0, 3.5, vx=0.05),
    JDisk(2.5, 41.0, 3.5, vx=-0.02),   # touches #0 through the seam
    JDisk(60.0, 40.0, 3.0), JDisk(63.5, 44.0, 3.0),  # bulk contact pair
    JDisk(127.2, 70.0, 2.5, vx=0.08),  # crosses the seam mid-subcycle
    JDisk(30.0, 20.0, 2.5, vy=0.03)]
WRAP_XY = dict(nx=128, ny=96, max_disks=4, n_sub=5, g_py=0.0,
               bc_west="periodic", bc_east="periodic", bc_south="periodic",
               bc_north="periodic")
WRAP_XY_SPECS = [
    JDisk(126.8, 94.5, 3.5, vx=0.03, vy=0.02),  # the domain corner
    JDisk(2.0, 1.5, 3.5, vx=-0.01),   # touches #0 through BOTH seams
    JDisk(50.0, 50.0, 3.0), JDisk(55.5, 52.0, 3.0)]


@pytest.mark.parametrize("axis", ["y", "x"])
@pytest.mark.parametrize("kw,specs", [(WRAP_X, WRAP_X_SPECS),
                                      (WRAP_XY, WRAP_XY_SPECS)],
                         ids=["periodic-x", "periodic-xy"])
def test_slab_periodic_matches_oracle(axis, kw, specs):
    """One and two periodic axes under both slab orientations (a wrapped
    lane axis and a wrapped row axis): a pair touching through the seam
    (the corner, with both axes wrapped) and a disk that crosses it."""
    cfg = _cfg(**kw)
    n = len(specs)
    jd, td, tcfg = _states(cfg, specs)
    jg, tg = _grids(cfg, 3.5)
    assert slab_dem.slab_supported(tg, axis)
    rng = np.random.default_rng(2)
    fh = rng.uniform(-1e-3, 1e-3, (n, 2)).astype(np.float32)
    th = rng.uniform(-1e-4, 1e-4, (n,)).astype(np.float32)
    jn, _, jnc = jdem.dem_subcycle(jd, jx(fh), jx(th), jg, cfg)
    tn, ovf, tnc = slab_dem.dem_subcycle(td, tt(fh), tt(th), tg, tcfg, axis)
    assert int(ovf) == 0 and int(jnc) == int(tnc) >= 2
    _assert_disks(jn, tn, 2e-5)


def test_slab_kt_periodic_wrap():
    """Springs persist across the periodic seam: a pair touching through
    the x wrap keeps its stretch through the slab rematch."""
    cfg = _cfg(nx=128, ny=96, max_disks=3, kt=0.4, gamma_t=0.2, mu=0.9,
               g_py=0.0, bc_west="periodic", bc_east="periodic")
    specs = [JDisk(126.5, 40.0, 3.0, omega=0.15), JDisk(2.0, 41.0, 3.0),
             JDisk(60.0, 60.0, 2.5)]
    jd, td, tcfg = _states(cfg, specs)
    jg, tg = _grids(cfg, 3.0)
    z2, z1 = _zeros(3)
    for axis in ("y", "x"):
        jn, tn = jd, td
        for _ in range(2):
            jn, _, _ = jdem.dem_subcycle(jn, jx(z2), jx(z1), jg, cfg)
            tn, ovf, _ = slab_dem.dem_subcycle(tn, tt(z2), tt(z1), tg, tcfg,
                                               axis)
            assert int(ovf) == 0
        _assert_disks(jn, tn, 3e-5, axis, ("x", "omega"))
        assert (0, 1) in _assert_springs(jn, tn, 3e-5, axis)


def test_slab_kt_window_matches_per_step():
    """dem_subcycle_window with kt (the slim layout, springs from channel
    8, the partner map frozen for the window) against two per-step slab
    subcycles: with travel below a cell width the frozen slots equal the
    per-step rebuild's."""
    cfg = _kt_cfg(mu=0.4, n_sub=6)
    _, td, tcfg = _states(cfg, KT_SPECS)
    tg = _grids(cfg, 3.0)[1]
    rng = np.random.default_rng(5)
    forces = [(tt(rng.uniform(-1e-3, 1e-3, (8, 2)).astype(np.float32)),
               tt(rng.uniform(-1e-4, 1e-4, (8,)).astype(np.float32)))
              for _ in range(2)]
    dp = td
    for fh, th in forces:
        dp, ovf, _ = slab_dem.dem_subcycle(dp, fh, th, tg, tcfg, "y")
        assert int(ovf) == 0
    dw, ovf_w, nc_w = slab_dem.dem_subcycle_window(td, forces, tg, tcfg, "y")
    assert int(ovf_w) == 0 and int(nc_w) > 0
    _assert_disks(dp, dw, 3e-5, "", ("x", "v", "omega", "wall_xi"))
    assert _assert_springs(dp, dw, 3e-5)


def test_slab_kt_window_matches_jax_oracle_chain():
    """The kt window against the JAX cell-list oracle applied per inner
    step (what the JAX windowed oracle step does)."""
    cfg = _kt_cfg(n_sub=6)
    jd, td, tcfg = _states(cfg, KT_SPECS)
    jg, tg = _grids(cfg, 3.0)
    rng = np.random.default_rng(8)
    forces = [(rng.uniform(-1e-3, 1e-3, (8, 2)).astype(np.float32),
               rng.uniform(-1e-4, 1e-4, (8,)).astype(np.float32))
              for _ in range(3)]
    for fh, th in forces:
        jd, _, jnc = jdem.dem_subcycle(jd, jx(fh), jx(th), jg, cfg)
    dw, ovf, nc = slab_dem.dem_subcycle_window(
        td, [(tt(a), tt(b)) for a, b in forces], tg, tcfg, "y")
    assert int(ovf) == 0 and int(nc) == int(jnc)
    _assert_disks(jd, dw, 3e-5, "", ("x", "v", "omega", "wall_xi"))
    assert _assert_springs(jd, dw, 3e-5)


@pytest.mark.parametrize("first", ["cell-list", "slab"])
def test_slab_kt_interop_with_cell_list(first):
    """Mid-run handoff in both directions (the spring carries
    interoperate): cell-list step then slab step, or slab step then
    cell-list step, equals two JAX oracle steps."""
    cfg = _kt_cfg(max_disks=4, n_sub=6)
    specs = KT_SPECS[:4]
    jd, td, tcfg = _states(cfg, specs)
    jg, tg = _grids(cfg, 3.0)
    z2, z1 = _zeros(4)
    for _ in range(2):
        jd, _, _ = jdem.dem_subcycle(jd, jx(z2), jx(z1), jg, cfg)
    order = ["cell-list", "slab"] if first == "cell-list" else \
        ["slab", "cell-list"]
    for which in order:
        if which == "slab":
            td, _, _ = slab_dem.dem_subcycle(td, tt(z2), tt(z1), tg, tcfg, "y")
        else:
            td, _, _ = tdem.dem_subcycle(td, tt(z2), tt(z1), tg, tcfg)
    _assert_disks(jd, td, 3e-5, first, ("x", "v"))
    assert _assert_springs(jd, td, 3e-5, first)


def test_empty_bands_carry_every_channel_through():
    """Partial writes: rows of bands that hold no disk come out of the
    subcycle as they went in, all 51 channels (a marker in an empty
    band's spring channels survives)."""
    cfg = _kt_cfg()
    _, td, tcfg = _states(cfg, KT_SPECS)
    tg = _grids(cfg, 3.0)[1]
    z2, z1 = _zeros(8)
    slabs, _, _, kmax, n_occ, bands, _ = slab_dem.build_slabs(
        td, tt(z2), tt(z1), tdem.body_forces(td, tcfg), tg, "y", kt=True)
    occupied = set(npy(bands)[:int(n_occ)].tolist())
    R = slabs.shape[2]
    empty = next(o for o in range(8, R - 8, 8) if o not in occupied)
    slabs[:, :, empty:empty + 8] = 0.0
    slabs[slab_dem._XI0:, :, empty:empty + 8] = 7.0
    out, _ = slab_dem.subcycle_slabs(slabs, kmax, n_occ, bands, tg, tcfg, "y")
    np.testing.assert_array_equal(npy(out[:, :, empty:empty + 8]),
                                  npy(slabs[:, :, empty:empty + 8]))
    assert not np.array_equal(npy(out), npy(slabs))


# --- the slice as a whole ---

def _pair(cfg, disks):
    # the JAX oracle's window step comes from make_step_fn alone
    js = JSim(cfg.replace(coupling_k=1), disks)
    js.cfg = js.cfg.replace(coupling_k=cfg.coupling_k)
    ts = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    assert to_torch_cfg(js.cfg) == ts.cfg.replace(tile_cap=js.cfg.tile_cap)
    return js, ts


def _assert_states(js, ts, tol, what=""):
    np.testing.assert_allclose(np.asarray(js.f), npy(ts.f), rtol=0, atol=tol,
                               err_msg=what + " f")
    _assert_disks(js.disks, ts.disks, tol, what,
                  ("x", "v", "omega", "theta", "wall_xi"))
    assert int(js.overflow) == int(ts.overflow) == 0
    assert int(js.n_contacts) == int(ts.n_contacts)


def _friction_column(dtype="float64", **kw):
    """The friction deck's scene (column_collapse with kt = 25) cut to
    96 x 96 and 12 disks of r = 4, with seeded velocities so contacts and
    springs form within a few steps."""
    cfg, disks = column_collapse(nx=96, ny=96, n_disks=12, r=4.0, g=1e-4,
                                 kt=25.0)
    rng = np.random.default_rng(1)
    disks = [dataclasses.replace(d, vx=rng.uniform(-0.04, 0.04),
                                 vy=rng.uniform(-0.06, 0.0),
                                 omega=rng.uniform(-0.02, 0.02))
             for d in disks]
    return cfg.replace(dtype=dtype, n_sub=4, **kw), disks


def test_simulation_friction_column_matches_oracle():
    """Simulation on the cut-down friction column (kt = 25) in float64
    against the JAX oracle: the slab gate with kt, hydro forces feeding
    the spring subcycle, the cross-step rematch."""
    cfg, disks = _friction_column()
    js, ts = _pair(cfg, disks)
    assert slab_dem.slab_supported(ts.grid, ts.dem_axis, kt=True)
    step = jstep_fn(js.cfg, js.grid)
    s = js.state
    for _ in range(12):
        s = step(s)
        ts.step()
    _assert_states(s, ts.state, 1e-9)
    assert _assert_springs(s.disks, ts.state.disks, 1e-9)
    assert int(ts.state.n_contacts) > 0


def test_simulation_friction_window_matches_oracle():
    """The same column through coupling_k = 4 windows (K6's plain version
    and the kt window slab) against the JAX windowed oracle."""
    cfg, disks = _friction_column(coupling_k=4)
    js, ts = _pair(cfg, disks)
    wstep = jstep_fn(js.cfg, js.grid, coupling_k=4)
    s = js.state
    for _ in range(3):
        s = wstep(s)
    ts.run(12)
    assert int(ts.state.step) == 12
    _assert_states(s, ts.state, 1e-9)
    assert _assert_springs(s.disks, ts.state.disks, 1e-9)


def test_simulation_periodic_channel_deck_matches_oracle():
    """examples/periodic_channel.par (mobile disks on a periodic x axis,
    one straddling the seam) in float64 against the JAX oracle: ghosts
    for the stamp and the reduce, the periodic slab DEM, run(10) through
    the Verlet cadence and the per-step step."""
    cfg, pf = load_param_file(os.path.join(EXAMPLES, "periodic_channel.par"))
    disks = load_particle_file(pf)
    cfg = cfg.replace(dtype="float64", ny=128, n_sub=4)
    disks = [dataclasses.replace(d, y=d.y - 110.0) for d in disks]
    js, ts = _pair(cfg, disks)
    assert slab_dem.slab_supported(ts.grid, ts.dem_axis)
    step = jstep_fn(js.cfg, js.grid)
    s = js.state
    for _ in range(10):
        s = step(s)
    ts.run(10)
    np.testing.assert_allclose(np.asarray(s.f), npy(ts.state.f), rtol=0,
                               atol=1e-9)
    _assert_disks(s.disks, ts.state.disks, 1e-9)
    assert int(ts.state.overflow) == 0
    # the seam disk wrapped into the domain
    assert 0.0 <= npy(ts.state.disks.x)[0, 0] + 0.5 < 128.0


def test_jax_kt_state_continues_in_the_port():
    """A JAX kt state with live springs (the friction column after 12
    oracle steps) loads into the port through interop by field name and
    gives the same next step."""
    cfg, disks = _friction_column()
    js, ts = _pair(cfg, disks)
    step = jstep_fn(js.cfg, js.grid)
    s = js.state
    for _ in range(12):
        s = step(s)
    assert _spring_set(s.disks)
    ts.load_state(jax_state_to_numpy(s))
    np.testing.assert_array_equal(np.asarray(s.disks.ct_j),
                                  npy(ts.state.disks.ct_j))
    s = step(s)
    ts.step()
    _assert_states(s, ts.state, 1e-9)
    assert _assert_springs(s.disks, ts.state.disks, 1e-9)
