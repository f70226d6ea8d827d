"""The port's all-fixed-obstacle path against the JAX package on CPU: the
periodic ghost glue against lbmdem_tpu.ops.imb, K7's plain version
against the Pallas fused_step_imb_static_multi in interpret mode, the
static hoist and the drift mode of Simulation against the JAX per-step
oracle (Simulation(use_pallas=False), the reference tests/test_fixed.py
holds the hoist to), and the errors that still name their ROADMAP item.

Bars: the ghost selection (parent, axes, overflow) exactly; wrapped and
augmented arrays and folded forces exactly in float64, 1e-6 in float32;
K7 rtol 1e-5 + atol 2e-6 (tests/test_pallas.py's static-kernel bar),
bf16 storage 3e-4; float64 runs 1e-9 (the same arithmetic in other
summation orders), float32 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu import lattice as jlattice
from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.ops import imb as jimb, lbm as jlbm, pallas_lbm as pk
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu_torch import Simulation, interop
from lbmdem_tpu_torch.ops import fused_static, imb, stamp

from torch_parity_util import TORCH_DT, jx, npy, to_torch_cfg, to_torch_disks, tt


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


# --- ghost glue ------------------------------------------------------

_AXES = {"x": dict(bc_west="periodic", bc_east="periodic"),
         "y": dict(bc_south="periodic", bc_north="periodic"),
         "xy": dict(bc_west="periodic", bc_east="periodic",
                    bc_south="periodic", bc_north="periodic")}


def _ghost_case(axes, dtype, margin, ghost_cap=0, n=40, seed=5):
    """A 128x96 config (window 9) and seeded disks: a third anywhere, a
    third within a few cells of (or just past) an x seam, a third of a y
    seam, the first sixth at corners; two inactive."""
    cfg = JCfg(nx=128, ny=96, tau=0.8, dtype=dtype, max_disks=n, window=9,
               **_AXES[axes])
    if ghost_cap <= 0:
        ghost_cap = jimb.default_ghost_cap(n, cfg, margin)
    cfg = cfg.replace(ghost_cap=ghost_cap)
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 128, n), rng.uniform(0, 96, n)], 1)
    edge = rng.uniform(-2.0, 9.0, (n, 2))
    far = np.asarray([128.0, 96.0]) - 1.0 - edge
    near = np.where(rng.random((n, 2)) < 0.5, far, edge)
    x[:n // 3, 0] = near[:n // 3, 0]
    x[n // 3:2 * n // 3, 1] = near[n // 3:2 * n // 3, 1]
    x[:n // 6, 1] = near[:n // 6, 1]
    v = rng.uniform(-0.05, 0.05, (n, 2))
    om = rng.uniform(-0.01, 0.01, n)
    r = rng.uniform(2.0, 4.0, n)
    act = np.ones(n, bool)
    act[[3, n - 1]] = False
    return cfg, [a.astype(dtype) if a.dtype != bool else a
                 for a in (x, v, om, r, act)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("margin", [0, 2])
@pytest.mark.parametrize("axes", ["x", "y", "xy"])
def test_ghost_glue_matches_jax(axes, margin, dtype):
    cfg, arrs = _ghost_case(axes, dtype, margin)
    tcfg = to_torch_cfg(cfg)
    assert imb.default_ghost_cap(cfg.max_disks, tcfg, margin) == cfg.ghost_cap
    jxw, jaug, jpar, jax_, jovf = jimb.periodic_ghosts(
        *(jx(a) for a in arrs), cfg, margin=margin)
    txw, taug, tpar, tax_, tovf = imb.periodic_ghosts(
        *(tt(a) for a in arrs), tcfg, margin=margin)
    np.testing.assert_array_equal(np.asarray(jpar), npy(tpar))
    np.testing.assert_array_equal(np.asarray(jax_), npy(tax_))
    assert int(jovf) == int(tovf) == 0
    assert int((tpar >= 0).sum()) > 0
    tol = 0.0 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(np.asarray(jxw), npy(txw), rtol=0, atol=tol)
    for a, b in zip(jaug, taug):
        np.testing.assert_allclose(np.asarray(a), npy(b), rtol=0, atol=tol)
    # the folded forces of random per-row forces (N + G rows)
    rng = np.random.default_rng(11)
    rows = taug[0].shape[0]
    F = rng.uniform(-1e-3, 1e-3, (rows, 2)).astype(dtype)
    T = rng.uniform(-1e-4, 1e-4, rows).astype(dtype)
    n = cfg.max_disks
    jF, jT = jimb.fold_ghost_forces(jx(F), jx(T), jpar, n)
    tF, tT = imb.fold_ghost_forces(tt(F), tt(T), tpar, n)
    np.testing.assert_allclose(np.asarray(jF), npy(tF), rtol=0, atol=tol)
    np.testing.assert_allclose(np.asarray(jT), npy(tT), rtol=0, atol=tol)
    assert not np.array_equal(npy(tF), F[:n])  # some ghost folded in


def test_ghost_selection_overflow_matches_jax():
    """A ghost_cap of 8 per block on a bed crowded at the seams."""
    cfg, arrs = _ghost_case("xy", "float32", 2, ghost_cap=8)
    x, act = arrs[0], arrs[4]
    jpar, jaxes, jovf = jimb.ghost_selection(jx(x), jx(act), cfg, 2)
    tpar, taxes, tovf = imb.ghost_selection(tt(x), tt(act), to_torch_cfg(cfg),
                                            2)
    assert tpar.shape == (24,)
    np.testing.assert_array_equal(np.asarray(jpar), npy(tpar))
    np.testing.assert_array_equal(np.asarray(jaxes), npy(taxes))
    assert int(jovf) == int(tovf) > 0


# --- K7 ----------------------------------------------------------------

K7_CASES = {
    "zou-he-k8": (8, dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05)),
    "walls-gx-lid-k4": (4, dict(bc_west="wall", bc_east="wall", gx=1e-5,
                                uw_north=0.05)),
    "trt-les-k2": (2, dict(collision="trt", smagorinsky=0.16, gx=1e-5)),
    "bf16-k4": (4, dict(f_storage="bfloat16", gx=1e-5, gy=-1e-5)),
}


@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_plain_matches_pallas_interpret(case):
    """K7's plain version against the TPU kernel in interpret mode, at
    256x64 with tests/test_pallas.py's two obstacles straddling tile
    boundaries (Zou/He: columns 0 and nx-1 masked, as the static hoist
    masks them)."""
    k, kw = K7_CASES[case]
    cfg = JCfg(nx=256, ny=64, tau=0.7, dtype="float32", max_disks=2,
               window=9, **kw)
    xs = jnp.asarray([[64.3, 32.1], [128.0, 40.0]], jnp.float32)
    z2 = jnp.zeros((2, 2), jnp.float32)
    eps, usx, usy = jimb.stamp_solid_fraction(
        xs, z2, jnp.zeros((2,), jnp.float32), jnp.asarray([4.0, 3.0]),
        jnp.ones((2,), bool), cfg)
    if cfg.bc_west == "inlet":
        eps, usx, usy = jimb.mask_open_columns(eps, usx, usy)
    solid = jnp.stack([eps, usx, usy])
    rng = np.random.default_rng(21)
    f = (jlattice.W[:, None, None].astype(np.float32) * (
        1.0 + 0.05 * rng.standard_normal((9, 64, 256)).astype(np.float32)))
    fs = jlbm.to_storage(jnp.asarray(f), cfg)
    got = pk.fused_step_imb_static_multi(fs, solid, cfg, k)
    tcfg = to_torch_cfg(cfg)
    g = interop._f_from_numpy({"f": np.asarray(fs)}, "cpu")
    out = torch.empty_like(g)
    n0 = fused_static.fused_step_imb_static_multi.launches
    res = fused_static.fused_step_imb_static_multi(g, tt(solid), tcfg, k, out)
    assert fused_static.fused_step_imb_static_multi.launches == n0
    assert res is out and out.dtype == g.dtype
    a, b = np.asarray(got, np.float32), npy(out.float())
    if cfg.f_storage == "bfloat16":
        np.testing.assert_allclose(b, a, rtol=0, atol=3e-4)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=2e-6)
    assert np.abs(b - np.asarray(fs, np.float32)).max() > 1e-4


# --- the static hoist and drift mode ------------------------------------


def _fixed_cfg(dtype, **kw):
    base = dict(nx=128, ny=128, tau=0.8, dtype=dtype, max_disks=2, kn=2.0,
                gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0, n_sub=10,
                bc_west="periodic", bc_east="periodic", g_py=0.0, gx=1e-5)
    base.update(kw)
    return JCfg(**base)


def _spy(monkeypatch, module, name):
    """Count the calls of module.name (the CPU path launches nothing)."""
    fn = getattr(module, name)
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _assert_run_close(jsim, sim, tol):
    np.testing.assert_allclose(np.asarray(jsim.state.f), npy(sim.state.f),
                               rtol=0, atol=tol)
    for name in ("x", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jsim.state.disks, name)),
                                   npy(getattr(sim.state.disks, name)),
                                   rtol=0, atol=tol, err_msg=name)
    assert int(sim.state.overflow) == 0
    assert int(jsim.state.step) == int(sim.state.step)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-6)])
def test_static_run_matches_per_step_oracle(monkeypatch, dtype, tol):
    """run(5) of two fixed disks at rest in a periodic-x channel: the
    hoist (K1 once, one K7 pass of 4 steps and one of 1) against the JAX
    per-step oracle."""
    cfg = _fixed_cfg(dtype, out_interval=5)
    specs = [JDisk(40.0, 64.0, 4.0, fixed=True),
             JDisk(80.0, 64.0, 4.0, fixed=True)]
    js = JSim(cfg, specs)
    js.run(5)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(specs), device="cpu")
    assert sim.dem_mode == "drift" and sim.static_solid
    k7 = _spy(monkeypatch, fused_static, "fused_step_imb_static_multi")
    k1 = _spy(monkeypatch, stamp, "stamp_fields")
    sim.run(5)
    assert (k7[0], k1[0]) == (2, 1)
    _assert_run_close(js, sim, tol)
    sim.run(3)  # the stack is cached: three one-step passes, no stamp
    assert (k7[0], k1[0]) == (5, 1)
    F, _ = sim.hydro_forces()
    assert F[0, 0] > 0.0  # the body force drags the obstacle downstream


def test_drift_run_and_forces_match_oracle():
    """tests/test_fixed.py's drift scene (a fixed disk at rest and one
    moving at vx = 0.01, periodic x) in float64: run(5) through the
    Verlet cadence with the drift against the JAX oracle, the moving
    disk at x0 + 5 vx, and hydro_forces against JAX's."""
    cfg = _fixed_cfg("float64", nx=64, ny=64, bc_west="periodic",
                     bc_east="periodic")
    specs = [JDisk(20.0, 32.0, 4.0, fixed=True),
             JDisk(44.0, 32.0, 4.0, vx=0.01, fixed=True)]
    js = JSim(cfg, specs)
    js.run(5)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(specs), device="cpu")
    assert sim.dem_mode == "drift" and not sim.static_solid
    sim.run(5)
    _assert_run_close(js, sim, 1e-9)
    x = sim.disk_arrays()["x"]
    np.testing.assert_allclose(x[0], [20.0, 32.0], atol=1e-12)
    np.testing.assert_allclose(x[1], [44.0 + 5 * 0.01, 32.0], atol=1e-12)
    jF, jT = js.hydro_forces()
    tF, tT = sim.hydro_forces()
    scale = np.abs(jF).max()
    assert scale > 0 and tF[0, 0] > 0.0
    np.testing.assert_allclose(tF, jF, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(tT, jT, rtol=0, atol=1e-11 * scale)


def test_drift_step_matches_oracle():
    """step() on a static scene is the per-step drift step (K1 + K2 with
    a fresh binning), as the JAX driver's step()."""
    cfg = _fixed_cfg("float64")
    specs = [JDisk(1.5, 64.0, 4.0, fixed=True),
             JDisk(80.0, 64.0, 4.0, fixed=True)]
    js = JSim(cfg, specs)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(specs), device="cpu")
    for _ in range(3):
        js.step()
        sim.step()
    _assert_run_close(js, sim, 1e-9)


def _offset_bed(nx=128, ny=128, pitch=32, r=6.0):
    """models.porous_bed shifted by half a pitch: every disk sits on a
    seam or a corner of the fully periodic box."""
    cfg = JCfg(nx=nx, ny=ny, tau=0.8, gx=1e-5, dtype="float64",
               bc_west="periodic", bc_east="periodic", bc_south="periodic",
               bc_north="periodic", max_disks=(nx // pitch) * (ny // pitch),
               n_sub=1, out_interval=8)
    disks = [JDisk(x=i * pitch, y=j * pitch, r=r, fixed=True)
             for i in range(nx // pitch) for j in range(ny // pitch)]
    return cfg, disks


def test_offset_porous_bed_matches_oracle():
    cfg, specs = _offset_bed()
    js = JSim(cfg, specs)
    js.run(8)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(specs), device="cpu")
    assert sim.static_solid
    d = sim.state.disks
    _, _, parent, axes, ovf = imb.periodic_ghosts(d.x, d.v, d.omega, d.r,
                                                  d.active, sim.cfg)
    n_ghosts = int((parent >= 0).sum())
    assert n_ghosts > 0 and int(ovf) == 0
    assert {tuple(a) for a in npy(axes[parent >= 0])} == {(1, 0), (0, 1),
                                                          (1, 1)}
    sim.run(8)
    _assert_run_close(js, sim, 1e-9)
    np.testing.assert_allclose(sim.solid_fraction(), js.solid_fraction(),
                               rtol=0, atol=1e-12)
    jF, _ = js.hydro_forces()
    tF, _ = sim.hydro_forces()
    # the two packages sum each disk's window in other orders
    np.testing.assert_allclose(tF, jF, rtol=0, atol=1e-11 * np.abs(jF).max())


# --- the seam bed set free or in motion, and what still raises -----------


def _bed_variants():
    """(what, cfg, specs): the seam bed with mobile disks, and in
    prescribed motion on bf16 storage."""
    cfg, specs = _offset_bed()
    return [
        ("mobile periodic", cfg,
         [dataclasses.replace(d, fixed=False) for d in specs]),
        ("prescribed motion on bf16",
         cfg.replace(dtype="float32", f_storage="bfloat16"),
         [dataclasses.replace(d, vx=0.01) for d in specs]),
    ]


def _runs_and_matches_oracle(cfg, specs):
    js = JSim(cfg, specs)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(specs), device="cpu")
    js.run(3)
    sim.run(3)
    f64 = cfg.dtype == "float64"
    np.testing.assert_allclose(
        np.asarray(js.state.f, np.float64),
        npy(sim.state.f.to(torch.float64)), rtol=0,
        atol=1e-9 if f64 else 3e-4)
    np.testing.assert_allclose(np.asarray(js.state.disks.x),
                               npy(sim.state.disks.x), rtol=0,
                               atol=1e-9 if f64 else 1e-5)
    assert int(sim.state.overflow) == 0


@pytest.mark.parametrize("what,cfg,specs", _bed_variants(),
                         ids=[c[0] for c in _bed_variants()])
def test_bed_variants_match_oracle(what, cfg, specs):
    """Mobile disks on periodic axes (the seam bed set free: ghosts, the
    periodic slab DEM) and prescribed motion on bf16 storage (the drift
    on K2's bf16 step): 3 steps against the JAX oracle (f64 1e-9; bf16 f
    3e-4, x 1e-5)."""
    _runs_and_matches_oracle(cfg, specs)


def test_out_of_slice_names_its_item():
    """The static hoist on a device mesh, which raised naming its item
    until the mesh took it, runs: the seam-straddling porous bed (float64)
    on a (2, 1) mesh of CPU shards, K7's pre-haloed plain version over
    solid windows stamped once, lands on the one-device hoist within
    1e-12 after 8 steps (the same arithmetic per cell)."""
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg, specs = _offset_bed()
    one = Simulation(to_torch_cfg(cfg), to_torch_disks(specs), device="cpu")
    sh = Simulation(to_torch_cfg(cfg), to_torch_disks(specs),
                    mesh=make_mesh(["cpu"] * 2, (2, 1)))
    assert sh.static_solid
    one.run(8)
    sh.run(8)
    np.testing.assert_allclose(npy(sh.state.f), npy(one.state.f), rtol=0,
                               atol=1e-12)
    assert int(sh.state.step) == 8 and int(sh.state.overflow) == 0


def test_default_device_is_the_card():
    """Simulation(cfg) asks for the card; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg, specs = _offset_bed()
    cfg = cfg.replace(dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(to_torch_cfg(cfg), to_torch_disks(specs))
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(to_torch_cfg(JCfg(nx=32, ny=8, tau=0.8)))
    assert Simulation(to_torch_cfg(cfg), to_torch_disks(specs),
                      device="cpu").state.f.dtype == TORCH_DT["float32"]
