"""The port's main path as a whole: lbmdem_tpu_torch.Simulation on CPU
tensors (every kernel through its plain version) against the JAX
package's oracle step make_step_fn(use_pallas=False).

Bars: float64 1e-9 over 16 steps (two binning cadences) - the two
paths take the same arithmetic in other summation orders, ~1e-15 per
step; float32 1e-5 on f and disk state (a few ulp per step)."""

import os

import numpy as np
import pytest
import torch

import jax
from lbmdem_tpu.config import DiskSpec as JDisk
from lbmdem_tpu.models import column_collapse
from lbmdem_tpu.simulation import Simulation as JSim, make_step_fn
from lbmdem_tpu_torch import Simulation, interop
from lbmdem_tpu_torch.ops import fused_lbm, slab_dem, stamp

from torch_parity_util import (jax_state_to_numpy, npy, to_torch_cfg,
                               to_torch_disks)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _scene(dtype, **kw):
    cfg, disks = column_collapse(nx=128, ny=128, n_disks=40, r=4.0, **kw)
    return cfg.replace(dtype=dtype), disks


def _contact_scene(dtype):
    """A square pack on the floor, each disk 0.1 into its neighbours:
    contacts from the first step."""
    cfg, _ = column_collapse(nx=128, ny=128, n_disks=30, r=3.0)
    rng = np.random.default_rng(9)
    disks = [JDisk(10.0 + 5.9 * i + rng.uniform(-0.05, 0.05),
                   2.6 + 5.9 * j + rng.uniform(-0.05, 0.05), 3.0,
                   rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02))
             for i in range(6) for j in range(5)]
    return cfg.replace(dtype=dtype, g_py=-1e-3), disks


def _jax_run(cfg, disks, n):
    js = JSim(cfg, disks)
    step = jax.jit(make_step_fn(js.cfg, js.grid, False))
    st = js.state
    for _ in range(n):
        st = step(st)
    return js, st


def _assert_state_close(jst, tst, tol_f, tol_d):
    np.testing.assert_allclose(np.asarray(jst.f), npy(tst.f), rtol=0,
                               atol=tol_f)
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jst.disks, k)),
                                   npy(getattr(tst.disks, k)), rtol=0,
                                   atol=tol_d, err_msg=k)
    assert int(jst.overflow) == int(tst.overflow) == 0
    assert int(jst.n_contacts) == int(tst.n_contacts)
    assert int(jst.step) == int(tst.step)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9),
                                       ("float32", 1e-5)])
def test_slice_matches_jax_oracle(dtype, tol):
    """16 steps of a small column collapse: the port's Verlet-cadence run
    (K1/K2/K3 plain versions) against the JAX oracle step."""
    cfg, disks = _scene(dtype)
    _, jst = _jax_run(cfg, disks, 16)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    counts = (stamp.stamp_fields.launches,
              fused_lbm.fused_step_imb_reduce.launches,
              slab_dem.subcycle_slabs.launches)
    assert sim.run(16) > 0
    assert counts == (stamp.stamp_fields.launches,
                      fused_lbm.fused_step_imb_reduce.launches,
                      slab_dem.subcycle_slabs.launches)  # no kernel on CPU
    _assert_state_close(jst, sim.state, tol, tol)
    moved = np.abs(npy(sim.state.disks.x) - np.asarray(
        [[d.x, d.y] for d in disks] + [[-1e6, -1e6]] * (
            sim.state.disks.x.shape[0] - len(disks)))).max()
    assert moved > 0


def test_slice_with_contacts_matches_jax_oracle():
    cfg, disks = _contact_scene("float64")
    _, jst = _jax_run(cfg, disks, 12)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    sim.run(12)
    assert int(sim.state.n_contacts) > 0
    _assert_state_close(jst, sim.state, 1e-9, 1e-9)


def test_step_equals_cadence_run():
    """A per-step fresh binning (step) and the Verlet-cadence binning
    (run) take the same arithmetic: the wider lists only add zeros."""
    cfg, disks = _contact_scene("float64")
    a = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    b = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    for _ in range(5):
        a.step()
    b.run(5)
    np.testing.assert_allclose(npy(a.state.f), npy(b.state.f), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(npy(a.state.disks.x), npy(b.state.disks.x),
                               rtol=0, atol=1e-14)


def test_two_f_buffers_swap():
    """Each step writes into the spare buffer and the two trade places:
    no f-sized allocation per step."""
    cfg, disks = _scene("float32")
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    p0, p1 = sim.state.f.data_ptr(), sim._f_spare.data_ptr()
    assert p0 != p1
    sim.step()
    assert (sim.state.f.data_ptr(), sim._f_spare.data_ptr()) == (p1, p0)
    sim.run(3)
    assert {sim.state.f.data_ptr(), sim._f_spare.data_ptr()} == {p0, p1}


def test_interop_roundtrip_and_jax_state_loads():
    """A JAX state crosses over and both packages step on alike; the
    numpy form round-trips exactly."""
    cfg, disks = _contact_scene("float64")
    js, jst = _jax_run(cfg, disks, 3)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    d = jax_state_to_numpy(jst)
    sim.load_state(d)
    back = interop.state_to_numpy(sim.state)
    np.testing.assert_array_equal(back["f"], d["f"])
    for k, v in d["disks"].items():
        np.testing.assert_array_equal(back["disks"][k], v)
    assert back["step"] == 3 and back["fail_step"] == -1
    step = jax.jit(make_step_fn(js.cfg, js.grid, False))
    for _ in range(5):
        jst = step(jst)
    sim.run(5)
    _assert_state_close(jst, sim.state, 1e-9, 1e-9)
    again = interop.state_from_numpy(interop.state_to_numpy(sim.state),
                                     device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(again)),
                    jax.tree_util.tree_leaves(tuple(sim.state))):
        assert torch.equal(a, b)


def test_state_from_numpy_defaults_to_the_card():
    """interop.state_from_numpy puts the state on the card unless it is
    asked for the CPU; without a card the default raises RuntimeError
    naming device='cpu'."""
    cfg, disks = _scene("float32")
    d = interop.state_to_numpy(
        Simulation(to_torch_cfg(cfg), to_torch_disks(disks),
                   device="cpu").state)
    if torch.cuda.is_available():
        assert interop.state_from_numpy(d).f.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            interop.state_from_numpy(d)
    back = interop.state_from_numpy(d, device="cpu")
    assert back.f.device.type == "cpu"
    np.testing.assert_array_equal(npy(back.f), d["f"])


def test_observations_match_jax():
    """hydro_forces (plain IMB functions), macroscopic and disk_arrays
    against the JAX Simulation's on the same state."""
    cfg, disks = _contact_scene("float64")
    js, jst = _jax_run(cfg, disks, 4)
    js.state = jst
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    sim.load_state(jax_state_to_numpy(jst))
    jF, jT = js.hydro_forces()
    tF, tT = sim.hydro_forces()
    scale = np.abs(jF).max()
    assert scale > 0
    np.testing.assert_allclose(jF, tF, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(jT, tT, rtol=0, atol=1e-11 * scale)
    for a, b in zip(js.macroscopic(), sim.macroscopic()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
    ja, ta = js.disk_arrays(), sim.disk_arrays()
    assert ja.keys() == ta.keys()
    np.testing.assert_array_equal(ja["x"], ta["x"])


def _ported_options():
    """(what, cfg, disks) of the options the coupled kernels take: every
    lattice option, bf16 storage, history springs and periodic axes."""
    cfg, disks = _scene("float32")
    # prescribed motion: the drift steps, on K2
    fixed = [JDisk(d.x, d.y, d.r, vx=0.01, fixed=True) for d in disks]
    return [
        ("coupling_k", cfg.replace(coupling_k=4, f_storage="bfloat16"),
         disks),
        ("bfloat16", cfg.replace(f_storage="bfloat16"), disks),
        ("all-fixed", cfg.replace(f_storage="bfloat16"), fixed),
        ("periodic", cfg.replace(bc_west="periodic", bc_east="periodic"),
         disks),
        ("Zou/He", cfg.replace(bc_west="inlet", bc_east="outlet",
                               u_inlet=0.02), disks),
        ("kt > 0", cfg.replace(kt=0.5), disks),
        ("TRT", cfg.replace(collision="trt"), disks),
        # float64: the JAX oracle's LES scan does not trace in float32
        ("LES", cfg.replace(smagorinsky=0.1, dtype="float64"), disks),
        ("nt_mode", cfg.replace(nt_mode="lambda"), disks),
    ]


def _out_of_slice():
    """(what, cfg, disks, constructor keywords) of what raised naming its
    ROADMAP.md item before the plain path, paranoid mode and the mesh's
    windows were ported: all of it constructs on the CPU now (float64 and
    the coupled scene without disks on the plain path, coupling_k > 1 on
    a (2, 1) mesh of CPU shards)."""
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg, disks = _scene("float32")
    return [
        ("mesh", cfg.replace(coupling_k=2), disks,
         dict(mesh=make_mesh(["cpu"] * 2, (2, 1)))),
        ("coupled without disks", cfg.replace(max_disks=10), [],
         dict(use_kernels=False)),
        ("pure-fluid float64", cfg.replace(max_disks=0, dtype="float64"), [],
         dict(use_kernels=False)),
        ("paranoid", cfg.replace(paranoia="chunk"), disks, {}),
        ("float64", cfg.replace(dtype="float64"), disks,
         dict(use_kernels=False)),
    ]


def _runs_and_matches_oracle(cfg, disks):
    """4 steps through Simulation on CPU tensors land on the JAX oracle's
    state (f32: f 5e-6, or 3e-4 on bf16 storage, disk positions 1e-5;
    f64: 1e-9)."""
    from lbmdem_tpu_torch.ops import lbm as tlbm

    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    js = JSim(cfg.replace(coupling_k=1), disks)
    step = make_step_fn(js.cfg.replace(coupling_k=cfg.coupling_k), js.grid,
                        False, coupling_k=cfg.coupling_k,
                        dem_mode=js.dem_mode)
    jst = js.state
    for _ in range(4 // cfg.coupling_k):
        jst = step(jst)
    sim.run(4)
    assert int(sim.state.step) == int(jst.step) == 4
    assert int(sim.state.overflow) == 0
    f64 = cfg.dtype == "float64"
    tol = 3e-4 if cfg.f_storage == "bfloat16" else 1e-9 if f64 else 5e-6
    np.testing.assert_allclose(np.asarray(jst.f, np.float64),
                               npy(sim.state.f.to(torch.float64)), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(np.asarray(jst.disks.x), npy(sim.state.disks.x),
                               rtol=0, atol=1e-9 if f64 else 1e-5)
    f = tlbm.from_storage(sim.state.f, sim.cfg)
    assert bool(torch.isfinite(f).all())


@pytest.mark.parametrize("what,cfg,disks", _ported_options(),
                         ids=[c[0] for c in _ported_options()])
def test_ported_options_match_oracle(what, cfg, disks):
    """bf16 storage (per step, per window, with prescribed motion), TRT,
    LES, lambda, Zou/He, kt and periodic axes run through Simulation and
    match the JAX oracle."""
    _runs_and_matches_oracle(cfg, disks)


@pytest.mark.parametrize("what,cfg,disks,kw", _out_of_slice(),
                         ids=[c[0] for c in _out_of_slice()])
def test_out_of_slice_raises_naming_the_roadmap(what, cfg, disks, kw):
    """What raised naming its ROADMAP.md item before (coupling_k > 1 on a
    device mesh, coupled scenes without disks, float64, paranoid mode)
    now constructs and steps healthily."""
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu",
                     **kw)
    sim.run(2)
    assert int(sim.state.step) == 2 and int(sim.state.fail_step) == -1
    assert bool(torch.isfinite(sim.state.f).all())


def test_dkt_golden_steps():
    """The golden's rows are 250 steps apart."""
    gold = np.loadtxt(os.path.join(GOLDEN, "dkt_f64.csv"))
    assert gold.shape == (12, 5) and gold[0, 0] == 250 and gold[-1, 0] == 3000


@pytest.mark.parametrize(
    "steps", [1000, pytest.param(3000, marks=pytest.mark.slow)])
def test_dkt_golden(steps):
    """The JAX package's pinned f64 drafting-kissing-tumbling trajectory
    (64x256, two disks, mu = 0.1, rows every 250 steps: step, x0, y0, x1,
    y1), run through the port's main path on CPU tensors at the bars of
    test_sedimentation.py (rtol 1e-7, atol 1e-9). 1000 steps in the quick
    lane, the whole 3000 under -m slow."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig

    cfg = SimConfig(nx=64, ny=256, tau=0.56, dtype="float64", g_py=-1e-4,
                    rho_s=2.0, kn=1.0, gamma_n=1.0, mu=0.1, n_sub=10,
                    buoyancy=True, bc_west="wall", bc_east="wall",
                    out_interval=250)
    sim = Simulation(cfg, [DiskSpec(32.2, 220.0, 5.0),
                           DiskSpec(31.8, 204.0, 5.0)], device="cpu")
    rows = []
    sim.run(steps, callback=lambda s: rows.append(
        (int(s.state.step), *s.state.disks.x[0].tolist(),
         *s.state.disks.x[1].tolist())))
    rows = np.asarray(rows)
    gold = np.loadtxt(os.path.join(GOLDEN, "dkt_f64.csv"))[:len(rows)]
    assert len(rows) == steps // 250
    np.testing.assert_allclose(rows, gold, rtol=1e-7, atol=1e-9)
    assert int(sim.state.overflow) == 0
    # the trailing disk drafts: the gap closes
    assert rows[-1, 2] - rows[-1, 4] < 16.0


@pytest.mark.parametrize("steps", [1000, pytest.param(3000, marks=pytest.mark.slow)])
def test_settling_golden(steps):
    """The JAX package's pinned f64 settling trajectory (one disk in a
    closed channel, rows every 100 steps), run through the port's main
    path on CPU tensors: y at rtol 1e-8 and vy at rtol 1e-6, the bars
    of test_sedimentation.py. 1000 steps (~40 s) in the quick lane, the
    whole 3000 under -m slow."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig

    cfg = SimConfig(nx=64, ny=192, tau=0.65, dtype="float64", g_py=-2e-5,
                    rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                    bc_west="wall", bc_east="wall", out_interval=100)
    sim = Simulation(cfg, [DiskSpec(32.3, 150.0, 5.0)], device="cpu")
    rows = []
    sim.run(steps, callback=lambda s: rows.append(
        (float(s.state.disks.x[0, 1]), float(s.state.disks.v[0, 1]))))
    rows = np.asarray(rows)
    gold = np.loadtxt(os.path.join(GOLDEN, "settling_r5_f64.csv"))[:len(rows)]
    np.testing.assert_allclose(rows[:, 0], gold[:, 1], rtol=1e-8)
    np.testing.assert_allclose(rows[:, 1], gold[:, 2], rtol=1e-6, atol=1e-12)
    assert int(sim.state.overflow) == 0
    mass = float(sim.state.f.sum()) / (cfg.nx * cfg.ny)
    assert abs(mass - 1.0) < 1e-9
