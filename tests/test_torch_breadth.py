"""The lattice breadth of the port's coupled steps against the JAX package
on CPU: K2's and K6's plain versions with TRT, Smagorinsky LES,
nt_mode="lambda", Guo forcing, moving walls, the Zou/He inlet/outlet and
shifted-bf16 storage against the Pallas fused_step_imb_reduce and
fused_step_imb_reduce_multi in interpret mode; dem.cull_open_boundaries;
and Simulation(device="cpu") against the JAX Simulation oracle
(use_pallas=False) with those options on the step, the coupling_k window
and the drift path.

Bars: f32 f' 5e-6 against the Pallas kernels (__graft_entry__.py's
fused-vs-oracle bar; Zou/He cases 2e-6 + 1e-6 relative as
tests/test_openbc.py), bf16 3e-4 in f32 units (one bf16 rounding of the
shifted populations); per-disk forces 1e-6 relative to the largest |F|,
torques 2e-6 relative to the largest |T|; float64 Simulation runs 1e-9
(the same arithmetic in other summation orders); bf16 Simulation runs
against the oracle's storage round trip 3e-4 on f and 1e-5 on disk
positions (tests/test_openbc.py's coupled bf16 bar)."""

import jax
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.config import window_for_radius
from lbmdem_tpu.ops import dem as jdem
from lbmdem_tpu.ops import pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu.simulation import Simulation as JSim, make_step_fn as jstep_fn
from lbmdem_tpu_torch import Simulation, interop
from lbmdem_tpu_torch.ops import dem as tdem, fused_lbm, lbm as tlbm, stamp

from torch_parity_util import (jax_state_to_numpy, jx, npy, perturbed_f,
                               random_disks, to_torch_cfg, to_torch_disks, tt)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(ps, "_INTERPRET", True)
    monkeypatch.setattr(pk, "_INTERPRET", True)


ZOUHE = dict(bc_west="inlet", bc_east="outlet", u_inlet=0.04,
             inlet_profile="poiseuille")
ALL = dict(collision="trt", smagorinsky=0.12, nt_mode="lambda", gx=2e-5,
           gy=-1e-5, uw_north=0.03)
# (id, config options): one case per option, one with all of them
OPTIONS = [("trt", dict(collision="trt")),
           ("les", dict(smagorinsky=0.12)),
           ("lambda", dict(nt_mode="lambda")),
           ("zouhe", ZOUHE),
           ("bf16", dict(f_storage="bfloat16")),
           ("all", ALL),
           ("all-zouhe-bf16", dict(ALL, **ZOUHE, f_storage="bfloat16"))]


def _kernel_case(kw, seed=5, n=6):
    """A 128x32 scene (the JAX quick-lane size): derived config, seeded
    disks (one straddling two stamp tiles, one on a wall), f in storage
    form as float32 numpy (bf16: the rounded shifted populations)."""
    kw = {"bc_west": "wall", "bc_east": "wall", **kw}
    cfg = JCfg(nx=128, ny=32, tau=0.7, dtype="float32", max_disks=n,
               window=window_for_radius(3.0), tile_cap=16, **kw)
    x, v, om, r, act = random_disks(n, 128, 32, seed, r_lo=2.0, r_hi=3.0,
                                    margin=8.0, n_inactive=1)
    x[0] = (63.6, 15.8)
    x[1] = (30.0, 29.4)
    arrs = [a.astype(np.float32) for a in (x, v, om, r)] + [act]
    f = perturbed_f((9, 32, 128), seed + 10, np.float32)
    return cfg, arrs, f


def _storage(f, cfg):
    """(JAX f in storage form, the port's, both from the float32 f)."""
    from lbmdem_tpu.ops import lbm as jlbm

    jf = jlbm.to_storage(jx(f), cfg)
    tf = tlbm.to_storage(tt(f), to_torch_cfg(cfg))
    np.testing.assert_array_equal(np.asarray(jf, np.float32),
                                  npy(tf.to(torch.float32)))
    return jf, tf


def _solid(cfg, arrs):
    """JAX binning and solid stack, Zou/He columns zeroed as the steps
    zero them; the port bins for itself."""
    xs = [jx(a) for a in arrs]
    td, cnt, es, ovf = ps.bin_disks_to_tiles(*xs, cfg)
    assert int(ovf) == 0
    solid, _ = ps.stamp_solid_fraction(*xs, cfg,
                                       binned=(td, cnt, None, None),
                                       as_stack=True)
    if cfg.bc_west == "inlet":
        solid = solid.at[:, :, 0].set(0.0).at[:, :, -1].set(0.0)
    tcfg = to_torch_cfg(cfg)
    ttd, tcnt, tes, tovf = stamp.bin_disks_to_tiles(*[tt(a) for a in arrs],
                                                    tcfg)
    assert int(tovf) == 0
    return solid, (td, cnt, es), (ttd, tcnt, tes)


def _f_bar(cfg):
    if cfg.f_storage == "bfloat16":
        return dict(rtol=0, atol=3e-4)
    if cfg.bc_west == "inlet":
        return dict(rtol=1e-6, atol=2e-6)
    return dict(rtol=0, atol=5e-6)


def _assert_forces(jparts, es, tparts, tes, what=""):
    jF, jT = ps.gather_partials(jparts, es, np.float32)
    tF, tT = stamp.gather_partials(tparts, tes, torch.float32)
    fs, ts = float(np.abs(jF).max()), float(np.abs(jT).max())
    assert fs > 0 and ts > 0
    np.testing.assert_allclose(np.asarray(jF), npy(tF), rtol=0,
                               atol=1e-6 * fs, err_msg=what)
    np.testing.assert_allclose(np.asarray(jT), npy(tT), rtol=0,
                               atol=2e-6 * ts, err_msg=what)


@pytest.mark.parametrize("kw", [o[1] for o in OPTIONS],
                         ids=[o[0] for o in OPTIONS])
def test_k2_plain_matches_pallas_interpret(kw):
    """K2's plain version with each lattice option against the TPU kernel
    in interpret mode: f' in storage form and the per-disk forces."""
    cfg, arrs, f = _kernel_case(kw)
    jf, tf = _storage(f, cfg)
    solid, (td, cnt, es), (ttd, tcnt, tes) = _solid(cfg, arrs)
    jnew, jparts = pk.fused_step_imb_reduce(jf, solid, None, None, cfg, td,
                                            cnt)
    out = torch.empty_like(tf)
    n0 = fused_lbm.fused_step_imb_reduce.launches
    tnew, tparts = fused_lbm.fused_step_imb_reduce(
        tf, tt(np.asarray(solid)), ttd, tcnt, to_torch_cfg(cfg), out)
    assert fused_lbm.fused_step_imb_reduce.launches == n0  # the CPU path
    assert tnew is out and tnew.dtype == tf.dtype
    np.testing.assert_allclose(np.asarray(jnew, np.float32),
                               npy(tnew.to(torch.float32)), **_f_bar(cfg))
    _assert_forces(jparts, es, tparts, tes)


@pytest.mark.parametrize("kw", [OPTIONS[i][1] for i in (0, 3, 4, 6)],
                         ids=[OPTIONS[i][0] for i in (0, 3, 4, 6)])
def test_k6_plain_matches_pallas_interpret(kw):
    """K6's plain version (k = 2) against the TPU kernel in interpret
    mode: the inner steps stay in float32 and bf16 storage rounds once,
    at the end of the window; forces of every inner step."""
    k = 2
    cfg, arrs, f = _kernel_case(kw, seed=8)
    jf, tf = _storage(f, cfg)
    solid, (td, cnt, es), (ttd, tcnt, tes) = _solid(cfg, arrs)
    jnew, jparts = pk.fused_step_imb_reduce_multi(jf, solid, cfg, k, td, cnt)
    out = torch.empty_like(tf)
    tnew, tparts = fused_lbm.fused_step_imb_reduce_multi(
        tf, tt(np.asarray(solid)), ttd, tcnt, to_torch_cfg(cfg), k, out)
    assert tnew is out and tnew.dtype == tf.dtype
    np.testing.assert_allclose(np.asarray(jnew, np.float32),
                               npy(tnew.to(torch.float32)), **_f_bar(cfg))
    for t in range(k):
        _assert_forces(jparts[t], es, tparts[t], tes, f"inner step {t}")
    assert not np.array_equal(npy(tparts[0]), npy(tparts[1]))


def test_k6_bf16_rounds_once_per_window():
    """Two K2 steps round the shifted populations twice, one K6 window of
    k = 2 once: the port's two plain versions differ as the JAX kernels
    do (by at most two bf16 roundings), and K6 equals two float32 steps
    rounded at the end."""
    cfg, arrs, f = _kernel_case(dict(f_storage="bfloat16"), seed=8)
    tcfg = to_torch_cfg(cfg)
    _, tf = _storage(f, cfg)
    solid, _, (ttd, tcnt, _) = _solid(cfg, arrs)
    solid = tt(np.asarray(solid))
    a, b = torch.empty_like(tf), torch.empty_like(tf)
    fused_lbm.fused_step_imb_reduce(tf, solid, ttd, tcnt, tcfg, a)
    fused_lbm.fused_step_imb_reduce(a, solid, ttd, tcnt, tcfg, b)
    w = torch.empty_like(tf)
    fused_lbm.fused_step_imb_reduce_multi(tf, solid, ttd, tcnt, tcfg, 2, w)
    c32 = tcfg.replace(f_storage="float32")
    g = tlbm.from_storage(tf, tcfg)
    o1, o2 = torch.empty_like(g), torch.empty_like(g)
    fused_lbm.fused_step_imb_reduce(g, solid, ttd, tcnt, c32, o1)
    fused_lbm.fused_step_imb_reduce(o1, solid, ttd, tcnt, c32, o2)
    np.testing.assert_array_equal(
        npy(w.to(torch.float32)),
        npy(tlbm.to_storage(o2, tcfg).to(torch.float32)))
    d = np.abs(npy(w.to(torch.float32)) - npy(b.to(torch.float32)))
    assert 0 < d.max() < 3e-4


def test_cull_open_boundaries_matches_jax():
    """Straddling disks stay, fully-out mobile disks park at rest, fixed
    disks are exempt: every field equal to the JAX function's."""
    cfg = JCfg(nx=64, ny=32, bc_west="inlet", bc_east="outlet",
               u_inlet=0.05, max_disks=5, dtype="float64")
    specs = [JDisk(65.0, 16.0, 3.0), JDisk(67.0, 16.0, 3.0, vx=0.1, omega=0.2),
             JDisk(-4.0, 16.0, 3.0, vy=0.3), JDisk(68.0, 16.0, 3.0, fixed=True),
             JDisk(30.0, 10.0, 2.0, vx=0.1)]
    jd = jdem.cull_open_boundaries(jdem.make_disk_state(specs, cfg), cfg)
    tcfg = to_torch_cfg(cfg)
    td = tdem.cull_open_boundaries(
        tdem.make_disk_state(to_torch_disks(specs), tcfg), tcfg)
    assert npy(td.active).tolist() == [True, False, False, True, True]
    for name, a in jd._asdict().items():
        np.testing.assert_array_equal(np.asarray(a), npy(getattr(td, name)),
                                      err_msg=name)


# --- the slice as a whole: Simulation against the JAX oracle ---

def _pair(cfg, disks):
    # the JAX oracle's window step comes from make_step_fn alone
    js = JSim(cfg.replace(coupling_k=1), disks)
    js.cfg = js.cfg.replace(coupling_k=cfg.coupling_k)
    ts = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    assert to_torch_cfg(js.cfg) == ts.cfg.replace(tile_cap=js.cfg.tile_cap)
    return js, ts


def _assert_states(js, ts, tol, f_tol=None, what=""):
    """The port's state against a JAX SimState."""
    f_tol = tol if f_tol is None else f_tol
    np.testing.assert_allclose(np.asarray(js.f, np.float64),
                               npy(ts.f.to(torch.float64)), rtol=0,
                               atol=f_tol, err_msg=what + " f")
    for name in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(
            np.asarray(getattr(js.disks, name)), npy(getattr(ts.disks, name)),
            rtol=0, atol=tol, err_msg=what + " " + name)
    np.testing.assert_array_equal(np.asarray(js.disks.active),
                                  npy(ts.disks.active))
    assert int(js.overflow) == int(ts.overflow) == 0


def _settling(**kw):
    base = dict(nx=128, ny=64, tau=0.7, dtype="float64", g_py=-1e-4,
                buoyancy=True, rho_s=1.8, kn=0.5, gamma_n=0.5, mu=0.3,
                n_sub=4, bc_west="wall", bc_east="wall")
    base.update(kw)
    disks = [JDisk(40.3, 40.0, 4.0, vx=0.01), JDisk(49.0, 41.0, 4.0),
             JDisk(90.0, 20.2, 3.0, omega=0.01)]
    return JCfg(**base), disks


def test_simulation_trt_les_matches_oracle():
    """One coupled run with TRT + LES + lambda + Guo + a moving wall in
    float64: 12 steps of step() against the JAX oracle step."""
    cfg, disks = _settling(collision="trt", smagorinsky=0.12,
                           nt_mode="lambda", gx=1e-5, uw_north=0.02)
    js, ts = _pair(cfg, disks)
    step = jstep_fn(js.cfg, js.grid)
    s = js.state
    for _ in range(12):
        s = step(s)
        ts.step()
    _assert_states(s, ts.state, 1e-9)
    assert float(np.abs(np.asarray(s.disks.v)).max()) > 1e-3


def test_simulation_zouhe_disk_leaves_and_is_culled():
    """A Zou/He channel with a mobile disk next to the outlet (TRT): it
    leaves through the open end and is deactivated on the same step in
    both packages; a fixed obstacle stays. float64, 1e-9."""
    cfg = JCfg(nx=128, ny=32, tau=0.7, dtype="float64", max_disks=2,
               bc_west="inlet", bc_east="outlet", u_inlet=0.1,
               inlet_profile="uniform", rho_s=1.0, n_sub=2, u0x=0.1,
               collision="trt")
    disks = [JDisk(125.0, 16.0, 3.0, vx=0.2),
             JDisk(24.0, 10.0, 2.5, fixed=True)]
    js, ts = _pair(cfg, disks)
    step = jax.jit(jstep_fn(js.cfg, js.grid))
    s = js.state
    gone_at = None
    for i in range(60):
        s = step(s)
        ts.step()
        assert bool(s.disks.active[0]) == bool(ts.state.disks.active[0])
        if not bool(s.disks.active[0]):
            gone_at = i if gone_at is None else gone_at
            if i >= gone_at + 2:
                break
    assert gone_at is not None and gone_at > 10
    _assert_states(s, ts.state, 1e-9)
    assert npy(ts.state.disks.x)[0, 0] == -1.0e6
    assert bool(ts.state.disks.active[1])
    # the Zou/He columns stay pure fluid: the inlet keeps its profile
    _, ux, _ = ts.macroscopic()
    np.testing.assert_allclose(ux[:, 0], 0.1, rtol=0, atol=1e-12)


def test_simulation_window_lambda_matches_oracle():
    """A coupling_k = 4 window run with nt_mode="lambda" and LES in
    float64 against the JAX windowed oracle: run(8) is two windows."""
    cfg, disks = _settling(coupling_k=4, nt_mode="lambda", smagorinsky=0.1)
    js, ts = _pair(cfg, disks)
    # the JAX Simulation splits a cadence block as the port does; its oracle
    # window step is make_step_fn(use_pallas=False, coupling_k=k)
    wstep = jstep_fn(js.cfg, js.grid, coupling_k=4)
    s = js.state
    for _ in range(2):
        s = wstep(s)
    ts.run(8)
    assert int(ts.state.step) == int(s.step) == 8
    _assert_states(s, ts.state, 1e-9)


@pytest.mark.parametrize("ck", [1, 4], ids=["step", "window-k4"])
def test_simulation_bf16_matches_oracle_round_trip(ck):
    """bf16 storage in float32 against the JAX oracle's round-trip
    emulation (from_storage, float32 step(s), to_storage): per step, and
    per window of 4. f within 3e-4 (a flipped bf16 rounding), disks
    within 1e-5."""
    cfg, disks = _settling(dtype="float32", f_storage="bfloat16",
                           coupling_k=ck)
    js, ts = _pair(cfg, disks)
    assert ts.state.f.dtype == torch.bfloat16
    step = jstep_fn(js.cfg, js.grid, coupling_k=ck)
    s = js.state
    for _ in range(8 // ck):
        s = step(s)
    ts.run(8)
    assert int(ts.state.step) == int(s.step) == 8
    _assert_states(s, ts.state, 1e-5, f_tol=3e-4)


def test_drift_takes_every_option():
    """An all-fixed scene with prescribed motion (the drift on the K2
    step) under TRT + LES on bf16 storage runs, where it used to raise,
    and matches the JAX oracle."""
    cfg = JCfg(nx=128, ny=32, tau=0.7, dtype="float32", collision="trt",
               smagorinsky=0.1, f_storage="bfloat16", gx=1e-5,
               bc_west="periodic", bc_east="periodic")
    disks = [JDisk(30.0, 16.0, 4.0, vx=0.02, fixed=True),
             JDisk(90.0, 10.0, 3.0, omega=0.01, fixed=True)]
    js, ts = _pair(cfg, disks)
    assert ts.dem_mode == "drift" and not ts.static_solid
    step = jstep_fn(js.cfg, js.grid, dem_mode="drift")
    s = js.state
    for _ in range(4):
        s = step(s)
        ts.step()
    _assert_states(s, ts.state, 1e-5, f_tol=3e-4)


def test_bf16_coupled_state_continues_in_the_port():
    """A JAX bf16 coupled state (uint16 bits + "f_dtype" through
    interop) continues in the port: the next step equals the JAX oracle's
    next step."""
    cfg, disks = _settling(dtype="float32", f_storage="bfloat16")
    js, ts = _pair(cfg, disks)
    step = jstep_fn(js.cfg, js.grid)
    s = js.state
    for _ in range(3):
        s = step(s)
    d = interop.state_to_numpy(interop.state_from_numpy(
        jax_state_to_numpy(s), device="cpu"))
    assert d["f"].dtype == np.uint16 and d["f_dtype"] == "bfloat16"
    ts.load_state(d)
    np.testing.assert_array_equal(np.asarray(s.f, np.float32),
                                  npy(ts.state.f.to(torch.float32)))
    s = step(s)
    ts.step()
    _assert_states(s, ts.state, 1e-5, f_tol=3e-4)
