"""The port's pure-fluid path (K4/K5 plain versions, the Simulation
branch, bf16 storage across interop) against the JAX package on CPU:
the Pallas fluid kernels in interpret mode and the plain-JAX oracle.

Bars are the JAX package's own (tests/test_pallas.py, test_lbm.py):
K4 rtol 1e-6 / atol 1e-7 over 2 steps; K5 (k = 8) rtol 1e-5 / atol
5e-7, atol 2e-6 with Zou/He (the TPU kernel evaluates the inlet profile
in f32, the port passes the f64-built array); bf16 storage atol 3e-4
(~1 bf16 ulp of |g| <~ 0.03); float64 against the oracle 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu import lattice as jlattice
from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import lbm as jlbm, pallas_lbm as pk
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu_torch import Simulation, interop, simulation
from lbmdem_tpu_torch.ops import fused_fluid, lbm

from torch_parity_util import jax_state_to_numpy, npy, to_torch_cfg, tt


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _rand_f(ny, nx, seed, dtype=np.float32):
    """test_pallas.py's input: w_i (1 + 0.05 N(0, 1)) in float32."""
    rng = np.random.default_rng(seed)
    base = jlattice.W[:, None, None].astype(np.float32)
    pert = 1.0 + 0.05 * rng.standard_normal((9, ny, nx)).astype(np.float32)
    return (base * pert).astype(dtype)


# the quick-lane feature matrix of tests/test_pallas.py
CFGS = {
    "periodic-x": dict(),
    "walls": dict(bc_west="wall", bc_east="wall"),
    "periodic": dict(bc_south="periodic", bc_north="periodic"),
    "forcing": dict(gx=1e-5, gy=-2e-5),
    "les": dict(smagorinsky=0.16, gx=2e-5),
    "lid": dict(bc_west="wall", bc_east="wall", uw_north=0.08),
    "trt": dict(collision="trt"),
    "trt-les": dict(collision="trt", smagorinsky=0.16, gx=1e-5),
}
ZOU_HE = dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
              inlet_profile="poiseuille")


def _k4(f, tcfg, n):
    g = tt(f)
    for _ in range(n):
        g = fused_fluid.fused_step_fluid(g, tcfg, torch.empty_like(g))
    return g


def _k5(f, tcfg, k):
    return fused_fluid.fused_step_fluid_multi(f, tcfg, k, torch.empty_like(f))


@pytest.mark.parametrize("kw", CFGS.values(), ids=CFGS.keys())
def test_k4_plain_matches_pallas(kw):
    cfg = JCfg(nx=128, ny=16, tau=0.8, dtype="float32", **kw)
    f = _rand_f(cfg.ny, cfg.nx, 0)
    ref = jnp.asarray(f)
    for _ in range(2):
        ref = pk.fused_step_fluid(ref, cfg)
    n0 = fused_fluid.fused_step_fluid.launches
    got = _k4(f, to_torch_cfg(cfg), 2)
    assert fused_fluid.fused_step_fluid.launches == n0  # no kernel on CPU
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kw", CFGS.values(), ids=CFGS.keys())
def test_k5_plain_matches_pallas(kw):
    cfg = JCfg(nx=128, ny=16, tau=0.8, dtype="float32", **kw)
    f = _rand_f(cfg.ny, cfg.nx, 7)
    ref = pk.fused_step_fluid_multi(jnp.asarray(f), cfg, 8)
    got = _k5(tt(f), to_torch_cfg(cfg), 8)
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-5,
                               atol=5e-7)


def test_k5_plain_matches_pallas_zou_he_periodic_y():
    cfg = JCfg(nx=256, ny=64, tau=0.7, dtype="float32", bc_south="periodic",
               bc_north="periodic", **ZOU_HE)
    f = _rand_f(cfg.ny, cfg.nx, 11)
    ref = pk.fused_step_fluid_multi(jnp.asarray(f), cfg, 8)
    got = _k5(tt(f), to_torch_cfg(cfg), 8)
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-5,
                               atol=2e-6)


def _bf16_pair(cfg, seed):
    """The same shifted-bf16 f for both packages (bits from JAX)."""
    fs = jlbm.to_storage(jnp.asarray(_rand_f(cfg.ny, cfg.nx, seed)), cfg)
    assert fs.dtype == jnp.bfloat16
    return fs, interop._f_from_numpy({"f": np.asarray(fs)}, "cpu")


def test_k4_bf16_plain_matches_pallas():
    cfg = JCfg(nx=128, ny=16, tau=0.8, dtype="float32", f_storage="bfloat16",
               gx=1e-5)
    fs, g = _bf16_pair(cfg, 2)
    assert g.dtype == torch.bfloat16
    tcfg = to_torch_cfg(cfg)
    for _ in range(2):
        fs = pk.fused_step_fluid(fs, cfg)
        g = fused_fluid.fused_step_fluid(g, tcfg, torch.empty_like(g))
    assert g.dtype == torch.bfloat16
    np.testing.assert_allclose(npy(g.float()), np.asarray(fs, np.float32),
                               atol=3e-4)


def test_k5_bf16_plain_matches_pallas():
    """k = 10 > 8: the bf16 range; one rounding per pass on both sides."""
    cfg = JCfg(nx=128, ny=32, tau=0.8, dtype="float32", f_storage="bfloat16",
               gy=-1e-5, uw_north=0.03)
    fs, g = _bf16_pair(cfg, 4)
    ref = pk.fused_step_fluid_multi(fs, cfg, 10)
    got = _k5(g, to_torch_cfg(cfg), 10)
    np.testing.assert_allclose(npy(got.float()), np.asarray(ref, np.float32),
                               atol=3e-4)


def test_bf16_rest_state_exact():
    """The shifted storage's invariant: the rest state is g = 0 exactly
    and stays 0 through a K4 step and a K5 pass."""
    tcfg = to_torch_cfg(JCfg(nx=128, ny=16, tau=0.8, dtype="float32",
                             f_storage="bfloat16"))
    g = lbm.to_storage(lbm.init_equilibrium(tcfg), tcfg)
    assert g.dtype == torch.bfloat16 and not g.float().any()
    out = torch.empty_like(g)
    assert not fused_fluid.fused_step_fluid(g, tcfg, out).float().any()
    assert not _k5(g, tcfg, 16).float().any()


@pytest.mark.parametrize("kw", [CFGS["lid"], CFGS["trt-les"], CFGS["forcing"],
                                dict(ZOU_HE, bc_south="wall")],
                         ids=["lid", "trt-les", "forcing", "zou-he"])
def test_f64_plain_matches_oracle(kw):
    cfg = JCfg(nx=64, ny=16, tau=0.7, dtype="float64", **kw)
    f = _rand_f(cfg.ny, cfg.nx, 5, np.float64)
    ref = jnp.asarray(f)
    for _ in range(3):
        ref = jlbm.step_pure_fluid(ref, cfg)
    got = _k5(tt(f), to_torch_cfg(cfg), 3)
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("steps,kw,atol", [
    (19, dict(nx=128, ny=16, tau=0.8, gx=1e-5, uw_north=0.03), 5e-7),
    (11, dict(nx=256, ny=64, tau=0.7, bc_west="inlet", bc_east="outlet",
              u_inlet=0.05), 2e-6)], ids=["lid-guo-19", "zou-he-11"])
def test_simulation_matches_jax_pallas(steps, kw, atol):
    """TEMPORAL_K macros plus singles (19 = 4 x 4 + 3; 11 = 2 x 4 + 3)
    against the JAX driver's Pallas chunk."""
    cfg = JCfg(dtype="float32", out_interval=steps, **kw)
    js = JSim(cfg, use_pallas=True)
    js.run(steps)
    sim = Simulation(to_torch_cfg(cfg), device="cpu")
    sim.run(steps)
    assert int(js.state.step) == int(sim.state.step) == steps
    np.testing.assert_allclose(npy(sim.state.f), np.asarray(js.state.f),
                               rtol=1e-5, atol=atol)


def test_chunk_is_k5_passes_then_k4_singles(monkeypatch):
    """run(n) issues n // TEMPORAL_K passes of TEMPORAL_K steps, then
    n % TEMPORAL_K single steps; step() is one single step."""
    calls = []
    multi = fused_fluid.fused_step_fluid_multi

    def spy(f, cfg, k, out, **kw):
        calls.append(k)
        return multi(f, cfg, k, out, **kw)

    monkeypatch.setattr(fused_fluid, "fused_step_fluid_multi", spy)
    sim = Simulation(to_torch_cfg(JCfg(nx=32, ny=8, tau=0.8, gx=1e-5)),
                     device="cpu")
    sim.run(19)
    assert calls == [4] * 4 + [1] * 3 and simulation.TEMPORAL_K == 4
    calls.clear()
    sim.run(3)
    sim.step()
    assert calls == [1] * 4 and int(sim.state.step) == 23


def test_pure_fluid_state_and_observations():
    """No disks: no DEM grid, one inactive disk slot (as the JAX
    constructor), zero hydro forces, two swapped f buffers."""
    cfg = JCfg(nx=32, ny=8, tau=0.8, gx=1e-5)
    js = JSim(cfg)
    sim = Simulation(to_torch_cfg(cfg), device="cpu")
    assert sim.grid is None and sim.cfg == to_torch_cfg(js.cfg)
    ja, ta = js.disk_arrays(), sim.disk_arrays()
    assert ja.keys() == ta.keys() and not ta["active"].any()
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    F, T = sim.hydro_forces()
    assert F.shape == (1, 2) and T.shape == (1,) and not F.any() and not T.any()
    p0, p1 = sim.state.f.data_ptr(), sim._f_spare.data_ptr()
    sim.step()
    assert (sim.state.f.data_ptr(), sim._f_spare.data_ptr()) == (p1, p0)
    sim.run(5)
    assert {sim.state.f.data_ptr(), sim._f_spare.data_ptr()} == {p0, p1}
    for a, b in zip(js.macroscopic(), Simulation(to_torch_cfg(cfg), device="cpu").macroscopic()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_interop_bf16_roundtrip_and_continue():
    """A JAX bf16 pure-fluid state crosses into the port and back bit for
    bit, and the port continues it to match the JAX run."""
    cfg = JCfg(nx=128, ny=16, tau=0.8, gx=1e-5, uw_north=0.03,
               dtype="float32", f_storage="bfloat16", out_interval=5)
    js = JSim(cfg, use_pallas=True)
    js.run(5)
    d = jax_state_to_numpy(js.state)
    assert d["f"].dtype.name == "bfloat16"
    sim = Simulation(to_torch_cfg(cfg), device="cpu")
    sim.load_state(d)
    assert sim.state.f.dtype == torch.bfloat16
    back = interop.state_to_numpy(sim.state)
    assert back["f_dtype"] == "bfloat16" and back["f"].dtype == np.uint16
    np.testing.assert_array_equal(back["f"], d["f"].view(np.uint16))
    again = interop.state_from_numpy(back, device="cpu")
    assert torch.equal(again.f.view(torch.int16), sim.state.f.view(torch.int16))
    js.run(7)
    sim.run(7)
    assert int(sim.state.step) == int(js.state.step) == 12
    np.testing.assert_allclose(npy(sim.state.f.float()),
                               np.asarray(js.state.f, np.float32), atol=3e-4)


def test_load_state_rejects_other_storage():
    cfg = JCfg(nx=32, ny=8, tau=0.8, dtype="float32")
    d = jax_state_to_numpy(JSim(cfg).state)
    sim = Simulation(to_torch_cfg(cfg.replace(f_storage="bfloat16")),
                     device="cpu")
    with pytest.raises(ValueError, match="f_storage"):
        sim.load_state(d)


@pytest.mark.parametrize("kw", [dict(prehalo=True), dict(edges=(1, 1, 1, 1))],
                         ids=["prehalo", "edges"])
def test_multichip_arguments_raise(kw):
    """The multi-chip arguments of K5 are ported (tests/test_torch_mesh.py)
    and checked: a pre-haloed K5 deeper than one sweep runs (k = 8 on a
    frame at rest keeps it at rest), edges without a pre-haloed frame
    and a frame of the wrong shape raise ValueError."""
    tcfg = to_torch_cfg(JCfg(nx=32, ny=8, tau=0.8))
    f = lbm.init_equilibrium(tcfg)
    out = torch.empty_like(f)
    if "edges" in kw:
        with pytest.raises(ValueError, match="pre-haloed"):
            fused_fluid.fused_step_fluid_multi(f, tcfg, 4, out, **kw)
        return
    fr = lbm.init_equilibrium(tcfg.replace(ny=8 + 2 * fused_fluid.HY))
    got = fused_fluid.fused_step_fluid_multi(fr, tcfg, 8, out, edges=(1,) * 4,
                                             **kw)
    np.testing.assert_allclose(got.numpy(), f.numpy(), rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="f must be"):
        fused_fluid.fused_step_fluid_multi(f, tcfg, 4, out, edges=(1,) * 4,
                                           **kw)


def test_poiseuille_profile_f64():
    """test_lbm.py's BASELINE config #1 through the port's Simulation:
    gravity-driven channel (32 x 4, tau 0.9, 16000 steps) against the
    analytic parabola at rtol 2e-3 / atol 3e-7."""
    from lbmdem_tpu_torch import SimConfig

    ny, nx, tau, g = 32, 4, 0.9, 1e-6
    cfg = SimConfig(nx=nx, ny=ny, tau=tau, gx=g, dtype="float64",
                    out_interval=16000)
    sim = Simulation(cfg, device="cpu")
    sim.run(16000)
    _, ux, _ = sim.macroscopic()
    y = np.arange(ny) + 0.5
    analytic = g / (2.0 * cfg.nu) * y * (ny - y)
    np.testing.assert_allclose(ux.mean(axis=1), analytic, rtol=2e-3,
                               atol=3e-7)
