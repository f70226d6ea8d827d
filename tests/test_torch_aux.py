"""The port's aux subsystems against the JAX package's: paranoid mode
(fail_step and the frozen state), checkpoints in both directions,
metrics, the VTK and CSV writers (byte for byte, native and Python),
the asynchronous writer and the profiling helpers."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lbmdem_tpu.utils.io_vtk as jvtk
import lbmdem_tpu.utils.native as jnative
from lbmdem_tpu.config import DiskSpec as JDisk
from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu.simulation import SimulationDiverged as JDiverged
from lbmdem_tpu.simulation import make_step_fn as jmake_step_fn
from lbmdem_tpu.utils import checkpoint as jckpt
from lbmdem_tpu.utils import metrics as jmetrics
from lbmdem_tpu_torch import SimConfig, Simulation, SimulationDiverged
from lbmdem_tpu_torch.utils import checkpoint as ckpt
from lbmdem_tpu_torch.utils import io_vtk, metrics, native, profiling
from lbmdem_tpu_torch.utils.async_io import AsyncWriter

from torch_parity_util import (jax_state_to_numpy, npy, to_torch_cfg,
                               to_torch_disks)


def _cfg(**kw):
    """The scene of the JAX package's tests/test_aux.py."""
    base = dict(nx=32, ny=48, tau=0.8, dtype="float64", g_py=-1e-4,
                rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=5,
                bc_west="wall", bc_east="wall")
    base.update(kw)
    return JCfg(**base)


DISKS = [JDisk(16.2, 40.0, 3.0)]


def _plain(cfg, disks=(), **kw):
    return Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu",
                      use_kernels=False, **kw)


def _assert_state(jst, tst, tol):
    np.testing.assert_allclose(np.asarray(jst.f, np.float64),
                               npy(tst.f.double()), rtol=0, atol=tol)
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jst.disks, k)),
                                   npy(getattr(tst.disks, k)), rtol=0,
                                   atol=tol, err_msg=k)
    assert int(jst.step) == int(tst.step)


# --- paranoid mode -------------------------------------------------------

def test_paranoid_pure_fluid_nan_matches_jax():
    """JAX tests/test_aux.py's NaN injected into pure fluid: both plain
    paths stop at step 4 with the state frozen there (NaN where JAX has
    it); the port's kernel path validates once per K5 pass (as the JAX
    kernel path does), so it reports the end of that pass, step 7."""
    cfg = JCfg(nx=32, ny=16, tau=0.8, gx=1e-5, paranoia=True,
               out_interval=100)
    js = JSim(cfg)
    js.run(3)
    js.state = js.state._replace(f=js.state.f.at[0, 5, 7].set(jnp.nan))
    with pytest.raises(JDiverged) as je:
        js.run(50)
    for use_kernels, want in ((False, je.value.step), (True, 7)):
        sim = Simulation(to_torch_cfg(cfg), device="cpu",
                         use_kernels=use_kernels)
        sim.run(3)
        assert int(sim.state.fail_step) == -1
        sim.state.f[0, 5, 7] = float("nan")
        with pytest.raises(SimulationDiverged) as te:
            sim.run(50)
        assert te.value.step == want == int(sim.state.step)
        assert int(sim.state.fail_step) == want
    assert je.value.step == 4
    sim = Simulation(to_torch_cfg(cfg), device="cpu", use_kernels=False)
    sim.run(3)
    sim.state.f[0, 5, 7] = float("nan")
    with pytest.raises(SimulationDiverged):
        sim.run(50)
    np.testing.assert_allclose(np.asarray(js.state.f), npy(sim.state.f),
                               rtol=0, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paranoid_coupled_clean_then_nan_disk(use_kernels):
    """JAX tests/test_aux.py's coupled scene: paranoia on, no false
    positive over a clean run; a NaN disk position is caught at the next
    step, as in the JAX plain path (per-step validation on both of the
    port's paths)."""
    cfg = JCfg(nx=32, ny=32, tau=0.8, paranoia=True, g_py=-1e-4,
               rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=5,
               bc_west="wall", bc_east="wall", out_interval=100)
    disks = [JDisk(16.0, 20.0, 3.0)]
    js = JSim(cfg, disks)
    js.run(5)
    d = js.state.disks
    js.state = js.state._replace(disks=d._replace(x=d.x.at[0, 1].set(jnp.nan)))
    with pytest.raises(JDiverged) as je:
        js.run(10)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu",
                     use_kernels=use_kernels)
    sim.run(5)
    assert int(sim.state.fail_step) == -1
    sim.state.disks.x[0, 1] = float("nan")
    with pytest.raises(SimulationDiverged) as te:
        sim.run(10)
    assert te.value.step == je.value.step == 6
    assert int(sim.state.step) == int(js.state.step) == 6


def _static(paranoia):
    return (JCfg(nx=128, ny=32, tau=0.8, gx=1e-5, paranoia=paranoia,
                 bc_west="wall", bc_east="wall", out_interval=100),
            [JDisk(40.0, 16.0, 3.0, fixed=True)])


def test_paranoia_chunk_static_hoist_matches_jax():
    """JAX tests/test_aux.py's chunk mode on the static hoist (its
    Pallas path in interpret mode): a NaN injected at step 4 is reported
    at the end of the K7 pass, step 8, with the state frozen there."""
    cfg, disks = _static("chunk")
    js = JSim(cfg, disks, use_pallas=True)
    js.run(4)
    js.state = js.state._replace(f=js.state.f.at[0, 5, 7].set(jnp.nan))
    with pytest.raises(JDiverged) as je:
        js.run(8)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    assert sim.static_solid
    sim.run(4)
    assert int(sim.state.fail_step) == -1
    sim.state.f[0, 5, 7] = float("nan")
    with pytest.raises(SimulationDiverged) as te:
        sim.run(8)
    assert te.value.step == je.value.step == 8
    assert int(sim.state.step) == int(js.state.step) == 8
    np.testing.assert_allclose(np.asarray(js.state.f), npy(sim.state.f),
                               rtol=0, atol=1e-5, equal_nan=True)


def test_paranoia_step_on_static_scene_is_per_step():
    """paranoia="step" gives up the static hoist (as in the JAX
    package): the NaN injected at step 4 is reported at step 5, as the
    JAX per-step path reports it."""
    cfg, disks = _static(True)
    js = JSim(cfg, disks)
    js.run(4)
    js.state = js.state._replace(f=js.state.f.at[0, 5, 7].set(jnp.nan))
    with pytest.raises(JDiverged) as je:
        js.run(8)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu")
    sim.run(4)
    sim.state.f[0, 5, 7] = float("nan")
    with pytest.raises(SimulationDiverged) as te:
        sim.run(8)
    assert te.value.step == je.value.step == 5 == int(sim.state.step)


def test_paranoia_chunk_cadence_block():
    """Chunk mode on the coupled Verlet-cadence chunk (the scene of the
    JAX package's slow test_paranoia_chunk_cadence_coupled): one
    validation per BIN_CADENCE block, so a NaN disk velocity injected at
    step 8 is reported at step 16, the state frozen at that block's end
    while the run's later blocks step on."""
    cfg = JCfg(nx=128, ny=32, tau=0.8, g_py=-1e-4, rho_s=2.0, kn=0.5,
               gamma_n=0.5, n_sub=5, paranoia="chunk", bc_west="wall",
               bc_east="wall", out_interval=100)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(
        [JDisk(64.0, 16.0, 3.0)]), device="cpu")
    sim.run(8)
    assert int(sim.state.fail_step) == -1
    sim.state.disks.v[0, 0] = float("nan")
    with pytest.raises(SimulationDiverged) as te:
        sim.run(24)
    assert te.value.step == 16 == int(sim.state.step)
    assert not bool(torch.isfinite(sim.state.disks.v).all())


def test_paranoia_step_refuses_coupling_k():
    cfg = _cfg(dtype="float32", coupling_k=4, paranoia=True)
    with pytest.raises(ValueError, match="paranoia='step'"):
        Simulation(to_torch_cfg(cfg), to_torch_disks(DISKS), device="cpu")


# --- checkpoints ---------------------------------------------------------

def _jax_steps(cfg, disks, n, state=None):
    js = JSim(cfg, disks)
    step = jax.jit(jmake_step_fn(js.cfg, js.grid, False))
    s = js.state if state is None else state
    for _ in range(n):
        s = step(s)
    return js, s


def test_checkpoint_from_jax_continues_in_the_port(tmp_path):
    """JAX writes after 10 steps; the port restores and continues 10
    more: equal to JAX continuing (float64, 1e-9)."""
    cfg = _cfg()
    js, s = _jax_steps(cfg, DISKS, 10)
    path = str(tmp_path / "j.npz")
    jckpt.save_state(path, s, cfg)
    _, s_cont = _jax_steps(cfg, DISKS, 10, s)
    sim = _plain(cfg, DISKS)
    sim.state = ckpt.load_state(path, sim.state)
    assert int(sim.state.step) == 10 and int(sim.state.fail_step) == -1
    sim.run(10)
    _assert_state(s_cont, sim.state, 1e-9)


def test_checkpoint_from_the_port_restores_in_jax(tmp_path):
    """The port writes after 10 steps; JAX restores the same values and
    continues: equal to the port continuing (float64, 1e-9)."""
    cfg = _cfg()
    sim = _plain(cfg, DISKS)
    sim.run(10)
    path = str(tmp_path / "t.npz")
    ckpt.save_state(path, sim.state, sim.cfg)
    js = JSim(cfg, DISKS)
    s = jckpt.load_state(path, js.state)
    _assert_state(s, sim.state, 0.0)
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
    assert meta["magic"] == "lbmdem_tpu_ckpt_v1" and meta["n_leaves"] == 17
    assert meta["config"]["nx"] == 32
    _, s = _jax_steps(cfg, DISKS, 10, s)
    sim.run(10)
    _assert_state(s, sim.state, 1e-9)


def test_checkpoint_resume_identical_trajectory(tmp_path):
    """The kernel path (its plain versions on the CPU): 10 steps, save,
    10 more; a restore into a fresh Simulation and the same 10 steps land
    on the same state bit for bit."""
    cfg, disks = to_torch_cfg(_cfg(dtype="float32")), to_torch_disks(DISKS)
    sim = Simulation(cfg, disks, device="cpu")
    sim.run(10)
    path = str(tmp_path / "r.npz")
    ckpt.save_state(path, ckpt.to_host(sim.state), sim.cfg)
    sim.run(10)
    res = Simulation(cfg, disks, device="cpu")
    res.state = ckpt.load_state(path, res.state)
    res.run(10)
    assert torch.equal(sim.state.f, res.state.f)
    for a, b in zip(sim.state.disks, res.state.disks):
        assert torch.equal(a, b)


def test_checkpoint_bf16_roundtrips_exact(tmp_path):
    cfg = to_torch_cfg(_cfg(max_disks=0, f_storage="bfloat16",
                            dtype="float32"))
    sim = Simulation(cfg, device="cpu")
    sim.run(5)
    assert sim.state.f.dtype == torch.bfloat16
    path = str(tmp_path / "b.npz")
    ckpt.save_state(path, sim.state, cfg)
    res = ckpt.load_state(path, Simulation(cfg, device="cpu").state)
    assert res.f.dtype == torch.bfloat16
    assert torch.equal(res.f.view(torch.int16), sim.state.f.view(torch.int16))
    with np.load(path) as z:
        assert json.loads(str(z["__meta__"]))["dtypes"][0] == "bfloat16"
        assert z["leaf_0"].dtype == np.float32


def test_checkpoint_storage_change_rejected(tmp_path):
    cfg = to_torch_cfg(_cfg(max_disks=0, dtype="float32"))
    path = str(tmp_path / "s.npz")
    ckpt.save_state(path, Simulation(cfg, device="cpu").state, cfg)
    other = Simulation(cfg.replace(f_storage="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        ckpt.load_state(path, other.state)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save_state(path, _plain(_cfg(), DISKS).state)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state(path, _plain(_cfg(nx=64), DISKS).state)


# --- metrics --------------------------------------------------------------

def test_diagnostics_match_jax(tmp_path):
    """compute_diagnostics on one state (JAX's after 6 steps, loaded into
    the port): every key within 1e-12 in float64; MetricsLogger writes
    the JAX logger's columns."""
    cfg = _cfg()
    js, s = _jax_steps(cfg, [JDisk(16.2, 40.0, 3.0, vx=0.01, omega=0.002)], 6)
    jd = {k: v.item() for k, v in jmetrics.compute_diagnostics(s, js.cfg)
          .items()}
    sim = _plain(cfg, DISKS)
    sim.load_state(jax_state_to_numpy(s))
    td = metrics.read_diagnostics(sim.state, sim.cfg)
    assert list(td) == sorted(jd)
    for k, v in jd.items():
        assert type(td[k]) is type(v), k
        np.testing.assert_allclose(td[k], v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    js.state = s
    jlog = jmetrics.MetricsLogger(str(tmp_path / "j.csv"))
    tlog = metrics.MetricsLogger(str(tmp_path / "t.csv"),
                                 str(tmp_path / "t.jsonl"))
    jlog.log(js)
    tlog.log(sim)
    sim.run(3)
    row = tlog.log(sim)
    assert row["step"] == 9 and row["mlups"] > 0
    jl = open(tmp_path / "j.csv").read().splitlines()
    tl = open(tmp_path / "t.csv").read().splitlines()
    assert tl[0] == jl[0] and len(tl) == 3
    assert json.loads(open(tmp_path / "t.jsonl").read().splitlines()[1])[
        "step"] == 9


# --- VTK and CSV writers --------------------------------------------------

def _fields(seed=0, ny=24, nx=40):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((ny, nx)).astype(np.float32)
            for _ in range(3)] + [rng.random((ny, nx)).astype(np.float32)]


def _disks(seed=1, n=7):
    rng = np.random.default_rng(seed)
    act = rng.random(n) > 0.3
    return {"x": rng.uniform(0, 40, (n, 2)), "v": rng.normal(0, 0.01, (n, 2)),
            "r": rng.uniform(2, 5, n), "omega": rng.normal(0, 1e-3, n),
            "theta": rng.normal(0, 1, n), "active": act}


def _python_only(monkeypatch):
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "write_fluid_vtk", lambda *a, **k: False)
        monkeypatch.setattr(mod, "append_particle_csv", lambda *a, **k: False)


@pytest.mark.parametrize("writer", ["native", "python"])
def test_writers_match_jax_byte_for_byte(tmp_path, monkeypatch, writer):
    """Fluid VTK (binary with and without eps, ASCII), particle VTK, the
    trajectory and force CSVs: the port's files equal the JAX writers'
    byte for byte, through the native writer and through the Python
    one."""
    if writer == "native":
        if native.get_lib() is None or jnative.get_lib() is None:
            pytest.skip("no native toolchain")
    else:
        _python_only(monkeypatch)
    rho, ux, uy, eps = _fields()
    d = {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in _disks().items()}
    F = np.random.default_rng(2).standard_normal((7, 2))
    T = np.random.default_rng(3).standard_normal(7)

    def write(mod, tag):
        p = lambda name: str(tmp_path / f"{tag}_{name}")
        mod.write_fluid_vtk(p("f.vtk"), rho, ux, uy, eps, binary=True)
        mod.write_fluid_vtk(p("g.vtk"), rho, ux, uy, None, binary=True)
        mod.write_fluid_vtk(p("a.vtk"), rho, ux, uy, eps, binary=False)
        mod.write_particles_vtk(p("p.vtk"), d)
        for step in (10, 20):
            mod.append_particle_csv(p("t.csv"), step, d)
            mod.append_force_csv(p("F.csv"), step, d["active"], F, T)

    write(jvtk, "jax")
    write(io_vtk, "port")
    for name in ("f.vtk", "g.vtk", "a.vtk", "p.vtk", "t.csv", "F.csv"):
        a = (tmp_path / f"jax_{name}").read_bytes()
        b = (tmp_path / f"port_{name}").read_bytes()
        assert a == b, name
    rows = (tmp_path / "port_t.csv").read_text().splitlines()
    assert rows[0] == "step,id,x,y,vx,vy,theta,omega"
    assert len(rows) == 1 + 2 * int(d["active"].sum())


def test_snapshot_of_a_simulation_matches_jax(tmp_path):
    """The fluid and particle VTK of one state (JAX's after 4 steps,
    loaded into the port): macroscopic(), solid_fraction() and
    disk_arrays() give the JAX files' bytes."""
    cfg = _cfg()
    js, s = _jax_steps(cfg, DISKS, 4)
    js.state = s
    sim = _plain(cfg, DISKS)
    sim.load_state(jax_state_to_numpy(s))
    for mod, obj, tag in ((jvtk, js, "j"), (io_vtk, sim, "t")):
        rho, ux, uy = obj.macroscopic()
        mod.write_fluid_vtk(str(tmp_path / f"{tag}.vtk"),
                            *(a.astype(np.float32) for a in (rho, ux, uy)),
                            obj.solid_fraction().astype(np.float32))
        mod.write_particles_vtk(str(tmp_path / f"{tag}p.vtk"),
                                obj.disk_arrays())
    assert (tmp_path / "jp.vtk").read_bytes() == (tmp_path / "tp.vtk"
                                                  ).read_bytes()
    a = (tmp_path / "j.vtk").read_bytes()
    b = (tmp_path / "t.vtk").read_bytes()
    assert len(a) == len(b) and a[:200] == b[:200]


# --- the asynchronous writer and profiling -------------------------------

def test_async_writer_ordering_and_backpressure(tmp_path):
    log = tmp_path / "order.txt"

    def slow_append(tag):
        time.sleep(0.02)
        with open(log, "a") as fh:
            fh.write(f"{tag}\n")

    w = AsyncWriter(max_pending=2)
    t0 = time.perf_counter()
    for i in range(8):
        w.submit(slow_append, i)
    # 8 x 20 ms through a 2-deep queue: submit blocked (backpressure)
    assert time.perf_counter() - t0 > 0.05
    w.close()
    assert log.read_text().splitlines() == [str(i) for i in range(8)]
    with pytest.raises(RuntimeError, match="after close"):
        w.submit(slow_append, 9)


def test_async_writer_error_surfaces():
    w = AsyncWriter(max_pending=1)

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="snapshot write failed") as e:
        for _ in range(4):
            w.submit(lambda: None)
        w.close()
    assert isinstance(e.value.__cause__, OSError)


def test_profiling_trace_timer_and_mlups(tmp_path):
    """trace() writes a Chrome trace that holds the program's spans (the
    region timer and the MLUPS helper are gone: Simulation.run times
    itself)."""
    sim = Simulation(SimConfig(nx=64, ny=32, tau=0.8), device="cpu")
    with profiling.trace(str(tmp_path / "tr")):
        sim.run(4)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("lbmdem.run") == 1
    assert names.count("lbmdem.step") == 1
    assert names.count("lbmdem.sync.run_end") == 1
    assert not hasattr(profiling, "Timer") and not hasattr(profiling, "mlups")
