"""The lattice mesh of the port (`lbmdem_tpu_torch/parallel/`) on the
CPU, its shards on `["cpu"] * n`, against the JAX package.

- The pre-haloed kernels' plain versions (K4 "y"/"yx", K5 k = 4 with
  edge flags, ny_glob and a Zou/He case, K2 "y"/"yx" with origin) against
  the JAX Pallas entries in interpret mode at the smallest legal shard
  (64 x 128), on the same seeded numpy inputs. Bars: the JAX package's
  own, as tests/test_torch_fluid.py holds the halo-free K4/K5 - K4 atol
  1e-7 with rtol 1e-6, K5 atol 5e-7 with rtol 1e-5 (the Pallas collide
  rounds its Guo forcing terms differently, ~2.7e-7 after 4 forced
  steps), 2e-6 with Zou/He (the TPU kernel evaluates the inlet profile in
  f32, the port reads the f64-built array); K2 f' 5e-6, partials 1e-6 of
  the largest.
- The plain sharded step against the JAX make_sharded_step(use_pallas=
  False) on the 8-device CPU mesh of tests/conftest.py, float64, meshes
  (4, 1) and (2, 2): pure fluid, a cavity with walls and moving walls,
  Zou/He, the three-disk coupled scene of tests/test_sharding.py. Bars
  1e-12 (f, disk x, v, omega).
- The sharded kernel path (its plain versions here) against the port's
  single-device kernel path, at the JAX sharded-kernel bars (f 2e-6, x
  1e-6, v 1e-7): the coupled and temporal-block scenes of
  tests/test_sharding.py and a periodic-x coupled case with a disk on
  the seam; Simulation(mesh=...).run(11) (8 + 3 cadence steps) at the
  chunk bars (f 5e-6, x 1e-5, v 1e-6) and the fluid run(9) (two K5
  blocks and a K4 step).
- The CLI's --mesh on the CPU, and what a mesh took in the later
  slices: coupling_k > 1, the static hoist, paranoid mode, K8's
  prehalo, bf16 storage run against one device
  (tests/test_torch_mesh_window.py and tests/test_torch_mesh_bf16.py
  hold those paths), K5 deeper than one sweep on a frame
  (tests/test_torch_mesh_deep.py) and several processes
  (tests/test_torch_distributed.py)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.ops import pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu.parallel import (make_mesh as jmake_mesh,
                                 make_sharded_step as jsharded_step,
                                 shard_state as jshard_state)
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation, cli
from lbmdem_tpu_torch.ops import fused_fluid, fused_lbm, stamp
from lbmdem_tpu_torch.parallel import (make_mesh, make_sharded_step,
                                       shard_state, unshard)
from lbmdem_tpu_torch.parallel._kernel_step import canvas_pads

from torch_parity_util import (npy, perturbed_f, random_disks,
                               to_torch_cfg, to_torch_disks, tt)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _cpu_mesh(dims):
    return make_mesh(["cpu"] * (dims[0] * dims[1]), dims)


def _jax_mesh(dims):
    return jmake_mesh(jax.devices()[:dims[0] * dims[1]], dims)


# --- the pre-haloed kernels against the JAX Pallas entries ------------

H, W = 64, 128  # the smallest legal shard
FLUID_OPTS = {
    "walls+lid": dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                      gy=-1e-5),
    "periodic": dict(bc_south="periodic", bc_north="periodic", gx=1e-5),
}
ZOU_HE = dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
              inlet_profile="poiseuille")


def _frame(mode, seed):
    shape = fused_fluid.frame_shape(SimConfig(nx=W, ny=H), mode)
    return perturbed_f(shape, seed, np.float32, amp=0.05)


@pytest.mark.parametrize("mode", ["y", "yx"])
@pytest.mark.parametrize("opt", sorted(FLUID_OPTS))
def test_k4_prehalo_matches_pallas(mode, opt):
    """K4 on a pre-haloed frame: the y walls ("y") or every wall ("yx")
    left to the caller, as the JAX kernel leaves them."""
    cfg = JCfg(nx=W, ny=H, tau=0.8, dtype="float32", **FLUID_OPTS[opt])
    f = _frame(mode, 1)
    want = pk.fused_step_fluid(jnp.asarray(f), cfg,
                               prehalo=True if mode == "y" else "yx")
    out = torch.empty((9, H, W))
    got = fused_fluid.fused_step_fluid(tt(f), to_torch_cfg(cfg), out,
                                       prehalo=mode)
    assert got is out
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("mode,opt,edges", [
    ("y", "walls+lid", (1, 1, 1, 1, 0)),
    ("yx", "walls+lid", (1, 0, 0, 1, 0)),
    ("yx", "periodic", (0, 0, 1, 0, 64)),
    ("y", "zou-he", (0, 1, 1, 1, 192)),
    ("yx", "zou-he", (1, 0, 1, 0, 0)),
])
def test_k5_prehalo_matches_pallas(mode, opt, edges):
    """K5 (k = 4) on a pre-haloed frame: walls and Zou/He at every inner
    step on the shard's global edges (`edges`), the inlet profile at the
    global row offset edges[4] of ny_glob = 4 H rows."""
    kw = ZOU_HE if opt == "zou-he" else FLUID_OPTS[opt]
    cfg = JCfg(nx=W, ny=H, tau=0.7, dtype="float32", **kw)
    f = _frame(mode, 2)
    want = pk.fused_step_fluid_multi(
        jnp.asarray(f), cfg, 4, prehalo=True if mode == "y" else "yx",
        edges=jnp.asarray(edges, jnp.int32), ny_glob=4 * H)
    out = torch.empty((9, H, W))
    got = fused_fluid.fused_step_fluid_multi(tt(f), to_torch_cfg(cfg), 4, out,
                                             prehalo=mode, edges=edges,
                                             ny_glob=4 * H)
    atol = 2e-6 if opt == "zou-he" else 5e-7
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=1e-5,
                               atol=atol)


def _canvas_inputs(mode, seed, n=14):
    """A shard's K2 inputs as the sharded step makes them: disks (canvas
    coordinates, some in the apron) binned and stamped on the canvas,
    the interior tiles' binning and the solid window."""
    pady, padx = canvas_pads(H, mode == "yx")
    cfg = JCfg(nx=W, ny=H, tau=0.8, dtype="float32", max_disks=n, window=9,
               tile_cap=32, bc_west="wall", bc_east="wall")
    canvas = to_torch_cfg(cfg.replace(ny=H + 2 * pady, nx=W + 2 * padx))
    x, v, om, r, act = random_disks(n, canvas.nx, canvas.ny, seed,
                                    r_lo=1.5, r_hi=3.5)
    x[0] = (padx + 0.3, pady + 0.4)  # on the interior's corner
    x = [tt(a.astype(np.float32)) for a in (x, v, om, r)] + [tt(act)]
    lists, counts, entries_c, ovf = stamp.build_tile_lists(x[0], x[4], canvas)
    assert int(ovf) == 0
    td = stamp.gather_tile_data(lists, *x)
    solid = stamp.stamp_fields(td, counts, canvas)
    th, tw = stamp.tile_dims(canvas)
    nty, ntx = canvas.ny // th, canvas.nx // tw
    oy, ox, ny_i, nx_i = pady // th, padx // tw, H // th, W // tw
    td_i = td.reshape(nty, ntx, -1)[oy:oy + ny_i, ox:ox + nx_i].reshape(
        ny_i * nx_i, 1, -1).contiguous()
    cnt_i = counts.reshape(nty, ntx)[oy:oy + ny_i, ox:ox + nx_i].reshape(
        -1, 1, 1).contiguous()
    entries = stamp.remap_entry_slots(entries_c, cfg.tile_cap, ntx, oy, ox,
                                      ny_i, nx_i)
    s_k = solid[:, pady - 8:pady + H + 8, :].contiguous()
    return cfg, (pady, padx), td_i, cnt_i, entries, s_k


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_k2_prehalo_matches_pallas(mode):
    """K2 on a pre-haloed frame and solid window, its reduce at the
    interior's origin in the canvas: f' and the partials of the interior
    tiles in K2's slot numbering."""
    cfg, origin, td, cnt, entries, s_k = _canvas_inputs(mode, 3)
    f = _frame(mode, 4)
    want_f, want_p = pk.fused_step_imb_reduce(
        jnp.asarray(f), jnp.asarray(npy(s_k)), None, None, cfg,
        jnp.asarray(npy(td)), jnp.asarray(npy(cnt)),
        prehalo=True if mode == "y" else "yx", origin=origin)
    out = torch.empty((9, H, W))
    got_f, got_p = fused_lbm.fused_step_imb_reduce(
        tt(f), s_k, td, cnt, to_torch_cfg(cfg), out, prehalo=mode,
        origin=origin)
    np.testing.assert_allclose(npy(got_f), np.asarray(want_f), rtol=0,
                               atol=5e-6)
    want_p = np.asarray(want_p).reshape(-1, 4)
    scale = max(float(np.abs(want_p).max()), 1e-30)
    assert scale > 1e-6  # the disks feel a force
    np.testing.assert_allclose(npy(got_p), want_p, rtol=0, atol=1e-6 * scale)
    # the interior entry slots address exactly the nonzero rows' disks
    assert int((entries >= 0).sum()) > 0


def test_remap_entry_slots_matches_jax():
    es = torch.tensor([[0, 5, 37, -1], [70, 71, 100, 129]], dtype=torch.int32)
    want = ps.remap_entry_slots(jnp.asarray(npy(es)), 8, 4, 1, 1, 2, 2)
    got = stamp.remap_entry_slots(es, 8, 4, 1, 1, 2, 2)
    np.testing.assert_array_equal(npy(got), np.asarray(want))


# --- the plain sharded step against the JAX XLA sharded step ----------

def _three_disks():
    return [JDisk(16.0, 16.0, 3.0), JDisk(8.2, 24.1, 2.5),
            JDisk(15.0, 7.5, 2.0, vx=0.01)]


PLAIN_SCENES = {
    "fluid": (JCfg(nx=32, ny=16, tau=0.8, gx=1e-5, dtype="float64"), []),
    "cavity": (JCfg(nx=16, ny=16, tau=0.7, gy=-1e-5, dtype="float64",
                    bc_west="wall", bc_east="wall", uw_north=0.08,
                    uw_west=0.02), []),
    "zou-he": (JCfg(nx=32, ny=16, tau=0.8, dtype="float64", **ZOU_HE), []),
    "coupled": (JCfg(nx=32, ny=32, tau=0.8, dtype="float64", g_py=-1e-4,
                     buoyancy=True, rho_s=2.5, kn=0.5, gamma_n=0.5, n_sub=5,
                     bc_west="wall", bc_east="wall"), _three_disks()),
}


@pytest.mark.parametrize("dims", [(4, 1), (2, 2)])
@pytest.mark.parametrize("scene", sorted(PLAIN_SCENES))
def test_plain_sharded_step_matches_jax(scene, dims):
    """4 steps of the plain sharded step (float64) against the JAX
    make_sharded_step(use_pallas=False) on the same mesh shape."""
    jcfg, jdisks = PLAIN_SCENES[scene]
    js = JSim(jcfg, jdisks)
    jmesh = _jax_mesh(dims)
    jstep = jax.jit(jsharded_step(js.cfg, js.grid, jmesh))
    jst = jshard_state(js.state, jmesh)
    sim = Simulation(to_torch_cfg(jcfg), to_torch_disks(jdisks),
                     device="cpu", use_kernels=False)
    mesh = _cpu_mesh(dims)
    step = make_sharded_step(sim.cfg, sim.grid, mesh, dem_mode=sim.dem_mode)
    ms = shard_state(sim.state, mesh)
    for _ in range(4):
        jst = jstep(jst)
        ms = step(ms, None)
    st = unshard(ms, mesh)
    np.testing.assert_allclose(npy(st.f), np.asarray(jst.f), rtol=0,
                               atol=1e-12)
    if jdisks:
        for name in ("x", "v", "omega"):
            np.testing.assert_allclose(npy(getattr(st.disks, name)),
                                       np.asarray(getattr(jst.disks, name)),
                                       rtol=0, atol=1e-12)
        assert int(st.overflow) == 0
    # every replica and shard agrees with the gathered state
    assert all(torch.equal(ms.disks[0].x, d.x) for d in ms.disks)


# --- the sharded kernel path against the single-device kernel path ----

def _tcfg(**kw):
    return SimConfig(**{"tau": 0.8, "dtype": "float32", **kw})


def _coupled_cfg(nx, ny=128, **kw):
    return _tcfg(nx=nx, ny=ny, g_py=-1e-4, buoyancy=True, rho_s=2.0, kn=0.5,
                 gamma_n=0.5, n_sub=5, **kw)


def _kernel_steps(cfg, disks, dims, n, kstep=1):
    """n steps of the single-device kernel path (make_step_fn) and of the
    sharded one, kstep steps per call (K5 blocks for pure fluid)."""
    from lbmdem_tpu_torch.simulation import make_step_fn

    one = Simulation(cfg, disks, device="cpu")
    mesh = _cpu_mesh(dims)
    sh = Simulation(cfg, disks, device="cpu", mesh=mesh)
    step1 = make_step_fn(one.cfg, one.grid, dem_axis=one.dem_axis,
                         temporal_k=kstep, dem_mode=one.dem_mode)
    stepm = make_sharded_step(sh.cfg, sh.grid, mesh, True,
                              dem_axis=sh.dem_axis, temporal_k=kstep,
                              dem_mode=sh.dem_mode)
    for _ in range(n // kstep):
        one._advance(step1)
        sh._advance(stepm)
    return one.state, sh.state


def _assert_close(a, b, f_tol, x_tol=None, v_tol=None):
    np.testing.assert_allclose(npy(b.f), npy(a.f), rtol=0, atol=f_tol)
    assert int(a.step) == int(b.step)
    if x_tol is not None:
        np.testing.assert_allclose(npy(b.disks.x), npy(a.disks.x), rtol=0,
                                   atol=x_tol)
        np.testing.assert_allclose(npy(b.disks.v), npy(a.disks.v), rtol=0,
                                   atol=v_tol)
        assert int(b.overflow) == 0


@pytest.mark.parametrize("dims", [(4, 1), (2, 2)])
def test_kernel_path_coupled_step_matches_one_device(dims):
    """tests/test_sharding.py's sharded fused coupled scene: disks on the
    mesh centre, inside a shard and near a boundary, 2 steps with a fresh
    canvas binning each."""
    nx = 128 * dims[1]
    disks = [DiskSpec(nx / 2, 64.0, 3.0), DiskSpec(32.2, 96.1, 2.5),
             DiskSpec(90.0, 31.9, 2.0, vx=0.01)]
    a, b = _kernel_steps(_coupled_cfg(nx, bc_west="wall", bc_east="wall"),
                         disks, dims, 2)
    _assert_close(a, b, 2e-6, 1e-6, 1e-7)


def test_kernel_path_periodic_x_seam_matches_one_device():
    """Periodic x on a (4, 1) mesh with a disk on the x seam (its ghost
    on the far side) and one on a shard seam."""
    disks = [DiskSpec(0.6, 40.0, 3.0, vx=-0.01), DiskSpec(60.0, 64.2, 2.5),
             DiskSpec(100.0, 90.0, 2.0)]
    a, b = _kernel_steps(_coupled_cfg(128), disks, (4, 1), 3)
    _assert_close(a, b, 2e-6, 1e-6, 1e-7)


@pytest.mark.parametrize("dims,kw", [
    ((2, 2), dict(nx=512, ny=64, tau=0.7, gy=-1e-5, bc_west="wall",
                  bc_east="wall", uw_north=0.05)),
    ((4, 1), dict(nx=128, ny=64, tau=0.7, **ZOU_HE)),
    ((2, 2), dict(nx=256, ny=64, tau=0.7, bc_south="periodic",
                  bc_north="periodic", **ZOU_HE)),
], ids=["walls+lid", "zou-he", "zou-he-periodic-y"])
@pytest.mark.parametrize("kstep", [1, 4])
def test_kernel_path_fluid_matches_one_device(dims, kw, kstep):
    """8 pure-fluid steps: K4 with the edge fixups outside the kernel
    (kstep 1), or two K5 blocks with the walls and Zou/He closures of the
    shards' edges in the kernel (kstep 4)."""
    a, b = _kernel_steps(_tcfg(**kw), [], dims, 8, kstep)
    _assert_close(a, b, 2e-6)


def test_simulation_mesh_coupled_run_matches():
    """Simulation(mesh=...).run(11) through the sharded Verlet-cadence
    chunk (8 + 3 steps) against Simulation().run(11) (the JAX chunk test's
    scene and bars)."""
    cfg = _coupled_cfg(128, bc_west="wall", bc_east="wall", out_interval=11)
    disks = [DiskSpec(64.0, 64.0, 3.0), DiskSpec(32.2, 96.1, 2.5),
             DiskSpec(90.0, 31.9, 2.0, vx=0.01)]
    one = Simulation(cfg, disks, device="cpu")
    sh = Simulation(cfg, disks, mesh=_cpu_mesh((4, 1)))
    one.run(11)
    sh.run(11)
    _assert_close(one.state, sh.state, 5e-6, 1e-5, 1e-6)
    assert int(sh.state.step) == 11


def test_simulation_mesh_fluid_run_matches():
    """The pure-fluid run(9): two K5 blocks then one K4 step per shard."""
    cfg = _tcfg(nx=256, ny=64, gx=1e-5, out_interval=9)
    one = Simulation(cfg, device="cpu")
    sh = Simulation(cfg, mesh=_cpu_mesh((2, 2)))
    one.run(9)
    sh.run(9)
    _assert_close(one.state, sh.state, 2e-6)
    assert int(sh.state.step) == 9
    # the observation methods work on the gathered state
    rho, ux, _ = sh.macroscopic()
    assert rho.shape == (64, 256) and float(ux.mean()) > 0.0


def test_mesh_state_roundtrip_and_load_state():
    """Setting `state` shards it; load_state of a gathered state keeps
    the run going as the single-device Simulation does."""
    from lbmdem_tpu_torch.interop import state_to_numpy

    cfg = _coupled_cfg(128, bc_west="wall", bc_east="wall")
    disks = [DiskSpec(64.0, 64.0, 3.0)]
    one = Simulation(cfg, disks, device="cpu")
    one.run(3)
    sh = Simulation(cfg, disks, mesh=_cpu_mesh((2, 1)))
    sh.load_state(state_to_numpy(one.state))
    assert torch.equal(sh.state.f, one.state.f)
    one.run(2)
    sh.run(2)
    _assert_close(one.state, sh.state, 5e-6, 1e-5, 1e-6)


# --- the CLI, the gates and the refusals --------------------------------

def test_cli_mesh_on_the_cpu(tmp_path, capsys):
    """--mesh 2x2 --device cpu runs a small deck on four CPU shards (the
    kernels' plain versions) and writes its files."""
    deck = tmp_path / "run.par"
    deck.write_text("nx 256\nny 64\ntau 0.8\nsteps 8\nout_interval 4\n"
                    "bc west wall\nbc east wall\nbc south wall\n"
                    "bc north wall\ng_py -1e-5\nkn 1.0\ngamma_n 1.0\n"
                    "rho_s 2.0\nn_sub 5\nbuoyancy 1\nparticles disks.txt\n")
    (tmp_path / "disks.txt").write_text("128 32 4.0\n60 20 3.0\n")
    out = tmp_path / "out"
    assert cli.main([str(deck), "--mesh", "2x2", "--device", "cpu",
                     "--kernels", "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "2x2 shards on 1 device(s), kernels" in err
    assert (out / "metrics.csv").exists()
    assert (out / "fluid_00000008.vtk").exists()


def test_kernels_supported_on_a_mesh():
    mesh = _cpu_mesh((2, 2))
    from lbmdem_tpu_torch.simulation import derive_config, kernels_supported

    cfg, _ = derive_config(_coupled_cfg(256, 128), [DiskSpec(60, 60, 3.0)])
    assert kernels_supported(cfg, "cpu", mesh) is None
    assert "tile the 2x2 mesh" in kernels_supported(
        cfg.replace(ny=129), "cpu", mesh)
    assert "nx%128" in kernels_supported(cfg.replace(nx=128), "cpu", mesh)
    big, _ = derive_config(_coupled_cfg(256, 16), [DiskSpec(60, 8, 3.0)])
    assert "stamp-canvas stamp tile" in kernels_supported(big, "cpu", mesh)
    with pytest.raises(ValueError, match="use_kernels=True unsupported"):
        Simulation(_tcfg(nx=128, ny=64), mesh=mesh)
    # the plain sharded step takes what the kernels cannot
    Simulation(_tcfg(nx=128, ny=64), mesh=mesh, use_kernels=False).run(2)


def _refusals():
    coupled = _coupled_cfg(256, 128, bc_west="wall", bc_east="wall")
    mobile = [DiskSpec(60.0, 60.0, 3.0)]
    fixed = [DiskSpec(60.0, 60.0, 3.0, fixed=True)]
    return [
        ("coupling_k", coupled.replace(coupling_k=2), mobile, {}),
        ("static hoist", coupled, fixed, {}),
        ("bf16", _tcfg(nx=256, ny=64, f_storage="bfloat16"), [], {}),
        ("paranoia", coupled.replace(paranoia="chunk"), mobile, {}),
        ("paranoia plain", coupled.replace(paranoia=True), mobile,
         dict(use_kernels=False)),
    ]


@pytest.mark.parametrize("what,cfg,disks,kw", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_mesh_refusals_name_item_12(what, cfg, disks, kw):
    """What raised naming item 12 until the mesh took it - coupling_k >
    1, the static hoist, bf16 storage, paranoid mode on the kernels and
    on the plain sharded step - runs 4 steps on the 2 x 2 mesh healthily
    and lands on the one-device run at the chunk bars (f 5e-6, x 1e-5, v
    1e-6; bf16 f compared in float32)."""
    cfg = cfg.replace(out_interval=4)
    one = Simulation(cfg, disks, device="cpu", **kw)
    sh = Simulation(cfg, disks, mesh=_cpu_mesh((2, 2)), **kw)
    one.run(4)
    sh.run(4)
    if what == "bf16":
        assert sh.state.f.dtype == torch.bfloat16
        np.testing.assert_allclose(npy(sh.state.f.float()),
                                   npy(one.state.f.float()), rtol=0,
                                   atol=5e-6)
        assert int(sh.state.step) == 4 and int(sh.state.fail_step) == -1
        return
    _assert_close(one.state, sh.state, 5e-6, 1e-5, 1e-6)
    assert int(sh.state.fail_step) == -1


def test_other_item_12_refusals(tmp_path):
    """What item 12's last slice took runs: K5 pre-haloed deeper than one
    sweep (on f32 and on bf16 frames) returns k steps of the whole frame
    (`frame_steps_plain`, its plain version) bit for bit, and
    process_info outside a group is process 0 of 1 (the multi-process
    runs themselves: tests/test_torch_distributed.py). A mesh must be a
    Mesh. K8's prehalo runs too: on a frame its f' equals K2's
    pre-haloed f' exactly and its phi is the interior's."""
    from lbmdem_tpu_torch.parallel import process_info

    tcfg = _tcfg(nx=128, ny=64)
    out = torch.empty((9, 64, 128))
    cfg, origin, td, cnt, _, s_k = _canvas_inputs("y", 5)
    fr = tt(_frame("y", 6))
    f8, phix, phiy = fused_lbm.fused_step_imb(
        fr, s_k[0], s_k[1], s_k[2], to_torch_cfg(cfg), out, prehalo=True)
    f2, _ = fused_lbm.fused_step_imb_reduce(
        fr, s_k, td, cnt, to_torch_cfg(cfg), torch.empty_like(out),
        prehalo=True, origin=origin)
    assert torch.equal(f8, f2)
    assert phix.shape == phiy.shape == (64, 128)
    assert float(phix.abs().max()) > 0.0
    bcfg = tcfg.replace(f_storage="bfloat16")
    fb = fused_fluid.lbm.to_storage(tt(perturbed_f(
        fused_fluid.frame_shape(bcfg, "y"), 7, np.float32, amp=0.05)), bcfg)
    for c, f, k in ((tcfg, fr, 8), (bcfg, fb, 16)):
        got = fused_fluid.fused_step_fluid_multi(
            f, c, k, torch.empty((9, 64, 128), dtype=f.dtype), prehalo="y",
            edges=(1, 1, 1, 1))
        g, shift = fused_fluid.compute_form(f, c)
        g = fused_fluid.frame_steps_plain(
            g, c, k, "y", (1, 1, 1, 1), 64,
            lambda a, t: fused_fluid.collide_pairs(a, c, shift), shift)
        want = fused_fluid.frame_interior(g, c, "y").to(f.dtype)
        assert torch.isfinite(got.float()).all() and torch.equal(got, want)
    assert process_info() == (0, 1, 1, 1)
    with pytest.raises(TypeError, match="Mesh"):
        Simulation(tcfg, device="cpu", mesh=object())


def test_package_mesh_imports_without_jax_and_needs_a_card():
    """The public names import in a process with no JAX; make_mesh()
    without devices raises RuntimeError where no card is visible."""
    code = (
        "import sys, torch\n"
        "from lbmdem_tpu_torch import FluidState\n"
        "from lbmdem_tpu_torch.parallel import make_mesh, "
        "make_sharded_step, shard_state\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lbmdem_tpu' or m.startswith('lbmdem_tpu.')]\n"
        "assert not bad, bad\n"
        "assert make_mesh(['cpu'] * 6).shape == {'y': 2, 'x': 3}\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        make_mesh()\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "    else:\n"
        "        raise AssertionError('make_mesh() without a card')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
