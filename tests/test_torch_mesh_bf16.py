"""Shifted-bf16 storage on the lattice mesh of the port, on the CPU, its
shards on `["cpu"] * n`: the pre-haloed kernels' plain versions on
16-row bf16 frames against the JAX package, and Simulation(mesh=...) with
f_storage="bfloat16" against the port's one-device bf16 runs and the JAX
sharded run.

- K4, K5 (k = 2, 4), K2, K6 (k = 2, 4) and K7 (k = 2, 4) on bf16 frames
  (16 halo rows; the solid window keeps 8) against the JAX Pallas
  entries in interpret mode at the smallest legal bf16 shard (64 x 128),
  on the same seeded numpy inputs: modes "y" and "yx", the edge flags of
  corner, edge and interior shards, a Zou/He case. Bars: f' rtol 1e-2
  with atol 1e-6 (one bf16 ulp: the JAX bf16 tests' bar; the coupled
  plain versions compute in physical f, the Pallas kernels and K4/K5's
  plain versions in the shifted form), partials 5e-6 of the largest.
- Simulation(mesh=...) against the port's one-device run on the scenes
  of tests/test_sharding.py's bf16 mesh tests and tests/test_fixed.py's
  bf16 static hoist, at those tests' bars; tests/test_sharding.py's
  fluid scene against the JAX sharded run.
- The refusals (per-shard ny % 16, the plain sharded step, K5 deeper
  than one sweep on a frame), paranoid mode, a state round trip through
  the shards and a checkpoint, and the CLI's --mesh on a bf16 deck."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import lbm as jlbm, pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu.parallel import (make_mesh as jmake_mesh,
                                 make_sharded_step as jsharded_step,
                                 shard_state as jshard_state)
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation, cli
from lbmdem_tpu_torch.ops import fused_fluid, fused_lbm, fused_static
from lbmdem_tpu_torch.parallel import (make_mesh, make_sharded_step,
                                       shard_state, unshard)
from lbmdem_tpu_torch.simulation import SimulationDiverged, make_step_fn

from test_torch_mesh_window import H, W, _shard_inputs as window_shard_inputs
from torch_parity_util import npy, perturbed_f, to_torch_cfg, tt


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _cpu_mesh(dims):
    return make_mesh(["cpu"] * (dims[0] * dims[1]), dims)


def _f32(a):
    """A bf16 array of either package as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, rtol=1e-2, atol=1e-6):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


# --- the pre-haloed kernels on bf16 frames against the JAX Pallas entries

WALLS = dict(bc_west="wall", bc_east="wall", uw_north=0.04, gy=-1e-5)
ZOU_HE = dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
              inlet_profile="poiseuille")


def _opts(opt):
    return ZOU_HE if opt == "zou-he" else WALLS


def _bf16_frame(cfg, mode, seed):
    """A seeded bf16 frame (9, H + 32, W [+ 256]) in storage form, as one
    torch tensor and one jnp array of the same values."""
    f = perturbed_f(fused_fluid.frame_shape(to_torch_cfg(cfg), mode), seed,
                    np.float32, amp=0.05)
    g = (tt(f) - tt(np.asarray(jlbm.storage_shift(cfg)))).to(torch.bfloat16)
    return g, jnp.asarray(_f32(g)).astype(jnp.bfloat16)


def _shard_inputs(mode, seed, **kw):
    """A bf16 shard's inputs as the sharded step makes them
    (tests/test_torch_mesh_window.py's, with f_storage="bfloat16": the
    solid window of 8 halo rows), the f frame of 16 halo rows in storage
    form, as one torch tensor and one jnp array of the same values."""
    cfg, origin, td, cnt, s_k, f = window_shard_inputs(
        mode, seed, f_storage="bfloat16", **kw)
    g = (tt(f) - tt(np.asarray(jlbm.storage_shift(cfg)))).to(torch.bfloat16)
    return cfg, origin, td, cnt, s_k, g, jnp.asarray(_f32(g)).astype(
        jnp.bfloat16)


def _jmode(mode):
    return True if mode == "y" else "yx"


def _partials_close(got, want):
    want = np.asarray(want).reshape(np.asarray(npy(got)).shape)
    scale = float(np.abs(want).max())
    assert scale > 1e-6  # the disks feel a force
    np.testing.assert_allclose(npy(got), want, rtol=0, atol=5e-6 * scale)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_k4_bf16_frame_matches_pallas(mode):
    """K4 on a bf16 frame: the y walls ("y") or every wall ("yx") left to
    the caller; the edge populations it hands out are the shifted ones."""
    cfg = JCfg(nx=W, ny=H, tau=0.8, dtype="float32", f_storage="bfloat16",
               **WALLS)
    f, jf = _bf16_frame(cfg, mode, 1)
    want = pk.fused_step_fluid(jf, cfg, prehalo=_jmode(mode))
    assert want.dtype == jnp.bfloat16
    tcfg = to_torch_cfg(cfg)
    out = torch.empty((9, H, W), dtype=torch.bfloat16)
    edge = (torch.empty((9, 2, W)), torch.empty((9, H, 2)))
    got = fused_fluid.fused_step_fluid(f, tcfg, out, prehalo=mode,
                                       edge_post=edge)
    assert got is out
    _close(got, want)
    # edge_post: the f32 shifted post-collision populations of the rows
    hy = fused_fluid.frame_hy(tcfg)
    assert hy == 16 and tuple(f.shape[1:2]) == (H + 32,)
    g, shift = fused_fluid.compute_form(f, tcfg)
    g = g[:, hy:hy + 1]
    if mode == "yx":
        g = g[:, :, fused_fluid.HX:fused_fluid.HX + W]
    post = fused_fluid.collide_pairs(g, tcfg, shift)
    np.testing.assert_allclose(npy(edge[0][:, 0]), npy(post[:, 0]), rtol=0,
                               atol=1e-7)


# (mode, lattice options, edges (south, north, west, east, global row
# offset of ny_glob = 4 H rows), k): corner, edge and interior shards
TBLOCK_CASES = [
    ("y", "walls", (1, 0, 1, 1, 0), 2),
    ("yx", "walls", (0, 1, 0, 1, 3 * H), 4),
    ("yx", "walls", (0, 0, 0, 0, H), 2),
    ("y", "zou-he", (0, 1, 1, 1, 3 * H), 4),
    ("yx", "zou-he", (1, 0, 1, 0, 0), 2),
]
TBLOCK_IDS = [f"{m}-{o}-{''.join(map(str, e[:4]))}-k{k}"
              for m, o, e, k in TBLOCK_CASES]


@pytest.mark.parametrize("mode,opt,edges,k", TBLOCK_CASES, ids=TBLOCK_IDS)
def test_k5_bf16_frame_matches_pallas(mode, opt, edges, k):
    """K5 on a bf16 frame: k inner steps in f32, one rounding, the walls
    and Zou/He closures of the shard's global edges at every inner
    step."""
    cfg = JCfg(nx=W, ny=H, tau=0.7, dtype="float32", f_storage="bfloat16",
               **_opts(opt))
    f, jf = _bf16_frame(cfg, mode, 2 + k)
    want = pk.fused_step_fluid_multi(
        jf, cfg, k, prehalo=_jmode(mode), edges=jnp.asarray(edges, jnp.int32),
        ny_glob=4 * H)
    out = torch.empty((9, H, W), dtype=torch.bfloat16)
    got = fused_fluid.fused_step_fluid_multi(f, to_torch_cfg(cfg), k, out,
                                             prehalo=mode, edges=edges,
                                             ny_glob=4 * H)
    _close(got, want)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_k2_bf16_frame_matches_pallas(mode):
    """K2 on a bf16 frame and the 8-row solid window, its reduce at the
    interior's origin in the canvas."""
    cfg, origin, td, cnt, s_k, f, jf = _shard_inputs(mode, 3, **WALLS)
    want_f, want_p = pk.fused_step_imb_reduce(
        jf, jnp.asarray(npy(s_k)), None, None, cfg, jnp.asarray(npy(td)),
        jnp.asarray(npy(cnt)), prehalo=_jmode(mode), origin=origin)
    out = torch.empty((9, H, W), dtype=torch.bfloat16)
    got_f, got_p = fused_lbm.fused_step_imb_reduce(
        f, s_k, td, cnt, to_torch_cfg(cfg), out, prehalo=mode, origin=origin)
    _close(got_f, want_f)
    _partials_close(got_p, want_p)


@pytest.mark.parametrize("mode,opt,edges,k", TBLOCK_CASES, ids=TBLOCK_IDS)
def test_k6_k7_bf16_frame_match_pallas(mode, opt, edges, k):
    """K6 (and K7 on the same inputs) on a bf16 frame and the 8-row solid
    window: k inner steps with the walls and Zou/He closures of the
    shard's global edges, K6's reduce of every inner step at the
    interior's origin."""
    cfg, origin, td, cnt, s_k, f, jf = _shard_inputs(mode, 3 + k,
                                                     **_opts(opt))
    tcfg = to_torch_cfg(cfg)
    je = jnp.asarray(edges, jnp.int32)
    want_f, want_p = pk.fused_step_imb_reduce_multi(
        jf, jnp.asarray(npy(s_k)), cfg, k, jnp.asarray(npy(td)),
        jnp.asarray(npy(cnt)), prehalo=_jmode(mode), origin=origin,
        edges=je, ny_glob=4 * H)
    out = torch.empty((9, H, W), dtype=torch.bfloat16)
    got_f, got_p = fused_lbm.fused_step_imb_reduce_multi(
        f, s_k, td, cnt, tcfg, k, out, prehalo=mode, origin=origin,
        edges=edges, ny_glob=4 * H)
    assert tuple(got_p.shape) == tuple(want_p.shape)
    _close(got_f, want_f)
    _partials_close(got_p, want_p)
    want7 = pk.fused_step_imb_static_multi(
        jf, jnp.asarray(npy(s_k)), cfg, k, prehalo=_jmode(mode), edges=je,
        ny_glob=4 * H)
    got7 = fused_static.fused_step_imb_static_multi(
        f, s_k, tcfg, k, torch.empty_like(out), prehalo=mode, edges=edges,
        ny_glob=4 * H)
    _close(got7, want7)


# --- Simulation(mesh=...) with bf16 storage against one device ---------

def _bf16_cfg(**kw):
    return SimConfig(**{"tau": 0.8, "dtype": "float32",
                        "f_storage": "bfloat16", **kw})


def _coupled_cfg(nx, ny=128, **kw):
    return _bf16_cfg(**{"nx": nx, "ny": ny, "g_py": -1e-4, "buoyancy": True,
                        "rho_s": 2.0, "kn": 0.5, "gamma_n": 0.5, "n_sub": 5,
                        **kw})


def _steps(cfg, disks, dims, n, kstep=1):
    """n steps of the one-device kernel path and of the sharded one
    (their plain versions here), kstep steps per call."""
    one = Simulation(cfg, disks, device="cpu")
    sh = Simulation(cfg, disks, mesh=_cpu_mesh(dims))
    step1 = make_step_fn(one.cfg, one.grid, dem_axis=one.dem_axis,
                         temporal_k=kstep, dem_mode=one.dem_mode)
    stepm = make_sharded_step(sh.cfg, sh.grid, sh.mesh, True,
                              dem_axis=sh.dem_axis, temporal_k=kstep,
                              dem_mode=sh.dem_mode)
    for _ in range(n // kstep):
        one._advance(step1)
        sh._advance(stepm)
    return one.state, sh.state


def _disks_close(a, b, x_tol, v_tol):
    np.testing.assert_allclose(npy(b.disks.x), npy(a.disks.x), rtol=0,
                               atol=x_tol)
    np.testing.assert_allclose(npy(b.disks.v), npy(a.disks.v), rtol=0,
                               atol=v_tol)
    assert int(b.overflow) == 0


FLUID_WALLS = dict(nx=512, ny=64, tau=0.7, gy=-1e-5, bc_west="wall",
                   bc_east="wall", uw_north=0.03)


@pytest.mark.parametrize("case", ["walls-2x2", "zou-he-4x1", "k5-4x1"])
def test_mesh_bf16_fluid_matches_one_device(case):
    """tests/test_sharding.py's bf16 fluid scenes: walls and a moving lid
    on 2 x 2 (4 K4 steps with the edge fixups; rtol 1e-2, atol 1e-6), a
    Zou/He channel on 4 x 1 (4 K4 steps, the storage-aware Zou/He fixup;
    rtol 1e-2, atol 5e-4), and K5 blocks on 4 x 1 (8 steps, two blocks
    of 4; atol 2e-6)."""
    if case == "walls-2x2":
        a, b = _steps(_bf16_cfg(**FLUID_WALLS), [], (2, 2), 4)
        bars = dict(rtol=1e-2, atol=1e-6)
    elif case == "zou-he-4x1":
        a, b = _steps(_bf16_cfg(nx=512, ny=64, tau=0.7, **ZOU_HE), [],
                      (4, 1), 4)
        bars = dict(rtol=1e-2, atol=5e-4)
    else:
        a, b = _steps(_bf16_cfg(nx=512, ny=64, gy=-1e-5, bc_west="wall",
                                bc_east="wall"), [], (4, 1), 8, kstep=4)
        bars = dict(rtol=0, atol=2e-6)
    assert b.f.dtype == torch.bfloat16 and int(b.step) == int(a.step)
    _close(b.f, a.f, **bars)
    assert float(b.f.float().abs().max()) > 0.0


def test_mesh_bf16_coupled_matches_one_device():
    """tests/test_sharding.py's bf16 coupled scene on 4 x 1: 2 steps of
    K1 + K2 on bf16 frames with the edge fixups. Bars f rtol 1e-2 with
    atol 1e-6, x 1e-5, v 1e-6."""
    disks = [DiskSpec(64.0, 64.0, 3.0), DiskSpec(32.2, 96.1, 2.5),
             DiskSpec(90.0, 31.9, 2.0, vx=0.01)]
    a, b = _steps(_coupled_cfg(128, bc_west="wall", bc_east="wall"), disks,
                  (4, 1), 2)
    _close(b.f, a.f)
    _disks_close(a, b, 1e-5, 1e-6)


def test_mesh_bf16_window_matches_one_device():
    """tests/test_sharding.py's bf16 window scene (Zou/He, coupling_k =
    2, 2 x 1, run(8): four K6 windows): f 3e-4, x 1e-5, v 1e-5."""
    cfg = _coupled_cfg(128, n_sub=3, bc_west="inlet", bc_east="outlet",
                       u_inlet=0.05, inlet_profile="poiseuille",
                       coupling_k=2, out_interval=8)
    disks = [DiskSpec(64.0, 64.0, 3.0), DiskSpec(40.2, 40.1, 2.5, vx=0.01)]
    one = Simulation(cfg, disks, device="cpu")
    sh = Simulation(cfg, disks, mesh=_cpu_mesh((2, 1)))
    one.run(8)
    sh.run(8)
    a, b = one.state, sh.state
    assert int(b.step) == 8
    _close(b.f, a.f, rtol=0, atol=3e-4)
    _disks_close(a, b, 1e-5, 1e-5)


def test_mesh_bf16_static_matches_one_device():
    """tests/test_fixed.py's bf16 static-hoist scene (128^2, periodic x,
    two fixed disks) on 4 x 1: run(8), two K7(4) passes per shard over
    the 8-row solid windows, against one device's static hoist at 3e-4;
    disk x equal."""
    cfg = _bf16_cfg(nx=128, ny=128, max_disks=2, kn=2.0, gamma_n=1.0,
                    gamma_t=0.3, mu=0.4, rho_s=2.0, n_sub=10, gx=1e-5,
                    g_py=0.0, bc_west="periodic", bc_east="periodic",
                    out_interval=8)
    disks = [DiskSpec(40.0, 64.0, 4.0, fixed=True),
             DiskSpec(80.0, 64.0, 4.0, fixed=True)]
    one = Simulation(cfg, disks, device="cpu")
    sh = Simulation(cfg, disks, mesh=_cpu_mesh((4, 1)))
    assert sh.static_solid
    one.run(8)
    sh.run(8)
    _close(sh.state.f, one.state.f, rtol=0, atol=3e-4)
    assert torch.equal(sh.state.disks.x, one.state.disks.x)
    F, _ = sh.hydro_forces()
    assert F[0, 0] > 0.0


def test_mesh_bf16_fluid_matches_jax_mesh():
    """tests/test_sharding.py's bf16 fluid scene on 2 x 2: the port's mesh
    (4 steps) against the JAX sharded Pallas run (interpret mode, the
    8-device CPU mesh): rtol 1e-2, atol 1e-6."""
    jcfg = JCfg(dtype="float32", f_storage="bfloat16", **FLUID_WALLS)
    js = JSim(jcfg, use_pallas=True)
    jmesh = jmake_mesh(jax.devices()[:4], (2, 2))
    jstep = jax.jit(jsharded_step(js.cfg, js.grid, jmesh, use_pallas=True))
    jst = jshard_state(js.state, jmesh)
    sh = Simulation(to_torch_cfg(jcfg), mesh=_cpu_mesh((2, 2)))
    step = make_sharded_step(sh.cfg, None, sh.mesh, True)
    for _ in range(4):
        jst = jstep(jst)
        sh._advance(step)
    assert jst.f.dtype == jnp.bfloat16
    _close(sh.state.f, jst.f)


# --- refusals, paranoia, state, CLI ------------------------------------

def test_mesh_bf16_refusals():
    """bf16 on a mesh needs per-shard ny % 16 == 0 (the reason names 16)
    and the kernel path (the plain sharded step consumes raw f32: a
    ValueError, as in the JAX package); K5 on a frame deeper than one
    sweep runs (k = 8), and past the bf16 frame's 16 halo rows it is a
    ValueError."""
    from lbmdem_tpu_torch.simulation import kernels_supported

    cfg = _bf16_cfg(nx=256, ny=64)
    reason = kernels_supported(cfg, "cpu", _cpu_mesh((8, 1)))
    assert reason is not None and "16" in reason
    assert kernels_supported(cfg, "cpu", _cpu_mesh((4, 1))) is None
    with pytest.raises(ValueError, match="16"):
        Simulation(cfg, mesh=_cpu_mesh((8, 1)))
    with pytest.raises(ValueError, match="raw f32"):
        Simulation(cfg, mesh=_cpu_mesh((2, 2)), use_kernels=False)
    # one device keeps its looser rule
    assert kernels_supported(cfg.replace(ny=40), "cpu") is None
    f = torch.zeros(fused_fluid.frame_shape(cfg.replace(ny=32, nx=128), "y"),
                    dtype=torch.bfloat16)
    assert tuple(f.shape) == (9, 64, 128)
    out = torch.empty((9, 32, 128), dtype=torch.bfloat16)
    got = fused_fluid.fused_step_fluid_multi(f, cfg.replace(ny=32, nx=128),
                                             8, out, prehalo="y",
                                             edges=(1, 1, 1, 1))
    assert got is out and torch.isfinite(got.float()).all()
    with pytest.raises(ValueError, match="outside 1..16"):
        fused_fluid.fused_step_fluid_multi(f, cfg.replace(ny=32, nx=128), 17,
                                           out, prehalo="y",
                                           edges=(1, 1, 1, 1))


@pytest.mark.parametrize("paranoia,want", [("step", 5), ("chunk", 8)])
def test_mesh_bf16_paranoia_matches_one_device(paranoia, want):
    """A NaN injected into the bf16 f after step 4 of a channel with a
    fixed disk: the 2 x 2 mesh reports the one-device fail_step under
    "step" (the per-step sharded step, K2) and "chunk" (the static
    chunk's K7 passes) and freezes there."""
    cfg = _coupled_cfg(256, bc_west="wall", bc_east="wall", gx=1e-5,
                       paranoia=paranoia, out_interval=100)
    disks = [DiskSpec(40.0, 64.0, 3.0, fixed=True)]
    got = []
    for kw in (dict(device="cpu"), dict(mesh=_cpu_mesh((2, 2)))):
        sim = Simulation(cfg, disks, **kw)
        sim.run(4)
        st = sim.state
        assert st.f.dtype == torch.bfloat16 and int(st.fail_step) == -1
        st.f[0, 70, 150] = float("nan")  # shard (1, 1)
        sim.state = st
        with pytest.raises(SimulationDiverged) as e:
            sim.run(8)
        got.append((e.value.step, int(sim.state.step),
                    int(sim.state.fail_step)))
    assert got[0] == got[1] == (want, want, want), got


def test_mesh_bf16_state_roundtrip_and_checkpoint(tmp_path):
    """A bf16 mesh state goes through shard_state / unshard bit for bit,
    and a checkpoint of the gathered state restores a mesh run that
    continues as the run that was not interrupted."""
    from lbmdem_tpu_torch.utils import checkpoint as ckpt

    cfg = _coupled_cfg(128, bc_west="wall", bc_east="wall", out_interval=3)
    disks = [DiskSpec(64.0, 64.0, 3.0), DiskSpec(40.2, 90.1, 2.5)]
    mesh = _cpu_mesh((2, 1))
    sim = Simulation(cfg, disks, mesh=mesh)
    sim.run(3)
    st = sim.state
    assert st.f.dtype == torch.bfloat16
    back = unshard(shard_state(st, mesh), mesh)
    assert torch.equal(back.f, st.f) and torch.equal(back.disks.x,
                                                     st.disks.x)
    path = str(tmp_path / "restart.npz")
    ckpt.save_state(path, st, cfg)
    other = Simulation(cfg, disks, mesh=mesh)
    other.state = ckpt.load_state(path, other.state)
    assert torch.equal(other.state.f, st.f)
    sim.run(3)
    other.run(3)
    assert torch.equal(other.state.f, sim.state.f)
    assert torch.equal(other.state.disks.x, sim.state.disks.x)


def test_cli_mesh_bf16_deck(tmp_path, capsys):
    """--mesh 2x2 --kernels --device cpu on a bf16 deck with disks runs 8
    steps on four bf16 shards, writes its files, and its state equals
    Simulation.run on the same mesh; without --kernels the CPU's auto
    path is the plain sharded step, which refuses bf16."""
    deck = tmp_path / "run.par"
    deck.write_text("nx 256\nny 64\ntau 0.8\nsteps 8\nout_interval 8\n"
                    "f_storage bfloat16\nbc west wall\nbc east wall\n"
                    "bc south wall\nbc north wall\ng_py -1e-5\nkn 1.0\n"
                    "gamma_n 1.0\nrho_s 2.0\nn_sub 5\nbuoyancy 1\n"
                    "particles disks.txt\n")
    (tmp_path / "disks.txt").write_text("128 32 4.0\n60 20 3.0\n")
    out = tmp_path / "out"
    assert cli.main([str(deck), "--mesh", "2x2", "--device", "cpu",
                     "--kernels", "--checkpoint-every", "8",
                     "--out", str(out)]) == 0
    assert "2x2 shards on 1 device(s), kernels" in capsys.readouterr().err
    assert (out / "fluid_00000008.vtk").exists()
    from lbmdem_tpu_torch.config import load_param_file, load_particle_file
    from lbmdem_tpu_torch.utils import checkpoint as ckpt

    cfg, pf = load_param_file(str(deck))
    sim = Simulation(cfg, load_particle_file(pf), mesh=_cpu_mesh((2, 2)))
    sim.run(8)
    st = ckpt.load_state(str(out / "restart.npz"), sim.state)
    assert st.f.dtype == torch.bfloat16
    assert torch.equal(st.f, sim.state.f)
    assert torch.equal(st.disks.x, sim.state.disks.x)
    with pytest.raises(ValueError, match="raw f32"):
        cli.main([str(deck), "--mesh", "2x2", "--device", "cpu", "--out",
                  str(tmp_path / "x")])
