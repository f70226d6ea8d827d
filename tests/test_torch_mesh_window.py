"""The lattice mesh's windowed and static paths on the CPU, their shards
on `["cpu"] * n`: K6, K7 and K8 in their pre-haloed modes against the JAX
package, the mesh window chunk, the mesh static chunk and paranoid mode
on a mesh against the port's one-device runs.

- K6, K7 and K8 pre-haloed (their plain versions) against the JAX Pallas
  entries in interpret mode at the smallest legal shard (64 x 128), on
  the same seeded numpy inputs: modes "y" and "yx", the edge flags of
  corner, edge and interior shards, K6 and K7 at k = 2 and 4, a Zou/He
  case. Bars: K6 those of tests/test_torch_mesh.py's K2 (f' 5e-6,
  partials 1e-6 of the largest); K7 tests/test_torch_static.py's (rtol
  1e-5 with atol 2e-6); K8 tests/test_torch_split.py's (f' rtol 1e-6 with
  atol 1e-7, phi rtol 1e-5 with atol 5e-8).
- Simulation(mesh=...) with coupling_k > 1 (the cadence chunk's windows:
  K1 and K6 pre-haloed per shard, the window DEM per replica) against
  the port's one-device window chunk, which tests/test_torch_window.py
  holds against JAX: tests/test_sharding.py's window scene (256 x 128,
  two disks on the seams, coupling_k = 4, 8 steps) on (2, 1) and (2, 2),
  and its Zou/He scene in f32 with coupling_k = 2. Bars: the JAX sharded
  window test's (f 2e-6, x 1e-6, v 1e-7).
- The static hoist on a mesh (K7 pre-haloed over solid windows stamped
  once) against one device: tests/test_fixed.py's mesh scene (128 x 128,
  periodic x, two fixed disks, (4, 1), run(5)) and a walled (2, 2)
  channel. Bars: f 2e-6 (the JAX bar), disk x equal.
- Paranoid mode on a mesh: a NaN injected after step 4 reports the
  one-device fail_step under "step" (the per-step sharded step) and
  "chunk" (the static chunk's K7 passes, the cadence chunk's blocks),
  with the state frozen there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.ops import pallas_lbm as pk, pallas_stamp as ps
from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation, cli
from lbmdem_tpu_torch.ops import fused_fluid, fused_lbm, fused_static, stamp
from lbmdem_tpu_torch.parallel import make_mesh
from lbmdem_tpu_torch.parallel._kernel_step import canvas_pads
from lbmdem_tpu_torch.simulation import SimulationDiverged

from torch_parity_util import (npy, perturbed_f, random_disks,
                               to_torch_cfg, tt)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(ps, "_INTERPRET", True)


def _cpu_mesh(dims):
    return make_mesh(["cpu"] * (dims[0] * dims[1]), dims)


# --- K6, K7 and K8 pre-haloed against the JAX Pallas entries ------------

H, W = 64, 128  # the smallest legal shard
WALLS = dict(bc_west="wall", bc_east="wall", uw_north=0.04, gy=-1e-5)
ZOU_HE = dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
              inlet_profile="poiseuille")


def _shard_inputs(mode, seed, n=14, **kw):
    """A shard's inputs as the sharded step makes them: disks binned and
    stamped on the shard's canvas (canvas coordinates, some in the
    apron), the interior tiles' binning and the solid window (its Zou/He
    columns zeroed as the mesh zeroes them on the edge shards), and a
    perturbed f frame."""
    pady, padx = canvas_pads(H, mode == "yx")
    cfg = JCfg(nx=W, ny=H, tau=0.8, dtype="float32", max_disks=n, window=9,
               tile_cap=32, **kw)
    canvas = to_torch_cfg(cfg.replace(ny=H + 2 * pady, nx=W + 2 * padx))
    x, v, om, r, act = random_disks(n, canvas.nx, canvas.ny, seed,
                                    r_lo=1.5, r_hi=3.5)
    x[0] = (padx + 0.3, pady + 0.4)  # on the interior's corner
    x = [tt(a.astype(np.float32)) for a in (x, v, om, r)] + [tt(act)]
    lists, counts, _, ovf = stamp.build_tile_lists(x[0], x[4], canvas)
    assert int(ovf) == 0
    td = stamp.gather_tile_data(lists, *x)
    solid = stamp.stamp_fields(td, counts, canvas)
    if cfg.bc_west == "inlet":
        solid[:, :, padx].zero_()
        solid[:, :, padx + W - 1].zero_()
    th, tw = stamp.tile_dims(canvas)
    nty, ntx = canvas.ny // th, canvas.nx // tw
    oy, ox, ny_i, nx_i = pady // th, padx // tw, H // th, W // tw
    td_i = td.reshape(nty, ntx, -1)[oy:oy + ny_i, ox:ox + nx_i].reshape(
        ny_i * nx_i, 1, -1).contiguous()
    cnt_i = counts.reshape(nty, ntx)[oy:oy + ny_i, ox:ox + nx_i].reshape(
        -1, 1, 1).contiguous()
    s_k = solid[:, pady - 8:pady + H + 8, :].contiguous()
    f = perturbed_f(fused_fluid.frame_shape(to_torch_cfg(cfg), mode),
                    seed + 1, np.float32, amp=0.05)
    return cfg, (pady, padx), td_i, cnt_i, s_k, f


def _jmode(mode):
    return True if mode == "y" else "yx"


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


def _opts(opt):
    return ZOU_HE if opt == "zou-he" else WALLS


@pytest.mark.parametrize("mode,opt,edges,k", TBLOCK_CASES, ids=TBLOCK_IDS)
def test_k6_prehalo_matches_pallas(mode, opt, edges, k):
    """K6 on a pre-haloed frame and solid window: k inner steps with the
    walls and Zou/He closures of the shard's global edges, the reduce of
    every inner step at the interior's origin. Bars f' 5e-6, partials
    1e-6 of the largest."""
    cfg, origin, td, cnt, s_k, f = _shard_inputs(mode, 3 + k, **_opts(opt))
    want_f, want_p = pk.fused_step_imb_reduce_multi(
        jnp.asarray(f), jnp.asarray(npy(s_k)), cfg, k, jnp.asarray(npy(td)),
        jnp.asarray(npy(cnt)), prehalo=_jmode(mode), origin=origin,
        edges=jnp.asarray(edges, jnp.int32), ny_glob=4 * H)
    out = torch.empty((9, H, W))
    got_f, got_p = fused_lbm.fused_step_imb_reduce_multi(
        tt(f), s_k, td, cnt, to_torch_cfg(cfg), k, out, prehalo=mode,
        origin=origin, edges=edges, ny_glob=4 * H)
    assert got_f is out and tuple(got_p.shape) == tuple(want_p.shape)
    np.testing.assert_allclose(npy(got_f), np.asarray(want_f), rtol=0,
                               atol=5e-6)
    want_p = np.asarray(want_p)
    scale = float(np.abs(want_p).max())
    assert scale > 1e-6  # the disks feel a force
    np.testing.assert_allclose(npy(got_p), want_p, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("mode,opt,edges,k", TBLOCK_CASES, ids=TBLOCK_IDS)
def test_k7_prehalo_matches_pallas(mode, opt, edges, k):
    """K7 on a pre-haloed frame and solid window, the walls and Zou/He
    closures of the shard's global edges at every inner step. Bar rtol
    1e-5 with atol 2e-6."""
    cfg, _, _, _, s_k, f = _shard_inputs(mode, 13 + k, **_opts(opt))
    want = pk.fused_step_imb_static_multi(
        jnp.asarray(f), jnp.asarray(npy(s_k)), cfg, k, prehalo=_jmode(mode),
        edges=jnp.asarray(edges, jnp.int32), ny_glob=4 * H)
    out = torch.empty((9, H, W))
    got = fused_static.fused_step_imb_static_multi(
        tt(f), s_k, to_torch_cfg(cfg), k, out, prehalo=mode, edges=edges,
        ny_glob=4 * H)
    assert got is out
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_k8_prehalo_matches_pallas(mode):
    """K8 on a pre-haloed frame and solid fields: f' (the y walls, or
    every wall, left to the caller) and the interior's raw phi. Bars f'
    rtol 1e-6 with atol 1e-7, phi rtol 1e-5 with atol 5e-8. Its f' and
    edge populations equal K2's pre-haloed plain version exactly, as the
    kernels' are bitwise."""
    cfg, origin, td, cnt, s_k, f = _shard_inputs(mode, 21, **WALLS)
    s = npy(s_k)
    want_f, want_x, want_y = pk.fused_step_imb(
        *(jnp.asarray(a) for a in (f, s[0], s[1], s[2])), cfg,
        prehalo=_jmode(mode))
    tcfg = to_torch_cfg(cfg)
    edge = (torch.empty((9, 2, W)), torch.empty((9, H, 2)))
    out = torch.empty((9, H, W))
    got_f, got_x, got_y = fused_lbm.fused_step_imb(
        tt(f), s_k[0], s_k[1], s_k[2], tcfg, out, prehalo=mode,
        edge_post=edge)
    np.testing.assert_allclose(npy(got_f), np.asarray(want_f), rtol=1e-6,
                               atol=1e-7)
    for a, b in ((got_x, want_x), (got_y, want_y)):
        assert tuple(a.shape) == (H, W)
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-5,
                                   atol=5e-8)
    assert float(got_x.abs().max()) > 0.0
    edge2 = (torch.empty((9, 2, W)), torch.empty((9, H, 2)))
    f2, _ = fused_lbm.fused_step_imb_reduce(
        tt(f), s_k, td, cnt, tcfg, torch.empty((9, H, W)), prehalo=mode,
        origin=origin, edge_post=edge2)
    assert torch.equal(f2, got_f)
    assert all(torch.equal(a, b) for a, b in zip(edge, edge2))


def test_prehalo_arguments_are_checked():
    """The pre-haloed K6/K7 need edges (a "y" shard holds both x edges),
    the global height ny_glob and frames of the frame's shape (a bf16
    frame has 16 halo rows, its solid window 8); origin and edges without
    a frame raise."""
    tcfg = SimConfig(nx=W, ny=H, tau=0.8)
    f = torch.zeros(fused_fluid.frame_shape(tcfg, "y"))
    s = torch.zeros((3,) + tuple(f.shape[1:]))
    out = torch.empty((9, H, W))
    td, cnt = torch.zeros((4, 1, 8)), torch.zeros((4, 1, 1),
                                                  dtype=torch.int32)
    assert fused_static.check_static_cfg(tcfg, "yx", (0, 0, 0, 0, 0)) == "yx"
    with pytest.raises(ValueError, match="both x edges"):
        fused_static.fused_step_imb_static_multi(f, s, tcfg, 2, out,
                                                 prehalo="y",
                                                 edges=(1, 1, 0, 1))
    with pytest.raises(ValueError, match="needs edges"):
        fused_lbm.fused_step_imb_reduce_multi(f, s, td, cnt, tcfg, 2, out,
                                              prehalo="y")
    for call in (
            lambda: fused_lbm.fused_step_imb_reduce_multi(
                f, s, td, cnt, tcfg, 2, out, prehalo="y", edges=(1,) * 4),
            lambda: fused_static.fused_step_imb_static_multi(
                f, s, tcfg, 2, out, prehalo="y", edges=(1,) * 4)):
        with pytest.raises(ValueError, match="needs ny_glob"):
            call()
    with pytest.raises(ValueError, match="pre-haloed f"):
        fused_lbm.fused_step_imb_reduce_multi(f, s, td, cnt, tcfg, 2, out,
                                              prehalo="yx",
                                              edges=(1, 1, 1, 1), ny_glob=H)
    with pytest.raises(ValueError, match="mesh position"):
        fused_static.fused_step_imb_static_multi(
            out, s[:, 8:-8], tcfg, 2, torch.empty_like(out),
            edges=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="origin"):
        fused_lbm.fused_step_imb_reduce_multi(
            out, s[:, 8:-8], td, cnt, tcfg, 2, torch.empty_like(out),
            origin=(8, 0))
    bf = tcfg.replace(f_storage="bfloat16")
    assert fused_static.check_static_cfg(bf, "y", (1, 1, 1, 1)) == "y"
    assert fused_fluid.frame_shape(bf, "y") == (9, H + 32, W)
    fb = f.to(torch.bfloat16)  # an f32 frame's 8 halo rows
    for call in (
            lambda: fused_static.fused_step_imb_static_multi(
                fb, s, bf, 2, out.to(torch.bfloat16), prehalo="y",
                edges=(1,) * 4, ny_glob=H),
            lambda: fused_lbm.fused_step_imb_reduce_multi(
                fb, s, td, cnt, bf, 2, out.to(torch.bfloat16), prehalo="y",
                edges=(1,) * 4, ny_glob=H)):
        with pytest.raises(ValueError, match="pre-haloed f|f \\("):
            call()


# --- the mesh chunks against one device ---------------------------------

def _coupled_cfg(nx, ny=128, **kw):
    return SimConfig(**{"nx": nx, "ny": ny, "tau": 0.8, "dtype": "float32",
                        "g_py": -1e-4, "buoyancy": True, "rho_s": 2.0,
                        "kn": 0.5, "gamma_n": 0.5, "n_sub": 5, **kw})


def _runs(cfg, disks, dims, n):
    one = Simulation(cfg, disks, device="cpu")
    sh = Simulation(cfg, disks, mesh=_cpu_mesh(dims))
    one.run(n)
    sh.run(n)
    return one, sh


def _assert_close(a, b, f_tol, x_tol, v_tol):
    np.testing.assert_allclose(npy(b.f), npy(a.f), rtol=0, atol=f_tol)
    assert int(a.step) == int(b.step)
    np.testing.assert_allclose(npy(b.disks.x), npy(a.disks.x), rtol=0,
                               atol=x_tol)
    np.testing.assert_allclose(npy(b.disks.v), npy(a.disks.v), rtol=0,
                               atol=v_tol)
    assert int(b.overflow) == 0


def _count_calls(monkeypatch, name):
    from lbmdem_tpu_torch.parallel import _kernel_step

    calls = []
    orig = getattr(_kernel_step._Sharded, name)

    def counted(self, *a, **kw):
        calls.append(a[-1])
        return orig(self, *a, **kw)

    monkeypatch.setattr(_kernel_step._Sharded, name, counted)
    return calls


WINDOW_CASES = {
    "walls-k4": (_coupled_cfg(256, bc_west="wall", bc_east="wall",
                              coupling_k=4, out_interval=8),
                 [DiskSpec(64.0, 64.0, 3.0),  # on the y seam
                  DiskSpec(130.2, 40.1, 2.5, vx=0.01)]),  # near the x seam
    "zou-he-k2": (_coupled_cfg(128, n_sub=3, bc_west="inlet",
                               bc_east="outlet", u_inlet=0.05,
                               inlet_profile="poiseuille", coupling_k=2,
                               out_interval=8),
                  [DiskSpec(64.0, 64.0, 3.0),
                   DiskSpec(40.2, 40.1, 2.5, vx=0.01)]),
}


@pytest.mark.parametrize("case,dims", [("walls-k4", (2, 1)),
                                       ("walls-k4", (2, 2)),
                                       ("zou-he-k2", (2, 1))])
def test_mesh_window_chunk_matches_one_device(monkeypatch, case, dims):
    """8 steps, one cadence block of coupling_k windows (K1 and K6
    pre-haloed per shard, the window DEM per replica), against the
    one-device window chunk. Bars f 2e-6, x 1e-6, v 1e-7."""
    cfg, disks = WINDOW_CASES[case]
    calls = _count_calls(monkeypatch, "window_step")
    one, sh = _runs(cfg, disks, dims, 8)
    assert calls == [cfg.coupling_k] * (8 // cfg.coupling_k)
    _assert_close(one.state, sh.state, 2e-6, 1e-6, 1e-7)
    # the window moved the disks as the windows do, not as single steps
    single = Simulation(cfg.replace(coupling_k=1), disks, device="cpu")
    single.run(8)
    assert float((single.state.f - sh.state.f).abs().max()) > 1e-5


def test_mesh_coupling_k_1_takes_single_steps(monkeypatch):
    """coupling_k = 1 takes no window: a cadence block of 8 is 8 single
    steps (K2 pre-haloed), as on one device."""
    cfg, disks = WINDOW_CASES["walls-k4"]
    wins = _count_calls(monkeypatch, "window_step")
    singles = _count_calls(monkeypatch, "coupled_step")
    Simulation(cfg.replace(coupling_k=1), disks,
               mesh=_cpu_mesh((2, 1))).run(8)
    assert wins == [] and len(singles) == 8


def test_mesh_window_with_singles_and_cell_list(monkeypatch):
    """A run(11) with coupling_k = 4: a block of two windows, then a
    block of 3 single steps (K2 pre-haloed with the edge fixups), on the
    cell-list DEM (the grid past the slab gate, the JAX mesh path's
    fallback), against one device at the chunk bars (f 5e-6, x 1e-5, v
    1e-6)."""
    from lbmdem_tpu_torch.ops import slab_dem

    monkeypatch.setattr(slab_dem, "slab_supported", lambda *a, **k: False)
    cfg, disks = WINDOW_CASES["walls-k4"]
    wins = _count_calls(monkeypatch, "window_step")
    singles = _count_calls(monkeypatch, "coupled_step")
    one, sh = _runs(cfg.replace(out_interval=11), disks, (2, 2), 11)
    assert len(wins) == 2 and len(singles) == 3
    _assert_close(one.state, sh.state, 5e-6, 1e-5, 1e-6)


def _fixed_cfg(nx=128, ny=128, **kw):
    return SimConfig(**{"nx": nx, "ny": ny, "tau": 0.8, "dtype": "float32",
                        "max_disks": 2, "kn": 2.0, "gamma_n": 1.0,
                        "gamma_t": 0.3, "mu": 0.4, "rho_s": 2.0,
                        "n_sub": 10, "gx": 1e-5, "g_py": 0.0,
                        "out_interval": 5, **kw})


STATIC_CASES = {
    "periodic-x": ((4, 1), _fixed_cfg(bc_west="periodic",
                                      bc_east="periodic"),
                   [DiskSpec(40.0, 64.0, 4.0, fixed=True),  # on a seam
                    DiskSpec(80.0, 96.0, 4.0, fixed=True)]),
    "walled": ((2, 2), _fixed_cfg(nx=256, bc_west="wall", bc_east="wall",
                                  uw_north=0.02),
               [DiskSpec(128.0, 64.0, 5.0, fixed=True),  # the mesh's centre
                DiskSpec(60.0, 30.0, 4.0, fixed=True)]),
}


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_mesh_static_chunk_matches_one_device(monkeypatch, case):
    """run(5), one K7(4) pass and one K7(1) pass per shard over solid
    windows stamped once, against the one-device static hoist: f 2e-6,
    disk x equal; hydro_forces on the gathered state agrees."""
    dims, cfg, disks = STATIC_CASES[case]
    passes = _count_calls(monkeypatch, "static_step")
    one, sh = _runs(cfg, disks, dims, 5)
    assert sh.static_solid and passes == [4, 1]
    np.testing.assert_allclose(npy(sh.state.f), npy(one.state.f), rtol=0,
                               atol=2e-6)
    assert torch.equal(sh.state.disks.x, one.state.disks.x)
    assert int(sh.state.step) == 5 and int(sh.state.overflow) == 0
    F1, _ = one.hydro_forces()
    Fm, _ = sh.hydro_forces()
    np.testing.assert_allclose(Fm, F1, rtol=0, atol=1e-6)
    assert float(np.abs(Fm).max()) > 0.0
    sh.run(3)  # the cached windows serve a second chunk
    assert passes == [4, 1, 1, 1, 1]


PARANOIA_CASES = [
    # (paranoia, disks, fail step): the per-step sharded step, the static
    # hoist's K7 passes of 4, the cadence chunk's block of 8 steps (two
    # windows) after run(4)
    ("step", [DiskSpec(40.0, 64.0, 3.0, fixed=True)], 5),
    ("chunk", [DiskSpec(40.0, 64.0, 3.0, fixed=True)], 8),
    ("chunk", [DiskSpec(40.0, 64.0, 3.0), DiskSpec(200.0, 60.0, 3.0)], 12),
]


@pytest.mark.parametrize("paranoia,disks,want", PARANOIA_CASES,
                         ids=["step-fixed", "chunk-static", "chunk-window"])
def test_mesh_paranoia_matches_one_device(paranoia, disks, want):
    """A NaN injected into f after step 4 of a 128 x 256 channel: the 2 x 2
    mesh reports the one-device fail_step and freezes there."""
    cfg = _coupled_cfg(256, bc_west="wall", bc_east="wall", gx=1e-5,
                       paranoia=paranoia, out_interval=100,
                       coupling_k=1 if paranoia == "step" else 4)
    got = []
    for kw in (dict(device="cpu"), dict(mesh=_cpu_mesh((2, 2)))):
        sim = Simulation(cfg, disks, **kw)
        sim.run(4)
        assert int(sim.state.fail_step) == -1
        st = sim.state
        st.f[0, 70, 150] = float("nan")  # shard (1, 1)
        sim.state = st
        with pytest.raises(SimulationDiverged) as e:
            sim.run(8)
        got.append((e.value.step, int(sim.state.step),
                    int(sim.state.fail_step)))
    assert got[0] == got[1] == (want, want, want), got


def test_cli_mesh_takes_the_porous_bed(tmp_path, capsys):
    """examples/porous_bed.par (256^2, fully periodic, fixed cylinders: the
    static hoist) runs on --mesh 2x2 --device cpu, 8 steps, and writes
    its files."""
    import os

    deck = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "porous_bed.par")
    out = tmp_path / "out"
    assert cli.main([deck, "--mesh", "2x2", "--device", "cpu", "--kernels",
                     "--steps", "8", "--out", str(out)]) == 0
    assert "2x2 shards on 1 device(s), kernels" in capsys.readouterr().err
    assert (out / "fluid_00000008.vtk").exists()
