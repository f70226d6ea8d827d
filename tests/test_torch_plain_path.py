"""The port's plain path (Simulation(..., use_kernels=False)) against the
JAX package's plain path (Simulation(..., use_pallas=False)), and the
port's kernel limits (kernels_supported) against pallas_supported.

Both plain paths take the same arithmetic in other summation orders:
float64 runs agree to ~1e-15 per step, held at 1e-9 (the bar of the
other float64 parity tests) over 20 steps."""

import os

import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk
from lbmdem_tpu.config import SimConfig as JCfg
from lbmdem_tpu.config import load_param_file as jload
from lbmdem_tpu.config import load_particle_file as jload_disks
from lbmdem_tpu.config import window_for_radius
from lbmdem_tpu.models import column_collapse
from lbmdem_tpu.simulation import Simulation as JSim
from lbmdem_tpu.simulation import pallas_supported
from lbmdem_tpu_torch import Simulation
from lbmdem_tpu_torch.ops import stamp
from lbmdem_tpu_torch.simulation import (BIN_MARGIN, derive_config,
                                         kernels_supported, make_step_fn)

from torch_parity_util import npy, to_torch_cfg, to_torch_disks

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
TOL = 1e-9


def _walls(**kw):
    base = dict(nx=64, ny=96, tau=0.8, dtype="float64", g_py=-1e-4,
                rho_s=2.0, kn=0.5, gamma_n=0.5, n_sub=5, bc_west="wall",
                bc_east="wall")
    base.update(kw)
    return JCfg(**base)


def _scenes():
    """(name, JAX cfg, JAX disks, steps) of the plain path's scenes."""
    pack = [JDisk(10.0 + 6.1 * i, 4.0 + 6.1 * j, 3.0) for i in range(5)
            for j in range(3)]
    pcfg = _walls(bc_west="periodic", bc_east="periodic", g_px=2e-5)
    seam = [JDisk(0.8, 48.0, 4.0, vx=-0.01), JDisk(32.0, 60.0, 3.0)]
    zcfg = _walls(nx=128, ny=48, g_py=0.0, bc_west="inlet",
                  bc_east="outlet", bc_south="wall", bc_north="wall",
                  u_inlet=0.02)
    zou = [JDisk(30.0, 24.0, 4.0, fixed=True), JDisk(60.0, 20.0, 3.0)]
    cfg, pf = jload(os.path.join(EXAMPLES, "schafer_turek.par"))
    return [
        ("coupled walls", _walls(g_py=-1e-3), pack, 20),
        ("periodic seam", pcfg, seam, 20),
        ("Zou/He channel", zcfg, zou, 20),
        ("max_disks no disks", _walls(max_disks=6), [], 20),
        ("pure fluid", JCfg(nx=48, ny=32, tau=0.7, gx=1e-5, dtype="float64",
                            bc_west="periodic", bc_east="periodic"), [], 20),
        ("schafer_turek", cfg.replace(dtype="float64"),
         jload_disks(pf, units=cfg.units), 4),
    ]


def _assert_close(jst, tst, tol=TOL):
    np.testing.assert_allclose(np.asarray(jst.f), npy(tst.f), rtol=0,
                               atol=tol)
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jst.disks, k)),
                                   npy(getattr(tst.disks, k)), rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_array_equal(np.asarray(jst.disks.active),
                                  npy(tst.disks.active))
    for k in ("step", "overflow", "n_contacts", "fail_step"):
        assert int(getattr(jst, k)) == int(getattr(tst, k)), k


@pytest.mark.parametrize("name,cfg,disks,steps", _scenes(),
                         ids=[s[0] for s in _scenes()])
def test_plain_path_matches_jax(name, cfg, disks, steps):
    """Walls with contacts, a disk on a periodic seam, a Zou/He channel
    (fixed obstacle + mobile disk), a coupled scene without disks
    (max_disks > 0), pure fluid and the Schafer-Turek deck's 440 x 82
    lattice (its stamp tiles are 2 rows high): the port's plain path
    against the JAX plain path in float64."""
    js = JSim(cfg, disks)
    js.run(steps)
    sim = Simulation(to_torch_cfg(cfg), to_torch_disks(disks), device="cpu",
                     use_kernels=False)
    assert sim.cfg.window == js.cfg.window
    assert sim.cfg.max_disks == js.cfg.max_disks
    sim.run(steps)
    _assert_close(js.state, sim.state)
    assert bool(torch.isfinite(sim.state.f).all())


def test_kernel_path_matches_plain_path():
    """The kernel path (K1/K2/K3 plain versions on CPU tensors, Verlet
    cadence) against the plain path on one float64 scene with contacts."""
    cfg, disks = column_collapse(nx=128, ny=128, n_disks=30, r=3.0)
    rng = np.random.default_rng(9)
    disks = [JDisk(10.0 + 5.9 * i + rng.uniform(-0.05, 0.05),
                   2.6 + 5.9 * j + rng.uniform(-0.05, 0.05), 3.0)
             for i in range(6) for j in range(5)]
    cfg = to_torch_cfg(cfg.replace(dtype="float64", g_py=-1e-3))
    disks = to_torch_disks(disks)
    k = Simulation(cfg, disks, device="cpu")
    p = Simulation(cfg, disks, device="cpu", use_kernels=False)
    k.run(16)
    p.run(16)
    assert int(k.state.n_contacts) == int(p.state.n_contacts) > 0
    _assert_close(p.state, k.state)


def _verdict_cases():
    """(name, cfg, disks) whose verdicts the two packages share."""
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=40, r=4.0)
    big = [JDisk(64.0, 8.0, 6.0)]
    return [
        ("coupled f32", cfg, disks),
        ("coupled float64", cfg.replace(dtype="float64"), disks),
        ("coupled bf16", cfg.replace(f_storage="bfloat16"), disks),
        ("pure fluid f32", JCfg(nx=256, ny=64, tau=0.8), []),
        ("pure fluid float64", JCfg(nx=256, ny=64, tau=0.8,
                                    dtype="float64"), []),
        # window 17 > 16-row tile: too large even without the margin
        ("window over the tile", JCfg(nx=128, ny=16, tau=0.8), big),
        # window 13 fits the 16-row tile, window + 4 does not
        ("Verlet margin gap", JCfg(nx=128, ny=16, tau=0.8),
         [JDisk(64.0, 8.0, 4.0)]),
    ]


def _differing_cases():
    """(name, cfg, disks, why) where only the TPU's alignment rejects."""
    return [
        ("pure fluid 100x50", JCfg(nx=100, ny=50, tau=0.8), [],
         "ny % 8, nx % 128 (the TPU's 8 x 128 vector tiles)"),
        ("coupled 96x96", JCfg(nx=96, ny=96, tau=0.8),
         [JDisk(40.0, 40.0, 3.0)], "nx % 128"),
        ("bf16 ny = 24", JCfg(nx=128, ny=24, tau=0.8,
                              f_storage="bfloat16"), [],
         "bf16 ny % 16 (16-row bf16 DMA granule)"),
    ]


def _jax_derived(cfg, disks):
    """The config pallas_supported reads: the JAX Simulation's window,
    capacity and tile_cap derivation (without building its kernels)."""
    if disks:
        cfg = cfg.replace(window=window_for_radius(max(d.r for d in disks)),
                          max_disks=max(cfg.max_disks, len(disks)))
    return cfg


@pytest.mark.parametrize("name,cfg,disks", _verdict_cases(),
                         ids=[c[0] for c in _verdict_cases()])
def test_kernels_supported_agrees_with_pallas_supported(name, cfg, disks):
    """Where the TPU-only alignment is not the reason, the port's
    kernels_supported (on the card) gives pallas_supported's verdict."""
    jr = pallas_supported(_jax_derived(cfg, disks))
    tcfg, _ = derive_config(to_torch_cfg(cfg), to_torch_disks(disks))
    tr = kernels_supported(tcfg, "cuda")
    assert (jr is None) == (tr is None), (jr, tr)


@pytest.mark.parametrize("name,cfg,disks,why", _differing_cases(),
                         ids=[c[0] for c in _differing_cases()])
def test_kernels_supported_differs_only_by_alignment(name, cfg, disks, why):
    """The cases where the verdicts differ: pallas_supported rejects for
    the TPU's alignment (`why`), the port's kernels take the lattice."""
    jr = pallas_supported(_jax_derived(cfg, disks))
    assert jr is not None and ("nx%128" in jr or "%16" in jr), jr
    tcfg, _ = derive_config(to_torch_cfg(cfg), to_torch_disks(disks))
    assert kernels_supported(tcfg, "cuda") is None


def test_kernels_supported_names_its_reasons():
    """float64 is refused on the card only (the kernels' plain versions
    take it on the CPU); a coupled scene without disks has no tile
    capacity to size; JAX's check passes that scene, whose kernel path
    then fails on tile_cap = 0."""
    cfg = to_torch_cfg(_walls())
    tcfg, _ = derive_config(cfg, to_torch_disks([JDisk(20.0, 40.0, 3.0)]))
    assert "float64" in kernels_supported(tcfg, "cuda")
    assert kernels_supported(tcfg, "cpu") is None
    empty, grid = derive_config(cfg.replace(max_disks=4), [])
    assert grid is not None and empty.window == window_for_radius(1.0)
    assert "without disks" in kernels_supported(empty, "cpu")
    jcfg = _walls(nx=128, max_disks=4, dtype="float32")
    assert pallas_supported(jcfg.replace(
        window=window_for_radius(1.0))) is None
    with pytest.raises(ValueError, match="without disks"):
        Simulation(cfg.replace(max_disks=4), [], device="cpu")


def test_verlet_margin_gap():
    """A scene whose stamp window fits the tile but not with the Verlet
    cadence's 2 * BIN_MARGIN cells (48 x 48, 16 x 16 tiles, r = 4,
    window 13). Before kernels_supported named this gap the kernel path
    was built and its first cadence rebuild raised mid-run; now
    use_kernels=True raises at construction, and the kernel path's
    fresh-binning step (margin 0) still agrees with the plain path."""
    jcfg = _walls(nx=48, ny=48, g_py=-1e-3)
    jd = [JDisk(12.0, 20.0, 4.0), JDisk(24.0, 12.0, 4.0),
          JDisk(36.0, 30.0, 4.0)]
    cfg, disks = to_torch_cfg(jcfg), to_torch_disks(jd)
    tcfg, _ = derive_config(cfg, disks)
    th, tw = stamp.tile_shape(tcfg)
    assert tcfg.window <= min(th, tw) < tcfg.window + 2 * BIN_MARGIN
    assert "Verlet margin" in kernels_supported(tcfg, "cpu")
    with pytest.raises(ValueError, match="Verlet margin"):
        Simulation(cfg, disks, device="cpu")
    with pytest.raises(ValueError, match="exceeds tile"):
        stamp.build_tile_lists(torch.zeros(1, 2, dtype=torch.float64),
                               torch.ones(1, dtype=torch.bool), tcfg,
                               margin=BIN_MARGIN)
    plain = Simulation(cfg, disks, device="cpu", use_kernels=False)
    kstep = make_step_fn(tcfg, plain.grid, dem_axis=plain.dem_axis)
    st = plain.state
    for _ in range(6):
        st = kstep(st, torch.empty_like(st.f))
    plain.run(6)
    _assert_close(plain.state, st)


def test_plain_path_refuses_coupling_k():
    cfg, disks = column_collapse(nx=128, ny=128, n_disks=10, r=3.0)
    with pytest.raises(ValueError, match="use_kernels=True"):
        Simulation(to_torch_cfg(cfg.replace(coupling_k=4)),
                   to_torch_disks(disks), device="cpu", use_kernels=False)
