"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU with nvcc and skips without
one. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bars (the JAX package's own): K1 fields 1e-6; K2 f' 5e-6 and per-disk
forces 1e-6 relative to the largest |F|; K3 x/v/omega 2e-5 with equal
contact counts; a whole run 1e-5 on f and 1e-4 on disk positions; K4
rtol 1e-6 / atol 1e-7, K5 rtol 1e-5 / atol 5e-7 (2e-6 with Zou/He),
bf16 storage atol 3e-4; K6 as K2 (f' 5e-6, forces 1e-6 relative, each
inner step); K3w as K3; K7 rtol 1e-5 / atol 2e-6 (bf16 3e-4) against its
plain version on CPU copies; all-fixed runs 1e-5 on f, hydro forces 1e-4
relative to the largest |F|; K8 f' rtol 1e-6 / atol 1e-7 and phi rtol
1e-5 / atol 5e-8 against its plain version on CPU copies, K8 + K9
against K2 f' equal and forces 1e-6, K9 1e-6 against its plain version
(relative to the largest |F| or |T| where that exceeds 1),
K1 under ramp and exact 1e-6; the cell-list DEM 1e-4 against the CPU
with equal contacts."""

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import Simulation, lattice
from lbmdem_tpu_torch.config import DiskSpec, SimConfig
from lbmdem_tpu_torch.models import column_collapse
from lbmdem_tpu_torch.models import porous_bed
from lbmdem_tpu_torch.ops import (dem, fused_fluid, fused_lbm, fused_static,
                                  imb, lbm, slab_dem, stamp)

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)  # tier-1 runs several xdist workers


@pytest.fixture
def dev():
    """Decided at run time, never at import (xdist workers collect alike)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(dev, **cfg_kw):
    """A 256^2 column collapse packed into contact, with seeded motion."""
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    disks = [DiskSpec(d.x * 0.94, d.y * 0.94, d.r) for d in disks]
    sim = Simulation(cfg.replace(**cfg_kw), disks, device=dev)
    rng = np.random.default_rng(0)
    d = sim.state.disks
    n = d.x.shape[0]
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)),
                          dtype=torch.float32, device=dev),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n),
                              dtype=torch.float32, device=dev))
    return sim, d


def test_stamp_kernel_matches_plain(dev):
    sim, d = _scene(dev)
    td, cnt, _, ovf = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                               d.active, sim.cfg)
    n0 = stamp.stamp_fields.launches
    k = stamp.stamp_fields(td, cnt, sim.cfg)
    assert stamp.stamp_fields.launches == n0 + 1
    p = stamp.stamp_fields_plain(td, cnt, sim.cfg)
    assert float(k[0].sum()) > 0
    assert float((k - p).abs().max()) <= 1e-6


@pytest.mark.parametrize("kw", [{}, dict(uw_north=0.05, gx=2e-5)],
                         ids=["slice", "lid-guo"])
def test_fused_step_kernel_matches_plain(dev, kw):
    sim, d = _scene(dev, **kw)
    cfg = sim.cfg
    td, cnt, es, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                              d.active, cfg)
    solid = stamp.stamp_fields(td, cnt, cfg)
    g = torch.Generator().manual_seed(1)
    f = (lbm.init_equilibrium(cfg, dev)
         * (1.0 + 0.02 * torch.randn((9, cfg.ny, cfg.nx), generator=g)
            .to(dev)))
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    n0 = fused_lbm.fused_step_imb_reduce.launches
    _, pk = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, cfg, fa)
    assert fused_lbm.fused_step_imb_reduce.launches == n0 + 1
    _, pp = fused_lbm.fused_step_imb_reduce_plain(f, solid, td, cnt, cfg, fb)
    assert float((fa - fb).abs().max()) <= 5e-6
    F, _ = stamp.gather_partials(pk, es, torch.float32)
    Fp, _ = stamp.gather_partials(pp, es, torch.float32)
    scale = float(Fp.abs().max())
    assert scale > 0
    assert float((F - Fp).abs().max()) <= 1e-6 * scale


def test_slab_kernel_matches_plain(dev):
    sim, d = _scene(dev)
    cfg, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    g = torch.Generator().manual_seed(2)
    n = d.x.shape[0]
    fh = (1e-3 * torch.randn((n, 2), generator=g)).to(dev)
    th = (1e-4 * torch.randn((n,), generator=g)).to(dev)
    slabs, slot, ovf, kmax, n_occ, bands = slab_dem.build_slabs(
        d, fh, th, dem.body_forces(d, cfg), grid, axis)
    assert int(ovf) == 0
    n0 = slab_dem.subcycle_slabs.launches
    sk, nck = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands, grid,
                                      cfg, axis)
    assert slab_dem.subcycle_slabs.launches == n0 + 1
    sp, ncp = slab_dem.subcycle_slabs_plain(
        slabs, kmax, cfg, slab_dem.slab_dims(grid, axis)[1])
    assert int(nck) == int(ncp) > 0
    a, b = slab_dem._unslab(sk, slot, d), slab_dem._unslab(sp, slot, d)
    for k in ("x", "v", "omega", "theta"):
        assert float((getattr(a, k) - getattr(b, k)).abs().max()) <= 2e-5, k


@pytest.mark.parametrize("k", [2, 4, 8])
def test_window_fluid_kernel_matches_plain(dev, k):
    """K6 against its plain version on CPU copies of the same inputs. The
    kernel divides as the CPU does; the plain version on the card
    multiplies by 1/tau (PyTorch's CUDA scalar division), and that
    1-ulp change of f after inner step 0 moved inner step 1's forces by
    1.2e-6 of the largest |F| on this scene, over K2's 1e-6 bar."""
    sim, d = _scene(dev, uw_north=0.02)
    cfg = sim.cfg
    td, cnt, es, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                              d.active, cfg)
    solid = stamp.stamp_fields(td, cnt, cfg)
    g = torch.Generator().manual_seed(3)
    f = (lbm.init_equilibrium(cfg, dev)
         * (1.0 + 0.02 * torch.randn((9, cfg.ny, cfg.nx), generator=g)
            .to(dev)))
    fa = torch.empty_like(f)
    n0 = fused_lbm.fused_step_imb_reduce_multi.launches
    _, pk = fused_lbm.fused_step_imb_reduce_multi(f, solid, td, cnt, cfg, k,
                                                  fa)
    assert fused_lbm.fused_step_imb_reduce_multi.launches == n0 + 1
    fb, pp = fused_lbm.fused_step_imb_reduce_multi_plain(
        f.cpu(), solid.cpu(), td.cpu(), cnt.cpu(), cfg, k,
        torch.empty_like(f, device="cpu"))
    assert pk.shape == pp.shape == (k,) + tuple(pp.shape[1:])
    assert float((fa.cpu() - fb).abs().max()) <= 5e-6
    for t in range(k):
        F, _ = stamp.gather_partials(pk[t].cpu(), es.cpu(), torch.float32)
        Fp, _ = stamp.gather_partials(pp[t], es.cpu(), torch.float32)
        scale = float(Fp.abs().max())
        assert scale > 0
        assert float((F - Fp).abs().max()) <= 1e-6 * scale, t


def test_window_slab_kernel_matches_plain(dev):
    sim, d = _scene(dev)
    cfg, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    g = torch.Generator().manual_seed(4)
    n = d.x.shape[0]
    forces = [((1e-3 * torch.randn((n, 2), generator=g)).to(dev),
               (1e-4 * torch.randn((n,), generator=g)).to(dev))
              for _ in range(4)]
    body = dem.body_forces(d, cfg)
    slabs, slot, ovf, kmax, n_occ, bands = slab_dem.build_slabs(
        d, None, None, body, grid, axis, bake_forces=False)
    assert int(ovf) == 0 and slabs.shape[0] == 8
    f3 = slab_dem._force_planes_window(slot, forces, body, slabs.shape)
    sk, sp = slabs.clone(), slabs
    ncl = slab_dem.slab_dims(grid, axis)[1]
    n0 = slab_dem.subcycle_slabs_window.launches
    for t in range(4):
        sk, nck = slab_dem.subcycle_slabs_window(sk, f3[t], kmax, n_occ,
                                                 bands, grid, cfg, axis)
        sp, ncp = slab_dem.subcycle_slabs_plain(sp, kmax, cfg, ncl, f3[t])
        assert int(nck) == int(ncp) > 0
    assert slab_dem.subcycle_slabs_window.launches == n0 + 4
    a, b = slab_dem._unslab(sk, slot, d), slab_dem._unslab(sp, slot, d)
    for k in ("x", "v", "omega", "theta"):
        assert float((getattr(a, k) - getattr(b, k)).abs().max()) <= 2e-5, k


def test_window_simulation_on_card_matches_cpu(dev):
    """run(19) at coupling_k=4: 2 cadence blocks of 2 windows, then 3
    single steps; the launch counts of that split, and the CPU run."""
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    cfg = cfg.replace(coupling_k=4)
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    wrappers = (fused_lbm.fused_step_imb_reduce_multi,
                fused_lbm.fused_step_imb_reduce, stamp.stamp_fields,
                slab_dem.subcycle_slabs_window, slab_dem.subcycle_slabs)
    n0 = [w.launches for w in wrappers]
    g.run(19)
    c.run(19)
    assert [w.launches - n for w, n in zip(wrappers, n0)] == [4, 3, 7, 16, 3]
    assert int(g.state.overflow) == 0 and int(g.state.step) == 19
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_simulation_on_card_matches_cpu(dev):
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    g.run(8)
    c.run(8)
    assert int(g.state.overflow) == 0
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_kernels_reject_float64_on_card(dev):
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    with pytest.raises(NotImplementedError, match="float64"):
        Simulation(cfg.replace(dtype="float64"), disks, device=dev)


def _fluid_f(cfg, dev, seed):
    rng = np.random.default_rng(seed)
    f = lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, cfg.ny, cfg.nx)))
    return lbm.to_storage(torch.as_tensor(f, dtype=torch.float32, device=dev),
                          cfg)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("kw", [
    dict(gx=1e-5, gy=-2e-5),
    dict(bc_west="wall", bc_east="wall", uw_north=0.08),
    dict(collision="trt", smagorinsky=0.16, gx=1e-5,
         bc_south="periodic", bc_north="periodic"),
    dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
         inlet_profile="poiseuille", bc_south="periodic",
         bc_north="periodic"),
    dict(f_storage="bfloat16", gx=1e-5),
    dict(f_storage="bfloat16", bc_west="inlet", bc_east="outlet",
         u_inlet=0.06)],
    ids=["forcing", "lid", "trt-les-periodic", "zou-he-periodic-y", "bf16",
         "bf16-zou-he"])
def test_fluid_kernels_match_plain(dev, kw, k):
    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32", **kw)
    f = _fluid_f(cfg, dev, 3)
    a, b = torch.empty_like(f), torch.empty_like(f)
    w = fused_fluid.fused_step_fluid if k == 1 else \
        fused_fluid.fused_step_fluid_multi
    n0 = w.launches
    fused_fluid.fused_step_fluid_multi(f, cfg, k, a)
    assert w.launches == n0 + 1
    fused_fluid.fused_step_fluid_multi_plain(f, cfg, k, b)
    a, b = a.float(), b.float()
    if cfg.f_storage == "bfloat16":
        atol, rtol = 3e-4, 0.0
    elif k == 1:
        atol, rtol = 1e-7, 1e-6
    else:
        atol, rtol = (2e-6 if cfg.bc_west == "inlet" else 5e-7), 1e-5
    assert float(((a - b).abs() - rtol * b.abs()).max()) <= atol


def test_fluid_bf16_rest_state_exact(dev):
    cfg = SimConfig(nx=128, ny=32, tau=0.8, dtype="float32",
                    f_storage="bfloat16")
    g = lbm.to_storage(lbm.init_equilibrium(cfg, dev), cfg)
    assert g.dtype == torch.bfloat16 and not g.float().any()
    out = torch.empty_like(g)
    assert not fused_fluid.fused_step_fluid(g, cfg, out).float().any()
    for k in (4, 16):
        assert not fused_fluid.fused_step_fluid_multi(g, cfg, k,
                                                      out).float().any()


def test_fluid_simulation_on_card_matches_cpu(dev):
    cfg = SimConfig(nx=256, ny=64, tau=0.7, dtype="float32", bc_west="inlet",
                    bc_east="outlet", u_inlet=0.05, inlet_profile="poiseuille")
    g = Simulation(cfg, device=dev)
    c = Simulation(cfg, device="cpu")
    n4, n5 = (fused_fluid.fused_step_fluid.launches,
              fused_fluid.fused_step_fluid_multi.launches)
    g.run(19)
    c.run(19)
    assert (fused_fluid.fused_step_fluid.launches - n4,
            fused_fluid.fused_step_fluid_multi.launches - n5) == (3, 4)
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5


def test_fluid_kernels_reject_prehalo_and_float64(dev):
    cfg = SimConfig(nx=128, ny=32, tau=0.8, dtype="float32")
    f = lbm.init_equilibrium(cfg, dev)
    out = torch.empty_like(f)
    with pytest.raises(NotImplementedError, match="item 12"):
        fused_fluid.fused_step_fluid(f, cfg, out, prehalo=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        fused_fluid.fused_step_fluid_multi(f, cfg, 4, out, prehalo=True)
    with pytest.raises(NotImplementedError, match="float64"):
        Simulation(cfg.replace(dtype="float64"), device=dev)


def _obstacles():
    """A row of fixed obstacles at rest, one across the periodic x seam."""
    return [DiskSpec(x, y, r, fixed=True) for x, y, r in (
        (1.2, 20.3, 4.0), (64.3, 32.1, 4.0), (128.0, 40.0, 3.0),
        (200.5, 50.2, 5.0))]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4])
def test_static_kernel_matches_plain(dev, k, storage):
    """K7 against its plain version on CPU copies of the same inputs (the
    plain version on the card multiplies by 1/tau): Guo forcing and a
    moving north wall over the stamped obstacles."""
    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32",
                    f_storage=storage, gx=1e-5, uw_north=0.05)
    sim = Simulation(cfg, _obstacles(), device=dev)
    cfg = sim.cfg
    solid = sim._static_solid_operands()
    f = _fluid_f(cfg, dev, 5)
    a = torch.empty_like(f)
    n0 = fused_static.fused_step_imb_static_multi.launches
    fused_static.fused_step_imb_static_multi(f, solid, cfg, k, a)
    assert fused_static.fused_step_imb_static_multi.launches == n0 + 1
    b = fused_static.fused_step_imb_static_multi_plain(
        f.cpu(), solid.cpu(), cfg, k, torch.empty_like(f, device="cpu"))
    a, b = a.float().cpu(), b.float()
    atol, rtol = (3e-4, 0.0) if storage == "bfloat16" else (2e-6, 1e-5)
    assert float(((a - b).abs() - rtol * b.abs()).max()) <= atol
    assert float((b - f.float().cpu()).abs().max()) > 1e-3


def _offset_bed():
    cfg, disks = porous_bed(nx=256, ny=256)
    return cfg.replace(gx=1e-5), [DiskSpec(d.x - 16.0, d.y - 16.0, d.r,
                                           fixed=True) for d in disks]


def test_static_simulation_on_card_matches_cpu(dev):
    """run(19) of a porous bed on the seams of a fully periodic box: K1
    once, 4 K7 passes of 4 steps and 3 of 1, and nothing else; the CPU
    run and its hydro forces."""
    cfg, disks = _offset_bed()
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    assert g.static_solid
    d = g.state.disks
    parent = imb.periodic_ghosts(d.x, d.v, d.omega, d.r, d.active, g.cfg)[2]
    assert int((parent >= 0).sum()) > 0
    wrappers = (fused_static.fused_step_imb_static_multi, stamp.stamp_fields,
                fused_lbm.fused_step_imb_reduce,
                fused_lbm.fused_step_imb_reduce_multi,
                slab_dem.subcycle_slabs)
    n0 = [w.launches for w in wrappers]
    g.run(19)
    c.run(19)
    assert [w.launches - n for w, n in zip(wrappers, n0)] == [7, 1, 0, 0, 0]
    assert int(g.state.overflow) == 0 and int(g.state.step) == 19
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    Fg, _ = g.hydro_forces()
    Fc, _ = c.hydro_forces()
    scale = float(np.abs(Fc).max())
    assert scale > 0 and float(np.abs(Fg - Fc).max()) <= 1e-4 * scale


def test_drift_simulation_on_card_matches_cpu(dev):
    """Prescribed motion on a periodic x axis: K1 + K2 per step through
    the Verlet cadence, no K7; the CPU run, positions equal."""
    cfg = SimConfig(nx=256, ny=256, tau=0.8, gx=1e-5, dtype="float32")
    disks = [DiskSpec(64.0, 128.0, 6.0, fixed=True),
             DiskSpec(255.1, 120.0, 6.0, vx=0.05, fixed=True)]
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    assert g.dem_mode == "drift" and not g.static_solid
    wrappers = (stamp.stamp_fields, fused_lbm.fused_step_imb_reduce,
                fused_static.fused_step_imb_static_multi)
    n0 = [w.launches for w in wrappers]
    g.run(19)
    c.run(19)
    assert [w.launches - n for w, n in zip(wrappers, n0)] == [19, 19, 0]
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert torch.equal(g.state.disks.x.cpu(), c.state.disks.x)
    assert float(g.state.disks.x[1, 0]) < 10.0  # crossed the seam, wrapped


_SPLIT_CASES = {
    "walls-gy": dict(bc_west="wall", bc_east="wall", gy=-1e-5),
    "trt-les": dict(collision="trt", smagorinsky=0.16, gx=1e-5),
    "les-lambda": dict(smagorinsky=0.16, nt_mode="lambda", gx=1e-5),
    "lid": dict(bc_west="wall", bc_east="wall", uw_north=0.05),
    "zou-he": dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                   inlet_profile="poiseuille"),
    "periodic-xy": dict(bc_south="periodic", bc_north="periodic", gx=1e-5),
}


@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_kernel_matches_plain(dev, case):
    """K8 against its plain version on CPU copies over its options, with
    moving disks stamped across the tiles (Zou/He columns masked)."""
    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32", max_disks=4,
                    window=13, **_SPLIT_CASES[case])
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0],
                      [200.5, 60.2]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0])
    fields = imb.stamp_solid_fraction(x, v, om, r, torch.ones(4, dtype=bool),
                                      cfg)
    if cfg.bc_west == "inlet":
        fields = imb.mask_open_columns(*fields)
    f = _fluid_f(cfg, "cpu", 7)
    a = torch.empty_like(f, device=dev)
    n0 = fused_lbm.fused_step_imb.launches
    _, kx, ky = fused_lbm.fused_step_imb(f.to(dev), *(t.to(dev) for t in fields),
                                         cfg, a)
    assert fused_lbm.fused_step_imb.launches == n0 + 1
    b, px, py = fused_lbm.fused_step_imb_plain(f, *fields, cfg,
                                               torch.empty_like(f))
    a = a.cpu()
    assert float(((a - b).abs() - 1e-6 * b.abs()).max()) <= 1e-7
    for k, p in ((kx, px), (ky, py)):
        assert float(((k.cpu() - p).abs() - 1e-5 * p.abs()).max()) <= 5e-8
    assert float(px.abs().max()) > 0


def test_split_kernel_rejects_bf16(dev):
    cfg = SimConfig(nx=128, ny=32, tau=0.8, dtype="float32")
    g = lbm.init_equilibrium(cfg, dev).to(torch.bfloat16)
    z = torch.zeros((32, 128), device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_lbm.fused_step_imb(g, z, z, z, cfg, torch.empty_like(g))


@pytest.mark.parametrize("method", ["sample", "ramp", "exact"])
def test_split_pair_and_coverage_match(dev, method):
    """Under each coverage method: K1 against its plain version; K8 + K9
    against K2 on the same input (f' equal, forces 1e-6); K9 against its
    plain version; K2's reduce against its plain version."""
    sim, d = _scene(dev, eps_method=method, gx=1e-5)
    cfg = sim.cfg
    td, cnt, es, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                              d.active, cfg)
    solid = stamp.stamp_fields(td, cnt, cfg)
    assert float((solid - stamp.stamp_fields_plain(td, cnt, cfg)).abs()
                 .max()) <= 1e-6
    g = torch.Generator().manual_seed(6)
    f = (lbm.init_equilibrium(cfg, dev)
         * (1.0 + 0.02 * torch.randn((9, cfg.ny, cfg.nx), generator=g)
            .to(dev)))
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    n8, n9 = fused_lbm.fused_step_imb.launches, stamp.reduce_hydro_forces.launches
    _, phix, phiy = fused_lbm.fused_step_imb(f, solid[0], solid[1], solid[2],
                                             cfg, fa)
    F9, T9 = stamp.reduce_hydro_forces(d.x, d.r, d.active, solid[0], phix,
                                       phiy, cfg, td, cnt, es)
    assert (fused_lbm.fused_step_imb.launches - n8,
            stamp.reduce_hydro_forces.launches - n9) == (1, 1)
    _, parts = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, cfg, fb)
    F2, T2 = stamp.gather_partials(parts, es, torch.float32)
    assert torch.equal(fa, fb)
    assert float((F9 - F2).abs().max()) <= 1e-6
    assert float((T9 - T2).abs().max()) <= 1e-6
    Fp, Tp = stamp.gather_partials(stamp.hydro_partials_plain(
        solid[0], phix, phiy, td, cnt, cfg), es, torch.float32)
    # atol 1e-6 for |F| < 1 (the JAX package's scene); above, f32 sums
    # in another order differ by a few ulp of the largest value
    fmax, tmax = float(Fp.abs().max()), float(Tp.abs().max())
    assert fmax > 0
    assert float((F9 - Fp).abs().max()) <= 1e-6 * max(1.0, fmax)
    assert float((T9 - Tp).abs().max()) <= 1e-6 * max(1.0, tmax)
    _, pp = fused_lbm.fused_step_imb_reduce_plain(f, solid, td, cnt, cfg,
                                                  torch.empty_like(f))
    F2p, _ = stamp.gather_partials(pp, es, torch.float32)
    assert float((F2 - F2p).abs().max()) <= 1e-6 * float(F2p.abs().max())


def _coverage_scene(path, method):
    if path == "static":
        cfg, disks = _offset_bed()
    else:
        cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
        cfg = cfg.replace(coupling_k=4 if path == "window" else 1)
    return cfg.replace(eps_method=method), disks


@pytest.mark.parametrize("path,method", [("coupled", "ramp"),
                                         ("window", "exact"),
                                         ("static", "ramp")])
def test_ramp_simulation_on_card_matches_cpu(dev, path, method):
    """run(8) with ramp or exact coverage on the coupled step, the
    coupling_k = 4 window and the static hoist, against the CPU run."""
    cfg, disks = _coverage_scene(path, method)
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    g.run(8)
    c.run(8)
    assert int(g.state.overflow) == 0
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_simulation_past_slab_gate_on_card_matches_cpu(dev):
    """A long channel of small disks whose DEM grid the slab gate
    rejects: the step takes the cell-list DEM, on the card as on the
    CPU."""
    cfg = SimConfig(nx=4352, ny=16, tau=0.8, dtype="float32", g_py=-1e-4,
                    rho_s=2.0, n_sub=4, bc_west="wall", bc_east="wall")
    disks = [DiskSpec(100.0 + 2.2 * i, 3.0 + 5.0 * j, 0.5)
             for i in range(4) for j in range(3)]
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    assert not slab_dem.slab_supported(g.grid, g.dem_axis)
    n3 = slab_dem.subcycle_slabs.launches
    g.run(4)
    c.run(4)
    assert slab_dem.subcycle_slabs.launches == n3
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_cell_list_dem_on_card_matches_cpu(dev):
    sim, d = _scene(dev)
    g = torch.Generator().manual_seed(8)
    n = d.x.shape[0]
    fh = (1e-3 * torch.randn((n, 2), generator=g)).to(dev)
    th = (1e-4 * torch.randn((n,), generator=g)).to(dev)
    a, ovf, nc = dem.dem_subcycle(d, fh, th, sim.grid, sim.cfg)
    b, ovf_c, nc_c = dem.dem_subcycle(type(d)(*(t.cpu() for t in d)),
                                      fh.cpu(), th.cpu(), sim.grid, sim.cfg)
    assert int(ovf) == int(ovf_c) == 0
    assert int(nc) == int(nc_c) > 0
    for k in ("x", "v", "omega"):
        assert float((getattr(a, k).cpu() - getattr(b, k)).abs().max()) <= 1e-4

