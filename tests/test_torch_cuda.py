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
with equal contacts; K2 and K6 over the lattice options on CPU copies as
above (bf16 3e-4), K8 + K9 against K2 bit for bit; K3 and K3w with
history springs 3e-5 on every slab channel, on periodic axes 2e-5."""

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
    slabs, slot, ovf, kmax, n_occ, bands, _ = slab_dem.build_slabs(
        d, fh, th, dem.body_forces(d, cfg), grid, axis)
    assert int(ovf) == 0
    n0 = slab_dem.subcycle_slabs.launches
    sk, nck = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands, grid,
                                      cfg, axis)
    assert slab_dem.subcycle_slabs.launches == n0 + 1
    sp, ncp = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg, grid, axis)
    assert int(nck) == int(ncp) > 0
    a = slab_dem._unslab(sk, slot, d, cfg, None, ovf)[0]
    b = slab_dem._unslab(sp, slot, d, cfg, None, ovf)[0]
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
    slabs, slot, ovf, kmax, n_occ, bands, _ = slab_dem.build_slabs(
        d, None, None, body, grid, axis, bake_forces=False)
    assert int(ovf) == 0 and slabs.shape[0] == 8
    f3 = slab_dem._force_planes_window(slot, forces, body, slabs.shape)
    sk, sp = slabs.clone(), slabs
    n0 = slab_dem.subcycle_slabs_window.launches
    for t in range(4):
        sk, nck = slab_dem.subcycle_slabs_window(sk, f3[t], kmax, n_occ,
                                                 bands, grid, cfg, axis)
        sp, ncp = slab_dem.subcycle_slabs_plain(sp, kmax, cfg, grid, axis,
                                                f3[t])
        assert int(nck) == int(ncp) > 0
    assert slab_dem.subcycle_slabs_window.launches == n0 + 4
    a = slab_dem._unslab(sk, slot, d, cfg, None, ovf)[0]
    b = slab_dem._unslab(sp, slot, d, cfg, None, ovf)[0]
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


def _long_channel():
    cfg = SimConfig(nx=4352, ny=16, tau=0.8, dtype="float32", g_py=-1e-4,
                    rho_s=2.0, n_sub=4, bc_west="wall", bc_east="wall")
    disks = [DiskSpec(100.0 + 2.2 * i, 3.0 + 5.0 * j, 0.5)
             for i in range(4) for j in range(3)]
    return cfg, disks


def test_simulation_past_slab_gate_on_card_matches_cpu(dev):
    """A long channel of small disks whose DEM grid is past the CPU's
    plane budget: the CPU run takes the cell-list DEM, the card has no
    such limit and takes K3, and the two agree."""
    cfg, disks = _long_channel()
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    assert not slab_dem.slab_supported(g.grid, g.dem_axis)
    assert slab_dem.slab_supported(g.grid, g.dem_axis, device=dev)
    n3 = slab_dem.subcycle_slabs.launches
    g.run(4)
    c.run(4)
    assert slab_dem.subcycle_slabs.launches == n3 + 4
    assert int(g.state.overflow) == int(c.state.overflow) == 0
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_simulation_cell_list_dem_on_card_matches_cpu(dev, monkeypatch):
    """The same channel with the slab gate shut: the step takes the
    cell-list DEM on the card as on the CPU."""
    monkeypatch.setattr(slab_dem, "slab_supported", lambda *a, **k: False)
    cfg, disks = _long_channel()
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
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



# --- the lattice breadth of K2 and K6, the springs and periodic axes of
# --- K3 and K3w

_BREADTH_CASES = dict(
    _SPLIT_CASES,
    **{"trt": dict(collision="trt", bc_west="wall", bc_east="wall"),
       "lambda": dict(nt_mode="lambda", bc_west="wall", bc_east="wall"),
       "all": dict(collision="trt", smagorinsky=0.16, nt_mode="lambda",
                   gx=1e-5, gy=-1e-5, uw_north=0.03, bc_west="inlet",
                   bc_east="outlet", u_inlet=0.05,
                   inlet_profile="poiseuille")})


def _breadth_inputs(case, storage, seed=7):
    """CPU inputs of a 256x64 coupled step under a lattice-option case:
    (cfg, f in storage form, solid stack, tile_data, counts,
    entry_slots), four moving disks across the tiles, Zou/He columns
    zeroed as the steps zero them."""
    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32", max_disks=4,
                    window=13, tile_cap=8, f_storage=storage,
                    **_BREADTH_CASES[case])
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0],
                      [200.5, 60.2]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0])
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(
        x, v, om, r, torch.ones(4, dtype=torch.bool), cfg)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, cfg)
    if cfg.bc_west == "inlet":
        solid[:, :, 0].zero_()
        solid[:, :, -1].zero_()
    f = lbm.to_storage(_fluid_f(cfg.replace(f_storage="float32"), "cpu",
                                seed), cfg)
    return cfg, f, solid, td, cnt, es, (x, r)


def _assert_coupled(cfg, fa, pk, fb, pp, es):
    """Kernel f' and partials (card) against the plain version's (CPU).
    On bf16 storage the kernel computes in the shifted form, the plain
    version in the physical one: forces within 5e-6 of the largest."""
    bf16 = cfg.f_storage == "bfloat16"
    tol = 3e-4 if bf16 else 5e-6
    rel = 5e-6 if bf16 else 1e-6
    assert fa.dtype == fb.dtype
    assert float((fa.cpu().float() - fb.float()).abs().max()) <= tol
    F, T = stamp.gather_partials(pk.cpu(), es, torch.float32)
    Fp, Tp = stamp.gather_partials(pp, es, torch.float32)
    fs, ts = float(Fp.abs().max()), float(Tp.abs().max())
    assert fs > 0 and ts > 0
    assert float((F - Fp).abs().max()) <= rel * fs
    assert float((T - Tp).abs().max()) <= 2 * rel * ts


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_BREADTH_CASES))
def test_fused_step_options_match_plain(dev, case, storage):
    """K2 over the lattice options on f32 and shifted-bf16 storage,
    against its plain version on CPU copies."""
    cfg, f, solid, td, cnt, es, _ = _breadth_inputs(case, storage)
    fa = torch.empty_like(f, device=dev)
    n0 = fused_lbm.fused_step_imb_reduce.launches
    _, pk = fused_lbm.fused_step_imb_reduce(f.to(dev), solid.to(dev),
                                            td.to(dev), cnt.to(dev), cfg, fa)
    assert fused_lbm.fused_step_imb_reduce.launches == n0 + 1
    fb, pp = fused_lbm.fused_step_imb_reduce_plain(f, solid, td, cnt, cfg,
                                                   torch.empty_like(f))
    _assert_coupled(cfg, fa, pk, fb, pp, es)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["trt-les", "les-lambda", "zou-he",
                                  "periodic-xy", "all"])
def test_window_fluid_options_match_plain(dev, case, storage, k):
    """K6 over the lattice options, f' and every inner step's forces,
    against its plain version on CPU copies (Zou/He: the halo cells of
    the blocks next to the open ends take the closures too)."""
    cfg, f, solid, td, cnt, es, _ = _breadth_inputs(case, storage, seed=9)
    fa = torch.empty_like(f, device=dev)
    _, pk = fused_lbm.fused_step_imb_reduce_multi(
        f.to(dev), solid.to(dev), td.to(dev), cnt.to(dev), cfg, k, fa)
    fb, pp = fused_lbm.fused_step_imb_reduce_multi_plain(
        f, solid, td, cnt, cfg, k, torch.empty_like(f))
    for t in range(k):
        _assert_coupled(cfg, fa, pk[t], fb, pp[t], es)


@pytest.mark.parametrize("case", list(_BREADTH_CASES))
def test_split_pair_equals_fused_step_bitwise(dev, case):
    """K8 + K9 against K2 on f32 for every option K8 takes, Zou/He
    included: f' and the partials bit for bit (one launch-(a) kernel)."""
    cfg, f, solid, td, cnt, es, (x, r) = _breadth_inputs(case, "float32")
    f, solid, td, cnt, es, x, r = (t.to(dev) for t in
                                   (f, solid, td, cnt, es, x, r))
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    _, p2 = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, cfg, fa)
    _, phx, phy = fused_lbm.fused_step_imb(f, solid[0], solid[1], solid[2],
                                           cfg, fb)
    F9, T9 = stamp.reduce_hydro_forces(
        x, r, torch.ones(4, dtype=torch.bool, device=dev), solid[0], phx, phy,
        cfg, td, cnt, es)
    F2, T2 = stamp.gather_partials(p2, es, torch.float32)
    assert torch.equal(fa, fb)
    assert float(F2.abs().max()) > 0
    assert torch.equal(F2, F9) and torch.equal(T2, T9)


def _kt_scene(dev, **kw):
    """The packed 256^2 column with history springs, carried springs
    from two subcycles on the CPU."""
    sim, d = _scene(dev, kt=25.0, **kw)
    cfg, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    g = torch.Generator().manual_seed(2)
    n = d.x.shape[0]
    fh = 1e-3 * torch.randn((n, 2), generator=g)
    th = 1e-4 * torch.randn((n,), generator=g)
    dc = type(d)(*(t.cpu() for t in d))
    for _ in range(2):
        dc, ovf, nc = slab_dem.dem_subcycle(dc, fh, th, grid, cfg, axis)
    assert int(ovf) == 0 and int(nc) > 0 and int((dc.ct_j >= 0).sum()) > 0
    return cfg, grid, axis, type(d)(*(t.to(dev) for t in dc)), fh.to(dev), \
        th.to(dev)


def _assert_slabs(sk, sp, nck, ncp, tol):
    assert int(nck) == int(ncp) > 0
    assert float((sk - sp).abs().max()) <= tol


def test_slab_kernel_with_springs_matches_plain(dev):
    """K3 with kt > 0 against its plain version on the card: every
    channel of the slabs (springs included) 3e-5, equal contacts; the
    unslabbed carry has live springs."""
    cfg, grid, axis, d, fh, th = _kt_scene(dev)
    slabs, slot, ovf, kmax, n_occ, bands, j36 = slab_dem.build_slabs(
        d, fh, th, dem.body_forces(d, cfg), grid, axis, kt=True)
    assert slabs.shape[0] == 51 and float(slabs[11:47].abs().max()) > 0
    sk, nck = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands, grid,
                                      cfg, axis)
    sp, ncp = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg, grid, axis)
    _assert_slabs(sk, sp, nck, ncp, 3e-5)
    new, ovf2 = slab_dem._unslab(sk, slot, d, cfg, j36, ovf)
    assert int(ovf2) == 0 and int((new.ct_j >= 0).sum()) > 0


def test_window_slab_kernel_with_springs_matches_plain(dev):
    """K3w with kt > 0 (48 channels, springs from channel 8), three
    chained calls, against its plain version."""
    cfg, grid, axis, d, fh, th = _kt_scene(dev)
    body = dem.body_forces(d, cfg)
    slabs, slot, ovf, kmax, n_occ, bands, j36 = slab_dem.build_slabs(
        d, None, None, body, grid, axis, kt=True, bake_forces=False)
    assert slabs.shape[0] == 48
    f3 = slab_dem._force_planes_window(slot, [(fh, th)] * 3, body,
                                       slabs.shape)
    sk, sp = slabs.clone(), slabs
    for t in range(3):
        sk, nck = slab_dem.subcycle_slabs_window(sk, f3[t], kmax, n_occ,
                                                 bands, grid, cfg, axis)
        sp, ncp = slab_dem.subcycle_slabs_plain(sp, kmax, cfg, grid, axis,
                                                f3[t])
        _assert_slabs(sk, sp, nck, ncp, 3e-5)


@pytest.mark.parametrize("axis", ["y", "x"])
@pytest.mark.parametrize("kt", [0.0, 0.4])
def test_slab_kernel_periodic_matches_plain(dev, axis, kt):
    """K3 on a doubly periodic box under both slab orientations: a pair
    touching through the corner, a disk that crosses the seam; 2e-5
    (3e-5 with kt)."""
    cfg = SimConfig(nx=128, ny=96, tau=0.8, dtype="float32", max_disks=6,
                    kn=2.0, gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0,
                    n_sub=6, kt=kt, bc_west="periodic", bc_east="periodic",
                    bc_south="periodic", bc_north="periodic")
    specs = [DiskSpec(126.8, 94.5, 3.5, vx=0.03, vy=0.02),
             DiskSpec(2.0, 1.5, 3.5, vx=-0.01),
             DiskSpec(50.0, 50.0, 3.0), DiskSpec(55.5, 52.0, 3.0),
             DiskSpec(127.2, 70.0, 2.5, vx=0.08),
             DiskSpec(30.0, 95.0, 2.5, vy=0.05)]
    d = dem.make_disk_state(specs, cfg, device=dev)
    grid = dem.DemGrid.build(cfg, 3.5)
    assert slab_dem.slab_supported(grid, axis, kt=kt > 0)
    z2 = torch.zeros((6, 2), device=dev)
    z1 = torch.zeros((6,), device=dev)
    slabs, slot, ovf, kmax, n_occ, bands, j36 = slab_dem.build_slabs(
        d, z2, z1, dem.body_forces(d, cfg), grid, axis, kt=kt > 0)
    sk, nck = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands, grid,
                                      cfg, axis)
    sp, ncp = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg, grid, axis)
    assert int(ncp) >= 2
    _assert_slabs(sk, sp, nck, ncp, 3e-5 if kt else 2e-5)
    # and against the cell-list DEM on the CPU
    a, _, nca = slab_dem.dem_subcycle(d, z2, z1, grid, cfg, axis)
    b, _, ncb = dem.dem_subcycle(type(d)(*(t.cpu() for t in d)), z2.cpu(),
                                 z1.cpu(), grid, cfg)
    assert int(nca) == int(ncb)
    for k in ("x", "v", "omega"):
        assert float((getattr(a, k).cpu() - getattr(b, k)).abs().max()) <= 1e-4


def _run_pair(cfg, disks, dev, n):
    g = Simulation(cfg, disks, device=dev)
    c = Simulation(cfg, disks, device="cpu")
    g.run(n)
    c.run(n)
    assert int(g.state.overflow) == int(c.state.overflow) == 0
    return g, c


@pytest.mark.parametrize("ck", [1, 4])
def test_bf16_coupled_simulation_on_card_matches_cpu(dev, ck):
    """The coupled slice on shifted-bf16 storage, per step and per
    coupling_k = 4 window, against the CPU run (3e-4: a flipped bf16
    rounding of the shifted populations)."""
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    cfg = cfg.replace(f_storage="bfloat16", coupling_k=ck)
    n2 = fused_lbm.fused_step_imb_reduce.launches
    n6 = fused_lbm.fused_step_imb_reduce_multi.launches
    g, c = _run_pair(cfg, disks, dev, 16)
    assert g.state.f.dtype == torch.bfloat16
    assert (fused_lbm.fused_step_imb_reduce.launches - n2,
            fused_lbm.fused_step_imb_reduce_multi.launches - n6) == \
        ((16, 0) if ck == 1 else (0, 4))
    assert float((g.state.f.float().cpu() - c.state.f.float()).abs().max()) \
        <= 3e-4
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_open_channel_simulation_on_card_matches_cpu(dev):
    """A Zou/He channel under TRT + LES with a mobile disk that leaves
    through the outlet and is culled, and a fixed obstacle."""
    cfg = SimConfig(nx=256, ny=64, tau=0.7, dtype="float32", max_disks=2,
                    bc_west="inlet", bc_east="outlet", u_inlet=0.1,
                    inlet_profile="uniform", rho_s=1.0, n_sub=2, u0x=0.1,
                    collision="trt", smagorinsky=0.1)
    disks = [DiskSpec(253.0, 32.0, 3.0, vx=0.2),
             DiskSpec(60.0, 20.0, 4.0, fixed=True)]
    g, c = _run_pair(cfg, disks, dev, 48)
    assert not bool(g.state.disks.active[0]) and \
        not bool(c.state.disks.active[0])
    assert bool(g.state.disks.active[1])
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_friction_simulation_on_card_matches_cpu(dev):
    """The packed column with history springs (kt = 25) on K2 + K3."""
    sim, _ = _scene("cpu", kt=25.0)
    d = sim.state.disks
    disks = [DiskSpec(float(x), float(y), float(r)) for (x, y), r, on in
             zip(d.x, d.r, d.active) if on]
    n3 = slab_dem.subcycle_slabs.launches
    g, c = _run_pair(sim.cfg, disks, dev, 16)
    assert slab_dem.subcycle_slabs.launches == n3 + 16
    assert int(g.state.n_contacts) == int(c.state.n_contacts) > 0
    assert int((g.state.disks.ct_j >= 0).sum()) > 0
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4


def test_periodic_mobile_disks_on_card_match_cpu(dev):
    """Mobile disks on a periodic x axis, one straddling the seam: ghosts
    for the stamp and the reduce, the periodic slab DEM."""
    cfg = SimConfig(nx=128, ny=256, tau=0.65, dtype="float32", kn=0.5,
                    gamma_n=1.0, mu=0.3, rho_s=1.25, n_sub=10, g_py=-2e-5,
                    buoyancy=True, bc_west="periodic", bc_east="periodic")
    disks = [DiskSpec(126.8, 200.0, 6.0, vx=0.02), DiskSpec(20.4, 180.0, 5.0),
             DiskSpec(64.0, 210.0, 6.0, vx=-0.01)]
    n3 = slab_dem.subcycle_slabs.launches
    g, c = _run_pair(cfg, disks, dev, 24)
    assert slab_dem.subcycle_slabs.launches == n3 + 24
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-5
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-4
