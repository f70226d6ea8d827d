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
history springs 3e-5 on every slab channel, on periodic axes 2e-5; the
redesigned K1 bit for bit against its plain version on CPU copies for
every coverage method, K2's push step at each block size over the
boundary matrix with the bars above, and on f32 the row-sweep K5(k),
K6(k) and K7(k) equal to k chained K4, K2 and K8 steps, bit for bit (K5
on bf16 3e-4 against its plain version); K5 on frames deeper than one
sweep equal to the halo-free K5(k) bit for bit; the one-launch K3 and K3w bit
for bit alike at every cooperative grid, one CUDA launch per call; the
TRT instantiations of K2, K6, K7 and K8 (the pair-form collide) equal to
their plain versions on the card under torch.equal on f32, within 3e-4
on bf16; the slab DEM's leftover fallback kernel equal to its plain
version on the card under torch.equal, one launch with no host read."""

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import Simulation, lattice
from lbmdem_tpu_torch.config import DiskSpec, SimConfig
from lbmdem_tpu_torch.models import column_collapse
from lbmdem_tpu_torch.models import porous_bed
from lbmdem_tpu_torch.ops import (dem, fused_fluid, fused_lbm, fused_static,
                                  imb, lbm, slab_dem, stamp)
from lbmdem_tpu_torch.ops.dem import make_disk_state
from lbmdem_tpu_torch.simulation import derive_config, static_solid_stack

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
    """float64 on the card: the kernel path refuses it before any launch,
    the plain path runs it and agrees with the CPU's plain path."""
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    cfg = cfg.replace(dtype="float64")
    with pytest.raises(ValueError, match="float64"):
        Simulation(cfg, disks, device=dev)
    g = Simulation(cfg, disks, device=dev, use_kernels=False)
    c = Simulation(cfg, disks, device="cpu", use_kernels=False)
    g.run(4)
    c.run(4)
    assert g.state.f.dtype == torch.float64
    assert float((g.state.f.cpu() - c.state.f).abs().max()) <= 1e-12
    assert float((g.state.disks.x.cpu() - c.state.disks.x).abs().max()) <= 1e-12


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


PAIR_COMBOS = [(t, l, g) for t in (0, 1) for l in (0, 1) for g in (0, 1)]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("trt,les,forced", PAIR_COMBOS, ids=[
    "-".join(n for n, on in zip(("trt", "les", "forced"), c) if on) or "bgk"
    for c in PAIR_COMBOS])
def test_fluid_kernels_equal_pair_plain(dev, trt, les, forced, storage):
    """K4 and K5 against their plain versions (the pair-form collide
    fused_fluid.collide_pairs, in the kernels' shifted form on bf16) on
    the same card input, f' equal under torch.equal in both storages,
    for every BGK/TRT x LES x forced combination (walls with a moving lid,
    or Zou/He with periodic y): halo-free at k = 1, 4 and the deepest pass
    (f32 8, bf16 16); on "y" and "yx" frames K4 with its edge populations
    and K5 at k = 4 and at the frame's depth."""
    kw = dict(f_storage=storage, collision="trt" if trt else "bgk",
              smagorinsky=0.16 if les else 0.0,
              gx=1e-5 if forced else 0.0, gy=-2e-5 if forced else 0.0)
    if (trt + les + forced) % 2:
        kw.update(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                  inlet_profile="poiseuille", bc_south="periodic",
                  bc_north="periodic")
    else:
        kw.update(bc_west="wall", bc_east="wall", uw_north=0.05)
    cfg = SimConfig(nx=256, ny=64, tau=0.7, dtype="float32", **kw)
    deep = fused_fluid.MAX_K[storage]
    f = _fluid_f(cfg, dev, 11)
    a, b = torch.empty_like(f), torch.empty_like(f)
    for k in (1, 4, deep):
        fused_fluid.fused_step_fluid_multi(f, cfg, k, a)
        fused_fluid.fused_step_fluid_multi_plain(f, cfg, k, b)
        err = float((a.float() - b.float()).abs().max())
        assert torch.equal(a, b), (k, err)
    rng = np.random.default_rng(5)
    for mode in ("y", "yx"):
        fr = lbm.to_storage(torch.as_tensor(
            lattice.W[:, None, None] * (1.0 + 0.05 * rng.standard_normal(
                fused_fluid.frame_shape(cfg, mode))),
            dtype=torch.float32, device=dev), cfg)
        ea, eb = ((torch.empty((9, 2, cfg.nx), device=dev),
                   torch.empty((9, cfg.ny, 2), device=dev)) for _ in range(2))
        fused_fluid.fused_step_fluid(fr, cfg, a, prehalo=mode, edge_post=ea)
        fused_fluid.fused_step_fluid_prehalo_plain(fr, cfg, mode, b, eb)
        assert torch.equal(a, b) and all(map(torch.equal, ea, eb)), mode
        edges = (1, 0, 1, 1, 0) if mode == "y" else (0, 1, 0, 1, 192)
        for k in (4, deep):
            fused_fluid.fused_step_fluid_multi(fr, cfg, k, a, prehalo=mode,
                                               edges=edges, ny_glob=256)
            fused_fluid.fused_step_fluid_multi_prehalo_plain(
                fr, cfg, k, mode, edges, 256, b)
            assert torch.equal(a, b), (mode, k)


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
    """A pre-haloed call wants the frame's shape (the modes themselves:
    test_prehalo_kernels_match_plain and, deeper than one sweep,
    test_prehalo_deep_k5_matches_plain), K5 on a frame at most its halo
    rows deep, and float64 runs on the plain path."""
    cfg = SimConfig(nx=128, ny=32, tau=0.8, dtype="float32")
    f = lbm.init_equilibrium(cfg, dev)
    out = torch.empty_like(f)
    with pytest.raises(ValueError, match="f must be"):
        fused_fluid.fused_step_fluid(f, cfg, out, prehalo=True)
    with pytest.raises(ValueError, match="f must be"):
        fused_fluid.fused_step_fluid_multi(f, cfg, 8, out, prehalo=True,
                                           edges=(1, 1, 1, 1))
    fr = torch.empty(fused_fluid.frame_shape(cfg, "y"), device=dev)
    with pytest.raises(ValueError, match="outside 1..8"):
        fused_fluid.fused_step_fluid_multi(fr, cfg, 9, out, prehalo=True,
                                           edges=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="float64"):
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


# --- the redesigned K1 and K2: coverage fast path, busy lanes, push
# --- streaming, the reduce without empty blocks

def _plain_stamp_cpu(td, cnt, cfg):
    """K1's plain version on CPU copies, single-threaded (per-cell sums
    in slot order; the card's index_add_ adds in atomic order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return stamp.stamp_fields_plain(td.cpu(), cnt.cpu(), cfg)
    finally:
        torch.set_num_threads(n)


def _sweep_inputs(n=160, seed=11):
    """A 512^2 scene of 8 stamp tiles: centres on a 1/8 sub-cell grid,
    half the radii with the rim through a sample point of ns 3 or 4,
    corner and tile-corner disks, the top-right tile empty and the
    fullest tile at count == cap. Returns (cfg, tile_data, counts,
    entry_slots, (x, r, active)) on the CPU."""
    rng = np.random.default_rng(seed)
    x = rng.integers(16, 8 * 372, n) / 8.0
    y = rng.integers(16, 8 * 496, n) / 8.0
    x[:5] = [0.3, 511.6, 0.0, 128.0, 383.5]
    y[:5] = [0.2, 0.3, 511.0, 256.0, 100.0]
    r = rng.uniform(1.5, 6.0, n)
    for j in range(0, n, 2):
        ns = 3 + (j // 2) % 2
        s = (np.arange(ns) + 0.5) / ns - 0.5
        a = np.floor(x[j]) + rng.integers(-4, 5) + rng.choice(s) - x[j]
        b = np.floor(y[j]) + rng.integers(-4, 5) + rng.choice(s) - y[j]
        r[j] = np.float32(np.hypot(np.float32(a), np.float32(b)))
    r = np.clip(r, 1.5, 6.0)
    xt = torch.as_tensor(np.stack([x, y], 1), dtype=torch.float32)
    rt = torch.as_tensor(r, dtype=torch.float32)
    v = torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32)
    om = torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32)
    act = torch.ones(n, dtype=torch.bool)
    cfg = SimConfig(nx=512, ny=512, tau=0.8, dtype="float32", bc_west="wall",
                    bc_east="wall", max_disks=n, window=13, tile_cap=4096)
    _, cnt, _, _ = stamp.build_tile_lists(xt, act, cfg)
    cfg = cfg.replace(tile_cap=int(cnt.max()))
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(xt, v, om, rt, act, cfg)
    assert int(ovf) == 0 and int(cnt.min()) == 0
    return cfg, td, cnt, es, (xt, rt, act)


_SWEEP = [("sample", ns) for ns in (2, 3, 4, 5, 8)] + [("ramp", 4),
                                                       ("exact", 4)]


@pytest.mark.parametrize("shift", [0.0, -0.4])
@pytest.mark.parametrize("method,ns", _SWEEP)
def test_stamp_coverage_sweep_bitwise(dev, method, ns, shift):
    """K1 (busy lanes, the coverage fast path) equals its plain version
    bit for bit for every method, sample count and eps_r_shift."""
    cfg, td, cnt, _, _ = _sweep_inputs()
    cfg = cfg.replace(eps_method=method, eps_samples=ns, eps_r_shift=shift)
    k = stamp.stamp_fields(td.to(dev), cnt.to(dev), cfg)
    assert float(k[0].sum()) > 0
    assert torch.equal(k.cpu(), _plain_stamp_cpu(td, cnt, cfg))


@pytest.mark.parametrize("method", ["sample", "ramp", "exact"])
def test_reduce_edge_cases_match_plain(dev, method):
    """The per-tile reduce (K2's launch (b) and K9) on tiles with count 0
    and count == cap and windows clipped by tiles and the domain: forces
    within 1e-6 of max(1, max |F|) of the plain reduce of K8's phi, K8 +
    K9 == K2 bit for bit, and every row past its tile's count zero."""
    cfg, td, cnt, es, (x, r, act) = _sweep_inputs(seed=12)
    cfg = cfg.replace(eps_method=method)
    td, cnt, es, x, r, act = (t.to(dev) for t in (td, cnt, es, x, r, act))
    solid = stamp.stamp_fields(td, cnt, cfg)
    f = _fluid_f(cfg, dev, 3)
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    _, p2 = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, cfg, fa)
    _, phx, phy = fused_lbm.fused_step_imb(f, solid[0], solid[1], solid[2],
                                           cfg, fb)
    F9, T9 = stamp.reduce_hydro_forces(x, r, act, solid[0], phx, phy, cfg,
                                       td, cnt, es)
    F2, T2 = stamp.gather_partials(p2, es, torch.float32)
    Fp, Tp = stamp.gather_partials(stamp.hydro_partials_plain(
        solid[0], phx, phy, td, cnt, cfg), es, torch.float32)
    assert float(Fp.abs().max()) > 0
    assert float((F2 - Fp).abs().max()) <= 1e-6 * max(1.0, float(
        Fp.abs().max()))
    assert float((T2 - Tp).abs().max()) <= 1e-6 * max(1.0, float(
        Tp.abs().max()))
    assert torch.equal(fa, fb) and torch.equal(F2, F9) and torch.equal(T2, T9)
    cap = cfg.tile_cap
    past = torch.arange(cap, device=dev)[None, :] >= cnt.view(-1, 1)
    assert bool((p2.view(-1, cap, 4)[past] == 0).all())


_BOUNDARY_CASES = {
    "walls-lid": dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                      uw_west=0.01),
    "periodic-xy": dict(bc_south="periodic", bc_north="periodic", gx=1e-5),
    "periodic-x-walls-y": dict(uw_south=-0.02),
    "zou-he-walls": dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                         inlet_profile="poiseuille"),
}


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_BOUNDARY_CASES))
def test_push_step_boundary_matrix(dev, case, storage, threads, monkeypatch):
    """K2 (push streaming) on a 240 x 80 lattice, no multiple of the
    32-wide step blocks, at each block size, against its plain version
    on CPU copies; on f32 K8 + K9 against K2 bit for bit."""
    monkeypatch.setattr(fused_lbm, "STEP_THREADS", threads)
    cfg = SimConfig(nx=240, ny=80, tau=0.8, dtype="float32", max_disks=4,
                    window=13, tile_cap=8, f_storage=storage,
                    **_BOUNDARY_CASES[case])
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0],
                      [238.6, 76.2]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002])
    r = torch.tensor([4.0, 4.0, 3.0, 3.5])
    act = torch.ones(4, dtype=torch.bool)
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, cfg)
    if cfg.bc_west == "inlet":
        solid[:, :, 0].zero_()
        solid[:, :, -1].zero_()
    f = lbm.to_storage(_fluid_f(cfg.replace(f_storage="float32"), "cpu", 5),
                       cfg)
    fa = torch.empty_like(f, device=dev)
    dev_in = [t.to(dev) for t in (f, solid, td, cnt)]
    _, pk = fused_lbm.fused_step_imb_reduce(*dev_in, cfg, fa)
    fb, pp = fused_lbm.fused_step_imb_reduce_plain(f, solid, td, cnt, cfg,
                                                   torch.empty_like(f))
    _assert_coupled(cfg, fa, pk, fb, pp, es)
    if storage == "float32":
        fd, sd, tdd, cd = dev_in
        fc = torch.empty_like(fd)
        _, phx, phy = fused_lbm.fused_step_imb(fd, sd[0], sd[1], sd[2], cfg,
                                               fc)
        F9, T9 = stamp.reduce_hydro_forces(
            x.to(dev), r.to(dev), act.to(dev), sd[0], phx, phy, cfg, tdd, cd,
            es.to(dev))
        F2, T2 = stamp.gather_partials(pk, es.to(dev), torch.float32)
        assert torch.equal(fa, fc)
        assert torch.equal(F2, F9) and torch.equal(T2, T9)


# --- the row-sweep temporal block of K6 and K7 against the one-step
# --- kernels, bit for bit


def _chain(step, k, f):
    """k chained step(src, dst) calls from f: (last f, [results])."""
    bufs = (torch.empty_like(f), torch.empty_like(f))
    src, res = f, []
    for s in range(k):
        res.append(step(src, bufs[s % 2]))
        src = bufs[s % 2]
    return src, res


@pytest.mark.parametrize("strip", [(128, 128), (64, 3), (256, 33)],
                         ids=["128-128", "64-3", "256-33"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["walls-gy", "zou-he", "periodic-xy",
                                  "all"])
def test_window_kernel_equals_chained_steps(dev, case, k, strip,
                                            monkeypatch):
    """K6(k) == k chained K2 steps on f32: f' and every inner step's
    partials, torch.equal (one collide and stream rule), at each strip."""
    monkeypatch.setattr(fused_lbm, "MULTI_STRIP", strip)
    cfg, f, solid, td, cnt, _, _ = _breadth_inputs(case, "float32")
    f, solid, td, cnt = (t.to(dev) for t in (f, solid, td, cnt))
    out = torch.empty_like(f)
    _, pk = fused_lbm.fused_step_imb_reduce_multi(f, solid, td, cnt, cfg, k,
                                                  out)
    last, p2 = _chain(lambda s, d: fused_lbm.fused_step_imb_reduce(
        s, solid, td, cnt, cfg, d)[1], k, f)
    assert torch.equal(out, last)
    assert all(torch.equal(pk[t], p2[t]) for t in range(k))
    assert float(p2[-1].abs().max()) > 0


@pytest.mark.parametrize("shape", [(256, 64), (240, 80), (96, 64)])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["walls-gx", "zou-he", "trt-les-lambda",
                                  "periodic"])
def test_static_kernel_equals_chained_steps(dev, case, k, shape):
    """K7(k) == k chained K8 steps on f32 (torch.equal), on lattices that
    are and are not multiples of a strip and one smaller than a strip.
    The solid stack is stamped as the static hoist stamps it (margin 0):
    240 x 80 is in the Verlet margin gap, where Simulation refuses the
    kernel path."""
    kw = {"walls-gx": dict(bc_west="wall", bc_east="wall", gx=1e-5),
          "zou-he": dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                         inlet_profile="poiseuille"),
          "trt-les-lambda": dict(collision="trt", smagorinsky=0.16,
                                 nt_mode="lambda", gx=1e-5),
          "periodic": dict(bc_south="periodic", bc_north="periodic",
                           gy=-1e-5)}[case]
    nx, ny = shape
    cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype="float32", **kw)
    obstacles = [DiskSpec(d.x * nx / 256, d.y * ny / 64, d.r, fixed=True)
                 for d in _obstacles()]
    cfg, _ = derive_config(cfg, obstacles)
    solid = static_solid_stack(cfg, make_disk_state(obstacles, cfg,
                                                    device=dev))
    assert float(solid[0].max()) > 0
    f = _fluid_f(cfg, dev, 11)
    out = torch.empty_like(f)
    fused_static.fused_step_imb_static_multi(f, solid, cfg, k, out)
    last, _ = _chain(lambda s, d: fused_lbm.fused_step_imb(
        s, solid[0], solid[1], solid[2], cfg, d), k, f)
    assert torch.equal(out, last)
    assert float((out - f).abs().max()) > 0


# --- K5 on the row sweep against K4, and the one-launch K3 / K3w


_FLUID_CASES = {
    "periodic-x-forcing": dict(gx=1e-5, gy=-2e-5),
    "walls-lid": dict(bc_west="wall", bc_east="wall", uw_north=0.08),
    "periodic": dict(bc_south="periodic", bc_north="periodic", gx=1e-5),
    "trt-les": dict(collision="trt", smagorinsky=0.16, gx=1e-5),
    "zou-he": dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                   inlet_profile="poiseuille"),
    "zou-he-periodic-y": dict(bc_west="inlet", bc_east="outlet",
                              u_inlet=0.06, bc_south="periodic",
                              bc_north="periodic"),
}


@pytest.mark.parametrize("shape", [(256, 64), (240, 80), (24, 6)],
                         ids=["256x64", "240x80", "24x6"])
@pytest.mark.parametrize("case", sorted(_FLUID_CASES))
def test_fluid_multi_equals_chained_steps(dev, case, shape):
    """K5(k) == k chained K4 steps on f32 (torch.equal), k = 2, 4, 7, 8
    (7 and 8: two sweeps through the f32 scratch), on lattices that are
    and are not a multiple of a strip and one smaller than a strip; then
    on bf16 K5 at k = 4, 12 and 16 (three and four sweeps) against its
    plain version (3e-4: one rounding per pass)."""
    nx, ny = shape
    cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype="float32",
                    **_FLUID_CASES[case])
    f = _fluid_f(cfg, dev, 13)
    for k in (2, 4, 7, 8):
        out = torch.empty_like(f)
        n0 = fused_fluid.fused_step_fluid_multi.launches
        fused_fluid.fused_step_fluid_multi(f, cfg, k, out)
        assert fused_fluid.fused_step_fluid_multi.launches == n0 + 1
        last, _ = _chain(lambda s, d: fused_fluid.fused_step_fluid(s, cfg, d),
                         k, f)
        assert torch.equal(out, last), k
        assert float((out - f).abs().max()) > 0
    bcfg = cfg.replace(f_storage="bfloat16")
    g = _fluid_f(bcfg, dev, 14)
    for k in (4, 12, 16):
        a, b = torch.empty_like(g), torch.empty_like(g)
        fused_fluid.fused_step_fluid_multi(g, bcfg, k, a)
        fused_fluid.fused_step_fluid_multi_plain(g, bcfg, k, b)
        assert float((a.float() - b.float()).abs().max()) <= 3e-4, k


def _slab_cases(dev):
    """(name, cfg, grid, axis, slabs, kmax, n_occ, bands, forces3) of K3
    and K3w on the packed 256^2 column (walls; with springs) and of K3 on
    a doubly periodic box (both slab orientations)."""
    out = []
    sim, d = _scene(dev)
    n = d.x.shape[0]
    g = torch.Generator().manual_seed(2)
    fh = (1e-3 * torch.randn((n, 2), generator=g)).to(dev)
    th = (1e-4 * torch.randn((n,), generator=g)).to(dev)
    body = dem.body_forces(d, sim.cfg)
    sl = slab_dem.build_slabs(d, fh, th, body, sim.grid, sim.dem_axis)
    out.append(("K3", sim.cfg, sim.grid, sim.dem_axis, sl[0], *sl[3:6],
                None))
    sw = slab_dem.build_slabs(d, None, None, body, sim.grid, sim.dem_axis,
                              bake_forces=False)
    f3 = slab_dem._force_planes_window(sw[1], [(fh, th)], body,
                                       sw[0].shape)[0]
    out.append(("K3w", sim.cfg, sim.grid, sim.dem_axis, sw[0], *sw[3:6], f3))
    cfg, grid, axis, dk, fh, th = _kt_scene(dev)
    body = dem.body_forces(dk, cfg)
    sl = slab_dem.build_slabs(dk, fh, th, body, grid, axis, kt=True)
    out.append(("K3 kt", cfg, grid, axis, sl[0], *sl[3:6], None))
    sw = slab_dem.build_slabs(dk, None, None, body, grid, axis, kt=True,
                              bake_forces=False)
    f3 = slab_dem._force_planes_window(sw[1], [(fh, th)], body,
                                       sw[0].shape)[0]
    out.append(("K3w kt", cfg, grid, axis, sw[0], *sw[3:6], f3))
    pcfg = SimConfig(nx=128, ny=96, tau=0.8, dtype="float32", max_disks=6,
                     kn=2.0, gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0,
                     n_sub=6, bc_west="periodic", bc_east="periodic",
                     bc_south="periodic", bc_north="periodic")
    specs = [DiskSpec(126.8, 94.5, 3.5, vx=0.03, vy=0.02),
             DiskSpec(2.0, 1.5, 3.5, vx=-0.01),
             DiskSpec(50.0, 50.0, 3.0), DiskSpec(55.5, 52.0, 3.0),
             DiskSpec(127.2, 70.0, 2.5, vx=0.08),
             DiskSpec(30.0, 95.0, 2.5, vy=0.05)]
    pd = dem.make_disk_state(specs, pcfg, device=dev)
    pgrid = dem.DemGrid.build(pcfg, 3.5)
    z2, z1 = torch.zeros((6, 2), device=dev), torch.zeros((6,), device=dev)
    for ax in ("y", "x"):
        sl = slab_dem.build_slabs(pd, z2, z1, dem.body_forces(pd, pcfg),
                                  pgrid, ax)
        out.append((f"K3 periodic {ax}", pcfg, pgrid, ax, sl[0], *sl[3:6],
                    None))
    return out


def _slab_call(case, s=None):
    """K3 or K3w of a _slab_cases case on `s` (a copy of its slabs)."""
    name, cfg, grid, axis, slabs, kmax, n_occ, bands, f3 = case
    s = slabs.clone() if s is None else s
    if f3 is None:
        return slab_dem.subcycle_slabs(s, kmax, n_occ, bands, grid, cfg,
                                       axis)
    return slab_dem.subcycle_slabs_window(s, f3, kmax, n_occ, bands, grid,
                                          cfg, axis)


@pytest.mark.parametrize("cap", [1, 3, 7])
def test_slab_kernel_capped_grid_matches(dev, cap, monkeypatch):
    """K3 and K3w with the cooperative grid capped to `cap` blocks, so each
    block strides over several tiles: every slab channel and the contact
    count equal to the uncapped launch bit for bit, and against the plain
    version at the bars of the uncapped kernel (walls and periodic axes
    2e-5, springs 3e-5; contacts equal)."""
    for case in _slab_cases(dev):
        name, cfg, grid, axis, slabs, kmax, n_occ, bands, f3 = case
        ref, ncr = _slab_call(case)
        monkeypatch.setattr(slab_dem, "GRID_CAP", cap)
        got, ncg = _slab_call(case)
        monkeypatch.setattr(slab_dem, "GRID_CAP", 0)
        tiles = -(-slabs.shape[3] // 32) * int(n_occ) * slab_dem.SLAB_K
        assert tiles > cap, name
        assert torch.equal(got, ref) and int(ncg) == int(ncr), name
        sp, ncp = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg, grid, axis,
                                                f3)
        _assert_slabs(got, sp, ncg, ncp, 3e-5 if cfg.kt > 0 else 2e-5)


def test_slab_kernel_is_one_launch(dev):
    """One K3 or K3w call is one CUDA kernel launch, the contact count
    included, and enqueues no other device operation (a CUDA graph
    capture of one call, counted by node type)."""
    from lbmdem_tpu_torch import kernels

    for case in _slab_cases(dev)[:2]:
        s = case[4].clone()
        _slab_call(case, s)
        ops = kernels.captured_launches(lambda c=case, t=s: _slab_call(c, t))
        assert ops == {"kernel": 1, "memcpy": 0, "memset": 0}, (case[0], ops)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_prehalo_kernels_match_plain(dev, mode):
    """K4, K5 (k = 4, edge flags) and K2 on a pre-haloed 256 x 128 shard
    (the lattice mesh) against their plain versions on the same card
    input, at the bars above."""
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.parallel._kernel_step import _Sharded, exchange

    w = torch.as_tensor(lattice.W, dtype=torch.float32, device=dev)
    for kw in (dict(bc_west="wall", bc_east="wall", uw_north=0.05, gy=-1e-5),
               dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")):
        cfg = SimConfig(nx=128, ny=256, tau=0.7, dtype="float32", **kw)
        g = torch.Generator(device=dev).manual_seed(3)
        f = w[:, None, None] * (1.0 + 0.05 * torch.randn(
            fused_fluid.frame_shape(cfg, mode), generator=g, device=dev))
        a = torch.empty((9, 256, 128), device=dev)
        b = torch.empty_like(a)
        fused_fluid.fused_step_fluid(f, cfg, a, prehalo=mode)
        fused_fluid.fused_step_fluid_prehalo_plain(f, cfg, mode, b)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        for edges in ((1, 1, 1, 1, 0), (0, 1, 0, 1, 768), (0, 0, 1, 0, 256)):
            if mode == "y":  # a "y" shard spans the width
                edges = edges[:2] + (1, 1) + edges[4:]
            fused_fluid.fused_step_fluid_multi(f, cfg, 4, a, prehalo=mode,
                                               edges=edges, ny_glob=1024)
            fused_fluid.fused_step_fluid_multi_prehalo_plain(
                f, cfg, 4, mode, edges, 1024, b)
            atol = 2e-6 if cfg.bc_west == "inlet" else 5e-7
            torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
    cfg, disks = column_collapse(nx=512, ny=512, n_disks=240)
    disks = [DiskSpec(d.x * 0.94, d.y * 0.94, d.r) for d in disks]
    dims = (2, 2) if mode == "yx" else (4, 1)
    mesh = make_mesh([dev] * 4, dims)
    sim = Simulation(cfg, disks, mesh=mesh)
    parts = _Sharded(sim.cfg, sim.grid, mesh, sim.dem_axis, sim.dem_mode)
    d = sim._state.disks[0]
    frames = exchange(sim._state.f, mesh)
    for p, iy, ix in mesh.positions():
        entries, _, td, cnt, s_k, _ = parts.shard_inputs(
            iy, ix, (d.x, d.v, d.omega, d.r, d.active))
        lc = parts.local_cfg
        a = torch.empty((9, lc.ny, lc.nx), device=dev)
        b = torch.empty_like(a)
        origin = parts.interior_origin(iy, ix)
        _, pk = fused_lbm.fused_step_imb_reduce(frames[p], s_k, td, cnt, lc,
                                                a, prehalo=mode,
                                                origin=origin)
        _, pp = fused_lbm.fused_step_imb_reduce_prehalo_plain(
            frames[p], s_k, td, cnt, lc, mode, origin, b)
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6)
        F, _ = stamp.gather_partials(pk, entries, torch.float32)
        Fp, _ = stamp.gather_partials(pp, entries, torch.float32)
        scale = max(float(Fp.abs().max()), 1e-30)
        assert float((F - Fp).abs().max()) <= 1e-6 * scale


def test_mesh_runs_on_one_card(dev):
    """A 2 x 2 mesh whose shards share the card: the coupled run(11) and
    the fluid run(9) against one device (f 5e-6, x 1e-5, v 1e-6), through
    the pre-haloed kernels."""
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    mesh = make_mesh([dev] * 4, (2, 2))
    one = Simulation(cfg, disks, device=dev)
    sh = Simulation(cfg, disks, mesh=mesh)
    n2 = fused_lbm.fused_step_imb_reduce.launches
    one.run(11)
    sh.run(11)
    assert fused_lbm.fused_step_imb_reduce.launches - n2 == 11 + 44
    a, b = one.state, sh.state
    torch.testing.assert_close(b.f, a.f, rtol=0, atol=5e-6)
    torch.testing.assert_close(b.disks.x, a.disks.x, rtol=0, atol=1e-5)
    torch.testing.assert_close(b.disks.v, a.disks.v, rtol=0, atol=1e-6)
    fcfg = SimConfig(nx=512, ny=256, tau=0.8, gx=1e-6, dtype="float32")
    one = Simulation(fcfg, device=dev)
    sh = Simulation(fcfg, mesh=mesh)
    one.run(9)
    sh.run(9)
    torch.testing.assert_close(sh.state.f, one.state.f, rtol=0, atol=1e-7)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_prehalo_window_kernels_match_plain(dev, mode):
    """K6 and K7 (k = 2 and 4, the edge flags of corner, edge and
    interior shards, walls and Zou/He) and K8 on pre-haloed shards of a
    512^2 column collapse (the lattice mesh's window and static paths)
    against their plain versions on CPU copies of the inputs: K6 f' 5e-6
    and forces 1e-6 of the largest |F| per inner step, K7 rtol 1e-5 /
    atol 2e-6, K8 f' rtol 1e-6 / atol 1e-7 and phi rtol 1e-5 / atol
    5e-8."""
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.parallel._kernel_step import _Sharded, exchange

    cpu = torch.device("cpu")
    cfg, disks = column_collapse(nx=512, ny=512, n_disks=240)
    disks = [DiskSpec(d.x * 0.94, d.y * 0.94, d.r) for d in disks]
    dims = (2, 2) if mode == "yx" else (4, 1)
    mesh = make_mesh([dev] * 4, dims)
    for kw in (dict(), dict(bc_west="inlet", bc_east="outlet",
                            u_inlet=0.04, inlet_profile="poiseuille")):
        sim = Simulation(cfg.replace(**kw), disks, mesh=mesh)
        parts = _Sharded(sim.cfg, sim.grid, mesh, sim.dem_axis, sim.dem_mode)
        lc = parts.local_cfg
        d = sim._state.disks[0]
        g = torch.Generator(device=dev).manual_seed(5)
        fs = [f * (1.0 + 0.02 * torch.randn(f.shape, generator=g,
                                             device=dev))
              for f in sim._state.f]
        frames = exchange(fs, mesh)
        for p, iy, ix in mesh.positions():
            entries, _, td, cnt, s_k, _ = parts.shard_inputs(
                iy, ix, (d.x, d.v, d.omega, d.r, d.active))
            origin, edges = parts.interior_origin(iy, ix), parts.edges[p]
            c = [t.to(cpu) for t in (frames[p], s_k, td, cnt)]
            a = torch.empty((9, lc.ny, lc.nx), device=dev)
            b = torch.empty((9, lc.ny, lc.nx))
            for k in (2, 4):
                _, pk = fused_lbm.fused_step_imb_reduce_multi(
                    frames[p], s_k, td, cnt, lc, k, a, prehalo=mode,
                    origin=origin, edges=edges, ny_glob=sim.cfg.ny)
                _, pp = fused_lbm.fused_step_imb_reduce_multi(
                    *c, lc, k, b, prehalo=mode, origin=origin, edges=edges,
                    ny_glob=sim.cfg.ny)
                torch.testing.assert_close(a.cpu(), b, rtol=0, atol=5e-6)
                for t in range(k):
                    F, _ = stamp.gather_partials(pk[t], entries,
                                                 torch.float32)
                    Fp, _ = stamp.gather_partials(pp[t].to(dev), entries,
                                                  torch.float32)
                    scale = max(float(Fp.abs().max()), 1e-30)
                    assert float((F - Fp).abs().max()) <= 1e-6 * scale
                fused_static.fused_step_imb_static_multi(
                    frames[p], s_k, lc, k, a, prehalo=mode, edges=edges,
                    ny_glob=sim.cfg.ny)
                fused_static.fused_step_imb_static_multi(
                    c[0], c[1], lc, k, b, prehalo=mode, edges=edges,
                    ny_glob=sim.cfg.ny)
                torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=2e-6)
        _, px, py = fused_lbm.fused_step_imb(frames[p], s_k[0], s_k[1],
                                             s_k[2], lc, a, prehalo=mode)
        _, qx, qy = fused_lbm.fused_step_imb(c[0], c[1][0], c[1][1],
                                             c[1][2], lc, b, prehalo=mode)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(px.cpu(), qx, rtol=1e-5, atol=5e-8)
        torch.testing.assert_close(py.cpu(), qy, rtol=1e-5, atol=5e-8)


def test_mesh_window_and_static_on_one_card(dev):
    """A 2 x 2 mesh whose shards share the card: the coupling_k = 4 run(11)
    (K1 and K6 pre-haloed per window and shard) at the chunk bars (f
    5e-6, x 1e-5, v 1e-6), and the static hoist's run(7) (K7 pre-haloed:
    one pass of 4 and 3 of 1 per shard) within 2e-6 with disk x equal,
    against one device."""
    from lbmdem_tpu_torch.parallel import make_mesh

    mesh = make_mesh([dev] * 4, (2, 2))
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    cfg = cfg.replace(coupling_k=4)
    one = Simulation(cfg, disks, device=dev)
    sh = Simulation(cfg, disks, mesh=mesh)
    one.run(11)
    n6 = fused_lbm.fused_step_imb_reduce_multi.launches
    sh.run(11)
    assert fused_lbm.fused_step_imb_reduce_multi.launches - n6 == 2 * 4
    torch.testing.assert_close(sh.state.f, one.state.f, rtol=0, atol=5e-6)
    torch.testing.assert_close(sh.state.disks.x, one.state.disks.x, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(sh.state.disks.v, one.state.disks.v, rtol=0,
                               atol=1e-6)
    scfg, sdisks = porous_bed(nx=256, ny=256, pitch=32, r=6.0)
    one = Simulation(scfg, sdisks, device=dev)
    sh = Simulation(scfg, sdisks, mesh=mesh)
    one.run(7)
    n7 = fused_static.fused_step_imb_static_multi.launches
    sh.run(7)
    assert fused_static.fused_step_imb_static_multi.launches - n7 == 4 * 4
    torch.testing.assert_close(sh.state.f, one.state.f, rtol=0, atol=2e-6)
    assert torch.equal(sh.state.disks.x, one.state.disks.x)


def _bf16_frames(sim, mesh, dev, seed):
    """The mesh's bf16 pre-collision frames of f perturbed in its physical
    form (bf16 at rest stores 0), 16 halo rows."""
    from lbmdem_tpu_torch.parallel._kernel_step import exchange

    g = torch.Generator(device=dev).manual_seed(seed)
    fs = [lbm.to_storage(lbm.from_storage(f, sim.cfg) * (1.0 + 0.02 * torch.randn(
        f.shape, generator=g, device=dev)), sim.cfg) for f in sim._state.f]
    return exchange(fs, mesh)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_prehalo_deep_k5_matches_plain(dev, mode):
    """K5 on frames deeper than one sweep (f32 k = 5 and 8, bf16 k = 8 and
    16: two to four sweeps through f32 scratch frames) on a 256 x 128
    shard with walls and with Zou/He, corner and interior edge flags,
    against its plain version on the card (K5's bars, bf16 3e-4); and on
    a fully periodic 512 x 256 lattice whose shard frames are filled
    from the lattice, equal to the halo-free K5(k) on the shards' rows
    (torch.equal)."""
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device=dev)
    for storage, ks in (("float32", (5, 8)), ("bfloat16", (8, 16))):
        for kw in (dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                        gy=-1e-5),
                   dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                        inlet_profile="poiseuille")):
            cfg = SimConfig(nx=128, ny=256, tau=0.7, dtype="float32",
                            f_storage=storage, **kw)
            g = torch.Generator(device=dev).manual_seed(5)
            f = lbm.to_storage(w[:, None, None] * (1.0 + 0.05 * torch.randn(
                fused_fluid.frame_shape(cfg, mode), generator=g,
                device=dev)), cfg)
            a = torch.empty((9, 256, 128), dtype=f.dtype, device=dev)
            b = torch.empty_like(a)
            for edges in ((1, 1, 1, 1, 0), (0, 0, 1, 0, 256)):
                if mode == "y":  # a "y" shard spans the width
                    edges = edges[:2] + (1, 1) + edges[4:]
                for k in ks:
                    n0 = fused_fluid.fused_step_fluid_multi.launches
                    fused_fluid.fused_step_fluid_multi(
                        f, cfg, k, a, prehalo=mode, edges=edges, ny_glob=1024)
                    assert fused_fluid.fused_step_fluid_multi.launches == n0 + 1
                    fused_fluid.fused_step_fluid_multi_prehalo_plain(
                        f, cfg, k, mode, edges, 1024, b)
                    if storage == "bfloat16":
                        torch.testing.assert_close(a.float(), b.float(),
                                                   rtol=0, atol=3e-4)
                    else:
                        atol = 2e-6 if cfg.bc_west == "inlet" else 5e-7
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=atol)
        dims = (2, 2) if mode == "yx" else (2, 1)
        ny, nx = 256 * dims[0], 128 * dims[1]
        cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype="float32", gx=1e-5,
                        bc_west="periodic", bc_east="periodic",
                        bc_south="periodic", bc_north="periodic",
                        f_storage=storage)
        g = torch.Generator(device=dev).manual_seed(6)
        f = lbm.to_storage(w[:, None, None] * (1.0 + 0.05 * torch.randn(
            (9, ny, nx), generator=g, device=dev)), cfg)
        lc = cfg.replace(ny=256, nx=128)
        hy = fused_fluid.frame_hy(lc)
        hx = fused_fluid.HX if mode == "yx" else 0
        for k in ks:
            ref = torch.empty_like(f)
            fused_fluid.fused_step_fluid_multi(f, cfg, k, ref)
            for iy in range(dims[0]):
                for ix in range(dims[1]):
                    rows = (torch.arange(-hy, 256 + hy, device=dev)
                            + iy * 256) % ny
                    cols = (torch.arange(-hx, 128 + hx, device=dev)
                            + ix * 128) % nx
                    fr = f[:, rows][:, :, cols].contiguous()
                    out = torch.empty((9, 256, 128), dtype=f.dtype,
                                      device=dev)
                    fused_fluid.fused_step_fluid_multi(
                        fr, lc, k, out, prehalo=mode,
                        edges=(0, 0, int(mode == "y"), int(mode == "y"),
                               iy * 256), ny_glob=ny)
                    assert torch.equal(out, ref[:, iy * 256:(iy + 1) * 256,
                                                ix * 128:(ix + 1) * 128]), (
                        storage, k, iy, ix)


@pytest.mark.parametrize("mode", ["y", "yx"])
def test_prehalo_bf16_kernels_match_plain(dev, mode):
    """The five pre-haloed kernels on bf16 frames (16 halo rows, the solid
    window 8) against their plain versions at the bf16 bars (f' 3e-4,
    forces 5e-6 of the largest |F|): K4 and K5 (k = 1, 2, 4, corner, edge
    and interior edge flags) on a 256 x 128 shard with walls and with
    Zou/He, the plain versions on the card; K2, K6 (k = 2, 4) and K7 (k =
    2, 4) on every shard of a 512^2 column collapse whose disks move at
    seeded velocities (the forces' scale of the bar; chip_smoke.py phase
    41's inputs), the plain versions on CPU copies of the inputs (the
    card's multiplies by 1/tau)."""
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.parallel._kernel_step import _Sharded

    w = torch.as_tensor(lattice.W, dtype=torch.float32, device=dev)
    for kw in (dict(bc_west="wall", bc_east="wall", uw_north=0.05, gy=-1e-5),
               dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")):
        cfg = SimConfig(nx=128, ny=256, tau=0.7, dtype="float32",
                        f_storage="bfloat16", **kw)
        g = torch.Generator(device=dev).manual_seed(3)
        f = lbm.to_storage(w[:, None, None] * (1.0 + 0.05 * torch.randn(
            fused_fluid.frame_shape(cfg, mode), generator=g, device=dev)), cfg)
        assert f.shape[1] == 256 + 32
        a = torch.empty((9, 256, 128), dtype=torch.bfloat16, device=dev)
        b = torch.empty_like(a)
        fused_fluid.fused_step_fluid(f, cfg, a, prehalo=mode)
        fused_fluid.fused_step_fluid_prehalo_plain(f, cfg, mode, b)
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=3e-4)
        for edges in ((1, 1, 1, 1, 0), (0, 1, 0, 1, 768), (0, 0, 1, 0, 256)):
            if mode == "y":  # a "y" shard spans the width
                edges = edges[:2] + (1, 1) + edges[4:]
            for k in (1, 2, 4):
                fused_fluid.fused_step_fluid_multi(f, cfg, k, a, prehalo=mode,
                                                   edges=edges, ny_glob=1024)
                fused_fluid.fused_step_fluid_multi_prehalo_plain(
                    f, cfg, k, mode, edges, 1024, b)
                torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                           atol=3e-4)
    cfg, disks = column_collapse(nx=512, ny=512, n_disks=240)
    disks = [DiskSpec(d.x * 0.94, d.y * 0.94, d.r) for d in disks]
    dims = (2, 2) if mode == "yx" else (4, 1)
    mesh = make_mesh([dev] * 4, dims)
    sim = Simulation(cfg.replace(f_storage="bfloat16"), disks, mesh=mesh)
    parts = _Sharded(sim.cfg, sim.grid, mesh, sim.dem_axis, sim.dem_mode)
    lc = parts.local_cfg
    d = sim._state.disks[0]
    rng = np.random.default_rng(6)
    n = d.x.shape[0]
    v = torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                        device=dev)
    om = torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32,
                         device=dev)
    frames = _bf16_frames(sim, mesh, dev, 4)
    cpu = torch.device("cpu")
    for p, iy, ix in mesh.positions():
        entries, _, td, cnt, s_k, _ = parts.shard_inputs(
            iy, ix, (d.x, v, om, d.r, d.active))
        origin, edges = parts.interior_origin(iy, ix), parts.edges[p]
        c = [t.to(cpu) for t in (frames[p], s_k, td, cnt)]
        a = torch.empty((9, lc.ny, lc.nx), dtype=torch.bfloat16, device=dev)
        b = torch.empty((9, lc.ny, lc.nx), dtype=torch.bfloat16)
        _, pk = fused_lbm.fused_step_imb_reduce(frames[p], s_k, td, cnt, lc,
                                                a, prehalo=mode,
                                                origin=origin)
        _, pp = fused_lbm.fused_step_imb_reduce(*c, lc, b, prehalo=mode,
                                                origin=origin)
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=0,
                                   atol=3e-4)
        pks, pps = [pk], [pp]
        for k in (2, 4):
            _, pk = fused_lbm.fused_step_imb_reduce_multi(
                frames[p], s_k, td, cnt, lc, k, a, prehalo=mode,
                origin=origin, edges=edges, ny_glob=sim.cfg.ny)
            _, pp = fused_lbm.fused_step_imb_reduce_multi(
                *c, lc, k, b, prehalo=mode, origin=origin, edges=edges,
                ny_glob=sim.cfg.ny)
            torch.testing.assert_close(a.cpu().float(), b.float(), rtol=0,
                                       atol=3e-4)
            pks += list(pk)
            pps += list(pp)
            fused_static.fused_step_imb_static_multi(
                frames[p], s_k, lc, k, a, prehalo=mode, edges=edges,
                ny_glob=sim.cfg.ny)
            fused_static.fused_step_imb_static_multi(
                c[0], c[1], lc, k, b, prehalo=mode, edges=edges,
                ny_glob=sim.cfg.ny)
            torch.testing.assert_close(a.cpu().float(), b.float(), rtol=0,
                                       atol=3e-4)
        for x, y in zip(pks, pps):
            F, _ = stamp.gather_partials(x, entries, torch.float32)
            Fp, _ = stamp.gather_partials(y.to(dev), entries, torch.float32)
            scale = max(float(Fp.abs().max()), 1e-30)
            assert float((F - Fp).abs().max()) <= 5e-6 * scale


def test_prehalo_bf16_kernels_equal_halo_free(dev):
    """On a fully periodic bf16 lattice whose 2 x 2 shard frames are
    filled from the lattice itself (f rows -16 .. h + 15, the solid
    window's -8 .. h + 7), K4, K5 (k = 2), K2, K6 (k = 4) and K7 (k = 4)
    pre-haloed equal the halo-free bf16 kernels on the shards' rows, f'
    and partials, by torch.equal: both round once per pass."""
    cfg = SimConfig(nx=256, ny=512, tau=0.8, dtype="float32", gx=1e-5,
                    f_storage="bfloat16", bc_west="periodic",
                    bc_east="periodic", bc_south="periodic",
                    bc_north="periodic")
    rng = np.random.default_rng(9)
    disks = [DiskSpec(x + rng.uniform(-8, 8), y + rng.uniform(-8, 8), 3.0,
                      *rng.uniform(-0.02, 0.02, 2))
             for y in range(20, 512, 40) for x in range(20, 256, 40)]
    sim = Simulation(cfg, disks, device=dev)
    cfg, d = sim.cfg, sim.state.disks
    _, aug, _, _, _ = imb.periodic_ghosts(d.x, d.v, d.omega, d.r, d.active,
                                          cfg)
    td, cnt, _, bovf = stamp.bin_disks_to_tiles(*aug, cfg)
    assert int(bovf) == 0
    solid = stamp.stamp_fields(td, cnt, cfg)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(10)
    f = lbm.to_storage(w[:, None, None] * (1.0 + 0.05 * torch.randn(
        (9, 512, 256), generator=g, device=dev)), cfg)
    h, wd = 256, 128
    lc = cfg.replace(ny=h, nx=wd)
    th, tw = stamp.tile_dims(cfg)
    cap, nty, ntx = cfg.tile_cap, 512 // th, 256 // tw
    ref = {}
    for kern, k in (("K4", 1), ("K5", 2), ("K2", 1), ("K6", 4), ("K7", 4)):
        a = torch.empty_like(f)
        pa = None
        if kern in ("K4", "K5"):
            fused_fluid.fused_step_fluid_multi(f, cfg, k, a)
        elif kern == "K2":
            _, pa = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, cfg, a)
            pa = pa[None]
        elif kern == "K6":
            _, pa = fused_lbm.fused_step_imb_reduce_multi(f, solid, td, cnt,
                                                          cfg, k, a)
        else:
            fused_static.fused_step_imb_static_multi(f, solid, cfg, k, a)
        ref[kern] = (k, a, pa)
    for iy in range(2):
        for ix in range(2):
            cols = (torch.arange(-128, wd + 128, device=dev) + ix * wd) % 256
            frows = (torch.arange(-16, h + 16, device=dev) + iy * h) % 512
            srows = (torch.arange(-8, h + 8, device=dev) + iy * h) % 512
            fr = f[:, frows][:, :, cols].contiguous()
            sw = solid[:, srows][:, :, cols].contiguous()
            tiles = (slice(iy * h // th, (iy + 1) * h // th),
                     slice(ix * wd // tw, (ix + 1) * wd // tw))
            td_i = td.reshape(nty, ntx, -1)[tiles].reshape(
                -1, 1, cap * 8).contiguous()
            cnt_i = cnt.reshape(nty, ntx)[tiles].reshape(-1, 1, 1).contiguous()
            edges, origin = (0, 0, 0, 0, iy * h), (iy * h, ix * wd)
            for kern, (k, a, pa) in ref.items():
                b = torch.empty((9, h, wd), dtype=torch.bfloat16, device=dev)
                pb = None
                if kern == "K4":
                    fused_fluid.fused_step_fluid(fr, lc, b, prehalo="yx")
                elif kern == "K5":
                    fused_fluid.fused_step_fluid_multi(
                        fr, lc, k, b, prehalo="yx", edges=edges, ny_glob=512)
                elif kern == "K2":
                    _, pb = fused_lbm.fused_step_imb_reduce(
                        fr, sw, td_i, cnt_i, lc, b, prehalo="yx",
                        origin=origin)
                    pb = pb[None]
                elif kern == "K6":
                    _, pb = fused_lbm.fused_step_imb_reduce_multi(
                        fr, sw, td_i, cnt_i, lc, k, b, prehalo="yx",
                        origin=origin, edges=edges, ny_glob=512)
                else:
                    fused_static.fused_step_imb_static_multi(
                        fr, sw, lc, k, b, prehalo="yx", edges=edges,
                        ny_glob=512)
                assert torch.equal(b, a[:, iy * h:(iy + 1) * h,
                                        ix * wd:(ix + 1) * wd]), (kern, iy, ix)
                if pb is not None:
                    want = pa.reshape(-1, nty, ntx, cap, 4)[
                        :, tiles[0], tiles[1]].reshape(pb.shape)
                    assert torch.equal(pb, want), (kern, iy, ix)


def test_mesh_bf16_on_one_card(dev):
    """A 2 x 2 bf16 mesh whose shards share the card against one device:
    the fluid run(9) (two K5 blocks, one K4 step with the fixups) within
    one bf16 ulp (rtol 1e-2, atol 1e-6), the coupled run(11) at f 3e-4,
    x 1e-5, v 1e-6."""
    from lbmdem_tpu_torch.parallel import make_mesh

    mesh = make_mesh([dev] * 4, (2, 2))
    fcfg = SimConfig(nx=512, ny=256, tau=0.8, gx=1e-6, dtype="float32",
                     f_storage="bfloat16")
    one = Simulation(fcfg, device=dev)
    sh = Simulation(fcfg, mesh=mesh)
    one.run(9)
    sh.run(9)
    assert sh.state.f.dtype == torch.bfloat16
    torch.testing.assert_close(sh.state.f.float(), one.state.f.float(),
                               rtol=1e-2, atol=1e-6)
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    cfg = cfg.replace(f_storage="bfloat16")
    one = Simulation(cfg, disks, device=dev)
    sh = Simulation(cfg, disks, mesh=mesh)
    one.run(11)
    sh.run(11)
    torch.testing.assert_close(sh.state.f.float(), one.state.f.float(),
                               rtol=0, atol=3e-4)
    torch.testing.assert_close(sh.state.disks.x, one.state.disks.x, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(sh.state.disks.v, one.state.disks.v, rtol=0,
                               atol=1e-6)


TRT_CASES = {
    "trt": dict(collision="trt", gy=-1e-5, bc_west="wall", bc_east="wall"),
    "trt-les": dict(collision="trt", smagorinsky=0.16, gx=1e-5),
    "all": dict(collision="trt", smagorinsky=0.16, nt_mode="lambda",
                gx=1e-5, gy=-1e-5, uw_north=0.03, bc_west="inlet",
                bc_east="outlet", u_inlet=0.05, inlet_profile="poiseuille")}


def _trt_same(a, b, storage, what):
    """f32: torch.equal; bf16: within 3e-4 (the plain versions compute
    in the physical form, the kernels in the shifted one)."""
    if storage == "float32":
        assert torch.equal(a, b), (what, float((a - b).abs().max()))
    else:
        err = float((a.float() - b.float()).abs().max())
        assert err <= 3e-4, (what, err)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", sorted(TRT_CASES))
def test_coupled_trt_kernels_match_pair_plain(dev, opt, storage):
    """The TRT instantiations of K2, K6 and K7 (k = 1, 4, 8) and K8 (f32),
    which collide in the pair form, against their plain versions
    (fused_fluid.collide_imb_pairs) on the same card input at 256x64
    with five moving disks: f' (and K2/K6's partials, K8's phi) equal
    under torch.equal on f32, f' within 3e-4 on bf16; K7 on "y" and "yx"
    frames with a random solid window and K8 on f32 frames likewise."""
    from lbmdem_tpu_torch.config import window_for_radius

    cfg = SimConfig(nx=256, ny=64, tau=0.8, dtype="float32", max_disks=5,
                    window=window_for_radius(5.0), tile_cap=8,
                    f_storage=storage, **TRT_CASES[opt])
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0],
                      [200.5, 60.2], [240.0, 12.7]], device=dev)
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0],
                      [0.01, 0.01], [0.0, -0.01]], device=dev)
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001], device=dev)
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5], device=dev)
    act = torch.ones(5, dtype=torch.bool, device=dev)
    td, cnt, _, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, cfg)
    if cfg.bc_west == "inlet":
        solid[:, :, 0].zero_()
        solid[:, :, -1].zero_()
    f = _fluid_f(cfg, dev, 17)
    a, b = torch.empty_like(f), torch.empty_like(f)
    _, pa = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, cfg, a)
    _, pb = fused_lbm.fused_step_imb_reduce_plain(f, solid, td, cnt, cfg, b)
    _trt_same(a, b, storage, "K2")
    if storage == "float32":
        assert torch.equal(pa, pb)
    for k in (1, 4, 8):
        _, pa = fused_lbm.fused_step_imb_reduce_multi(f, solid, td, cnt, cfg,
                                                      k, a)
        _, pb = fused_lbm.fused_step_imb_reduce_multi_plain(
            f, solid, td, cnt, cfg, k, b)
        _trt_same(a, b, storage, f"K6 k={k}")
        if storage == "float32":
            assert torch.equal(pa, pb), k
        fused_static.fused_step_imb_static_multi(f, solid, cfg, k, a)
        fused_static.fused_step_imb_static_multi_plain(f, solid, cfg, k, b)
        _trt_same(a, b, storage, f"K7 k={k}")
    if storage == "float32":
        ka = fused_lbm.fused_step_imb(f, *solid, cfg, a)
        kb = fused_lbm.fused_step_imb_plain(f, *solid, cfg, b)
        assert all(map(torch.equal, ka, kb))
    rng = np.random.default_rng(23)
    for mode in ("y", "yx"):
        fr = lbm.to_storage(torch.as_tensor(
            lattice.W[:, None, None] * (1.0 + 0.05 * rng.standard_normal(
                fused_fluid.frame_shape(cfg, mode))),
            dtype=torch.float32, device=dev), cfg)
        sh = fused_fluid.solid_shape(cfg, mode)
        eps = rng.uniform(-0.2, 1.2, sh[1:]) * (rng.uniform(size=sh[1:]) > 0.6)
        sw = torch.as_tensor(np.stack([
            eps, rng.uniform(-0.03, 0.03, sh[1:]),
            rng.uniform(-0.03, 0.03, sh[1:])]), dtype=torch.float32,
            device=dev)
        out_a = torch.empty((9, cfg.ny, cfg.nx), dtype=f.dtype, device=dev)
        out_b = torch.empty_like(out_a)
        edges = (1, 0, 1, 1, 0) if mode == "y" else (0, 1, 0, 1, 192)
        fused_static.fused_step_imb_static_multi(
            fr, sw, cfg, 4, out_a, prehalo=mode, edges=edges, ny_glob=256)
        fused_static.fused_step_imb_static_multi_prehalo_plain(
            fr, sw, cfg, 4, mode, edges, 256, out_b)
        _trt_same(out_a, out_b, storage, f"K7 {mode}")
        if storage == "float32" and cfg.bc_west != "inlet":
            ka = fused_lbm.fused_step_imb(fr, *sw, cfg, out_a, prehalo=mode)
            kb = fused_lbm.fused_step_imb_prehalo_plain(fr, *sw, cfg, mode,
                                                         out_b)
            assert all(map(torch.equal, ka, kb)), mode


# --- the leftover fallback kernel (lbm_dem_leftover) -----------------------

LEFTOVER_CASES = {"walls": {}, "kt": dict(kt=0.5),
                  "periodic": dict(bc_west="periodic", bc_east="periodic"),
                  "window": {}}


def _leftover_scene(dev, case):
    """A 64^2 box with walls (x periodic in "periodic"): disks without a
    slot touching each wall and a corner, one in the open, one fixed with
    a prescribed velocity, beside slotted and inactive disks that the
    fallback leaves alone; seeded hydro forces of 1 step (4 in
    "window"). Returns (cfg, grid, disks, slot, forces, body_f)."""
    kw = dict(bc_west="wall", bc_east="wall", bc_south="wall",
              bc_north="wall")
    kw.update(LEFTOVER_CASES[case])
    cfg = SimConfig(nx=64, ny=64, tau=0.8, dtype="float32", max_disks=12,
                    kn=50.0, gamma_n=2.0, gamma_t=1.0, mu=0.5, rho_s=2.5,
                    n_sub=10, g_py=-1e-3, buoyancy=True, **kw)
    specs = [DiskSpec(0.1, 30.0, 1.0, vx=-0.01),             # west
             DiskSpec(62.8, 20.0, 1.2, vy=0.02),             # east
             DiskSpec(30.0, 0.2, 1.0, omega=0.01),           # south
             DiskSpec(20.0, 62.9, 1.1, vx=0.03),             # north
             DiskSpec(0.3, 0.1, 1.0, vx=-0.02, vy=-0.02),    # a corner
             DiskSpec(32.0, 32.0, 2.0, vx=0.01, omega=-2e-3),
             DiskSpec(10.0, 10.0, 1.0, vx=0.01, fixed=True),
             DiskSpec(0.2, 50.0, 1.0), DiskSpec(40.0, 40.0, 1.0, vy=-0.02)]
    d = make_disk_state(specs, cfg, device=dev)  # the last 3 inactive
    slot = torch.tensor([-1] * 7 + [5, 9] + [-1] * 3, dtype=torch.int32,
                        device=dev)
    rng = np.random.default_rng(5)
    forces = []
    for _ in range(4 if case == "window" else 1):
        # rows [fx, fy, tq, 0] as the hydro reduction leaves them: the
        # kernel reads the views through their strides ("kt": copies)
        rows = torch.as_tensor(rng.uniform(-1e-2, 1e-2, (12, 4)),
                               dtype=torch.float32, device=dev)
        rows[:, 2] *= 0.1
        fh, th = rows[:, :2], rows[:, 2]
        forces.append((fh.contiguous(), th.contiguous()) if case == "kt"
                      else (fh, th))
    return (cfg, dem.DemGrid.build(cfg, 2.0), d, slot, forces,
            dem.body_forces(d, cfg))


def _fresh(d):
    """`d` with fresh x, v, omega, theta (as `_unslab` returns them)."""
    return d._replace(x=d.x.clone(), v=d.v.clone(), omega=d.omega.clone(),
                      theta=d.theta.clone())


@pytest.mark.parametrize("case", sorted(LEFTOVER_CASES))
def test_leftover_kernel_matches_plain(dev, case):
    """The leftover kernel and `leftover_verlet_plain` against the plain
    _fallback_integrate, chained once per step's forces, on the card
    under torch.equal (all take
    the cell-list wall law, d / dist, under --fmad=false), with overflow
    > 0: it adds the steps to fallback_steps, moves every leftover disk
    and no other, and is one CUDA launch with no host read. With overflow
    0 it changes nothing and counts nothing."""
    from lbmdem_tpu_torch import kernels
    from lbmdem_tpu_torch.utils import profiling

    cfg, grid, d, slot, forces, body_f = _leftover_scene(dev, case)
    leftover = d.active & (slot < 0)
    ovf = torch.sum(leftover).to(torch.int32)
    p = d
    for fh, th in forces:
        p = slab_dem._fallback_integrate(p, leftover, fh, th, body_f, cfg)
    want = slab_dem._merge(leftover, p, d)
    c0 = profiling.counters()["fallback_steps"]
    n0 = slab_dem.leftover_verlet.launches
    got = slab_dem.leftover_verlet(_fresh(d), slot, ovf, forces, body_f,
                                   grid, cfg, "y")
    assert slab_dem.leftover_verlet.launches == n0 + 1
    assert profiling.counters()["fallback_steps"] - c0 == len(forces)
    plain = slab_dem.leftover_verlet_plain(_fresh(d), slot, ovf, forces,
                                           body_f, cfg)
    for k in ("x", "v", "omega", "theta"):
        a, b = getattr(got, k), getattr(want, k)
        assert torch.equal(a, b), (case, k, float((a - b).abs().max()))
        assert torch.equal(getattr(plain, k), b), (case, k)
    moved = (got.x != d.x).any(dim=1)
    assert moved[:7].all() and not moved[7:].any(), moved
    new = _fresh(d)
    ops = kernels.captured_launches(lambda: slab_dem.leftover_verlet(
        new, slot, ovf, forces, body_f, grid, cfg, "y"))
    assert ops == {"kernel": 1, "memcpy": 0, "memset": 0}, ops
    c1 = profiling.counters()["fallback_steps"]
    new = _fresh(d)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    slab_dem.leftover_verlet(new, slot, zero, forces, body_f, grid, cfg, "y")
    for k in ("x", "v", "omega", "theta"):
        assert torch.equal(getattr(new, k), getattr(d, k)), k
    assert profiling.counters()["fallback_steps"] == c1


@pytest.mark.parametrize("k", [1, 4])
def test_slab_dem_with_overflow_matches_cpu(dev, k):
    """Five apart disks in one broadphase cell at a wall (K = 4 slots):
    dem_subcycle (k = 1) or a k = 4 window on the card against the CPU,
    the unslotted disk included, at K3's bar (2e-5); overflow 1 on
    both."""
    cfg = SimConfig(nx=128, ny=128, tau=0.8, dtype="float32", max_disks=5,
                    kn=2.0, gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0,
                    n_sub=6, bc_west="wall", bc_east="wall", g_py=-1e-2,
                    buoyancy=False)
    specs = [DiskSpec(5.2 - 1.3 * i, 43.0 + 1.3 * i, 0.6, vx=-0.01 * i)
             for i in range(5)]
    grid = dem.DemGrid.build(cfg, 3.0)
    rng = np.random.default_rng(9)
    forces = [(torch.as_tensor(rng.uniform(-1e-2, 1e-2, (5, 2)),
                               dtype=torch.float32),
               torch.as_tensor(rng.uniform(-1e-3, 1e-3, 5),
                               dtype=torch.float32)) for _ in range(k)]
    out = []
    for device in (dev, "cpu"):
        d = make_disk_state(specs, cfg, device=device)
        fs = [(fh.to(device), th.to(device)) for fh, th in forces]
        if k == 1:
            new, ovf, _ = slab_dem.dem_subcycle(d, *fs[0], grid, cfg, "y")
        else:
            new, ovf, _ = slab_dem.dem_subcycle_window(d, fs, grid, cfg, "y")
        out.append((new, int(ovf), d))
    (a, ovf_a, da), (b, ovf_b, db) = out
    assert ovf_a == ovf_b == 1
    assert not torch.equal(a.x[4].cpu(), da.x[4].cpu())  # it moved
    for name in ("x", "v", "omega", "theta"):
        torch.testing.assert_close(getattr(a, name).cpu(), getattr(b, name),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_coupled_run_waits_once(dev, k):
    """One sim.run(16) of the coupled slice (coupling_k 1 and 4) waits on
    the device once, at its end: the leftover fallback reads overflow on
    the device. fallback_steps stays 0 (every disk slotted)."""
    from lbmdem_tpu_torch.utils import profiling

    sim, _ = _scene(dev, coupling_k=k)
    sim.run(4)
    c0 = profiling.counters()
    sim.run(16)
    c1 = profiling.counters()
    assert c1["syncs"] - c0["syncs"] == 1
    assert c1["fallback_steps"] == c0["fallback_steps"]
    assert int(sim.state.overflow) == 0
