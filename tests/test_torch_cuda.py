"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU with nvcc and skips without
one. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bars (the JAX package's own): K1 fields 1e-6; K2 f' 5e-6 and per-disk
forces 1e-6 relative to the largest |F|; K3 x/v/omega 2e-5 with equal
contact counts; a whole run 1e-5 on f and 1e-4 on disk positions."""

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import Simulation
from lbmdem_tpu_torch.config import DiskSpec
from lbmdem_tpu_torch.models import column_collapse
from lbmdem_tpu_torch.ops import dem, fused_lbm, lbm, slab_dem, stamp

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
