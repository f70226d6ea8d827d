"""The phase order of the one-launch slab DEM (csrc/slab_dem.cu
subcycle_kernel, K3 and K3w), written plainly and held against K3's
plain version `subcycle_slabs_plain` bit for bit.

The kernel runs n_sub + 1 phases with one grid barrier after each but
the last: phase t evaluates every slot's force from state buffer t, then
applies the slot's own second half-kick of substep t - 1 (t > 0) and
first half-kick + drift of substep t (t < n_sub), and writes the five
channels a neighbour reads (x, y, vx, vy, omega) into buffer t + 1.
Buffers 0 and n_sub + 1 are the slabs themselves, the ones between them
two scratch buffers used in turn; theta and the springs stay in place at
their own slot. Only the occupied 8-row bands are walked: the scratch
rows outside them hold poison that no force may read. Over walls, both
wrapped axes, the slim window layout and kt = 0 / 25, in float32 and
float64; one case also against the JAX package's Pallas subcycle in
interpret mode at its bars (2e-5, 3e-5 with springs)."""

import jax
import numpy as np
import pytest
import torch

from lbmdem_tpu.config import DiskSpec as JDisk, SimConfig as JCfg
from lbmdem_tpu.ops import dem as jdem, pallas_dem
from lbmdem_tpu.ops.dem import DemGrid as JGrid
from lbmdem_tpu_torch.config import DiskSpec, SimConfig
from lbmdem_tpu_torch.ops import dem, slab_dem
from lbmdem_tpu_torch.ops.slab_dem import (_MINV, _MINV_SLIM, _NCH_KT, _OM,
                                           _R, _TH, _VX, _VY, _X, _XI0,
                                           _XI0_SLIM, _Y)

from torch_parity_util import jx, npy, to_torch_cfg, to_torch_disks, tt

POISON = 1.0e3  # finite, far from every disk: read only where r = 0


def scheduled(slabs, kmax, n_occ, band_offs, cfg: SimConfig, grid, axis,
              forces3=None):
    """The kernel's phase order on whole planes. Returns (slabs after the
    subcycle, n_contacts () i32)."""
    out = slabs.clone()
    R = out.shape[2]
    ncs, ncl = slab_dem.slab_dims(grid, axis)[:2]
    wrap_s, wrap_l = slab_dem._wrap_sl(grid, axis)
    rows = slice(8, 8 + ncs) if wrap_s else slice(7, R - 7)
    s = out[:, :, rows, :ncl]
    if forces3 is None:
        hyd, ch_minv, xi0 = s[7:10], _MINV, _XI0
    else:
        hyd, ch_minv, xi0 = forces3[:, :, rows, :ncl], _MINV_SLIM, _XI0_SLIM
    if not cfg.kt > 0.0:
        xi0 = None
    # the rows of the occupied bands: the only ones a block walks
    walked = torch.zeros(R, dtype=torch.bool)
    for off in band_offs[:int(n_occ)].tolist():
        walked[off:off + 8] = True
    walked = walked[rows]
    n = cfg.n_sub
    scratch = [torch.full_like(s[:5], POISON) for _ in range(2)]

    def buf(q):
        return s[:5] if q in (0, n + 1) else scratch[q % 2]

    h = float(np.float32(1.0 / n)) if s.dtype == torch.float32 else 1.0 / n
    half_h = 0.5 * h
    r, minv = s[_R], s[ch_minv]
    inv_i = minv * 2.0 / torch.clamp(r * r, min=1e-12)
    a = (r > 0).to(s.dtype)
    nc_max = None
    for ph in range(n + 1):
        src, dst = buf(ph), buf(ph + 1)
        assert src.data_ptr() != dst.data_ptr()
        # the force reads the state from src; r, 1/mass and the springs
        # from the slabs, and writes the springs back at their own slot
        work = torch.cat([src, s[5:]])
        F, nc = slab_dem._force_plain(work, hyd, int(kmax), bool(wrap_l),
                                      cfg, xi0, h if ph else 0.0, ph > 0)
        if xi0 is not None:
            s[xi0:, :, walked] = work[xi0:, :, walked]
        nc_max = nc if nc_max is None else torch.maximum(nc_max, nc)
        x, y, vx, vy, om = src.unbind(0)
        if ph > 0:  # second half-kick of substep ph - 1
            vx = (vx + half_h * F[0] * minv) * a
            vy = (vy + half_h * F[1] * minv) * a
            om = (om + half_h * F[2] * inv_i) * a
        if ph < n:  # first half-kick + drift of substep ph
            vx = vx + half_h * F[0] * minv
            vy = vy + half_h * F[1] * minv
            om = om + half_h * F[2] * inv_i
            x = x + h * vx * a
            y = y + h * vy * a
            th = s[_TH] + h * om * a
            s[_TH][:, walked] = th[:, walked]
        new = torch.stack([x, y, vx, vy, om])
        dst[:, :, walked] = new[:, :, walked]
    return out, (nc_max // 2).to(torch.int32)


def _cluster(cfg: SimConfig, n=22, seed=3):
    rng = np.random.default_rng(seed)
    specs = [DiskSpec(rng.uniform(20, 60), rng.uniform(20, 60), 3.0,
                      rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                      rng.uniform(-0.01, 0.01)) for _ in range(n)]
    specs.append(DiskSpec(2.2, 90.0, 3.0, vx=-0.02))            # west wall
    specs.append(DiskSpec(100.0, cfg.ny - 3.0, 3.0, vy=0.03))   # north wall
    specs.append(DiskSpec(110.0, 30.0, 3.0, fixed=True))        # fixed
    return specs


_WRAP_XY = [DiskSpec(126.8, 94.5, 3.5, vx=0.03, vy=0.02),  # the corner
            DiskSpec(2.0, 1.5, 3.5, vx=-0.01),  # touches it through both
            DiskSpec(50.0, 50.0, 3.0), DiskSpec(55.5, 52.0, 3.0),
            DiskSpec(127.2, 70.0, 2.5, vx=0.08),  # crosses the x seam
            DiskSpec(30.0, 95.0, 2.5, vy=0.05)]   # crosses the y seam

CASES = {
    "walls": lambda: (dict(nx=256, ny=256), _cluster),
    "periodic-xy": lambda: (dict(nx=128, ny=96, g_py=0.0,
                                 bc_west="periodic", bc_east="periodic",
                                 bc_south="periodic", bc_north="periodic"),
                            lambda cfg: _WRAP_XY),
}


def _inputs(case, dtype, kt, axis, slim):
    kw, specs = CASES[case]()
    cfg = SimConfig(tau=0.8, dtype=dtype, max_disks=32, kn=2.0, gamma_n=1.0,
                    gamma_t=0.3, mu=0.4, rho_s=2.0, n_sub=6, kt=kt,
                    g_py=kw.pop("g_py", -1e-4), **kw)
    disks = dem.make_disk_state(specs(cfg), cfg)
    grid = dem.DemGrid.build(cfg, 3.5)
    n = disks.x.shape[0]
    rng = np.random.default_rng(7)
    fh = torch.as_tensor(rng.uniform(-1e-3, 1e-3, (n, 2)), dtype=disks.x.dtype)
    th = torch.as_tensor(rng.uniform(-1e-4, 1e-4, n), dtype=disks.x.dtype)
    body = dem.body_forces(disks, cfg)
    if slim:
        slabs, slot, ovf, kmax, n_occ, bands, _ = slab_dem.build_slabs(
            disks, None, None, body, grid, axis, kt=kt > 0, bake_forces=False)
        f3 = slab_dem._force_planes_window(slot, [(fh, th)], body,
                                           slabs.shape)[0]
    else:
        slabs, slot, ovf, kmax, n_occ, bands, _ = slab_dem.build_slabs(
            disks, fh, th, body, grid, axis, kt=kt > 0)
        f3 = None
    assert int(ovf) == 0
    if case == "walls":  # bands no block walks
        assert int(n_occ) < slab_dem.slab_dims(grid, axis)[4]
    return cfg, grid, slabs, kmax, n_occ, bands, f3


@pytest.mark.parametrize("slim", [False, True], ids=["K3", "K3w"])
@pytest.mark.parametrize("kt", [0.0, 25.0])
@pytest.mark.parametrize("axis", ["y", "x"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_phase_order_equals_plain_bitwise(dtype, case, axis, kt, slim):
    """Two chained subcycles (the second carries the first's springs):
    every slab channel and the contact count under torch.equal."""
    cfg, grid, slabs, kmax, n_occ, bands, f3 = _inputs(case, dtype, kt,
                                                       axis, slim)
    a = b = slabs
    for _ in range(2):
        a, nca = scheduled(a, kmax, n_occ, bands, cfg, grid, axis, f3)
        b, ncb = slab_dem.subcycle_slabs_plain(b, kmax, cfg, grid, axis, f3)
        assert torch.equal(a, b)
        assert int(nca) == int(ncb) > 0
    if kt:
        assert float(b[(_XI0_SLIM if slim else _XI0):].abs().max()) > 0
    moved = (b[_X] - slabs[_X]).abs().max() + (b[_Y] - slabs[_Y]).abs().max()
    assert float(moved) > 0
    assert not bool((b[[_X, _Y, _VX, _VY, _OM]] == POISON).any())


def test_phase_order_matches_pallas_interpret():
    """The phase order through the slab path (build_slabs, the schedule,
    _unslab) against the TPU kernel in interpret mode, on walls with
    springs: x/v/omega/theta within 3e-5, contacts equal."""
    cfg = JCfg(nx=128, ny=128, tau=0.8, dtype="float32", max_disks=25,
               kn=2.0, gamma_n=1.0, gamma_t=0.3, mu=0.4, rho_s=2.0, n_sub=3,
               kt=25.0, bc_west="wall", bc_east="wall", g_py=-1e-4)
    tcfg = to_torch_cfg(cfg)
    specs = [JDisk(**{k: getattr(d, k) for k in
                      ("x", "y", "r", "vx", "vy", "omega", "fixed")})
             for d in _cluster(tcfg)]
    jd = jdem.make_disk_state(specs, cfg, "float32")
    td = dem.make_disk_state(to_torch_disks(specs), tcfg)
    rng = np.random.default_rng(2)
    n = len(specs)
    fh = rng.uniform(-1e-3, 1e-3, (n, 2)).astype(np.float32)
    th = rng.uniform(-1e-4, 1e-4, n).astype(np.float32)
    jg = JGrid.build(cfg, 3.0)
    jn, jovf, jnc = jax.jit(pallas_dem.dem_subcycle,
                            static_argnums=(3, 4, 5))(jd, jx(fh), jx(th), jg,
                                                      cfg, "y")
    grid = dem.DemGrid.build(tcfg, 3.0)
    slabs, slot, ovf, kmax, n_occ, bands, j36 = slab_dem.build_slabs(
        td, tt(fh), tt(th), dem.body_forces(td, tcfg), grid, "y", kt=True)
    assert slabs.shape[0] == _NCH_KT
    out, nc = scheduled(slabs, kmax, n_occ, bands, tcfg, grid, "y")
    tn, tovf = slab_dem._unslab(out, slot, td, tcfg, j36, ovf)
    assert int(jovf) == int(tovf) == 0 and int(jnc) == int(nc) > 0
    for k in ("x", "v", "omega", "theta"):
        np.testing.assert_allclose(np.asarray(getattr(jn, k)),
                                   npy(getattr(tn, k)), rtol=0, atol=3e-5,
                                   err_msg=k)
