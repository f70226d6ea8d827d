"""The sample method's fast path (csrc/coverage.cuh cov_sample_fast)
held against the sample loop on the CPU: wherever the classifier
`ops/stamp.sample_class` calls a cell all-in, the plain coverage
`cov_field` is exactly the full-hit constant, and wherever it calls a
cell all-out, exactly 0, so the kernels that skip the loop there agree
with it bit for bit. Exact equality, in float32, over ~10^6 random and
edge-placed (relx, rely, r) for ns 1-8 with and without eps_r_shift; and
the premise of the fast path, counted from shapes: at r = 8 and ns = 4
under a fifth of a disk's window cells are left to the loop."""

import numpy as np
import pytest
import torch

from lbmdem_tpu_torch import SimConfig
from lbmdem_tpu_torch.config import window_for_radius
from lbmdem_tpu_torch.ops import stamp

# points per (ns, r_shift) case: 16 cases, ~10^6 points in all
N_RANDOM = 48_000
N_EDGE = 15_000


def _points(ns: int, seed: int):
    """(relx, rely, r) float32: random cells around random radii up to 64
    (most near the rim), then edge placements - centres on a fine
    sub-cell grid (cell corners, half-integers, sample offsets) and radii
    whose rim passes exactly through a sample point - and empty slots."""
    rng = np.random.default_rng(seed)
    r = np.exp(rng.uniform(np.log(0.05), np.log(64.0), N_RANDOM))
    ang = rng.uniform(0.0, 2.0 * np.pi, N_RANDOM)
    d = r + rng.uniform(-1.5, 1.5, N_RANDOM)
    relx, rely = d * np.cos(ang), d * np.sin(ang)
    # edge placements: offsets on a 1/(4 ns) grid, a rim through a sample
    grid = np.arange(-4 * ns, 4 * ns + 1) / (4.0 * ns)
    base = rng.integers(-60, 61, (N_EDGE, 2)).astype(np.float64)
    ex = base[:, 0] + rng.choice(grid, N_EDGE)
    ey = base[:, 1] + rng.choice(grid, N_EDGE)
    offs = ((np.arange(ns) + 0.5) / ns - 0.5).astype(np.float32)
    sx = rng.choice(offs, N_EDGE).astype(np.float32)
    sy = rng.choice(offs, N_EDGE).astype(np.float32)
    px = (ex.astype(np.float32) + sx).astype(np.float32)
    py = (ey.astype(np.float32) + sy).astype(np.float32)
    er = np.sqrt(px.astype(np.float64) ** 2 + py.astype(np.float64) ** 2)
    er = np.clip(er, 0.05, 64.0)
    er[::50] = 0.0  # empty slots
    relx = np.concatenate([relx, ex])
    rely = np.concatenate([rely, ey])
    r = np.concatenate([r, er])
    return (torch.as_tensor(a.astype(np.float32)) for a in (relx, rely, r))


@pytest.mark.parametrize("r_shift", [0.0, -0.4])
@pytest.mark.parametrize("ns", list(range(1, 9)))
def test_classifier_agrees_with_the_sample_loop(ns, r_shift):
    relx, rely, r = _points(ns, 100 * ns + int(10 * -r_shift))
    cfg = SimConfig(nx=64, ny=64, eps_samples=ns, eps_r_shift=r_shift)
    cov = stamp.cov_field(relx, rely, r, cfg)
    cls = stamp.sample_class(relx, rely, stamp.shift_radius(r, r_shift), ns)
    full = torch.tensor(stamp.sample_consts(ns)[0])
    inn, out = cls == 1, cls == -1
    assert cov.dtype == torch.float32
    assert torch.equal(cov[inn], full.expand(int(inn.sum())))
    assert torch.equal(cov[out], torch.zeros(int(out.sum())))
    # every class occurs, and the loop keeps the mixed cells
    assert int(inn.sum()) > 0 and int(out.sum()) > 0
    ring = cls == 0
    mixed = (cov > 0) & (cov != full)
    assert bool(ring[mixed].all())


def test_full_hit_constant_is_the_loops_sum():
    """full is what the loop adds up when every sample hits: 1.0 for
    ns = 4, but not for every ns; a disk far larger than the cell hits
    every sample."""
    assert stamp.sample_consts(4)[0] == np.float32(1.0)
    assert stamp.sample_consts(5)[0] != np.float32(1.0)
    for ns in range(1, 9):
        cfg = SimConfig(nx=8, ny=8, eps_samples=ns)
        one = torch.zeros(1)
        cov = stamp.cov_field(one, one, torch.tensor([30.0]), cfg)
        assert float(cov[0]) == float(stamp.sample_consts(ns)[0])


def test_ring_share_under_a_fifth_at_r8():
    """The fast path's premise: over 21 x 21 windows of r = 8 disks at
    random sub-cell centres (ns = 4), the classifier leaves under 20 % of
    the cells to the sample loop."""
    rng = np.random.default_rng(7)
    window = window_for_radius(8.0)
    half = window // 2
    c = rng.uniform(0.0, 1.0, (500, 2)) + 100.0
    b = np.floor(c + 0.5).astype(np.int64) - half
    ar = np.arange(window)
    relx = (b[:, 0, None] + ar).astype(np.float32) - c[:, 0, None].astype(
        np.float32)
    rely = (b[:, 1, None] + ar).astype(np.float32) - c[:, 1, None].astype(
        np.float32)
    relx = torch.as_tensor(relx[:, None, :])
    rely = torch.as_tensor(rely[:, :, None])
    cls = stamp.sample_class(relx, rely, torch.tensor(8.0), 4)
    share = float((cls == 0).float().mean())
    assert 0.0 < share < 0.20, share


def test_plain_square_root_is_correctly_rounded():
    """The ramp and exact plain versions take imb.sqrt_rn, which rounds
    like IEEE sqrt (numpy's, and the kernels' __fsqrt_rn), where the
    CPU's float32 torch.sqrt may be off by one unit in the last place."""
    from lbmdem_tpu_torch.ops import imb

    a = np.random.default_rng(3).uniform(0.0, 9000.0, 200_000).astype(
        np.float32)
    got = imb.sqrt_rn(torch.from_numpy(a))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(a))


def test_plain_reduce_follows_the_kernels_order():
    """stamp.reduce_partials_plain sums each slot in the reduce kernel's
    order (csrc/imb.cuh reduce_kernel: the clipped window's cells dealt
    to 32 lanes, cells with eps_raw <= 0 skipped, a shuffle-down tree),
    so the kernel's partials can equal it bit for bit: held here against
    that loop written out in float32 scalars."""
    rng = np.random.default_rng(5)
    cfg = SimConfig(nx=64, ny=32, tau=0.8, dtype="float32", max_disks=6,
                    window=window_for_radius(4.0), tile_cap=8,
                    bc_west="wall", bc_east="wall")
    x = torch.tensor([[1.3, 2.2], [17.6, 15.9], [31.5, 16.0], [40.2, 30.7],
                      [62.6, 8.1], [50.0, 20.0]])
    v = torch.as_tensor(rng.uniform(-0.01, 0.01, (6, 2)), dtype=torch.float32)
    om = torch.as_tensor(rng.uniform(-1e-3, 1e-3, 6), dtype=torch.float32)
    r = torch.tensor([3.0, 4.0, 2.5, 3.5, 4.0, 3.0])
    act = torch.ones(6, dtype=torch.bool)
    td, cnt, _, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
    assert int(ovf) == 0
    eps = stamp.stamp_fields_plain(td, cnt, cfg)[0]
    w = torch.as_tensor(rng.standard_normal((2, 32, 64)), dtype=torch.float32)
    w = torch.where(eps > 0, w, torch.zeros(()))
    got = stamp.reduce_partials_plain(w, td, cnt, cfg).numpy()
    th, tw = stamp.tile_dims(cfg)
    ntx, cap, half = cfg.nx // tw, cfg.tile_cap, cfg.window // 2
    rec = td.reshape(-1, cap, 8).numpy()
    cov_of = lambda rx, ry, rr: float(stamp.cov_field(  # noqa: E731
        torch.tensor([rx]), torch.tensor([ry]), torch.tensor([rr]), cfg)[0])
    f32 = np.float32
    for tile in range(rec.shape[0]):
        y0, x0 = (tile // ntx) * th, (tile % ntx) * tw
        for slot in range(cap):
            want = np.zeros(3, np.float32)
            if slot < int(cnt.reshape(-1)[tile]):
                px, py, rr = rec[tile, slot, 0], rec[tile, slot, 1], \
                    rec[tile, slot, 5]
                by = int(np.floor(f32(py + f32(0.5)))) - half
                bx = int(np.floor(f32(px + f32(0.5)))) - half
                ya, yb = max(by, y0), min(by + cfg.window, y0 + th)
                xa, xb = max(bx, x0), min(bx + cfg.window, x0 + tw)
                lanes = np.zeros((32, 3), np.float32)
                for c in range(max(yb - ya, 0) * max(xb - xa, 0)):
                    gy, gx = ya + c // (xb - xa), xa + c % (xb - xa)
                    if not eps[gy, gx] > 0:
                        continue
                    rx, ry = f32(f32(gx) - px), f32(f32(gy) - py)
                    cov = f32(cov_of(rx, ry, rr))
                    fx = f32(cov * w[0, gy, gx].item())
                    fy = f32(cov * w[1, gy, gx].item())
                    lanes[c % 32] += np.array(
                        [fx, fy, f32(f32(rx * fy) - f32(ry * fx))], np.float32)
                o = 16
                while o:
                    lanes[:o] = lanes[:o] + lanes[o:2 * o]
                    o //= 2
                want = lanes[0]
            np.testing.assert_array_equal(got[tile * cap + slot, :3], want)
