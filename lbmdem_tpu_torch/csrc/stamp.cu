// K1: solid-fraction stamp from tile-binned disks -> dense (3, ny, nx)
// fields [eps_raw, us_x, us_y].
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_stamp.py:_stamp_kernel
// (entry stamp_solid_fraction). For each stamp tile it walks the tile's
// binned disks in slot order and accumulates cov, cov*us_x and cov*us_y
// (u_s = v + omega x r), then divides u_s by max(eps, eps_min).
//
// What bounds it on the H100: the write of the three f32 planes
// (12 B/cell, 0.2 GB at 4096^2: 0.062 ms) and, under eps_method
// "sample", the ns^2 sample tests of every window cell. Design:
//  - one block of 512 threads per 32 x 16 sub-tile of a stamp tile, one
//    thread per cell, so a 21-wide disk window keeps 21 of a warp's 32
//    lanes busy;
//  - the block first compacts, in slot order, the tile's disks whose
//    window meets its sub-tile into shared memory (a warp ballot and a
//    prefix over the warps' counts, 512 slots per round), so each thread
//    walks the handful of disks near its cell, not the tile's `cnt`;
//  - coverage goes through coverage.cuh's fast path: only the cells
//    whose sample square straddles a rim run the sample loop, which
//    reads its offsets from a per-block table (no float64 divide per
//    sample).
// No atomics and no shared accumulators: each cell's sum runs in slot
// order in its own thread, so eps and u_s equal the plain version's
// (ops/stamp.stamp_fields_plain) bit for bit, for every method.
//
// The lattice's cell (0, 0) sits at (oy, ox) of the frame the disk
// records are in ((0, 0) on one device). A shard of the lattice mesh
// stamps its canvas from records in global coordinates with the
// canvas's global offset as the origin, so every window cell's relative
// coordinate, and so its coverage, is the single-device stamp's bit for
// bit (records shifted into canvas coordinates would round in f32 near
// the low global edges).
#include <cuda_runtime.h>

#include "coverage.cuh"

namespace {

constexpr int kSubX = 32;                     // sub-tile columns (one warp)
constexpr int kSubY = 16;                     // sub-tile rows
constexpr int kThreads = kSubX * kSubY;       // one thread per cell
constexpr int kWarps = kThreads / 32;

// a compacted disk: centre, velocity, spin, shifted radius, window origin
struct Disk {
  float px, py, vx, vy, om, rr;
  int bx, by;
};

// one instantiation per coverage method M (CovMethod)
template <int M>
__global__ void __launch_bounds__(kThreads)
    stamp_kernel(const float* __restrict__ tile_data,
                 const int* __restrict__ counts, float* __restrict__ out,
                 int ny, int nx, int th, int tw, int ntx, int cap, int window,
                 CovParams cp, float eps_min, int oy, int ox) {
  __shared__ Disk disks[kThreads];
  __shared__ int warp_n[kWarps];
  __shared__ SampleTable tab;  // filled before the first barrier
  if (M == kSample) fill_sample_table(&tab, cp.ns);
  const int tile = blockIdx.x;
  const int nsx = (tw + kSubX - 1) / kSubX;
  const int sy0 = (blockIdx.y / nsx) * kSubY;  // sub-tile origin in the tile
  const int sx0 = (blockIdx.y % nsx) * kSubX;
  const int y0 = (tile / ntx) * th + oy, x0 = (tile % ntx) * tw + ox;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = sy0 + warp, col = sx0 + lane;
  const bool mine = row < th && col < tw;
  const int gy = y0 + row, gx = x0 + col;
  const float fx = (float)gx, fy = (float)gy;
  // the sub-tile clipped to its tile, in global cells
  const int ya = y0 + sy0, yb = y0 + min(sy0 + kSubY, th);
  const int xa = x0 + sx0, xb = x0 + min(sx0 + kSubX, tw);
  const int half = window / 2;
  const int cnt = min(counts[tile], cap);
  const float* base = tile_data + (size_t)tile * cap * 8;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int s0 = 0; s0 < cnt; s0 += kThreads) {
    // compact this round's slots whose window meets the sub-tile
    const int s = s0 + threadIdx.x;
    Disk dk;
    bool hit = false;
    if (s < cnt) {
      const float* d = base + (size_t)s * 8;
      dk.px = d[0];
      dk.py = d[1];
      dk.by = (int)floorf(dk.py + 0.5f) - half;
      dk.bx = (int)floorf(dk.px + 0.5f) - half;
      hit = dk.by < yb && dk.by + window > ya && dk.bx < xb &&
            dk.bx + window > xa;
      if (hit) {
        dk.vx = d[2];
        dk.vy = d[3];
        dk.om = d[4];
        dk.rr = shift_radius(d[5], cp.r_shift);
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_n[w] : 0;
      n += warp_n[w];
    }
    if (hit) disks[off + __popc(m & ((1u << lane) - 1u))] = dk;
    __syncthreads();
    if (mine) {
      for (int j = 0; j < n; ++j) {
        const Disk& d = disks[j];
        if (gy < d.by || gy >= d.by + window || gx < d.bx ||
            gx >= d.bx + window)
          continue;
        const float relx = __fsub_rn(fx, d.px);
        const float rely = __fsub_rn(fy, d.py);
        const float cov = coverage<M>(relx, rely, d.rr, cp, tab);
        const float usx = __fsub_rn(d.vx, __fmul_rn(d.om, rely));
        const float usy = __fadd_rn(d.vy, __fmul_rn(d.om, relx));
        a0 = __fadd_rn(a0, cov);
        a1 = __fadd_rn(a1, __fmul_rn(cov, usx));
        a2 = __fadd_rn(a2, __fmul_rn(cov, usy));
      }
    }
    __syncthreads();  // the next round overwrites `disks`
  }
  if (!mine) return;
  const size_t plane = (size_t)ny * nx;
  const size_t c = (size_t)(gy - oy) * nx + (gx - ox);
  const float inv = 1.0f / fmaxf(a0, eps_min);
  out[c] = a0;
  out[plane + c] = __fmul_rn(a1, inv);
  out[2 * plane + c] = __fmul_rn(a2, inv);
}

}  // namespace

// tile_data: (n_tiles, cap * 8) f32 disk records [x, y, vx, vy, omega, r,
// active, 0] in slot order; counts: (n_tiles,) i32; out: (3, ny, nx) f32.
// Stamp tiles are th x tw, ntx per tile row; cp: the coverage method and
// its constants (ops/stamp.cov_params); (oy, ox): the lattice's cell (0,
// 0) in the records' frame.
extern "C" int lbm_stamp(const float* tile_data, const int* counts, float* out,
                         int ny, int nx, int th, int tw, int ntx, int cap,
                         int window, CovParams cp, float eps_min, int oy,
                         int ox, cudaStream_t stream) {
  if (cp.method < kSample || cp.method > kExact)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (ny / th) * ntx;
  if (n_tiles == 0) return 0;
  const dim3 grid(n_tiles,
                  ((th + kSubY - 1) / kSubY) * ((tw + kSubX - 1) / kSubX));
  auto kernel = cp.method == kRamp    ? &stamp_kernel<kRamp>
                : cp.method == kExact ? &stamp_kernel<kExact>
                                      : &stamp_kernel<kSample>;
  kernel<<<grid, kThreads, 0, stream>>>(tile_data, counts, out, ny, nx, th,
                                        tw, ntx, cap, window, cp, eps_min, oy,
                                        ox);
  return (int)cudaGetLastError();
}
