// K1: solid-fraction stamp from tile-binned disks -> dense (3, ny, nx)
// fields [eps_raw, us_x, us_y].
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_stamp.py:_stamp_kernel
// (entry stamp_solid_fraction). For each stamp tile it walks the tile's
// binned disks in slot order and accumulates cov, cov*us_x and cov*us_y
// (u_s = v + omega x r), then divides u_s by max(eps, eps_min).
//
// What bounds it on the H100: the write of the three f32 planes
// (12 B/cell, ~0.2 GB at 4096^2) and the per-disk issue work inside
// dense tiles (16 sample tests per covered cell; ramp and exact coverage
// are a closed form per cell). Design: one block per
// (tile, 16-row strip), one thread per column holding its 4 cells' sums
// in registers; a disk whose window misses the strip is skipped by the
// whole block, a cell outside the window by its thread. No atomics and
// no shared accumulators, so the per-cell sum runs in slot order and is
// deterministic, like the TPU kernel. Disk records are read as
// broadcast loads (every thread of the block reads the same address).
#include <cuda_runtime.h>

#include "coverage.cuh"

namespace {

constexpr int kStrip = 16;   // rows per block
constexpr int kCols = 128;   // threads along x (the stamp tile width cap)
constexpr int kRowsPer = 4;  // rows per thread; blockDim.y = kStrip/kRowsPer

// one instantiation per coverage method M (CovMethod)
template <int M>
__global__ void stamp_kernel(const float* __restrict__ tile_data,
                             const int* __restrict__ counts,
                             float* __restrict__ out, int ny, int nx, int th,
                             int tw, int ntx, int cap, int window, int ns,
                             float r_shift, float eps_min) {
  const int tile = blockIdx.x;
  const int y0 = (tile / ntx) * th;
  const int x0 = (tile % ntx) * tw;
  const int row0 = blockIdx.y * kStrip;
  const int row_end = min(row0 + kStrip, th);
  const int col = threadIdx.x;
  const int gx = x0 + col;
  const float fx = (float)gx;
  const int half = window / 2;
  const int cnt = counts[tile];

  float acc[kRowsPer][3];
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;

  const float* base = tile_data + (size_t)tile * cap * 8;
  for (int k = 0; k < cnt; ++k) {
    const float* d = base + (size_t)k * 8;
    const float px = d[0], py = d[1], vx = d[2], vy = d[3], om = d[4],
                rr = shift_radius(d[5], r_shift);
    const int by = (int)floorf(py + 0.5f) - half;
    const int bx = (int)floorf(px + 0.5f) - half;
    // block-uniform: the window's rows miss this strip
    if (by + window <= y0 + row0 || by >= y0 + row_end) continue;
    if (col >= tw || gx < bx || gx >= bx + window) continue;
    const float relx = __fsub_rn(fx, px);
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) {
      const int row = row0 + threadIdx.y + j * (kStrip / kRowsPer);
      const int gy = y0 + row;
      if (row >= row_end || gy < by || gy >= by + window) continue;
      const float rely = __fsub_rn((float)gy, py);
      const float cov = coverage<M>(relx, rely, rr, ns);
      const float usx = __fsub_rn(vx, __fmul_rn(om, rely));
      const float usy = __fadd_rn(vy, __fmul_rn(om, relx));
      acc[j][0] = __fadd_rn(acc[j][0], cov);
      acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(cov, usx));
      acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(cov, usy));
    }
  }
  if (col >= tw) return;
  const size_t plane = (size_t)ny * nx;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int row = row0 + threadIdx.y + j * (kStrip / kRowsPer);
    if (row >= row_end) continue;
    const size_t c = (size_t)(y0 + row) * nx + gx;
    const float inv = 1.0f / fmaxf(acc[j][0], eps_min);
    out[c] = acc[j][0];
    out[plane + c] = __fmul_rn(acc[j][1], inv);
    out[2 * plane + c] = __fmul_rn(acc[j][2], inv);
  }
}

}  // namespace

// tile_data: (n_tiles, cap * 8) f32 disk records [x, y, vx, vy, omega, r,
// active, 0] in slot order; counts: (n_tiles,) i32; out: (3, ny, nx) f32.
// Stamp tiles are th x tw (tw <= 128), ntx per tile row; method: the
// CovMethod of cfg.eps_method.
extern "C" int lbm_stamp(const float* tile_data, const int* counts, float* out,
                         int ny, int nx, int th, int tw, int ntx, int cap,
                         int window, int ns, float r_shift, float eps_min,
                         int method, cudaStream_t stream) {
  if (tw > kCols || method < kSample || method > kExact)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (ny / th) * ntx;
  dim3 grid(n_tiles, (th + kStrip - 1) / kStrip);
  dim3 block(kCols, kStrip / kRowsPer);
  auto kernel = method == kRamp    ? &stamp_kernel<kRamp>
                : method == kExact ? &stamp_kernel<kExact>
                                   : &stamp_kernel<kSample>;
  kernel<<<grid, block, 0, stream>>>(tile_data, counts, out, ny, nx, th, tw,
                                     ntx, cap, window, ns, r_shift, eps_min);
  return (int)cudaGetLastError();
}
