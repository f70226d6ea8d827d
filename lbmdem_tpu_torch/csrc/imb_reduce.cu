// K2: one coupled LBM step - NT-blended BGK collide (+ Guo forcing),
// pull-stream, half-way bounce-back - with the per-(stamp tile, slot)
// hydrodynamic force reduce.
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_lbm.py:_imb_reduce_kernel
// (entry fused_step_imb_reduce), which runs _collide_window,
// _stream_and_bb and pallas_stamp.reduce_partials_banded per lattice tile.
//
// What bounds it on the H100: device-memory traffic. Per cell the step
// reads f (36 B) and the solid stack (12 B) and writes f' (36 B) and
// the share-weighted momentum exchange w (8 B): ~1.5 GB per step at
// 4096^2, ~0.5 ms at 3.35 TB/s. Design, two launches:
//  (a) collide_stream_kernel: one block per 16 x 32 cell tile. It
//      collides the tile plus a 1-cell halo (periodic wrap at the domain
//      edge, as the TPU kernel's wrapped halo windows; on wall sides the
//      wrapped values only reach populations that bounce-back
//      overwrites), keeps the post-collision populations in shared
//      memory, then pulls each interior cell's 9 populations from its
//      neighbours and writes them to the OTHER f buffer. Halo cells are
//      collided twice (1.2x the collide work) so no cell reads another
//      block's output. w = phi / max(eps_raw, eps_min) goes to device
//      memory for (b).
//  (b) reduce_kernel: one block per (stamp tile, slot). It sums cov * w
//      and the torque over the disk's window clipped to the tile with a
//      block reduction and writes partials[tile * cap + slot] =
//      [fx, fy, tq, 0]. Slots past the tile's count write zeros.
// No atomics: f' and the partials are deterministic.
#include <cuda_runtime.h>

#include "imb.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 16;
constexpr int kHX = kBX + 2;
constexpr int kHY = kBY + 2;

__global__ void __launch_bounds__(kBX * kBY)
    collide_stream_kernel(const float* __restrict__ f,
                          const float* __restrict__ solid,
                          float* __restrict__ fout, float* __restrict__ w,
                          int ny, int nx, LbmParams p) {
  __shared__ float post[9][kHY][kHX];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const size_t plane = (size_t)ny * nx;
  const int tid = threadIdx.y * kBX + threadIdx.x;

  for (int c = tid; c < kHY * kHX; c += kBX * kBY) {
    const int ly = c / kHX, lx = c % kHX;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    const int wy = ((gy % ny) + ny) % ny;
    const int wx = ((gx % nx) + nx) % nx;
    const size_t cell = (size_t)wy * nx + wx;
    float fc[9], fp[9], phix, phiy;
#pragma unroll
    for (int i = 0; i < 9; ++i) fc[i] = f[i * plane + cell];
    const float eps_raw = solid[cell];
    collide_cell(fc, eps_raw, solid[plane + cell], solid[2 * plane + cell], p,
                 p.tm, fp, &phix, &phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) post[i][ly][lx] = fp[i];
    const bool interior = ly >= 1 && ly <= kBY && lx >= 1 && lx <= kBX &&
                          gy < ny && gx < nx;
    if (interior) {
      const float sd = 1.0f / fmaxf(eps_raw, p.eps_min);
      w[cell] = __fmul_rn(phix, sd);
      w[plane + cell] = __fmul_rn(phiy, sd);
    }
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= ny || gx >= nx) return;
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  float v[9];
  imb_stream_cell(&post[0][0][0], kHY * kHX, kHX, ly * kHX + lx, gy, gx, ny,
                  nx, p, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) fout[i * plane + cell] = v[i];
}

}  // namespace

// f, fout: (9, ny, nx) f32 (distinct buffers); solid: (3, ny, nx) f32
// [eps_raw, us_x, us_y]; w: (2, ny, nx) f32 scratch; tile_data/counts:
// the stamp binning ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles,
// ntx per row; partials: (n_tiles * cap, 4) f32; method: the CovMethod of
// cfg.eps_method.
extern "C" int lbm_imb_step(const float* f, const float* solid,
                            const float* tile_data, const int* counts,
                            float* fout, float* w, float* partials, int ny,
                            int nx, int th, int tw, int ntx, int n_tiles,
                            int cap, int window, int ns, float r_shift,
                            int method, LbmParams p, cudaStream_t stream) {
  dim3 grid_a((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  dim3 block_a(kBX, kBY);
  collide_stream_kernel<<<grid_a, block_a, 0, stream>>>(f, solid, fout, w, ny,
                                                        nx, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(WPlanes{w, (size_t)ny * nx}, tile_data, counts,
                       partials, ny, nx, th, tw, ntx, n_tiles, cap, window, ns,
                       r_shift, method, 1, stream);
}
