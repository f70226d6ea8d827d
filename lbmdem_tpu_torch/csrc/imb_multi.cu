// K6: k coupled LBM steps in one pass over a FROZEN solid stack - the
// coupling_k window - with the per-(stamp tile, slot) hydro-force
// reduce of every inner step.
//
// Replaces the TPU kernel
// lbmdem_tpu/ops/pallas_lbm.py:_imb_reduce_multi_kernel (entry
// fused_step_imb_reduce_multi): the window-start solid stack and stamp
// binning hold for all k inner steps; only f streams, so the dependency
// cone of k steps is a k-cell halo, as in the pure-fluid temporal block
// (K5, fluid.cu).
//
// What bounds it on the H100: arithmetic. The NT collide computes 18
// equilibria per cell (K5's pure-fluid collide 9), and the halo
// recompute of a 16 x 32 tile with a k-cell halo is 6.1 collides per
// output cell at k = 4. Device memory per pass: f read and written once
// (72 B per cell), the solid stack read once (12 B), and the
// share-weighted momentum exchange w written per inner step (8 B):
// ~2 GB at 4096^2 and k = 4, ~0.6 ms at 3.35 TB/s.
//
// Design, two launches:
//  (a) imb_multi_kernel: one block of 512 threads per 16 x 32 tile. It
//      keeps two f windows of (16 + 2k)(32 + 2k) cells and one solid
//      window of the same extent (3 planes, loaded once) in dynamic
//      shared memory: 81 KB at k = 4, 129 KB at k = 8. Pass 0 loads f
//      and collides the whole window; each inner step t pull-streams
//      and collides the window shrunk by t cells per side into the
//      other buffer; the last pass streams the interior into `out`, the
//      caller's second f buffer. Bounce-back fires on each window cell's
//      global unwrapped coordinate (as in K5), so wrapped halos on a
//      periodic axis evolve exactly and the wall rule cuts the cone on
//      a wall axis. At every inner step the interior cells write
//      w_t = phi / max(eps_raw, eps_min) into the (k, 2, ny, nx) scratch.
//  (b) reduce_kernel (imb.cuh): one block per (slot, stamp tile, inner
//      step), writing partials[t][tile * cap + slot] - K2's reduce over
//      a third grid axis.
// No atomics: f' and the partials are deterministic.
#include <cuda_runtime.h>

#include "imb.cuh"

namespace {

constexpr int kTX = 32;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;

// w_t of an interior window cell (global row gy, column gx)
__device__ __forceinline__ void write_w(float* w, size_t plane, int ly,
                                        int lx, int k, int gy, int gx, int ny,
                                        int nx, float eps_raw, float phix,
                                        float phiy, const LbmParams& p) {
  if (ly < k || ly >= k + kTY || lx < k || lx >= k + kTX || gy >= ny ||
      gx >= nx)
    return;
  const float sd = 1.0f / fmaxf(eps_raw, p.eps_min);
  const size_t cell = (size_t)gy * nx + gx;
  w[cell] = __fmul_rn(phix, sd);
  w[plane + cell] = __fmul_rn(phiy, sd);
}

__global__ void __launch_bounds__(kThreads)
    imb_multi_kernel(const float* __restrict__ f,
                     const float* __restrict__ solid,
                     float* __restrict__ out, float* __restrict__ w, int ny,
                     int nx, int k, LbmParams p) {
  extern __shared__ float smem[];
  const int ww = kTX + 2 * k, wh = kTY + 2 * k, n = ww * wh;
  float* cur = smem;
  float* nxt = smem + 9 * n;
  float* sol = smem + 18 * n;  // [eps_raw, us_x, us_y] planes
  const int gy0 = blockIdx.y * kTY - k;  // global row of window row 0
  const int gx0 = blockIdx.x * kTX - k;
  const size_t plane = (size_t)ny * nx;

  // pass 0: load f and the solid window, collide the whole window
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int ly = c / ww, lx = c - ly * ww;
    const size_t cell = (size_t)wrap(gy0 + ly, ny) * nx + wrap(gx0 + lx, nx);
    float fc[9], fp[9], phix, phiy;
#pragma unroll
    for (int i = 0; i < 9; ++i) fc[i] = f[i * plane + cell];
    const float eps_raw = solid[cell];
    const float usx = solid[plane + cell], usy = solid[2 * plane + cell];
    sol[c] = eps_raw;
    sol[n + c] = usx;
    sol[2 * n + c] = usy;
    collide_cell(fc, eps_raw, usx, usy, p, p.tm, fp, &phix, &phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) cur[i * n + c] = fp[i];
    write_w(w, plane, ly, lx, k, gy0 + ly, gx0 + lx, ny, nx, eps_raw, phix,
            phiy, p);
  }
  __syncthreads();

  // inner steps: stream + collide the window shrunk by s cells per side
  for (int s = 1; s < k; ++s) {
    float* ws = w + (size_t)s * 2 * plane;
    const int sw = ww - 2 * s, sh = wh - 2 * s;
    for (int c = threadIdx.x; c < sw * sh; c += kThreads) {
      const int ly = s + c / sw, lx = s + c % sw;
      const int wc = ly * ww + lx;
      const int gy = gy0 + ly, gx = gx0 + lx;
      float v[9], fp[9], phix, phiy;
      imb_stream_cell(cur, n, ww, wc, gy, gx, ny, nx, p, v);
      const float eps_raw = sol[wc];
      collide_cell(v, eps_raw, sol[n + wc], sol[2 * n + wc], p, p.tm, fp,
                   &phix, &phiy);
#pragma unroll
      for (int i = 0; i < 9; ++i) nxt[i * n + wc] = fp[i];
      write_w(ws, plane, ly, lx, k, gy, gx, ny, nx, eps_raw, phix, phiy, p);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // last pass: stream the interior into the other f buffer
  const int ly = k + threadIdx.x / kTX, lx = k + threadIdx.x % kTX;
  const int gy = gy0 + ly, gx = gx0 + lx;
  if (gy >= ny || gx >= nx) return;
  float v[9];
  imb_stream_cell(cur, n, ww, ly * ww + lx, gy, gx, ny, nx, p, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i * plane + cell] = v[i];
}

}  // namespace

// f, out: (9, ny, nx) f32 (distinct buffers); solid: (3, ny, nx) f32
// [eps_raw, us_x, us_y], frozen for the k steps; w: (k, 2, ny, nx) f32
// scratch; tile_data/counts: the stamp binning ((n_tiles, cap * 8),
// (n_tiles,)) of th x tw tiles, ntx per row; partials: (k, n_tiles *
// cap, 4) f32; method: the CovMethod of cfg.eps_method. 1 <= k <= 8.
extern "C" int lbm_imb_multi(const float* f, const float* solid,
                             const float* tile_data, const int* counts,
                             float* out, float* w, float* partials, int ny,
                             int nx, int th, int tw, int ntx, int n_tiles,
                             int cap, int window, int ns, float r_shift,
                             int method, int k, LbmParams p,
                             cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * 21 * (size_t)(kTX + 2 * k) * (kTY + 2 * k);
  static size_t opted_in = 48 * 1024;
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        imb_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  imb_multi_kernel<<<grid, kThreads, bytes, stream>>>(f, solid, out, w, ny,
                                                       nx, k, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(WPlanes{w, (size_t)ny * nx}, tile_data, counts,
                       partials, ny, nx, th, tw, ntx, n_tiles, cap, window, ns,
                       r_shift, method, k, stream);
}
