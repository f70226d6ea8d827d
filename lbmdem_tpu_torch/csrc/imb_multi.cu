// K6: k coupled LBM steps in one pass over a FROZEN solid stack - the
// coupling_k window - with the per-(stamp tile, slot) hydro-force
// reduce of every inner step; every lattice option (BGK/TRT, LES, nt_mode,
// Guo forcing, static and moving walls, Zou/He, periodic axes) on f32 or
// shifted-bf16 storage.
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
// (72 B per cell in f32, 36 B in bf16), the solid stack read once (12 B),
// and the share-weighted momentum exchange w written per inner step
// where eps_raw > 0 (8 B on ~12 % of the cells): ~1.4 GB at 4096^2 in
// f32, ~0.42 ms at 3.35 TB/s. The collide skips the divide of a zero
// numerator (imb.cuh div_nz; f stays bitwise).
//
// Design, two launches:
//  (a) imb_multi_kernel: one block of 512 threads per 16 x 32 tile. It
//      keeps two f windows of (16 + 2k)(32 + 2k) cells and one solid
//      window of the same extent (3 planes, loaded once) in dynamic
//      shared memory: 81 KB at k = 4, 129 KB at k = 8. Pass 0 loads f
//      and collides the whole window; each inner step t pull-streams
//      and collides the window shrunk by t cells per side into the
//      other buffer; the last pass streams the interior into `out`, the
//      caller's second f buffer. Bounce-back and the Zou/He closures
//      fire on each window cell's global unwrapped coordinate (d2q9.cuh
//      stream_cell, as in K5 and K7), so wrapped halos on a periodic
//      axis evolve exactly, the wall rule cuts the cone on a wall axis,
//      and the halo cells of a block next to an open end apply the same
//      closure as the block that owns them. bf16 storage computes in the
//      shifted form g = f - w rho0 with f32 windows and rounds once, at
//      the final store, as the TPU kernel does. At every inner step the
//      interior cells with eps_raw > 0 write w_t = phi / max(eps_raw,
//      eps_min) into the (k, 2, ny, nx) scratch.
//  (b) reduce_kernel (imb.cuh): a warp per occupied slot and inner step,
//      writing partials[t][tile * cap + slot] - K2's reduce over a
//      second grid axis.
// No atomics: f' and the partials are deterministic.
#include <cuda_bf16.h>
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
                                        float phiy, float eps_min) {
  if (ly < k || ly >= k + kTY || lx < k || lx >= k + kTX || gy >= ny ||
      gx >= nx)
    return;
  WSink{w, plane, eps_min}.store((size_t)gy * nx + gx, eps_raw, phix, phiy);
}

template <typename S, bool TRT, bool LES, bool LAMBDA>
__global__ void __launch_bounds__(kThreads)
    imb_multi_kernel(const S* __restrict__ f, const float* __restrict__ solid,
                     const float* __restrict__ u_in, S* __restrict__ out,
                     float* __restrict__ w, int ny, int nx, int k,
                     FluidParams p, float tm, float eps_min) {
  constexpr bool kShift = sizeof(S) == 2;  // bf16 storage
  extern __shared__ float smem[];
  const float shift = kShift ? p.rho0 : 0.0f;
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
    for (int i = 0; i < 9; ++i) fc[i] = load_f(f + i * plane + cell);
    const float eps_raw = solid[cell];
    const float usx = solid[plane + cell], usy = solid[2 * plane + cell];
    sol[c] = eps_raw;
    sol[n + c] = usx;
    sol[2 * n + c] = usy;
    collide_cell<kShift, TRT, LES, LAMBDA>(fc, eps_raw, usx, usy, p, tm, fp,
                                           &phix, &phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) cur[i * n + c] = fp[i];
    write_w(w, plane, ly, lx, k, gy0 + ly, gx0 + lx, ny, nx, eps_raw, phix,
            phiy, eps_min);
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
      stream_cell(cur, n, ww, wc, gy, gx, ny, nx, u_in, p, shift, v);
      const float eps_raw = sol[wc];
      collide_cell<kShift, TRT, LES, LAMBDA>(v, eps_raw, sol[n + wc],
                                             sol[2 * n + wc], p, tm, fp,
                                             &phix, &phiy);
#pragma unroll
      for (int i = 0; i < 9; ++i) nxt[i * n + wc] = fp[i];
      write_w(ws, plane, ly, lx, k, gy, gx, ny, nx, eps_raw, phix, phiy,
              eps_min);
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
  stream_cell(cur, n, ww, ly * ww + lx, gy, gx, ny, nx, u_in, p, shift, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) store_f(out + i * plane + cell, v[i]);
}

template <typename S, bool TRT, bool LES, bool LAMBDA>
int launch(const void* f, const float* solid, const float* u_in, void* out,
           float* w, int ny, int nx, int k, const FluidParams& p, float tm,
           float eps_min, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * 21 * (size_t)(kTX + 2 * k) * (kTY + 2 * k);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        imb_multi_kernel<S, TRT, LES, LAMBDA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  imb_multi_kernel<S, TRT, LES, LAMBDA><<<grid, kThreads, bytes, stream>>>(
      static_cast<const S*>(f), solid, u_in, static_cast<S*>(out), w, ny, nx,
      k, p, tm, eps_min);
  return (int)cudaGetLastError();
}

// the instantiation for the options: LAMBDA matters only with LES (else
// the caller's tm already has the lambda form)
template <typename S>
int dispatch(const void* f, const float* solid, const float* u_in, void* out,
             float* w, int ny, int nx, int k, int lambda,
             const FluidParams& p, float tm, float eps_min,
             cudaStream_t stream) {
#define LBM_MULTI(TRT, LES, LAMBDA)                                       \
  launch<S, TRT, LES, LAMBDA>(f, solid, u_in, out, w, ny, nx, k, p, tm,   \
                              eps_min, stream)
  if (p.trt) {
    if (!p.les) return LBM_MULTI(true, false, false);
    return lambda ? LBM_MULTI(true, true, true) : LBM_MULTI(true, true, false);
  }
  if (!p.les) return LBM_MULTI(false, false, false);
  return lambda ? LBM_MULTI(false, true, true) : LBM_MULTI(false, true, false);
#undef LBM_MULTI
}

}  // namespace

// f, out: (9, ny, nx) f32, or shifted bf16 when bf16 = 1 (distinct
// buffers); solid: (3, ny, nx) f32 [eps_raw, us_x, us_y], frozen for the
// k steps; u_in: (ny,) f32 inlet profile (read only when p.open); w:
// (k, 2, ny, nx) f32 scratch; tile_data/counts: the stamp binning
// ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles, ntx per row;
// partials: (k, n_tiles * cap, 4) f32; offsets: (n_tiles + 1,) i32
// scratch; cp: the coverage method and its
// constants; tm: the NT blend constant (tau - 1/2, or 3/16 /
// (tau - 1/2) when lambda = 1). 1 <= k <= 8.
extern "C" int lbm_imb_multi(const void* f, const float* solid,
                             const float* u_in, const float* tile_data,
                             const int* counts, void* out, float* w,
                             float* partials, int* offsets, int ny, int nx,
                             int th, int tw, int ntx, int n_tiles, int cap,
                             int window,
                             CovParams cp, int k, int bf16, int lambda,
                             FluidParams p, float tm, float eps_min,
                             cudaStream_t stream) {
  const int err =
      bf16 ? dispatch<__nv_bfloat16>(f, solid, u_in, out, w, ny, nx, k, lambda,
                                     p, tm, eps_min, stream)
           : dispatch<float>(f, solid, u_in, out, w, ny, nx, k, lambda, p, tm,
                             eps_min, stream);
  if (err != 0) return err;
  return launch_reduce(WPlanes{w, (size_t)ny * nx}, solid, tile_data, counts,
                       offsets, partials, nx, th, tw, ntx, n_tiles, cap,
                       window, cp, k, stream);
}
