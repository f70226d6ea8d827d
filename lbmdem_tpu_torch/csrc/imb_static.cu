// K7: k coupled LBM steps in one pass over a CONSTANT solid stack - the
// static-solid hoist of scenes whose disks are all fixed and at rest
// (porous beds, obstacle arrays, a cylinder in a channel).
//
// Replaces the TPU kernel
// lbmdem_tpu/ops/pallas_lbm.py:_imb_static_multi_kernel (entry
// fused_step_imb_static_multi). The solid stack (eps_raw, us_x, us_y) is
// stamped once for the whole run, so no reduce follows the collides; the
// drag on the obstacles is observed out of band (Simulation.hydro_forces).
//
// What bounds it on the H100: per pass f is read and written once (72 B
// per cell in f32, 36 B in bf16) and the solid stack read once (12 B):
// 1.41 GB at 4096^2 in f32 (0.81 GB in bf16), 0.42 ms (0.24 ms) at
// 3.35 TB/s. The arithmetic is K6's without the w stores: the NT collide
// computes 18 equilibria per cell, times the halo recompute (1 + 2k/16)
// (1 + 2k/32) = 1.9x at k = 4, so it is bound by issue and occupancy
// before it reaches the memory floor.
//
// Design: K5's body (fluid.cu) with K6's frozen solid window
// (imb_multi.cu). One block of 512 threads per 16 x 32 output tile keeps
// two f windows of (16 + 2k)(32 + 2k) cells and one solid window of the
// same extent (3 planes, loaded once) in dynamic shared memory: 81 KB at
// k = 4, 129 KB at k = 8 (k = 1 needs one f window only). Pass 0 loads
// f and the solid window and collides the whole window; each inner step
// pull-streams and collides the window shrunk by one more cell per side
// into the other buffer; the last pass streams the interior into `out`,
// the caller's second f buffer. Bounce-back and the Zou/He closures fire
// on each window cell's global unwrapped coordinate, as in K5, so wrapped
// halos on a periodic axis evolve exactly and the wall rule cuts the
// cone on a wall axis; a domain smaller than the tile holds the same
// cell more than once. The collide is imb.cuh's collide_cell with the
// options as template flags (the BGK instantiation carries no TRT or LES
// state, and a zero numerator skips its two divides, imb.cuh div_nz);
// bf16 storage computes in the shifted form g = f - w rho0 and rounds
// once per pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "imb.cuh"

namespace {

constexpr int kTX = 32;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;

template <typename S, bool TRT, bool LES, bool LAMBDA>
__global__ void __launch_bounds__(kThreads)
    imb_static_kernel(const S* __restrict__ f, const float* __restrict__ solid,
                      S* __restrict__ out, const float* __restrict__ u_in,
                      int ny, int nx, int k, FluidParams p, float tm) {
  constexpr bool kShift = sizeof(S) == 2;  // bf16 storage
  extern __shared__ float smem[];
  const float shift = kShift ? p.rho0 : 0.0f;
  const int w = kTX + 2 * k, h = kTY + 2 * k, n = w * h;
  float* cur = smem;
  float* nxt = smem + 9 * n;
  float* sol = smem + 18 * n;  // [eps_raw, us_x, us_y] (k > 1 only)
  const int gy0 = blockIdx.y * kTY - k;  // global row of window row 0
  const int gx0 = blockIdx.x * kTX - k;
  const size_t plane = (size_t)ny * nx;

  // pass 0: load f and the solid window, collide the whole window
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int ly = c / w, lx = c - ly * w;
    const size_t cell = (size_t)wrap(gy0 + ly, ny) * nx + wrap(gx0 + lx, nx);
    float fc[9], fp[9], phix, phiy;
#pragma unroll
    for (int i = 0; i < 9; ++i) fc[i] = load_f(f + i * plane + cell);
    const float eps_raw = solid[cell];
    const float usx = solid[plane + cell], usy = solid[2 * plane + cell];
    if (k > 1) {
      sol[c] = eps_raw;
      sol[n + c] = usx;
      sol[2 * n + c] = usy;
    }
    collide_cell<kShift, TRT, LES, LAMBDA>(fc, eps_raw, usx, usy, p, tm, fp,
                                           &phix, &phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) cur[i * n + c] = fp[i];
  }
  __syncthreads();

  // inner steps: stream + collide the window shrunk by s cells per side
  for (int s = 1; s < k; ++s) {
    const int ws = w - 2 * s, hs = h - 2 * s;
    for (int c = threadIdx.x; c < ws * hs; c += kThreads) {
      const int ly = s + c / ws, lx = s + c % ws;
      const int wc = ly * w + lx;
      float v[9], fp[9], phix, phiy;
      stream_cell(cur, n, w, wc, gy0 + ly, gx0 + lx, ny, nx, u_in, p, shift,
                  v);
      collide_cell<kShift, TRT, LES, LAMBDA>(v, sol[wc], sol[n + wc],
                                             sol[2 * n + wc], p, tm, fp,
                                             &phix, &phiy);
#pragma unroll
      for (int i = 0; i < 9; ++i) nxt[i * n + wc] = fp[i];
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
  stream_cell(cur, n, w, ly * w + lx, gy, gx, ny, nx, u_in, p, shift, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) store_f(out + i * plane + cell, v[i]);
}

template <typename S, bool TRT, bool LES, bool LAMBDA>
int launch(const void* f, const float* solid, void* out, const float* u_in,
           int ny, int nx, int k, const FluidParams& p, float tm,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)(kTX + 2 * k) * (kTY + 2 * k) *
                       (k > 1 ? 21 : 9);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        imb_static_kernel<S, TRT, LES, LAMBDA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  imb_static_kernel<S, TRT, LES, LAMBDA><<<grid, kThreads, bytes, stream>>>(
      static_cast<const S*>(f), solid, static_cast<S*>(out), u_in, ny, nx, k,
      p, tm);
  return (int)cudaGetLastError();
}

// the instantiation for the options: LAMBDA matters only with LES (else
// the caller's tm already has the lambda form)
template <typename S>
int dispatch(const void* f, const float* solid, void* out, const float* u_in,
             int ny, int nx, int k, int lambda, const FluidParams& p,
             float tm, cudaStream_t stream) {
  if (p.trt) {
    if (!p.les)
      return launch<S, true, false, false>(f, solid, out, u_in, ny, nx, k, p,
                                           tm, stream);
    return lambda ? launch<S, true, true, true>(f, solid, out, u_in, ny, nx,
                                                k, p, tm, stream)
                  : launch<S, true, true, false>(f, solid, out, u_in, ny, nx,
                                                 k, p, tm, stream);
  }
  if (!p.les)
    return launch<S, false, false, false>(f, solid, out, u_in, ny, nx, k, p,
                                          tm, stream);
  return lambda ? launch<S, false, true, true>(f, solid, out, u_in, ny, nx, k,
                                               p, tm, stream)
                : launch<S, false, true, false>(f, solid, out, u_in, ny, nx,
                                                k, p, tm, stream);
}

}  // namespace

// f, out: (9, ny, nx) f32 or shifted bf16 (bf16 = 1; distinct buffers);
// solid: (3, ny, nx) f32 [eps_raw, us_x, us_y], constant; u_in: (ny,) f32
// inlet profile (read only when p.open); tm: the NT blend constant
// (tau - 1/2, or 3/16 / (tau - 1/2) when lambda = 1); 1 <= k <= 8.
extern "C" int lbm_imb_static_multi(const void* f, const float* solid,
                                    void* out, const float* u_in, int ny,
                                    int nx, int k, int bf16, int lambda,
                                    FluidParams p, float tm,
                                    cudaStream_t stream) {
  return bf16 ? dispatch<__nv_bfloat16>(f, solid, out, u_in, ny, nx, k,
                                        lambda, p, tm, stream)
              : dispatch<float>(f, solid, out, u_in, ny, nx, k, lambda, p, tm,
                                stream);
}
