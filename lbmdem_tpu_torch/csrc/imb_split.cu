// The split coupled step: K8, one coupled LBM step that emits the raw
// momentum-exchange field phi, and K9, the standalone per-(stamp tile,
// slot) hydro-force reduce of phi. K8 + K9 compute what K2 computes in
// one kernel; the stage-ablation tool (tools/ablate.py) times them apart.
//
// K8 replaces the TPU kernel lbmdem_tpu/ops/pallas_lbm.py:_imb_kernel
// (entry fused_step_imb): _collide_window + _stream_and_bb on one lattice
// tile, with every lattice option (BGK/TRT, Smagorinsky LES, nt_mode "nt"
// or "lambda", Guo forcing, static and moving walls, Zou/He inlet/outlet,
// periodic axes), f32 storage only, as the TPU kernel. It writes f' and
// phi = -B sum_i Omega_i e_i, not K2's w = phi / max(eps, eps_min).
// What bounds it on the H100: per cell it reads f (36 B) and the solid
// fields (12 B) and writes f' (36 B) and phi (8 B): 1.54 GB at 4096^2,
// 0.46 ms at 3.35 TB/s. Design: K2's launch (a) - one block of 512
// threads per 16 x 32 tile collides the tile plus a 1-cell halo (wrapped
// at the domain edge) into shared memory and pulls each interior cell's
// populations from it, with bounce-back and the Zou/He closures on the
// cell's global coordinate (d2q9.cuh stream_cell, as K7) - through the
// collide template K7 compiles (imb.cuh collide_cell with the options as
// flags). Its BGK instantiation is K2's collide, so K8's f' equals K2's
// bitwise.
//
// K9 replaces the TPU kernel lbmdem_tpu/ops/pallas_stamp.py:_reduce_kernel
// (entry reduce_hydro_forces). It is K2's launch (b), imb.cuh reduce_kernel,
// with a w source that computes w = phi * (1 / max(eps_raw, eps_min)) per
// cell in K2's expression, so K8 + K9 gives K2's partials bitwise. What
// bounds it: the per-cell coverage arithmetic of every binned window (ns^2
// sample tests, or the ramp/exact closed forms), not bytes: one block per
// (slot, tile) reads its window's eps and phi once.
#include <cuda_runtime.h>

#include "imb.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 16;
constexpr int kHX = kBX + 2;
constexpr int kHY = kBY + 2;

template <bool TRT, bool LES, bool LAMBDA>
__global__ void __launch_bounds__(kBX * kBY)
    imb_split_kernel(const float* __restrict__ f,
                     const float* __restrict__ eps,
                     const float* __restrict__ usx,
                     const float* __restrict__ usy,
                     const float* __restrict__ u_in, float* __restrict__ fout,
                     float* __restrict__ phi, int ny, int nx, FluidParams p,
                     float tm) {
  __shared__ float post[9][kHY][kHX];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const size_t plane = (size_t)ny * nx;
  const int tid = threadIdx.y * kBX + threadIdx.x;

  for (int c = tid; c < kHY * kHX; c += kBX * kBY) {
    const int ly = c / kHX, lx = c % kHX;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    const size_t cell = (size_t)wrap(gy, ny) * nx + wrap(gx, nx);
    float fc[9], fp[9], phix, phiy;
#pragma unroll
    for (int i = 0; i < 9; ++i) fc[i] = f[i * plane + cell];
    collide_cell<false, TRT, LES, LAMBDA>(fc, eps[cell], usx[cell], usy[cell],
                                          p, tm, fp, &phix, &phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) post[i][ly][lx] = fp[i];
    const bool interior = ly >= 1 && ly <= kBY && lx >= 1 && lx <= kBX &&
                          gy < ny && gx < nx;
    if (interior) {
      phi[cell] = phix;
      phi[plane + cell] = phiy;
    }
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= ny || gx >= nx) return;
  float v[9];
  stream_cell(&post[0][0][0], kHY * kHX, kHX,
              (threadIdx.y + 1) * kHX + threadIdx.x + 1, gy, gx, ny, nx, u_in,
              p, 0.0f, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) fout[i * plane + cell] = v[i];
}

template <bool TRT, bool LES, bool LAMBDA>
int launch_split(const float* f, const float* eps, const float* usx,
                 const float* usy, const float* u_in, float* fout, float* phi,
                 int ny, int nx, const FluidParams& p, float tm,
                 cudaStream_t stream) {
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  imb_split_kernel<TRT, LES, LAMBDA><<<grid, dim3(kBX, kBY), 0, stream>>>(
      f, eps, usx, usy, u_in, fout, phi, ny, nx, p, tm);
  return (int)cudaGetLastError();
}

}  // namespace

// K8. f, fout: (9, ny, nx) f32 (distinct buffers); eps, usx, usy: (ny, nx)
// f32 [eps_raw, us_x, us_y]; u_in: (ny,) f32 inlet profile (read only
// when p.open); phi: (2, ny, nx) f32 out [phi_x, phi_y]; tm: the NT blend
// constant (tau - 1/2, or 3/16 / (tau - 1/2) when lambda = 1). LAMBDA
// matters only with LES (else tm already has the lambda form).
extern "C" int lbm_imb_split_step(const float* f, const float* eps,
                                  const float* usx, const float* usy,
                                  const float* u_in, float* fout, float* phi,
                                  int ny, int nx, int lambda, FluidParams p,
                                  float tm, cudaStream_t stream) {
  if (p.trt) {
    if (!p.les)
      return launch_split<true, false, false>(f, eps, usx, usy, u_in, fout,
                                              phi, ny, nx, p, tm, stream);
    return lambda ? launch_split<true, true, true>(f, eps, usx, usy, u_in,
                                                   fout, phi, ny, nx, p, tm,
                                                   stream)
                  : launch_split<true, true, false>(f, eps, usx, usy, u_in,
                                                    fout, phi, ny, nx, p, tm,
                                                    stream);
  }
  if (!p.les)
    return launch_split<false, false, false>(f, eps, usx, usy, u_in, fout,
                                             phi, ny, nx, p, tm, stream);
  return lambda ? launch_split<false, true, true>(f, eps, usx, usy, u_in, fout,
                                                  phi, ny, nx, p, tm, stream)
                : launch_split<false, true, false>(f, eps, usx, usy, u_in,
                                                   fout, phi, ny, nx, p, tm,
                                                   stream);
}

// K9. eps, phix, phiy: (ny, nx) f32; tile_data/counts: the stamp binning
// ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles, ntx per row;
// partials: (n_tiles * cap, 4) f32 out; method: the CovMethod of
// cfg.eps_method.
extern "C" int lbm_reduce_hydro(const float* eps, const float* phix,
                                const float* phiy, const float* tile_data,
                                const int* counts, float* partials, int ny,
                                int nx, int th, int tw, int ntx, int n_tiles,
                                int cap, int window, int ns, float r_shift,
                                float eps_min, int method,
                                cudaStream_t stream) {
  return launch_reduce(WFromPhi{eps, phix, phiy, eps_min}, tile_data, counts,
                       partials, ny, nx, th, tw, ntx, n_tiles, cap, window, ns,
                       r_shift, method, 1, stream);
}
