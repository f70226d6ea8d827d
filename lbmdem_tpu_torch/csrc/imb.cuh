// Coupled-step device code shared by the fused IMB step (K2,
// imb_reduce.cu) and its temporal block over a frozen solid stack (K6,
// imb_multi.cu): the scalars, the NT-blended collide of one cell, the
// pull + half-way bounce-back of one cell, and the per-(stamp tile,
// slot) hydro-force reduce.
//
// The arithmetic mirrors the plain version (ops/imb.collide_imb,
// ops/lbm.stream + apply_bounce_back, ops/fused_lbm.reduce_partials_plain)
// with round-to-nearest intrinsics, under --fmad=false.
#pragma once

#include <cuda_runtime.h>

#include "coverage.cuh"
#include "d2q9.cuh"

// Scalars of the coupled collide-stream step (K2, K6); mirrored field
// for field by kernels.LbmParams.
struct LbmParams {
  float tau;       // BGK relaxation time
  float tm;        // NT blend tm = tau - 1/2
  float half_gx;   // 0.5 * gx (velocity shift of the Guo scheme)
  float half_gy;
  float gx, gy;    // fluid body force
  float guo_pref;  // 1 - 1/(2 tau)
  float eps_min;
  int forced;      // gx != 0 or gy != 0
  int walls;       // bit 0 south, 1 north, 2 west, 3 east
  double uw_west, uw_east, uw_south, uw_north, rho0;
};

namespace {

// NT-blended collision of one cell (plain version: imb.collide_imb).
// fp[9] receives the post-collision populations; returns phi.
__device__ __forceinline__ void collide_cell(const float* fc, float eps_raw,
                                             float usx, float usy,
                                             const LbmParams& p, float* fp,
                                             float* phix, float* phiy) {
  float rho = 0.f, jx = 0.f, jy = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) rho = __fadd_rn(rho, fc[i]);
#pragma unroll
  for (int i = 0; i < 9; ++i) jx = __fadd_rn(jx, __fmul_rn(fc[i], (float)ex(i)));
#pragma unroll
  for (int i = 0; i < 9; ++i) jy = __fadd_rn(jy, __fmul_rn(fc[i], (float)ey(i)));
  const float inv_rho = 1.0f / rho;
  const float ux = __fmul_rn(__fadd_rn(jx, p.half_gx), inv_rho);
  const float uy = __fmul_rn(__fadd_rn(jy, p.half_gy), inv_rho);
  const float usq = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
  const float ssq = __fadd_rn(__fmul_rn(usx, usx), __fmul_rn(usy, usy));
  const float eps = fminf(fmaxf(eps_raw, 0.0f), 1.0f);
  const float B = __fmul_rn(eps, p.tm) / __fadd_rn(__fsub_rn(1.0f, eps), p.tm);
  const float omb = __fsub_rn(1.0f, B);
  float fe[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) fe[i] = feq(i, rho, ux, uy, usq);
  float px = 0.f, py = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int o = opp(i);
    const float fes = feq(i, rho, usx, usy, ssq);
    const float om = __fsub_rn(__fadd_rn(__fsub_rn(fc[o], fc[i]), fes), fe[o]);
    float v = __fsub_rn(fc[i], __fmul_rn(omb, __fsub_rn(fc[i], fe[i])) / p.tau);
    const float bom = __fmul_rn(B, om);
    v = __fadd_rn(v, bom);
    if (p.forced) {
      const float exf = (float)ex(i), eyf = (float)ey(i);
      const float eu = __fadd_rn(__fmul_rn(exf, ux), __fmul_rn(eyf, uy));
      const float t1 = __fmul_rn(
          3.0f, __fadd_rn(__fmul_rn(__fsub_rn(exf, ux), p.gx),
                          __fmul_rn(__fsub_rn(eyf, uy), p.gy)));
      const float eg = __fadd_rn(__fmul_rn(exf, p.gx), __fmul_rn(eyf, p.gy));
      const float t2 = __fmul_rn(__fmul_rn(9.0f, eu), eg);
      const float proj = __fmul_rn(weight(i), __fadd_rn(t1, t2));
      v = __fadd_rn(v, __fmul_rn(omb, __fmul_rn(p.guo_pref, proj)));
    }
    fp[i] = v;
    px = __fadd_rn(px, __fmul_rn(bom, (float)ex(i)));
    py = __fadd_rn(py, __fmul_rn(bom, (float)ey(i)));
  }
  *phix = -px;
  *phiy = -py;
}

// Pull of the cell at index c of a post-collision window `post` (9
// planes of n floats, w floats per row) whose global unwrapped
// coordinate is (gy, gx), then half-way bounce-back where that
// coordinate lies on a global wall: south, north, then west, east (at a
// corner the x-wall rule wins; plain version: lbm.apply_bounce_back).
// The wall rule reads only the cell itself, so garbage beyond a wall
// never reaches the domain.
__device__ __forceinline__ void imb_stream_cell(const float* post, int n,
                                                int w, int c, int gy, int gx,
                                                int ny, int nx,
                                                const LbmParams& p, float* v) {
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = post[i * n + c - ey(i) * w - ex(i)];
  if ((p.walls & 1) && gy == 0) {  // ey = +1 populations 2, 5, 6
    v[2] = __fadd_rn(post[4 * n + c], wall_corr(2, p.uw_south, 0.0, p.rho0));
    v[5] = __fadd_rn(post[7 * n + c], wall_corr(5, p.uw_south, 0.0, p.rho0));
    v[6] = __fadd_rn(post[8 * n + c], wall_corr(6, p.uw_south, 0.0, p.rho0));
  }
  if ((p.walls & 2) && gy == ny - 1) {  // ey = -1 populations 4, 7, 8
    v[4] = __fadd_rn(post[2 * n + c], wall_corr(4, p.uw_north, 0.0, p.rho0));
    v[7] = __fadd_rn(post[5 * n + c], wall_corr(7, p.uw_north, 0.0, p.rho0));
    v[8] = __fadd_rn(post[6 * n + c], wall_corr(8, p.uw_north, 0.0, p.rho0));
  }
  if ((p.walls & 4) && gx == 0) {  // ex = +1 populations 1, 5, 8
    v[1] = __fadd_rn(post[3 * n + c], wall_corr(1, 0.0, p.uw_west, p.rho0));
    v[5] = __fadd_rn(post[7 * n + c], wall_corr(5, 0.0, p.uw_west, p.rho0));
    v[8] = __fadd_rn(post[6 * n + c], wall_corr(8, 0.0, p.uw_west, p.rho0));
  }
  if ((p.walls & 8) && gx == nx - 1) {  // ex = -1 populations 3, 6, 7
    v[3] = __fadd_rn(post[1 * n + c], wall_corr(3, 0.0, p.uw_east, p.rho0));
    v[6] = __fadd_rn(post[8 * n + c], wall_corr(6, 0.0, p.uw_east, p.rho0));
    v[7] = __fadd_rn(post[5 * n + c], wall_corr(7, 0.0, p.uw_east, p.rho0));
  }
}

constexpr int kReduceThreads = 128;

// One block per (slot, stamp tile, inner step t): sums cov * w[t] and
// the torque over the disk's window clipped to the tile (block
// reduction) and writes partials[t][tile * cap + slot] = [fx, fy, tq, 0].
// Slots past the tile's count write zeros. w: (k, 2, ny, nx), partials:
// (k, n_tiles * cap, 4); K2 launches it with k = 1.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ w,
                  const float* __restrict__ tile_data,
                  const int* __restrict__ counts,
                  float* __restrict__ partials, int ny, int nx, int th, int tw,
                  int ntx, int cap, int window, int ns, float r_shift) {
  const int slot = blockIdx.x;
  const int tile = blockIdx.y;
  const size_t plane = (size_t)ny * nx;
  w += (size_t)blockIdx.z * 2 * plane;
  float* outp = partials +
                (((size_t)blockIdx.z * gridDim.y + tile) * cap + slot) * 4;
  if (slot >= counts[tile]) {
    if (threadIdx.x < 4) outp[threadIdx.x] = 0.0f;
    return;
  }
  const float* d = tile_data + ((size_t)tile * cap + slot) * 8;
  const float px = d[0], py = d[1], rr = d[5];
  const int half = window / 2;
  const int y0 = (tile / ntx) * th, x0 = (tile % ntx) * tw;
  const int by = (int)floorf(py + 0.5f) - half;
  const int bx = (int)floorf(px + 0.5f) - half;
  const int ya = max(by, y0), yb = min(by + window, y0 + th);
  const int xa = max(bx, x0), xb = min(bx + window, x0 + tw);
  const int wh = yb - ya, ww = xb - xa;
  float fx = 0.f, fy = 0.f, tq = 0.f;
  if (wh > 0 && ww > 0) {
    for (int c = threadIdx.x; c < wh * ww; c += kReduceThreads) {
      const int gy = ya + c / ww, gx = xa + c % ww;
      const float relx = __fsub_rn((float)gx, px);
      const float rely = __fsub_rn((float)gy, py);
      const float cov = cov_sample(relx, rely, rr, r_shift, ns);
      const size_t cell = (size_t)gy * nx + gx;
      const float fxc = __fmul_rn(cov, w[cell]);
      const float fyc = __fmul_rn(cov, w[plane + cell]);
      fx = __fadd_rn(fx, fxc);
      fy = __fadd_rn(fy, fyc);
      tq = __fadd_rn(tq, __fsub_rn(__fmul_rn(relx, fyc), __fmul_rn(rely, fxc)));
    }
  }
  // block reduction: warp shuffles, then one value per warp in shared
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    fx += __shfl_down_sync(0xffffffffu, fx, o);
    fy += __shfl_down_sync(0xffffffffu, fy, o);
    tq += __shfl_down_sync(0xffffffffu, tq, o);
  }
  __shared__ float red[3][kReduceThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = fx;
    red[1][warp] = fy;
    red[2][warp] = tq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < kReduceThreads / 32; ++k) {
      s0 += red[0][k];
      s1 += red[1][k];
      s2 += red[2][k];
    }
    outp[0] = s0;
    outp[1] = s1;
    outp[2] = s2;
    outp[3] = 0.0f;
  }
}

// Launch (b) of K2 and K6 over k inner steps; returns cudaGetLastError.
inline int launch_reduce(const float* w, const float* tile_data,
                         const int* counts, float* partials, int ny, int nx,
                         int th, int tw, int ntx, int n_tiles, int cap,
                         int window, int ns, float r_shift, int k,
                         cudaStream_t stream) {
  if (n_tiles == 0 || cap == 0) return 0;
  const dim3 grid(cap, n_tiles, k);
  reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(
      w, tile_data, counts, partials, ny, nx, th, tw, ntx, cap, window, ns,
      r_shift);
  return (int)cudaGetLastError();
}

}  // namespace
