// Coupled-step device code shared by the fused IMB step (K2,
// imb_reduce.cu), its temporal block over a frozen solid stack (K6,
// imb_multi.cu) and the static-solid temporal block (K7, imb_static.cu):
// the scalars, the NT-blended collide of one cell (with K7's options as
// template flags), the pull + half-way bounce-back of one cell, and the
// per-(stamp tile, slot) hydro-force reduce (also the standalone K9 of
// imb_split.cu, which computes w itself).
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

// e_i . u in the plain version's full form ex*ux + ey*uy
__device__ __forceinline__ float edot_full(int i, float ux, float uy) {
  return __fadd_rn(__fmul_rn((float)ex(i), ux), __fmul_rn((float)ey(i), uy));
}

// Equilibrium of population i at (rho, u): f_eq, or with SHIFT the
// shifted g_eq = f_eq - w_i rho0 (rho_b = sum of the shifted g)
template <bool SHIFT>
__device__ __forceinline__ float feq_nt(int i, float rho_b, float rho,
                                        float ux, float uy, float usq) {
  const float eu = edot_full(i, ux, uy);
  return SHIFT ? geq_eu(i, rho_b, rho, eu, usq) : feq_eu(i, rho, eu, usq);
}

// NT-blended collision of one cell (plain version: imb.collide_imb,
// operation by operation). fp[9] receives the post-collision
// populations; returns phi. P is LbmParams (K2, K6) or FluidParams (K7);
// tm is the NT blend's tau - 1/2, or 3/16 / (tau - 1/2) under
// nt_mode="lambda", rounded from float64 as the plain version's Python
// scalar is. The options are compile-time flags:
//   SHIFT  fc holds g = f - w rho0 (bf16 storage); BGK, TRT, Guo and the
//          NT operator are linear in f - f_eq, so the update keeps its
//          form with g_eq for f_eq;
//   TRT    the two-relaxation-time split of collide_imb;
//   LES    Smagorinsky tau_eff per cell (lbm.smagorinsky_tau); B, the
//          Guo prefactor and the TRT rates follow from it;
//   LAMBDA with LES: tm = 3/16 / (tau_eff - 1/2) per cell.
// The all-false instantiation is K2's and K6's collide.
template <bool SHIFT = false, bool TRT = false, bool LES = false,
          bool LAMBDA = false, class P>
__device__ __forceinline__ void collide_cell(const float* fc, float eps_raw,
                                             float usx, float usy, const P& p,
                                             float tm, float* fp, float* phix,
                                             float* phiy) {
  float rs = 0.f, jx = 0.f, jy = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) rs = __fadd_rn(rs, fc[i]);
#pragma unroll
  for (int i = 0; i < 9; ++i) jx = __fadd_rn(jx, __fmul_rn(fc[i], (float)ex(i)));
#pragma unroll
  for (int i = 0; i < 9; ++i) jy = __fadd_rn(jy, __fmul_rn(fc[i], (float)ey(i)));
  float rho = rs;
  if constexpr (SHIFT) rho = __fadd_rn(rs, p.rho0);
  const float inv_rho = 1.0f / rho;
  const float ux = __fmul_rn(__fadd_rn(jx, p.half_gx), inv_rho);
  const float uy = __fmul_rn(__fadd_rn(jy, p.half_gy), inv_rho);
  const float usq = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
  const float ssq = __fadd_rn(__fmul_rn(usx, usx), __fmul_rn(usy, usy));
  float fe[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) fe[i] = feq_nt<SHIFT>(i, rs, rho, ux, uy, usq);
  float tau = p.tau;
  if constexpr (LES) {  // ops/lbm.smagorinsky_tau, as K5's fluid_collide
    float pxx = 0.f, pyy = 0.f, pxy = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float ne = __fsub_rn(fc[i], fe[i]);
      if (ex(i) != 0) pxx = __fadd_rn(pxx, ne);
      if (ey(i) != 0) pyy = __fadd_rn(pyy, ne);
      if (ex(i) * ey(i) != 0) pxy = __fadd_rn(pxy, ex(i) * ey(i) > 0 ? ne : -ne);
    }
    const float pn = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(pxx, pxx), __fmul_rn(pyy, pyy)),
                  __fmul_rn(__fmul_rn(2.0f, pxy), pxy)));
    tau = __fmul_rn(0.5f, __fadd_rn(p.tau, __fsqrt_rn(__fadd_rn(
        p.tau_sq, __fdiv_rn(__fmul_rn(p.les_c, pn), rho)))));
    tm = __fsub_rn(tau, 0.5f);  // imb.nt_weight on the per-cell tau
    if constexpr (LAMBDA) tm = __fmul_rn(__frcp_rn(tm), 0.1875f);
  }
  const float eps = fminf(fmaxf(eps_raw, 0.0f), 1.0f);
  const float B = __fmul_rn(eps, tm) / __fadd_rn(__fsub_rn(1.0f, eps), tm);
  const float omb = __fsub_rn(1.0f, B);
  float px = 0.f, py = 0.f;
  if constexpr (!TRT) {
    float pref = p.guo_pref;
    if constexpr (LES) pref = __fsub_rn(1.0f, __fmul_rn(__frcp_rn(tau), 0.5f));
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int o = opp(i);
      const float fes = feq_nt<SHIFT>(i, rs, rho, usx, usy, ssq);
      const float om = __fsub_rn(__fadd_rn(__fsub_rn(fc[o], fc[i]), fes), fe[o]);
      float v = __fsub_rn(fc[i], __fmul_rn(omb, __fsub_rn(fc[i], fe[i])) / tau);
      const float bom = __fmul_rn(B, om);
      v = __fadd_rn(v, bom);
      if (p.forced) {
        const float proj = guo_proj(i, ux, uy, edot_full(i, ux, uy), p.gx, p.gy);
        v = __fadd_rn(v, __fmul_rn(omb, __fmul_rn(pref, proj)));
      }
      fp[i] = v;
      px = __fadd_rn(px, __fmul_rn(bom, (float)ex(i)));
      py = __fadd_rn(py, __fmul_rn(bom, (float)ey(i)));
    }
  } else {
    float hp = p.trt_hp, hm = p.trt_hm, pe = p.trt_pe, po = p.trt_po;
    if constexpr (LES) {  // ops/lbm.trt_tau_minus on the per-cell tau
      hp = __fmul_rn(__frcp_rn(tau), 0.5f);
      const float tmin = __fadd_rn(
          __fmul_rn(__frcp_rn(__fsub_rn(tau, 0.5f)), p.trt_magic), 0.5f);
      hm = __fmul_rn(__frcp_rn(tmin), 0.5f);
      pe = __fmul_rn(__fsub_rn(1.0f, hp), 0.5f);
      po = __fmul_rn(__fsub_rn(1.0f, hm), 0.5f);
    }
    float ne[9], S[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      ne[i] = __fsub_rn(fc[i], fe[i]);
      S[i] = p.forced ? guo_proj(i, ux, uy, edot_full(i, ux, uy), p.gx, p.gy)
                      : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int o = opp(i);
      const float fes = feq_nt<SHIFT>(i, rs, rho, usx, usy, ssq);
      const float om = __fsub_rn(__fadd_rn(__fsub_rn(fc[o], fc[i]), fes), fe[o]);
      const float relax = __fadd_rn(__fmul_rn(hp, __fadd_rn(ne[i], ne[o])),
                                    __fmul_rn(hm, __fsub_rn(ne[i], ne[o])));
      float v = __fsub_rn(fc[i], __fmul_rn(omb, relax));
      const float bom = __fmul_rn(B, om);
      v = __fadd_rn(v, bom);
      if (p.forced) {
        const float src = __fadd_rn(__fmul_rn(pe, __fadd_rn(S[i], S[o])),
                                    __fmul_rn(po, __fsub_rn(S[i], S[o])));
        v = __fadd_rn(v, __fmul_rn(omb, src));
      }
      fp[i] = v;
      px = __fadd_rn(px, __fmul_rn(bom, (float)ex(i)));
      py = __fadd_rn(py, __fmul_rn(bom, (float)ey(i)));
    }
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

// The momentum exchange w = phi / max(eps_raw, eps_min) the reduce weights
// by coverage, as a source functor of reduce_kernel: load(t, cell, wx, wy)
// gives inner step t's (wx, wy) at a flat cell index.
//
// WPlanes: K2's and K6's launch (a) wrote w to a (k, 2, ny, nx) scratch.
struct WPlanes {
  const float* w;
  size_t plane;
  __device__ __forceinline__ void load(int t, size_t cell, float& wx,
                                       float& wy) const {
    const float* wt = w + (size_t)t * 2 * plane;
    wx = wt[cell];
    wy = wt[plane + cell];
  }
};

// WFromPhi: K9 computes w from the raw phi planes and eps_raw, with the
// expression of K2's launch (a), so K8 + K9 gives K2's partials.
struct WFromPhi {
  const float* eps;
  const float* phix;
  const float* phiy;
  float eps_min;
  __device__ __forceinline__ void load(int, size_t cell, float& wx,
                                       float& wy) const {
    const float sd = 1.0f / fmaxf(eps[cell], eps_min);
    wx = __fmul_rn(phix[cell], sd);
    wy = __fmul_rn(phiy[cell], sd);
  }
};

// One block per (slot, stamp tile, inner step t): sums cov * w[t] and
// the torque over the disk's window clipped to the tile (block
// reduction) and writes partials[t][tile * cap + slot] = [fx, fy, tq, 0].
// Slots past the tile's count write zeros. partials: (k, n_tiles * cap,
// 4); K2 and K9 launch it with k = 1. M is the coverage method, W the
// source of w (WPlanes or WFromPhi).
template <int M, class W>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(W wsrc, const float* __restrict__ tile_data,
                  const int* __restrict__ counts,
                  float* __restrict__ partials, int ny, int nx, int th, int tw,
                  int ntx, int cap, int window, int ns, float r_shift) {
  const int slot = blockIdx.x;
  const int tile = blockIdx.y;
  float* outp = partials +
                (((size_t)blockIdx.z * gridDim.y + tile) * cap + slot) * 4;
  if (slot >= counts[tile]) {
    if (threadIdx.x < 4) outp[threadIdx.x] = 0.0f;
    return;
  }
  const float* d = tile_data + ((size_t)tile * cap + slot) * 8;
  const float px = d[0], py = d[1], rr = shift_radius(d[5], r_shift);
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
      const float cov = coverage<M>(relx, rely, rr, ns);
      float wx, wy;
      wsrc.load(blockIdx.z, (size_t)gy * nx + gx, wx, wy);
      const float fxc = __fmul_rn(cov, wx);
      const float fyc = __fmul_rn(cov, wy);
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

// The reduce over k inner steps (launch b of K2 and K6, and K9) for the
// coverage method `method` (CovMethod); returns cudaGetLastError.
template <class W>
inline int launch_reduce(W wsrc, const float* tile_data, const int* counts,
                         float* partials, int ny, int nx, int th, int tw,
                         int ntx, int n_tiles, int cap, int window, int ns,
                         float r_shift, int method, int k,
                         cudaStream_t stream) {
  if (method < kSample || method > kExact) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0 || cap == 0) return 0;
  const dim3 grid(cap, n_tiles, k);
  auto kernel = method == kRamp    ? &reduce_kernel<kRamp, W>
                : method == kExact ? &reduce_kernel<kExact, W>
                                   : &reduce_kernel<kSample, W>;
  kernel<<<grid, kReduceThreads, 0, stream>>>(wsrc, tile_data, counts,
                                              partials, ny, nx, th, tw, ntx,
                                              cap, window, ns, r_shift);
  return (int)cudaGetLastError();
}

}  // namespace
