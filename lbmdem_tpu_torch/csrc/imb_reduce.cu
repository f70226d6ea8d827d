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

#include "coverage.cuh"

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

constexpr int kBX = 32;
constexpr int kBY = 16;
constexpr int kHX = kBX + 2;
constexpr int kHY = kBY + 2;

// D2Q9 tables (lattice.py) as constexpr functions: inside the unrolled
// population loops they fold to constants, so the per-cell arrays stay
// in registers (a table in __constant__ memory would make fc[opp(i)] a
// dynamic index and move the arrays to local memory)
__host__ __device__ constexpr int ex(int i) {
  return i == 1 || i == 5 || i == 8 ? 1 : (i == 3 || i == 6 || i == 7 ? -1 : 0);
}
__host__ __device__ constexpr int ey(int i) {
  return i == 2 || i == 5 || i == 6 ? 1 : (i == 4 || i == 7 || i == 8 ? -1 : 0);
}
__host__ __device__ constexpr int opp(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}

// lattice weights exactly as float64 -> float32 (numpy's rounding)
__device__ __forceinline__ float weight(int i) {
  return i == 0 ? (float)(4.0 / 9.0)
                : (i < 5 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0));
}

// f_eq_i = w_i rho (1 + 3 eu + 4.5 eu^2 - 1.5 usq), in the evaluation
// order of the plain version (ops/lbm.equilibrium)
__device__ __forceinline__ float feq(int i, float rho, float ux, float uy,
                                     float usq) {
  const float eu = __fadd_rn(__fmul_rn((float)ex(i), ux),
                             __fmul_rn((float)ey(i), uy));
  const float a = __fadd_rn(1.0f, __fmul_rn(3.0f, eu));
  const float b = __fadd_rn(a, __fmul_rn(__fmul_rn(4.5f, eu), eu));
  const float c = __fsub_rn(b, __fmul_rn(1.5f, usq));
  return __fmul_rn(__fmul_rn(weight(i), rho), c);
}

// moving-wall bounce-back term 6 w_i rho0 (e_i . u_w), in float64 as
// lattice.wall_corr computes it, then rounded
__device__ __forceinline__ float wall_corr(int i, double uwx, double uwy,
                                           double rho0) {
  const double w = i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
  return (float)(6.0 * w * rho0 * ((double)ex(i) * uwx + (double)ey(i) * uwy));
}

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
                 fp, &phix, &phiy);
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
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = post[i][ly - ey(i)][lx - ex(i)];
  // half-way bounce-back, south, north, then west, east: at a corner
  // the x-wall rule wins (plain version: lbm.apply_bounce_back)
  if ((p.walls & 1) && gy == 0) {  // ey = +1 populations 2, 5, 6
    v[2] = __fadd_rn(post[4][ly][lx], wall_corr(2, p.uw_south, 0.0, p.rho0));
    v[5] = __fadd_rn(post[7][ly][lx], wall_corr(5, p.uw_south, 0.0, p.rho0));
    v[6] = __fadd_rn(post[8][ly][lx], wall_corr(6, p.uw_south, 0.0, p.rho0));
  }
  if ((p.walls & 2) && gy == ny - 1) {  // ey = -1 populations 4, 7, 8
    v[4] = __fadd_rn(post[2][ly][lx], wall_corr(4, p.uw_north, 0.0, p.rho0));
    v[7] = __fadd_rn(post[5][ly][lx], wall_corr(7, p.uw_north, 0.0, p.rho0));
    v[8] = __fadd_rn(post[6][ly][lx], wall_corr(8, p.uw_north, 0.0, p.rho0));
  }
  if ((p.walls & 4) && gx == 0) {  // ex = +1 populations 1, 5, 8
    v[1] = __fadd_rn(post[3][ly][lx], wall_corr(1, 0.0, p.uw_west, p.rho0));
    v[5] = __fadd_rn(post[7][ly][lx], wall_corr(5, 0.0, p.uw_west, p.rho0));
    v[8] = __fadd_rn(post[6][ly][lx], wall_corr(8, 0.0, p.uw_west, p.rho0));
  }
  if ((p.walls & 8) && gx == nx - 1) {  // ex = -1 populations 3, 6, 7
    v[3] = __fadd_rn(post[1][ly][lx], wall_corr(3, 0.0, p.uw_east, p.rho0));
    v[6] = __fadd_rn(post[8][ly][lx], wall_corr(6, 0.0, p.uw_east, p.rho0));
    v[7] = __fadd_rn(post[5][ly][lx], wall_corr(7, 0.0, p.uw_east, p.rho0));
  }
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) fout[i * plane + cell] = v[i];
}

constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ w,
                  const float* __restrict__ tile_data,
                  const int* __restrict__ counts,
                  float* __restrict__ partials, int ny, int nx, int th, int tw,
                  int ntx, int cap, int window, int ns, float r_shift) {
  const int slot = blockIdx.x;
  const int tile = blockIdx.y;
  float* outp = partials + ((size_t)tile * cap + slot) * 4;
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
  const size_t plane = (size_t)ny * nx;
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

}  // namespace

// f, fout: (9, ny, nx) f32 (distinct buffers); solid: (3, ny, nx) f32
// [eps_raw, us_x, us_y]; w: (2, ny, nx) f32 scratch; tile_data/counts:
// the stamp binning ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles,
// ntx per row; partials: (n_tiles * cap, 4) f32.
extern "C" int lbm_imb_step(const float* f, const float* solid,
                            const float* tile_data, const int* counts,
                            float* fout, float* w, float* partials, int ny,
                            int nx, int th, int tw, int ntx, int n_tiles,
                            int cap, int window, int ns, float r_shift,
                            LbmParams p, cudaStream_t stream) {
  dim3 grid_a((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY);
  dim3 block_a(kBX, kBY);
  collide_stream_kernel<<<grid_a, block_a, 0, stream>>>(f, solid, fout, w, ny,
                                                        nx, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0 || cap == 0) return 0;
  dim3 grid_b(cap, n_tiles);
  reduce_kernel<<<grid_b, kReduceThreads, 0, stream>>>(
      w, tile_data, counts, partials, ny, nx, th, tw, ntx, cap, window, ns,
      r_shift);
  return (int)cudaGetLastError();
}
