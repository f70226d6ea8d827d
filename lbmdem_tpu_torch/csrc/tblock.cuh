// The temporal block of the coupled step: k NT-blended collide +
// pull-stream steps over one solid stack in one pass over f, by a row
// sweep. One body serves K6 (imb_multi.cu: the coupling_k window, a sink
// that writes every inner step's momentum exchange w_t) and K7
// (imb_static.cu: the static-solid hoist, a sink that stores nothing).
//
// Replaces the bodies of the TPU kernels
// lbmdem_tpu/ops/pallas_lbm.py:_imb_reduce_multi_kernel (K6, line 1257)
// and :_imb_static_multi_kernel (K7, line 911).
//
// What bounds it on the H100: neither roof. Per pass f is read and
// written once (72 B per cell in f32, 36 B in bf16) and the solid stack
// read once (12 B): 1.41 GB at 4096^2 in f32, 0.42 ms at 3.35 TB/s. The
// NT collide is ~350 operations at a cell with eps > 0 and ~180 on the
// fluid branch (imb.cuh relax_cell), nine IEEE divides among them; at
// k = 4 the coupled cell's collides (without the halo recompute) are
// ~13.5 GFLOP, 0.20 ms at the 67 TFLOP/s peak and twice that with no
// multiply-add fused under --fmad=false. The kernel takes 1.6-1.8 ms
// per pass (PERF.md section 6): the collide's dependent chains at the
// occupancy the rings allow, with one barrier per row, hold it.
//
// Why the design before this one (one 512-thread block per 16 x 32 tile,
// two f windows of (16 + 2k)(32 + 2k) cells, each inner step the window
// shrunk by one cell per side) lost to k chained one-step kernels: it
// collided 3 128 cells for 512 outputs at k = 4 (6.11 per output cell
// and pass, 4 needed), its second round of 512 threads kept 88, 63, 41
// and 20 % of the lanes busy, a barrier followed each step, and 80.6 KB
// of shared memory with 81 registers left one block per SM to wait at
// those barriers.
//
// Design: a block owns a strip of W = T - 2k output columns and `rows`
// output rows. It has k groups of T threads (blockDim (T, k)), one
// thread per column of the strip plus its k-column halo on each side and
// per level: group t runs inner step t. The block walks its rows from k
// above its first output row to k below its last, one row per phase and
// one barrier per phase. Level 0 loads f and the solid fields of its row
// from device memory and collides; level t pull-streams from level t - 1's
// ring (d2q9.cuh stream_pull) and collides; level k, run by group k - 1
// after its collide, streams level k - 1 into `out` (bf16: one rounding,
// at this store). Level t runs 2 rows behind level t - 1 (the lag), so
// the three rows it reads were all written in earlier phases and all
// levels work in the same phase between two barriers, k independent
// collides per column and phase on k warps, where one thread per column
// doing them in turn left the SM idle on the collide's dependency chains
// and lost to chained K2 steps. The x halo shrinks by one column
// per level, as the dependency cone does, so no row is collided twice
// and only the 2(k - t) halo columns and rows of level t are recomputed:
// at T = 128 and k = 4 about (128 + 126 + 124 + 122) / 120 (1 + 2k /
// rows) = 4.2 collides per output cell and pass. Every cell carries its
// global unwrapped coordinate: bounce-back and the Zou/He closures fire
// on it, as in K5, so wrapped halos on a periodic axis evolve exactly,
// the wall rule cuts the cone on a wall axis, and a domain smaller than a
// strip holds a cell more than once.
//
// Shared memory: per level a ring of lag + 2 = 4 post-collision rows of
// 9 x T floats, and one ring of 2k - 1 rows of the solid fields (3 x T
// floats; level t reads the row level 0 stored 2t phases before):
// 4 T (36 k + 3 (2k - 1)) bytes, 84.5 KB at T = 128 and k = 4, 85 KB at
// T = 64 and k = 8. A strip is narrowed (256 -> 128 -> 64) at launch
// until T k <= 512 threads and its rings fit a block. Chosen by
// chip_smoke.py's strip sweep at 4096^2: T = 128 (64 for k >= 5), so
// W = 128 - 2k (120 at k = 4); 128 rows per block for K6 and 64 for K7
// (ops/fused_lbm.MULTI_STRIP, ops/fused_static.STRIP); the lag is 2 at
// every k, the least that lets all levels share one barrier.
#pragma once

#include <cuda_runtime.h>

#include "imb.cuh"

namespace {

constexpr int kTBMaxThreads = 512;
constexpr int kTBMaxK = 8;

// Strip of a temporal-block launch: threads per level (the strip's
// output columns plus the 2k halo columns) and output rows per block
struct StripConfig {
  int threads;
  int rows;
};

inline int set_strip(StripConfig& s, int threads, int rows) {
  if ((threads != 64 && threads != 128 && threads != 256) || rows < 1)
    return (int)cudaErrorInvalidValue;
  s = {threads, rows};
  return 0;
}

// Per-inner-step sinks at a block's output cells. WSteps (K6): inner step
// t's w_t into plane pair t of the (k, 2, ny, nx) scratch, where eps_raw
// > 0 (WSink). NoSink (K7): nothing.
struct WSteps {
  float* w;
  size_t plane;
  float eps_min;
  __device__ __forceinline__ void store(int t, size_t cell, float eps_raw,
                                        float phix, float phiy) const {
    WSink{w + (size_t)t * 2 * plane, plane, eps_min}.store(cell, eps_raw,
                                                           phix, phiy);
  }
};

struct NoSink {
  __device__ __forceinline__ void store(int, size_t, float, float,
                                        float) const {}
};

// dynamic shared memory of a block: k rings of 4 rows of 9 x T floats and
// a ring of 2k - 1 rows of 3 x T floats
inline size_t tblock_smem(int k, int threads) {
  return sizeof(float) * (size_t)threads * (36 * k + 3 * (2 * k - 1));
}

// __launch_bounds__: two blocks of 512 threads per SM for the BGK
// instantiations (64 registers, no spills), so one block's work fills
// the other's barrier waits; one for TRT or LES, whose collide would
// spill at 64.
template <typename S, bool TRT, bool LES, bool LAMBDA, class Sink>
__global__ void __launch_bounds__(kTBMaxThreads, (TRT || LES) ? 1 : 2)
    temporal_block_kernel(const S* __restrict__ f,
                          const float* __restrict__ solid,
                          const float* __restrict__ u_in, S* __restrict__ out,
                          Sink sink, int ny, int nx, int k, int rows,
                          FluidParams p, float tm) {
  constexpr bool kShift = sizeof(S) == 2;  // bf16 storage
  extern __shared__ float smem[];
  const int T = blockDim.x, lx = threadIdx.x;
  const int t = threadIdx.y;                     // this thread's level
  const int y0 = blockIdx.y * rows;              // first output row
  const int h = min(rows, ny - y0);              // output rows
  const int gx = blockIdx.x * (T - 2 * k) - k + lx;  // global unwrapped
  const int cx = wrap(gx, nx);
  const size_t plane = (size_t)ny * nx;
  const float shift = kShift ? p.rho0 : 0.0f;
  const int R = 2 * k - 1;
  float* sol = smem + (size_t)36 * k * T;  // [R][eps_raw, us_x, us_y][T]
  const bool out_col = lx >= k && lx < T - k && gx < nx;
  // Row j of the sweep is global row y0 - k + j. Level t collides rows j
  // in [t, h + 2k - t) at phase j + 2t into ring slot j % 4 (solid: j %
  // R, kept in `rs`); level k streams rows j in [k, k + h) into `out`
  // (by level k - 1's threads).
  const int n0 = h + 2 * k;
  // pull of row j, column lx from level lt - 1's ring
  auto pull = [&](int lt, int j, float* v) {
    const float* src = smem + (size_t)(lt - 1) * 36 * T + lx;
    stream_pull([&](int i, int dy, int dx) {
      return src[((j + dy) & 3) * 9 * T + i * T + dx];
    }, y0 - k + j, gx, ny, nx, u_in, p, shift, v);
  };
  int rs = (R - (2 * t) % R) % R;  // (ph - 2t) mod R at ph = 0
  for (int ph = 0; ph < h + 3 * k; ++ph) {
    const int j = ph - 2 * t;
    if (j >= t && j < n0 - t && lx >= t && lx < T - t) {
      float fc[9], fp[9], phix, phiy;
      float* sr = sol + (size_t)rs * 3 * T + lx;
      float e, sx, sy;
      if (t == 0) {  // row j = ph from device memory
        const size_t cell = (size_t)wrap(y0 - k + j, ny) * nx + cx;
#pragma unroll
        for (int i = 0; i < 9; ++i) fc[i] = load_f(f + i * plane + cell);
        e = solid[cell];
        sx = solid[plane + cell];
        sy = solid[2 * plane + cell];
        if (k > 1) {
          sr[0] = e;
          sr[T] = sx;
          sr[2 * T] = sy;
        }
      } else {  // row j from level t - 1, solid from level 0's ring
        pull(t, j, fc);
        e = sr[0];
        sx = sr[T];
        sy = sr[2 * T];
      }
      collide_cell<kShift, TRT, LES, LAMBDA>(fc, e, sx, sy, p, tm, fp, &phix,
                                             &phiy);
      if (out_col && j >= k && j < k + h)
        sink.store(t, (size_t)(y0 - k + j) * nx + gx, e, phix, phiy);
      float* dst = smem + (size_t)(4 * t + (j & 3)) * 9 * T;
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i * T + lx] = fp[i];
    }
    const int jo = ph - 2 * k;  // level k: the store, by level k - 1
    if (t == k - 1 && jo >= k && jo < k + h && out_col) {
      float v[9];
      pull(k, jo, v);
      const size_t cell = (size_t)(y0 - k + jo) * nx + gx;
#pragma unroll
      for (int i = 0; i < 9; ++i) store_f(out + i * plane + cell, v[i]);
    }
    if (++rs == R) rs = 0;
    __syncthreads();
  }
}

template <typename S, bool TRT, bool LES, bool LAMBDA, class Sink>
int launch_temporal_block(const void* f, const float* solid,
                          const float* u_in, void* out, Sink sink, int ny,
                          int nx, int k, StripConfig strip,
                          const FluidParams& p, float tm,
                          cudaStream_t stream) {
  auto kernel = temporal_block_kernel<S, TRT, LES, LAMBDA, Sink>;
  if (k < 1 || k > kTBMaxK) return (int)cudaErrorInvalidValue;
  static int max_smem = 0;
  if (max_smem == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  int threads = strip.threads;
  while (threads > 64 && (threads * k > kTBMaxThreads ||
                          tblock_smem(k, threads) > (size_t)max_smem))
    threads /= 2;
  const size_t bytes = tblock_smem(k, threads);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const int w = threads - 2 * k;
  const int nbx = (nx + w - 1) / w, rows = strip.rows;
  const dim3 grid(nbx, (ny + rows - 1) / rows);
  kernel<<<grid, dim3(threads, k), bytes, stream>>>(
      static_cast<const S*>(f), solid, u_in, static_cast<S*>(out), sink, ny,
      nx, k, rows, p, tm);
  return (int)cudaGetLastError();
}

// The instantiation for the options: LAMBDA matters only with LES (else
// the caller's tm already has the lambda form)
template <typename S, class Sink>
int dispatch_temporal_block(const void* f, const float* solid,
                            const float* u_in, void* out, Sink sink, int ny,
                            int nx, int k, int lambda, StripConfig strip,
                            const FluidParams& p, float tm,
                            cudaStream_t stream) {
#define LBM_TB(TRT, LES, LAMBDA)                                            \
  launch_temporal_block<S, TRT, LES, LAMBDA, Sink>(f, solid, u_in, out, sink, \
                                                   ny, nx, k, strip, p, tm,   \
                                                   stream)
  if (p.trt) {
    if (!p.les) return LBM_TB(true, false, false);
    return lambda ? LBM_TB(true, true, true) : LBM_TB(true, true, false);
  }
  if (!p.les) return LBM_TB(false, false, false);
  return lambda ? LBM_TB(false, true, true) : LBM_TB(false, true, false);
#undef LBM_TB
}

}  // namespace
