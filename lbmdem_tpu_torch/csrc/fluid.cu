// K4 and K5: pure-fluid LBM steps - moments, BGK/TRT (+ Smagorinsky
// LES), Guo forcing, pull streaming, half-way bounce-back with moving
// walls, Zou/He inlet/outlet - on f32 or shifted-bf16 storage.
//
// Replaces the TPU kernels lbmdem_tpu/ops/pallas_lbm.py:_fluid_kernel
// (K4, entry fused_step_fluid: one step per pass) and
// _fluid_multi_kernel (K5, entry fused_step_fluid_multi: k steps per
// pass, temporal blocking). Each has its own C entry point; the storage
// type is a template parameter of both.
//
// K4: on f32, one block of 512 threads per 16 x 32 tile loads the tile
// and a one-cell halo (periodic wrap at the domain edge, as the plain
// version's torch.roll), collides it into shared memory and streams the
// tile into `out`, the caller's second f buffer; on bf16, K5's row sweep
// at k = 1, faster there (PERF.md section 6), but on a shard's frame the
// one-step body in both storages (it hands out the edge populations; the
// same f' as the sweep's, the same operations in the same order).
// Bounded by device memory:
// per cell a step reads f and writes f' (72 B in f32, 36 B in bf16),
// 1.2 GB per step at 4096^2, ~0.36 ms at 3.35 TB/s.
//
// K5: the row-sweep temporal block of tblock.cuh with FluidCell (no
// solid ring, no sink): strips of T - 2k output columns, one warp group
// per inner step, each LAG rows behind the one before, a ring of rows per
// step in shared memory. Its collide and stream are K4's (fluid_collide_t
// with the options as compile-time flags runs K4's operations in K4's
// order), so in f32 K5(k) equals k chained K4 steps bit for bit; bf16
// rounds once per pass. What bounds it now: not the 0.36 ms of bytes
// (the pass reads and writes f once) but the collides' instruction
// throughput and latency: the pair-form collide (d2q9.cuh fluid_collide_t,
// the TPU kernels' algebra) takes ~130 operations and one reciprocal per
// cell and step with BGK and a body force, 4.2 collides per output cell
// and pass at k = 4 and T = 128, one barrier per phase. With no
// solid ring and no sink its rings take less shared memory and its
// collide fewer registers than the NT one, which the design spends on
// two rows per level and phase (a ring of 6 rows, 110.6 KB at T = 128
// and k = 4; two independent collides per thread and half the barriers)
// at 2 blocks of 512 threads per SM, with the options fixed at compile
// time. The steps before it (the options read at run time; fixed at 2 or
// 3 blocks per SM; one row per phase) were slower at 4096^2 on f32 and
// bf16; their times are in PERF.md section 6. The strip (threads per
// level, rows per block) is `lbm_fluid_strip`'s, chosen by
// chip_smoke.py's sweep at 4096^2 (ops/fused_fluid.STRIP). A sweep takes
// at most kSweepK = 4 steps, the most at which a level keeps T = 128
// threads (T k <= 512): deeper, T falls to 64, the halo takes 2k of 64
// columns and the rings (and at bf16 k = 16 two levels per warp group)
// leave one block per SM. So k > 4 runs as ceil(k / 4) sweeps of near
// equal depth, the ones between through f32 scratch planes that hold the
// populations unrounded (shifted on bf16): the same arithmetic as one
// pass, bit for bit, and one rounding per pass on bf16.
//
// bf16: loads the shifted populations g = f - w rho0, computes in f32
// in the shifted form (d2q9.cuh geq_eu), and rounds once per call with
// __float2bfloat16_rn: once per k steps in K5. The rest state g = 0 is
// a fixed point exactly.
//
// Pre-haloed mode (the lattice mesh, ops/fused_fluid prehalo): the
// same bodies read a shard's frame (d2q9.cuh Frame) in place of the
// wrapped lattice - K4's tile and its ring of one cell, K5's cone of k
// rows and columns - and write the interior. They replace the prehalo
// branches of the TPU kernels (_window_copies' pre-haloed offsets,
// pallas_lbm.py:398; _stream_and_bb's skipped walls, :482; and the edge
// flags of _stream_and_bb_window, :669). K4 runs no y walls ("y") or no
// walls ("yx") and no Zou/He: the caller fixes the shards at a global
// edge. K5 runs the walls and closures of the shard's global edges at
// every inner step (p.walls, p.open and the frame rows' inlet profile
// from the host). On f32 and on shifted bf16, whose frames carry 16
// halo rows (Frame.hy; the JAX bf16 row granule); bf16 rounds once per
// pass at the store, as on the lattice, and K4's edge populations are
// the f32 shifted ones, unrounded, so that the caller's bounce-back
// rounds once. A pass reads the interior and the halo cells its steps
// need - K4 a ring of one cell, K5 a ring of k (rows only in "y" mode,
// where x wraps) - and writes the interior: 9 x 4 B (2 B in bf16) x
// ((ny + 2k) (nx [+ 2k]) + ny nx); the frame's other halo cells are
// exchanged but not read. K5 takes k up to the frame's halo (8 on f32,
// 16 on bf16), the JAX kernel's limit: as on the lattice, ceil(k / 4)
// sweeps, each but the last writing an f32 scratch frame that holds the
// interior and the rings the later sweeps' cone reads (tblock.cuh's
// frame output), stepped with the walls and closures at every inner
// step as one deep pass steps them; bf16 rounds once, at the last store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tblock.cuh"

namespace {

constexpr int kTX = 32;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;

// K4's one-step body: one step of a 16 x 32 tile (see the header), f32
// on the lattice, f32 or bf16 on a frame. PRE: 0 on
// the lattice, 1 ("y") or 2 ("yx") on a shard's frame `fr`, whose rows
// (and in "yx" mode columns) past the ring of one cell are clamped: no
// output pulls from them; there the interior's first and last rows and
// columns also hand their post-collision populations to `edge` (d2q9.cuh
// EdgePost), where the caller's wall fixups read them.
template <typename S, int PRE>
__global__ void __launch_bounds__(kThreads)
    fluid_step_kernel(const S* __restrict__ f, S* __restrict__ out,
                      const float* __restrict__ u_in, int ny, int nx,
                      FluidParams p, PairParams q, Frame fr,
                      EdgePost edge) {
  constexpr bool kShift = sizeof(S) == 2;  // bf16 storage
  __shared__ float post[9 * (kTX + 2) * (kTY + 2)];
  const float shift = kShift ? p.rho0 : 0.0f;
  const int w = kTX + 2, n = w * (kTY + 2);
  const int gy0 = blockIdx.y * kTY - 1;  // global row of window row 0
  const int gx0 = blockIdx.x * kTX - 1;
  const size_t plane = (size_t)ny * nx;
  const size_t fplane = PRE ? (size_t)(ny + 2 * fr.hy) * fr.pitch : plane;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int ly = c / w, lx = c - ly * w;
    size_t cell;
    if constexpr (PRE == 0) {
      cell = (size_t)wrap(gy0 + ly, ny) * nx + wrap(gx0 + lx, nx);
    } else {
      const int col = PRE == 2 ? min(gx0 + lx, nx) + fr.hx
                               : wrap(gx0 + lx, nx);
      cell = (size_t)(min(gy0 + ly, ny) + fr.hy) * fr.pitch + col;
    }
    float v[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = load_f(f + i * fplane + cell);
    fluid_collide<kShift>(v, p, q);
#pragma unroll
    for (int i = 0; i < 9; ++i) post[i * n + c] = v[i];
  }
  __syncthreads();
  const int ly = 1 + threadIdx.x / kTX, lx = 1 + threadIdx.x % kTX;
  const int gy = gy0 + ly, gx = gx0 + lx;
  if (gy >= ny || gx >= nx) return;
  float v[9];
  stream_cell<PRE != 0>(post, n, w, ly * w + lx, gy, gx, ny, nx, u_in, p,
                        shift, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) store_f(out + i * plane + cell, v[i]);
  if constexpr (PRE != 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = post[i * n + ly * w + lx];
    edge.store(gy, gx, ny, nx, v);
  }
}

constexpr int kRows = 2;    // rows per level and phase (see the header)
constexpr int kSweepK = 4;  // steps per sweep (see the header)

StripConfig strip{128, 64};

// one sweep, S -> SO, for the options; TRT or LES builds for one block
// per SM (its collide needs more registers)
template <typename S, typename SO, bool SHIFT, int TRT, int LES, int FORCED>
int launch_sweep(const void* f, void* out, const float* u_in, int ny, int nx,
                 int k, const FluidParams& p, const PairParams& q,
                 cudaStream_t stream) {
  return launch_temporal_block<S, SO, SHIFT, kRows, (TRT || LES) ? 1 : 2>(
      f, u_in, out, FluidCell<TRT, LES, FORCED>{q}, ny, nx, k, strip, p,
      stream);
}

template <typename S, typename SO, bool SHIFT>
int launch_pass(const void* f, void* out, const float* u_in, int ny, int nx,
                int k, const FluidParams& p, const PairParams& q,
                cudaStream_t stream) {
#define LBM_FL(TRT, LES)                                                     \
  (p.forced ? launch_sweep<S, SO, SHIFT, TRT, LES, 1>(f, out, u_in, ny, nx, \
                                                      k, p, q, stream)      \
            : launch_sweep<S, SO, SHIFT, TRT, LES, 0>(f, out, u_in, ny, nx, \
                                                      k, p, q, stream))
  if (p.trt) return p.les ? LBM_FL(1, 1) : LBM_FL(1, 0);
  return p.les ? LBM_FL(0, 1) : LBM_FL(0, 0);
#undef LBM_FL
}

// k steps: ceil(k / kSweepK) sweeps of near equal depth, sweep i < n - 1
// into the f32 scratch plane mid[i % 2]
template <typename S>
int launch_multi(const void* f, float* mid, void* out, const float* u_in,
                 int ny, int nx, int k, const FluidParams& p,
                 const PairParams& q, cudaStream_t stream) {
  constexpr bool kShift = sizeof(S) == 2;
  const int n = (k + kSweepK - 1) / kSweepK;
  if (n == 1)
    return launch_pass<S, S, kShift>(f, out, u_in, ny, nx, k, p, q, stream);
  if (mid == nullptr) return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)9 * ny * nx;
  const float* src = nullptr;
  for (int i = 0; i < n; ++i) {
    const int ki = k / n + (i < k % n);
    float* dst = mid + (i & 1) * plane;
    int err;
    if (i == 0)
      err = launch_pass<S, float, kShift>(f, dst, u_in, ny, nx, ki, p, q,
                                          stream);
    else if (i < n - 1)
      err = launch_pass<float, float, kShift>(src, dst, u_in, ny, nx, ki, p,
                                              q, stream);
    else
      err = launch_pass<float, S, kShift>(src, out, u_in, ny, nx, ki, p, q,
                                          stream);
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

template <typename S, int PRE = 0>
int launch_step(const void* f, void* out, const float* u_in, int ny, int nx,
                const FluidParams& p, const PairParams& q, cudaStream_t stream,
                Frame fr = Frame{0, 0, 0},
                EdgePost edge = EdgePost{nullptr, nullptr}) {
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  fluid_step_kernel<S, PRE><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(f), static_cast<S*>(out), u_in, ny, nx, p, q, fr,
      edge);
  return (int)cudaGetLastError();
}

// K5 on a frame: one sweep (k <= kSweepK) of the options, S -> SO; ext
// = 0 writes the interior into `out`, ext > 0 the interior and ext rings
// around it into an f32 frame of fr's shape (tblock.cuh)
template <typename S, typename SO, bool SHIFT, int PRE, int TRT, int LES,
          int FORCED>
int launch_sweep_prehalo(const void* f, void* out, const float* u_in, int ny,
                         int nx, int k, int ext, const FluidParams& p,
                         const PairParams& q, Frame fr, cudaStream_t stream) {
  return launch_temporal_block<S, SO, SHIFT, kRows, (TRT || LES) ? 1 : 2,
                               FluidCell<TRT, LES, FORCED>, PRE>(
      f, u_in, out, FluidCell<TRT, LES, FORCED>{q}, ny, nx, k, strip, p,
      stream, fr, ext, ext ? fr : Frame{0, 0, 0});
}

template <typename S, typename SO, bool SHIFT, int PRE>
int launch_pass_prehalo(const void* f, void* out, const float* u_in, int ny,
                        int nx, int k, int ext, const FluidParams& p,
                        const PairParams& q, Frame fr, cudaStream_t stream) {
#define LBM_FP(TRT, LES)                                                  \
  (p.forced ? launch_sweep_prehalo<S, SO, SHIFT, PRE, TRT, LES, 1>(      \
                  f, out, u_in, ny, nx, k, ext, p, q, fr, stream)        \
            : launch_sweep_prehalo<S, SO, SHIFT, PRE, TRT, LES, 0>(      \
                  f, out, u_in, ny, nx, k, ext, p, q, fr, stream))
  if (p.trt) return p.les ? LBM_FP(1, 1) : LBM_FP(1, 0);
  return p.les ? LBM_FP(0, 1) : LBM_FP(0, 0);
#undef LBM_FP
}

// K5 on a frame, k <= fr.hy steps: ceil(k / kSweepK) sweeps of near equal
// depth, as launch_multi; sweep i < n - 1 writes into the f32 scratch
// frame mid[i % 2] the interior and the rings that the later sweeps'
// cone reads (their depth: `rest`), the next reads it as its frame
template <typename S, int PRE>
int launch_multi_prehalo(const void* f, float* mid, void* out,
                         const float* u_in, int ny, int nx, int k,
                         const FluidParams& p, const PairParams& q, Frame fr,
                         cudaStream_t stream) {
  constexpr bool kShift = sizeof(S) == 2;
  const int n = (k + kSweepK - 1) / kSweepK;
  if (n == 1)
    return launch_pass_prehalo<S, S, kShift, PRE>(f, out, u_in, ny, nx, k, 0,
                                                  p, q, fr, stream);
  if (mid == nullptr) return (int)cudaErrorInvalidValue;
  const size_t frame = (size_t)9 * (ny + 2 * fr.hy) * fr.pitch;
  const float* src = nullptr;
  int rest = k;
  for (int i = 0; i < n; ++i) {
    const int ki = k / n + (i < k % n);
    rest -= ki;
    float* dst = mid + (i & 1) * frame;
    int err;
    if (i == 0)
      err = launch_pass_prehalo<S, float, kShift, PRE>(f, dst, u_in, ny, nx,
                                                       ki, rest, p, q, fr,
                                                       stream);
    else if (i < n - 1)
      err = launch_pass_prehalo<float, float, kShift, PRE>(
          src, dst, u_in, ny, nx, ki, rest, p, q, fr, stream);
    else
      err = launch_pass_prehalo<float, S, kShift, PRE>(
          src, out, u_in, ny, nx, ki, 0, p, q, fr, stream);
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

}  // namespace

// The strip of K5: threads per level (64, 128 or 256) and output rows
// per block (>= 1). Returns cudaErrorInvalidValue for anything else.
extern "C" int lbm_fluid_strip(int threads, int rows) {
  return set_strip(strip, threads, rows);
}

// K4: one step. f, out: (9, ny, nx) f32 or bf16 (bf16 = 1; distinct
// buffers); u_in: (ny,) f32 inlet profile (read only when p.open). On
// bf16 the row sweep at k = 1 (K5's body, the same f') is faster at
// 4096^2 than the one-step body; on f32 it is slower.
extern "C" int lbm_fluid_step(const void* f, void* out, const float* u_in,
                              int ny, int nx, int bf16, FluidParams p,
                              PairParams q, cudaStream_t stream) {
  return bf16 ? launch_pass<__nv_bfloat16, __nv_bfloat16, true>(
                    f, out, u_in, ny, nx, 1, p, q, stream)
              : launch_step<float>(f, out, u_in, ny, nx, p, q, stream);
}

// K5: k steps in one pass by row sweeps (1 <= k <= 16; the wrappers take
// k <= 8 on f32 and k = 1 to K4). mid: f32 scratch of (n - 1, 9, ny, nx)
// for n = ceil(k / 4) sweeps, at most (2, 9, ny, nx); unused (may be
// null) for k <= 4.
extern "C" int lbm_fluid_multi(const void* f, void* out, float* mid,
                               const float* u_in, int ny, int nx, int k,
                               int bf16, FluidParams p, PairParams q,
                               cudaStream_t stream) {
  return bf16 ? launch_multi<__nv_bfloat16>(f, mid, out, u_in, ny, nx, k, p,
                                            q, stream)
              : launch_multi<float>(f, mid, out, u_in, ny, nx, k, p, q,
                                    stream);
}

// K4 on a shard's pre-haloed frame: f (9, ny + 2 hy, pitch) f32 (hy = 8)
// or shifted bf16 (bf16 = 1, hy = 16), the interior at column hx (128 in
// "yx" mode, else 0; pitch = nx + 2 hx); out (9, ny, nx) of f's type;
// erow (9, 2, nx) and ecol (9, ny, 2) f32, or null: the post-collision
// populations of the interior's first and last rows and columns (on
// bf16 the shifted ones, unrounded). p carries only the walls the kernel
// runs (the x walls in "y" mode, none in "yx") and no Zou/He.
extern "C" int lbm_fluid_step_prehalo(const void* f, void* out, float* erow,
                                      float* ecol, int ny, int nx, int pitch,
                                      int hx, int bf16, FluidParams p,
                                      PairParams q, cudaStream_t stream) {
  if (p.open || pitch != nx + 2 * hx || (hx != 0 && hx != kHaloCols))
    return (int)cudaErrorInvalidValue;
  const Frame fr{pitch, hx, frame_hy(bf16)};
  const EdgePost edge{erow, ecol};
  if (bf16)
    return hx ? launch_step<__nv_bfloat16, 2>(f, out, nullptr, ny, nx, p, q,
                                              stream, fr, edge)
              : launch_step<__nv_bfloat16, 1>(f, out, nullptr, ny, nx, p, q,
                                              stream, fr, edge);
  return hx ? launch_step<float, 2>(f, out, nullptr, ny, nx, p, q, stream, fr,
                                    edge)
            : launch_step<float, 1>(f, out, nullptr, ny, nx, p, q, stream, fr,
                                    edge);
}

// K5 on a shard's pre-haloed frame: 1 <= k <= hy steps (8 on f32, 16 on
// bf16), f, out and bf16 as lbm_fluid_step_prehalo's; p carries the walls
// and Zou/He sides of the shard's global edges (p.open: bit 0 inlet, bit
// 1 outlet); u_in: (ny + 2 hy,) f32, the inlet profile at the frame's
// global rows (read only when p.open); mid: f32 scratch of
// (min(n - 1, 2), 9, ny + 2 hy, pitch) for n = ceil(k / 4) sweeps,
// unused (may be null) for k <= 4.
extern "C" int lbm_fluid_multi_prehalo(const void* f, void* out, float* mid,
                                       const float* u_in, int ny, int nx,
                                       int pitch, int hx, int k, int bf16,
                                       FluidParams p, PairParams q,
                                       cudaStream_t stream) {
  if (k < 1 || k > frame_hy(bf16) || pitch != nx + 2 * hx ||
      (hx != 0 && hx != kHaloCols) || (p.open && u_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const Frame fr{pitch, hx, frame_hy(bf16)};
  if (bf16)
    return hx ? launch_multi_prehalo<__nv_bfloat16, 2>(f, mid, out, u_in, ny,
                                                       nx, k, p, q, fr, stream)
              : launch_multi_prehalo<__nv_bfloat16, 1>(f, mid, out, u_in, ny,
                                                       nx, k, p, q, fr, stream);
  return hx ? launch_multi_prehalo<float, 2>(f, mid, out, u_in, ny, nx, k, p,
                                             q, fr, stream)
            : launch_multi_prehalo<float, 1>(f, mid, out, u_in, ny, nx, k, p,
                                             q, fr, stream);
}
