// The temporal block: k collide + pull-stream steps in one pass over f,
// by a row sweep, generic over a cell policy. One body serves K5
// (fluid.cu: the pure-fluid collide, FluidCell), K6 (imb_multi.cu: the
// coupling_k window, NTCell with a sink that writes every inner step's
// momentum exchange w_t) and K7 (imb_static.cu: the static-solid hoist,
// NTCell with a sink that stores nothing), each on the lattice and on a
// shard's pre-haloed frame of the lattice mesh (PRE below).
//
// Replaces the bodies of the TPU kernels
// lbmdem_tpu/ops/pallas_lbm.py:_fluid_multi_kernel (K5, line 780),
// :_imb_reduce_multi_kernel (K6, line 1257) and
// :_imb_static_multi_kernel (K7, line 911).
//
// What bounds it on the H100: neither roof. Per pass f is read and
// written once (72 B per cell in f32, 36 B in bf16), and for NTCell the
// solid stack read once (12 B): 1.21 GB (K5) and 1.41 GB (K6, K7) at
// 4096^2 in f32, 0.36 and 0.42 ms at 3.35 TB/s. The NT collide is ~350
// operations at a cell with eps > 0 and ~180 on the fluid branch (imb.cuh
// relax_cell) with nine IEEE divides, the pure-fluid collide ~130 and one
// reciprocal (d2q9.cuh fluid_collide_t); at k = 4 that is 0.13 ms (pure
// fluid) and 0.18-0.24 ms (NT) at the 67 TFLOP/s peak, twice that with no
// multiply-add fused under --fmad=false.
// The sweep takes several times that: the collide's dependent chains at
// the occupancy the rings and registers allow, with one barrier per
// phase, hold it (PERF.md sections 6 and 7).
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
// thread per column of the strip plus its k-column halo on each side:
// group t runs inner step (level) t. k <= 8 per launch (T k <= 512 at
// T = 64); fluid.cu runs K5 as sweeps of at most 4 steps. The block
// walks its rows from k above its first output row to k below its last,
// ROWS rows per level and phase and one barrier per phase. Level 0 loads
// f (and the cell's solid fields, which NTCell keeps in a ring) from
// device memory and collides; level t pull-streams from level t - 1's
// ring (d2q9.cuh stream_pull) and collides; level k, run by the group of
// level k - 1 after its collides, streams level k - 1 into `out` (bf16:
// one rounding, at this store). The storage types of f and `out` are
// separate: an f32 side of a bf16 pass holds the shifted form unrounded,
// so such launches chain into one pass bit for bit. At phase ph
// level t works on rows [ROWS ph - LAG t, ROWS ph - LAG t + ROWS), LAG =
// ROWS + 1 rows behind the level before, so every row it reads was
// written in an earlier phase and all levels work in the same phase
// between two barriers, independent collides on every warp. A level's
// ring holds the 2 ROWS + 2 rows that are live at once (4, or 6 with two
// rows per phase). The x halo shrinks by one column per level, as the
// dependency cone does, so no row is collided twice and only the
// 2(k - t) halo columns and rows of level t are recomputed: at T = 128
// and k = 4 about (128 + 126 + 124 + 122) / 120 (1 + 2k / rows) = 4.2
// collides per output cell and pass. Every cell carries its global unwrapped
// coordinate: bounce-back and the Zou/He closures fire on it, so wrapped
// halos on a periodic axis evolve exactly, the wall rule cuts the cone on
// a wall axis, and a domain smaller than a strip holds a cell more than
// once. tests/test_torch_fluid_sweep.py holds this bookkeeping, written
// plainly, against k chained plain steps bit for bit.
//
// Shared memory: per level a ring of 4 (6) post-collision rows of 9 x T
// floats and, for NTCell, one ring of 2k - 1 rows of the solid fields
// (3 x T floats; level t reads the row level 0 stored 2t phases before):
// 4 T (36 k + 3 (2k - 1)) bytes, 84.5 KB at T = 128 and k = 4, 85 KB at
// T = 64 and k = 8; FluidCell 144 T k bytes, 216 T k with two rows per
// phase (K5: 110.6 KB at T = 128 and k = 4). A strip is narrowed (256
// -> 128 -> 64) at launch while T k > 512 threads or its rings pass a
// block's shared memory. The strips in use were chosen by
// chip_smoke.py's sweeps at 4096^2 (ops/fused_fluid.STRIP,
// ops/fused_lbm.MULTI_STRIP, ops/fused_static.STRIP).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "imb.cuh"

namespace {

constexpr int kTBMaxThreads = 512;
constexpr int kTBMaxK = 8;
constexpr int kMaxDevices = 64;

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

// Per-inner-step sinks of NTCell at a block's output cells. WSteps (K6):
// inner step t's w_t into plane pair t of the (k, 2, ny, nx) scratch,
// where eps_raw > 0 (WSink). NoSink (K7): nothing.
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

// Cell policies: what a level does to the populations v[9] of one cell
// after level 0's load or a pull, leaving the post-collision populations
// in v. kSolid: the cell reads the solid stack (eps_raw, us_x, us_y),
// which level 0 loads and the later levels take from a ring. out: the
// cell is an output cell of the block, at global index `cell`.
//
// NTCell (K6, K7): the NT-blended collide of K2 and K8 (imb.cuh
// collide_cell under BGK; the TRT specialization below takes
// collide_cell_pairs and its scalars q) and the sink.
template <bool TRT, bool LES, bool LAMBDA, class Sink>
struct NTCell {
  static constexpr bool kSolid = true;
  const float* solid;  // (3, ny, nx)
  Sink sink;
  float tm;
  template <bool SHIFT>
  __device__ __forceinline__ void collide(int t, float* v, float e, float sx,
                                          float sy, const FluidParams& p,
                                          bool out, size_t cell) const {
    float fp[9], phix, phiy;
    collide_cell<SHIFT, LES, LAMBDA>(v, e, sx, sy, p, tm, fp, &phix, &phiy);
    if (out) sink.store(t, cell, e, phix, phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = fp[i];
  }
};

template <bool LES, bool LAMBDA, class Sink>
struct NTCell<true, LES, LAMBDA, Sink> {
  static constexpr bool kSolid = true;
  const float* solid;  // (3, ny, nx)
  Sink sink;
  float tm;
  PairParams q;
  template <bool SHIFT>
  __device__ __forceinline__ void collide(int t, float* v, float e, float sx,
                                          float sy, const FluidParams& p,
                                          bool out, size_t cell) const {
    float fp[9], phix, phiy;
    collide_cell_pairs<SHIFT, LES, LAMBDA>(v, e, sx, sy, p, q, tm, fp, &phix,
                                           &phiy);
    if (out) sink.store(t, cell, e, phix, phiy);
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = fp[i];
  }
};

// The NTCell of an instantiation: the TRT one carries q
template <bool TRT, bool LES, bool LAMBDA, class Sink>
inline NTCell<TRT, LES, LAMBDA, Sink> nt_cell(const float* solid, Sink sink,
                                              float tm, const PairParams& q) {
  if constexpr (TRT)
    return {solid, sink, tm, q};
  else
    return {solid, sink, tm};
}

// FluidCell (K5): the pure-fluid collide of K4 (d2q9.cuh
// fluid_collide_t) with its scalars q, the options fixed at compile time.
template <int TRT, int LES, int FORCED>
struct FluidCell {
  static constexpr bool kSolid = false;
  PairParams q;
  template <bool SHIFT>
  __device__ __forceinline__ void collide(int, float* v, float, float, float,
                                          const FluidParams& p, bool,
                                          size_t) const {
    fluid_collide_t<SHIFT, TRT, LES, FORCED>(v, p, q);
  }
};

// the ring of post-collision rows of one level: 4, or 6 with two rows per
// phase (2 ROWS + 2 rows are live at once)
template <int ROWS>
__host__ __device__ constexpr int ring_rows() {
  return 2 * ROWS + 2;
}

// dynamic shared memory of a block of T threads per level: k rings of
// 9 x T floats per row and, with a solid stack, a ring of 2k - 1 rows of
// 3 x T floats
template <int ROWS, bool SOLID>
inline size_t tblock_smem(int k, int threads) {
  return sizeof(float) * (size_t)threads *
         (9 * ring_rows<ROWS>() * k + (SOLID ? 3 * (2 * k - 1) : 0));
}

// The sweep (see the header). S, SO: the storage types of f and `out`;
// SHIFT: both hold the shifted form (bf16 storage, or an f32 scratch of
// a bf16 pass). MINB: __launch_bounds__'s blocks per
// SM, so a register cap: the BGK instantiations build for two blocks of
// 512 threads per SM (64 registers, no spills), so one block's work fills
// the other's barrier waits; TRT or LES for one, whose collide would
// spill at 64. ROWS: rows per level and phase (two: two independent
// collides per thread between barriers, half the barriers). PRE: 0 on
// the lattice; 1 ("y") or 2 ("yx") on a shard's pre-haloed frame `fr`
// (d2q9.cuh Frame): level 0 reads row y of the interior from frame row
// y + fr.hy (8 halo rows on f32, 16 on bf16), which holds exchanged data
// for the k <= fr.hy rows above and below the interior, and column x
// from frame column x + hx in "yx" mode (wrapped in x in "y" mode, where
// the shard spans the lattice's width); the walls and Zou/He closures
// that fire are those of p (the shard's global edges), and u_in is the
// inlet profile of the frame's rows. An NTCell reads its solid stack
// from the JAX solid window: 3 planes of the frame's pitch with
// kSolidHaloRows = 8 halo rows in both storages (row y at y + 8; k <= 8
// keeps the cone inside) and, in "yx" mode, 128 halo columns, at the f
// frame's column. The body is one device function; the lattice's
// kernel (temporal_block_kernel) and the frame's
// (temporal_block_prehalo_kernel) are two entries, so the lattice's
// keeps its own signature and code.
//
// On a frame the output is the (planes, ny, nx) interior (fo = {nx, 0,
// 0}) or, for a K5 sweep that feeds another (fluid.cu), a frame of fr's
// shape (fo = fr) that receives the interior and `ext` rings of cells
// around it ("y" mode: rows only): the cone the later sweeps read. Those
// cells are stepped as the interior is (each carries its local unwrapped
// coordinate), so the chained sweeps compute what one deep sweep would.
// The cone of the pass, k + ext, stays inside the frame's halo.
template <typename S, typename SO, bool SHIFT, int ROWS, class Cell, int PRE>
__device__ __forceinline__ void temporal_block_body(
    const S* __restrict__ f, const float* __restrict__ u_in,
    SO* __restrict__ out, Cell cell, int ny, int nx, int k, int rows,
    FluidParams p, Frame fr, int ext, Frame fo) {
  constexpr bool kShift = SHIFT;
  constexpr int RING = ring_rows<ROWS>();
  constexpr int LAG = ROWS + 1;
  static_assert(!Cell::kSolid || ROWS == 1, "the solid ring lags 2 rows");
  extern __shared__ float smem[];
  const int T = blockDim.x, lx = threadIdx.x;
  const int g = threadIdx.y;                     // group g runs level g
  const int ery = PRE ? ext : 0;                 // output rings past the
  const int erx = PRE == 2 ? ery : 0;            // interior, rows and cols
  const int y0 = blockIdx.y * rows - ery;        // first output row
  const int h = min(rows, ny + ery - y0);        // output rows
  const int gx = blockIdx.x * (T - 2 * k) - k + lx - erx;  // unwrapped
  const int cx = wrap(gx, nx);
  const size_t plane = (size_t)ny * nx;
  const size_t oplane = PRE ? (size_t)(ny + 2 * fo.hy) * fo.pitch : plane;
  // PRE: the planes of the f frame and of the solid window, and the
  // lane's frame column (lanes past the 2k-column cone that no output
  // needs read a clamped column); u_in from interior row 0 of the frame's
  // profile (d2q9.cuh stream_pull)
  const size_t fplane = PRE ? (size_t)(ny + 2 * fr.hy) * fr.pitch : plane;
  const size_t splane =
      PRE ? (size_t)(ny + 2 * kSolidHaloRows) * fr.pitch : plane;
  const int fx = PRE == 2 ? min(gx, nx + kHaloCols - 1) + fr.hx : cx;
  if (PRE && u_in != nullptr) u_in += fr.hy;
  const float shift = kShift ? p.rho0 : 0.0f;
  const int R = 2 * k - 1;
  // NTCell: [R][eps_raw, us_x, us_y][T]
  float* sol = smem + (size_t)9 * RING * k * T;
  const bool out_col = lx >= k && lx < T - k && gx < nx + erx;
  const bool stores = out_col && g == k - 1;  // level k: the store
  // Row j of the sweep is global row y0 - k + j. Level t collides rows j
  // in [t, h + 2k - t) (at phase (j + LAG t) / ROWS) into ring slot
  // j % RING; level k streams rows j in [k, k + h) into `out`.
  const int n0 = h + 2 * k;
  const int nph = (h + k - 1 + LAG * k) / ROWS + 1;
  // pull of row j, column lx from level lt - 1's ring
  auto pull = [&](int lt, int j, float* v) {
    const float* src = smem + (size_t)(lt - 1) * RING * 9 * T + lx;
    stream_pull<PRE != 0>([&](int i, int dy, int dx) {
      return src[(unsigned)(j + dy) % RING * 9 * T + i * T + dx];
    }, y0 - k + j, gx, ny, nx, u_in, p, shift, v);
  };
  int rs = (R - (2 * g) % R) % R;  // NTCell: (ph - 2g) mod R at ph = 0
  // level t's rows of phase ph (and, for NTCell, the solid ring's row)
  auto level = [&](int ph, int t) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = ROWS * ph - LAG * t + r;
      if (!(j >= t && j < n0 - t && lx >= t && lx < T - t)) continue;
      float v[9], e = 0.f, sx = 0.f, sy = 0.f;
      float* sr = sol + (size_t)rs * 3 * T + lx;
      if (t == 0) {  // row j from device memory
        const int y = y0 - k + j;
        const size_t c = PRE ? (size_t)(y + fr.hy) * fr.pitch + fx
                             : (size_t)wrap(y, ny) * nx + cx;
#pragma unroll
        for (int i = 0; i < 9; ++i) v[i] = load_f(f + i * fplane + c);
        if constexpr (Cell::kSolid) {
          const size_t cs =
              PRE ? (size_t)(y + kSolidHaloRows) * fr.pitch + fx : c;
          e = __ldg(cell.solid + cs);  // read-only, as a __restrict__ one
          sx = __ldg(cell.solid + splane + cs);
          sy = __ldg(cell.solid + 2 * splane + cs);
          if (k > 1) {
            sr[0] = e;
            sr[T] = sx;
            sr[2 * T] = sy;
          }
        }
      } else {  // row j from level t - 1 (solid: level 0's ring)
        pull(t, j, v);
        if constexpr (Cell::kSolid) {
          e = sr[0];
          sx = sr[T];
          sy = sr[2 * T];
        }
      }
      const bool oc = out_col && j >= k && j < k + h;
      cell.template collide<kShift>(t, v, e, sx, sy, p, oc,
                                    (size_t)(y0 - k + j) * nx + gx);
      float* dst = smem + ((size_t)t * RING + (unsigned)j % RING) * 9 * T;
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i * T + lx] = v[i];
    }
  };
  for (int ph = 0; ph < nph; ++ph) {
    level(ph, g);
    if (stores) {  // level k: the store
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int jo = ROWS * ph - LAG * k + r;
        if (jo < k || jo >= k + h) continue;
        float v[9];
        pull(k, jo, v);
        const size_t c =
            PRE ? (size_t)(y0 - k + jo + fo.hy) * fo.pitch + gx + fo.hx
                : (size_t)(y0 - k + jo) * nx + gx;
#pragma unroll
        for (int i = 0; i < 9; ++i) store_f(out + i * oplane + c, v[i]);
      }
    }
    if constexpr (Cell::kSolid) {
      if (++rs == R) rs = 0;
    }
    __syncthreads();
  }
}

template <typename S, typename SO, bool SHIFT, int ROWS, int MINB,
          class Cell>
__global__ void __launch_bounds__(kTBMaxThreads, MINB)
    temporal_block_kernel(const S* __restrict__ f,
                          const float* __restrict__ u_in, SO* __restrict__ out,
                          Cell cell, int ny, int nx, int k, int rows,
                          FluidParams p) {
  temporal_block_body<S, SO, SHIFT, ROWS, Cell, 0>(
      f, u_in, out, cell, ny, nx, k, rows, p, Frame{0, 0, 0}, 0,
      Frame{nx, 0, 0});
}

template <typename S, typename SO, bool SHIFT, int ROWS, int MINB,
          class Cell, int PRE>
__global__ void __launch_bounds__(kTBMaxThreads, MINB)
    temporal_block_prehalo_kernel(const S* __restrict__ f,
                                  const float* __restrict__ u_in,
                                  SO* __restrict__ out, Cell cell, int ny,
                                  int nx, int k, int rows, FluidParams p,
                                  Frame fr, int ext, Frame fo) {
  temporal_block_body<S, SO, SHIFT, ROWS, Cell, PRE>(f, u_in, out, cell, ny,
                                                     nx, k, rows, p, fr, ext,
                                                     fo);
}

// The device's opt-in shared memory per block, read once
inline int max_block_smem() {
  static int max_smem = 0;
  if (max_smem == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return max_smem;
}

// ext, fo: the frame-output mode of temporal_block_body (fo.pitch = 0:
// the interior); K5 only (a cell with a solid stack or a sink keeps the
// interior)
template <typename S, typename SO, bool SHIFT, int ROWS, int MINB,
          class Cell, int PRE = 0>
int launch_temporal_block(const void* f, const float* u_in, void* out,
                          Cell cell, int ny, int nx, int k, StripConfig strip,
                          const FluidParams& p, cudaStream_t stream,
                          Frame fr = Frame{0, 0, 0}, int ext = 0,
                          Frame fo = Frame{0, 0, 0}) {
  auto kernel = [] {
    if constexpr (PRE == 0)
      return temporal_block_kernel<S, SO, SHIFT, ROWS, MINB, Cell>;
    else
      return temporal_block_prehalo_kernel<S, SO, SHIFT, ROWS, MINB, Cell,
                                           PRE>;
  }();
  if (k < 1 || k > kTBMaxK || ext < 0 || (PRE && k + ext > fr.hy) ||
      (ext > 0 && (PRE == 0 || Cell::kSolid || fo.pitch != fr.pitch ||
                   fo.hx != fr.hx || fo.hy != fr.hy)))
    return (int)cudaErrorInvalidValue;
  if (fo.pitch == 0) fo = Frame{nx, 0, 0};
  const int max_smem = max_block_smem();
  int threads = strip.threads;
  while (threads > 64 &&
         (threads * k > kTBMaxThreads ||
          tblock_smem<ROWS, Cell::kSolid>(k, threads) > (size_t)max_smem))
    threads /= 2;
  if (threads * k > kTBMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t bytes = tblock_smem<ROWS, Cell::kSolid>(k, threads);
  // per instantiation and device: the attribute is a device's (the
  // shards of a mesh may sit on several cards)
  static size_t opted_in[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (bytes > std::max(opted_in[dev], (size_t)48 * 1024)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = bytes;
  }
  const int w = threads - 2 * k;
  const int oy = ext, ox = PRE == 2 ? ext : 0;  // output rings
  const int nbx = (nx + 2 * ox + w - 1) / w, rows = strip.rows;
  const dim3 grid(nbx, (ny + 2 * oy + rows - 1) / rows);
  if constexpr (PRE == 0)
    kernel<<<grid, dim3(threads, k), bytes, stream>>>(
        static_cast<const S*>(f), u_in, static_cast<SO*>(out), cell, ny, nx,
        k, rows, p);
  else
    kernel<<<grid, dim3(threads, k), bytes, stream>>>(
        static_cast<const S*>(f), u_in, static_cast<SO*>(out), cell, ny, nx,
        k, rows, p, fr, ext, fo);
  return (int)cudaGetLastError();
}

// K6 and K7: the NTCell instantiation for the options (LAMBDA matters only
// with LES, else the caller's tm already has the lambda form; q: the TRT
// pair form's scalars); 1 <= k <= 8. PRE: 0 on the lattice, 1 ("y") or 2
// ("yx") on a shard's frame `fr`, whose solid stack is the 8-row solid
// window (f32 or bf16 f)
template <typename S, class Sink, int PRE = 0>
int dispatch_temporal_block(const void* f, const float* solid,
                            const float* u_in, void* out, Sink sink, int ny,
                            int nx, int k, int lambda, StripConfig strip,
                            const FluidParams& p, float tm,
                            const PairParams& q, cudaStream_t stream,
                            Frame fr = Frame{0, 0, 0}) {
#define LBM_TB(TRT, LES, LAMBDA)                                          \
  launch_temporal_block<S, S, sizeof(S) == 2, 1, (TRT || LES) ? 1 : 2,    \
                        NTCell<TRT, LES, LAMBDA, Sink>, PRE>(             \
      f, u_in, out, nt_cell<TRT, LES, LAMBDA>(solid, sink, tm, q), ny,    \
      nx, k, strip, p, stream, fr)
  if (p.trt) {
    if (!p.les) return LBM_TB(true, false, false);
    return lambda ? LBM_TB(true, true, true) : LBM_TB(true, true, false);
  }
  if (!p.les) return LBM_TB(false, false, false);
  return lambda ? LBM_TB(false, true, true) : LBM_TB(false, true, false);
#undef LBM_TB
}

}  // namespace
