// K6: k coupled LBM steps in one pass over a FROZEN solid stack - the
// coupling_k window - with the per-(stamp tile, slot) hydro-force
// reduce of every inner step; every lattice option (BGK/TRT, LES, nt_mode,
// Guo forcing, static and moving walls, Zou/He, periodic axes) on f32 or
// shifted-bf16 storage.
//
// Replaces the TPU kernel
// lbmdem_tpu/ops/pallas_lbm.py:_imb_reduce_multi_kernel (line 1257; entry
// fused_step_imb_reduce_multi): the window-start solid stack and stamp
// binning hold for all k inner steps; only f streams, so the dependency
// cone of k steps is a k-cell halo.
//
// What bounds it on the H100: the collide's instruction issue (tblock.cuh
// has the count). Device memory per pass: f read and written once (72 B
// per cell in f32, 36 B in bf16), the solid stack read once (12 B), and
// w written per inner step where eps_raw > 0 (8 B on ~12 % of the
// cells): ~1.4 GB at 4096^2 in f32, ~0.42 ms at 3.35 TB/s.
//
// Design, two launches:
//  (a) tblock.cuh temporal_block_kernel with the WSteps sink: the row
//      sweep (strips of T - 2k output columns, levels 2 rows apart, one
//      ring of 4 rows per level in shared memory); at every inner step
//      the output cells with eps_raw > 0 write w_t = phi / max(eps_raw,
//      eps_min) into the (k, 2, ny, nx) scratch. Its collide and stream
//      are K2's, so f' and every w_t equal k chained K2 steps bit for bit
//      in f32 (bf16 rounds once per pass, as the TPU kernel does). Strip
//      width, height and shared memory per k: tblock.cuh and
//      lbm_imb_multi_strip below.
//  (b) reduce_kernel (imb.cuh): a warp per occupied slot and inner step,
//      writing partials[t][tile * cap + slot] - K2's reduce over a
//      second grid axis.
// No atomics: f' and the partials are deterministic.
//
// Pre-haloed mode (lbm_imb_multi_prehalo, the lattice mesh's coupling_k
// window): launch (a) reads a shard's f frame (d2q9.cuh Frame: 8 halo
// rows in f32, 16 in bf16) and solid window (8 rows in both, the
// dependency cone of k <= 8 steps) with, in "yx" mode, 128 halo columns
// per side, and writes the interior; the walls and
// the Zou/He closures of the shard's global edges run at every inner
// step (p.walls, p.open and the frame rows' inlet profile from the
// host). Launch (b) is K2's pre-haloed reduce over k inner steps: the
// interior tiles at the origin (oy, ox) of the disk records, eps_raw
// from the solid window. It replaces the prehalo, origin, edges and
// ny_glob branches of the TPU kernel (pallas_lbm.py:1257, the edge flags
// at :1299-1301). Bytes per pass: f and the solid window over the
// interior and its ring of k cells (rows only in "y" mode, where x
// wraps) read, f' written, w written per inner step where eps_raw > 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tblock.cuh"

namespace {

StripConfig strip{128, 128};

}  // namespace

// The strip of launch (a): threads per level (64, 128 or 256) and output
// rows per block (>= 1). Returns cudaErrorInvalidValue for anything else.
extern "C" int lbm_imb_multi_strip(int threads, int rows) {
  return set_strip(strip, threads, rows);
}

// f, out: (9, ny, nx) f32, or shifted bf16 when bf16 = 1 (distinct
// buffers); solid: (3, ny, nx) f32 [eps_raw, us_x, us_y], frozen for the
// k steps; u_in: (ny,) f32 inlet profile (read only when p.open); w:
// (k, 2, ny, nx) f32 scratch; tile_data/counts: the stamp binning
// ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles, ntx per row;
// partials: (k, n_tiles * cap, 4) f32; offsets: (n_tiles + 1,) i32
// scratch; cp: the coverage method and its
// constants; q: the TRT pair form's scalars (d2q9.cuh PairParams;
// unread under BGK); tm: the NT blend constant (tau - 1/2, or 3/16 /
// (tau - 1/2) when lambda = 1). 1 <= k <= 8.
extern "C" int lbm_imb_multi(const void* f, const float* solid,
                             const float* u_in, const float* tile_data,
                             const int* counts, void* out, float* w,
                             float* partials, int* offsets, int ny, int nx,
                             int th, int tw, int ntx, int n_tiles, int cap,
                             int window,
                             CovParams cp, int k, int bf16, int lambda,
                             FluidParams p, PairParams q, float tm,
                             float eps_min, cudaStream_t stream) {
  const WSteps sink{w, (size_t)ny * nx, eps_min};
  const int err =
      bf16 ? dispatch_temporal_block<__nv_bfloat16>(
                 f, solid, u_in, out, sink, ny, nx, k, lambda, strip, p, tm, q,
                 stream)
           : dispatch_temporal_block<float>(f, solid, u_in, out, sink, ny, nx,
                                            k, lambda, strip, p, tm, q,
                                            stream);
  if (err != 0) return err;
  return launch_reduce(WPlanes{w, (size_t)ny * nx}, solid, tile_data, counts,
                       offsets, partials, nx, th, tw, ntx, n_tiles, cap,
                       window, cp, k, stream);
}

// K6 on a shard's pre-haloed frame: f (9, ny + 2 hy, pitch) f32 (hy = 8)
// or shifted bf16 (bf16 = 1, hy = 16) and solid (3, ny + 16, pitch) f32,
// the interior at column hx (128 in "yx" mode, else 0; pitch = nx +
// 2 hx); out (9, ny, nx) of f's type; w (k, 2, ny, nx) scratch; the
// binning of the interior's th x tw tiles with disk records whose frame
// puts the interior's (0, 0) at (oy, ox); p carries the walls and Zou/He
// sides of the shard's global edges (p.open: bit 0 inlet, bit 1 outlet);
// u_in: (ny + 2 hy,) f32, the inlet profile at the frame's global rows
// (read only when p.open). 1 <= k <= 8.
extern "C" int lbm_imb_multi_prehalo(
    const void* f, const float* solid, const float* u_in,
    const float* tile_data, const int* counts, void* out, float* w,
    float* partials, int* offsets, int ny, int nx, int pitch, int hx, int oy,
    int ox, int th, int tw, int ntx, int n_tiles, int cap, int window,
    CovParams cp, int k, int bf16, int lambda, FluidParams p, PairParams q,
    float tm, float eps_min, cudaStream_t stream) {
  if (pitch != nx + 2 * hx || (hx != 0 && hx != kHaloCols) ||
      (p.open && u_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)ny * nx;
  const WSteps sink{w, plane, eps_min};
  const Frame fr{pitch, hx, frame_hy(bf16)};
#define LBM_K6P(S, PRE)                                                   \
  dispatch_temporal_block<S, WSteps, PRE>(f, solid, u_in, out, sink, ny,  \
                                          nx, k, lambda, strip, p, tm, q, \
                                          stream, fr)
  const int err = bf16 ? (hx ? LBM_K6P(__nv_bfloat16, 2)
                             : LBM_K6P(__nv_bfloat16, 1))
                       : (hx ? LBM_K6P(float, 2) : LBM_K6P(float, 1));
#undef LBM_K6P
  if (err != 0) return err;
  return launch_reduce(WPlanes{w, plane},
                       solid + (size_t)kSolidHaloRows * pitch + hx, tile_data,
                       counts, offsets, partials, nx, th, tw, ntx, n_tiles,
                       cap, window, cp, k, stream, pitch, oy, ox);
}
