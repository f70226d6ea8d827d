// K2: one coupled LBM step - NT-blended collide (BGK or TRT, optional
// Smagorinsky LES, nt_mode "nt" or "lambda", Guo forcing), streaming,
// half-way bounce-back (static or moving walls), Zou/He inlet/outlet -
// on f32 or shifted-bf16 storage, with the per-(stamp tile, slot)
// hydrodynamic force reduce.
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_lbm.py:_imb_reduce_kernel
// (entry fused_step_imb_reduce), which runs _collide_window,
// _stream_and_bb and pallas_stamp.reduce_partials_banded per lattice tile.
//
// What bounds it on the H100: device-memory traffic. Per cell the step
// must read f (36 B; 18 B in bf16) and the solid stack (12 B) and write
// f' (36 B; 18 B): 84 B per cell in f32 (1.41 GB at 4096^2, 0.42 ms at
// 3.35 TB/s), 48 B in bf16 (0.24 ms). Design, two launches (three under
// Zou/He):
//  (a) imb.cuh coupled_step_kernel with WSink: push streaming, one
//      thread per cell in blocks of 32 x (threads / 32). Each cell is
//      loaded once, coalesced, collided once (no halo recompute, no
//      shared memory, no barrier) and its 9 post-collision populations
//      are written to their destinations in the OTHER f buffer, with
//      bounce-back as a write into the cell's own opposite slot. The
//      collide's two divides skip a zero numerator (imb.cuh div_nz; f
//      stays bitwise): the far field's B = 0 no longer takes the IEEE
//      divide's slow path. w = phi / max(eps_raw, eps_min) goes to device
//      memory only where eps_raw > 0 (~12 % of the cells). Under Zou/He a
//      one-thread-per-row launch closes columns 0 and nx - 1 from the f32
//      edge scratch. The lattice options are template flags, so the f32
//      BGK instantiation carries none of the others; K8 (imb_split.cu)
//      launches the same kernel with a phi sink.
//  (b) slot_offsets_kernel (one block: the prefix of the tiles' counts),
//      then reduce_kernel: a fixed grid whose warps take the occupied
//      slots only, one warp per slot. It sums cov * w and the torque over
//      the disk's window clipped to the tile, skipping cells with
//      eps_raw <= 0, and writes partials[tile * cap + slot] = [fx, fy,
//      tq, 0]; the same grid writes the zero rows past each tile's count,
//      so no block is spent on an empty slot. Coverage takes
//      coverage.cuh's fast path.
// No atomics: f' and the partials are deterministic.
//
// Pre-haloed mode (lbm_imb_step_prehalo, the lattice mesh): the step
// reads a shard's frame and solid window (d2q9.cuh Frame) and collides
// the interior and its ring of one cell, whose pushes bring the
// exchanged neighbours' populations in (imb.cuh
// coupled_step_prehalo_kernel); the reduce places the interior tiles at
// the origin (oy, ox) of the shard's stamp canvas, where the disk records
// live, and reads eps_raw from the window. It replaces the prehalo and
// origin branches of the TPU kernel (_imb_reduce_kernel's pre-haloed
// windows and oy/ox, pallas_lbm.py:1048). f is an f32 frame of 8 halo
// rows or a shifted-bf16 frame of 16 (d2q9.cuh Frame.hy, the JAX bf16
// granule), the solid window 8 rows in both: the step reads the f frame
// at its rows and the window at its own, as the JAX kernel reads
// win[hy - 1 ...] beside swin[_HY - 1 ...] (pallas_lbm.py:1093-1096).
// Bytes per step: f and the solid window over the interior and its ring
// of one cell (48 B per cell of (ny + 2)(nx [+ 2]), 30 B in bf16) read,
// f' (36 B per interior cell, 18 B in bf16) written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "imb.cuh"

// f, fout: (9, ny, nx) f32, or shifted bf16 when bf16 = 1 (distinct
// buffers); solid: (3, ny, nx) f32 [eps_raw, us_x, us_y]; u_in: (ny,) f32
// inlet profile and edge: (9, ny, 2) f32 scratch (both read only when
// p.open); w: (2, ny, nx) f32 scratch; tile_data/counts: the stamp
// binning ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles, ntx per row;
// partials: (n_tiles * cap, 4) f32; offsets: (n_tiles + 1,) i32
// scratch; cp: the coverage method and its
// constants; q: the TRT pair form's scalars (d2q9.cuh PairParams;
// unread under BGK); tm: the NT blend constant (tau - 1/2, or 3/16 /
// (tau - 1/2) when lambda = 1); threads: the step kernel's block size (a
// multiple of 32, at most 512).
extern "C" int lbm_imb_step(const void* f, const float* solid,
                            const float* u_in, const float* tile_data,
                            const int* counts, void* fout, float* w,
                            float* edge, float* partials, int* offsets,
                            int ny, int nx, int th, int tw, int ntx,
                            int n_tiles, int cap, int window, CovParams cp,
                            int bf16, int lambda, FluidParams p, PairParams q,
                            float tm, float eps_min, int threads,
                            cudaStream_t stream) {
  const size_t plane = (size_t)ny * nx;
  const WSink sink{w, plane, eps_min};
  const int err =
      bf16 ? dispatch_coupled_step<__nv_bfloat16>(
                 f, solid, solid + plane, solid + 2 * plane, u_in, fout, edge,
                 sink, ny, nx, lambda, p, tm, q, threads, stream)
           : dispatch_coupled_step<float>(
                 f, solid, solid + plane, solid + 2 * plane, u_in, fout, edge,
                 sink, ny, nx, lambda, p, tm, q, threads, stream);
  if (err != 0) return err;
  return launch_reduce(WPlanes{w, plane}, solid, tile_data, counts, offsets,
                       partials, nx, th, tw, ntx, n_tiles, cap, window, cp, 1,
                       stream);
}

// K2 on a shard's pre-haloed frame: f (9, ny + 2 hy, pitch) f32 (hy = 8)
// or shifted bf16 (bf16 = 1, hy = 16) and solid (3, ny + 16, pitch) f32,
// the interior at column hx (128 in "yx" mode, else 0; pitch = nx +
// 2 hx); fout (9, ny, nx) of f's type; w (2, ny, nx) scratch; the
// binning of the interior's th x tw tiles with disk records in canvas
// coordinates, the interior's (0, 0) at canvas cell (oy, ox); p carries
// only the x walls ("y" mode) or none ("yx"), and no Zou/He; erow (9, 2,
// nx) and ecol (9, ny, 2) f32, or null: the post-collision populations of
// the interior's first and last rows and columns (bf16: the shifted
// ones, unrounded).
extern "C" int lbm_imb_step_prehalo(
    const void* f, const float* solid, const float* tile_data,
    const int* counts, void* fout, float* w, float* erow, float* ecol,
    float* partials, int* offsets,
    int ny, int nx, int pitch, int hx, int oy, int ox, int th, int tw,
    int ntx, int n_tiles, int cap, int window, CovParams cp, int bf16,
    int lambda, FluidParams p, PairParams q, float tm, float eps_min,
    int threads, cudaStream_t stream) {
  if (pitch != nx + 2 * hx || (hx != 0 && hx != kHaloCols))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)ny * nx;
  const size_t splane = (size_t)(ny + 2 * kSolidHaloRows) * pitch;
  const Frame fr{pitch, hx, frame_hy(bf16)};
  const WSink sink{w, plane, eps_min};
  const EdgePost edge{erow, ecol};
  const int err =
      bf16 ? dispatch_coupled_step_prehalo<__nv_bfloat16>(
                 f, solid, solid + splane, solid + 2 * splane, fout, sink, ny,
                 nx, fr, lambda, p, tm, q, edge, threads, stream)
           : dispatch_coupled_step_prehalo<float>(
                 f, solid, solid + splane, solid + 2 * splane, fout, sink, ny,
                 nx, fr, lambda, p, tm, q, edge, threads, stream);
  if (err != 0) return err;
  return launch_reduce(WPlanes{w, plane},
                       solid + (size_t)kSolidHaloRows * pitch + hx, tile_data,
                       counts, offsets, partials, nx, th, tw, ntx, n_tiles,
                       cap, window, cp, 1, stream, pitch, oy, ox);
}
