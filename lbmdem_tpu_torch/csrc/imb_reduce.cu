// K2: one coupled LBM step - NT-blended collide (BGK or TRT, optional
// Smagorinsky LES, nt_mode "nt" or "lambda", Guo forcing), pull-stream,
// half-way bounce-back (static or moving walls), Zou/He inlet/outlet -
// on f32 or shifted-bf16 storage, with the per-(stamp tile, slot)
// hydrodynamic force reduce.
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_lbm.py:_imb_reduce_kernel
// (entry fused_step_imb_reduce), which runs _collide_window,
// _stream_and_bb and pallas_stamp.reduce_partials_banded per lattice tile.
//
// What bounds it on the H100: device-memory traffic. Per cell the step
// reads f (36 B; 18 B in bf16) and the solid stack (12 B) and writes f'
// (36 B; 18 B) and the share-weighted momentum exchange w (8 B): 92 B
// per cell in f32 (1.54 GB at 4096^2, 0.46 ms at 3.35 TB/s), 56 B in
// bf16. Design, two launches:
//  (a) imb.cuh coupled_step_kernel with WSink: one block per 16 x 32 cell
//      tile collides the tile plus a 1-cell halo into shared memory, pulls
//      each interior cell's 9 populations from its neighbours and writes
//      them to the OTHER f buffer; w = phi / max(eps_raw, eps_min) goes to
//      device memory in f32 for (b). The lattice options are template
//      flags, so the f32 BGK instantiation carries none of the others; K8
//      (imb_split.cu) launches the same kernel with a phi sink.
//  (b) reduce_kernel: one block per (stamp tile, slot). It sums cov * w
//      and the torque over the disk's window clipped to the tile with a
//      block reduction and writes partials[tile * cap + slot] =
//      [fx, fy, tq, 0]. Slots past the tile's count write zeros.
// No atomics: f' and the partials are deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "imb.cuh"

// f, fout: (9, ny, nx) f32, or shifted bf16 when bf16 = 1 (distinct
// buffers); solid: (3, ny, nx) f32 [eps_raw, us_x, us_y]; u_in: (ny,) f32
// inlet profile (read only when p.open); w: (2, ny, nx) f32 scratch;
// tile_data/counts: the stamp binning ((n_tiles, cap * 8), (n_tiles,)) of
// th x tw tiles, ntx per row; partials: (n_tiles * cap, 4) f32; method:
// the CovMethod of cfg.eps_method; tm: the NT blend constant (tau - 1/2,
// or 3/16 / (tau - 1/2) when lambda = 1).
extern "C" int lbm_imb_step(const void* f, const float* solid,
                            const float* u_in, const float* tile_data,
                            const int* counts, void* fout, float* w,
                            float* partials, int ny, int nx, int th, int tw,
                            int ntx, int n_tiles, int cap, int window, int ns,
                            float r_shift, int method, int bf16, int lambda,
                            FluidParams p, float tm, float eps_min,
                            cudaStream_t stream) {
  const size_t plane = (size_t)ny * nx;
  const WSink sink{w, plane, eps_min};
  const int err =
      bf16 ? dispatch_coupled_step<__nv_bfloat16>(
                 f, solid, solid + plane, solid + 2 * plane, u_in, fout, sink,
                 ny, nx, lambda, p, tm, stream)
           : dispatch_coupled_step<float>(f, solid, solid + plane,
                                          solid + 2 * plane, u_in, fout, sink,
                                          ny, nx, lambda, p, tm, stream);
  if (err != 0) return err;
  return launch_reduce(WPlanes{w, plane}, tile_data, counts, partials, ny, nx,
                       th, tw, ntx, n_tiles, cap, window, ns, r_shift, method,
                       1, stream);
}
