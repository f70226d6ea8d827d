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
// 0.46 ms at 3.35 TB/s. Design: K2's launch (a), the one kernel imb.cuh
// coupled_step_kernel - push streaming, one thread per cell, each cell
// collided once, bounce-back as a write into the cell's own opposite
// slot, the Zou/He columns closed by a second small launch from an f32
// edge scratch - with a sink that stores phi at every cell where K2's
// stores w. Every f32 instantiation is K2's, so K8's f' equals K2's
// bitwise.
//
// Pre-haloed K8 (lbm_imb_split_step_prehalo): K2's pre-haloed step
// (imb.cuh coupled_step_prehalo_kernel, the interior and its ring of one
// cell collided, pushes into the interior) with the phi sink, so f' and
// the edges' post-collision populations equal K2's bitwise; it replaces
// the prehalo branch of the TPU kernel (pallas_lbm.py:1469, "y" or
// "yx", f32). The walls it skips are the caller's, as for K2. Bytes:
// f and the solid fields over the interior and its ring of one cell
// (48 B per cell) read, f' (36 B) and phi (8 B) per interior cell
// written.
//
// K9 replaces the TPU kernel lbmdem_tpu/ops/pallas_stamp.py:_reduce_kernel
// (entry reduce_hydro_forces). It is K2's launch (b), imb.cuh reduce_kernel
// (a warp per occupied slot, cells with eps_raw <= 0 skipped), with a w source that computes w = phi * (1 /
// max(eps_raw, eps_min)) per cell in K2's expression, so K8 + K9 gives
// K2's partials bitwise. What bounds it: the eps and phi of every binned
// window, read once, and the coverage arithmetic of the covered cells
// (coverage.cuh's fast path: the sample loop only on ring cells).
#include <cuda_runtime.h>

#include "imb.cuh"

// K8. f, fout: (9, ny, nx) f32 (distinct buffers); eps, usx, usy: (ny, nx)
// f32 [eps_raw, us_x, us_y]; u_in: (ny,) f32 inlet profile and edge:
// (9, ny, 2) f32 scratch (both read only when p.open); phi: (2, ny, nx)
// f32 out [phi_x, phi_y]; q: the TRT pair form's scalars (d2q9.cuh
// PairParams; unread under BGK); tm: the NT blend constant (tau - 1/2,
// or 3/16 / (tau - 1/2) when lambda = 1); threads: the block size
// (K2's).
extern "C" int lbm_imb_split_step(const float* f, const float* eps,
                                  const float* usx, const float* usy,
                                  const float* u_in, float* fout, float* phi,
                                  float* edge, int ny, int nx, int lambda,
                                  FluidParams p, PairParams q, float tm,
                                  int threads, cudaStream_t stream) {
  return dispatch_coupled_step<float>(f, eps, usx, usy, u_in, fout, edge,
                                      PhiSink{phi, (size_t)ny * nx}, ny, nx,
                                      lambda, p, tm, q, threads, stream);
}

// K8 on a shard's pre-haloed frame (f32): f (9, ny + 16, pitch) and eps,
// usx, usy (ny + 16, pitch), the interior at column hx (128 in "yx" mode,
// else 0; pitch = nx + 2 hx); fout (9, ny, nx); phi (2, ny, nx) out; p
// carries only the x walls ("y" mode) or none ("yx"), and no Zou/He;
// erow (9, 2, nx) and ecol (9, ny, 2) f32, or null: the post-collision
// populations of the interior's first and last rows and columns.
extern "C" int lbm_imb_split_step_prehalo(
    const float* f, const float* eps, const float* usx, const float* usy,
    float* fout, float* phi, float* erow, float* ecol, int ny, int nx,
    int pitch, int hx, int lambda, FluidParams p, PairParams q, float tm,
    int threads, cudaStream_t stream) {
  if (pitch != nx + 2 * hx || (hx != 0 && hx != kHaloCols))
    return (int)cudaErrorInvalidValue;
  return dispatch_coupled_step_prehalo<float>(
      f, eps, usx, usy, fout, PhiSink{phi, (size_t)ny * nx}, ny, nx,
      Frame{pitch, hx, frame_hy(0)}, lambda, p, tm, q, EdgePost{erow, ecol},
      threads, stream);
}

// K9. eps, phix, phiy: (ny, nx) f32; tile_data/counts: the stamp binning
// ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles, ntx per row;
// partials: (n_tiles * cap, 4) f32 out; offsets: (n_tiles + 1,) i32
// scratch; cp: the coverage method and its constants.
extern "C" int lbm_reduce_hydro(const float* eps, const float* phix,
                                const float* phiy, const float* tile_data,
                                const int* counts, float* partials,
                                int* offsets, int ny, int nx, int th, int tw,
                                int ntx, int n_tiles, int cap, int window,
                                CovParams cp, float eps_min,
                                cudaStream_t stream) {
  (void)ny;
  return launch_reduce(WFromPhi{phix, phiy, eps_min}, eps, tile_data, counts,
                       offsets, partials, nx, th, tw, ntx, n_tiles, cap,
                       window, cp, 1, stream);
}
