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
// 0.46 ms at 3.35 TB/s. Design: K2's launch (a), the one kernel
// imb.cuh coupled_step_kernel - one block of 512 threads per 16 x 32 tile
// collides the tile plus a 1-cell halo (wrapped at the domain edge) into
// shared memory and pulls each interior cell's populations from it, with
// bounce-back and the Zou/He closures on the cell's global coordinate -
// with a sink that stores phi where K2's stores w. Every f32
// instantiation is K2's, so K8's f' equals K2's bitwise.
//
// K9 replaces the TPU kernel lbmdem_tpu/ops/pallas_stamp.py:_reduce_kernel
// (entry reduce_hydro_forces). It is K2's launch (b), imb.cuh reduce_kernel,
// with a w source that computes w = phi * (1 / max(eps_raw, eps_min)) per
// cell in K2's expression, so K8 + K9 gives K2's partials bitwise. What
// bounds it: the per-cell coverage arithmetic of every binned window (ns^2
// sample tests, or the ramp/exact closed forms), not bytes: one block per
// (slot, tile) reads its window's eps and phi once.
#include <cuda_runtime.h>

#include "imb.cuh"

// K8. f, fout: (9, ny, nx) f32 (distinct buffers); eps, usx, usy: (ny, nx)
// f32 [eps_raw, us_x, us_y]; u_in: (ny,) f32 inlet profile (read only
// when p.open); phi: (2, ny, nx) f32 out [phi_x, phi_y]; tm: the NT blend
// constant (tau - 1/2, or 3/16 / (tau - 1/2) when lambda = 1).
extern "C" int lbm_imb_split_step(const float* f, const float* eps,
                                  const float* usx, const float* usy,
                                  const float* u_in, float* fout, float* phi,
                                  int ny, int nx, int lambda, FluidParams p,
                                  float tm, cudaStream_t stream) {
  return dispatch_coupled_step<float>(f, eps, usx, usy, u_in, fout,
                                      PhiSink{phi, (size_t)ny * nx}, ny, nx,
                                      lambda, p, tm, stream);
}

// K9. eps, phix, phiy: (ny, nx) f32; tile_data/counts: the stamp binning
// ((n_tiles, cap * 8), (n_tiles,)) of th x tw tiles, ntx per row;
// partials: (n_tiles * cap, 4) f32 out; method: the CovMethod of
// cfg.eps_method.
extern "C" int lbm_reduce_hydro(const float* eps, const float* phix,
                                const float* phiy, const float* tile_data,
                                const int* counts, float* partials, int ny,
                                int nx, int th, int tw, int ntx, int n_tiles,
                                int cap, int window, int ns, float r_shift,
                                float eps_min, int method,
                                cudaStream_t stream) {
  return launch_reduce(WFromPhi{eps, phix, phiy, eps_min}, tile_data, counts,
                       partials, ny, nx, th, tw, ntx, n_tiles, cap, window, ns,
                       r_shift, method, 1, stream);
}
