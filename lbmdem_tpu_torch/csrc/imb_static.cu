// K7: k coupled LBM steps in one pass over a CONSTANT solid stack - the
// static-solid hoist of scenes whose disks are all fixed and at rest
// (porous beds, obstacle arrays, a cylinder in a channel).
//
// Replaces the TPU kernel
// lbmdem_tpu/ops/pallas_lbm.py:_imb_static_multi_kernel (line 911; entry
// fused_step_imb_static_multi). The solid stack (eps_raw, us_x, us_y) is
// stamped once for the whole run, so no reduce follows the collides; the
// drag on the obstacles is observed out of band (Simulation.hydro_forces).
//
// What bounds it on the H100: per pass f is read and written once (72 B
// per cell in f32, 36 B in bf16) and the solid stack read once (12 B):
// 1.41 GB at 4096^2 in f32 (0.81 GB in bf16), 0.42 ms (0.24 ms) at
// 3.35 TB/s; the collides' instruction issue comes first (tblock.cuh).
//
// Design: K6's launch (a), tblock.cuh temporal_block_kernel, with a sink
// that stores nothing: the row sweep over strips of T - 2k output columns
// with one ring of 4 rows per level in shared memory. Its collide and
// stream are K8's, so in f32 f' equals k chained K8 steps bit for bit; at
// ~99 % of the static cell's cells eps_raw = 0 and the collide takes its
// fluid branch. bf16 storage rounds once per pass.
//
// Pre-haloed mode (lbm_imb_static_multi_prehalo, the static hoist on the
// lattice mesh): the same sweep on a shard's f frame and solid window
// (d2q9.cuh Frame), the walls and Zou/He closures of the shard's global
// edges at every inner step; it replaces the prehalo, edges and ny_glob
// branches of the TPU kernel (pallas_lbm.py:911). The f frame has 8 halo
// rows in f32 and 16 in bf16, the solid window 8 in both (the JAX kernel
// pads it by hy - 8 rows to the f window, pallas_lbm.py:952-958; here the
// sweep reads it at its own rows), so k <= 8 in both storages, as the JAX
// kernel keeps (:988). Bytes per pass: f and the solid window over the
// interior and its ring of k cells (rows only in "y" mode) read, f'
// written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tblock.cuh"

namespace {

StripConfig strip{128, 64};

}  // namespace

// The strip of the kernel: threads per level (64, 128 or 256) and output
// rows per block (>= 1). Returns cudaErrorInvalidValue for anything else.
extern "C" int lbm_imb_static_strip(int threads, int rows) {
  return set_strip(strip, threads, rows);
}

// f, out: (9, ny, nx) f32 or shifted bf16 (bf16 = 1; distinct buffers);
// solid: (3, ny, nx) f32 [eps_raw, us_x, us_y], constant; u_in: (ny,) f32
// inlet profile (read only when p.open); q: the TRT pair form's scalars
// (d2q9.cuh PairParams; unread under BGK); tm: the NT blend constant
// (tau - 1/2, or 3/16 / (tau - 1/2) when lambda = 1); 1 <= k <= 8.
extern "C" int lbm_imb_static_multi(const void* f, const float* solid,
                                    void* out, const float* u_in, int ny,
                                    int nx, int k, int bf16, int lambda,
                                    FluidParams p, PairParams q, float tm,
                                    cudaStream_t stream) {
  return bf16 ? dispatch_temporal_block<__nv_bfloat16>(
                    f, solid, u_in, out, NoSink{}, ny, nx, k, lambda, strip,
                    p, tm, q, stream)
              : dispatch_temporal_block<float>(f, solid, u_in, out, NoSink{},
                                               ny, nx, k, lambda, strip, p, tm,
                                               q, stream);
}

// K7 on a shard's pre-haloed frame: f (9, ny + 2 hy, pitch) f32 (hy = 8)
// or shifted bf16 (bf16 = 1, hy = 16) and solid (3, ny + 16, pitch) f32,
// the interior at column hx (128 in "yx" mode, else 0; pitch = nx +
// 2 hx); out (9, ny, nx) of f's type; p carries the walls and Zou/He
// sides of the shard's global edges (p.open: bit 0 inlet, bit 1 outlet);
// u_in: (ny + 2 hy,) f32, the inlet profile at the frame's global rows
// (read only when p.open); 1 <= k <= 8.
extern "C" int lbm_imb_static_multi_prehalo(const void* f,
                                            const float* solid, void* out,
                                            const float* u_in, int ny, int nx,
                                            int pitch, int hx, int k,
                                            int bf16, int lambda,
                                            FluidParams p, PairParams q,
                                            float tm, cudaStream_t stream) {
  if (pitch != nx + 2 * hx || (hx != 0 && hx != kHaloCols) ||
      (p.open && u_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const Frame fr{pitch, hx, frame_hy(bf16)};
#define LBM_K7P(S, PRE)                                                     \
  dispatch_temporal_block<S, NoSink, PRE>(f, solid, u_in, out, NoSink{},    \
                                          ny, nx, k, lambda, strip, p, tm, \
                                          q, stream, fr)
  if (bf16)
    return hx ? LBM_K7P(__nv_bfloat16, 2) : LBM_K7P(__nv_bfloat16, 1);
  return hx ? LBM_K7P(float, 2) : LBM_K7P(float, 1);
#undef LBM_K7P
}
