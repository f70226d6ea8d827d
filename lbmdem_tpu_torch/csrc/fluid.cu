// K4 and K5: pure-fluid LBM steps - moments, BGK/TRT (+ Smagorinsky
// LES), Guo forcing, pull streaming, half-way bounce-back with moving
// walls, Zou/He inlet/outlet - on f32 or shifted-bf16 storage.
//
// Replaces the TPU kernels lbmdem_tpu/ops/pallas_lbm.py:_fluid_kernel
// (K4, entry fused_step_fluid: one step per pass) and
// _fluid_multi_kernel (K5, entry fused_step_fluid_multi: k steps per
// pass, temporal blocking). Both are one templated body here, with k a
// launch argument (K4 is k = 1) and the storage type a template
// parameter; each has its own C entry point.
//
// What bounds it on the H100: at k = 1, device memory. Per cell a step
// reads f and writes f' (72 B in f32, 36 B in bf16): 1.2 GB per step
// at 4096^2, ~0.36 ms at 3.35 TB/s. Temporal blocking divides that
// traffic by k and moves the bound to the arithmetic: ~150-250 flops per
// cell and step (no FMA contraction, --fmad=false), times the halo
// recompute (1 + 2k/16)(1 + 2k/32), 1.9x at k = 4.
//
// Design: one block of 512 threads per 16 x 32 output tile. The block
// keeps a window of the tile plus a k-cell halo on every side in shared
// memory (periodic wrap at the domain edge, as the plain version's
// torch.roll). Pass 0 loads the window from f and collides it; each of
// the k - 1 inner steps pull-streams and collides the window shrunk by
// one more cell per side into the second window buffer; the last pass
// streams the interior straight to `out`, the caller's second f buffer
// (never f: other blocks still read their halos from it). Shared memory
// is 9 (16 + 2k)(32 + 2k) floats per buffer, two buffers when k > 1:
// 69 KB at k = 4, 110 KB at k = 8, 221 KB at k = 16 (bf16 only), under
// the 227 KB a block can have; that, and the halo recompute, bound k
// and the tile.
//
// Halo validity: every window cell carries its unwrapped global
// coordinate. Bounce-back and the Zou/He closures fire where that
// coordinate is on the global wall or open column, across the whole
// window: on a periodic axis the halo holds true wrapped data that must
// keep evolving exactly (the other axis's wall rule included); on a
// wall or open axis the halo beyond the edge is garbage, but the wall
// rule reads only its own cell, which cuts the dependency cone. The
// inlet profile is indexed by the global row mod ny. A domain smaller
// than the tile just holds the same cell more than once.
//
// bf16: loads the shifted populations g = f - w rho0, computes in f32
// in the shifted form (d2q9.cuh geq_eu), and rounds once per call with
// __float2bfloat16_rn: once per k steps in K5. The rest state g = 0 is
// a fixed point exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "d2q9.cuh"

namespace {

constexpr int kTX = 32;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;

template <typename S>
__global__ void __launch_bounds__(kThreads)
    fluid_kernel(const S* __restrict__ f, S* __restrict__ out,
                 const float* __restrict__ u_in, int ny, int nx, int k,
                 FluidParams p) {
  constexpr bool kShift = sizeof(S) == 2;  // bf16 storage
  extern __shared__ float smem[];
  const float shift = kShift ? p.rho0 : 0.0f;
  const int w = kTX + 2 * k, h = kTY + 2 * k, n = w * h;
  float* cur = smem;
  float* nxt = smem + 9 * n;
  const int gy0 = blockIdx.y * kTY - k;  // global row of window row 0
  const int gx0 = blockIdx.x * kTX - k;
  const size_t plane = (size_t)ny * nx;

  // pass 0: load and collide the whole window
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int ly = c / w, lx = c - ly * w;
    const size_t cell = (size_t)wrap(gy0 + ly, ny) * nx + wrap(gx0 + lx, nx);
    float v[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = load_f(f + i * plane + cell);
    fluid_collide<kShift>(v, p);
#pragma unroll
    for (int i = 0; i < 9; ++i) cur[i * n + c] = v[i];
  }
  __syncthreads();

  // inner steps: stream + collide the window shrunk by s cells per side
  for (int s = 1; s < k; ++s) {
    const int ws = w - 2 * s, hs = h - 2 * s;
    for (int c = threadIdx.x; c < ws * hs; c += kThreads) {
      const int ly = s + c / ws, lx = s + c % ws;
      const int wc = ly * w + lx;
      float v[9];
      stream_cell(cur, n, w, wc, gy0 + ly, gx0 + lx, ny, nx, u_in, p, shift,
                  v);
      fluid_collide<kShift>(v, p);
#pragma unroll
      for (int i = 0; i < 9; ++i) nxt[i * n + wc] = v[i];
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // last pass: stream the interior into the other f buffer
  const int ly = k + threadIdx.x / kTX, lx = k + threadIdx.x % kTX;
  const int gy = gy0 + ly, gx = gx0 + lx;
  if (gy >= ny || gx >= nx) return;
  float v[9];
  stream_cell(cur, n, w, ly * w + lx, gy, gx, ny, nx, u_in, p, shift, v);
  const size_t cell = (size_t)gy * nx + gx;
#pragma unroll
  for (int i = 0; i < 9; ++i) store_f(out + i * plane + cell, v[i]);
}

template <typename S>
int launch(const void* f, void* out, const float* u_in, int ny, int nx, int k,
           const FluidParams& p, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * 9 * (size_t)(kTX + 2 * k) *
                       (kTY + 2 * k) * (k > 1 ? 2 : 1);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fluid_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = bytes;
  }
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY);
  fluid_kernel<S><<<grid, kThreads, bytes, stream>>>(
      static_cast<const S*>(f), static_cast<S*>(out), u_in, ny, nx, k, p);
  return (int)cudaGetLastError();
}

int dispatch(const void* f, void* out, const float* u_in, int ny, int nx,
             int k, int bf16, const FluidParams& p, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(f, out, u_in, ny, nx, k, p, stream)
              : launch<float>(f, out, u_in, ny, nx, k, p, stream);
}

}  // namespace

// K4: one step. f, out: (9, ny, nx) f32 or bf16 (bf16 = 1; distinct
// buffers); u_in: (ny,) f32 inlet profile (read only when p.open).
extern "C" int lbm_fluid_step(const void* f, void* out, const float* u_in,
                              int ny, int nx, int bf16, FluidParams p,
                              cudaStream_t stream) {
  return dispatch(f, out, u_in, ny, nx, 1, bf16, p, stream);
}

// K5: k steps in one pass (1 <= k <= 8 for f32, <= 16 for bf16).
extern "C" int lbm_fluid_multi(const void* f, void* out, const float* u_in,
                               int ny, int nx, int k, int bf16,
                               FluidParams p, cudaStream_t stream) {
  return dispatch(f, out, u_in, ny, nx, k, bf16, p, stream);
}
