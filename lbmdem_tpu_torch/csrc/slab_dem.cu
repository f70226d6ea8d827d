// K3 and K3w: the DEM subcycle over slab planes - n_sub velocity-Verlet
// substeps of spring-dashpot contacts (normal spring-dashpot,
// tangential dashpot with Coulomb cap), wall mirror contacts and the
// hydro + body forces.
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_dem.py:_dem_kernel
// (kt = 0, walls) in its two flavours, one body here with two C entry
// points:
//  - K3, lbm_dem_subcycle (entry dem_subcycle -> _kernel_call): the
//    per-step slabs (11 channels), hydro + body forces baked into
//    channels 7-9, 1/mass in channel 10;
//  - K3w, lbm_dem_subcycle_window (entry dem_subcycle_window ->
//    _kernel_call(forces3=..., slim=True)): the slim window slabs (8
//    channels, 1/mass in channel 7), forces from a separate (3, K, R, C)
//    plane stack per inner step, so the k chained calls of a coupling_k
//    window share one slab build.
// The force source (a pointer to 3 planes of K * R * C floats) and the
// 1/mass channel are launch parameters of the one body.
//
// Slab layout (ops/slab_dem.build_slabs): channels (11 or 8, K, R, C), slot
// (k, s, l) = rank k of broadphase cell (s - 8, l); rows [0, 8) and
// [R - 8, R) are empty guard rows; empty slots hold r = 0 and every
// pair and wall test masks on r > 0. A disk's possible partners are the
// K slots of the 3 x 3 cells around it: uniform shifts, no gathers.
//
// What bounds it on the H100: launch latency and the dependent phases,
// not bandwidth. At the 4096^2 / 10k-disk slice a force evaluation
// covers the ~57k slots of 7 occupied bands and reads a few MB from L2;
// the phases need grid-wide ordering, so each is its own launch:
// force(h = 0), then n_sub x (kick-drift, force, kick) = 31 launches
// per LBM step at n_sub = 10. Design: one thread per
// (rank k, cell) of the OCCUPIED 8-row bands only (the band table of the
// binning; empty bands hold no disk and pass through untouched, as on
// the TPU). The force evaluation writes only a (3, K, R, C) force
// scratch; kick-drift and kick read and write only their own slot, so
// every launch is race-free and slots no phase touches carry their input
// values. The contact count is a warp-summed integer atomicAdd per
// evaluation into its own counter; the caller takes the max over
// evaluations and halves it.
#include <cuda_runtime.h>

struct DemParams {
  float kn, gn, gt, mu;  // normal stiffness/damping, tangential damping, mu
  float h, half_h;       // substep 1/n_sub and 0.5 * h
  float wall_pos[4];     // W, E, S, N wall planes (-0.5, nx-0.5, -0.5, ny-0.5)
  int wall_on[4];
};

namespace {

constexpr int kX = 0, kY = 1, kVX = 2, kVY = 3, kOM = 4, kTH = 5, kR = 6,
              kFHX = 7, kMINV = 10, kMINV_SLIM = 7;
constexpr int kLanes = 32;  // threads along the lane (C) axis
constexpr int kBand = 8;    // rows per band = threads along the row axis

struct Geom {
  int K, R, C, ncl;
  int minv;      // channel of 1/mass: kMINV, or kMINV_SLIM (window slabs)
  size_t plane;  // R * C
  __device__ size_t at(int ch, int k, int s, int l) const {
    return ((size_t)ch * K + k) * plane + (size_t)s * C + l;
  }
};

// spring-dashpot law of one (i, j) pair, as the TPU kernel's pair();
// j is a radius-0 mirror point for walls. Adds to the accumulators and
// returns whether the pair touches.
__device__ __forceinline__ bool pair(float xi, float yi, float vxi, float vyi,
                                     float omi, float ri, float xj, float yj,
                                     float vxj, float vyj, float omj, float rj,
                                     bool j_ok, const DemParams& p, float& fx,
                                     float& fy, float& tq) {
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  dist = fmaxf(dist, 1e-12f);
  const float delta = __fsub_rn(__fadd_rn(ri, rj), dist);
  const bool touching = j_ok && delta > 0.0f && ri > 0.0f;
  if (!touching) return false;
  const float inv = 1.0f / dist;
  const float nx = __fmul_rn(dx, inv), ny = __fmul_rn(dy, inv);
  const float tx = -ny, ty = nx;
  const float li = __fsub_rn(ri, __fmul_rn(0.5f, delta));
  const float lj = __fsub_rn(rj, __fmul_rn(0.5f, delta));
  const float larm = __fadd_rn(__fmul_rn(omi, li), __fmul_rn(omj, lj));
  const float vrx = __fsub_rn(__fsub_rn(vxi, vxj), __fmul_rn(larm, tx));
  const float vry = __fsub_rn(__fsub_rn(vyi, vyj), __fmul_rn(larm, ty));
  const float vn = __fadd_rn(__fmul_rn(vrx, nx), __fmul_rn(vry, ny));
  const float vt = __fadd_rn(__fmul_rn(vrx, tx), __fmul_rn(vry, ty));
  const float fn = __fsub_rn(__fmul_rn(p.kn, delta), __fmul_rn(p.gn, vn));
  const float cap = __fmul_rn(p.mu, fabsf(fn));
  const float ft = fminf(fmaxf(__fmul_rn(-p.gt, vt), -cap), cap);
  fx = __fadd_rn(fx, __fadd_rn(__fmul_rn(fn, nx), __fmul_rn(ft, tx)));
  fy = __fadd_rn(fy, __fadd_rn(__fmul_rn(fn, ny), __fmul_rn(ft, ty)));
  tq = __fadd_rn(tq, __fmul_rn(-li, ft));
  return true;
}

// (k, s, l) of this thread, or false if its band is unoccupied
__device__ __forceinline__ bool slot_of_thread(const int* n_occ,
                                               const int* band_offs,
                                               const Geom& g, int& k, int& s,
                                               int& l) {
  if ((int)blockIdx.y >= *n_occ) return false;
  k = blockIdx.z;
  s = band_offs[blockIdx.y] + threadIdx.y;
  l = blockIdx.x * kLanes + threadIdx.x;
  return l < g.C;
}

__global__ void __launch_bounds__(kLanes * kBand)
    force_kernel(const float* __restrict__ sl, const float* __restrict__ hyd,
                 float* __restrict__ fscr,
                 int* __restrict__ counter, const int* __restrict__ kmax_p,
                 const int* __restrict__ n_occ,
                 const int* __restrict__ band_offs, Geom g, DemParams p) {
  int k, s, l;
  const bool mine = slot_of_thread(n_occ, band_offs, g, k, s, l);
  if ((int)blockIdx.y >= *n_occ) return;  // whole block: band unoccupied
  int nc = 0;
  if (mine) {
    const int kmax = *kmax_p;
    const float xi = sl[g.at(kX, k, s, l)], yi = sl[g.at(kY, k, s, l)];
    const float vxi = sl[g.at(kVX, k, s, l)], vyi = sl[g.at(kVY, k, s, l)];
    const float omi = sl[g.at(kOM, k, s, l)], ri = sl[g.at(kR, k, s, l)];
    float fx = 0.f, fy = 0.f, tq = 0.f;
    if (k < kmax) {
      for (int k2 = 0; k2 < kmax; ++k2) {
        for (int dy = -1; dy <= 1; ++dy) {
          for (int dc = -1; dc <= 1; ++dc) {
            const int l2 = l + dc;
            if (l2 < 0 || l2 >= g.ncl) continue;
            if (dy == 0 && dc == 0 && k2 == k) continue;
            const int s2 = s + dy;  // guard rows keep s2 inside [0, R)
            const float rj = sl[g.at(kR, k2, s2, l2)];
            if (!(rj > 0.0f)) continue;
            nc += pair(xi, yi, vxi, vyi, omi, ri, sl[g.at(kX, k2, s2, l2)],
                       sl[g.at(kY, k2, s2, l2)], sl[g.at(kVX, k2, s2, l2)],
                       sl[g.at(kVY, k2, s2, l2)], sl[g.at(kOM, k2, s2, l2)],
                       rj, true, p, fx, fy, tq);
          }
        }
      }
      for (int wsl = 0; wsl < 4; ++wsl) {
        if (!p.wall_on[wsl]) continue;
        const float xj = wsl < 2 ? p.wall_pos[wsl] : xi;
        const float yj = wsl < 2 ? yi : p.wall_pos[wsl];
        pair(xi, yi, vxi, vyi, omi, ri, xj, yj, 0.f, 0.f, 0.f, 0.f, true, p,
             fx, fy, tq);
      }
    }
    const float act = ri > 0.0f ? 1.0f : 0.0f;
    const size_t pl3 = (size_t)g.K * g.plane;
    const size_t o = (size_t)k * g.plane + (size_t)s * g.C + l;
    fscr[o] = __fmul_rn(__fadd_rn(fx, hyd[o]), act);
    fscr[pl3 + o] = __fmul_rn(__fadd_rn(fy, hyd[pl3 + o]), act);
    fscr[2 * pl3 + o] = __fmul_rn(__fadd_rn(tq, hyd[2 * pl3 + o]), act);
  }
  // directed contact count of this evaluation
  const int w = __reduce_add_sync(0xffffffffu, nc);
  if ((threadIdx.x & 31) == 0 && w) atomicAdd(counter, w);
}

// first half-kick + drift (drift = 0 only for empty slots: fixed disks
// have minv = 0 and keep their prescribed v/omega)
__global__ void __launch_bounds__(kLanes * kBand)
    kickdrift_kernel(float* __restrict__ sl, const float* __restrict__ fscr,
                     const int* __restrict__ n_occ,
                     const int* __restrict__ band_offs, Geom g, DemParams p) {
  int k, s, l;
  if (!slot_of_thread(n_occ, band_offs, g, k, s, l)) return;
  const size_t pl3 = (size_t)g.K * g.plane;
  const size_t o = (size_t)k * g.plane + (size_t)s * g.C + l;
  const float r = sl[g.at(kR, k, s, l)];
  const float minv = sl[g.at(g.minv, k, s, l)];
  const float inv_i = __fmul_rn(minv, 2.0f) / fmaxf(__fmul_rn(r, r), 1e-12f);
  const float a = r > 0.0f ? 1.0f : 0.0f;
  const float vxh = __fadd_rn(sl[g.at(kVX, k, s, l)],
                              __fmul_rn(__fmul_rn(p.half_h, fscr[o]), minv));
  const float vyh = __fadd_rn(sl[g.at(kVY, k, s, l)],
                              __fmul_rn(__fmul_rn(p.half_h, fscr[pl3 + o]), minv));
  const float omh = __fadd_rn(sl[g.at(kOM, k, s, l)],
                              __fmul_rn(__fmul_rn(p.half_h, fscr[2 * pl3 + o]), inv_i));
  sl[g.at(kX, k, s, l)] = __fadd_rn(sl[g.at(kX, k, s, l)], __fmul_rn(__fmul_rn(p.h, vxh), a));
  sl[g.at(kY, k, s, l)] = __fadd_rn(sl[g.at(kY, k, s, l)], __fmul_rn(__fmul_rn(p.h, vyh), a));
  sl[g.at(kTH, k, s, l)] = __fadd_rn(sl[g.at(kTH, k, s, l)], __fmul_rn(__fmul_rn(p.h, omh), a));
  sl[g.at(kVX, k, s, l)] = vxh;
  sl[g.at(kVY, k, s, l)] = vyh;
  sl[g.at(kOM, k, s, l)] = omh;
}

// second half-kick with the fresh force
__global__ void __launch_bounds__(kLanes * kBand)
    kick_kernel(float* __restrict__ sl, const float* __restrict__ fscr,
                const int* __restrict__ n_occ,
                const int* __restrict__ band_offs, Geom g, DemParams p) {
  int k, s, l;
  if (!slot_of_thread(n_occ, band_offs, g, k, s, l)) return;
  const size_t pl3 = (size_t)g.K * g.plane;
  const size_t o = (size_t)k * g.plane + (size_t)s * g.C + l;
  const float r = sl[g.at(kR, k, s, l)];
  const float minv = sl[g.at(g.minv, k, s, l)];
  const float inv_i = __fmul_rn(minv, 2.0f) / fmaxf(__fmul_rn(r, r), 1e-12f);
  const float a = r > 0.0f ? 1.0f : 0.0f;
  sl[g.at(kVX, k, s, l)] = __fmul_rn(
      __fadd_rn(sl[g.at(kVX, k, s, l)], __fmul_rn(__fmul_rn(p.half_h, fscr[o]), minv)), a);
  sl[g.at(kVY, k, s, l)] = __fmul_rn(
      __fadd_rn(sl[g.at(kVY, k, s, l)], __fmul_rn(__fmul_rn(p.half_h, fscr[pl3 + o]), minv)), a);
  sl[g.at(kOM, k, s, l)] = __fmul_rn(
      __fadd_rn(sl[g.at(kOM, k, s, l)], __fmul_rn(__fmul_rn(p.half_h, fscr[2 * pl3 + o]), inv_i)), a);
}

// The 1 + 3 n_sub launches of one subcycle: hyd is the (3, K, R, C)
// hydro + body force source, minv the 1/mass channel.
int subcycle(float* slabs, const float* hyd, float* fscr, int* counters,
             const int* kmax, const int* n_occ, const int* band_offs, int nb,
             int K, int R, int C, int ncl, int minv, int n_sub,
             const DemParams& p, cudaStream_t stream) {
  if (nb == 0) return 0;
  const Geom g{K, R, C, ncl, minv, (size_t)R * C};
  const dim3 grid((C + kLanes - 1) / kLanes, nb, K);
  const dim3 block(kLanes, kBand);
  force_kernel<<<grid, block, 0, stream>>>(slabs, hyd, fscr, counters, kmax,
                                           n_occ, band_offs, g, p);
  cudaError_t err = cudaGetLastError();
  for (int t = 0; t < n_sub && err == cudaSuccess; ++t) {
    kickdrift_kernel<<<grid, block, 0, stream>>>(slabs, fscr, n_occ, band_offs,
                                                 g, p);
    force_kernel<<<grid, block, 0, stream>>>(slabs, hyd, fscr,
                                             counters + t + 1, kmax, n_occ,
                                             band_offs, g, p);
    kick_kernel<<<grid, block, 0, stream>>>(slabs, fscr, n_occ, band_offs, g,
                                            p);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// K3. slabs: (11, K, R, C) f32, updated in place; fscr: (3, K, R, C) f32
// scratch; counters: (n_sub + 1,) i32, zeroed by the caller (one per
// force evaluation); kmax, n_occ: (1,) i32; band_offs: (nb,) i32 plane-
// row offsets of the occupied 8-row bands (first n_occ entries).
extern "C" int lbm_dem_subcycle(float* slabs, float* fscr, int* counters,
                                const int* kmax, const int* n_occ,
                                const int* band_offs, int nb, int K, int R,
                                int C, int ncl, int n_sub, DemParams p,
                                cudaStream_t stream) {
  return subcycle(slabs, slabs + (size_t)kFHX * K * R * C, fscr, counters,
                  kmax, n_occ, band_offs, nb, K, R, C, ncl, kMINV, n_sub, p,
                  stream);
}

// K3w. slabs: the slim (8, K, R, C) f32 window slabs, updated in place;
// forces3: (3, K, R, C) f32 hydro + body forces of this inner step; the
// rest as K3.
extern "C" int lbm_dem_subcycle_window(float* slabs, const float* forces3,
                                       float* fscr, int* counters,
                                       const int* kmax, const int* n_occ,
                                       const int* band_offs, int nb, int K,
                                       int R, int C, int ncl, int n_sub,
                                       DemParams p, cudaStream_t stream) {
  return subcycle(slabs, forces3, fscr, counters, kmax, n_occ, band_offs, nb,
                  K, R, C, ncl, kMINV_SLIM, n_sub, p, stream);
}
