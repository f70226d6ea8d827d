// K3 and K3w: the DEM subcycle over slab planes - n_sub velocity-Verlet
// substeps of spring-dashpot contacts (normal spring-dashpot; tangential
// dashpot with Coulomb cap, or with kt > 0 the Cundall-Strack history
// spring), wall mirror contacts and the hydro + body forces, on wall or
// periodic axes.
//
// Replaces the TPU kernel lbmdem_tpu/ops/pallas_dem.py:_dem_kernel in its
// two flavours, one body here with two C entry points:
//  - K3, lbm_dem_subcycle (entry dem_subcycle -> _kernel_call): the
//    per-step slabs (11 channels, 51 with springs), hydro + body forces
//    baked into channels 7-9, 1/mass in channel 10, springs from 11;
//  - K3w, lbm_dem_subcycle_window (entry dem_subcycle_window ->
//    _kernel_call(forces3=..., slim=True)): the slim window slabs (8
//    channels, 48 with springs; 1/mass in channel 7, springs from 8),
//    forces from a separate (3, K, R, C) plane stack per inner step, so
//    the k chained calls of a coupling_k window share one slab build.
// The force source (a pointer to 3 planes of K * R * C floats), the 1/mass
// channel and the first spring channel are launch parameters of the one
// body.
//
// Beside them, the leftover fallback (lbm_dem_leftover, entry
// dem_subcycle / dem_subcycle_window -> _leftover_fallback, which the TPU
// runs as an XLA loop whose trip count is 0 without overflow): the
// contact-free velocity Verlet of the active disks that the slab build
// could not slot. The host never reads the build's overflow count: every
// thread reads it on the device and returns at once when it is 0, so
// without overflow a launch writes nothing and no step waits on the host.
//
// Slab layout (ops/slab_dem.build_slabs): channels (NCH, K, R, C), slot
// (k, s, l) = rank k of broadphase cell (s - 8, l); rows [0, 8) and
// [R - 8, R) are empty guard rows; empty slots hold r = 0 and every
// pair and wall test masks on r > 0. A disk's possible partners are the
// K slots of the 3 x 3 cells around it: uniform shifts, no gathers. On a
// periodic axis the cells tile the domain exactly, so the patch wraps by
// modular cell row (within the ncs real rows) or lane (within the ncl real
// lanes), partner coordinates stay raw and the pair law takes the minimum
// image; a slot is never its own partner.
//
// History springs (kt > 0): the stretch of the contact between slot
// (k, s, l) and its partner (k2, s + dy, l + dc) lives in channel
// xi0 + ((dy + 1) * 3 + (dc + 1)) * K + k2 at the slot itself, the four
// wall springs in the 4 channels after those 9 K. The first force
// evaluation (h = 0) reads the springs; every later one advances them by
// h and writes them back - each thread only its own slot's channels.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic. At
// the 4096^2 / 10k-disk slice a force evaluation covers the ~57k slots
// of 7 occupied bands (kmax <= 4 ranks, 9 x kmax partner slots each) and
// reads a few MB from L2; the bound is ~0.007 ms. The phases need
// grid-wide ordering (a force reads its neighbours' state after their
// kick-drift), and as 31 launches per call (force(h = 0), then n_sub x
// (kick-drift, force, kick) at n_sub = 10) each phase cost ~9.6 us of
// launch latency. Now the grid barriers and each phase's dependent chain
// (a slot's loads, then its 9 kmax pair laws in order) bound it.
//
// Design: ONE cooperative persistent launch per call
// (cudaLaunchCooperativeKernel; the grid is the occupancy's blocks per SM
// times the SMs, capped by the tiles the slab can have). Blocks stride
// over the tiles of 32 lanes x kTileRows rows of one OCCUPIED
// 8-row band x one rank (the band table of the binning; n_occ is read on
// the device, so any grid covers any slab; empty bands hold no disk and
// carry every channel through untouched, as on the TPU). A slot issues
// the loads of a rank's 9 partners before their pair laws run (and an
// empty slot skips them), so it waits on memory about twice per rank and
// not twice per partner. A slot's force feeds only its own kick, so the
// kick of substep t and the kick-drift of substep t + 1 run in one phase
// after the force that feeds both: phase 0 is force(h = 0) + kick-drift,
// phase t (1 <= t < n_sub) force + kick + kick-drift, phase n_sub force
// + kick: n_sub + 1 phases and n_sub grid barriers. The
// force stays in registers. The five channels a neighbour reads (x, y,
// vx, vy, omega) ping-pong between `slabs` and two scratch buffers:
// phase t reads buffer t and writes buffer t + 1, where buffer 0 and
// buffer n_sub + 1 are `slabs` and buffer t in between is scratch
// t mod 2, so no phase writes what another slot of the same phase reads
// and one barrier per phase suffices. theta, the springs and the
// constant channels are read and written only at their own slot, in
// place. Each slot's arithmetic is that of the 31-launch schedule in the
// same order, so the result is the same bit for bit. The contact count:
// block 0 zeroes the n_sub + 1 per-evaluation counters and a ticket at
// the start; each block adds its directed count of phase t after the
// barrier that follows it (so after the zeroing), and of the last phase
// before taking a ticket; the block that takes the last ticket writes the
// max over the evaluations, halved. The spring and wrap code are template
// flags: the kt = 0, wall-axes instantiation is the plain dashpot kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

struct DemParams {
  float kn, gn, gt, mu;  // normal stiffness/damping, tangential damping, mu
  float h, half_h;       // substep 1/n_sub and 0.5 * h
  float kt;              // tangential spring stiffness (0: dashpot only)
  float wrap_lx, wrap_ly;  // periodic wrap lengths of lattice x, y (0: walls)
  float wall_pos[4];     // W, E, S, N wall planes (-0.5, nx-0.5, -0.5, ny-0.5)
  int wall_on[4];
  int wrap_s, wrap_l;    // the slab's row / lane axis is periodic
  int ncs;               // real cell rows (plane rows [8, 8 + ncs))
};

// The leftover fallback's hydro forces (N, 2) and torques (N,) of each
// inner step of one launch, passed by value: disk i's force at fh[t] +
// i * fh_stride (its y one float further), its torque at th[t] + i *
// th_stride (the strides in floats, the same for every step; views of
// the hydro reduction's rows need no copy)
constexpr int kLeftoverSteps = 8;
struct LeftoverForces {
  const float* fh[kLeftoverSteps];
  const float* th[kLeftoverSteps];
  int fh_stride, th_stride;
};

namespace {

constexpr int kX = 0, kY = 1, kVX = 2, kVY = 3, kOM = 4, kTH = 5, kR = 6,
              kFHX = 7, kMINV = 10, kMINV_SLIM = 7, kXI0 = 11, kXI0_SLIM = 8;
constexpr int kLanes = 32;  // threads along the lane (C) axis
constexpr int kBand = 8;    // rows per band = threads along the row axis

struct Geom {
  int K, R, C, ncl;
  int minv;      // channel of 1/mass: kMINV, or kMINV_SLIM (window slabs)
  int xi0;       // first spring channel: kXI0, or kXI0_SLIM
  size_t plane;  // R * C
  __device__ size_t at(int ch, int k, int s, int l) const {
    return ((size_t)ch * K + k) * plane + (size_t)s * C + l;
  }
};

// spring-dashpot law of one (i, j) pair, as the TPU kernel's pair();
// j is a radius-0 mirror point for walls. Adds to the accumulators and
// returns whether the pair touches. WRAP: the minimum image on periodic
// axes (wall mirror points pass false). KT: `xi` holds the carried
// tangential stretch, advanced by adv (0 evaluates without advancing),
// and receives the slip-consistently truncated new stretch (0 when the
// pair does not touch). NDIV: the normal as d / dist, as the cell-list
// law (ops/dem._pair_force) takes it, in place of d * (1 / dist).
template <bool KT, bool WRAP, bool NDIV = false>
__device__ __forceinline__ bool pair(float xi, float yi, float vxi, float vyi,
                                     float omi, float ri, float xj, float yj,
                                     float vxj, float vyj, float omj, float rj,
                                     bool j_ok, const DemParams& p, float& fx,
                                     float& fy, float& tq, float adv,
                                     float& spring) {
  float dx = __fsub_rn(xi, xj);
  float dy = __fsub_rn(yi, yj);
  if constexpr (WRAP) {
    if (p.wrap_lx != 0.0f)
      dx = __fsub_rn(dx, __fmul_rn(p.wrap_lx, rintf(__fdiv_rn(dx, p.wrap_lx))));
    if (p.wrap_ly != 0.0f)
      dy = __fsub_rn(dy, __fmul_rn(p.wrap_ly, rintf(__fdiv_rn(dy, p.wrap_ly))));
  }
  float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  dist = fmaxf(dist, 1e-12f);
  const float delta = __fsub_rn(__fadd_rn(ri, rj), dist);
  const bool touching = j_ok && delta > 0.0f && ri > 0.0f;
  if (!touching) {
    if constexpr (KT) spring = 0.0f;
    return false;
  }
  float nx, ny;
  if constexpr (NDIV) {
    nx = __fdiv_rn(dx, dist);
    ny = __fdiv_rn(dy, dist);
  } else {
    const float inv = 1.0f / dist;
    nx = __fmul_rn(dx, inv);
    ny = __fmul_rn(dy, inv);
  }
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
  float ft;
  if constexpr (KT) {
    const float xi_t = __fadd_rn(spring, __fmul_rn(vt, adv));
    const float gv = __fmul_rn(p.gt, vt);
    ft = fminf(fmaxf(__fsub_rn(__fmul_rn(-p.kt, xi_t), gv), -cap), cap);
    spring = __fdiv_rn(-__fadd_rn(ft, gv), p.kt);
  } else {
    ft = fminf(fmaxf(__fmul_rn(-p.gt, vt), -cap), cap);
  }
  fx = __fadd_rn(fx, __fadd_rn(__fmul_rn(fn, nx), __fmul_rn(ft, tx)));
  fy = __fadd_rn(fy, __fadd_rn(__fmul_rn(fn, ny), __fmul_rn(ft, ty)));
  tq = __fadd_rn(tq, __fmul_rn(-li, ft));
  return true;
}

// The state channels a force reads at a neighbour (x, y, vx, vy,
// omega: slab channels 0-4), in `slabs` or in one ping-pong scratch
// buffer of the same (5, K, R, C) layout
constexpr int kNState = 5;

// One force evaluation at slot (k, s, l), whose state is (xi .. omi, ri):
// the contact forces from the partners' state in `st` (r from `sl`) plus
// the hydro + body force. With KT the springs advance by adv and, with
// write_xi, are written back to this slot's channels of `sl`. Adds the
// touching pairs to nc. An empty slot (ri = 0) touches nothing and keeps
// its (zero) springs. The loads of a rank's 9 partners are issued before
// their pair laws run, so a thread waits on memory once or twice per rank
// and not once or twice per partner; the pair laws then run and add up in
// the order (k2, dy, dc) of the plain version.
template <bool KT, bool WRAP>
__device__ __forceinline__ void slot_force(const float* __restrict__ st,
                                           float* __restrict__ sl,
                                           const float* __restrict__ hyd,
                                           const Geom& g, const DemParams& p,
                                           int kmax, int k, int s, int l,
                                           float xi, float yi, float vxi,
                                           float vyi, float omi, float ri,
                                           float adv, bool write_xi, int& nc,
                                           float& ffx, float& ffy,
                                           float& ftq) {
  float fx = 0.f, fy = 0.f, tq = 0.f;
  if (k < kmax && ri > 0.0f) {
    // the plane offsets of the 3 x 3 partner cells, and whether each is a
    // real cell (wrapped by index on a periodic axis)
    int cell[9];
    bool okc[9];
#pragma unroll
    for (int n = 0; n < 9; ++n) {
      const int dy = n / 3 - 1, dc = n % 3 - 1;
      int l2 = l + dc;
      int s2 = s + dy;  // guard rows keep s2 inside [0, R)
      bool ok = true;
      if (WRAP && p.wrap_l) {
        if (l >= g.ncl) ok = false;  // lane padding: an empty slot
        l2 = l2 < 0 ? l2 + g.ncl : (l2 >= g.ncl ? l2 - g.ncl : l2);
      } else if (l2 < 0 || l2 >= g.ncl) {
        ok = false;
      }
      if (WRAP && p.wrap_s) {
        const int r2 = s2 - 8;  // modular within the real cell rows
        if (s < 8 || s >= 8 + p.ncs) ok = false;  // row padding
        s2 = 8 + (r2 < 0 ? r2 + p.ncs : (r2 >= p.ncs ? r2 - p.ncs : r2));
      }
      cell[n] = s2 * g.C + l2;
      okc[n] = ok;
    }
    const int own = s * g.C + l;
    for (int k2 = 0; k2 < kmax; ++k2) {
      float rj[9], xj[9], yj[9], vxj[9], vyj[9], omj[9], spring[9];
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        const bool ok = okc[n] && !(k2 == k && cell[n] == own);  // itself
        rj[n] = ok ? sl[g.at(kR, k2, 0, 0) + cell[n]] : 0.0f;
        if constexpr (KT)
          spring[n] = sl[g.at(g.xi0 + n * g.K + k2, k, s, l)];
      }
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        const bool live = rj[n] > 0.0f;
        const size_t c = g.at(0, k2, 0, 0) + cell[n];
        const size_t pl = (size_t)g.K * g.plane;  // one channel
        xj[n] = live ? st[c + kX * pl] : 0.0f;
        yj[n] = live ? st[c + kY * pl] : 0.0f;
        vxj[n] = live ? st[c + kVX * pl] : 0.0f;
        vyj[n] = live ? st[c + kVY * pl] : 0.0f;
        omj[n] = live ? st[c + kOM * pl] : 0.0f;
      }
#pragma unroll
      for (int n = 0; n < 9; ++n) {
        float sp = KT ? spring[n] : 0.0f;
        bool touch = false;
        if (rj[n] > 0.0f)
          touch = pair<KT, WRAP>(xi, yi, vxi, vyi, omi, ri, xj[n], yj[n],
                                 vxj[n], vyj[n], omj[n], rj[n], true, p, fx,
                                 fy, tq, adv, sp);
        nc += touch;
        if (KT && write_xi)
          sl[g.at(g.xi0 + n * g.K + k2, k, s, l)] = touch ? sp : 0.0f;
      }
    }
    for (int wsl = 0; wsl < 4; ++wsl) {
      if (!p.wall_on[wsl]) continue;
      const float xw = wsl < 2 ? p.wall_pos[wsl] : xi;
      const float yw = wsl < 2 ? yi : p.wall_pos[wsl];
      float spring = 0.0f;
      float* xi_p = nullptr;
      if constexpr (KT) {
        xi_p = sl + g.at(g.xi0 + 9 * g.K + wsl, k, s, l);
        spring = *xi_p;
      }
      const bool touch =
          pair<KT, false>(xi, yi, vxi, vyi, omi, ri, xw, yw, 0.f, 0.f, 0.f,
                          0.f, true, p, fx, fy, tq, adv, spring);
      if (KT && write_xi) *xi_p = touch ? spring : 0.0f;
    }
  }
  const float act = ri > 0.0f ? 1.0f : 0.0f;
  const size_t pl3 = (size_t)g.K * g.plane;
  const size_t o = (size_t)k * g.plane + (size_t)s * g.C + l;
  ffx = __fmul_rn(__fadd_rn(fx, hyd[o]), act);
  ffy = __fmul_rn(__fadd_rn(fy, hyd[pl3 + o]), act);
  ftq = __fmul_rn(__fadd_rn(tq, hyd[2 * pl3 + o]), act);
}

// The whole subcycle in one cooperative launch (see the header). sl: the
// slabs, updated in place; hyd: the (3, K, R, C) hydro + body forces;
// buf: (2, 5, K, R, C) ping-pong scratch; counters: (n_sub + 2,) scratch
// (per-evaluation directed counts, then the ticket); n_contacts: (1,)
// out.
template <bool KT, bool WRAP>
__global__ void __launch_bounds__(kLanes * kBand)
    subcycle_kernel(float* __restrict__ sl, const float* __restrict__ hyd,
                    float* __restrict__ buf, int* __restrict__ counters,
                    int* __restrict__ n_contacts,
                    const int* __restrict__ kmax_p,
                    const int* __restrict__ n_occ_p,
                    const int* __restrict__ band_offs, Geom g, DemParams p,
                    int n_sub) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int block_nc;
  const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
  const int kmax = *kmax_p, n_occ = *n_occ_p;
  const int nbx = g.C / kLanes;
  const int parts = kBand / blockDim.y;  // tiles per band, lane block, rank
  const int tiles = nbx * n_occ * parts * g.K;
  const size_t stride = (size_t)kNState * g.K * g.plane;
  if (blockIdx.x == 0)
    for (int i = threadIdx.y * kLanes + threadIdx.x; i < n_sub + 2;
         i += kLanes * blockDim.y)
      counters[i] = 0;
  if (lead) block_nc = 0;
  __syncthreads();
  int pending = 0;  // the lead thread's block count of the last phase
  for (int ph = 0; ph <= n_sub; ++ph) {
    const float* st = ph == 0 ? sl : buf + (ph & 1) * stride;
    float* nxt = ph == n_sub ? sl : buf + ((ph + 1) & 1) * stride;
    int nc = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int bx = tile % nbx, part = (tile / nbx) % parts;
      const int rest = tile / (nbx * parts);
      const int k = rest / n_occ;
      const int s =
          band_offs[rest - k * n_occ] + part * blockDim.y + threadIdx.y;
      const int l = bx * kLanes + threadIdx.x;
      float x = st[g.at(kX, k, s, l)], y = st[g.at(kY, k, s, l)];
      float vx = st[g.at(kVX, k, s, l)], vy = st[g.at(kVY, k, s, l)];
      float om = st[g.at(kOM, k, s, l)];
      const float r = sl[g.at(kR, k, s, l)];
      float fx, fy, tq;
      slot_force<KT, WRAP>(st, sl, hyd, g, p, kmax, k, s, l, x, y, vx, vy, om,
                           r, ph == 0 ? 0.0f : p.h, KT && ph > 0, nc, fx, fy,
                           tq);
      const float minv = sl[g.at(g.minv, k, s, l)];
      const float inv_i =
          __fmul_rn(minv, 2.0f) / fmaxf(__fmul_rn(r, r), 1e-12f);
      const float a = r > 0.0f ? 1.0f : 0.0f;
      if (ph > 0) {  // second half-kick of substep ph - 1, fresh force
        vx = __fmul_rn(__fadd_rn(vx, __fmul_rn(__fmul_rn(p.half_h, fx), minv)),
                       a);
        vy = __fmul_rn(__fadd_rn(vy, __fmul_rn(__fmul_rn(p.half_h, fy), minv)),
                       a);
        om = __fmul_rn(
            __fadd_rn(om, __fmul_rn(__fmul_rn(p.half_h, tq), inv_i)), a);
      }
      if (ph < n_sub) {  // first half-kick + drift of substep ph (drift = 0
                         // only for empty slots: fixed disks have minv = 0
                         // and keep their prescribed v/omega)
        vx = __fadd_rn(vx, __fmul_rn(__fmul_rn(p.half_h, fx), minv));
        vy = __fadd_rn(vy, __fmul_rn(__fmul_rn(p.half_h, fy), minv));
        om = __fadd_rn(om, __fmul_rn(__fmul_rn(p.half_h, tq), inv_i));
        x = __fadd_rn(x, __fmul_rn(__fmul_rn(p.h, vx), a));
        y = __fadd_rn(y, __fmul_rn(__fmul_rn(p.h, vy), a));
        float* th = sl + g.at(kTH, k, s, l);
        *th = __fadd_rn(*th, __fmul_rn(__fmul_rn(p.h, om), a));
      }
      nxt[g.at(kX, k, s, l)] = x;
      nxt[g.at(kY, k, s, l)] = y;
      nxt[g.at(kVX, k, s, l)] = vx;
      nxt[g.at(kVY, k, s, l)] = vy;
      nxt[g.at(kOM, k, s, l)] = om;
    }
    // directed contact count of this evaluation
    const int w = __reduce_add_sync(0xffffffffu, nc);
    if ((threadIdx.x & 31) == 0 && w) atomicAdd(&block_nc, w);
    __syncthreads();
    if (lead) {
      pending = block_nc;
      block_nc = 0;
    }
    if (ph < n_sub) {
      grid.sync();  // also orders block 0's zeroing before every add
      if (lead && pending) atomicAdd(&counters[ph], pending);
    }
  }
  if (!lead) return;
  if (pending) atomicAdd(&counters[n_sub], pending);
  __threadfence();
  if (atomicAdd(&counters[n_sub + 1], 1) != (int)gridDim.x - 1) return;
  int m = 0;  // the last block: every count is in
  for (int t = 0; t <= n_sub; ++t)
    m = max(m, *(volatile const int*)&counters[t]);
  *n_contacts = m / 2;
}

// Rows of a band per block (of 1, 2, 4 and 8 the fastest at 4096^2,
// PERF.md section 6), and a test-only cap on the cooperative grid (0: the
// occupancy's grid)
constexpr int kTileRows = 4;
int grid_cap = 0;

template <bool KT, bool WRAP>
int subcycle(float* slabs, const float* hyd, float* buf, int* counters,
             int* n_contacts, const int* kmax, const int* n_occ,
             const int* band_offs, int nb, const Geom& g, int n_sub,
             const DemParams& p, cudaStream_t stream) {
  auto kernel = subcycle_kernel<KT, WRAP>;
  static int resident = 0, sms = 0;  // per instantiation
  if (resident == 0) {
    int dev = 0, coop = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return (int)cudaErrorNotSupported;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, kLanes * kTileRows, 0);
    if (err != cudaSuccess) return (int)err;
  }
  // every block must be resident; no more blocks than tiles the slab can
  // have (n_occ <= nb)
  const int most = (g.C / kLanes) * nb * (kBand / kTileRows) * g.K;
  int blocks = std::min(resident * sms, most);
  if (grid_cap > 0) blocks = std::min(blocks, grid_cap);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  Geom gg = g;
  DemParams pp = p;
  void* args[] = {&slabs,  (void*)&hyd,  &buf,       &counters,
                  &n_contacts, (void*)&kmax, (void*)&n_occ,
                  (void*)&band_offs, &gg, &pp, &n_sub};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                          dim3(kLanes, kTileRows), args, 0,
                                          stream);
}

int dispatch(float* slabs, const float* hyd, float* buf, int* counters,
             int* n_contacts, const int* kmax, const int* n_occ,
             const int* band_offs, int nb, int K, int R, int C, int ncl,
             int minv, int xi0, int n_sub, const DemParams& p,
             cudaStream_t stream) {
  if (n_sub < 1 || nb < 1 || C % kLanes) return (int)cudaErrorInvalidValue;
  const Geom g{K, R, C, ncl, minv, xi0, (size_t)R * C};
  const bool kt = p.kt > 0.0f;
  const bool wrap = p.wrap_s || p.wrap_l || p.wrap_lx != 0.0f ||
                    p.wrap_ly != 0.0f;
#define LBM_DEM(KT, WRAP)                                                  \
  subcycle<KT, WRAP>(slabs, hyd, buf, counters, n_contacts, kmax, n_occ,   \
                     band_offs, nb, g, n_sub, p, stream)
  if (kt) return wrap ? LBM_DEM(true, true) : LBM_DEM(true, false);
  return wrap ? LBM_DEM(false, true) : LBM_DEM(false, false);
#undef LBM_DEM
}

// The wall contacts of one disk (ops/dem.wall_forces): K3's pair law
// against each enabled wall's mirror point, without history and with
// h = 0, so with kt > 0 too the tangential force is the dashpot's; the
// normal as the cell-list law takes it (NDIV)
__device__ __forceinline__ void wall_forces(float x, float y, float vx,
                                            float vy, float om, float r,
                                            const DemParams& p, float& fx,
                                            float& fy, float& tq) {
  fx = fy = tq = 0.0f;
  float spring = 0.0f;  // unused without KT
  for (int w = 0; w < 4; ++w) {
    if (!p.wall_on[w]) continue;
    pair<false, false, true>(x, y, vx, vy, om, r, w < 2 ? p.wall_pos[w] : x,
                             w < 2 ? y : p.wall_pos[w], 0.f, 0.f, 0.f, 0.f,
                             true, p, fx, fy, tq, 0.0f, spring);
  }
}

constexpr int kLeftoverThreads = 256;

// One thread per disk. With overflow > 0, each active disk with no slot
// runs n_steps chained steps (hydro force and torque of step t from f),
// each one force evaluation then n_sub velocity-Verlet substeps under the
// wall contacts, f_hydro + body_f and t_hydro, in registers, in the
// order of the plain version (ops/slab_dem._fallback_integrate), and
// writes its x, v, omega and theta in place; thread 0 adds n_steps to
// the tally. What bounds it: the launch itself; without overflow a
// thread makes one load, with it a few disks' arithmetic.
__global__ void __launch_bounds__(kLeftoverThreads) leftover_verlet_kernel(
    const int* __restrict__ overflow, const int* __restrict__ slot,
    const bool* __restrict__ active, const bool* __restrict__ mobile,
    const float* __restrict__ r, const float* __restrict__ mass,
    const float* __restrict__ inertia, const float* __restrict__ body_f,
    LeftoverForces f, int n_steps, float* __restrict__ x,
    float* __restrict__ v, float* __restrict__ omega,
    float* __restrict__ theta, int* __restrict__ tally, int n, int n_sub,
    DemParams p) {
  if (*overflow == 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *tally += n_steps;
  if (i >= n || !active[i] || slot[i] >= 0) return;
  const float ri = r[i];
  const float inv_m = mobile[i] ? __fdiv_rn(1.0f, mass[i]) : 0.0f;
  const float inv_i = mobile[i] ? __fdiv_rn(1.0f, inertia[i]) : 0.0f;
  const float bfx = body_f[2 * i], bfy = body_f[2 * i + 1];
  float px = x[2 * i], py = x[2 * i + 1], vx = v[2 * i], vy = v[2 * i + 1];
  float om = omega[i], th = theta[i];
  for (int t = 0; t < n_steps; ++t) {
    const float* fh = f.fh[t] + (size_t)i * f.fh_stride;
    const float fhx = fh[0], fhy = fh[1];
    const float tht = f.th[t][(size_t)i * f.th_stride];
    float fx, fy, tq;
    wall_forces(px, py, vx, vy, om, ri, p, fx, fy, tq);
    fx = __fadd_rn(__fadd_rn(fx, fhx), bfx);
    fy = __fadd_rn(__fadd_rn(fy, fhy), bfy);
    tq = __fadd_rn(tq, tht);
    for (int s = 0; s < n_sub; ++s) {
      const float vhx =
          __fadd_rn(vx, __fmul_rn(__fmul_rn(p.half_h, fx), inv_m));
      const float vhy =
          __fadd_rn(vy, __fmul_rn(__fmul_rn(p.half_h, fy), inv_m));
      const float omh =
          __fadd_rn(om, __fmul_rn(__fmul_rn(p.half_h, tq), inv_i));
      px = __fadd_rn(px, __fmul_rn(p.h, vhx));
      py = __fadd_rn(py, __fmul_rn(p.h, vhy));
      th = __fadd_rn(th, __fmul_rn(p.h, omh));
      wall_forces(px, py, vhx, vhy, omh, ri, p, fx, fy, tq);
      fx = __fadd_rn(__fadd_rn(fx, fhx), bfx);
      fy = __fadd_rn(__fadd_rn(fy, fhy), bfy);
      tq = __fadd_rn(tq, tht);
      vx = __fadd_rn(vhx, __fmul_rn(__fmul_rn(p.half_h, fx), inv_m));
      vy = __fadd_rn(vhy, __fmul_rn(__fmul_rn(p.half_h, fy), inv_m));
      om = __fadd_rn(omh, __fmul_rn(__fmul_rn(p.half_h, tq), inv_i));
    }
  }
  x[2 * i] = px;
  x[2 * i + 1] = py;
  v[2 * i] = vx;
  v[2 * i + 1] = vy;
  omega[i] = om;
  theta[i] = th;
}

}  // namespace

// A cap on the cooperative grid of K3 and K3w in blocks (0: the
// occupancy's blocks per SM times the SMs), so that a test can make each
// block stride over several tiles. Returns cudaErrorInvalidValue for a
// negative cap.
extern "C" int lbm_dem_grid(int cap) {
  if (cap < 0) return (int)cudaErrorInvalidValue;
  grid_cap = cap;
  return 0;
}

// K3. slabs: (11, K, R, C) f32, or (51, K, R, C) when p.kt > 0, updated in
// place; buf: (2, 5, K, R, C) f32 scratch; counters: (n_sub + 2,) i32
// scratch; n_contacts: (1,) i32 out, the max over the force evaluations
// of the directed touching count, halved; kmax, n_occ: (1,) i32;
// band_offs: (nb,) i32 plane-row offsets of the occupied 8-row bands
// (first n_occ entries); n_sub >= 1, nb >= 1. One cooperative launch.
extern "C" int lbm_dem_subcycle(float* slabs, float* buf, int* counters,
                                int* n_contacts, const int* kmax,
                                const int* n_occ, const int* band_offs,
                                int nb, int K, int R, int C, int ncl,
                                int n_sub, DemParams p, cudaStream_t stream) {
  return dispatch(slabs, slabs + (size_t)kFHX * K * R * C, buf, counters,
                  n_contacts, kmax, n_occ, band_offs, nb, K, R, C, ncl, kMINV,
                  kXI0, n_sub, p, stream);
}

// K3w. slabs: the slim (8, K, R, C) f32 window slabs, or (48, K, R, C)
// when p.kt > 0, updated in place; forces3: (3, K, R, C) f32 hydro + body
// forces of this inner step; the rest as K3.
extern "C" int lbm_dem_subcycle_window(float* slabs, const float* forces3,
                                       float* buf, int* counters,
                                       int* n_contacts, const int* kmax,
                                       const int* n_occ,
                                       const int* band_offs, int nb, int K,
                                       int R, int C, int ncl, int n_sub,
                                       DemParams p, cudaStream_t stream) {
  return dispatch(slabs, forces3, buf, counters, n_contacts, kmax, n_occ,
                  band_offs, nb, K, R, C, ncl, kMINV_SLIM, kXI0_SLIM, n_sub,
                  p, stream);
}

// The leftover fallback, one launch on the stream. overflow: () i32, the
// build's count of active disks without a slot; slot: (n,) i32 slot of
// each disk (-1: none); active, mobile: (n,) bool; r, mass, inertia: (n,)
// f32; body_f: (n, 2) f32; f: n_steps (1..8) steps' hydro forces (n, 2)
// and torques (n,) f32, strided; x, v (n, 2), omega, theta (n,) f32, the
// state, updated in place at the disks it integrates; tally: () i32,
// += n_steps when overflow > 0. n = 0 launches nothing.
extern "C" int lbm_dem_leftover(const int* overflow, const int* slot,
                                const bool* active, const bool* mobile,
                                const float* r, const float* mass,
                                const float* inertia, const float* body_f,
                                LeftoverForces f, int n_steps, float* x,
                                float* v, float* omega, float* theta,
                                int* tally, int n, int n_sub, DemParams p,
                                cudaStream_t stream) {
  if (n_steps < 1 || n_steps > kLeftoverSteps || n_sub < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  leftover_verlet_kernel<<<(n + kLeftoverThreads - 1) / kLeftoverThreads,
                           kLeftoverThreads, 0, stream>>>(
      overflow, slot, active, mobile, r, mass, inertia, body_f, f, n_steps, x,
      v, omega, theta, tally, n, n_sub, p);
  return (int)cudaGetLastError();
}
