// Coupled-step device code shared by the fused IMB step (K2,
// imb_reduce.cu), its temporal block over a frozen solid stack (K6,
// imb_multi.cu), the static-solid temporal block (K7, imb_static.cu) and
// the split step (K8/K9, imb_split.cu): the NT-blended collide of one
// cell (the lattice options as template flags), the one-step push kernel
// that K2 and K8 launch (one thread per cell: collide once, push with
// bounce-back, then the Zou/He columns) with the momentum-exchange sink
// as a functor, and the per-stamp-tile hydro-force reduce with the w
// source as a functor.
//
// The arithmetic mirrors the plain version (ops/imb.collide_imb under
// BGK, ops/fused_fluid.collide_imb_pairs under TRT, ops/lbm.stream +
// apply_bounce_back + apply_open_boundaries,
// ops/stamp.hydro_partials_plain) with round-to-nearest intrinsics, under
// --fmad=false.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "coverage.cuh"
#include "d2q9.cuh"

namespace {

// e_i . u in the plain version's full form ex*ux + ey*uy
__device__ __forceinline__ float edot_full(int i, float ux, float uy) {
  return __fadd_rn(__fmul_rn((float)ex(i), ux), __fmul_rn((float)ey(i), uy));
}

// Equilibrium of population i at (rho, u): f_eq, or with SHIFT the
// shifted g_eq = f_eq - w_i rho0 (rho_b = sum of the shifted g)
template <bool SHIFT>
__device__ __forceinline__ float feq_nt(int i, float rho_b, float rho,
                                        float ux, float uy, float usq) {
  const float eu = edot_full(i, ux, uy);
  return SHIFT ? geq_eu(i, rho_b, rho, eu, usq) : feq_eu(i, rho, eu, usq);
}

// d / x for a divisor x > 0, with a zero numerator returned as it is:
// 0 / x is d itself (sign included), so the result is the IEEE quotient
// bit for bit, but a zero numerator skips the divide's slow path. About
// 88 % of the main path's cells have eps = 0 (B's numerator), and a
// fluid at rest has f = f_eq (the relaxation's).
__device__ __forceinline__ float div_nz(float d, float x) {
  return d == 0.0f ? d : d / x;
}

// The BGK relaxation of one cell after its moments, equilibria and tau
// (collide_cell): post-collision populations into fp[9] and phi. FLUID:
// the cell has eps == 0, so B is +0 and omb = 1 - B is 1 exactly; then
// omb * x is x, every B * Omega_i is +-0 and x + (+-0) is x (only the
// sign of a zero can change), so the fluid terms alone, in the same
// operations and order, give the full path's populations under == for
// finite inputs, and phi is 0 (tests/test_torch_collide_fastpath.py
// holds the rule on the plain version). That skips the nine equilibria at
// u_s, Omega_i, B Omega_i and the phi sums at ~88 % of the coupled
// cell's and ~99 % of the static cell's cells.
template <bool SHIFT, bool LES, bool FLUID>
__device__ __forceinline__ void relax_cell(const float* fc, const float* fe,
                                           float rs, float rho, float ux,
                                           float uy, float usx, float usy,
                                           float tau, float B,
                                           const FluidParams& p, float* fp,
                                           float* phix, float* phiy) {
  const float omb = __fsub_rn(1.0f, B);
  float ssq = 0.f;
  if constexpr (!FLUID)
    ssq = __fadd_rn(__fmul_rn(usx, usx), __fmul_rn(usy, usy));
  float px = 0.f, py = 0.f;
  float pref = p.guo_pref;
  if constexpr (LES) pref = __fsub_rn(1.0f, __fmul_rn(__frcp_rn(tau), 0.5f));
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float ne = __fsub_rn(fc[i], fe[i]);
    float v = __fsub_rn(fc[i], div_nz(FLUID ? ne : __fmul_rn(omb, ne), tau));
    float bom = 0.f;
    if constexpr (!FLUID) {
      const int o = opp(i);
      const float fes = feq_nt<SHIFT>(i, rs, rho, usx, usy, ssq);
      const float om =
          __fsub_rn(__fadd_rn(__fsub_rn(fc[o], fc[i]), fes), fe[o]);
      bom = __fmul_rn(B, om);
      v = __fadd_rn(v, bom);
    }
    if (p.forced) {
      const float src = __fmul_rn(
          pref, guo_proj(i, ux, uy, edot_full(i, ux, uy), p.gx, p.gy));
      v = __fadd_rn(v, FLUID ? src : __fmul_rn(omb, src));
    }
    fp[i] = v;
    if constexpr (!FLUID) {
      px = __fadd_rn(px, __fmul_rn(bom, (float)ex(i)));
      py = __fadd_rn(py, __fmul_rn(bom, (float)ey(i)));
    }
  }
  *phix = FLUID ? 0.0f : -px;
  *phiy = FLUID ? 0.0f : -py;
}

// NT-blended BGK collision of one cell (plain version: imb.collide_imb,
// operation by operation). fp[9] receives the post-collision
// populations; returns phi. p is the FluidParams of ops/fused_fluid;
// tm is the NT blend's tau - 1/2, or 3/16 / (tau - 1/2) under
// nt_mode="lambda", rounded from float64 as the plain version's Python
// scalar is. The options are compile-time flags:
//   SHIFT  fc holds g = f - w rho0 (bf16 storage); BGK, Guo and the NT
//          operator are linear in f - f_eq, so the update keeps its
//          form with g_eq for f_eq;
//   LES    Smagorinsky tau_eff per cell (lbm.smagorinsky_tau); B and the
//          Guo prefactor follow from it;
//   LAMBDA with LES: tm = 3/16 / (tau_eff - 1/2) per cell.
// The all-false instantiation is the f32 BGK collide of K2, K6, K7, K8.
// A cell with eps == 0 (eps_raw <= 0) takes relax_cell's fluid branch.
template <bool SHIFT, bool LES, bool LAMBDA>
__device__ __forceinline__ void collide_cell(const float* fc, float eps_raw,
                                             float usx, float usy,
                                             const FluidParams& p, float tm,
                                             float* fp, float* phix,
                                             float* phiy) {
  float rs = 0.f, jx = 0.f, jy = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) rs = __fadd_rn(rs, fc[i]);
#pragma unroll
  for (int i = 0; i < 9; ++i) jx = __fadd_rn(jx, __fmul_rn(fc[i], (float)ex(i)));
#pragma unroll
  for (int i = 0; i < 9; ++i) jy = __fadd_rn(jy, __fmul_rn(fc[i], (float)ey(i)));
  float rho = rs;
  if constexpr (SHIFT) rho = __fadd_rn(rs, p.rho0);
  const float inv_rho = 1.0f / rho;
  const float ux = __fmul_rn(__fadd_rn(jx, p.half_gx), inv_rho);
  const float uy = __fmul_rn(__fadd_rn(jy, p.half_gy), inv_rho);
  const float usq = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
  float fe[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) fe[i] = feq_nt<SHIFT>(i, rs, rho, ux, uy, usq);
  float tau = p.tau;
  if constexpr (LES) {  // ops/lbm.smagorinsky_tau, as K5's fluid_collide
    float pxx = 0.f, pyy = 0.f, pxy = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float ne = __fsub_rn(fc[i], fe[i]);
      if (ex(i) != 0) pxx = __fadd_rn(pxx, ne);
      if (ey(i) != 0) pyy = __fadd_rn(pyy, ne);
      if (ex(i) * ey(i) != 0) pxy = __fadd_rn(pxy, ex(i) * ey(i) > 0 ? ne : -ne);
    }
    const float pn = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(pxx, pxx), __fmul_rn(pyy, pyy)),
                  __fmul_rn(__fmul_rn(2.0f, pxy), pxy)));
    tau = __fmul_rn(0.5f, __fadd_rn(p.tau, __fsqrt_rn(__fadd_rn(
        p.tau_sq, __fdiv_rn(__fmul_rn(p.les_c, pn), rho)))));
    tm = __fsub_rn(tau, 0.5f);  // imb.nt_weight on the per-cell tau
    if constexpr (LAMBDA) tm = __fmul_rn(__frcp_rn(tm), 0.1875f);
  }
  const float eps = fminf(fmaxf(eps_raw, 0.0f), 1.0f);
  if (eps == 0.0f) {
    relax_cell<SHIFT, LES, true>(fc, fe, rs, rho, ux, uy, usx, usy, tau, 0.0f,
                                 p, fp, phix, phiy);
    return;
  }
  const float B =
      div_nz(__fmul_rn(eps, tm), __fadd_rn(__fsub_rn(1.0f, eps), tm));
  relax_cell<SHIFT, LES, false>(fc, fe, rs, rho, ux, uy, usx, usy, tau, B, p,
                                fp, phix, phiy);
}

// NT-blended TRT collision of one cell in the pair form of the TPU
// kernels (lbmdem_tpu/ops/pallas_lbm.py _collide_window with eps given;
// plain version: ops/fused_fluid.collide_imb_pairs, operation by
// operation). The moments, equilibria and LES tau are those of
// d2q9.cuh fluid_collide_t: per direction pair S = f_i + f_opp and D =
// f_i - f_opp, the equilibria E +- O, the even part S/2 - E relaxed at
// 1/tau and the odd part D/2 - O at 1/tau-. Then the blend: B = eps tm /
// ((1 - eps) + tm) (with LES tm per cell, 3/16 / tm a divide under
// LAMBDA), the rest population f0 - (1 - B)/tau (f0 - feq0) + B (feq0_s
// - feq0), each pair f_i - (1 - B) rt_i + B (W + Q + P) and f_opp - (1 -
// B) rt_opp + B (P - W - Q), with the equilibria at u_s giving P = E_s -
// E and W + Q = O_s + O - D, phi -= e_i 2 B (W + Q), and Guo's even/odd
// source scaled by 1 - B. q holds the scalars the JAX trace folds from
// Python floats (without LES: 1/tau, 1/tau-, the Guo factors). A cell
// with eps == 0 takes the fluid terms alone: there B is +0 and 1 - B is
// 1 exactly, so relax = inv_tau, every B term adds +-0 and 1 - B scales
// nothing, and the populations equal the full path's under == for
// finite inputs, phi 0 (tests/test_torch_coupled_pairs.py holds the rule
// on the plain version). SHIFT, LES, LAMBDA as collide_cell's.
template <bool SHIFT, bool LES, bool LAMBDA>
__device__ __forceinline__ void collide_cell_pairs(
    const float* f, float eps_raw, float usx, float usy, const FluidParams& p,
    const PairParams& q, float tm, float* fp, float* phix, float* phiy) {
  float S[4], D[4];
  float rs = f[0];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = pair_rep(k);
    S[k] = __fadd_rn(f[i], f[opp(i)]);
    rs = __fadd_rn(rs, S[k]);
    D[k] = __fsub_rn(f[i], f[opp(i)]);
  }
  const float jx = __fsub_rn(__fadd_rn(D[0], D[2]), D[3]);
  const float jy = __fadd_rn(__fadd_rn(D[1], D[2]), D[3]);
  const float rho = SHIFT ? __fadd_rn(rs, p.rho0) : rs;
  const float inv_rho = __frcp_rn(rho);
  const float ux = __fmul_rn(__fadd_rn(jx, p.half_gx), inv_rho);
  const float uy = __fmul_rn(__fadd_rn(jy, p.half_gy), inv_rho);
  const float usq = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
  const float rho_b = SHIFT ? rs : rho;
  const float rho3 = __fmul_rn(3.0f, rho);
  const float m15 = __fmul_rn(-1.5f, usq);
  const float feq0 =
      __fmul_rn(weight(0), __fadd_rn(rho_b, __fmul_rn(rho, m15)));
  float eu[4], E[4], O[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = pair_rep(k);
    eu[k] = edot(i, ux, uy);
    E[k] = __fmul_rn(weight(i), __fadd_rn(rho_b, __fmul_rn(rho, __fadd_rn(
        __fmul_rn(4.5f, __fmul_rn(eu[k], eu[k])), m15))));
    O[k] = __fmul_rn(__fmul_rn(weight(i), rho3), eu[k]);
  }
  float inv_tau = q.inv_tau, inv_tau_m = q.inv_tau_m, fpref = 0.f,
        opref = 0.f;
  if constexpr (LES) {  // ops/lbm.smagorinsky_tau, as fluid_collide_t
    float pxx = 0.f, pyy = 0.f, pxy = 0.f;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      const int k = pair_of(i);
      const float fe =
          is_rep(i) ? __fadd_rn(E[k], O[k]) : __fsub_rn(E[k], O[k]);
      const float ne = __fsub_rn(f[i], fe);
      if (ex(i) != 0) pxx = __fadd_rn(pxx, ne);
      if (ey(i) != 0) pyy = __fadd_rn(pyy, ne);
      if (ex(i) * ey(i) != 0) pxy = ex(i) * ey(i) > 0 ? __fadd_rn(pxy, ne)
                                                      : __fsub_rn(pxy, ne);
    }
    const float pn = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(pxx, pxx), __fmul_rn(pyy, pyy)),
                  __fmul_rn(__fmul_rn(2.0f, pxy), pxy)));
    const float tau = __fmul_rn(0.5f, __fadd_rn(p.tau, __fsqrt_rn(__fadd_rn(
        p.tau_sq, __fdiv_rn(__fmul_rn(p.les_c, pn), rho)))));
    tm = __fsub_rn(tau, 0.5f);
    if constexpr (LAMBDA) tm = __fdiv_rn(0.1875f, tm);
    inv_tau = __frcp_rn(tau);
    fpref = __fsub_rn(1.0f, __fmul_rn(0.5f, inv_tau));
    inv_tau_m = __frcp_rn(__fadd_rn(
        0.5f, __fdiv_rn(p.trt_magic, __fsub_rn(tau, 0.5f))));
    opref = __fsub_rn(1.0f, __fmul_rn(0.5f, inv_tau_m));
  }
  float ug3 = 0.f;
  if (p.forced)
    ug3 = __fmul_rn(3.0f, __fadd_rn(__fmul_rn(ux, p.gx), __fmul_rn(uy, p.gy)));
  const float eps = fminf(fmaxf(eps_raw, 0.0f), 1.0f);
  // FLUID: eps == 0, the fluid terms alone (see above)
  auto relax = [&](auto fluid) {
    constexpr bool FLUID = decltype(fluid)::value;
    float B = 0.f, omb = 1.f, m15s = 0.f, px = 0.f, py = 0.f;
    if constexpr (!FLUID) {
      B = __fdiv_rn(__fmul_rn(eps, tm), __fadd_rn(__fsub_rn(1.0f, eps), tm));
      omb = __fsub_rn(1.0f, B);
      m15s = __fmul_rn(-1.5f, __fadd_rn(__fmul_rn(usx, usx),
                                        __fmul_rn(usy, usy)));
    }
    float v0 = __fsub_rn(f[0], __fmul_rn(FLUID ? inv_tau
                                               : __fmul_rn(omb, inv_tau),
                                         __fsub_rn(f[0], feq0)));
    if constexpr (!FLUID) {
      const float feq0s =
          __fmul_rn(weight(0), __fadd_rn(rho_b, __fmul_rn(rho, m15s)));
      v0 = __fadd_rn(v0, __fmul_rn(B, __fsub_rn(feq0s, feq0)));
    }
    if (p.forced) {
      const float gw0 = LES ? __fmul_rn(weight(0), fpref) : q.gw[0];
      const float src0 = __fmul_rn(gw0, -ug3);
      v0 = __fadd_rn(v0, FLUID ? src0 : __fmul_rn(omb, src0));
    }
    fp[0] = v0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = pair_rep(k), o = opp(i);
      const float ne_e =
          __fmul_rn(inv_tau, __fsub_rn(__fmul_rn(0.5f, S[k]), E[k]));
      const float ne_o =
          __fmul_rn(inv_tau_m, __fsub_rn(__fmul_rn(0.5f, D[k]), O[k]));
      const float rt_i = __fadd_rn(ne_e, ne_o), rt_o = __fsub_rn(ne_e, ne_o);
      float vi, vo;
      if constexpr (FLUID) {
        vi = __fsub_rn(f[i], rt_i);
        vo = __fsub_rn(f[o], rt_o);
      } else {
        const float eus = edot(i, usx, usy);
        const float Es = __fmul_rn(weight(i), __fadd_rn(rho_b, __fmul_rn(
            rho, __fadd_rn(__fmul_rn(4.5f, __fmul_rn(eus, eus)), m15s))));
        const float Os = __fmul_rn(__fmul_rn(weight(i), rho3), eus);
        const float P = __fsub_rn(Es, E[k]);
        const float WQ = __fsub_rn(__fadd_rn(Os, O[k]), D[k]);
        vi = __fadd_rn(__fsub_rn(f[i], __fmul_rn(omb, rt_i)),
                       __fmul_rn(B, __fadd_rn(WQ, P)));
        vo = __fadd_rn(__fsub_rn(f[o], __fmul_rn(omb, rt_o)),
                       __fmul_rn(B, __fsub_rn(P, WQ)));
        const float pp = __fmul_rn(__fmul_rn(2.0f, B), WQ);
        if (ex(i) != 0) px = ex(i) > 0 ? __fsub_rn(px, pp) : __fadd_rn(px, pp);
        if (ey(i) != 0) py = ey(i) > 0 ? __fsub_rn(py, pp) : __fadd_rn(py, pp);
      }
      if (p.forced) {
        const float gw = LES ? __fmul_rn(weight(i), fpref) : q.gw[k + 1];
        const float even =
            __fmul_rn(gw, __fsub_rn(__fmul_rn(q.eg9[k], eu[k]), ug3));
        float si = even, so = even;
        if (q.w3eg[k] != 0.f) {  // e_i . g != 0
          const float odd = LES ? __fmul_rn(q.w3eg[k], opref) : q.godd[k];
          si = __fadd_rn(even, odd);
          so = __fsub_rn(even, odd);
        }
        vi = __fadd_rn(vi, FLUID ? si : __fmul_rn(omb, si));
        vo = __fadd_rn(vo, FLUID ? so : __fmul_rn(omb, so));
      }
      fp[i] = vi;
      fp[o] = vo;
    }
    *phix = px;
    *phiy = py;
  };
  if (eps == 0.0f)
    relax(std::true_type{});
  else
    relax(std::false_type{});
}

// The scalars of a collide instantiation beyond FluidParams: PairParams
// for the TRT pair form, nothing for BGK (an empty argument, passed last,
// so a BGK kernel's other parameters keep their places)
struct NoPairs {};
template <bool TRT>
using PairArg = std::conditional_t<TRT, PairParams, NoPairs>;
template <bool TRT>
__host__ __device__ inline PairArg<TRT> pair_arg(const PairParams& q) {
  if constexpr (TRT)
    return q;
  else
    return NoPairs{};
}

// The coupled collide of an instantiation: the pair form under TRT, the
// index-order BGK collide_cell otherwise
template <bool SHIFT, bool TRT, bool LES, bool LAMBDA>
__device__ __forceinline__ void coupled_collide(
    const float* fc, float eps_raw, float usx, float usy,
    const FluidParams& p, const PairArg<TRT>& q, float tm, float* fp,
    float* phix, float* phiy) {
  if constexpr (TRT)
    collide_cell_pairs<SHIFT, LES, LAMBDA>(fc, eps_raw, usx, usy, p, q, tm,
                                           fp, phix, phiy);
  else
    collide_cell<SHIFT, LES, LAMBDA>(fc, eps_raw, usx, usy, p, tm, fp, phix,
                                     phiy);
}


// Sinks of the one-step kernel's momentum exchange at a cell. WSink (K2)
// stores w = phi * (1 / max(eps_raw, eps_min)), the share-weighted
// exchange its reduce sums, only where eps_raw > 0: elsewhere B = 0 makes
// phi (and w) +-0, a term the reduce skips by reading eps_raw, so the
// scratch there is never read. PhiSink (K8) stores the raw phi at every
// cell (it is K8's output) for the standalone reduce (K9), whose
// WFromPhi source applies WSink's expression, so K8 + K9 give K2's
// partials bitwise.
struct WSink {
  float* w;  // (2, ny, nx)
  size_t plane;
  float eps_min;
  __device__ __forceinline__ void store(size_t cell, float eps_raw, float phix,
                                        float phiy) const {
    if (!(eps_raw > 0.0f)) return;
    const float sd = 1.0f / fmaxf(eps_raw, eps_min);
    w[cell] = __fmul_rn(phix, sd);
    w[plane + cell] = __fmul_rn(phiy, sd);
  }
};

struct PhiSink {
  float* phi;  // (2, ny, nx)
  size_t plane;
  __device__ __forceinline__ void store(size_t cell, float, float phix,
                                        float phiy) const {
    phi[cell] = phix;
    phi[plane + cell] = phiy;
  }
};

// FluidParams.bb index of the wall term that population i takes when it
// is pushed past a wall and bounces into its own cell's slot opp(i):
// past the south (ey < 0) or north (ey > 0) wall, past the west (ex < 0)
// or east (ex > 0) wall (the order [south 2,5,6; north 4,7,8; west
// 1,5,8; east 3,6,7] of the slot). Unused combinations give 0.
__host__ __device__ constexpr int bb_y(int i) {
  return ey(i) < 0 ? (opp(i) == 2 ? 0 : (opp(i) == 5 ? 1 : 2))
                   : (opp(i) == 4 ? 3 : (opp(i) == 7 ? 4 : 5));
}
__host__ __device__ constexpr int bb_x(int i) {
  return ex(i) < 0 ? (opp(i) == 1 ? 6 : (opp(i) == 5 ? 7 : 8))
                   : (opp(i) == 3 ? 9 : (opp(i) == 6 ? 10 : 11));
}

constexpr int kStepMaxThreads = 512;

// One coupled step by push streaming (launch (a) of K2, and K8): one
// thread per cell, blocks of 32 x (threads / 32) cells. Each thread
// loads its cell's 9 populations and solid fields, collides once, hands
// phi to the sink and writes post-collision population i to slot i of
// cell x + e_i (wrapped on an axis without walls). Where x + e_i lies
// past a wall it writes its own cell's slot opp(i) plus that wall's term
// instead, the x-wall's where it is past two (at a corner the pull's
// x-wall rule wins, d2q9.cuh stream_cell). That is the pull + bounce-back
// rule seen from the source: every slot of fout has exactly one writer,
// and f' equals the pull's bit for bit (the collide is unchanged, the
// streaming only moves values). Under Zou/He (p.open) a destination in
// column 0 or nx - 1 also goes, in f32, to `edge` (9, ny, 2), from which
// zou_he_edges_kernel closes those columns. S is the storage type of f:
// float, or __nv_bfloat16 for the shifted populations g = f - w rho0
// (one rounding per store, compute in f32).
template <typename S, bool TRT, bool LES, bool LAMBDA, class Sink>
__global__ void __launch_bounds__(kStepMaxThreads)
    coupled_step_kernel(const S* __restrict__ f, const float* __restrict__ eps,
                        const float* __restrict__ usx,
                        const float* __restrict__ usy, S* __restrict__ fout,
                        float* __restrict__ edge, Sink sink, int ny, int nx,
                        FluidParams p, float tm, PairArg<TRT> q) {
  constexpr bool kShift = sizeof(S) == 2;
  const int gx = blockIdx.x * 32 + threadIdx.x;
  const int gy = blockIdx.y * blockDim.y + threadIdx.y;
  if (gx >= nx || gy >= ny) return;
  const size_t plane = (size_t)ny * nx;
  const size_t cell = (size_t)gy * nx + gx;
  float fc[9], fp[9], phix, phiy;
#pragma unroll
  for (int i = 0; i < 9; ++i) fc[i] = load_f(f + i * plane + cell);
  const float eps_raw = eps[cell];
  coupled_collide<kShift, TRT, LES, LAMBDA>(fc, eps_raw, usx[cell], usy[cell],
                                            p, q, tm, fp, &phix, &phiy);
  sink.store(cell, eps_raw, phix, phiy);
  const bool wall_s = (p.walls & 1) && gy == 0;
  const bool wall_n = (p.walls & 2) && gy == ny - 1;
  const bool wall_w = (p.walls & 4) && gx == 0;
  const bool wall_e = (p.walls & 8) && gx == nx - 1;
  const int ys = gy == 0 ? ny - 1 : gy - 1, yn = gy == ny - 1 ? 0 : gy + 1;
  const int xw = gx == 0 ? nx - 1 : gx - 1, xe = gx == nx - 1 ? 0 : gx + 1;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const bool past_y = ey(i) < 0 ? wall_s : (ey(i) > 0 && wall_n);
    const bool past_x = ex(i) < 0 ? wall_w : (ex(i) > 0 && wall_e);
    int slot = i;
    int dy = ey(i) < 0 ? ys : (ey(i) > 0 ? yn : gy);
    int dx = ex(i) < 0 ? xw : (ex(i) > 0 ? xe : gx);
    float v = fp[i];
    if (past_x || past_y) {
      slot = opp(i);
      dy = gy;
      dx = gx;
      v = __fadd_rn(fp[i], p.bb[past_x ? bb_x(i) : bb_y(i)]);
    }
    store_f(fout + slot * plane + (size_t)dy * nx + dx, v);
    if (p.open && (dx == 0 || dx == nx - 1))
      edge[((size_t)slot * ny + dy) * 2 + (dx == 0 ? 0 : 1)] = v;
  }
}

// The Zou/He closures of a pushed step (p.open): one thread per row
// applies zou_he_inlet to column 0 and zou_he_outlet to column nx - 1
// from the f32 post-stream populations in `edge` (so bf16 storage closes
// on unrounded knowns, as the pull did) and stores the three unknowns of
// each into fout.
template <typename S>
__global__ void zou_he_edges_kernel(const float* __restrict__ edge,
                                    const float* __restrict__ u_in,
                                    S* __restrict__ fout, int ny, int nx,
                                    FluidParams p) {
  const int gy = blockIdx.x * blockDim.x + threadIdx.x;
  if (gy >= ny) return;
  const float shift = sizeof(S) == 2 ? p.rho0 : 0.0f;
  const size_t plane = (size_t)ny * nx;
  S* c0 = fout + (size_t)gy * nx;
  float v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = edge[((size_t)i * ny + gy) * 2];
  zou_he_inlet(v, u_in[gy], shift);
  store_f(c0 + plane, v[1]);
  store_f(c0 + 5 * plane, v[5]);
  store_f(c0 + 8 * plane, v[8]);
  if (nx > 1) {
#pragma unroll
    for (int i = 0; i < 9; ++i) v[i] = edge[((size_t)i * ny + gy) * 2 + 1];
  }
  zou_he_outlet(v, p.rho_out, shift);  // nx == 1: after the inlet, in place
  S* c1 = c0 + nx - 1;
  store_f(c1 + 3 * plane, v[3]);
  store_f(c1 + 6 * plane, v[6]);
  store_f(c1 + 7 * plane, v[7]);
}

// The one-step push kernel on a shard's pre-haloed frame (K2 and K8 on
// the lattice mesh): f is a frame (d2q9.cuh Frame: fr.hy halo rows, f32
// or shifted bf16, S as in coupled_step_kernel), the solid fields eps,
// usx, usy the solid window's planes (kSolidHaloRows rows, the same
// pitch), fout the (9, ny, nx) interior in f's type. One
// thread per cell of the interior and its ring of one cell (the ring's
// rows always; its columns in "yx" mode, PRE = 2 - in "y" mode, PRE = 1,
// x wraps over the shard's full width). Each collides once; the
// interior's cells hand phi to the sink at their interior index, and
// every cell pushes the populations that land in the interior, so that
// the ring's pushes are the exchanged neighbours' and each interior slot
// has one writer, as in coupled_step_kernel. p.walls holds only the x
// walls ("y" mode) or none ("yx"), p.open is 0: the caller fixes the
// global edges of the shards that hold them (the JAX _stream_and_bb with
// prehalo), from the post-collision populations of the interior's edge
// rows and columns that `edge` receives (f32; on bf16 the shifted ones,
// unrounded, so that the fixup rounds once, as the in-kernel wall does).
template <typename S, bool TRT, bool LES, bool LAMBDA, class Sink, int PRE>
__global__ void __launch_bounds__(kStepMaxThreads)
    coupled_step_prehalo_kernel(const S* __restrict__ f,
                                const float* __restrict__ eps,
                                const float* __restrict__ usx,
                                const float* __restrict__ usy,
                                S* __restrict__ fout, Sink sink, int ny,
                                int nx, Frame fr, FluidParams p, float tm,
                                EdgePost edge, PairArg<TRT> q) {
  constexpr bool kShift = sizeof(S) == 2;
  constexpr int kRing = PRE == 2 ? 1 : 0;  // ring columns per side
  const int gx = blockIdx.x * 32 + threadIdx.x - kRing;
  const int gy = blockIdx.y * blockDim.y + threadIdx.y - 1;
  if (gx >= nx + kRing || gy > ny) return;
  const size_t fplane = (size_t)(ny + 2 * fr.hy) * fr.pitch;
  const size_t src = (size_t)(gy + fr.hy) * fr.pitch + gx + fr.hx;
  const size_t ssrc = (size_t)(gy + kSolidHaloRows) * fr.pitch + gx + fr.hx;
  float fc[9], fp[9], phix, phiy;
#pragma unroll
  for (int i = 0; i < 9; ++i) fc[i] = load_f(f + i * fplane + src);
  const float eps_raw = eps[ssrc];
  coupled_collide<kShift, TRT, LES, LAMBDA>(fc, eps_raw, usx[ssrc],
                                            usy[ssrc], p, q, tm, fp, &phix,
                                            &phiy);
  const size_t plane = (size_t)ny * nx;
  const bool inside = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
  if (inside) {
    sink.store((size_t)gy * nx + gx, eps_raw, phix, phiy);
    edge.store(gy, gx, ny, nx, fp);
  }
  const bool wall_w = (p.walls & 4) && gx == 0;
  const bool wall_e = (p.walls & 8) && gx == nx - 1;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const bool past_x = ex(i) < 0 ? wall_w : (ex(i) > 0 && wall_e);
    int slot = i, dy = gy + ey(i), dx = gx + ex(i);
    float v = fp[i];
    if (past_x) {
      slot = opp(i);
      dy = gy;
      dx = gx;
      v = __fadd_rn(fp[i], p.bb[bb_x(i)]);
    } else if (PRE == 1) {
      dx = dx < 0 ? nx - 1 : (dx == nx ? 0 : dx);
    }
    if (dy < 0 || dy >= ny || dx < 0 || dx >= nx) continue;
    store_f(fout + slot * plane + (size_t)dy * nx + dx, v);
  }
}

template <typename S, bool TRT, bool LES, bool LAMBDA, class Sink>
int launch_coupled_step(const void* f, const float* eps, const float* usx,
                        const float* usy, const float* u_in, void* fout,
                        float* edge, Sink sink, int ny, int nx,
                        const FluidParams& p, float tm,
                        const PairArg<TRT>& q, int threads,
                        cudaStream_t stream) {
  if (threads < 32 || threads > kStepMaxThreads || threads % 32 != 0 ||
      (p.open && (edge == nullptr || u_in == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int by = threads / 32;
  const dim3 grid((nx + 31) / 32, (ny + by - 1) / by);
  coupled_step_kernel<S, TRT, LES, LAMBDA, Sink>
      <<<grid, dim3(32, by), 0, stream>>>(
          static_cast<const S*>(f), eps, usx, usy, static_cast<S*>(fout), edge,
          sink, ny, nx, p, tm, q);
  const int err = (int)cudaGetLastError();
  if (err != 0 || !p.open) return err;
  zou_he_edges_kernel<S><<<(ny + 127) / 128, 128, 0, stream>>>(
      edge, u_in, static_cast<S*>(fout), ny, nx, p);
  return (int)cudaGetLastError();
}

template <typename S, bool TRT, bool LES, bool LAMBDA, class Sink>
int launch_coupled_step_prehalo(const void* f, const float* eps,
                                const float* usx, const float* usy,
                                void* fout, Sink sink, int ny, int nx,
                                Frame fr, const FluidParams& p, float tm,
                                EdgePost edge, const PairArg<TRT>& q,
                                int threads, cudaStream_t stream) {
  if (threads < 32 || threads > kStepMaxThreads || threads % 32 != 0 ||
      p.open || (p.walls & 3) || (fr.hx != 0 && (p.walls & 12)))
    return (int)cudaErrorInvalidValue;
  const int by = threads / 32, ring = fr.hx ? 2 : 0;
  const dim3 grid((nx + ring + 31) / 32, (ny + 2 + by - 1) / by);
  const S* fs = static_cast<const S*>(f);
  S* fo = static_cast<S*>(fout);
  if (fr.hx)
    coupled_step_prehalo_kernel<S, TRT, LES, LAMBDA, Sink, 2>
        <<<grid, dim3(32, by), 0, stream>>>(fs, eps, usx, usy, fo, sink, ny,
                                            nx, fr, p, tm, edge, q);
  else
    coupled_step_prehalo_kernel<S, TRT, LES, LAMBDA, Sink, 1>
        <<<grid, dim3(32, by), 0, stream>>>(fs, eps, usx, usy, fo, sink, ny,
                                            nx, fr, p, tm, edge, q);
  return (int)cudaGetLastError();
}

// The instantiation of the one-step kernel for the options: LAMBDA
// matters only with LES (else the caller's tm already has the lambda
// form); q: the TRT pair form's scalars.
template <typename S, class Sink>
int dispatch_coupled_step(const void* f, const float* eps, const float* usx,
                          const float* usy, const float* u_in, void* fout,
                          float* edge, Sink sink, int ny, int nx, int lambda,
                          const FluidParams& p, float tm,
                          const PairParams& q, int threads,
                          cudaStream_t stream) {
#define LBM_STEP(TRT, LES, LAMBDA)                                        \
  launch_coupled_step<S, TRT, LES, LAMBDA, Sink>(                         \
      f, eps, usx, usy, u_in, fout, edge, sink, ny, nx, p, tm,            \
      pair_arg<TRT>(q), threads, stream)
  if (p.trt) {
    if (!p.les) return LBM_STEP(true, false, false);
    return lambda ? LBM_STEP(true, true, true) : LBM_STEP(true, true, false);
  }
  if (!p.les) return LBM_STEP(false, false, false);
  return lambda ? LBM_STEP(false, true, true) : LBM_STEP(false, true, false);
#undef LBM_STEP
}

template <typename S, class Sink>
int dispatch_coupled_step_prehalo(const void* f, const float* eps,
                                  const float* usx, const float* usy,
                                  void* fout, Sink sink, int ny, int nx,
                                  Frame fr, int lambda, const FluidParams& p,
                                  float tm, const PairParams& q,
                                  EdgePost edge, int threads,
                                  cudaStream_t stream) {
#define LBM_STEP(TRT, LES, LAMBDA)                                         \
  launch_coupled_step_prehalo<S, TRT, LES, LAMBDA, Sink>(                  \
      f, eps, usx, usy, fout, sink, ny, nx, fr, p, tm, edge,               \
      pair_arg<TRT>(q), threads, stream)
  if (p.trt) {
    if (!p.les) return LBM_STEP(true, false, false);
    return lambda ? LBM_STEP(true, true, true) : LBM_STEP(true, true, false);
  }
  if (!p.les) return LBM_STEP(false, false, false);
  return lambda ? LBM_STEP(false, true, true) : LBM_STEP(false, true, false);
#undef LBM_STEP
}

constexpr int kReduceThreads = 256;

// The momentum exchange w = phi / max(eps_raw, eps_min) the reduce weights
// by coverage, as a source functor of reduce_kernel: load(t, cell,
// eps_raw, wx, wy) gives inner step t's (wx, wy) at a flat cell index
// whose eps_raw > 0.
//
// WPlanes: K2's and K6's launch (a) wrote w to a (k, 2, ny, nx) scratch.
struct WPlanes {
  const float* w;
  size_t plane;
  __device__ __forceinline__ void load(int t, size_t cell, float, float& wx,
                                       float& wy) const {
    const float* wt = w + (size_t)t * 2 * plane;
    wx = wt[cell];
    wy = wt[plane + cell];
  }
};

// WFromPhi: K9 computes w from the raw phi planes and eps_raw, with the
// expression of K2's launch (a), so K8 + K9 gives K2's partials.
struct WFromPhi {
  const float* phix;
  const float* phiy;
  float eps_min;
  __device__ __forceinline__ void load(int, size_t cell, float eps_raw,
                                       float& wx, float& wy) const {
    const float sd = 1.0f / fmaxf(eps_raw, eps_min);
    wx = __fmul_rn(phix[cell], sd);
    wy = __fmul_rn(phiy[cell], sd);
  }
};

// Exclusive prefix of the tiles' slot counts (clipped to cap) into
// offsets[0..n_tiles], offsets[n_tiles] the number of occupied slots:
// one block, 1024 slots per round, a warp scan then a scan over the
// warps' totals.
__global__ void __launch_bounds__(1024)
    slot_offsets_kernel(const int* __restrict__ counts, int n_tiles, int cap,
                        int* __restrict__ offsets) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += 1024) {
    const int t = t0 + threadIdx.x;
    const int c = t < n_tiles ? min(counts[t], cap) : 0;
    int v = c;  // inclusive warp scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (t < n_tiles) offsets[t] = before + v - c;
    __syncthreads();
    if (threadIdx.x == 1023) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n_tiles] = carry;
}

// The hydro-force reduce over the occupied slots only: a fixed grid of
// kReduceBlocks x k blocks whose warps take the occupied slots j =
// warp, warp + (all warps), ... below offsets[n_tiles]; a slot's tile is
// found by binary search in offsets. The lanes of the warp sum cov *
// w[t] and the torque over the disk's window clipped to the tile
// (lane-strided, then a shuffle tree: a fixed order, so the partials are
// deterministic) and lane 0 writes partials[t][tile * cap + rank] = [fx,
// fy, tq, 0]; the same grid writes the zero rows past each tile's count.
// A cell with eps_raw <= 0 is skipped before its coverage: its w
// is +-0 (not even stored), and adding +-0 to a sum that starts at +0
// changes no bit. partials: (k, n_tiles * cap, 4); K2 and K9 launch it
// with k = 1. M is the coverage method, W the source of w (WPlanes or
// WFromPhi). On a shard of the lattice mesh (K2's pre-haloed mode) the
// disk records are in the coordinates of the shard's stamp canvas, whose
// cell (oy, ox) is the interior's (0, 0): the tiles sit at that origin,
// w is read at the interior cell and eps_raw from a window of row length
// eps_pitch whose pointer is at the interior's (0, 0); FRAME selects
// that instantiation, so the lattice's keeps its indexing.
constexpr int kReduceBlocks = 1056;  // 8 blocks of 256 threads per SM
template <int M, class W, bool FRAME>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(W wsrc, const float* __restrict__ eps,
                  const float* __restrict__ tile_data,
                  const int* __restrict__ counts,
                  const int* __restrict__ offsets,
                  float* __restrict__ partials, int nx, int th, int tw,
                  int ntx, int n_tiles, int cap, int window, CovParams cp,
                  int eps_pitch, int oy, int ox) {
  __shared__ SampleTable tab;
  if (M == kSample) fill_sample_table(&tab, cp.ns);
  __syncthreads();
  float* outp = partials + (size_t)blockIdx.y * n_tiles * cap * 4;
  const size_t rows = (size_t)n_tiles * cap;
  for (size_t row = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
       row < rows; row += (size_t)gridDim.x * kReduceThreads) {
    const int tile = (int)(row / cap);
    if ((int)(row - (size_t)tile * cap) >= min(counts[tile], cap))
      reinterpret_cast<float4*>(outp)[row] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (kReduceThreads / 32);
  const int total = offsets[n_tiles];
  const int half = window / 2;
  for (int j = blockIdx.x * (kReduceThreads / 32) + threadIdx.x / 32;
       j < total; j += warps) {
    int lo = 0, hi = n_tiles;  // the tile with offsets[t] <= j < [t + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (offsets[mid] <= j) lo = mid; else hi = mid;
    }
    const int tile = lo, slot = j - offsets[lo];
    const float* d = tile_data + ((size_t)tile * cap + slot) * 8;
    const float px = d[0], py = d[1], rr = shift_radius(d[5], cp.r_shift);
    const int y0 = (tile / ntx) * th + (FRAME ? oy : 0);
    const int x0 = (tile % ntx) * tw + (FRAME ? ox : 0);
    const int by = (int)floorf(py + 0.5f) - half;
    const int bx = (int)floorf(px + 0.5f) - half;
    const int ya = max(by, y0), yb = min(by + window, y0 + th);
    const int xa = max(bx, x0), xb = min(bx + window, x0 + tw);
    const int ww = xb - xa;
    const int n = (yb > ya && ww > 0) ? (yb - ya) * ww : 0;
    float fx = 0.f, fy = 0.f, tq = 0.f;
    for (int c = lane; c < n; c += 32) {
      const int gy = ya + c / ww, gx = xa + c % ww;
      size_t cell;
      float e;
      if constexpr (FRAME) {
        cell = (size_t)(gy - oy) * nx + (gx - ox);
        e = eps[(size_t)(gy - oy) * eps_pitch + (gx - ox)];
      } else {
        cell = (size_t)gy * nx + gx;
        e = eps[cell];
      }
      if (!(e > 0.0f)) continue;
      const float relx = __fsub_rn((float)gx, px);
      const float rely = __fsub_rn((float)gy, py);
      const float cov = coverage<M>(relx, rely, rr, cp, tab);
      float wx, wy;
      wsrc.load(blockIdx.y, cell, e, wx, wy);
      const float fxc = __fmul_rn(cov, wx);
      const float fyc = __fmul_rn(cov, wy);
      fx = __fadd_rn(fx, fxc);
      fy = __fadd_rn(fy, fyc);
      tq = __fadd_rn(tq,
                     __fsub_rn(__fmul_rn(relx, fyc), __fmul_rn(rely, fxc)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      fx = __fadd_rn(fx, __shfl_down_sync(0xffffffffu, fx, o));
      fy = __fadd_rn(fy, __shfl_down_sync(0xffffffffu, fy, o));
      tq = __fadd_rn(tq, __shfl_down_sync(0xffffffffu, tq, o));
    }
    if (lane == 0)
      reinterpret_cast<float4*>(outp)[(size_t)tile * cap + slot] =
          make_float4(fx, fy, tq, 0.0f);
  }
}

// The reduce over k inner steps (launch b of K2 and K6, and K9) for the
// coverage method cp.method: the prefix of the counts into `offsets`
// ((n_tiles + 1,) i32 scratch), then the reduce over the occupied slots.
// Returns cudaGetLastError.
template <class W>
inline int launch_reduce(W wsrc, const float* eps, const float* tile_data,
                         const int* counts, int* offsets, float* partials,
                         int nx, int th, int tw, int ntx, int n_tiles, int cap,
                         int window, const CovParams& cp, int k,
                         cudaStream_t stream, int eps_pitch = 0, int oy = 0,
                         int ox = 0) {
  // eps_pitch 0: the lattice (eps (ny, nx), origin (0, 0)); else a
  // shard's solid window, the interior at (oy, ox) of the records' frame
  if (cp.method < kSample || cp.method > kExact)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0 || cap == 0) return 0;
  slot_offsets_kernel<<<1, 1024, 0, stream>>>(counts, n_tiles, cap, offsets);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const bool frame = eps_pitch != 0;
  auto kernel =
      cp.method == kRamp
          ? (frame ? &reduce_kernel<kRamp, W, true>
                   : &reduce_kernel<kRamp, W, false>)
      : cp.method == kExact
          ? (frame ? &reduce_kernel<kExact, W, true>
                   : &reduce_kernel<kExact, W, false>)
          : (frame ? &reduce_kernel<kSample, W, true>
                   : &reduce_kernel<kSample, W, false>);
  kernel<<<dim3(kReduceBlocks, k), kReduceThreads, 0, stream>>>(
      wsrc, eps, tile_data, counts, offsets, partials, nx, th, tw, ntx,
      n_tiles, cap, window, cp, frame ? eps_pitch : nx, oy, ox);
  return (int)cudaGetLastError();
}

}  // namespace
