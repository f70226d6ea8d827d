// D2Q9 lattice device code shared by the coupled steps (K2, K6, K7, K8,
// through imb.cuh) and the pure-fluid steps (K4/K5, fluid.cu); the
// storage loads/stores and the pull + bounce-back + Zou/He of one cell
// serve K4 and the K5/K6/K7 temporal block (tblock.cuh).
//
// Every helper mirrors a function of the plain PyTorch version
// (ops/lbm.py; the pure-fluid collide ops/fused_fluid.collide_pairs)
// operation by operation, in its evaluation order and with
// round-to-nearest intrinsics, so that under --fmad=false a kernel
// rounds like the plain version. Where the plain version divides a
// Python scalar by a tensor, PyTorch computes reciprocal(t) * scalar
// (Tensor.__rtruediv__); the helpers do the same.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// D2Q9 tables (lattice.py) as constexpr functions: inside the unrolled
// population loops they fold to constants, so the per-cell arrays stay
// in registers (a table in __constant__ memory would make fc[opp(i)] a
// dynamic index and move the arrays to local memory)
__host__ __device__ constexpr int ex(int i) {
  return i == 1 || i == 5 || i == 8 ? 1 : (i == 3 || i == 6 || i == 7 ? -1 : 0);
}
__host__ __device__ constexpr int ey(int i) {
  return i == 2 || i == 5 || i == 6 ? 1 : (i == 4 || i == 7 || i == 8 ? -1 : 0);
}
__host__ __device__ constexpr int opp(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}

// g mod n in [0, n): the periodic image of an unwrapped window coordinate
__device__ __forceinline__ int wrap(int g, int n) {
  if (g >= 0 && g < n) return g;
  g %= n;
  return g < 0 ? g + n : g;
}

// lattice weights exactly as float64 -> float32 (numpy's rounding)
__device__ __forceinline__ float weight(int i) {
  return i == 0 ? (float)(4.0 / 9.0)
                : (i < 5 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0));
}

// f_eq_i = w_i rho (1 + 3 eu + 4.5 eu^2 - 1.5 usq) for a given e_i . u,
// in the evaluation order of the plain version (ops/lbm.equilibrium)
__device__ __forceinline__ float feq_eu(int i, float rho, float eu,
                                        float usq) {
  const float a = __fadd_rn(1.0f, __fmul_rn(3.0f, eu));
  const float b = __fadd_rn(a, __fmul_rn(__fmul_rn(4.5f, eu), eu));
  const float c = __fsub_rn(b, __fmul_rn(1.5f, usq));
  return __fmul_rn(__fmul_rn(weight(i), rho), c);
}

// e_i . u with the products by a zero component dropped (they only add a
// signed zero): the same value as ex*ux + ey*uy in the plain version
__device__ __forceinline__ float edot(int i, float ux, float uy) {
  if (ex(i) == 0 && ey(i) == 0) return 0.0f;
  if (ex(i) == 0) return ey(i) > 0 ? uy : -uy;
  const float a = ex(i) > 0 ? ux : -ux;
  if (ey(i) == 0) return a;
  return __fadd_rn(a, ey(i) > 0 ? uy : -uy);
}

// Shifted-storage equilibrium g_eq_i = f_eq_i - w_i rho0 on populations
// g = f - w rho0: the "1" of f_eq multiplies rho_b = sum g, the rest
// rho = rho_b + rho0. A fluid at rest is g = 0 and stays exactly 0.
__device__ __forceinline__ float geq_eu(int i, float rho_b, float rho,
                                        float eu, float usq) {
  const float a = __fadd_rn(__fmul_rn(3.0f, eu),
                            __fmul_rn(__fmul_rn(4.5f, eu), eu));
  const float c = __fsub_rn(a, __fmul_rn(1.5f, usq));
  return __fmul_rn(weight(i), __fadd_rn(rho_b, __fmul_rn(rho, c)));
}

// Scalars of the pure-fluid steps (K4/K5) and of the coupled ones;
// mirrored field for field by kernels.FluidParams. Scalars the plain
// version computes in float64 from Python floats arrive here already
// rounded to float32.
struct FluidParams {
  float tau;        // BGK relaxation time (TRT: tau+)
  float tau_sq;     // tau * tau (LES closure)
  float half_gx;    // 0.5 * gx (velocity shift of the Guo scheme)
  float half_gy;
  float gx, gy;     // fluid body force
  float guo_pref;   // 1 - 1/(2 tau) (BGK without LES)
  float trt_magic;  // TRT magic parameter Lambda
  // the index-order TRT scalars: no kernel reads them (every TRT collide
  // is the pair form, on PairParams); they hold the fields after them
  // where the BGK kernels read them
  float trt_hp;     // 1/(2 tau+)
  float trt_hm;     // 1/(2 tau-)
  float trt_pe;     // (1 - 1/(2 tau+)) / 2
  float trt_po;     // (1 - 1/(2 tau-)) / 2
  float les_c;      // 18 sqrt(2) Cs^2
  float rho0;       // storage shift of bf16 f, and the Zou/He shift
  float rho_out;    // Zou/He outlet density
  float bb[12];     // wall terms [south 2,5,6; north 4,7,8; west 1,5,8;
                    // east 3,6,7] (lattice.wall_corr)
  int forced;       // gx != 0 or gy != 0
  int trt;          // collision == "trt"
  int les;          // smagorinsky > 0
  int walls;        // bit 0 south, 1 north, 2 west, 3 east
  int open;         // west Zou/He inlet + east Zou/He outlet (on a
                    // shard's frame: bit 0 the inlet, bit 1 the outlet)
};

// The pair-form collide's scalars without LES, folded on the host as
// the JAX trace folds them (K4, K5: fluid_collide_t; the TRT
// instantiations of K2, K6, K7, K8: imb.cuh collide_cell_pairs; mirrored
// by kernels.PairParams, filled from ops/fused_fluid.pair_consts), per
// pair k of pair_rep. Apart from FluidParams, so that the BGK coupled
// kernels' parameters stay as they are (they take none of it).
struct PairParams {
  float inv_tau;    // 1/tau
  float inv_tau_m;  // TRT: 1/tau-
  float gw[5];      // w_i (1 - 1/(2 tau)): the rest population, the pairs
  float eg9[4];     // 9 e_i . g
  float w3eg[4];    // w_i 3 e_i . g
  float godd[4];    // w3eg (1 - 1/(2 tau-)), BGK (1 - 1/(2 tau))
};

// A shard's pre-haloed frame of f on the lattice mesh (ops/fused_fluid
// prehalo): hy exchanged rows above and below its ny x nx interior (8 on
// f32 storage, 16 on bf16: the JAX package's row granule of each, its
// pallas_lbm._storage) and, in "yx" mode, kHaloCols columns on either
// side (hx = kHaloCols, else 0); pitch is the frame's row length. Row r
// of the interior is frame row r + hy. The coupled kernels' solid window
// is a frame of the same pitch with kSolidHaloRows rows per side in both
// storages (the JAX f32 granule): its row r at r + kSolidHaloRows.
constexpr int kSolidHaloRows = 8;
constexpr int kHaloCols = 128;
struct Frame {
  int pitch;
  int hx;
  int hy;
};

// The f frame's halo rows of a storage: 16 for bf16 (bf16 = 1), else 8
__host__ __device__ constexpr int frame_hy(int bf16) {
  return bf16 ? 16 : kSolidHaloRows;
}

// The post-collision populations of a shard's interior edges, which the
// one-step pre-haloed kernels (K4, K2) hand to the caller's wall fixups
// (the walls they skip): rows (9, 2, nx) - the first and last interior
// rows - and cols (9, ny, 2) - the first and last columns; either may be
// null.
struct EdgePost {
  float* rows;
  float* cols;
  __device__ __forceinline__ void store(int y, int x, int ny, int nx,
                                        const float* v) const {
    if (rows != nullptr && (y == 0 || y == ny - 1)) {
      const int r = y == 0 ? 0 : 1;
#pragma unroll
      for (int i = 0; i < 9; ++i) rows[((size_t)i * 2 + r) * nx + x] = v[i];
    }
    if (cols != nullptr && (x == 0 || x == nx - 1)) {
      const int c = x == 0 ? 0 : 1;
#pragma unroll
      for (int i = 0; i < 9; ++i) cols[((size_t)i * ny + y) * 2 + c] = v[i];
    }
  }
};

// w_i [3 (e_i - u) . g + 9 (e_i . u)(e_i . g)] (ops/lbm._guo_proj)
__device__ __forceinline__ float guo_proj(int i, float ux, float uy, float eu,
                                          float gx, float gy) {
  const float exf = (float)ex(i), eyf = (float)ey(i);
  const float t1 = __fmul_rn(
      3.0f, __fadd_rn(__fmul_rn(__fsub_rn(exf, ux), gx),
                      __fmul_rn(__fsub_rn(eyf, uy), gy)));
  const float eg = __fadd_rn(__fmul_rn(exf, gx), __fmul_rn(eyf, gy));
  const float t2 = __fmul_rn(__fmul_rn(9.0f, eu), eg);
  return __fmul_rn(weight(i), __fadd_rn(t1, t2));
}

// A lattice option of a collide: fixed at compile time (0 or 1), or
// kRuntime to read it from FluidParams at run time
constexpr int kRuntime = -1;
__device__ __forceinline__ bool option(int fixed, int runtime) {
  return fixed == kRuntime ? runtime != 0 : fixed != 0;
}

// The representative i < opp(i) of direction pair k: 1, 2, 5, 6 (pairs
// (1, 3), (2, 4), (5, 7), (6, 8); ops/fused_fluid.PAIRS)
__host__ __device__ constexpr int pair_rep(int k) {
  return k < 2 ? k + 1 : k + 3;
}
// the pair of population i > 0, and whether i is its representative
__host__ __device__ constexpr int pair_of(int i) {
  return i == 1 || i == 3 ? 0
                          : (i == 2 || i == 4 ? 1 : (i == 5 || i == 7 ? 2 : 3));
}
__host__ __device__ constexpr bool is_rep(int i) {
  return i == 1 || i == 2 || i == 5 || i == 6;
}

// Pure-fluid collision of one cell in place (K4, K5; plain version:
// ops/fused_fluid.collide_pairs), the pair form of the TPU kernels
// (lbmdem_tpu/ops/pallas_lbm.py _collide_window without a solid): per
// direction pair the sum S = f_i + f_opp and the difference D = f_i -
// f_opp give rho and j; each equilibrium pair is E +- O, E = w (rho_b +
// rho (4.5 eu^2 - 1.5 u^2)), O = 3 w rho eu; BGK relaxes f - (E +- O) at
// 1/tau, TRT the even part S/2 - E at 1/tau and the odd part D/2 - O at
// 1/tau-; Guo's source splits into even w fp (9 e.g eu - 3 u.g) and odd
// w 3 e.g fp-. With LES tau is per cell (ops/lbm.smagorinsky_tau on the
// nine equilibria) and so are 1/tau, 1/tau- and the prefactors; without
// LES they are the scalars of q (PairParams). SHIFT: f holds the shifted
// populations g = f - w rho0 (bf16 storage); the update keeps its form
// with rho_b = sum g. TRT, LES, FORCED: the options p.trt, p.les,
// p.forced fixed at compile time (0/1), or kRuntime; every choice runs
// the same operations in the same order for the same options, so the
// results agree bit for bit.
template <bool SHIFT, int TRT, int LES, int FORCED>
__device__ __forceinline__ void fluid_collide_t(float* f,
                                                const FluidParams& p,
                                                const PairParams& q) {
  const bool trt = option(TRT, p.trt), les = option(LES, p.les);
  const bool forced = option(FORCED, p.forced);
  float S[4], D[4];
  float rs = f[0];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = pair_rep(k);
    S[k] = __fadd_rn(f[i], f[opp(i)]);
    rs = __fadd_rn(rs, S[k]);
    D[k] = __fsub_rn(f[i], f[opp(i)]);
  }
  // j = sum of e_i D over the pairs in order: e_x +1, +1, -1 (pairs 0, 2,
  // 3), e_y +1, +1, +1 (pairs 1, 2, 3)
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
  if (les) {  // ops/lbm.smagorinsky_tau
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
    inv_tau = __frcp_rn(tau);
    fpref = __fsub_rn(1.0f, __fmul_rn(0.5f, inv_tau));
    opref = fpref;
    if (trt) {  // ops/lbm.trt_tau_minus on the per-cell tau
      inv_tau_m = __frcp_rn(__fadd_rn(
          0.5f, __fdiv_rn(p.trt_magic, __fsub_rn(tau, 0.5f))));
      opref = __fsub_rn(1.0f, __fmul_rn(0.5f, inv_tau_m));
    }
  }
  float ug3 = 0.f;
  if (forced)
    ug3 = __fmul_rn(3.0f, __fadd_rn(__fmul_rn(ux, p.gx), __fmul_rn(uy, p.gy)));
  float v0 = __fsub_rn(f[0], __fmul_rn(inv_tau, __fsub_rn(f[0], feq0)));
  if (forced) {
    const float gw0 = les ? __fmul_rn(weight(0), fpref) : q.gw[0];
    v0 = __fadd_rn(v0, __fmul_rn(gw0, -ug3));
  }
  f[0] = v0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = pair_rep(k), o = opp(i);
    float vi, vo;
    if (trt) {
      const float ne_e =
          __fmul_rn(inv_tau, __fsub_rn(__fmul_rn(0.5f, S[k]), E[k]));
      const float ne_o =
          __fmul_rn(inv_tau_m, __fsub_rn(__fmul_rn(0.5f, D[k]), O[k]));
      vi = __fsub_rn(f[i], __fadd_rn(ne_e, ne_o));
      vo = __fsub_rn(f[o], __fsub_rn(ne_e, ne_o));
    } else {
      vi = __fsub_rn(f[i], __fmul_rn(inv_tau, __fsub_rn(
                                 f[i], __fadd_rn(E[k], O[k]))));
      vo = __fsub_rn(f[o], __fmul_rn(inv_tau, __fsub_rn(
                                 f[o], __fsub_rn(E[k], O[k]))));
    }
    if (forced) {
      const float gw = les ? __fmul_rn(weight(i), fpref) : q.gw[k + 1];
      const float even =
          __fmul_rn(gw, __fsub_rn(__fmul_rn(q.eg9[k], eu[k]), ug3));
      if (q.w3eg[k] != 0.f) {  // e_i . g != 0
        const float odd = les ? __fmul_rn(q.w3eg[k], opref) : q.godd[k];
        vi = __fadd_rn(vi, __fadd_rn(even, odd));
        vo = __fadd_rn(vo, __fsub_rn(even, odd));
      } else {
        vi = __fadd_rn(vi, even);
        vo = __fadd_rn(vo, even);
      }
    }
    f[i] = vi;
    f[o] = vo;
  }
}

// fluid_collide_t with every option read at run time (K4)
template <bool SHIFT>
__device__ __forceinline__ void fluid_collide(float* f, const FluidParams& p,
                                              const PairParams& q) {
  fluid_collide_t<SHIFT, kRuntime, kRuntime, kRuntime>(f, p, q);
}

// Zou/He west-inlet closure (ops/lbm.zou_he_inlet): the unknown
// populations 1, 5, 8 of a cell with prescribed u = (uw, 0), from its
// post-stream knowns. shift != 0: shifted-storage populations.
__device__ __forceinline__ void zou_he_inlet(float* v, float uw, float shift) {
  float kn = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[2]), v[4]),
                       __fmul_rn(2.0f, __fadd_rn(__fadd_rn(v[3], v[6]), v[7])));
  if (shift != 0.0f) kn = __fadd_rn(kn, shift);
  const float rho_w = __fdiv_rn(kn, __fsub_rn(1.0f, uw));
  const float d24 = __fmul_rn(0.5f, __fsub_rn(v[2], v[4]));
  const float ru = __fmul_rn(rho_w, uw);
  v[1] = __fadd_rn(v[3], __fmul_rn((float)(2.0 / 3.0), ru));
  v[5] = __fadd_rn(__fsub_rn(v[7], d24), __fmul_rn((float)(1.0 / 6.0), ru));
  v[8] = __fadd_rn(__fadd_rn(v[6], d24), __fmul_rn((float)(1.0 / 6.0), ru));
}

// Zou/He east-outlet closure (ops/lbm.zou_he_outlet): prescribed
// rho = rho_o, v = 0; the populations 3, 7, 6.
__device__ __forceinline__ void zou_he_outlet(float* v, float rho_o,
                                              float shift) {
  float kn = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[2]), v[4]),
                       __fmul_rn(2.0f, __fadd_rn(__fadd_rn(v[1], v[5]), v[8])));
  if (shift != 0.0f) kn = __fadd_rn(kn, shift);
  const float ue = __fadd_rn(__fdiv_rn(kn, rho_o), -1.0f);
  const float d24 = __fmul_rn(0.5f, __fsub_rn(v[2], v[4]));
  const float rue = __fmul_rn(rho_o, ue);
  v[3] = __fsub_rn(v[1], __fmul_rn((float)(2.0 / 3.0), rue));
  v[7] = __fsub_rn(__fadd_rn(v[5], d24), __fmul_rn((float)(1.0 / 6.0), rue));
  v[6] = __fsub_rn(__fsub_rn(v[8], d24), __fmul_rn((float)(1.0 / 6.0), rue));
}

// f in storage: f32, or the shifted bf16 populations (one rounding per
// store, round to nearest)
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Pull of the cell at global unwrapped coordinate (gy, gx) from the
// post-collision populations around it, then half-way bounce-back at the
// global walls in the order south, north, west, east (the x-wall rule
// wins at corners; plain version: lbm.apply_bounce_back) and the Zou/He
// closures (lbm.apply_open_boundaries). post(i, dy, dx) is population i
// of the cell (gy + dy, gx + dx). On a shard of the lattice mesh (PRE)
// (gy, gx) are its local unwrapped coordinates, p.walls and p.open hold
// only the global edges the shard has (p.open: bit 0 the inlet, bit 1
// the outlet), and u_in points at interior row 0 of the inlet profile of
// the shard's frame rows (row gy at u_in[gy], the global rows wrapped by
// the host).
template <bool PRE = false, class Post>
__device__ __forceinline__ void stream_pull(const Post& post, int gy, int gx,
                                            int ny, int nx,
                                            const float* u_in,
                                            const FluidParams& p, float shift,
                                            float* v) {
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = post(i, -ey(i), -ex(i));
  if ((p.walls & 1) && gy == 0) {  // ey = +1 populations 2, 5, 6
    v[2] = __fadd_rn(post(4, 0, 0), p.bb[0]);
    v[5] = __fadd_rn(post(7, 0, 0), p.bb[1]);
    v[6] = __fadd_rn(post(8, 0, 0), p.bb[2]);
  }
  if ((p.walls & 2) && gy == ny - 1) {  // ey = -1 populations 4, 7, 8
    v[4] = __fadd_rn(post(2, 0, 0), p.bb[3]);
    v[7] = __fadd_rn(post(5, 0, 0), p.bb[4]);
    v[8] = __fadd_rn(post(6, 0, 0), p.bb[5]);
  }
  if ((p.walls & 4) && gx == 0) {  // ex = +1 populations 1, 5, 8
    v[1] = __fadd_rn(post(3, 0, 0), p.bb[6]);
    v[5] = __fadd_rn(post(7, 0, 0), p.bb[7]);
    v[8] = __fadd_rn(post(6, 0, 0), p.bb[8]);
  }
  if ((p.walls & 8) && gx == nx - 1) {  // ex = -1 populations 3, 6, 7
    v[3] = __fadd_rn(post(1, 0, 0), p.bb[9]);
    v[6] = __fadd_rn(post(8, 0, 0), p.bb[10]);
    v[7] = __fadd_rn(post(5, 0, 0), p.bb[11]);
  }
  if constexpr (PRE) {
    if ((p.open & 1) && gx == 0)
      zou_he_inlet(v, u_in[gy], shift);
    if ((p.open & 2) && gx == nx - 1) zou_he_outlet(v, p.rho_out, shift);
  } else if (p.open) {
    if (gx == 0) zou_he_inlet(v, u_in[wrap(gy, ny)], shift);
    if (gx == nx - 1) zou_he_outlet(v, p.rho_out, shift);
  }
}

// stream_pull of window cell c from the post-collision window `post` (9
// planes of n floats, w per row)
template <bool PRE = false>
__device__ __forceinline__ void stream_cell(const float* post, int n, int w,
                                            int c, int gy, int gx, int ny,
                                            int nx, const float* u_in,
                                            const FluidParams& p, float shift,
                                            float* v) {
  stream_pull<PRE>([&](int i, int dy, int dx) {
    return post[i * n + c + dy * w + dx];
  }, gy, gx, ny, nx, u_in, p, shift, v);
}
