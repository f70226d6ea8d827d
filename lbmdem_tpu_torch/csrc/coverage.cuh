// Per-disk coverage of one lattice cell: the device functions shared by
// the stamp kernel (K1, stamp.cu) and the hydro-force reduce (K2/K6's
// launch b and K9, imb.cuh reduce_kernel).
//
// Counterpart of the JAX package's pallas_stamp._cov_field, all three
// eps_method branches:
//   sample  eps_samples^2 subgrid points, tested in the t-form
//           (relx + sx)^2 <= r^2 - (rely + sy)^2;
//   ramp    the linear ramp clip((r + 1/2) - d, 0, 1);
//   exact   the analytic tangent-plane overlap (ops/imb.exact_coverage).
// Coverage must agree BITWISE with the plain PyTorch version
// (ops/stamp.py cov_field): one flipped sample is a 1/ns^2 coverage step,
// and K1 is held to its plain version to the bit. Every operation
// therefore goes through the round-to-nearest intrinsics, which nvcc never
// contracts into an FMA, in the plain version's order; where the plain
// version divides a Python scalar by a tensor, PyTorch computes
// reciprocal(t) * scalar, and so does this code.
#pragma once

// eps_method, a template parameter of the kernels that take coverage (each
// method its own instantiation, chosen at launch)
enum CovMethod { kSample = 0, kRamp = 1, kExact = 2 };

// The coverage scalars of one launch; mirrored field for field by
// kernels.CovParams and filled by ops/stamp.cov_params. full, half, lo
// and hi are the constants of the sample method's fast path
// (cov_sample_fast), computed in Python (ops/stamp.sample_consts).
struct CovParams {
  int method;     // CovMethod
  int ns;         // samples per axis
  float r_shift;  // eps_r_shift (0 = none)
  float full;     // the ns^2 loop's sum when every sample hits
  float half;     // the largest |sample offset|, 1/2 - 1/(2 ns)
  float lo;       // all-in when the farthest sample's d^2 <= r^2 * lo
  float hi;       // all-out when the nearest sample's d^2 >= r^2 * hi
};

// The eps_r_shift calibration of one disk radius (0 = none): a slot's
// radius rr > 0 becomes max(rr + r_shift, 0.05); rr == 0 marks an empty
// slot and stays 0. Applied once per disk, before any method.
__device__ __forceinline__ float shift_radius(float rr, float r_shift) {
  if (r_shift == 0.0f) return rr;
  return rr > 0.0f ? fmaxf(__fadd_rn(rr, r_shift), 0.05f) : 0.0f;
}

// The sample offsets (i + 1/2) / ns - 1/2 and the weight 1 / ns^2,
// exactly as numpy computes them in float64, then rounded to float32; a
// kernel fills one table per block (fill_sample_table, threads i < ns)
// so the sample loop reads them from shared memory instead of taking a
// float64 divide per sample. ns > kMaxSamples computes them in the loop.
constexpr int kMaxSamples = 32;
struct SampleTable {
  float offs[kMaxSamples];
  float inv_s2;
};

__device__ __forceinline__ float sample_offset(int i, int ns) {
  return (float)(((double)i + 0.5) / (double)ns - 0.5);
}

// called by every thread of the block before a barrier
__device__ __forceinline__ void fill_sample_table(SampleTable* tab, int ns) {
  if ((int)threadIdx.x < min(ns, kMaxSamples))
    tab->offs[threadIdx.x] = sample_offset(threadIdx.x, ns);
  if (threadIdx.x == 0) tab->inv_s2 = (float)(1.0 / (double)(ns * ns));
}

// relx, rely: cell centre minus disk centre (lattice units); rr: the
// (shifted) disk radius, 0 for an empty slot, which gives 0; ns: samples
// per axis; tab: the block's filled SampleTable.
__device__ __forceinline__ float cov_sample(float relx, float rely, float rr,
                                            int ns, const SampleTable& tab) {
  const bool table = ns <= kMaxSamples;
  const float inv_s2 = tab.inv_s2;
  const float r2 = __fmul_rn(rr, rr);
  float cov = 0.0f;
  for (int a = 0; a < ns; ++a) {
    const float sy = table ? tab.offs[a] : sample_offset(a, ns);
    const float py = __fadd_rn(rely, sy);
    const float t = __fsub_rn(r2, __fmul_rn(py, py));
    for (int b = 0; b < ns; ++b) {
      const float sx = table ? tab.offs[b] : sample_offset(b, ns);
      const float px = __fadd_rn(relx, sx);
      if (__fmul_rn(px, px) <= t) cov = __fadd_rn(cov, inv_s2);
    }
  }
  // odd ns has a 0-offset sample: an empty slot would hit d = 0
  if ((ns & 1) && !(rr > 0.0f)) cov = 0.0f;
  return cov;
}

// d = sqrt(rely^2 + relx^2); clip((rr + 1/2) - d, 0, 1), 0 for an empty
// slot (the ramp would otherwise stamp phantom cover where d < 1/2)
__device__ __forceinline__ float cov_ramp(float relx, float rely, float rr) {
  const float d =
      __fsqrt_rn(__fadd_rn(__fmul_rn(rely, rely), __fmul_rn(relx, relx)));
  const float c = fminf(fmaxf(__fsub_rn(__fadd_rn(rr, 0.5f), d), 0.0f), 1.0f);
  return rr > 0.0f ? c : 0.0f;
}

// The analytic circle-cell overlap (ops/imb.exact_coverage, operation by
// operation): two reciprocals and one square root per cell. An empty slot
// (rr == 0) gives 0.
__device__ __forceinline__ float cov_exact(float relx, float rely, float rr) {
  const float ax = fabsf(relx), ay = fabsf(rely);
  const float A = fmaxf(ax, ay), Bc = fminf(ax, ay);
  const float d2 = __fadd_rn(__fmul_rn(relx, relx), __fmul_rn(rely, rely));
  const float d = __fsqrt_rn(d2);
  const float rc = __fsub_rn(rr, __frcp_rn(__fmul_rn(24.0f, fmaxf(rr, 1e-6f))));
  const float S = __fmul_rn(d, __fsub_rn(rc, d));
  const float C1 = __fmul_rn(0.5f, __fsub_rn(A, Bc));
  const float C2 = __fmul_rn(0.5f, __fadd_rn(A, Bc));
  const float t1 = __fadd_rn(S, C1);
  const float t2 = __fadd_rn(S, C2);
  const float t3 = __fsub_rn(S, C1);
  const float t4 = __fsub_rn(S, C2);
  const float u = fmaxf(t1, 0.0f), v = fmaxf(t2, 0.0f);
  const float p = fmaxf(t3, 0.0f), q = fmaxf(t4, 0.0f);
  const float inv_b = __frcp_rn(fmaxf(Bc, 1e-4f));
  const float alpha = fminf(fmaxf(__fmul_rn(t2, inv_b), 0.0f), 1.0f);
  const float beta = fminf(fmaxf(__fmul_rn(t3, inv_b), 0.0f), 1.0f);
  const float num = __fsub_rn(__fmul_rn(alpha, __fadd_rn(v, u)),
                              __fmul_rn(beta, __fadd_rn(p, q)));
  float cov = __fmul_rn(num, __fmul_rn(__frcp_rn(fmaxf(A, 1e-6f)), 0.5f));
  cov = fminf(fmaxf(cov, 0.0f), 1.0f);
  return d2 < 0.01f ? (rr > 0.81f ? 1.0f : 0.0f) : cov;
}

// The sample method with a conservative classification first: only a
// cell whose sample square straddles the rim runs the ns^2 loop. The
// farthest sample lies at most (|relx| + half, |rely| + half) from the
// centre and the nearest at least (max(|relx| - half, 0), ...). The
// relative margins lo = 1 - 2^-12 and hi = 1 + 2^-12 on r^2 are ~500x the
// f32 rounding of the loop's t-form test (a few 2^-24 of max(d^2, r^2)),
// so a cell classified all-in has every sample hit in the loop too, and
// all-out none: the result is the loop's to the bit. All-out is tested
// first, so an empty slot (rr == 0) gives 0 under odd ns as the loop's
// rule does. At r = 8 and ns = 4 about 10 % of a 21 x 21 window is ring.
__device__ __forceinline__ float cov_sample_fast(float relx, float rely,
                                                 float rr, const CovParams& cp,
                                                 const SampleTable& tab) {
  const float ax = fabsf(relx), ay = fabsf(rely);
  const float r2 = __fmul_rn(rr, rr);
  const float nx = fmaxf(__fsub_rn(ax, cp.half), 0.0f);
  const float ny = fmaxf(__fsub_rn(ay, cp.half), 0.0f);
  if (__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)) >= __fmul_rn(r2, cp.hi))
    return 0.0f;
  const float fx = __fadd_rn(ax, cp.half), fy = __fadd_rn(ay, cp.half);
  if (__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)) <= __fmul_rn(r2, cp.lo))
    return cp.full;
  return cov_sample(relx, rely, rr, cp.ns, tab);
}

// Coverage of one cell by one disk under method M; rr already shifted
// (shift_radius).
template <int M>
__device__ __forceinline__ float coverage(float relx, float rely, float rr,
                                          const CovParams& cp,
                                          const SampleTable& tab) {
  if constexpr (M == kRamp) return cov_ramp(relx, rely, rr);
  if constexpr (M == kExact) return cov_exact(relx, rely, rr);
  return cov_sample_fast(relx, rely, rr, cp, tab);
}
