// Per-disk coverage of one lattice cell: the device function shared by
// the stamp kernel (K1, stamp.cu) and the hydro-force reduce of the
// fused IMB step (K2, imb_reduce.cu).
//
// Counterpart of the JAX package's pallas_stamp._cov_field (the
// eps_method="sample" branch): eps_samples^2 subgrid points, tested in
// the t-form  (relx + sx)^2 <= r^2 - (rely + sy)^2.  Sample membership
// must agree BITWISE with the plain PyTorch version (ops/stamp.py
// cov_field): one flipped sample is a 1/ns^2 coverage step. Every
// operation therefore goes through the round-to-nearest intrinsics,
// which nvcc never contracts into an FMA, whatever the build flags.
#pragma once

// relx, rely: cell centre minus disk centre (lattice units); rr: disk
// radius (0 marks an empty slot and gives 0); r_shift: the
// eps_r_shift calibration (0 = none); ns: samples per axis.
__device__ __forceinline__ float cov_sample(float relx, float rely, float rr,
                                            float r_shift, int ns) {
  if (r_shift != 0.0f) {
    rr = rr > 0.0f ? fmaxf(__fadd_rn(rr, r_shift), 0.05f) : 0.0f;
  }
  // offsets and weight exactly as numpy computes them in float64, then
  // rounded to float32
  const float inv_s2 = (float)(1.0 / (double)(ns * ns));
  const float r2 = __fmul_rn(rr, rr);
  float cov = 0.0f;
  for (int a = 0; a < ns; ++a) {
    const float sy = (float)(((double)a + 0.5) / (double)ns - 0.5);
    const float py = __fadd_rn(rely, sy);
    const float t = __fsub_rn(r2, __fmul_rn(py, py));
    for (int b = 0; b < ns; ++b) {
      const float sx = (float)(((double)b + 0.5) / (double)ns - 0.5);
      const float px = __fadd_rn(relx, sx);
      if (__fmul_rn(px, px) <= t) cov = __fadd_rn(cov, inv_s2);
    }
  }
  // odd ns has a 0-offset sample: an empty slot would hit d = 0
  if ((ns & 1) && !(rr > 0.0f)) cov = 0.0f;
  return cov;
}
