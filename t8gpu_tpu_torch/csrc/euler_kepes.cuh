// Device code shared by the first-order Euler kernels (fused_rk_stage.cu,
// fused_fields.cu, inner_divergence.cu) and the MUSCL kernel
// (fused_muscl.cu, through euler_hll.cuh): the gamma constants, the kepes
// cell fields, the face-frame rotation and the KEPES interface flux on
// per-cell fields.  The arithmetic is that of kepes_fields_flux in
// t8gpu_tpu_torch/ops/euler.py, in the same order; built with
// --fmad=false, the kernels follow their plain PyTorch versions bit for
// bit.

#pragma once

#include <cuda_runtime.h>

namespace {

// gamma-derived constants, rounded from double to float once on the host
// (the JAX code combines gamma in Python doubles and rounds to f32).
struct Consts {
  float gamma;        // gamma
  float km1;          // gamma - 1
  float half_gamma;   // gamma * 0.5
  float h_coef;       // gamma / (2 (gamma - 1))
  float inv_km1;      // 1 / (gamma - 1)
  float half_over_g;  // 0.5 / gamma
  float km1_over_g;   // (gamma - 1) / gamma
  float two_km1;      // 2 (gamma - 1)
};

inline Consts make_consts(double gamma) {
  return {(float)gamma,
          (float)(gamma - 1.0),
          (float)(gamma * 0.5),
          (float)(gamma / (2.0 * (gamma - 1.0))),
          (float)(1.0 / (gamma - 1.0)),
          (float)(0.5 / gamma),
          (float)((gamma - 1.0) / gamma),
          (float)(2.0 * (gamma - 1.0))};
}

// kepes cell fields: [rho, v, p, rho/p, log rho, log p, vent0, ke]
struct Fields {
  float rho, v[3], p, rhop, lrho, lp, vent0, ke;
};

// Face frame of a +A normal: normal component A, tangents the other two axes
// in increasing order (AXIS_ROTATE / AXIS_UNROTATE of ops/euler.py).
template <int A>
struct Frame {
  static constexpr int n = A;
  static constexpr int t1 = (A == 0) ? 1 : 0;
  static constexpr int t2 = (A == 2) ? 1 : 2;
};

__device__ __forceinline__ float series_den(float v) {
  return 105.0f + v * (35.0f + v * (21.0f + v * 15.0f));
}

// KEPES flux across a +A face from left cell fields L to right cell fields
// R; f comes back in x, y, z rows.  Returns the interface wave speed.
template <int A>
__device__ __forceinline__ float kepes_flux(const Fields& L, const Fields& R,
                                            const Consts& k, float f[5]) {
  using Fr = Frame<A>;
  const float u_l = L.v[Fr::n], v_l = L.v[Fr::t1], w_l = L.v[Fr::t2];
  const float u_r = R.v[Fr::n], v_r = R.v[Fr::t1], w_r = R.v[Fr::t2];

  const float d_r = R.rho - L.rho;
  const float s_r = L.rho + R.rho;
  const float d_b = R.rhop - L.rhop;
  const float s_b = L.rhop + R.rhop;
  const float s_r2 = s_r * s_r;
  const float s_b2 = s_b * s_b;
  const float q2 = 1.0f / (s_r2 * s_b2);
  const float vsq_r = (d_r * d_r) * s_b2 * q2;
  const float vsq_b = (d_b * d_b) * s_r2 * q2;
  const bool c_r = vsq_r < 1.0e-4f;
  const bool c_b = vsq_b < 1.0e-4f;
  const float num_r = c_r ? s_r * 52.5f : d_r;
  const float den_r = c_r ? series_den(vsq_r) : R.lrho - L.lrho;
  const float num_b = c_b ? s_b * 52.5f : d_b;
  const float den_b = c_b ? series_den(vsq_b) : (R.lrho - R.lp) - (L.lrho - L.lp);
  const float Q = 1.0f / (den_r * num_b * s_b);
  const float nbsb = num_b * s_b;
  const float rho_hat = num_r * nbsb * Q;
  const float inv_bh = (2.0f * den_b * den_r * s_b) * Q;
  const float p1_hat = s_r * den_r * num_b * Q;

  const float u_hat = 0.5f * (u_l + u_r);
  const float v_hat = 0.5f * (v_l + v_r);
  const float w_hat = 0.5f * (w_l + w_r);
  const float a_hat = sqrtf(k.half_gamma * (L.p + R.p)) * rsqrtf(rho_hat);
  const float h_hat = k.h_coef * inv_bh + 0.5f * (u_l * u_r + v_l * v_r + w_l * w_r);
  const float vel2_m = L.ke + R.ke;

  const float f0 = rho_hat * u_hat;
  const float f1 = f0 * u_hat + p1_hat;
  const float f2 = f0 * v_hat;
  const float f3 = f0 * w_hat;
  const float f4 = f0 * 0.5f * (k.inv_km1 * inv_bh - vel2_m) + u_hat * f1 +
                   v_hat * f2 + w_hat * f3;

  const float d0 = k.half_over_g * fabsf(u_hat - a_hat) * rho_hat;
  const float d1 = fabsf(u_hat) * k.km1_over_g * rho_hat;
  const float d2 = fabsf(u_hat) * p1_hat;
  const float d4 = k.half_over_g * fabsf(u_hat + a_hat) * rho_hat;

  const float dv0 = R.vent0 - L.vent0;
  const float dv1 = R.rhop * u_r - L.rhop * u_l;
  const float dv2 = R.rhop * v_r - L.rhop * v_l;
  const float dv3 = R.rhop * w_r - L.rhop * w_l;
  const float dv4 = -(R.rhop - L.rhop);

  const float ek = 0.5f * (u_hat * u_hat + v_hat * v_hat + w_hat * w_hat);
  const float w0 = dv0 + (u_hat - a_hat) * dv1 + v_hat * dv2 + w_hat * dv3 +
                   (h_hat - u_hat * a_hat) * dv4;
  const float w1 = dv0 + u_hat * dv1 + v_hat * dv2 + w_hat * dv3 + ek * dv4;
  const float w2 = dv2 + v_hat * dv4;
  const float w3 = dv3 + w_hat * dv4;
  const float w4 = dv0 + (u_hat + a_hat) * dv1 + v_hat * dv2 + w_hat * dv3 +
                   (h_hat + u_hat * a_hat) * dv4;

  const float g0 = d0 * w0, g1 = d1 * w1, g2 = d2 * w2, g3 = d2 * w3, g4 = d4 * w4;

  const float diss0 = g0 + g1 + g4;
  const float diss1 = (u_hat - a_hat) * g0 + u_hat * g1 + (u_hat + a_hat) * g4;
  const float diss2 = v_hat * (g0 + g1 + g4) + g2;
  const float diss3 = w_hat * (g0 + g1 + g4) + g3;
  const float diss4 = (h_hat - u_hat * a_hat) * g0 + ek * g1 + v_hat * g2 +
                      w_hat * g3 + (h_hat + u_hat * a_hat) * g4;

  f[0] = f0 - 0.5f * diss0;
  f[1 + Fr::n] = f1 - 0.5f * diss1;
  f[1 + Fr::t1] = f2 - 0.5f * diss2;
  f[1 + Fr::t2] = f3 - 0.5f * diss3;
  f[4] = f4 - 0.5f * diss4;
  return fabsf(u_hat) + a_hat;
}

}  // namespace
