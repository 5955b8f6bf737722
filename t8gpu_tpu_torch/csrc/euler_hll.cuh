// The hll and hllc interface fluxes on face-frame fields, shared by the
// first-order stage kernel (fused_rk_stage.cu, fields of each cell) and
// the MUSCL kernel (fused_muscl.cu, fields of each reconstruction): the
// arithmetic of hll_fields_flux and hllc_fields_flux in
// t8gpu_tpu_torch/ops/euler.py, in the same order (IEEE divisions and
// square roots, --fmad=false).  Min, max and clamp propagate NaN, as
// torch's do.

#pragma once

#include "euler_kepes.cuh"
#include "muscl_pencil.cuh"

namespace {

enum Flux { KEPES = 0, HLL = 1, HLLC = 2 };

// cell_fields_tuple(..., "hll"/"hllc") of a face-frame state:
// (rho, v[3], p, h, c, sqrt(rho), ke).
struct HllFields {
  float rho, u, v, w, p, h, c, sq, ke;
};

// inv_rho: 1 / s[0]
__device__ __forceinline__ HllFields hll_fields(const float s[5], float inv_rho,
                                                const Consts& k) {
  HllFields q;
  q.rho = s[0];
  q.u = s[1] * inv_rho;
  q.v = s[2] * inv_rho;
  q.w = s[3] * inv_rho;
  q.ke = 0.5f * ((q.u * q.u + q.v * q.v) + q.w * q.w);
  q.p = k.km1 * (s[4] - s[0] * q.ke);
  q.h = (s[4] + q.p) * inv_rho;
  q.c = sqrtf(k.km1 * (q.h - q.ke));
  q.sq = sqrtf(s[0]);
  return q;
}

// _roe_speeds: the Roe-averaged wave-speed bounds (s_l, s_r).  Here and
// in the two fluxes min, max and clamp propagate NaN, as torch's do, so
// that a reconstruction with p < 0 (positivity off) takes the plain
// version's branch.
__device__ __forceinline__ void roe_speeds(const HllFields& L, const HllFields& R,
                                           const Consts& k, float& s_l, float& s_r) {
  const float inv_w = 1.0f / (L.sq + R.sq);
  const float v1 = (L.sq * L.u + R.sq * R.u) * inv_w;
  const float v2 = (L.sq * L.v + R.sq * R.v) * inv_w;
  const float v3 = (L.sq * L.w + R.sq * R.w) * inv_w;
  const float h_roe = (L.sq * L.h + R.sq * R.h) * inv_w;
  const float c_roe = sqrtf(k.km1 * (h_roe - 0.5f * ((v1 * v1 + v2 * v2) + v3 * v3)));
  s_l = t8pencil::nan_min(v1 - c_roe, L.u - L.c);
  s_r = t8pencil::nan_max(v1 + c_roe, R.u + R.c);
}

// hll_fields_flux: returns max(|s_l|, |s_r|).
__device__ __forceinline__ float hll_flux(const HllFields& L, const HllFields& R,
                                          const Consts& k, float f[5]) {
  float s_l, s_r;
  roe_speeds(L, R, k, s_l, s_r);
  const float m_l = L.rho * L.u, m_r = R.rho * R.u;
  const float e_l = L.rho * L.h - L.p, e_r = R.rho * R.h - R.p;
  const float fl[5] = {m_l, m_l * L.u + L.p, m_l * L.v, m_l * L.w, m_l * L.h};
  const float fr[5] = {m_r, m_r * R.u + R.p, m_r * R.v, m_r * R.w, m_r * R.h};
  const float du[5] = {R.rho - L.rho, m_r - m_l, R.rho * R.v - L.rho * L.v,
                       R.rho * R.w - L.rho * L.w, e_r - e_l};
  const float slc = t8pencil::nan_min(s_l, 0.0f), src = t8pencil::nan_max(s_r, 0.0f);
  const float ss = src * slc, den = src - slc;
#pragma unroll
  for (int i = 0; i < 5; ++i) f[i] = ((src * fl[i] - slc * fr[i]) + ss * du[i]) / den;
  return t8pencil::nan_max(fabsf(s_l), fabsf(s_r));
}

// One side of hllc_fields_flux: its flux f_k, and f_k + s_k (U*_k - U_k)
// when `star`.
__device__ __forceinline__ void hllc_side(const HllFields& q, float s_k, float s_m,
                                          bool star, float f[5]) {
  constexpr float tiny = 1e-30f;
  const float m = q.rho * q.u;
  const float e = q.rho * q.h - q.p;  // total energy E
  f[0] = m;
  f[1] = m * q.u + q.p;
  f[2] = m * q.v;
  f[3] = m * q.w;
  f[4] = q.u * (e + q.p);
  if (!star) return;
  const float gap = s_k - s_m;
  const float gap_s = fabsf(gap) > tiny ? gap : tiny;
  const float ugap = s_k - q.u;
  const float r_star = q.rho * ugap / gap_s;
  const float ugap_s = fabsf(ugap) > tiny ? ugap : tiny;
  const float e_star = r_star * (e / q.rho + (s_m - q.u) * (s_m + q.p / (q.rho * ugap_s)));
  const float u_vec[5] = {q.rho, m, q.rho * q.v, q.rho * q.w, e};
  const float u_star[5] = {r_star, r_star * s_m, r_star * q.v, r_star * q.w, e_star};
#pragma unroll
  for (int i = 0; i < 5; ++i) f[i] = f[i] + s_k * (u_star[i] - u_vec[i]);
}

// hllc_fields_flux: HLL's fan plus the contact wave s_m; returns
// max(|s_l|, |s_r|).
__device__ __forceinline__ float hllc_flux(const HllFields& L, const HllFields& R,
                                           const Consts& k, float f[5]) {
  constexpr float tiny = 1e-30f;
  float s_l, s_r;
  roe_speeds(L, R, k, s_l, s_r);
  const float m_l = L.rho * L.u, m_r = R.rho * R.u;
  const float num = ((R.p - L.p) + m_l * (s_l - L.u)) - m_r * (s_r - R.u);
  const float den = L.rho * (s_l - L.u) - R.rho * (s_r - R.u);
  const float s_m = num / (fabsf(den) > tiny ? den : -tiny);
  if (s_l >= 0.0f)
    hllc_side(L, s_l, s_m, false, f);
  else if (s_m >= 0.0f)
    hllc_side(L, s_l, s_m, true, f);
  else if (s_r >= 0.0f)
    hllc_side(R, s_r, s_m, true, f);
  else
    hllc_side(R, s_r, s_m, false, f);
  return t8pencil::nan_max(fabsf(s_l), fabsf(s_r));
}

}  // namespace
