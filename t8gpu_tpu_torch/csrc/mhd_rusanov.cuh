// The GLM-MHD interface flux shared by the two MHD kernels
// (fused_mhd_flux.cu, fused_mhd_muscl.cu): the Rusanov flux of the 7
// Galilean rows with the exact 2x2 GLM solve of (B_n, psi), in the face
// frame, as models/mhd._rusanov_rows of the port (and of the JAX package).
// Every expression keeps that function's operation order; built with
// --fmad=false and without fast math (IEEE division and sqrtf), so the
// kernels follow their plain PyTorch versions bit for bit (the first-order
// kernel) or to a few ulp, and two threads that evaluate one interface
// get bit-identical fluxes.  The states come in rotated into the face
// frame (muscl_pencil.cuh's frame_row), the flux goes out in it.

#pragma once

#include <cuda_runtime.h>

namespace t8mhd {

constexpr int ROWS = 9;  // rho, m_x, m_y, m_z, E, B_x, B_y, B_z, psi

// gamma and gamma - 1 rounded from double to float once on the host (the
// JAX code combines gamma in Python doubles and rounds to f32).
struct Consts {
  float gamma;
  float km1;
};

// Thermal pressure (_pressure): (g-1) * (E - ke - |B|^2/2).
__device__ __forceinline__ float pressure(float rho, float mn, float mt1,
                                          float mt2, float e, float b2,
                                          const Consts& k) {
  const float inv = 1.0f / rho;
  const float ke = 0.5f * ((mn * mn + mt1 * mt1) + mt2 * mt2) * inv;
  return k.km1 * ((e - ke) - 0.5f * b2);
}

// _phys_flux: the 7 Galilean flux rows (B_n is the GLM subsystem's) into
// f; returns |u_n| + c_f (_fast_speed).
__device__ __forceinline__ float phys_flux(float rho, float mn, float mt1,
                                           float mt2, float e, float bn,
                                           float bt1, float bt2,
                                           const Consts& k, float f[7]) {
  const float inv = 1.0f / rho;
  const float un = mn * inv, ut1 = mt1 * inv, ut2 = mt2 * inv;
  const float b2 = (bn * bn + bt1 * bt1) + bt2 * bt2;
  const float p = pressure(rho, mn, mt1, mt2, e, b2, k);
  const float pt = p + 0.5f * b2;
  const float vb = (un * bn + ut1 * bt1) + ut2 * bt2;

  const float a2 = k.gamma * fmaxf(p, 1e-12f) * inv;
  const float bb2 = b2 * inv;
  const float bn2 = bn * bn * inv;
  const float s = a2 + bb2;
  const float disc = sqrtf(fmaxf(s * s - 4.0f * a2 * bn2, 0.0f));
  const float cf = sqrtf(0.5f * (s + disc));

  f[0] = mn;
  f[1] = (mn * un + pt) - bn * bn;
  f[2] = mt1 * un - bn * bt1;
  f[3] = mt2 * un - bn * bt2;
  f[4] = (e + pt) * un - bn * vb;
  f[5] = bt1 * un - ut1 * bn;
  f[6] = bt2 * un - ut2 * bn;
  return fabsf(un) + cf;
}

// _rusanov_rows: the face-frame flux from the rotated left and right
// states, with the cleaning speed ch; returns the max signal speed.
__device__ __forceinline__ float rusanov(const float L[ROWS],
                                         const float R[ROWS], float ch,
                                         const Consts& k, float f[ROWS]) {
  // exact GLM 2x2 interface solve (Dedner eq. 42)
  const float bn_s = 0.5f * (L[5] + R[5]) - 0.5f / ch * (R[8] - L[8]);
  const float psi_s = 0.5f * (L[8] + R[8]) - 0.5f * ch * (R[5] - L[5]);

  float fl[7], fr[7];
  const float s_l = phys_flux(L[0], L[1], L[2], L[3], L[4], bn_s, L[6], L[7], k, fl);
  const float s_r = phys_flux(R[0], R[1], R[2], R[3], R[4], bn_s, R[6], R[7], k, fr);
  const float smax = fmaxf(s_l, s_r);
  const float hs = 0.5f * smax;

  f[0] = 0.5f * (fl[0] + fr[0]) - hs * (R[0] - L[0]);
  f[1] = 0.5f * (fl[1] + fr[1]) - hs * (R[1] - L[1]);
  f[2] = 0.5f * (fl[2] + fr[2]) - hs * (R[2] - L[2]);
  f[3] = 0.5f * (fl[3] + fr[3]) - hs * (R[3] - L[3]);
  f[4] = 0.5f * (fl[4] + fr[4]) - hs * (R[4] - L[4]);
  f[5] = psi_s;  // F(B_n): the GLM divergence wave
  f[6] = 0.5f * (fl[5] + fr[5]) - hs * (R[6] - L[6]);
  f[7] = 0.5f * (fl[6] + fr[6]) - hs * (R[7] - L[7]);
  f[8] = ch * ch * bn_s;  // F(psi)
  return smax;
}

inline Consts make_consts(double gamma) {
  return {(float)gamma, (float)(gamma - 1.0)};
}

}  // namespace t8mhd
