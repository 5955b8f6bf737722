// The GLM-MHD interface flux shared by the two MHD kernels
// (fused_mhd_flux.cu, fused_mhd_muscl.cu): the Rusanov flux of the 7
// Galilean rows with the exact 2x2 GLM solve of (B_n, psi), in the face
// frame, as models/mhd._rusanov_rows of the port (and of the JAX package).
// Every expression keeps that function's operation order; built with
// --fmad=false and without fast math (IEEE division and sqrtf), so the
// kernels follow their plain PyTorch versions to a few ulp and two threads
// that evaluate one interface get bit-identical fluxes.

#pragma once

#include <cuda_runtime.h>

namespace t8mhd {

constexpr int ROWS = 9;     // rho, m_x, m_y, m_z, E, B_x, B_y, B_z, psi
constexpr int TILE_E = 32;  // elements per block (threadIdx.x)
constexpr int TILE_C = 8;   // cells per block (threadIdx.y)

__host__ __device__ constexpr int ipow(int b, int n) {
  return n == 0 ? 1 : b * ipow(b, n - 1);
}

// gamma and gamma - 1 rounded from double to float once on the host (the
// JAX code combines gamma in Python doubles and rounds to f32).
struct Consts {
  float gamma;
  float km1;
};

struct Sides {
  const float* p[6];
};

// Face frame of a +A normal: normal component A, tangents the other two
// axes in increasing order, for the momentum (rows 1-3) and the field
// (rows 5-7) alike (_ROT9 / _UNROT9 of models/mhd.py).
template <int A>
struct Frame {
  static constexpr int n = A;
  static constexpr int t1 = (A == 0) ? 1 : 0;
  static constexpr int t2 = (A == 2) ? 1 : 2;
};

// One state, rows rotated into the +A frame.
template <int A>
__device__ __forceinline__ void load9(const float* __restrict__ base,
                                      long long rs, long long off,
                                      float s[ROWS]) {
  using Fr = Frame<A>;
  float r[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) r[i] = __ldg(base + off + i * rs);
  s[0] = r[0];
  s[1] = r[1 + Fr::n];
  s[2] = r[1 + Fr::t1];
  s[3] = r[1 + Fr::t2];
  s[4] = r[4];
  s[5] = r[5 + Fr::n];
  s[6] = r[5 + Fr::t1];
  s[7] = r[5 + Fr::t2];
  s[8] = r[8];
}

// Frame rows back to x, y, z rows, times the face weight.
template <int A>
__device__ __forceinline__ void unrotate9(const float f[ROWS], float wgt,
                                          float out[ROWS]) {
  using Fr = Frame<A>;
  out[0] = f[0] * wgt;
  out[1 + Fr::n] = f[1] * wgt;
  out[1 + Fr::t1] = f[2] * wgt;
  out[1 + Fr::t2] = f[3] * wgt;
  out[4] = f[4] * wgt;
  out[5 + Fr::n] = f[5] * wgt;
  out[5 + Fr::t1] = f[6] * wgt;
  out[5 + Fr::t2] = f[7] * wgt;
  out[8] = f[8] * wgt;
}

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

// Where one thread's cell sits: its element and the strides.
struct Site {
  int e;
  long long Es;  // element count (stride of one cell)
  long long rs;  // row stride of a block state
  long long ls;  // row stride of a side layer
};

// The thread's cell coordinates (x slowest) from its flat cell index.
template <int DIM, int EXT>
__device__ __forceinline__ void cell_coords(int c, int idx[3]) {
  idx[0] = idx[1] = idx[2] = 0;
  int rem = c;
#pragma unroll
  for (int a = DIM - 1; a >= 0; --a) {
    idx[a] = rem % EXT;
    rem /= EXT;
  }
}

// Index of the thread's cell within the side layers of axis A (the
// remaining axes in increasing order).
template <int DIM, int EXT, int A>
__device__ __forceinline__ int tangent_index(const int idx[3]) {
  int t = 0;
#pragma unroll
  for (int b = 0; b < DIM; ++b)
    if (b != A) t = t * EXT + idx[b];
  return t;
}

// The per-element speed max of a block of TILE_C x TILE_E threads: a
// shared-memory max over the block's cells and one atomicMax on the bits
// of the non-negative float (max is order-free, so the result is
// bit-reproducible; no float atomics).  Every thread of the block calls it.
__device__ __forceinline__ void element_speed_max(float spd, bool live, int e,
                                                  unsigned int* speed) {
  __shared__ float red[TILE_C][TILE_E];
  red[threadIdx.y][threadIdx.x] = spd;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    float m = red[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < TILE_C; ++j) m = fmaxf(m, red[j][threadIdx.x]);
    m = m > 0.0f ? m : 0.0f;  // +0 for zero and NaN: the bits order as floats
    atomicMax(speed + e, __float_as_uint(m));
  }
}

inline Consts make_consts(double gamma) {
  return {(float)gamma, (float)(gamma - 1.0)};
}

}  // namespace t8mhd
