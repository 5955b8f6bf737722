// Device code shared by the first-order Euler kernels (fused_rk_stage.cu,
// fused_fields.cu): the KEPES interface flux on per-cell fields, the
// face-frame rotation, the per-cell divergence of a block and the
// per-element speed max.  The arithmetic is that of kepes_fields_flux in
// t8gpu_tpu_torch/ops/euler.py, in the same order; built with
// --fmad=false, so the two threads that evaluate one interface get
// bit-identical fluxes and the kernels follow their plain PyTorch
// versions to a few ulp.
//
// Layout (element-minor, as in the JAX package): a block tensor is
// [C, EXT^DIM, E] (row stride EXT^DIM * E), a side layer [C, EXT^(DIM-1),
// E] with the tangent axes in increasing order; side k = 2*axis + (0 hi,
// 1 lo).  One thread per (element, cell), elements fastest across
// threadIdx.x, so a warp's load of one cell row is one coalesced 128-byte
// line and a neighbour cell along any axis sits at a fixed stride of E
// floats.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_E = 32;  // elements per block (threadIdx.x)
constexpr int TILE_C = 8;   // cells per block (threadIdx.y)

__host__ __device__ constexpr int ipow(int b, int n) {
  return n == 0 ? 1 : b * ipow(b, n - 1);
}

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

struct Sides {
  const float* p[6];
};

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

// The two interfaces of cell idx along axis A: D += w_lo F(lo) - w_hi F(hi).
// load(base, row_stride, offset) gives the fields of one cell of a block
// tensor or a side layer.
template <int DIM, int EXT, int A, class Load>
__device__ __forceinline__ void axis_update(
    const float* __restrict__ u, const Sides& sides, const float* __restrict__ w,
    const Fields& q, const int idx[3], int c, int e, long long Es, long long rs,
    long long ls, float surface, float interior_ok, const Consts& k,
    const Load& load, float D[5], float& spd) {
  constexpr int stride = ipow(EXT, DIM - 1 - A);  // cell stride along A
  const int ia = idx[A];
  int t = 0;  // cell index within the side layer
#pragma unroll
  for (int b = 0; b < DIM; ++b)
    if (b != A) t = t * EXT + idx[b];
  const float w_hi = __ldg(w + (1 + 2 * A) * Es + e);
  const float w_lo = __ldg(w + (2 + 2 * A) * Es + e);

  float f[5], fhi[5];
  // +A face: the next cell, or the hi side layer after the last cell
  Fields qn;
  float wgt, ok;
  if (ia < EXT - 1) {
    qn = load(u, rs, (long long)(c + stride) * Es + e);
    wgt = surface;
    ok = interior_ok;
  } else {
    qn = load(sides.p[2 * A], ls, (long long)t * Es + e);
    wgt = w_hi;
    ok = w_hi > 0.0f ? 1.0f : 0.0f;
  }
  float sp = kepes_flux<A>(q, qn, k, f);
  spd = fmaxf(spd, sp * ok);
#pragma unroll
  for (int r = 0; r < 5; ++r) fhi[r] = f[r] * wgt;

  // -A face: the previous cell, or the lo side layer before cell 0
  Fields qp;
  if (ia > 0) {
    qp = load(u, rs, (long long)(c - stride) * Es + e);
    wgt = surface;
  } else {
    qp = load(sides.p[2 * A + 1], ls, (long long)t * Es + e);
    wgt = w_lo;
  }
  sp = kepes_flux<A>(qp, q, k, f);
  if (ia == 0) spd = fmaxf(spd, sp * (w_lo > 0.0f ? 1.0f : 0.0f));
#pragma unroll
  for (int r = 0; r < 5; ++r) D[r] = (D[r] + f[r] * wgt) - fhi[r];
}

// The first-order divergence D of cell c of element e (interior faces with
// weight w[0], the block's end faces against the side layers with weights
// w[1 + k]) and the cell's max interface speed.  Returns the cell's own
// fields.
template <int DIM, int EXT, class Load>
__device__ __forceinline__ Fields tile_divergence(
    const float* __restrict__ u, const Sides& sides,
    const float* __restrict__ w, int c, int e, long long Es, long long rs,
    long long ls, const Consts& k, const Load& load, float D[5], float& spd) {
  int idx[3] = {0, 0, 0};
  int rem = c;
#pragma unroll
  for (int a = DIM - 1; a >= 0; --a) {
    idx[a] = rem % EXT;
    rem /= EXT;
  }
  const Fields q = load(u, rs, (long long)c * Es + e);
  const float surface = __ldg(w + e);
  const float interior_ok = surface > 0.0f ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < 5; ++r) D[r] = 0.0f;
  axis_update<DIM, EXT, 0>(u, sides, w, q, idx, c, e, Es, rs, ls, surface,
                           interior_ok, k, load, D, spd);
  axis_update<DIM, EXT, 1>(u, sides, w, q, idx, c, e, Es, rs, ls, surface,
                           interior_ok, k, load, D, spd);
  if constexpr (DIM == 3)
    axis_update<DIM, EXT, 2>(u, sides, w, q, idx, c, e, Es, rs, ls, surface,
                             interior_ok, k, load, D, spd);
  return q;
}

// Per-element speed max: a shared-memory max over the block's cells, then
// one atomicMax on the float's bits per element and block.  max does not
// depend on order, so the result is bit-reproducible.  Every thread of the
// block calls it.
__device__ __forceinline__ void element_speed_max(float (*red)[TILE_E],
                                                  float spd, bool live,
                                                  unsigned int* speed, int e) {
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

// Cells in a block of extent EXT in DIM dimensions, for the 2x2 supported
// shapes of the block kernels.
inline int block_cells(int dim, int ext) {
  return ext == 8 ? (dim == 3 ? 512 : 64) : (dim == 3 ? 64 : 16);
}

}  // namespace
