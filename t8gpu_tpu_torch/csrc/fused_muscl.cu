// Second-order MUSCL flux divergence of the subgrid compressible-Euler
// scheme, fused into one kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_muscl_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:848, body _fused_muscl_kernel :827 and
// _tile_muscl_divergence :427) for flux "kepes".  Per element E and cell c
// of its [EXT]^DIM block, and per axis a:
//
//   slope_i = lim(u_i - u_{i-1}, u_{i+1} - u_i)      (lim: minmod or central)
//   u_L(i)  = guard(u_i + slope_i / 2, u_i),  u_R(i) = guard(u_i - slope_i / 2, u_i)
//   F(i|i+1) = KEPES pair flux (kepes_pair_flux of t8gpu_tpu/ops/euler.py)
//              from u_L(i) to u_R(i+1)
//   D(c)   += w(c-1|c) F(c-1|c) - w(c|c+1) F(c|c+1)
//   speed   = per-element max wave speed over the masked interfaces
//
// At the block edge the outward difference reads the equal-level
// neighbour's facing layer (rows 0-4 of the side slab) and is multiplied by
// eq = (w[1+k] > 0), so walls, dead and hanging sides get a one-sided slope
// (zero for minmod, half for central).  The neighbour's reconstruction
// toward us is built from the same four layers it sees itself (its facing
// and second layer, rows 5-9, and our edge layer), so both elements
// evaluate the identical mesh-face flux and conservation is exact.  The
// guard keeps the cell's own state where the reconstruction has rho <= 0 or
// p <= 0 (cons: p recomputed from the reconstruction; prim: two compares).
// In prim space every state (block and side-layer cells) becomes
// (rho, v, p) by prim_rows, in the unrotated row order, before the axis
// rotation.  Interior faces carry w[0]; the +a face of the last cell w[1+2a],
// the -a face of cell 0 w[2+2a].
//
// Layout (element-minor, as in the JAX package): u and D are
// [5, EXT^DIM, E]; w is [8, E]; side slab k is [10, EXT^(DIM-1), E], side
// k = 2a + (0 for +a, 1 for -a), tangent axes in increasing order; speed is
// [E] (float bits).
//
// Bound on this card: at the flagship shape (DIM 3, EXT 8, E 4374) one
// launch must read u (44.8 MB), six side slabs (67.2 MB) and the weights,
// and write D (44.8 MB): ~157 MB, 47 us at 3.35 TB/s.  The necessary
// arithmetic (one pair flux, ~220 operations with two logs, four divides, a
// sqrt and a rsqrt, per interface, 7.6M interfaces) is ~1.7 GFLOP, 25 us at
// the fp32 peak, so the bytes bound it.
//
// Design (the simple version that is right first): one thread per
// (element, cell), elements fastest across threadIdx.x, so a warp's load of
// one cell row is one coalesced 128-byte line and all threads of a warp
// share one cell (no divergence at the block edges).  Each thread evaluates
// its own two interfaces per axis, each from the four states around it
// (re-read through L1/L2), so every interior interface is evaluated twice,
// by the same code on the same inputs, and every cell's slope four times:
// the kernel does ~2.5x the necessary arithmetic and is issue-bound, not
// byte-bound.  Staging a tile in shared memory so each interface is
// evaluated once is later perf work.  The ragged element edge is masked,
// not padded.  The per-element speed max is a shared-memory max over the
// block's cells and one atomicMax on the non-negative float's bits: max is
// order-free, so the result is bit-reproducible; no float atomics.
//
// Built without --use_fast_math and with --fmad=false (IEEE division and
// sqrt, no contraction): the two threads of an interface get bit-identical
// fluxes, and the kernel follows its plain PyTorch version to a few ulp.

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
};

struct Sides {
  const float* p[6];
};

// Face frame of a +A normal: normal component A, tangents the other two axes
// in increasing order (AXIS_ROTATE / AXIS_UNROTATE of ops/euler.py).
template <int A>
struct Frame {
  static constexpr int n = A;
  static constexpr int t1 = (A == 0) ? 1 : 0;
  static constexpr int t2 = (A == 2) ? 1 : 2;
};

// One state in the +A frame: rows (rho, m_n, m_t1, m_t2, e) in cons space,
// (rho, v_n, v_t1, v_t2, p) in prim space.  prim_rows runs on the unrotated
// rows, as in the JAX kernel.
template <int A, bool PRIM>
__device__ __forceinline__ void load_state(const float* __restrict__ base,
                                           long long rs, long long off,
                                           const Consts& k, float s[5]) {
  using Fr = Frame<A>;
  float r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) r[i] = __ldg(base + off + i * rs);
  if (PRIM) {
    const float inv_rho = 1.0f / r[0];
    const float v1 = r[1] * inv_rho, v2 = r[2] * inv_rho, v3 = r[3] * inv_rho;
    const float p = k.km1 * (r[4] - 0.5f * ((r[1] * v1 + r[2] * v2) + r[3] * v3));
    r[1] = v1;
    r[2] = v2;
    r[3] = v3;
    r[4] = p;
  }
  s[0] = r[0];
  s[1] = r[1 + Fr::n];
  s[2] = r[1 + Fr::t1];
  s[3] = r[1 + Fr::t2];
  s[4] = r[4];
}

template <bool MINMOD>
__device__ __forceinline__ float limit(float a, float b) {
  if (MINMOD) return (a * b > 0.0f) ? copysignf(fminf(fabsf(a), fabsf(b)), a) : 0.0f;
  return 0.5f * (a + b);
}

// rec = guard(rec, base): keep base where rec has rho <= 0 or p <= 0.
template <bool PRIM, bool POS>
__device__ __forceinline__ void guard(float rec[5], const float base[5],
                                      const Consts& k) {
  if (!POS) return;
  bool ok;
  if (PRIM) {
    ok = (rec[0] > 0.0f) & (rec[4] > 0.0f);
  } else {
    const float s_rho = 1.0f / rec[0];
    const float kinetic =
        0.5f * ((rec[1] * rec[1] + rec[2] * rec[2]) + rec[3] * rec[3]) * s_rho;
    const float p = k.km1 * (rec[4] - kinetic);
    ok = (rec[0] > 0.0f) & (p > 0.0f);
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 5; ++i) rec[i] = base[i];
  }
}

// kepes_pair_fields / prim_pair_fields: (rho, v[3], p, rho/p, 1/rho, 1/p, ke)
struct Pair {
  float rho, v[3], p, rhop, irho, ip, ke;
};

template <bool PRIM>
__device__ __forceinline__ Pair pair_fields(const float s[5], const Consts& k) {
  Pair q;
  q.rho = s[0];
  if (PRIM) {
    q.irho = 1.0f / s[0];
    q.ip = 1.0f / s[4];
    q.rhop = s[0] * q.ip;
    q.v[0] = s[1];
    q.v[1] = s[2];
    q.v[2] = s[3];
    q.ke = 0.5f * ((s[1] * s[1] + s[2] * s[2]) + s[3] * s[3]);
    q.p = s[4];
  } else {
    q.irho = 1.0f / s[0];
    q.v[0] = s[1] * q.irho;
    q.v[1] = s[2] * q.irho;
    q.v[2] = s[3] * q.irho;
    q.ke = 0.5f * ((q.v[0] * q.v[0] + q.v[1] * q.v[1]) + q.v[2] * q.v[2]);
    q.p = k.km1 * (s[4] - s[0] * q.ke);
    q.ip = 1.0f / q.p;
    q.rhop = s[0] * q.ip;
  }
  return q;
}

__device__ __forceinline__ float series_den(float v) {
  return 105.0f + v * (35.0f + v * (21.0f + v * 15.0f));
}

// KEPES pair flux (kepes_pair_flux of ops/euler.py) in the face frame: f in
// frame rows (rho, normal, t1, t2, energy).  Returns the wave speed.
__device__ __forceinline__ float kepes_pair_flux(const Pair& L, const Pair& R,
                                                 const Consts& k, float f[5]) {
  const float u_l = L.v[0], v_l = L.v[1], w_l = L.v[2];
  const float u_r = R.v[0], v_r = R.v[1], w_r = R.v[2];

  const float dlrho = logf(R.rho * L.irho);  // log(rho_r / rho_l)
  const float dlp = logf(R.p * L.ip);        // log(p_r / p_l)

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
  const float den_r = c_r ? series_den(vsq_r) : dlrho;
  const float num_b = c_b ? s_b * 52.5f : d_b;
  const float den_b = c_b ? series_den(vsq_b) : dlrho - dlp;
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

  const float dv0 = -(dlp - k.gamma * dlrho) * k.inv_km1 -
                    (R.rhop * R.ke - L.rhop * L.ke);
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
  f[1] = f1 - 0.5f * diss1;
  f[2] = f2 - 0.5f * diss2;
  f[3] = f3 - 0.5f * diss3;
  f[4] = f4 - 0.5f * diss4;
  return fabsf(u_hat) + a_hat;
}

// Where one thread's cell sits: its element, its cell index with the axis
// coordinate zeroed per axis, and the strides.
struct Site {
  int e;
  long long Es;  // element count (stride of one cell)
  long long rs;  // row stride of a block state
  long long ls;  // row stride of a side slab
};

// The state at position q in [-2, EXT+1] along axis A on the thread's line:
// block cells 0..EXT-1, then the hi side's facing (EXT) and second (EXT+1)
// layer, the lo side's facing (-1) and second (-2) layer.
template <int DIM, int EXT, int A, bool PRIM>
__device__ __forceinline__ void fetch(int q, const float* __restrict__ u,
                                      const Sides& sides, int c0, int t,
                                      const Site& st, const Consts& k,
                                      float s[5]) {
  constexpr int stride = ipow(EXT, DIM - 1 - A);  // cell stride along A
  const long long toff = (long long)t * st.Es + st.e;
  if (q >= 0 && q < EXT)
    load_state<A, PRIM>(u, st.rs, (long long)(c0 + q * stride) * st.Es + st.e, k, s);
  else if (q >= EXT)
    load_state<A, PRIM>(sides.p[2 * A] + (q - EXT) * 5 * st.ls, st.ls, toff, k, s);
  else
    load_state<A, PRIM>(sides.p[2 * A + 1] + (-1 - q) * 5 * st.ls, st.ls, toff, k, s);
}

// The flux across the interface between positions p and p+1 along axis A,
// p in [-1, EXT-1], in frame rows; returns its wave speed.
template <int DIM, int EXT, int A, bool PRIM, bool MINMOD, bool POS>
__device__ __forceinline__ float interface_flux(
    int p, const float* __restrict__ u, const Sides& sides, int c0, int t,
    const Site& st, float eq_hi, float eq_lo, const Consts& k, float f[5]) {
  float x0[5], x1[5], x2[5], x3[5];  // positions p-1, p, p+1, p+2
  fetch<DIM, EXT, A, PRIM>(p - 1, u, sides, c0, t, st, k, x0);
  fetch<DIM, EXT, A, PRIM>(p, u, sides, c0, t, st, k, x1);
  fetch<DIM, EXT, A, PRIM>(p + 1, u, sides, c0, t, st, k, x2);
  fetch<DIM, EXT, A, PRIM>(p + 2, u, sides, c0, t, st, k, x3);

  float sl[5], sr[5];
  if (p == -1) {
    // lo neighbour's facing cell, from its second layer, facing layer and
    // our cell 0: s = lim(l0 - l1, m - l0), lo_sub = l0 + s/2
#pragma unroll
    for (int i = 0; i < 5; ++i)
      sl[i] = x1[i] + 0.5f * limit<MINMOD>(x1[i] - x0[i], x2[i] - x1[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      float dl = x1[i] - x0[i];
      if (p == 0) dl = dl * eq_lo;
      float dh = x2[i] - x1[i];
      if (p == EXT - 1) dh = dh * eq_hi;
      sl[i] = x1[i] + 0.5f * limit<MINMOD>(dl, dh);
    }
  }
  if (p + 1 == EXT) {
    // hi neighbour's facing cell, from our last cell, its facing and second
    // layer: s = lim(h0 - m, h1 - h0), hi_sub = h0 - s/2
#pragma unroll
    for (int i = 0; i < 5; ++i)
      sr[i] = x2[i] - 0.5f * limit<MINMOD>(x2[i] - x1[i], x3[i] - x2[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      float dl = x2[i] - x1[i];
      if (p + 1 == 0) dl = dl * eq_lo;
      float dh = x3[i] - x2[i];
      if (p + 1 == EXT - 1) dh = dh * eq_hi;
      sr[i] = x2[i] - 0.5f * limit<MINMOD>(dl, dh);
    }
  }
  guard<PRIM, POS>(sl, x1, k);
  guard<PRIM, POS>(sr, x2, k);
  return kepes_pair_flux(pair_fields<PRIM>(sl, k), pair_fields<PRIM>(sr, k), k, f);
}

// The two interfaces of the thread's cell along axis A:
// D += w_lo F(ia-1 | ia) - w_hi F(ia | ia+1).
template <int DIM, int EXT, int A, bool PRIM, bool MINMOD, bool POS>
__device__ __forceinline__ void axis_update(
    const float* __restrict__ u, const Sides& sides, const float* __restrict__ w,
    const int idx[3], int c, const Site& st, float surface, float interior_ok,
    const Consts& k, float D[5], float& spd) {
  using Fr = Frame<A>;
  constexpr int stride = ipow(EXT, DIM - 1 - A);
  const int ia = idx[A];
  const int c0 = c - ia * stride;
  int t = 0;  // cell index within the side slab
#pragma unroll
  for (int b = 0; b < DIM; ++b)
    if (b != A) t = t * EXT + idx[b];
  const float w_hi = __ldg(w + (1 + 2 * A) * st.Es + st.e);
  const float w_lo = __ldg(w + (2 + 2 * A) * st.Es + st.e);
  const float eq_hi = w_hi > 0.0f ? 1.0f : 0.0f;
  const float eq_lo = w_lo > 0.0f ? 1.0f : 0.0f;

#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // h = 0: the -A face, h = 1: the +A face
    const int p = ia - 1 + h;
    float f[5];
    const float sp = interface_flux<DIM, EXT, A, PRIM, MINMOD, POS>(
        p, u, sides, c0, t, st, eq_hi, eq_lo, k, f);
    float wgt;
    if (h == 0) {
      wgt = ia == 0 ? w_lo : surface;
      if (ia == 0) spd = fmaxf(spd, sp * eq_lo);
    } else {
      wgt = ia == EXT - 1 ? w_hi : surface;
      spd = fmaxf(spd, sp * (ia == EXT - 1 ? eq_hi : interior_ok));
    }
    // frame rows back to x, y, z rows, weighted
    float fw[5];
    fw[0] = f[0] * wgt;
    fw[1 + Fr::n] = f[1] * wgt;
    fw[1 + Fr::t1] = f[2] * wgt;
    fw[1 + Fr::t2] = f[3] * wgt;
    fw[4] = f[4] * wgt;
    if (h == 0) {
#pragma unroll
      for (int r = 0; r < 5; ++r) D[r] = D[r] + fw[r];
    } else {
#pragma unroll
      for (int r = 0; r < 5; ++r) D[r] = D[r] - fw[r];
    }
  }
}

template <int DIM, int EXT, bool PRIM, bool MINMOD, bool POS>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    fused_muscl_kernel(const float* __restrict__ u, const float* __restrict__ w,
                       Sides sides, float* __restrict__ D_out,
                       unsigned int* __restrict__ speed, int E, Consts k) {
  constexpr int B = ipow(EXT, DIM);
  constexpr int T = B / EXT;
  static_assert(B % TILE_C == 0, "cells per block must divide the block");
  __shared__ float red[TILE_C][TILE_E];

  const int e = blockIdx.x * TILE_E + threadIdx.x;
  const int c = blockIdx.y * TILE_C + threadIdx.y;
  const bool live = e < E;
  float spd = 0.0f;
  if (live) {
    Site st;
    st.e = e;
    st.Es = E;
    st.rs = (long long)B * st.Es;
    st.ls = (long long)T * st.Es;
    int idx[3] = {0, 0, 0};
    int rem = c;
#pragma unroll
    for (int a = DIM - 1; a >= 0; --a) {
      idx[a] = rem % EXT;
      rem /= EXT;
    }
    const float surface = __ldg(w + e);
    const float interior_ok = surface > 0.0f ? 1.0f : 0.0f;
    float D[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    axis_update<DIM, EXT, 0, PRIM, MINMOD, POS>(u, sides, w, idx, c, st,
                                                 surface, interior_ok, k, D, spd);
    axis_update<DIM, EXT, 1, PRIM, MINMOD, POS>(u, sides, w, idx, c, st,
                                                 surface, interior_ok, k, D, spd);
    if constexpr (DIM == 3)
      axis_update<DIM, EXT, 2, PRIM, MINMOD, POS>(u, sides, w, idx, c, st,
                                                   surface, interior_ok, k, D, spd);
    const long long off = (long long)c * st.Es + e;
#pragma unroll
    for (int r = 0; r < 5; ++r) D_out[r * st.rs + off] = D[r];
  }

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

struct Launch {
  dim3 grid, block;
  cudaStream_t stream;
  const float* u;
  const float* w;
  Sides sides;
  float* D;
  unsigned int* speed;
  int E;
  Consts k;
};

template <int DIM, int EXT, bool PRIM, bool MINMOD, bool POS>
void launch(const Launch& l) {
  fused_muscl_kernel<DIM, EXT, PRIM, MINMOD, POS>
      <<<l.grid, l.block, 0, l.stream>>>(l.u, l.w, l.sides, l.D, l.speed, l.E, l.k);
}

template <int DIM, int EXT>
void dispatch(bool prim, bool minmod, bool pos, const Launch& l) {
  if (prim) {
    if (minmod)
      pos ? launch<DIM, EXT, true, true, true>(l) : launch<DIM, EXT, true, true, false>(l);
    else
      pos ? launch<DIM, EXT, true, false, true>(l) : launch<DIM, EXT, true, false, false>(l);
  } else {
    if (minmod)
      pos ? launch<DIM, EXT, false, true, true>(l) : launch<DIM, EXT, false, true, false>(l);
    else
      pos ? launch<DIM, EXT, false, false, true>(l) : launch<DIM, EXT, false, false, false>(l);
  }
}

}  // namespace

// Launch one MUSCL divergence on `stream`.  speed must be zero-filled [E]
// (uint32 bits of the float max).  prim / minmod / positivity are 0 or 1.
// Returns the cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int t8_fused_muscl(int device, int dim, int ext, int E, int prim,
                              int minmod, int positivity, const float* u,
                              const float* w, const float* o0, const float* o1,
                              const float* o2, const float* o3,
                              const float* o4, const float* o5, float* D,
                              unsigned int* speed, double gamma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const int B = ext == 8 ? (dim == 3 ? 512 : 64) : (dim == 3 ? 64 : 16);
  Launch l;
  l.block = dim3(TILE_E, TILE_C);
  l.grid = dim3((E + TILE_E - 1) / TILE_E, B / TILE_C);
  l.stream = static_cast<cudaStream_t>(stream);
  l.u = u;
  l.w = w;
  l.sides = {{o0, o1, o2, o3, o4, o5}};
  l.D = D;
  l.speed = speed;
  l.E = E;
  l.k = {(float)gamma,
         (float)(gamma - 1.0),
         (float)(gamma * 0.5),
         (float)(gamma / (2.0 * (gamma - 1.0))),
         (float)(1.0 / (gamma - 1.0)),
         (float)(0.5 / gamma),
         (float)((gamma - 1.0) / gamma)};
  const bool pr = prim != 0, mm = minmod != 0, pos = positivity != 0;
  if (dim == 3 && ext == 8)
    dispatch<3, 8>(pr, mm, pos, l);
  else if (dim == 3 && ext == 4)
    dispatch<3, 4>(pr, mm, pos, l);
  else if (dim == 2 && ext == 8)
    dispatch<2, 8>(pr, mm, pos, l);
  else if (dim == 2 && ext == 4)
    dispatch<2, 4>(pr, mm, pos, l);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
