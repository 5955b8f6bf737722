// One SSP-RK stage of the subgrid compressible-Euler scheme, fused into one
// kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_rk_stage_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:1190, body _fused_rk_kernel :1100 and
// _tile_flux_divergence :97) for flux "kepes", 5-row state inputs, no
// hanging-face extras, mu = 0 and no gravity.  It computes, per element E
// and cell c of its [EXT]^DIM block:
//
//   D(c)   = sum over axes a of  w_lo(c,a) F(c-1 -> c) - w_hi(c,a) F(c -> c+1)
//   out(c) = ca * u_prev(c) + cb * u(c) + cc * w[7] * D(c)
//   speed  = per-element max wave speed over the masked interfaces
//
// where the interface flux F is the entropy-stable KEPES flux evaluated on
// per-cell fields (cell_fields_tuple / kepes_fields_flux of
// t8gpu_tpu/ops/euler.py, same arithmetic in the same order).  Interfaces
// inside the block carry weight w[0] (the cell face area); the +a face of
// the last cell reads the side layer others[2a] with weight w[1+2a], the -a
// face of cell 0 the side layer others[2a+1] with weight w[2+2a].
//
// Layout (element-minor, as in the JAX package): u, u_prev, out are
// [5, EXT^DIM, E]; w is [8, E]; side layer k is [5, EXT^(DIM-1), E] with the
// tangent axes in increasing order; speed is [E] (float bits).
//
// Bound on this card: the stage moves ~123 MB (stage 1, one state read) or
// ~168 MB (stages 2-3) at the flagship shape (DIM 3, EXT 8, E 4374), 37-50
// us at 3.35 TB/s; its arithmetic (two logs, three divides per cell field,
// two divides, a sqrt and a rsqrt per interface, ~200 flops) is a few
// GFLOP, well under the fp32 peak.  So the bytes bound it, if it reads
// every input once.
//
// Design (the simple version that is right first): one thread per
// (element, cell), elements fastest across threadIdx.x, so a warp's load of
// one cell row is one coalesced 128-byte line and a neighbor cell along any
// axis sits at a fixed stride of E floats (L1/L2 serve the re-reads).  Each
// thread derives its own fields and those of its 2*DIM neighbors and
// evaluates its own 2*DIM interface fluxes, so every interior interface is
// evaluated twice and every cell's fields 2*DIM+1 times: the kernel does
// ~7x the necessary arithmetic and is compute-bound, not byte-bound.
// Staging a tile in shared memory so each flux is computed once is the next
// step.  The ragged element edge (E is not a multiple of 32) is masked, not
// padded.  The per-element speed max is a shared-memory max over the
// block's cells followed by one atomicMax on the float's bits per element
// and block: max does not depend on order, so the result is
// bit-reproducible.  No float atomics.
//
// Built without --use_fast_math and with --fmad=false: IEEE division and
// sqrt, no contraction, so the two threads that evaluate one interface get
// bit-identical fluxes (exact flux telescoping, as the single evaluation of
// the TPU kernel) and the kernel follows its plain PyTorch version to a few
// ulp.

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

// kepes cell fields: [rho, v, p, rho/p, log rho, log p, vent0, ke]
struct Fields {
  float rho, v[3], p, rhop, lrho, lp, vent0, ke;
};

__device__ __forceinline__ Fields cell_fields(const float* __restrict__ base,
                                              long long row_stride,
                                              long long off, const Consts& k) {
  const float rho = __ldg(base + off);
  const float m1 = __ldg(base + off + row_stride);
  const float m2 = __ldg(base + off + 2 * row_stride);
  const float m3 = __ldg(base + off + 3 * row_stride);
  const float e = __ldg(base + off + 4 * row_stride);
  Fields q;
  const float inv_rho = 1.0f / rho;
  q.rho = rho;
  q.v[0] = m1 * inv_rho;
  q.v[1] = m2 * inv_rho;
  q.v[2] = m3 * inv_rho;
  q.ke = 0.5f * (q.v[0] * q.v[0] + q.v[1] * q.v[1] + q.v[2] * q.v[2]);
  q.p = k.km1 * (e - rho * q.ke);
  q.rhop = rho / q.p;
  q.lrho = logf(rho);
  q.lp = logf(q.p);
  const float s = q.lp - k.gamma * q.lrho;
  q.vent0 = (k.gamma - s) / k.km1 - q.rhop * q.ke;
  return q;
}

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
template <int DIM, int EXT, int A>
__device__ __forceinline__ void axis_update(
    const float* __restrict__ u, const Sides& sides, const float* __restrict__ w,
    const Fields& q, const int idx[3], int c, int e, long long Es, long long rs,
    long long ls, float surface, float interior_ok, const Consts& k, float D[5],
    float& spd) {
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
    qn = cell_fields(u, rs, (long long)(c + stride) * Es + e, k);
    wgt = surface;
    ok = interior_ok;
  } else {
    qn = cell_fields(sides.p[2 * A], ls, (long long)t * Es + e, k);
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
    qp = cell_fields(u, rs, (long long)(c - stride) * Es + e, k);
    wgt = surface;
  } else {
    qp = cell_fields(sides.p[2 * A + 1], ls, (long long)t * Es + e, k);
    wgt = w_lo;
  }
  sp = kepes_flux<A>(qp, q, k, f);
  if (ia == 0) spd = fmaxf(spd, sp * (w_lo > 0.0f ? 1.0f : 0.0f));
#pragma unroll
  for (int r = 0; r < 5; ++r) D[r] = (D[r] + f[r] * wgt) - fhi[r];
}

template <int DIM, int EXT, bool SHARE_PREV>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    fused_rk_stage_kernel(const float* __restrict__ u,
                          const float* __restrict__ up,
                          const float* __restrict__ w, Sides sides,
                          float* __restrict__ out,
                          unsigned int* __restrict__ speed, int E, Consts k,
                          float ca, float cb, float cc) {
  constexpr int B = ipow(EXT, DIM);
  constexpr int T = B / EXT;
  static_assert(B % TILE_C == 0, "cells per block must divide the block");
  __shared__ float red[TILE_C][TILE_E];

  const int e = blockIdx.x * TILE_E + threadIdx.x;
  const int c = blockIdx.y * TILE_C + threadIdx.y;
  const bool live = e < E;
  float spd = 0.0f;
  if (live) {
    const long long Es = E;
    const long long rs = (long long)B * Es;  // row stride of a block state
    const long long ls = (long long)T * Es;  // row stride of a side layer
    const long long off = (long long)c * Es + e;
    int idx[3] = {0, 0, 0};
    int rem = c;
#pragma unroll
    for (int a = DIM - 1; a >= 0; --a) {
      idx[a] = rem % EXT;
      rem /= EXT;
    }
    const Fields q = cell_fields(u, rs, off, k);
    const float surface = __ldg(w + e);
    const float interior_ok = surface > 0.0f ? 1.0f : 0.0f;
    float D[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    axis_update<DIM, EXT, 0>(u, sides, w, q, idx, c, e, Es, rs, ls, surface,
                             interior_ok, k, D, spd);
    axis_update<DIM, EXT, 1>(u, sides, w, q, idx, c, e, Es, rs, ls, surface,
                             interior_ok, k, D, spd);
    if constexpr (DIM == 3)
      axis_update<DIM, EXT, 2>(u, sides, w, q, idx, c, e, Es, rs, ls, surface,
                               interior_ok, k, D, spd);

    const float cdt = cc * __ldg(w + 7 * Es + e);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float ur = __ldg(u + r * rs + off);
      const float upr = SHARE_PREV ? ur : __ldg(up + r * rs + off);
      out[r * rs + off] = (ca * upr + cb * ur) + cdt * D[r];
    }
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

template <int DIM, int EXT>
void launch(bool share_prev, dim3 grid, dim3 block, cudaStream_t stream,
            const float* u, const float* up, const float* w, const Sides& sides,
            float* out, unsigned int* speed, int E, const Consts& k, float ca,
            float cb, float cc) {
  if (share_prev)
    fused_rk_stage_kernel<DIM, EXT, true><<<grid, block, 0, stream>>>(
        u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else
    fused_rk_stage_kernel<DIM, EXT, false><<<grid, block, 0, stream>>>(
        u, up, w, sides, out, speed, E, k, ca, cb, cc);
}

}  // namespace

// Launch one stage on `stream`.  up == nullptr means u_prev == u (stage 1).
// speed must be zero-filled [E] (uint32 bits of the float max).  Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int t8_fused_rk_stage(int device, int dim, int ext, int E,
                                 const float* u, const float* up,
                                 const float* w, const float* o0,
                                 const float* o1, const float* o2,
                                 const float* o3, const float* o4,
                                 const float* o5, float* out,
                                 unsigned int* speed, double gamma, float ca,
                                 float cb, float cc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = {(float)gamma,
                    (float)(gamma - 1.0),
                    (float)(gamma * 0.5),
                    (float)(gamma / (2.0 * (gamma - 1.0))),
                    (float)(1.0 / (gamma - 1.0)),
                    (float)(0.5 / gamma),
                    (float)((gamma - 1.0) / gamma)};
  const Sides sides = {{o0, o1, o2, o3, o4, o5}};
  const bool share_prev = up == nullptr;
  const int B = ext == 8 ? (dim == 3 ? 512 : 64) : (dim == 3 ? 64 : 16);
  const dim3 block(TILE_E, TILE_C);
  const dim3 grid((E + TILE_E - 1) / TILE_E, B / TILE_C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3 && ext == 8)
    launch<3, 8>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 3 && ext == 4)
    launch<3, 4>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 2 && ext == 8)
    launch<2, 8>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 2 && ext == 4)
    launch<2, 4>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
