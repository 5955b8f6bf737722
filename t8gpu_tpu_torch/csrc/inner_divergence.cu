// The interior faces' flux divergence of a subgrid block state, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel inner_divergence_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:1425, body _kernel :1394) for flux
// "kepes": per element e and cell c of its [EXT]^DIM block, EXT in 2, 4, 8,
// 16,
//   D(c)  = sum over axes a of  s F(c-1 -> c) - s F(c -> c+1)
// over the faces inside the block only (the mesh faces and walls are the
// caller's: ops/subgrid.outer_apply, boundary_apply), s the element's
// interior face area (given per element, ops/kernels.interior_surface, 0
// on dead slots), and the max wave speed over all interior faces of the
// live elements, one scalar.  F is the state-form entropy-stable KEPES
// flux (kepes_es_flux of t8gpu_tpu_torch/ops/euler.py, the same arithmetic
// in the same order): per face two logarithmic means with one log each and
// the entropy variables of both states with two logs each, evaluated per
// face as the TPU kernel does.
//
// Layout (element-minor): u and D are [5, EXT^DIM, E]; surface [E]; speed
// one uint32 (float bits).
//
// Bound on this card: at Subgrid<16,16,16> with E 576 (512 live) the kernel
// moves ~94 MB (u 47.2 read, D 47.2 written): 28 us at 3.35 TB/s; its
// arithmetic, ~290 operations per interface with 6 logs and 8 divides over
// 6.6M interfaces (1.9 GFLOP), takes ~29 us at the 67 TFLOP/s fp32 peak.
// The two bounds meet; this simple kernel, which evaluates every interior
// face twice (once from each cell), is held by the operations.
//
// Design: one thread per (element, cell), elements fastest across
// threadIdx.x (a warp's load of one cell row is one coalesced line, a
// neighbour cell at a fixed stride of E floats).  Each thread evaluates the
// faces on both sides of its cell along every axis; both threads of a face
// compute it from the same two states with the same code (--fmad=false),
// so the divergence telescopes exactly.  A block of 32 elements x up to 8
// cells reduces its speed in shared memory and adds it by one atomicMax on
// non-negative float bits: order-free, so the scalar is bit-reproducible.

#include "euler_kepes.cuh"

namespace {

// ln_mean of ops/euler.py: the stable logarithmic mean.
__device__ __forceinline__ float ln_mean(float a_l, float a_r) {
  const float xi = a_r / a_l;
  const float u = (xi * (xi - 2.0f) + 1.0f) / (xi * (xi + 2.0f) + 1.0f);
  const bool near = u < 1.0e-4f;
  const float series = (a_l + a_r) * 52.5f / series_den(u);
  const float exact = (a_r - a_l) / logf(near ? 2.0f : xi);
  return near ? series : exact;
}

// Entropy variables of a face-frame state (_entropy_variables).
__device__ __forceinline__ void entropy_variables(const float s[5],
                                                  const Consts& k,
                                                  float v[5]) {
  const float s_rho = 1.0f / s[0];
  const float v0 = s[1] * s_rho, v1 = s[2] * s_rho, v2 = s[3] * s_rho;
  const float kinetic = 0.5f * (s[1] * v0 + s[2] * v1 + s[3] * v2);
  const float p = k.km1 * (s[4] - kinetic);
  const float ent = logf(p) - k.gamma * logf(s[0]);
  const float rho_p = s[0] / p;
  v[0] = (k.gamma - ent) / k.km1 - 0.5f * rho_p * (v0 * v0 + v1 * v1 + v2 * v2);
  v[1] = rho_p * v0;
  v[2] = rho_p * v1;
  v[3] = rho_p * v2;
  v[4] = -rho_p;
}

// kepes_es_flux of face-frame states L, R (row 1 the normal momentum):
// the face-frame flux f and the wave speed |u_hat| + a_hat.
__device__ __forceinline__ float kepes_es_flux(const float L[5],
                                               const float R[5],
                                               const Consts& k, float f[5]) {
  // kepes_flux: the central part
  const float s_rho_l = 1.0f / L[0];
  const float vl0 = L[1] * s_rho_l, vl1 = L[2] * s_rho_l, vl2 = L[3] * s_rho_l;
  const float s_rho_r = 1.0f / R[0];
  const float vr0 = R[1] * s_rho_r, vr1 = R[2] * s_rho_r, vr2 = R[3] * s_rho_r;
  const float vel2s2_l = 0.5f * (vl0 * vl0 + vl1 * vl1 + vl2 * vl2);
  const float vel2s2_r = 0.5f * (vr0 * vr0 + vr1 * vr1 + vr2 * vr2);
  const float p_l = k.km1 * (L[4] - L[0] * vel2s2_l);
  const float p_r = k.km1 * (R[4] - R[0] * vel2s2_r);
  const float beta_l = 0.5f * L[0] / p_l;
  const float beta_r = 0.5f * R[0] / p_r;
  const float rho_mean = 0.5f * (L[0] + R[0]);
  const float rho_hat = ln_mean(L[0], R[0]);
  const float beta_mean = 0.5f * (beta_l + beta_r);
  const float beta_hat = ln_mean(beta_l, beta_r);
  const float uh = 0.5f * (vl0 + vr0);
  const float vh = 0.5f * (vl1 + vr1);
  const float wh = 0.5f * (vl2 + vr2);
  const float ah = sqrtf(k.half_gamma * (p_l + p_r) / rho_hat);
  const float hh = k.gamma / (k.two_km1 * beta_hat) +
                   0.5f * (vl0 * vr0 + vl1 * vr1 + vl2 * vr2);
  const float p1h = 0.5f * rho_mean / beta_mean;
  const float vel2_m = vel2s2_l + vel2s2_r;
  const float f0 = rho_hat * uh;
  const float f1 = f0 * uh + p1h;
  const float f2 = f0 * vh;
  const float f3 = f0 * wh;
  const float f4 = f0 * 0.5f * (1.0f / (k.km1 * beta_hat) - vel2_m) + uh * f1 +
                   vh * f2 + wh * f3;

  // the dissipation R diag(D) R^T [[v]]
  const float d0 = 0.5f * fabsf(uh - ah) * rho_hat / k.gamma;
  const float d1 = fabsf(uh) * k.km1_over_g * rho_hat;
  const float d2 = fabsf(uh) * p1h;
  const float d3 = d2;
  const float d4 = 0.5f * fabsf(uh + ah) * rho_hat / k.gamma;
  float el[5], er[5], dv[5];
  entropy_variables(L, k, el);
  entropy_variables(R, k, er);
#pragma unroll
  for (int r = 0; r < 5; ++r) dv[r] = er[r] - el[r];
  const float ek = 0.5f * (uh * uh + vh * vh + wh * wh);
  const float w0 = dv[0] + (uh - ah) * dv[1] + vh * dv[2] + wh * dv[3] +
                   (hh - uh * ah) * dv[4];
  const float w1 = dv[0] + uh * dv[1] + vh * dv[2] + wh * dv[3] + ek * dv[4];
  const float w2 = dv[2] + vh * dv[4];
  const float w3 = dv[3] + wh * dv[4];
  const float w4 = dv[0] + (uh + ah) * dv[1] + vh * dv[2] + wh * dv[3] +
                   (hh + uh * ah) * dv[4];
  const float g0 = d0 * w0, g1 = d1 * w1, g2 = d2 * w2, g3 = d3 * w3,
              g4 = d4 * w4;
  const float diss0 = g0 + g1 + g4;
  const float diss1 = (uh - ah) * g0 + uh * g1 + (uh + ah) * g4;
  const float diss2 = vh * g0 + vh * g1 + g2 + vh * g4;
  const float diss3 = wh * g0 + wh * g1 + g3 + wh * g4;
  const float diss4 = (hh - uh * ah) * g0 + ek * g1 + vh * g2 + wh * g3 +
                      (hh + uh * ah) * g4;
  f[0] = f0 - 0.5f * diss0;
  f[1] = f1 - 0.5f * diss1;
  f[2] = f2 - 0.5f * diss2;
  f[3] = f3 - 0.5f * diss3;
  f[4] = f4 - 0.5f * diss4;
  return fabsf(uh) + ah;
}

// The state of one cell in the +A face frame.
template <int A>
__device__ __forceinline__ void load_rotated(const float* __restrict__ u,
                                             long long rs, long long off,
                                             float s[5]) {
  using Fr = Frame<A>;
  s[0] = __ldg(u + off);
  s[1] = __ldg(u + off + (1 + Fr::n) * rs);
  s[2] = __ldg(u + off + (1 + Fr::t1) * rs);
  s[3] = __ldg(u + off + (1 + Fr::t2) * rs);
  s[4] = __ldg(u + off + 4 * rs);
}

// The face flux between the cells at offsets lo and hi along +A, back in
// x, y, z rows and times the face area; returns the face's wave speed.
template <int A>
__device__ __forceinline__ float face(const float* __restrict__ u,
                                      long long rs, long long lo,
                                      long long hi, float surface,
                                      const Consts& k, float out[5]) {
  using Fr = Frame<A>;
  float L[5], R[5], f[5];
  load_rotated<A>(u, rs, lo, L);
  load_rotated<A>(u, rs, hi, R);
  const float sp = kepes_es_flux(L, R, k, f);
  out[0] = f[0] * surface;
  out[1 + Fr::n] = f[1] * surface;
  out[1 + Fr::t1] = f[2] * surface;
  out[1 + Fr::t2] = f[3] * surface;
  out[4] = f[4] * surface;
  return sp;
}

// Cell c's two faces along axis A, where they lie inside the block:
// D = (D + s F(lo)) - s F(hi), as the zero-padded shifts of the TPU kernel.
template <int DIM, int EXT, int A>
__device__ __forceinline__ void axis_inner(const float* __restrict__ u,
                                           const int idx[3], long long off,
                                           long long Es, long long rs,
                                           float surface, const Consts& k,
                                           float D[5], float& spd) {
  constexpr long long stride = ipow(EXT, DIM - 1 - A);
  const int ia = idx[A];
  float flo[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float fhi[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (ia < EXT - 1)
    spd = fmaxf(spd, face<A>(u, rs, off, off + stride * Es, surface, k, fhi));
  if (ia > 0) face<A>(u, rs, off - stride * Es, off, surface, k, flo);
#pragma unroll
  for (int r = 0; r < 5; ++r) D[r] = (D[r] + flo[r]) - fhi[r];
}

template <int DIM, int EXT>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    inner_divergence_kernel(const float* __restrict__ u,
                            const float* __restrict__ surf,
                            float* __restrict__ D_out,
                            unsigned int* __restrict__ speed, int E,
                            Consts k) {
  constexpr int B = ipow(EXT, DIM);
  constexpr int TC = B < TILE_C ? B : TILE_C;  // cells per block
  static_assert(B % TC == 0, "cells per block must divide the block");
  __shared__ float red[TC * TILE_E];

  const int e = blockIdx.x * TILE_E + threadIdx.x;
  const int c = blockIdx.y * TC + threadIdx.y;
  float spd = 0.0f;
  if (e < E) {
    const long long Es = E;
    const long long rs = (long long)B * Es;
    const long long off = (long long)c * Es + e;
    int idx[3] = {0, 0, 0};
    int rem = c;
#pragma unroll
    for (int a = DIM - 1; a >= 0; --a) {
      idx[a] = rem % EXT;
      rem /= EXT;
    }
    const float surface = __ldg(surf + e);
    float D[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    axis_inner<DIM, EXT, 0>(u, idx, off, Es, rs, surface, k, D, spd);
    axis_inner<DIM, EXT, 1>(u, idx, off, Es, rs, surface, k, D, spd);
    if constexpr (DIM == 3)
      axis_inner<DIM, EXT, 2>(u, idx, off, Es, rs, surface, k, D, spd);
#pragma unroll
    for (int r = 0; r < 5; ++r) D_out[r * rs + off] = D[r];
    spd = surface > 0.0f ? spd : 0.0f;  // live elements only
  }
  const int tid = threadIdx.y * TILE_E + threadIdx.x;
  red[tid] = spd;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int j = 1; j < TC * TILE_E; ++j) m = fmaxf(m, red[j]);
    m = m > 0.0f ? m : 0.0f;  // +0 for zero and NaN: the bits order as floats
    atomicMax(speed, __float_as_uint(m));
  }
}

template <int DIM, int EXT>
int launch(cudaStream_t s, const float* u, const float* surf, float* D,
           unsigned int* speed, int E, const Consts& k) {
  constexpr int B = ipow(EXT, DIM);
  constexpr int TC = B < TILE_C ? B : TILE_C;
  const dim3 block(TILE_E, TC);
  const dim3 grid((E + TILE_E - 1) / TILE_E, B / TC);
  inner_divergence_kernel<DIM, EXT><<<grid, block, 0, s>>>(u, surf, D, speed,
                                                          E, k);
  return (int)cudaGetLastError();
}

template <int DIM>
int launch_ext(int ext, cudaStream_t s, const float* u, const float* surf,
               float* D, unsigned int* speed, int E, const Consts& k) {
  switch (ext) {
    case 2: return launch<DIM, 2>(s, u, surf, D, speed, E, k);
    case 4: return launch<DIM, 4>(s, u, surf, D, speed, E, k);
    case 8: return launch<DIM, 8>(s, u, surf, D, speed, E, k);
    case 16: return launch<DIM, 16>(s, u, surf, D, speed, E, k);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch the interior divergence on `stream`.  speed must be one zero-filled
// uint32 (the float bits of the max).  Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
extern "C" int t8_inner_divergence(int device, int dim, int ext, int E,
                                   const float* u, const float* surface,
                                   float* D, unsigned int* speed,
                                   double gamma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(gamma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) return launch_ext<3>(ext, s, u, surface, D, speed, E, k);
  if (dim == 2) return launch_ext<2>(ext, s, u, surface, D, speed, E, k);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
