// Second-order (MUSCL) GLM-MHD flux divergence of the subgrid scheme,
// fused into one kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mhd_muscl_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:777, body _fused_mhd_muscl_kernel :761
// and _tile_mhd_muscl_divergence :617).  Per element E and cell c of its
// [EXT]^DIM block, and per axis a, on the 9 rows rotated into the +a frame:
//
//   slope_i = lim(u_i - u_{i-1}, u_{i+1} - u_i)      (lim: minmod or central)
//   u_L(i)  = guard(u_i + slope_i / 2, u_i),  u_R(i) = guard(u_i - slope_i / 2, u_i)
//   F(i|i+1) = Rusanov + exact GLM flux (mhd_rusanov.cuh) from u_L(i) to
//              u_R(i+1), with the cleaning speed c_h = w[7]
//   D(c)   += w(c-1|c) F(c-1|c) - w(c|c+1) F(c|c+1)
//   speed   = per-element max signal speed over the masked interfaces
//
// The guard keeps the cell's own state where the reconstruction has
// rho <= 0 or THERMAL pressure p <= 0 (the magnetic pressure excluded).  At
// the block edge the outward difference reads the equal-level neighbour's
// facing layer (rows 0-8 of the side slab) and is multiplied by
// eq = (w[1+k] > 0), so walls, dead and hanging sides get a one-sided
// slope (zero for minmod, half for central); their fluxes are the caller's
// first-order closure.  The neighbour's reconstruction toward us is built
// from the same four layers it sees itself (its facing and second layer,
// rows 9-17, and our edge layer), so both elements evaluate the identical
// mesh-face flux and conservation is exact.
//
// Layout (element-minor, as in the JAX package): u and D are
// [9, EXT^DIM, E]; w is [8, E]; side slab k is [18, EXT^(DIM-1), E], side
// k = 2a + (0 for +a, 1 for -a), tangent axes in increasing order; speed is
// [E] (float bits).
//
// Bound on this card: at the Orszag-Tang shape (DIM 2, EXT 8, E 22143:
// 16384 elements and their capacity padding) one launch must read u
// (51.0 MB), four side slabs (51.0 MB) and the weights, and write D
// (51.0 MB): ~154 MB, 46 us at 3.35 TB/s.  The necessary arithmetic (per
// cell and axis the slopes, reconstructions and guards, ~160 operations;
// per interface one Rusanov flux, ~210) is ~1.2 GFLOP, 17 us at the fp32
// peak: the bytes bound it.
//
// Design (the simple version that is right first, as fused_muscl.cu): one
// thread per (element, cell), elements fastest across threadIdx.x.  Each
// thread evaluates its own two interfaces per axis, each from the four
// states around it (re-read through L1/L2), so every interior interface is
// evaluated twice, by the same code on the same inputs.  An interface holds
// 4 states x 9 rows and two reconstructions; a non-unrolled loop over a
// thread's two faces keeps one copy of that body per axis.  The ragged
// element edge is masked, not padded; the per-element speed max is one
// atomicMax on float bits.

#include <cuda_runtime.h>

#include "mhd_rusanov.cuh"

namespace {

using namespace t8mhd;

template <bool MINMOD>
__device__ __forceinline__ float limit(float a, float b) {
  if (MINMOD) return (a * b > 0.0f) ? copysignf(fminf(fabsf(a), fabsf(b)), a) : 0.0f;
  return 0.5f * (a + b);
}

// rec = guard(rec, base): keep base where rec has rho <= 0 or thermal
// p <= 0 (rows in the face frame; the sums are over the frame's rows, as
// in the JAX kernel).
template <bool POS>
__device__ __forceinline__ void guard(float rec[ROWS], const float base[ROWS],
                                      const Consts& k) {
  if (!POS) return;
  const float s_rho = 1.0f / rec[0];
  const float ke = 0.5f * ((rec[1] * rec[1] + rec[2] * rec[2]) + rec[3] * rec[3]) * s_rho;
  const float b2s = (rec[5] * rec[5] + rec[6] * rec[6]) + rec[7] * rec[7];
  const float p = k.km1 * ((rec[4] - ke) - 0.5f * b2s);
  const bool ok = (rec[0] > 0.0f) & (p > 0.0f);
  if (!ok) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) rec[i] = base[i];
  }
}

// The state at position q in [-2, EXT+1] along axis A on the thread's line:
// block cells 0..EXT-1, then the hi side's facing (EXT) and second (EXT+1)
// layer, the lo side's facing (-1) and second (-2) layer.
template <int DIM, int EXT, int A>
__device__ __forceinline__ void fetch(int q, const float* __restrict__ u,
                                      const Sides& sides, int c0,
                                      long long toff, const Site& st,
                                      float s[ROWS]) {
  constexpr int stride = ipow(EXT, DIM - 1 - A);  // cell stride along A
  if (q >= 0 && q < EXT)
    load9<A>(u, st.rs, (long long)(c0 + q * stride) * st.Es + st.e, s);
  else if (q >= EXT)
    load9<A>(sides.p[2 * A] + (q - EXT) * ROWS * st.ls, st.ls, toff, s);
  else
    load9<A>(sides.p[2 * A + 1] + (-1 - q) * ROWS * st.ls, st.ls, toff, s);
}

// The flux across the interface between positions p and p+1 along axis A,
// p in [-1, EXT-1], in frame rows; returns its signal speed.
template <int DIM, int EXT, int A, bool MINMOD, bool POS>
__device__ __forceinline__ float interface_flux(
    int p, const float* __restrict__ u, const Sides& sides, int c0,
    long long toff, const Site& st, float eq_hi, float eq_lo, float ch,
    const Consts& k, float f[ROWS]) {
  float x0[ROWS], x1[ROWS], x2[ROWS], x3[ROWS];  // positions p-1, p, p+1, p+2
  fetch<DIM, EXT, A>(p - 1, u, sides, c0, toff, st, x0);
  fetch<DIM, EXT, A>(p, u, sides, c0, toff, st, x1);
  fetch<DIM, EXT, A>(p + 1, u, sides, c0, toff, st, x2);
  fetch<DIM, EXT, A>(p + 2, u, sides, c0, toff, st, x3);

  float sl[ROWS], sr[ROWS];
  if (p == -1) {
    // lo neighbour's facing cell, from its second layer, facing layer and
    // our cell 0: s = lim(l0 - l1, m - l0), lo_sub = l0 + s/2
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      sl[i] = x1[i] + 0.5f * limit<MINMOD>(x1[i] - x0[i], x2[i] - x1[i]);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
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
    for (int i = 0; i < ROWS; ++i)
      sr[i] = x2[i] - 0.5f * limit<MINMOD>(x2[i] - x1[i], x3[i] - x2[i]);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float dl = x2[i] - x1[i];
      if (p + 1 == 0) dl = dl * eq_lo;
      float dh = x3[i] - x2[i];
      if (p + 1 == EXT - 1) dh = dh * eq_hi;
      sr[i] = x2[i] - 0.5f * limit<MINMOD>(dl, dh);
    }
  }
  guard<POS>(sl, x1, k);
  guard<POS>(sr, x2, k);
  return rusanov(sl, sr, ch, k, f);
}

// The two interfaces of the thread's cell along axis A:
// D += w_lo F(ia-1 | ia) - w_hi F(ia | ia+1).
template <int DIM, int EXT, int A, bool MINMOD, bool POS>
__device__ __forceinline__ void axis_update(
    const float* __restrict__ u, const Sides& sides, const float* __restrict__ w,
    const int idx[3], int c, const Site& st, float surface, float interior_ok,
    float ch, const Consts& k, float D[ROWS], float& spd) {
  constexpr int stride = ipow(EXT, DIM - 1 - A);
  const int ia = idx[A];
  const int c0 = c - ia * stride;
  const long long toff =
      (long long)tangent_index<DIM, EXT, A>(idx) * st.Es + st.e;
  const float w_hi = __ldg(w + (1 + 2 * A) * st.Es + st.e);
  const float w_lo = __ldg(w + (2 + 2 * A) * st.Es + st.e);
  const float eq_hi = w_hi > 0.0f ? 1.0f : 0.0f;
  const float eq_lo = w_lo > 0.0f ? 1.0f : 0.0f;

#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // h = 0: the -A face, h = 1: the +A face
    float f[ROWS];
    const float sp = interface_flux<DIM, EXT, A, MINMOD, POS>(
        ia - 1 + h, u, sides, c0, toff, st, eq_hi, eq_lo, ch, k, f);
    float wgt;
    if (h == 0) {
      wgt = ia == 0 ? w_lo : surface;
      if (ia == 0) spd = fmaxf(spd, sp * eq_lo);
    } else {
      wgt = ia == EXT - 1 ? w_hi : surface;
      spd = fmaxf(spd, sp * (ia == EXT - 1 ? eq_hi : interior_ok));
    }
    float fw[ROWS];
    unrotate9<A>(f, wgt, fw);
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) D[i] = D[i] + fw[i];
    } else {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) D[i] = D[i] - fw[i];
    }
  }
}

template <int DIM, int EXT, bool MINMOD, bool POS>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    fused_mhd_muscl_kernel(const float* __restrict__ u,
                           const float* __restrict__ w, Sides sides,
                           float* __restrict__ D_out,
                           unsigned int* __restrict__ speed, int E, Consts k) {
  constexpr int B = ipow(EXT, DIM);
  constexpr int T = B / EXT;
  static_assert(B % TILE_C == 0, "cells per block must divide the block");

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
    int idx[3];
    cell_coords<DIM, EXT>(c, idx);
    const float surface = __ldg(w + e);
    const float interior_ok = surface > 0.0f ? 1.0f : 0.0f;
    const float ch = __ldg(w + 7 * st.Es + e);
    float D[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) D[i] = 0.0f;
    axis_update<DIM, EXT, 0, MINMOD, POS>(u, sides, w, idx, c, st, surface,
                                          interior_ok, ch, k, D, spd);
    axis_update<DIM, EXT, 1, MINMOD, POS>(u, sides, w, idx, c, st, surface,
                                          interior_ok, ch, k, D, spd);
    if constexpr (DIM == 3)
      axis_update<DIM, EXT, 2, MINMOD, POS>(u, sides, w, idx, c, st, surface,
                                            interior_ok, ch, k, D, spd);
    const long long off = (long long)c * st.Es + e;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) D_out[i * st.rs + off] = D[i];
  }
  element_speed_max(spd, live, e, speed);
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

template <int DIM, int EXT, bool MINMOD, bool POS>
void launch(const Launch& l) {
  fused_mhd_muscl_kernel<DIM, EXT, MINMOD, POS>
      <<<l.grid, l.block, 0, l.stream>>>(l.u, l.w, l.sides, l.D, l.speed, l.E, l.k);
}

template <int DIM, int EXT>
void dispatch(bool minmod, bool pos, const Launch& l) {
  if (minmod)
    pos ? launch<DIM, EXT, true, true>(l) : launch<DIM, EXT, true, false>(l);
  else
    pos ? launch<DIM, EXT, false, true>(l) : launch<DIM, EXT, false, false>(l);
}

}  // namespace

// Launch one MHD MUSCL divergence on `stream`.  speed must be zero-filled
// [E] (uint32 bits of the float max).  minmod / positivity are 0 or 1.
// Returns the cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int t8_fused_mhd_muscl(int device, int dim, int ext, int E,
                                  int minmod, int positivity, const float* u,
                                  const float* w, const float* o0,
                                  const float* o1, const float* o2,
                                  const float* o3, const float* o4,
                                  const float* o5, float* D,
                                  unsigned int* speed, double gamma,
                                  void* stream) {
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
  l.k = make_consts(gamma);
  const bool mm = minmod != 0, pos = positivity != 0;
  if (dim == 3 && ext == 8)
    dispatch<3, 8>(mm, pos, l);
  else if (dim == 3 && ext == 4)
    dispatch<3, 4>(mm, pos, l);
  else if (dim == 2 && ext == 8)
    dispatch<2, 8>(mm, pos, l);
  else if (dim == 2 && ext == 4)
    dispatch<2, 4>(mm, pos, l);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
