// First-order GLM-MHD flux divergence of the subgrid scheme, fused into
// one kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mhd_flux_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:365, body _fused_mhd_kernel :351 and
// _tile_mhd_divergence :279).  Per element E and cell c of its [EXT]^DIM
// block, and per axis a:
//
//   F(i|i+1) = Rusanov + exact GLM flux (mhd_rusanov.cuh) from the rotated
//              states of cells i and i+1, with the cleaning speed c_h
//   D(c)    += w(c-1|c) F(c-1|c) - w(c|c+1) F(c|c+1)
//   speed    = per-element max signal speed over the masked interfaces
//
// At the block edge the other state is the side layer (the equal-level
// neighbour's facing layer, or on a wall side the conductor ghost of the
// element's own layer, built by the caller), so interior faces, mesh faces
// and walls take one code path.  Interior faces carry w[0]; the +a face of
// the last cell w[1+2a], the -a face of cell 0 w[2+2a]; w[7] holds c_h in
// every element (a device scalar the caller broadcasts: no host sync).
//
// Layout (element-minor, as in the JAX package): u and D are
// [9, EXT^DIM, E]; w is [8, E]; side layer k is [9, EXT^(DIM-1), E], side
// k = 2a + (0 for +a, 1 for -a), tangent axes in increasing order; speed is
// [E] (float bits).
//
// Bound on this card: at the Orszag-Tang shape (DIM 2, EXT 8, E 22143:
// 16384 elements and their capacity padding) one launch must read u
// (51.0 MB), four side layers (25.5 MB) and the weights, and write D
// (51.0 MB): ~128 MB, 38 us at 3.35 TB/s.  The necessary arithmetic (one
// Rusanov flux, ~210 operations with four sqrt and five divides, per
// interface, 3.2M interfaces) is ~0.7 GFLOP, 10 us at the fp32 peak, so
// the bytes bound it.
//
// Design (the simple version that is right first, as the Euler kernels):
// one thread per (element, cell), elements fastest across threadIdx.x, so
// a warp's load of one cell row is one coalesced 128-byte line and all
// threads of a warp share one cell (no divergence at the block edges).
// Each thread loads its own state once per axis and evaluates its two
// interfaces from it and the state on either side, so every interior
// interface is evaluated twice, by the same code on the same inputs.  The
// ragged element edge is masked, not padded; the per-element speed max is
// one atomicMax on float bits.

#include <cuda_runtime.h>

#include "mhd_rusanov.cuh"

namespace {

using namespace t8mhd;

// The two interfaces of the thread's cell along axis A:
// D += w_lo F(ia-1 | ia) - w_hi F(ia | ia+1).
template <int DIM, int EXT, int A>
__device__ __forceinline__ void axis_update(
    const float* __restrict__ u, const Sides& sides, const float* __restrict__ w,
    const int idx[3], int c, const Site& st, float surface, float interior_ok,
    float ch, const Consts& k, float D[ROWS], float& spd) {
  constexpr int stride = ipow(EXT, DIM - 1 - A);  // cell stride along A
  const int ia = idx[A];
  const long long toff =
      (long long)tangent_index<DIM, EXT, A>(idx) * st.Es + st.e;
  const float w_hi = __ldg(w + (1 + 2 * A) * st.Es + st.e);
  const float w_lo = __ldg(w + (2 + 2 * A) * st.Es + st.e);
  const float eq_hi = w_hi > 0.0f ? 1.0f : 0.0f;
  const float eq_lo = w_lo > 0.0f ? 1.0f : 0.0f;

  float me[ROWS];
  load9<A>(u, st.rs, (long long)c * st.Es + st.e, me);

#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // h = 0: the -A face, h = 1: the +A face
    float nb[ROWS];
    if (h == 0) {
      if (ia == 0)
        load9<A>(sides.p[2 * A + 1], st.ls, toff, nb);
      else
        load9<A>(u, st.rs, (long long)(c - stride) * st.Es + st.e, nb);
    } else {
      if (ia == EXT - 1)
        load9<A>(sides.p[2 * A], st.ls, toff, nb);
      else
        load9<A>(u, st.rs, (long long)(c + stride) * st.Es + st.e, nb);
    }
    float l[ROWS], r[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      l[i] = h == 0 ? nb[i] : me[i];
      r[i] = h == 0 ? me[i] : nb[i];
    }
    float f[ROWS];
    const float sp = rusanov(l, r, ch, k, f);
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

template <int DIM, int EXT>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    fused_mhd_flux_kernel(const float* __restrict__ u,
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
    axis_update<DIM, EXT, 0>(u, sides, w, idx, c, st, surface, interior_ok,
                             ch, k, D, spd);
    axis_update<DIM, EXT, 1>(u, sides, w, idx, c, st, surface, interior_ok,
                             ch, k, D, spd);
    if constexpr (DIM == 3)
      axis_update<DIM, EXT, 2>(u, sides, w, idx, c, st, surface, interior_ok,
                               ch, k, D, spd);
    const long long off = (long long)c * st.Es + e;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) D_out[i * st.rs + off] = D[i];
  }
  element_speed_max(spd, live, e, speed);
}

template <int DIM, int EXT>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* u,
            const float* w, Sides sides, float* D, unsigned int* speed, int E,
            Consts k) {
  fused_mhd_flux_kernel<DIM, EXT><<<grid, block, 0, stream>>>(u, w, sides, D,
                                                             speed, E, k);
}

}  // namespace

// Launch one MHD flux divergence on `stream`.  speed must be zero-filled [E]
// (uint32 bits of the float max).  Returns the cudaError_t of the launch
// (0 on success); never synchronizes.
extern "C" int t8_fused_mhd_flux(int device, int dim, int ext, int E,
                                 const float* u, const float* w,
                                 const float* o0, const float* o1,
                                 const float* o2, const float* o3,
                                 const float* o4, const float* o5, float* D,
                                 unsigned int* speed, double gamma,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const int B = ext == 8 ? (dim == 3 ? 512 : 64) : (dim == 3 ? 64 : 16);
  const dim3 block(TILE_E, TILE_C);
  const dim3 grid((E + TILE_E - 1) / TILE_E, B / TILE_C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sides sides = {{o0, o1, o2, o3, o4, o5}};
  const Consts k = make_consts(gamma);
  if (dim == 3 && ext == 8)
    launch<3, 8>(grid, block, s, u, w, sides, D, speed, E, k);
  else if (dim == 3 && ext == 4)
    launch<3, 4>(grid, block, s, u, w, sides, D, speed, E, k);
  else if (dim == 2 && ext == 8)
    launch<2, 8>(grid, block, s, u, w, sides, D, speed, E, k);
  else if (dim == 2 && ext == 4)
    launch<2, 4>(grid, block, s, u, w, sides, D, speed, E, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
