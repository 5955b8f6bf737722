// The first-order Euler flux divergence from precomputed cell fields, and
// the SSP-RK stage built on it, for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of t8gpu_tpu/ops/pallas_kernels.py, for flux
// "kepes" and no hanging-face extras:
//   * fused_flux_pallas (:193, body _fused_kernel :170) with RK = false:
//       D(c)  = sum over axes a of  w_lo(c,a) F(c-1 -> c) - w_hi(c,a) F(c -> c+1)
//       speed = per-element max wave speed over the masked interfaces;
//   * fused_rk_stage_fields_pallas (:1329, body _fused_rk_fields_kernel
//     :1282) with RK = true: the same D, the stage state u recovered from
//     the cell's fields (_recover_state_rows :1268: m = rho v, e = p/(gamma
//     - 1) + rho ke) and out(c) = ca * u_prev(c) + cb * u(c) + cc * w[7] *
//     D(c), with u_prev = u when it is not given (stage 1).
// F is the KEPES flux on the fields (euler_kepes.cuh): the fields are read,
// not derived, so the kernel has no log and no per-cell divide; the caller
// computes them once per cell and stage (ops/euler.cell_fields_tuple) and
// gathers the side layers of field rows (ops/subgrid.pallas_side_inputs;
// a wall side carries the mirrored own layer, so walls need no code here).
//
// Layout (element-minor): q is [10, EXT^DIM, E] (kepes rows rho, v_x, v_y,
// v_z, p, rho/p, log rho, log p, vent0, ke); u_prev and out [5, EXT^DIM,
// E]; w [8, E] (row 0 the interior face area, rows 1 + k side k's face
// weight, row 7 dt / V_cell for RK); side layer k [10, EXT^(DIM-1), E];
// speed [E] (float bits).
//
// Bound on this card: at the flagship shape (DIM 3, EXT 8, E 4374) the
// divergence moves ~202 MB (q 89.6, side layers 67.2, D 44.8) and the
// stage ~246 MB (u_prev 44.8 more; ~202 MB at stage 1): 60 and 74 us at
// 3.35 TB/s; ~200 flops per interface and no transcendental but a sqrt and
// a rsqrt put the arithmetic at a fraction of that.  So the bytes bound
// it: twice the state's bytes come in as field rows, which is what removing
// the repeated field derivation of fused_rk_stage.cu costs.
//
// Design: the one-thread-per-cell kernel of fused_rk_stage.cu with the
// field derivation replaced by ten loads per cell (a warp's load of one
// row is one coalesced line); every interface is still evaluated by both
// of its cells, bit-identically (--fmad=false), so the divergence
// telescopes exactly.  The ragged element edge is masked; the speed is a
// shared-memory max and one atomicMax on non-negative float bits per
// element and block (order-free, bit-reproducible).

#include "euler_kepes.cuh"

namespace {

// The kepes fields of one cell, read from ten field rows.
struct FieldLoad {
  __device__ __forceinline__ Fields operator()(const float* __restrict__ base,
                                               long long rs,
                                               long long off) const {
    Fields q;
    q.rho = __ldg(base + off);
    q.v[0] = __ldg(base + off + rs);
    q.v[1] = __ldg(base + off + 2 * rs);
    q.v[2] = __ldg(base + off + 3 * rs);
    q.p = __ldg(base + off + 4 * rs);
    q.rhop = __ldg(base + off + 5 * rs);
    q.lrho = __ldg(base + off + 6 * rs);
    q.lp = __ldg(base + off + 7 * rs);
    q.vent0 = __ldg(base + off + 8 * rs);
    q.ke = __ldg(base + off + 9 * rs);
    return q;
  }
};

template <int DIM, int EXT, bool RK, bool SHARE_PREV>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    fused_fields_kernel(const float* __restrict__ q,
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
    const long long rs = (long long)B * Es;  // row stride of a block tensor
    const long long ls = (long long)T * Es;  // row stride of a side layer
    const long long off = (long long)c * Es + e;
    float D[5];
    const Fields f = tile_divergence<DIM, EXT>(q, sides, w, c, e, Es, rs, ls,
                                               k, FieldLoad{}, D, spd);
    if constexpr (RK) {
      const float rho = f.rho;
      const float u[5] = {rho, rho * f.v[0], rho * f.v[1], rho * f.v[2],
                          f.p * k.inv_km1 + rho * f.ke};
      const float cdt = cc * __ldg(w + 7 * Es + e);
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const float upr = SHARE_PREV ? u[r] : __ldg(up + r * rs + off);
        out[r * rs + off] = (ca * upr + cb * u[r]) + cdt * D[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < 5; ++r) out[r * rs + off] = D[r];
    }
  }
  element_speed_max(red, spd, live, speed, e);
}

template <int DIM, int EXT>
void launch(bool rk, bool share_prev, dim3 grid, dim3 block, cudaStream_t s,
            const float* q, const float* up, const float* w,
            const Sides& sides, float* out, unsigned int* speed, int E,
            const Consts& k, float ca, float cb, float cc) {
  if (!rk)
    fused_fields_kernel<DIM, EXT, false, false><<<grid, block, 0, s>>>(
        q, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (share_prev)
    fused_fields_kernel<DIM, EXT, true, true><<<grid, block, 0, s>>>(
        q, up, w, sides, out, speed, E, k, ca, cb, cc);
  else
    fused_fields_kernel<DIM, EXT, true, false><<<grid, block, 0, s>>>(
        q, up, w, sides, out, speed, E, k, ca, cb, cc);
}

}  // namespace

// Launch the divergence (rk == 0: out is D [5, ...]) or one stage (rk != 0:
// out is u_next; up == nullptr means u_prev == the recovered state) on
// `stream`.  speed must be zero-filled [E].  Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
extern "C" int t8_fused_fields(int device, int dim, int ext, int E, int rk,
                               const float* q, const float* up,
                               const float* w, const float* o0,
                               const float* o1, const float* o2,
                               const float* o3, const float* o4,
                               const float* o5, float* out,
                               unsigned int* speed, double gamma, float ca,
                               float cb, float cc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(gamma);
  const Sides sides = {{o0, o1, o2, o3, o4, o5}};
  const bool share_prev = up == nullptr;
  const dim3 block(TILE_E, TILE_C);
  const dim3 grid((E + TILE_E - 1) / TILE_E, block_cells(dim, ext) / TILE_C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3 && ext == 8)
    launch<3, 8>(rk, share_prev, grid, block, s, q, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 3 && ext == 4)
    launch<3, 4>(rk, share_prev, grid, block, s, q, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 2 && ext == 8)
    launch<2, 8>(rk, share_prev, grid, block, s, q, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 2 && ext == 4)
    launch<2, 4>(rk, share_prev, grid, block, s, q, up, w, sides, out, speed, E, k, ca, cb, cc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
