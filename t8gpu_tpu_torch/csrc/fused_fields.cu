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
// it: twice the state's bytes come in as field rows, the price of taking
// the field derivation out of the kernel.
//
// Design: one thread per (element, cell), elements fastest across
// threadIdx.x (a warp's load of one cell row is one coalesced 128-byte
// line, a neighbour cell along any axis at a fixed stride of E floats);
// the fields are ten loads per cell; every interface is evaluated by both
// of its cells, bit-identically (--fmad=false), so the divergence
// telescopes exactly.  The ragged element edge is masked; the speed is a
// shared-memory max and one atomicMax on non-negative float bits per
// element and block (order-free, bit-reproducible).

#include "euler_kepes.cuh"

namespace {

constexpr int TILE_E = 32;  // elements per block (threadIdx.x)
constexpr int TILE_C = 8;   // cells per block (threadIdx.y)

__host__ __device__ constexpr int ipow(int b, int n) {
  return n == 0 ? 1 : b * ipow(b, n - 1);
}

struct Sides {
  const float* p[6];
};

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
