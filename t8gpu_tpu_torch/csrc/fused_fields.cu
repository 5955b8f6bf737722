// The first-order Euler flux divergence from precomputed cell fields, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_flux_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:193, body _fused_kernel :170) for flux
// "kepes" and no hanging-face extras:
//   D(c)  = sum over axes a of  w_lo(c,a) F(c-1 -> c) - w_hi(c,a) F(c -> c+1)
//   speed = per-element max wave speed over the masked interfaces.
// F is the KEPES flux on the fields (euler_kepes.cuh): the fields are read,
// not derived, so the kernel has no log and no per-cell divide; the caller
// computes them once per cell (ops/euler.cell_fields_tuple) and gathers
// the side layers of field rows (ops/subgrid.pallas_side_inputs; a wall
// side carries the mirrored own layer, so walls need no code here).  The
// stage kernel on the same field rows (fused_rk_stage_fields_pallas) is
// fused_rk_stage.cu's fused_rk_stage_fields_kernel.
//
// Layout (element-minor): q is [10, EXT^DIM, E] (kepes rows rho, v_x, v_y,
// v_z, p, rho/p, log rho, log p, vent0, ke); D [5, EXT^DIM, E]; w [8, E]
// (row 0 the interior face area, rows 1 + k side k's face weight); side
// layer k [10, EXT^(DIM-1), E]; speed [E] (float bits).
//
// Bound on this card: at the flagship shape (DIM 3, EXT 8, E 4374) the
// divergence moves ~202 MB (q 89.6, side layers 67.2, D 44.8): 60 us at
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
// w[1 + k]) and the cell's max interface speed.
template <int DIM, int EXT, class Load>
__device__ __forceinline__ void tile_divergence(
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

template <int DIM, int EXT>
__global__ void __launch_bounds__(TILE_E* TILE_C)
    fused_fields_kernel(const float* __restrict__ q,
                        const float* __restrict__ w, Sides sides,
                        float* __restrict__ out,
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
    const long long Es = E;
    const long long rs = (long long)B * Es;  // row stride of a block tensor
    const long long ls = (long long)T * Es;  // row stride of a side layer
    const long long off = (long long)c * Es + e;
    float D[5];
    tile_divergence<DIM, EXT>(q, sides, w, c, e, Es, rs, ls, k, FieldLoad{}, D,
                              spd);
#pragma unroll
    for (int r = 0; r < 5; ++r) out[r * rs + off] = D[r];
  }
  element_speed_max(red, spd, live, speed, e);
}

template <int DIM, int EXT>
void launch(dim3 grid, dim3 block, cudaStream_t s, const float* q,
            const float* w, const Sides& sides, float* out,
            unsigned int* speed, int E, const Consts& k) {
  fused_fields_kernel<DIM, EXT><<<grid, block, 0, s>>>(q, w, sides, out, speed,
                                                      E, k);
}

}  // namespace

// Launch the divergence (out is D [5, ...]) on `stream`.  speed must be
// zero-filled [E].  Returns the cudaError_t of the launch (0 on success);
// never synchronizes.
extern "C" int t8_fused_fields(int device, int dim, int ext, int E,
                               const float* q, const float* w,
                               const float* o0, const float* o1,
                               const float* o2, const float* o3,
                               const float* o4, const float* o5, float* out,
                               unsigned int* speed, double gamma,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(gamma);
  const Sides sides = {{o0, o1, o2, o3, o4, o5}};
  const dim3 block(TILE_E, TILE_C);
  const dim3 grid((E + TILE_E - 1) / TILE_E, block_cells(dim, ext) / TILE_C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3 && ext == 8)
    launch<3, 8>(grid, block, s, q, w, sides, out, speed, E, k);
  else if (dim == 3 && ext == 4)
    launch<3, 4>(grid, block, s, q, w, sides, out, speed, E, k);
  else if (dim == 2 && ext == 8)
    launch<2, 8>(grid, block, s, q, w, sides, out, speed, E, k);
  else if (dim == 2 && ext == 4)
    launch<2, 4>(grid, block, s, q, w, sides, out, speed, E, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
