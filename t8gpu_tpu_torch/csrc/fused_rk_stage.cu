// One SSP-RK stage of the subgrid compressible-Euler scheme, fused into one
// kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_rk_stage_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:1190, body _fused_rk_kernel :1100 and
// _tile_flux_divergence :97) for flux "kepes", 5-row state inputs or 7-row
// ones with log rho and log p in rows 5-6 (the "logs" stage input), no
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
// Layout (element-minor, as in the JAX package): u is [5 or 7, EXT^DIM, E],
// u_prev and out [5, EXT^DIM, E]; w is [8, E]; side layer k is [5 or 7,
// EXT^(DIM-1), E] with the tangent axes in increasing order; speed is [E]
// (float bits).  With 7 rows (LOGS) the two logs of every cell's fields
// are loaded, not computed: the state rows are read as before and the
// side layers carry the neighbours' log rows too (ops/subgrid.
// append_log_rows, _state_side_layers).
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
// ~7x the necessary arithmetic and is compute-bound, not byte-bound (the
// LOGS input takes the 7 repeats of the two logs out of it, for 40% more
// bytes read).
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
// ulp.  The interface flux and the block divergence are in euler_kepes.cuh,
// shared with the field-input kernels (fused_fields.cu).

#include "euler_kepes.cuh"

namespace {

// The kepes fields of one cell from its state (cell_fields_tuple of
// ops/euler.py); with LOGS, log rho and log p are rows 5 and 6.
template <bool LOGS>
struct StateLoad {
  Consts k;
  __device__ __forceinline__ Fields operator()(const float* __restrict__ base,
                                               long long row_stride,
                                               long long off) const {
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
    if constexpr (LOGS) {
      q.lrho = __ldg(base + off + 5 * row_stride);
      q.lp = __ldg(base + off + 6 * row_stride);
    } else {
      q.lrho = logf(rho);
      q.lp = logf(q.p);
    }
    const float s = q.lp - k.gamma * q.lrho;
    q.vent0 = (k.gamma - s) / k.km1 - q.rhop * q.ke;
    return q;
  }
};

template <int DIM, int EXT, bool SHARE_PREV, bool LOGS>
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
    const long long rs = (long long)B * Es;  // row stride of a block tensor
    const long long ls = (long long)T * Es;  // row stride of a side layer
    const long long off = (long long)c * Es + e;
    float D[5];
    tile_divergence<DIM, EXT>(u, sides, w, c, e, Es, rs, ls, k,
                              StateLoad<LOGS>{k}, D, spd);

    const float cdt = cc * __ldg(w + 7 * Es + e);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float ur = __ldg(u + r * rs + off);
      const float upr = SHARE_PREV ? ur : __ldg(up + r * rs + off);
      out[r * rs + off] = (ca * upr + cb * ur) + cdt * D[r];
    }
  }
  element_speed_max(red, spd, live, speed, e);
}

template <int DIM, int EXT, bool LOGS>
void launch(bool share_prev, dim3 grid, dim3 block, cudaStream_t stream,
            const float* u, const float* up, const float* w, const Sides& sides,
            float* out, unsigned int* speed, int E, const Consts& k, float ca,
            float cb, float cc) {
  if (share_prev)
    fused_rk_stage_kernel<DIM, EXT, true, LOGS><<<grid, block, 0, stream>>>(
        u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else
    fused_rk_stage_kernel<DIM, EXT, false, LOGS><<<grid, block, 0, stream>>>(
        u, up, w, sides, out, speed, E, k, ca, cb, cc);
}

template <bool LOGS>
int launch_shape(int dim, int ext, bool share_prev, dim3 grid, dim3 block,
                 cudaStream_t s, const float* u, const float* up,
                 const float* w, const Sides& sides, float* out,
                 unsigned int* speed, int E, const Consts& k, float ca,
                 float cb, float cc) {
  if (dim == 3 && ext == 8)
    launch<3, 8, LOGS>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 3 && ext == 4)
    launch<3, 4, LOGS>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 2 && ext == 8)
    launch<2, 8, LOGS>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else if (dim == 2 && ext == 4)
    launch<2, 4, LOGS>(share_prev, grid, block, s, u, up, w, sides, out, speed, E, k, ca, cb, cc);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one stage on `stream`.  up == nullptr means u_prev == the state
// rows of u (stage 1); logs != 0 means u and the side layers have 7 rows.
// speed must be zero-filled [E] (uint32 bits of the float max).  Returns
// the cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int t8_fused_rk_stage(int device, int dim, int ext, int E, int logs,
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
  const Consts k = make_consts(gamma);
  const Sides sides = {{o0, o1, o2, o3, o4, o5}};
  const bool share_prev = up == nullptr;
  const dim3 block(TILE_E, TILE_C);
  const dim3 grid((E + TILE_E - 1) / TILE_E, block_cells(dim, ext) / TILE_C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return logs ? launch_shape<true>(dim, ext, share_prev, grid, block, s, u, up,
                                   w, sides, out, speed, E, k, ca, cb, cc)
              : launch_shape<false>(dim, ext, share_prev, grid, block, s, u,
                                    up, w, sides, out, speed, E, k, ca, cb, cc);
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
