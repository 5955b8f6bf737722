// The pencil walk shared by the two MUSCL kernels (fused_muscl.cu,
// fused_mhd_muscl.cu): an element tile staged once in shared memory, one
// walk per pencil and axis that evaluates every interface of the pencil
// once, and the divergence and speed epilogue.  The physics comes in as a
// policy P:
//
//   P::R                       state rows (5 Euler, 9 GLM-MHD)
//   P::Params                  its constants
//   P::convert(r, k)           a cell's unrotated rows into the
//                              reconstruction space (prim_rows, or none)
//   P::Face                    what the flux needs of one reconstruction
//   P::face(rec, base, k)      the positivity guard on frame rows (keep
//                              base where rec is not admissible), then
//                              the Face of the result
//   P::flux(L, R, aux, k, f)   interface flux in frame rows from the two
//                              reconstructions' Faces; returns its wave
//                              speed.  aux is weight row 7 (c_h for
//                              GLM-MHD)
//
// Per element, cell i of a pencil along axis a and frame row r:
//
//   s_i  = lim(x_i - x_{i-1}, x_{i+1} - x_i)     (block edges masked by eq)
//   uL_i = guard(x_i + s_i/2, x_i),  uR_i = guard(x_i - s_i/2, x_i)
//   F(i-1|i) = P::flux(uL_{i-1}, uR_i)
//   D_i  = (D_i + w(i-1|i) F(i-1|i)) - w(i|i+1) F(i|i+1),  axis 0 first
//
// Positions -2, -1 are the lo neighbour's second and facing layer, EXT and
// EXT+1 the hi neighbour's facing and second layer (the side slabs).  The
// neighbours' reconstructions toward the element, uL_{-1} and uR_{EXT},
// take no eq mask and come from the same four layers the neighbour sees
// itself, so a mesh face's flux is the same from both of its elements.
// The operation order per row is that of the plain version
// (ops/kernels._muscl_divergence): built with --fmad=false and IEEE
// division, the kernels can be bit-identical to it.
//
// Layout (element-minor, as in the JAX package): u and D [R, EXT^DIM, E];
// w [8, E] (row 0 interior face area, rows 1+k side k's equal-level face
// weight, whose sign is the slope mask eq); side slab k [2R, EXT^(DIM-1),
// E], rows 0..R-1 the facing layer, R..2R-1 the second, side k = 2a + (0
// for +a, 1 for -a), tangent axes in increasing order; speed [E] (float
// bits).
//
// A block (Block<TE, SPLIT, MIN_BLOCKS>) owns TE elements (threadIdx.x)
// and SPLIT pencil slots per tangent index (threadIdx.y; T = EXT^(DIM-1)
// tangent indices, each pencil walked in SPLIT segments).  Shared memory
// holds the staged states and the partial divergence between axes, each
// [R][cells][TE] with one pad cell after every EXT cells (so that the
// slots of a warp hit distinct banks on every axis), and [SLOTS][TE]
// floats for the speed reduction.

#pragma once

#include <cuda_runtime.h>

namespace t8pencil {

__host__ __device__ constexpr int ipow(int b, int n) {
  return n == 0 ? 1 : b * ipow(b, n - 1);
}

// Stored row of frame row i in the +A face frame: the normal component is
// A, the tangents the other two axes in increasing order, for the momentum
// (rows 1-3) and the magnetic field (rows 5-7) alike.
__host__ __device__ constexpr int frame_row(int A, int i) {
  return (i == 1 || i == 5)   ? i + A
         : (i == 2 || i == 6) ? i - 1 + (A == 0 ? 1 : 0)
         : (i == 3 || i == 7) ? i - 2 + (A == 2 ? 1 : 2)
                              : i;
}

// torch.minimum / torch.maximum: NaN where either operand is NaN (fminf
// and fmaxf would drop it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

template <bool MINMOD>
__device__ __forceinline__ float limit(float a, float b) {
  if (MINMOD) return (a * b > 0.0f) ? copysignf(fminf(fabsf(a), fabsf(b)), a) : 0.0f;
  return 0.5f * (a + b);
}

struct Args {
  const float* u;
  const float* w;
  const float* sides[6];
  float* D;
  unsigned int* speed;
  int E;
};

// How a block is cut: TE elements, SPLIT segments per pencil, and the
// blocks per SM the compiler keeps registers for (__launch_bounds__).
template <int TE_, int SPLIT_, int MIN_BLOCKS_>
struct Block {
  static constexpr int TE = TE_, SPLIT = SPLIT_, MIN_BLOCKS = MIN_BLOCKS_;
};

// Tile geometry of a block: TE elements of EXT^DIM cells, each pencil
// walked in SPLIT segments of EXT / SPLIT cells by as many threads.
template <int R, int DIM, int EXT, class Blk>
struct Tile {
  static constexpr int TE = Blk::TE, SPLIT = Blk::SPLIT;
  static_assert(EXT % SPLIT == 0, "segments must divide the pencil");
  static constexpr int B = ipow(EXT, DIM);  // cells per element
  static constexpr int T = B / EXT;         // pencils per element and axis
  static constexpr int BP = B + B / EXT;    // cell slots with the padding
  static constexpr int SLOTS = T * SPLIT;   // threadIdx.y
  static constexpr int THREADS = TE * SLOTS;
  static constexpr int TILE = R * BP * TE;  // floats of one [R][BP][TE] tile
  static constexpr size_t SMEM = (2 * (size_t)TILE + SLOTS * TE) * sizeof(float);
  __device__ static int at(int r, int c, int x) {
    return (r * BP + c + c / EXT) * TE + x;
  }
};

// One side-slab layer (0 facing, 1 second) of the pencil, converted and
// rotated into the +A frame.
template <class P, int A>
__device__ __forceinline__ void side_state(const float* __restrict__ base,
                                           int layer, long long ls,
                                           const typename P::Params& k,
                                           float s[P::R]) {
  float r[P::R];
#pragma unroll
  for (int i = 0; i < P::R; ++i) r[i] = __ldg(base + (layer * P::R + i) * ls);
  P::convert(r, k);
#pragma unroll
  for (int i = 0; i < P::R; ++i) s[i] = r[frame_row(A, i)];
}

// Walk segment seg of the pencil of tangent index t along axis A for
// element slot x: cells [seg L, (seg + 1) L), L = EXT / SPLIT, each
// interface of theirs once (the one between two segments in both, the
// same bits), D of each cell once (the tile sd, or D itself on the last
// axis), the masked interface speeds into spd.
template <class P, int DIM, int EXT, class Blk, bool MINMOD, int A>
__device__ __forceinline__ void walk(const float* su, float* sd,
                                     const Args& g, int x, int e, int t,
                                     int seg, const typename P::Params& k,
                                     float& spd) {
  using Tl = Tile<P::R, DIM, EXT, Blk>;
  using Face = typename P::Face;
  constexpr int R = P::R;
  constexpr int L = EXT / Blk::SPLIT;
  constexpr int TE = Blk::TE;
  constexpr int stride = ipow(EXT, DIM - 1 - A);  // cell stride along A
  // slot stride along A in the padded tiles: c + c / EXT grows by it
  // (stride / EXT is 0 on the last axis, whose pencils lie within one
  // group of EXT cells)
  constexpr int pstride = stride + stride / EXT;
  constexpr int RS = Tl::BP * TE;  // row stride of a tile
  constexpr bool FIRST = A == 0, LAST = A == DIM - 1;
  const long long Es = g.E;

  int c0 = 0;  // the pencil's cell at position 0
  {
    int rem = t;
#pragma unroll
    for (int b = DIM - 1; b >= 0; --b) {
      if (b == A) continue;
      c0 += (rem % EXT) * ipow(EXT, DIM - 1 - b);
      rem /= EXT;
    }
  }
  const float surface = __ldg(g.w + e);
  const float w_hi = __ldg(g.w + (1 + 2 * A) * Es + e);
  const float w_lo = __ldg(g.w + (2 + 2 * A) * Es + e);
  const float aux = __ldg(g.w + 7 * Es + e);
  const float eq_hi = w_hi > 0.0f ? 1.0f : 0.0f;
  const float eq_lo = w_lo > 0.0f ? 1.0f : 0.0f;
  const float interior_ok = surface > 0.0f ? 1.0f : 0.0f;
  const long long ls = (long long)Tl::T * Es;  // row stride of a side slab
  const float* hi = g.sides[2 * A] + (long long)t * Es + e;
  const float* lo = g.sides[2 * A + 1] + (long long)t * Es + e;

  // the pencil's position 0 in the tiles and in D
  const int at0 = Tl::at(0, c0, x);
  const float* pu = su + at0;
  float* pd = sd + at0;
  float* gd = g.D + (long long)c0 * Es + e;
  const long long gr = (long long)Tl::B * Es;  // row stride of D

  // the state at position q in [-2, EXT+1], rotated into the +A frame
  auto state = [&](int q, float s[R]) {
    if (q >= 0 && q < EXT) {
      const float* p = pu + q * pstride * TE;
#pragma unroll
      for (int i = 0; i < R; ++i) s[i] = p[frame_row(A, i) * RS];
    } else if (q >= EXT) {
      side_state<P, A>(hi, q - EXT, ls, k, s);
    } else {
      side_state<P, A>(lo, -1 - q, ls, k, s);
    }
  };

  const int qs = seg * L - 1, qe = qs + L + 1;  // uL of qs .. uR of qe

  float xm[R], x0[R], xp[R];  // positions q-1, q, q+1
  Face ul;                    // uL of position q-1
  float fl[R];                // weighted flux of the lo face of cell q-1
  state(qs - 1, xm);
  state(qs, x0);

#pragma unroll 1
  for (int q = qs; q <= qe; ++q) {
    const bool update = q - 1 > qs;  // both faces of cell q-1 known here
    float* du = pd + (q - 1) * pstride * TE;           // cell q-1 in sd
    float* dg = gd + (long long)((q - 1) * stride) * Es;  // and in D
    float dold[R];                   // D of cell q-1 from the earlier axes
    if (!FIRST && update) {
#pragma unroll
      for (int r = 0; r < R; ++r) dold[r] = du[r * RS];
    }
    state(q + 1, xp);
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float dl = x0[i] - xm[i];
      if (q == 0) dl = dl * eq_lo;
      float dh = xp[i] - x0[i];
      if (q == EXT - 1) dh = dh * eq_hi;
      s[i] = limit<MINMOD>(dl, dh);
    }
    if (q > qs) {
      float ur[R], f[R], fw[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ur[i] = x0[i] - 0.5f * s[i];
      const float sp = P::flux(ul, P::face(ur, x0, k), aux, k, f);  // q-1 | q
      const float wgt = q == 0 ? w_lo : (q == EXT ? w_hi : surface);
      spd = nan_max(spd, sp * (q == 0 ? eq_lo : (q == EXT ? eq_hi : interior_ok)));
#pragma unroll
      for (int i = 0; i < R; ++i) fw[frame_row(A, i)] = f[i] * wgt;
      if (update) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d = ((FIRST ? 0.0f : dold[r]) + fl[r]) - fw[r];
          if (LAST)
            dg[r * gr] = d;
          else
            du[r * RS] = d;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) fl[r] = fw[r];
    }
    if (q < qe) {
      float uq[R];
#pragma unroll
      for (int i = 0; i < R; ++i) uq[i] = x0[i] + 0.5f * s[i];
      ul = P::face(uq, x0, k);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      xm[i] = x0[i];
      x0[i] = xp[i];
    }
  }
}

// The MUSCL divergence of TE elements per block: stage, walk axis 0, 1
// (and 2), then the per-element speed max.  Launch with blockDim (TE,
// Tile::SLOTS) and Tile::SMEM bytes of dynamic shared memory.
template <class P, int DIM, int EXT, class Blk, bool MINMOD>
__global__ void __launch_bounds__(Tile<P::R, DIM, EXT, Blk>::THREADS, Blk::MIN_BLOCKS)
    muscl_kernel(Args g, typename P::Params k) {
  using Tl = Tile<P::R, DIM, EXT, Blk>;
  constexpr int R = P::R, TE = Blk::TE;
  extern __shared__ float smem[];
  float* su = smem;                   // staged states
  float* sd = su + Tl::TILE;          // partial divergence
  float* red = sd + Tl::TILE;         // [SLOTS][TE] speeds

  const int x = threadIdx.x, y = threadIdx.y;
  const int t = y % Tl::T, seg = y / Tl::T;  // pencil and its segment
  const int e0 = blockIdx.x * TE;
  const int e = e0 + x;
  const bool live = e < g.E;
  const long long Es = g.E;

  // stage: each cell read once, converted once, elements fastest; all of
  // a thread's loads issued before its first store
  constexpr int ITERS = (Tl::B * TE + Tl::THREADS - 1) / Tl::THREADS;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int j = it * Tl::THREADS + y * TE + x;
    const int cx = j % TE, c = j / TE;
    const int ee = e0 + cx;
    if (j < Tl::B * TE && ee < g.E) {
      float r[R];
#pragma unroll
      for (int i = 0; i < R; ++i) r[i] = __ldg(g.u + (i * (long long)Tl::B + c) * Es + ee);
      P::convert(r, k);
#pragma unroll
      for (int i = 0; i < R; ++i) su[Tl::at(i, c, cx)] = r[i];
    }
  }
  __syncthreads();

  float spd = 0.0f;
  if (live) walk<P, DIM, EXT, Blk, MINMOD, 0>(su, sd, g, x, e, t, seg, k, spd);
  __syncthreads();
  if (live) walk<P, DIM, EXT, Blk, MINMOD, 1>(su, sd, g, x, e, t, seg, k, spd);
  if constexpr (DIM == 3) {
    __syncthreads();
    if (live) walk<P, DIM, EXT, Blk, MINMOD, 2>(su, sd, g, x, e, t, seg, k, spd);
  }

  // per-element max over the block's pencil segments.  The block owns its
  // elements, so one plain store each: order-free, bit-reproducible.  A
  // NaN speed propagates, as in the plain version.
  red[y * TE + x] = spd;
  __syncthreads();
  if (y == 0 && live) {
    float m = red[x];
    for (int j = 1; j < Tl::SLOTS; ++j) m = nan_max(m, red[j * TE + x]);
    m = (m > 0.0f || m != m) ? m : 0.0f;  // +0 for zero and -0
    g.speed[e] = __float_as_uint(m);
  }
}

// Launch one instantiation on device `device`'s `stream`: raises the
// dynamic shared-memory limit on the first launch there.  Returns the
// cudaError_t (0 on success).
template <class P, int DIM, int EXT, class Blk, bool MINMOD>
int launch(int device, const Args& g, const typename P::Params& k,
           cudaStream_t stream) {
  using Tl = Tile<P::R, DIM, EXT, Blk>;
  constexpr int TE = Blk::TE;
  auto kern = muscl_kernel<P, DIM, EXT, Blk, MINMOD>;
  static bool raised[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  const dim3 block(TE, Tl::SLOTS), grid((g.E + TE - 1) / TE);
  kern<<<grid, block, Tl::SMEM, stream>>>(g, k);
  return (int)cudaGetLastError();
}

// Registers, spilled bytes per thread, threads and shared memory per block
// of one instantiation, into out[0..3].
template <class P, int DIM, int EXT, class Blk, bool MINMOD>
int attributes(int out[4]) {
  using Tl = Tile<P::R, DIM, EXT, Blk>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, muscl_kernel<P, DIM, EXT, Blk, MINMOD>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = Tl::THREADS;
  out[3] = (int)(a.sharedSizeBytes + Tl::SMEM);
  return 0;
}

}  // namespace t8pencil
