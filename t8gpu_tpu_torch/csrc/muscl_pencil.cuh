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
//
// The first-order kernels (fused_rk_stage.cu: the stage kernel on states
// and on cell fields; fused_mhd_flux.cu; inner_divergence.cu) take the
// sibling walk `walk1` over the same tile: no slopes, one neighbour cell
// beyond each end of a pencil, each interface F(i-1|i) once from the two
// cells' staged rows,
//
//   D_i  = (D_i + w(i-1|i) F(i-1|i)) - w(i|i+1) F(i|i+1),  axis 0 first,
//
// the operation order of the plain versions (ops/kernels.
// _first_order_divergence, inner_divergence_reference).  Their policy P:
//
//   P::RIN, P::RS, P::RD       rows of a cell in device memory, staged in
//                              shared memory, and of its divergence
//   P::convert(r, s, k)        a cell's RIN rows r into its RS staged rows
//   P::Cell, P::cell<A>(s, k)  what the flux of a +A face needs of a cell,
//                              from its staged rows s
//   P::flux<A>(L, R, aux, k, f)  the +A interface flux in x, y, z rows
//                              (RD of them); returns its wave speed.  aux
//                              is the element's weight row 7 (c_h for
//                              GLM-MHD)
//
// Their tile may be a slab of PL planes along axis 0 (PL < EXT: the stage
// and MHD kernels at 3D extent 8, the inner-only kernel at 3D extent 16),
// whose axis-0 pencils reach the planes beyond the slab in device memory.
// The kernels load their tiles with every load of a thread in flight at
// once (load_cells) and write their results in one pass over the tile
// (for_cells, elements fastest), D of the last axis too.  walk1_slab
// stages a slab and walks it for the kernels whose pencils end at side
// layers (the stage kernels and the MHD kernel).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace t8pencil {

// b^n; a loop, not a recursion, so that a call outside a constant
// expression (an index in an unrolled loop) inlines and folds.
__host__ __device__ constexpr int ipow(int b, int n) {
  int r = 1;
  for (int i = 0; i < n; ++i) r *= b;
  return r;
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

// Tile geometry of a block: TE elements, each a slab of PL planes along
// axis 0 (PL = EXT: the whole element), each pencil walked in SPLIT
// segments of EXT / SPLIT cells by as many threads; R staged rows and RD
// rows of divergence per cell.
template <int R, int DIM, int EXT, class Blk, int PL = EXT, int RD = R>
struct Tile {
  static constexpr int TE = Blk::TE, SPLIT = Blk::SPLIT;
  static_assert(EXT % SPLIT == 0, "segments must divide the pencil");
  static_assert(EXT % PL == 0, "slabs must divide the element");
  static constexpr int B = PL * ipow(EXT, DIM - 1);  // cells per element
  static constexpr int T = B / EXT;         // pencils per element, axes > 0
  static constexpr int BP = B + B / EXT;    // cell slots with the padding
  static constexpr int SLOTS = T * SPLIT;   // threadIdx.y
  static constexpr int THREADS = TE * SLOTS;
  static constexpr int TILE = R * BP * TE;   // floats of the staged tile
  static constexpr int DTILE = RD * BP * TE; // floats of the divergence tile
  static constexpr size_t SMEM = ((size_t)TILE + DTILE + SLOTS * TE) * sizeof(float);
  static_assert(SMEM <= 232448, "a block holds at most 227 KB");
  // float index of row r of cell c of element slot x in either tile
  __device__ static int at(int r, int c, int x) {
    return (r * BP + c + c / EXT) * TE + x;
  }
};

// The tile cell at position 0 of pencil t along axis A: t enumerates the
// other axes' indices, the last axis fastest (the tangent order of the
// side layers); axis 0 has PL planes in the tile.
template <int DIM, int EXT, int A, int PL = EXT>
__device__ __forceinline__ int pencil_start(int t) {
  int c0 = 0, rem = t;
#pragma unroll
  for (int b = DIM - 1; b >= 0; --b) {
    if (b == A) continue;
    const int n = b == 0 ? PL : EXT;
    c0 += (rem % n) * ipow(EXT, DIM - 1 - b);
    rem /= n;
  }
  return c0;
}

// Stage the tile's cells of elements e0 .. e0 + TE - 1 (those below E):
// load(c, ee, s) gives the Tl-tile rows s of cell c of element ee, each
// cell loaded once, elements fastest; all of a thread's loads issued
// before its first store.
template <class Tl, int RS, class Load>
__device__ __forceinline__ void stage_tile(float* st, int e0, int E,
                                           const Load& load) {
  constexpr int TE = Tl::TE, N = Tl::B * TE;
  constexpr int ITERS = (N + Tl::THREADS - 1) / Tl::THREADS;
  const int tid = threadIdx.y * TE + threadIdx.x;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int j = it * Tl::THREADS + tid;
    const int cx = j % TE, c = j / TE;
    const int ee = e0 + cx;
    if (j < N && ee < E) {
      float s[RS];
      load(c, ee, s);
#pragma unroll
      for (int i = 0; i < RS; ++i) st[Tl::at(i, c, cx)] = s[i];
    }
  }
}

// Call fn(c, ee, x) for every cell c < N of element slot x of the block
// (element ee = e0 + x, those below E), elements fastest across the
// block's threads.
template <class Tl, int N, class Fn>
__device__ __forceinline__ void for_cells(int e0, int E, const Fn& fn) {
  constexpr int TE = Tl::TE;
  for (int j = threadIdx.y * TE + threadIdx.x; j < N * TE; j += Tl::THREADS) {
    const int x = j % TE, c = j / TE;
    if (e0 + x < E) fn(c, e0 + x, x);
  }
}

// Every thread loads the R values of each of its items (cell c < N of
// element slot x, elements fastest, those below E) with load(c, ee, v),
// all of them before the first store(c, ee, x, v): all of a block's loads
// in flight together.
template <class Tl, int N, int R, class Load, class Store>
__device__ __forceinline__ void load_cells(int e0, int E, const Load& load,
                                           const Store& store) {
  constexpr int TE = Tl::TE;
  static_assert(N * TE % Tl::THREADS == 0, "whole rounds of the block");
  constexpr int IT = N * TE / Tl::THREADS;
  const int tid = threadIdx.y * TE + threadIdx.x;
  float v[IT][R];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int j = it * Tl::THREADS + tid, x = j % TE;
    if (e0 + x < E) load(j / TE, e0 + x, v[it]);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int j = it * Tl::THREADS + tid, x = j % TE;
    if (e0 + x < E) store(j / TE, e0 + x, x, v[it]);
  }
}

// Per-element max of the block's pencil slots' speeds spd into speed[e]:
// one plain store where the block owns its elements (ATOMIC false), else
// one atomicMax on the bits of the non-negative float into a zero-filled
// speed (an element's slabs in several blocks).  Either way order-free,
// bit-reproducible; a NaN speed propagates, as in the plain versions.
// Every thread of the block calls it.
template <class Tl, bool ATOMIC = false>
__device__ __forceinline__ void element_speed(float* red, float spd, bool live,
                                              unsigned int* speed, int e) {
  const int x = threadIdx.x, y = threadIdx.y;
  red[y * Tl::TE + x] = spd;
  __syncthreads();
  if (y == 0 && live) {
    float m = red[x];
    for (int j = 1; j < Tl::SLOTS; ++j) m = nan_max(m, red[j * Tl::TE + x]);
    m = (m > 0.0f || m != m) ? m : 0.0f;  // +0 for zero and -0
    if constexpr (ATOMIC)
      atomicMax(speed + e, __float_as_uint(m));
    else
      speed[e] = __float_as_uint(m);
  }
}

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

  const int c0 = pencil_start<DIM, EXT, A>(t);  // the pencil's position 0
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
  float* red = sd + Tl::DTILE;        // [SLOTS][TE] speeds

  const int x = threadIdx.x, y = threadIdx.y;
  const int t = y % Tl::T, seg = y / Tl::T;  // pencil and its segment
  const int e0 = blockIdx.x * TE;
  const int e = e0 + x;
  const bool live = e < g.E;
  const long long Es = g.E;

  // stage: each cell read once, converted once
  stage_tile<Tl, R>(su, e0, g.E, [&](int c, int ee, float r[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) r[i] = __ldg(g.u + (i * (long long)Tl::B + c) * Es + ee);
    P::convert(r, k);
  });
  __syncthreads();

  float spd = 0.0f;
  if (live) walk<P, DIM, EXT, Blk, MINMOD, 0>(su, sd, g, x, e, t, seg, k, spd);
  __syncthreads();
  if (live) walk<P, DIM, EXT, Blk, MINMOD, 1>(su, sd, g, x, e, t, seg, k, spd);
  if constexpr (DIM == 3) {
    __syncthreads();
    if (live) walk<P, DIM, EXT, Blk, MINMOD, 2>(su, sd, g, x, e, t, seg, k, spd);
  }

  element_speed<Tl>(red, spd, live, g.speed, e);
}

// Raise kern's dynamic shared-memory limit to smem bytes on `device`,
// once per device (raised: that kernel's flags).  Returns a cudaError_t.
inline int raise_smem(const void* kern, size_t smem, int device,
                      bool raised[64]) {
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  return 0;
}

// Registers, spilled bytes per thread, threads and shared memory per block
// of kern launched with `threads` threads and smem dynamic bytes, into
// out[0..3].  Returns a cudaError_t.
inline int kernel_attributes(const void* kern, int threads, size_t smem,
                             int out[4]) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = threads;
  out[3] = (int)(a.sharedSizeBytes + smem);
  return 0;
}

// Launch one instantiation on device `device`'s `stream`: raises the
// dynamic shared-memory limit on the first launch there.  Returns the
// cudaError_t (0 on success).
template <class P, int DIM, int EXT, class Blk, bool MINMOD>
int launch(int device, const Args& g, const typename P::Params& k,
           cudaStream_t stream) {
  using Tl = Tile<P::R, DIM, EXT, Blk>;
  auto kern = muscl_kernel<P, DIM, EXT, Blk, MINMOD>;
  static bool raised[64] = {};
  const int err = raise_smem((const void*)kern, Tl::SMEM, device, raised);
  if (err != 0) return err;
  const dim3 block(Blk::TE, Tl::SLOTS), grid((g.E + Blk::TE - 1) / Blk::TE);
  kern<<<grid, block, Tl::SMEM, stream>>>(g, k);
  return (int)cudaGetLastError();
}

// Registers, spilled bytes per thread, threads and shared memory per block
// of one instantiation, into out[0..3].
template <class P, int DIM, int EXT, class Blk, bool MINMOD>
int attributes(int out[4]) {
  using Tl = Tile<P::R, DIM, EXT, Blk>;
  return kernel_attributes((const void*)muscl_kernel<P, DIM, EXT, Blk, MINMOD>,
                           Tl::THREADS, Tl::SMEM, out);
}

// The first-order walk's neighbour beyond one end of a pencil: nb its row
// 0 in device memory (P::RIN rows rs apart), or nullptr where the pencil
// has no face there (a zero flux: the inner-only kernel's element edges);
// w the face weight and ok its speed mask.
struct End {
  const float* nb;
  long long rs;
  float w, ok;
};

// Walk segment seg of pencil t along axis A of element slot x over the Tl
// tile st (P::RS rows): its Ls = L / SPLIT cells [seg Ls, (seg + 1) Ls)
// of the pencil's L, each interface of theirs once, the one before the
// first cell from the previous tile cell or lo's cell, the one after the
// last from the next tile cell or hi's cell (an interface between two
// segments is evaluated by both: the same bits); the flux weighted by
// surface inside the tile; D of each cell once into the tile sd (P::RD
// rows, axis 0 first); the masked interface speeds into spd.
template <class P, class Tl, int DIM, int EXT, int A>
__device__ __forceinline__ void walk1(const float* st, float* sd, int x, int t,
                                      int seg, const End& lo, const End& hi,
                                      float surface, float interior_ok,
                                      float aux, const typename P::Params& k,
                                      float& spd) {
  using Cell = typename P::Cell;
  constexpr int RS = P::RS, RD = P::RD, TE = Tl::TE;
  constexpr int PL = Tl::B / ipow(EXT, DIM - 1);  // planes along axis 0
  constexpr int L = A == 0 ? PL : EXT;
  constexpr int Ls = L / Tl::SPLIT;               // cells of a segment
  static_assert(L % Tl::SPLIT == 0, "segments must divide the pencil");
  constexpr int stride = ipow(EXT, DIM - 1 - A);  // cell stride along A
  constexpr int pstride = stride + stride / EXT;  // slot stride, as walk's
  constexpr int RSTR = Tl::BP * TE;               // row stride of a tile
  constexpr bool FIRST = A == 0;

  const int c0 = pencil_start<DIM, EXT, A, PL>(t);
  const float* pu = st + Tl::at(0, c0, x);
  float* pd = sd + Tl::at(0, c0, x);

  auto tile_cell = [&](int q) {
    const float* p = pu + q * pstride * TE;
    float s[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) s[i] = p[i * RSTR];
    return P::template cell<A>(s, k);
  };
  auto end_cell = [&](const End& n) {
    float r[P::RIN], s[RS];
#pragma unroll
    for (int i = 0; i < P::RIN; ++i) r[i] = __ldg(n.nb + i * n.rs);
    P::convert(r, s, k);
    return P::template cell<A>(s, k);
  };

  const int q0 = seg * Ls;  // the faces (q0-1|q0) .. (q0+Ls-1|q0+Ls)
  const bool has_lo = q0 == 0 && lo.nb != nullptr;
  const bool has_hi = q0 + Ls == L && hi.nb != nullptr;
  Cell cl = has_lo ? end_cell(lo) : tile_cell(q0 == 0 ? 0 : q0 - 1);  // at q-1
  float fl[RD];  // weighted F(q-2|q-1)
#pragma unroll
  for (int r = 0; r < RD; ++r) fl[r] = 0.0f;

#pragma unroll 2
  for (int j = 0; j <= Ls; ++j) {
    const int q = q0 + j;
    float* du = pd + (q - 1) * pstride * TE;  // cell q-1 in sd
    float dold[RD];                           // its D from the earlier axes
    if (!FIRST && j > 0) {
#pragma unroll
      for (int r = 0; r < RD; ++r) dold[r] = du[r * RSTR];
    }
    float fw[RD];  // weighted F(q-1|q); zero where the pencil has no face
    if ((q == 0 && !has_lo) || (q == L && !has_hi)) {
#pragma unroll
      for (int r = 0; r < RD; ++r) fw[r] = 0.0f;
    } else {
      const Cell cr = q == L ? end_cell(hi) : tile_cell(q);
      float f[RD];
      const float sp = P::template flux<A>(cl, cr, aux, k, f);
      const float wgt = q == 0 ? lo.w : (q == L ? hi.w : surface);
      spd = nan_max(spd, sp * (q == 0 ? lo.ok : (q == L ? hi.ok : interior_ok)));
#pragma unroll
      for (int r = 0; r < RD; ++r) fw[r] = f[r] * wgt;
      cl = cr;
    }
    if (j > 0) {  // both faces of cell q-1 known
#pragma unroll
      for (int r = 0; r < RD; ++r) du[r * RSTR] = ((FIRST ? 0.0f : dold[r]) + fl[r]) - fw[r];
    }
#pragma unroll
    for (int r = 0; r < RD; ++r) fl[r] = fw[r];
  }
}

// Walk every (pencil, segment) of axis A of element slot x, the threads'
// slots y striding over them (pencils fastest); ends(t) gives pencil t's
// (lo, hi) neighbours.
template <class P, class Tl, int DIM, int EXT, int A, class Ends>
__device__ __forceinline__ void walk1_axis(const float* st, float* sd, int x,
                                           int y, const Ends& ends,
                                           float surface, float interior_ok,
                                           float aux,
                                           const typename P::Params& k,
                                           float& spd) {
  constexpr int PENCILS = A == 0 ? ipow(EXT, DIM - 1) : Tl::T;
  for (int i = y; i < PENCILS * Tl::SPLIT; i += Tl::SLOTS) {
    const int t = i % PENCILS, seg = i / PENCILS;
    End lo, hi;
    ends(t, lo, hi);
    walk1<P, Tl, DIM, EXT, A>(st, sd, x, t, seg, lo, hi, surface, interior_ok,
                              aux, k, spd);
  }
}

// The first-order divergence of slab `slab` (of EXT / PL) of the TE
// elements e0 .. e0 + TE - 1 of a block, those below E: stage the slab's
// cells (g.u's P::RIN rows, all of a thread's loads in flight at once,
// converted into the P::RS rows of st), then walk axis 0, 1 (and 2), D
// into sd (P::RD rows).  A pencil's neighbours are the side layers
// g.sides[2A] (hi, weight w[1+2A]) and [2A+1] (lo, w[2+2A]), or along
// axis 0 inside the element the planes beyond the slab, read in g.u
// (interior faces, weight w[0]).  Returns the thread's masked interface
// speed max; ends with a __syncthreads, after which the block reads st
// and sd.  Every thread of the block calls it.
template <class P, class Tl, int DIM, int EXT>
__device__ __forceinline__ float walk1_slab(const Args& g, float* st, float* sd,
                                            int slab, int e0,
                                            const typename P::Params& k) {
  constexpr int B = Tl::B, T0 = ipow(EXT, DIM - 1);  // cells of a plane
  constexpr int NSLAB = EXT * T0 / B;
  const int x = threadIdx.x, y = threadIdx.y;
  const int e = e0 + x;
  const bool live = e < g.E;
  const long long Es = g.E;
  const long long rs = (long long)EXT * T0 * Es;  // row stride of a block tensor
  const long long ls = (long long)T0 * Es;        // row stride of a side layer
  const int cbase = slab * B;                     // the slab's first cell

  load_cells<Tl, B, P::RIN>(
      e0, g.E,
      [&](int c, int ee, float* v) {
#pragma unroll
        for (int r = 0; r < P::RIN; ++r)
          v[r] = __ldg(g.u + r * rs + (long long)(cbase + c) * Es + ee);
      },
      [&](int c, int, int cx, const float* v) {
        float s[P::RS];
        P::convert(v, s, k);
#pragma unroll
        for (int i = 0; i < P::RS; ++i) st[Tl::at(i, c, cx)] = s[i];
      });
  __syncthreads();

  float spd = 0.0f;
  float surface = 0.0f, interior_ok = 0.0f, aux = 0.0f;
  if (live) {
    surface = __ldg(g.w + e);
    interior_ok = surface > 0.0f ? 1.0f : 0.0f;
    aux = __ldg(g.w + 7 * Es + e);
  }
  // walk axis A; pencil t's neighbours are side layers 2A (hi) and 2A+1
  // (lo), or along axis 0 inside the element the planes beyond the slab
  auto walk = [&](auto axis) {
    constexpr int A = decltype(axis)::value;
    const float w_hi = __ldg(g.w + (1 + 2 * A) * Es + e);
    const float w_lo = __ldg(g.w + (2 + 2 * A) * Es + e);
    auto ends = [&](int t, End& lo, End& hi) {
      // the side layers' tangent index: the slab's planes along axis 0
      // come after the earlier slabs'
      const long long ts = A == 0 ? t : t + slab * Tl::T;
      hi = End{g.sides[2 * A] + ts * Es + e, ls, w_hi, w_hi > 0.0f ? 1.0f : 0.0f};
      lo = End{g.sides[2 * A + 1] + ts * Es + e, ls, w_lo, w_lo > 0.0f ? 1.0f : 0.0f};
      if constexpr (A == 0) {
        const float* cell = g.u + (long long)(cbase + t) * Es + e;
        if (slab > 0) lo = End{cell - T0 * Es, rs, surface, interior_ok};
        if (slab < NSLAB - 1) hi = End{cell + B * Es, rs, surface, interior_ok};
      }
    };
    walk1_axis<P, Tl, DIM, EXT, A>(st, sd, x, y, ends, surface, interior_ok,
                                   aux, k, spd);
  };
  if (live) walk(std::integral_constant<int, 0>{});
  __syncthreads();
  if (live) walk(std::integral_constant<int, 1>{});
  if constexpr (DIM == 3) {
    __syncthreads();
    if (live) walk(std::integral_constant<int, 2>{});
  }
  __syncthreads();
  return spd;
}

}  // namespace t8pencil
