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
//   D(c)     = (D(c) + w(c-1|c) F(c-1|c)) - w(c|c+1) F(c|c+1), axis 0 first
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
// Design: the first-order pencil walk of muscl_pencil.cuh (walk1_slab),
// shared with the Euler stage kernels, on the 9 state rows (the Glm
// policy below: a cell's rows rotated into the face frame, the flux
// rotated back).  A block stages a tile of elements in shared memory (all
// of a thread's loads in flight at once), walks each pencil in two
// segments, evaluating each interface once (the one between the segments
// by both, the same bits), keeps D in a shared tile between axes and
// writes it in one pass, elements fastest.  At 2D extent 8 a block holds
// 16 elements: 256 threads, 83,968 bytes of shared memory, two blocks per
// SM, 87 registers (8 or 32 elements per block, one segment per pencil,
// blocks that stay resident and stage the next tile while they walk, and
// D from the faces in a second pass all ran slower); at 3D extent 8 a
// slab of 2 of the 8 planes along axis 0 of 8
// elements, whose axis-0 pencils read the planes beyond the slab in
// device memory (the face between two slabs evaluated by both, from the
// same two states), and an element's speed combines its slabs' by one
// atomicMax on the bits of the non-negative float into the zero-filled
// [E].  Every instantiation's resources: t8_fused_mhd_flux_attributes.

#include <cuda_runtime.h>

#include <type_traits>

#include "mhd_rusanov.cuh"
#include "muscl_pencil.cuh"

namespace {

constexpr int ROWS = t8mhd::ROWS;

// The GLM-MHD physics of walk1: the 9 state rows staged as they are, a
// cell's rows rotated into the +A face frame, the Rusanov/GLM flux with
// c_h = aux (weight row 7) rotated back into x, y, z rows.
struct Glm {
  static constexpr int RIN = ROWS, RS = ROWS, RD = ROWS;
  using Params = t8mhd::Consts;
  struct Cell {
    float s[ROWS];
  };

  __device__ static __forceinline__ void convert(const float* r, float s[ROWS],
                                                 const Params&) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = r[i];
  }

  template <int A>
  __device__ static __forceinline__ Cell cell(const float s[ROWS], const Params&) {
    Cell q;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) q.s[i] = s[t8pencil::frame_row(A, i)];
    return q;
  }

  template <int A>
  __device__ static __forceinline__ float flux(const Cell& L, const Cell& R,
                                               float ch, const Params& k,
                                               float f[ROWS]) {
    float fr[ROWS];
    const float sp = t8mhd::rusanov(L.s, R.s, ch, k, fr);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) f[t8pencil::frame_row(A, i)] = fr[i];
    return sp;
  }
};

// A block takes a slab of PL planes along axis 0 (2 at 3D extent 8, else
// the whole element) of MHD_SLOTS / T elements (T pencils of a slab along
// the other axes), MHD_SPLIT threads per pencil: 256 threads in every
// case; registers for MHD_MIN_BLOCKS blocks per SM.
constexpr int MHD_SLOTS = 128, MHD_SPLIT = 2, MHD_MIN_BLOCKS = 2;

__host__ __device__ constexpr int mhd_planes(int dim, int ext) {
  return dim == 3 && ext == 8 ? 2 : ext;
}

template <int DIM, int EXT>
struct MhdShape {
  static constexpr int PL = mhd_planes(DIM, EXT);
  static constexpr int T = PL * t8pencil::ipow(EXT, DIM - 1) / EXT;
  using Blk = t8pencil::Block<MHD_SLOTS / T, MHD_SPLIT, MHD_MIN_BLOCKS>;
};

template <int DIM, int EXT>
using MhdTile = t8pencil::Tile<ROWS, DIM, EXT, typename MhdShape<DIM, EXT>::Blk,
                               MhdShape<DIM, EXT>::PL, ROWS>;

// The divergence of a block's slab of its elements (walk1_slab), written
// in one pass over the tile, and the per-element speed max.
template <int DIM, int EXT>
__global__ void __launch_bounds__(MhdTile<DIM, EXT>::THREADS, MHD_MIN_BLOCKS)
    fused_mhd_flux_kernel(t8pencil::Args g, t8mhd::Consts k) {
  using Tl = MhdTile<DIM, EXT>;
  constexpr int B = Tl::B, NSLAB = EXT / MhdShape<DIM, EXT>::PL;
  extern __shared__ float smem[];
  float* st = smem;             // states
  float* sd = st + Tl::TILE;    // D
  float* red = sd + Tl::DTILE;  // [SLOTS][TE] speeds

  const int slab = blockIdx.x % NSLAB;
  const int e0 = (blockIdx.x / NSLAB) * Tl::TE;
  const float spd = t8pencil::walk1_slab<Glm, Tl, DIM, EXT>(g, st, sd, slab, e0, k);

  const long long Es = g.E;
  const long long rs = (long long)t8pencil::ipow(EXT, DIM) * Es;  // row stride
  t8pencil::for_cells<Tl, B>(e0, g.E, [&](int c, int ee, int cx) {
    const long long off = (long long)(slab * B + c) * Es + ee;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) g.D[r * rs + off] = sd[Tl::at(r, c, cx)];
  });
  const int e = e0 + threadIdx.x;
  t8pencil::element_speed<Tl, (NSLAB > 1)>(red, spd, e < g.E, g.speed, e);
}

// Call fn.template run<DIM, EXT>() for the case; cudaErrorInvalidValue
// for a case none takes.
template <class Fn>
int with_case(int dim, int ext, const Fn& fn) {
  if (dim == 3 && ext == 8) return fn.template run<3, 8>();
  if (dim == 3 && ext == 4) return fn.template run<3, 4>();
  if (dim == 2 && ext == 8) return fn.template run<2, 8>();
  if (dim == 2 && ext == 4) return fn.template run<2, 4>();
  return (int)cudaErrorInvalidValue;
}

struct Launcher {
  int device;
  const t8pencil::Args& g;
  const t8mhd::Consts& k;
  cudaStream_t stream;
  template <int DIM, int EXT>
  int run() const {
    using Tl = MhdTile<DIM, EXT>;
    auto kern = fused_mhd_flux_kernel<DIM, EXT>;
    static bool raised[64] = {};
    const int err = t8pencil::raise_smem((const void*)kern, Tl::SMEM, device, raised);
    if (err != 0) return err;
    const dim3 block(Tl::TE, Tl::SLOTS);
    const dim3 grid((g.E + Tl::TE - 1) / Tl::TE * (EXT / mhd_planes(DIM, EXT)));
    kern<<<grid, block, Tl::SMEM, stream>>>(g, k);
    return (int)cudaGetLastError();
  }
};

struct Attributes {
  int* out;
  template <int DIM, int EXT>
  int run() const {
    using Tl = MhdTile<DIM, EXT>;
    return t8pencil::kernel_attributes((const void*)fused_mhd_flux_kernel<DIM, EXT>,
                                       Tl::THREADS, Tl::SMEM, out);
  }
};

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
  const t8pencil::Args g{u, w, {o0, o1, o2, o3, o4, o5}, D, speed, E};
  const t8mhd::Consts k = t8mhd::make_consts(gamma);
  return with_case(dim, ext, Launcher{device, g, k, static_cast<cudaStream_t>(stream)});
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel, into out[0..3].  Returns
// a cudaError_t.
extern "C" int t8_fused_mhd_flux_attributes(int device, int dim, int ext,
                                            int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, Attributes{out});
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
