// Second-order (MUSCL) GLM-MHD flux divergence of the subgrid scheme,
// fused into one kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mhd_muscl_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:777, body _fused_mhd_muscl_kernel :761
// and _tile_mhd_muscl_divergence :617).  Per element, cell i of a pencil
// along axis a, on the 9 rows rotated into the +a frame:
//
//   s_i  = lim(u_i - u_{i-1}, u_{i+1} - u_i)      (lim: minmod or central)
//   uL_i = guard(u_i + s_i/2, u_i),  uR_i = guard(u_i - s_i/2, u_i)
//   F(i|i+1) = Rusanov + exact GLM flux (mhd_rusanov.cuh) from uL_i to
//              uR_{i+1}, with the cleaning speed c_h = w[7]
//   D_i  = (D_i + w(i-1|i) F(i-1|i)) - w(i|i+1) F(i|i+1),  axis 0 first
//   speed = per-element max signal speed over the masked interfaces
//
// The walk, the block-edge masks (walls, dead and hanging sides get a
// one-sided slope; their fluxes are the caller's first-order closure) and
// the mesh-face reconstructions from the four layers both elements see are
// muscl_pencil.cuh's, shared with fused_muscl.cu; this file holds the
// guard, which keeps the cell's own state where the reconstruction has
// rho <= 0 or THERMAL pressure p <= 0 (the magnetic pressure excluded).
//
// Layout (element-minor, as in the JAX package): u and D are
// [9, EXT^DIM, E]; w is [8, E]; side slab k is [18, EXT^(DIM-1), E], rows
// 0-8 the facing layer, 9-17 the second, side k = 2a + (0 for +a, 1 for
// -a), tangent axes in increasing order; speed is [E] (float bits).
//
// Bound on this card: at the Orszag-Tang shape (DIM 2, EXT 8, E 22143:
// 16384 elements and their capacity padding) one launch must read u
// (51.0 MB), four side slabs (51.0 MB) and the weights, and write D
// (51.0 MB): ~154 MB, 46 us at 3.35 TB/s.  The necessary arithmetic (per
// cell and axis the slopes, reconstructions and guards, ~160 operations;
// per interface one Rusanov flux, ~210) is ~1.2 GFLOP, 17 us at the fp32
// peak: the bytes bound it.
//
// Design: the pencil walk of muscl_pencil.cuh, each interface evaluated
// once and each slope and guarded reconstruction once.  At 2D extent 8 a
// block holds 16 elements and walks each pencil in two segments of 4
// cells (the interface between them evaluated by both, the same bits):
// 256 threads, 83,968 bytes of shared memory, two blocks per SM, 114
// registers, no spills (sm_90a, CUDA 12.8).  One segment
// per pencil, or 8 elements per block, ran slower.  No atomics: a block
// owns its elements, so each one's speed max is one store.  Every
// instantiation's resources: t8_fused_mhd_muscl_attributes.

#include <cuda_runtime.h>

#include <type_traits>

#include "mhd_rusanov.cuh"
#include "muscl_pencil.cuh"

namespace {

constexpr int ROWS = t8mhd::ROWS;

// The GLM-MHD physics of the pencil walk (muscl_pencil.cuh).
template <bool POS>
struct Mhd {
  static constexpr int R = ROWS;
  using Params = t8mhd::Consts;

  __device__ static __forceinline__ void convert(float[ROWS], const Params&) {}

  struct Face {
    float s[ROWS];
  };

  // guard(rec, base): keep base where rec has rho <= 0 or thermal p <= 0
  // (rows in the face frame; the sums are over the frame's rows, as in the
  // JAX kernel).
  __device__ static __forceinline__ Face face(float rec[ROWS],
                                              const float base[ROWS],
                                              const Params& k) {
    bool ok = true;
    if (POS) {
      const float s_rho = 1.0f / rec[0];
      const float ke = 0.5f * ((rec[1] * rec[1] + rec[2] * rec[2]) + rec[3] * rec[3]) * s_rho;
      const float b2s = (rec[5] * rec[5] + rec[6] * rec[6]) + rec[7] * rec[7];
      const float p = k.km1 * ((rec[4] - ke) - 0.5f * b2s);
      ok = (rec[0] > 0.0f) & (p > 0.0f);
    }
    Face q;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) q.s[i] = ok ? rec[i] : base[i];
    return q;
  }

  __device__ static __forceinline__ float flux(const Face& L, const Face& Rf,
                                               float ch, const Params& k,
                                               float f[ROWS]) {
    return t8mhd::rusanov(L.s, Rf.s, ch, k, f);
  }
};

// Elements per block.
__host__ __device__ constexpr int tile_elements(int dim, int ext) {
  return dim == 3 ? (ext == 8 ? 4 : 16) : (ext == 8 ? 16 : 32);
}

// Segments per pencil walk (threads per pencil).
__host__ __device__ constexpr int pencil_split(int dim, int ext) {
  return dim == 2 && ext == 8 ? 2 : 1;
}

// Call fn.template run<Physics, DIM, EXT, Block, MINMOD>() for the
// instantiation of the case; cudaErrorInvalidValue for a case none takes.
template <class Fn>
int with_case(int dim, int ext, bool minmod, bool pos, const Fn& fn) {
  auto by_shape = [&](auto physics) -> int {
    using P = decltype(physics);
    auto by_lim = [&](auto d, auto x) -> int {
      constexpr int D = decltype(d)::value, X = decltype(x)::value;
      using Blk = t8pencil::Block<tile_elements(D, X), pencil_split(D, X), 2>;
      return minmod ? fn.template run<P, D, X, Blk, true>()
                    : fn.template run<P, D, X, Blk, false>();
    };
    using I3 = std::integral_constant<int, 3>;
    using I2 = std::integral_constant<int, 2>;
    using I8 = std::integral_constant<int, 8>;
    using I4 = std::integral_constant<int, 4>;
    if (dim == 3 && ext == 8) return by_lim(I3{}, I8{});
    if (dim == 3 && ext == 4) return by_lim(I3{}, I4{});
    if (dim == 2 && ext == 8) return by_lim(I2{}, I8{});
    if (dim == 2 && ext == 4) return by_lim(I2{}, I4{});
    return (int)cudaErrorInvalidValue;
  };
  return pos ? by_shape(Mhd<true>{}) : by_shape(Mhd<false>{});
}

struct Launcher {
  int device;
  const t8pencil::Args& g;
  const t8mhd::Consts& k;
  cudaStream_t stream;
  template <class P, int DIM, int EXT, class Blk, bool MINMOD>
  int run() const {
    return t8pencil::launch<P, DIM, EXT, Blk, MINMOD>(device, g, k, stream);
  }
};

struct Attributes {
  int* out;
  template <class P, int DIM, int EXT, class Blk, bool MINMOD>
  int run() const {
    return t8pencil::attributes<P, DIM, EXT, Blk, MINMOD>(out);
  }
};

}  // namespace

// Launch one MHD MUSCL divergence on `stream`; speed [E] receives the
// uint32 bits of each element's float max.  minmod / positivity are 0 or 1.
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
  const t8pencil::Args g{u, w, {o0, o1, o2, o3, o4, o5}, D, speed, E};
  const t8mhd::Consts k = t8mhd::make_consts(gamma);
  return with_case(dim, ext, minmod != 0, positivity != 0,
                   Launcher{device, g, k, static_cast<cudaStream_t>(stream)});
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel, into out[0..3].  Returns
// a cudaError_t.
extern "C" int t8_fused_mhd_muscl_attributes(int device, int dim, int ext,
                                             int minmod, int positivity,
                                             int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, minmod != 0, positivity != 0, Attributes{out});
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
