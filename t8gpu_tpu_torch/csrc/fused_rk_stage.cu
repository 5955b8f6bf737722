// One SSP-RK stage of the subgrid compressible-Euler scheme, fused into one
// kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_rk_stage_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:1190, body _fused_rk_kernel :1100 and
// _tile_flux_divergence :97) for the kepes, hll and hllc fluxes, 5-row
// state inputs or (kepes) 7-row ones with log rho and log p in rows 5-6
// (the "logs" stage input), no hanging-face extras, mu = 0 and no gravity.
// It computes, per element E and cell c of its [EXT]^DIM block:
//
//   D(c)   = sum over axes a of  w_lo(c,a) F(c-1 -> c) - w_hi(c,a) F(c -> c+1)
//   out(c) = (ca * u_prev(c) + cb * u(c)) + (cc * w[7]) * D(c)
//   speed  = per-element max wave speed over the masked interfaces
//
// where the interface flux F is fields_flux of t8gpu_tpu/ops/euler.py on
// per-cell fields (cell_fields_tuple): kepes_fields_flux (euler_kepes.cuh),
// hll_fields_flux or hllc_fields_flux (euler_hll.cuh).  Interfaces inside
// the block carry weight w[0] (the cell face area); the +a face of the
// last cell reads the side layer others[2a] with weight w[1+2a], the -a
// face of cell 0 the side layer others[2a+1] with weight w[2+2a].
//
// Layout (element-minor, as in the JAX package): u is [5 or 7, EXT^DIM, E],
// u_prev and out [5, EXT^DIM, E]; w is [8, E]; side layer k is [5 or 7,
// EXT^(DIM-1), E] with the tangent axes in increasing order; speed is [E]
// (float bits).
//
// Bound on this card: the stage moves ~123 MB (stage 1, one state read) or
// ~168 MB (stages 2-3) at the flagship shape (DIM 3, EXT 8, E 4374), 37-50
// us at 3.35 TB/s; its necessary arithmetic (the fields of each cell once,
// ~22 operations with two logs and three divides, and each interface's
// flux once, ~200 with two divides, a sqrt and a rsqrt) is ~1.6 GFLOP, 24
// us at the fp32 peak.  So the bytes bound it, if it reads every input
// once and evaluates every interface once.
//
// Design: the first-order pencil walk of muscl_pencil.cuh (walk1).  A
// block takes a slab of 2 of the 8 planes along axis 0 of 16 elements (at
// 3D extent 8; whole elements at extent 4 and in 2D): it loads the slab's
// cells with all of a thread's loads in flight at once, derives each
// cell's fields once into shared memory (rho, v, p, log rho, log p: 7
// rows; rho/p, ke and vent0, or sqrt(rho) for hll/hllc, are taken per face
// frame by the same operations), and one thread per pencil walks it,
// evaluating each of its interfaces once; the faces beyond the pencil's
// ends come from the side layers, or inside the element from the planes
// beyond the slab, whose fields are derived by the same code as their own
// block's (the face between two slabs is evaluated by both, the same
// bits, and both elements of a mesh face get the same bits).  D lives in
// a shared tile between axes; the stage update is one pass over the tile,
// elements fastest (u, u_prev and w[7] loaded first).  256 threads per
// block, 111,616 bytes of shared memory, two blocks per SM; 16 elements
// give 64-byte runs of each cell row.  An element's speed max combines its
// slabs' by one atomicMax on the bits of the non-negative float into a
// zero-filled [E] (order-free, bit-reproducible); no float atomics.
// Every instantiation's resources: t8_fused_rk_stage_attributes.
//
// Built without --use_fast_math and with --fmad=false: IEEE division and
// sqrt, no contraction, as the plain PyTorch version, which the kernel
// follows bit for bit.  torch divides by a Python scalar on CUDA as a
// product with the scalar's float reciprocal, so vent0's "/ (gamma - 1)"
// is that product here too.

#include <cuda_runtime.h>

#include <type_traits>

#include "euler_hll.cuh"
#include "muscl_pencil.cuh"

namespace {

// KEPES on the kepes fields of each cell (cell_fields_tuple): rho, v[3], p,
// log rho, log p staged, derived from the RIN input rows once per cell
// (with LOGS, log rho and log p are rows 5 and 6 of the input, not
// computed); rho/p, ke and vent0 derived from them per face frame, by the
// same operations, so to the same bits.
template <bool LOGS>
struct Kepes {
  static constexpr int RIN = LOGS ? 7 : 5;
  static constexpr int RS = 7;
  using Params = Consts;
  using Cell = Fields;

  __device__ static __forceinline__ void convert(const float* r, float s[RS],
                                                 const Consts& k) {
    const float rho = r[0], inv_rho = 1.0f / rho;
    const float v0 = r[1] * inv_rho, v1 = r[2] * inv_rho, v2 = r[3] * inv_rho;
    const float ke = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
    const float p = k.km1 * (r[4] - rho * ke);
    s[0] = rho;
    s[1] = v0;
    s[2] = v1;
    s[3] = v2;
    s[4] = p;
    s[5] = LOGS ? r[5] : logf(rho);
    s[6] = LOGS ? r[6] : logf(p);
  }

  // the fields, in cell_fields_tuple's operation order; torch divides by a
  // Python scalar on CUDA as a product with the scalar's float reciprocal,
  // so vent0's "/ (gamma - 1)" is that product
  template <int A>
  __device__ static __forceinline__ Fields cell(const float s[RS], const Consts& k) {
    Fields f;
    f.rho = s[0];
    f.v[0] = s[1];
    f.v[1] = s[2];
    f.v[2] = s[3];
    f.p = s[4];
    f.lrho = s[5];
    f.lp = s[6];
    f.ke = 0.5f * (s[1] * s[1] + s[2] * s[2] + s[3] * s[3]);
    f.rhop = s[0] / s[4];
    const float ent = s[6] - k.gamma * s[5];
    f.vent0 = (k.gamma - ent) * (1.0f / k.km1) - f.rhop * f.ke;
    return f;
  }

  template <int A>
  __device__ static __forceinline__ float flux(const Fields& L, const Fields& R,
                                               const Consts& k, float f[5]) {
    return kepes_flux<A>(L, R, k, f);
  }
};

// hll or hllc on the hll fields of each cell (cell_fields_tuple "hll"):
// rho, v[3], p, h and c staged, sqrt(rho) taken per face frame (the same
// bits); ke is not needed, the fluxes do not read it.
template <int FLUX>
struct Hll {
  static constexpr int RIN = 5;
  static constexpr int RS = 7;
  using Params = Consts;
  using Cell = HllFields;

  __device__ static __forceinline__ void convert(const float* r, float s[RS],
                                                 const Consts& k) {
    const float rho = r[0], inv_rho = 1.0f / rho;
    const float v0 = r[1] * inv_rho, v1 = r[2] * inv_rho, v2 = r[3] * inv_rho;
    const float ke = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
    const float p = k.km1 * (r[4] - rho * ke);
    const float h = (r[4] + p) * inv_rho;
    s[0] = rho;
    s[1] = v0;
    s[2] = v1;
    s[3] = v2;
    s[4] = p;
    s[5] = h;
    s[6] = sqrtf(k.km1 * (h - ke));
  }

  // the fields in the +A face frame
  template <int A>
  __device__ static __forceinline__ HllFields cell(const float s[RS], const Consts&) {
    using Fr = Frame<A>;
    return {s[0], s[1 + Fr::n], s[1 + Fr::t1], s[1 + Fr::t2], s[4], s[5], s[6], sqrtf(s[0]), 0.0f};
  }

  template <int A>
  __device__ static __forceinline__ float flux(const HllFields& L, const HllFields& R,
                                               const Consts& k, float f[5]) {
    float fr[5];
    const float sp = FLUX == HLL ? hll_flux(L, R, k, fr) : hllc_flux(L, R, k, fr);
#pragma unroll
    for (int i = 0; i < 5; ++i) f[t8pencil::frame_row(A, i)] = fr[i];
    return sp;
  }
};

// A block: 256 threads, one per pencil of a slab of PL planes along axis 0
// (2 at 3D extent 8, else the whole element) of as many elements as that
// leaves (16 at 3D extent 8); registers for two blocks per SM.
__host__ __device__ constexpr int stage_planes(int dim, int ext) {
  return dim == 3 && ext == 8 ? 2 : ext;
}

template <int DIM, int EXT>
struct StageShape {
  static constexpr int PL = stage_planes(DIM, EXT);
  static constexpr int T = PL * t8pencil::ipow(EXT, DIM - 1) / EXT;  // pencils
  using Blk = t8pencil::Block<256 / T, 1, 2>;
};

// The staged tile holds each cell's fields, the divergence tile D.
template <class P, int DIM, int EXT>
using StageTile = t8pencil::Tile<P::RS, DIM, EXT, typename StageShape<DIM, EXT>::Blk,
                                 StageShape<DIM, EXT>::PL, 5>;

// One stage for a block: the fields of its slab of its elements' cells,
// walks along axis 0, 1 (and 2), then the stage update
// (a u_prev + b u) + c w[7] D in one pass and the per-element speed max.
// up == nullptr (SHARE_PREV) means u_prev is the state rows of u.
template <class P, int DIM, int EXT, bool SHARE_PREV>
__global__ void __launch_bounds__(StageTile<P, DIM, EXT>::THREADS,
                                  StageShape<DIM, EXT>::Blk::MIN_BLOCKS)
    fused_rk_stage_kernel(t8pencil::Args g, const float* __restrict__ up,
                          Consts k, float ca, float cb, float cc) {
  using Tl = StageTile<P, DIM, EXT>;
  using t8pencil::End;
  constexpr int B = Tl::B, T0 = t8pencil::ipow(EXT, DIM - 1);  // cells of a plane
  constexpr int NSLAB = EXT / StageShape<DIM, EXT>::PL;
  extern __shared__ float smem[];
  float* st = smem;             // fields
  float* sd = st + Tl::TILE;    // D
  float* red = sd + Tl::DTILE;  // [SLOTS][TE] speeds

  const int x = threadIdx.x, y = threadIdx.y;
  const int slab = blockIdx.x % NSLAB;
  const int e0 = (blockIdx.x / NSLAB) * Tl::TE;
  const int e = e0 + x;
  const bool live = e < g.E;
  const long long Es = g.E;
  const long long rs = (long long)EXT * T0 * Es;  // row stride of a block tensor
  const long long ls = (long long)T0 * Es;        // row stride of a side layer
  const int cbase = slab * B;                     // the slab's first cell

  t8pencil::load_cells<Tl, B, P::RIN>(
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
  float surface = 0.0f, interior_ok = 0.0f;
  if (live) {
    surface = __ldg(g.w + e);
    interior_ok = surface > 0.0f ? 1.0f : 0.0f;
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
    t8pencil::walk1_axis<P, Tl, DIM, EXT, A>(st, sd, x, y, ends, surface,
                                             interior_ok, k, spd);
  };
  if (live) walk(std::integral_constant<int, 0>{});
  __syncthreads();
  if (live) walk(std::integral_constant<int, 1>{});
  if constexpr (DIM == 3) {
    __syncthreads();
    if (live) walk(std::integral_constant<int, 2>{});
  }
  __syncthreads();

  // the stage update, in _stage_update's operation order
  t8pencil::for_cells<Tl, B>(e0, g.E, [&](int c, int ee, int cx) {
    const long long off = (long long)(cbase + c) * Es + ee;
    const float cdt = cc * __ldg(g.w + 7 * Es + ee);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float ur = __ldg(g.u + r * rs + off);
      const float upr = SHARE_PREV ? ur : __ldg(up + r * rs + off);
      g.D[r * rs + off] = (ca * upr + cb * ur) + cdt * sd[Tl::at(r, c, cx)];
    }
  });
  t8pencil::element_speed<Tl, (NSLAB > 1)>(red, spd, live, g.speed, e);
}

// Call fn.template run<P, DIM, EXT, SHARE_PREV>() for the instantiation of
// the case; cudaErrorInvalidValue for a case none takes.
template <class Fn>
int with_case(int dim, int ext, int flux, bool logs, bool share_prev, const Fn& fn) {
  auto by_shape = [&](auto physics) -> int {
    using P = decltype(physics);
    auto by_prev = [&](auto d, auto x) -> int {
      constexpr int D = decltype(d)::value, X = decltype(x)::value;
      return share_prev ? fn.template run<P, D, X, true>()
                        : fn.template run<P, D, X, false>();
    };
    using I3 = std::integral_constant<int, 3>;
    using I2 = std::integral_constant<int, 2>;
    using I8 = std::integral_constant<int, 8>;
    using I4 = std::integral_constant<int, 4>;
    if (dim == 3 && ext == 8) return by_prev(I3{}, I8{});
    if (dim == 3 && ext == 4) return by_prev(I3{}, I4{});
    if (dim == 2 && ext == 8) return by_prev(I2{}, I8{});
    if (dim == 2 && ext == 4) return by_prev(I2{}, I4{});
    return (int)cudaErrorInvalidValue;
  };
  if (flux == KEPES) return logs ? by_shape(Kepes<true>{}) : by_shape(Kepes<false>{});
  if (logs) return (int)cudaErrorInvalidValue;  // the log rows: kepes only
  if (flux == HLL) return by_shape(Hll<HLL>{});
  if (flux == HLLC) return by_shape(Hll<HLLC>{});
  return (int)cudaErrorInvalidValue;
}

struct Launcher {
  int device;
  const t8pencil::Args& g;
  const float* up;
  const Consts& k;
  float ca, cb, cc;
  cudaStream_t stream;
  template <class P, int DIM, int EXT, bool SHARE_PREV>
  int run() const {
    using Tl = StageTile<P, DIM, EXT>;
    auto kern = fused_rk_stage_kernel<P, DIM, EXT, SHARE_PREV>;
    static bool raised[64] = {};
    const int err = t8pencil::raise_smem((const void*)kern, Tl::SMEM, device, raised);
    if (err != 0) return err;
    const dim3 block(Tl::TE, Tl::SLOTS);
    const dim3 grid((g.E + Tl::TE - 1) / Tl::TE * (EXT / stage_planes(DIM, EXT)));
    kern<<<grid, block, Tl::SMEM, stream>>>(g, up, k, ca, cb, cc);
    return (int)cudaGetLastError();
  }
};

struct Attributes {
  int* out;
  template <class P, int DIM, int EXT, bool SHARE_PREV>
  int run() const {
    using Tl = StageTile<P, DIM, EXT>;
    return t8pencil::kernel_attributes(
        (const void*)fused_rk_stage_kernel<P, DIM, EXT, SHARE_PREV>, Tl::THREADS,
        Tl::SMEM, out);
  }
};

}  // namespace

// Launch one stage on `stream`.  flux is 0 kepes, 1 hll, 2 hllc; logs != 0
// (kepes only) means u and the side layers have 7 rows; up == nullptr
// means u_prev == the state rows of u (stage 1).  speed [E] receives the
// uint32 bits of each element's float max.  Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
extern "C" int t8_fused_rk_stage(int device, int dim, int ext, int E, int flux,
                                 int logs, const float* u, const float* up,
                                 const float* w, const float* o0,
                                 const float* o1, const float* o2,
                                 const float* o3, const float* o4,
                                 const float* o5, float* out,
                                 unsigned int* speed, double gamma, float ca,
                                 float cb, float cc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const t8pencil::Args g{u, w, {o0, o1, o2, o3, o4, o5}, out, speed, E};
  const Consts k = make_consts(gamma);
  return with_case(dim, ext, flux, logs != 0, up == nullptr,
                   Launcher{device, g, up, k, ca, cb, cc,
                            static_cast<cudaStream_t>(stream)});
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel, into out[0..3].  Returns
// a cudaError_t.
extern "C" int t8_fused_rk_stage_attributes(int device, int dim, int ext,
                                            int flux, int logs, int share_prev,
                                            int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, flux, logs != 0, share_prev != 0, Attributes{out});
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
