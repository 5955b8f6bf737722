// One SSP-RK stage of the subgrid compressible-Euler scheme, fused into one
// kernel for NVIDIA Hopper (sm_90a), from the state or from cell fields.
//
// Replaces two TPU kernels of t8gpu_tpu/ops/pallas_kernels.py, for mu = 0
// and no gravity:
//   * fused_rk_stage_pallas (:1190, body _fused_rk_kernel :1100 and
//     _tile_flux_divergence :97), kernel fused_rk_stage_kernel: kepes,
//     hll and hllc on 5-row state inputs, or (kepes) 7-row ones with log
//     rho and log p in rows 5-6 (the "logs" stage input);
//   * fused_rk_stage_fields_pallas (:1329, body _fused_rk_fields_kernel
//     :1282), kernel fused_rk_stage_fields_kernel: kepes, hll and hllc on
//     the caller's cell-field rows (the "fields" stage input), the stage
//     state recovered from them (_recover_state_rows :1268: m = rho v,
//     e = p / (gamma - 1) + rho ke for kepes, rho h - p for hll/hllc).
// Both compute, per element E and cell c of its [EXT]^DIM block:
//
//   D(c)   = sum over axes a of  w_lo(c,a) F(c-1 -> c) - w_hi(c,a) F(c -> c+1)
//   D(c)  += x_k(t(c))  for each side k with extras whose boundary layer
//            holds c, in increasing k (both kernels' extras operand,
//            _fused_rk_kernel :1154-1158, _fused_rk_fields_kernel
//            :1309-1313: the hanging-fine faces' fluxes of AMR meshes)
//   out(c) = (ca * u_prev(c) + cb * u(c)) + (cc * w[7]) * D(c)
//   speed  = per-element max wave speed over the masked interfaces
//
// with u_prev = u when it is not given (stage 1), where the interface
// flux F is fields_flux of t8gpu_tpu/ops/euler.py on per-cell fields
// (cell_fields_tuple): kepes_fields_flux (euler_kepes.cuh),
// hll_fields_flux or hllc_fields_flux (euler_hll.cuh).  Interfaces inside
// the block carry weight w[0] (the cell face area); the +a face of the
// last cell reads the side layer others[2a] with weight w[1+2a], the -a
// face of cell 0 the side layer others[2a+1] with weight w[2+2a] (a wall
// side carries the mirrored own layer, built by the caller).
//
// Layout (element-minor, as in the JAX package): u is [5 or 7, EXT^DIM,
// E], or the field rows q [10 (kepes: rho, v_x, v_y, v_z, p, rho/p, log
// rho, log p, vent0, ke) or 9 (hll/hllc: rho, v_x, v_y, v_z, p, h, c,
// sqrt(rho), ke), EXT^DIM, E]; u_prev and out [5, EXT^DIM, E]; w is [8,
// E]; side layer k has u's rows, [C, EXT^(DIM-1), E], the tangent axes
// in increasing order, and its extras x_k (null: none) [5, EXT^(DIM-1),
// E] the same tangent order, t(c) the cell's index in it; side k is the
// +axis (k even) or -axis (k odd) side of axis k / 2, its boundary layer
// the cells at EXT - 1 or 0 along that axis; speed is [E] (float bits).
//
// Bound on this card, at the flagship shape (DIM 3, EXT 8, E 4374): the
// state-input stage moves ~123 MB (stage 1, one state read) or ~168 MB
// (stages 2-3), 37-50 us at 3.35 TB/s; its necessary arithmetic (the
// fields of each cell once, ~22 operations with two logs and three
// divides, and each interface's flux once, ~200 with two divides, a sqrt
// and a rsqrt) is ~1.6 GFLOP, 24 us at the fp32 peak.  The field-input
// stage moves ~202 MB (stage 1) or ~246 MB (stages 2-3): 60 and 74 us;
// twice the state's bytes come in as field rows, the price of taking the
// field derivation out of the kernel.  So the bytes bound both, if they
// read every input once and evaluate every interface once.
//
// Design: the first-order pencil walk of muscl_pencil.cuh (walk1_slab).
// A block takes a slab of 2 of the 8 planes along axis 0 (at 3D extent 8;
// whole elements at extent 4 and in 2D) of a tile of elements: it loads
// the slab's cells with all of a thread's loads in flight at once and
// stages each cell's fields once in shared memory (from the state: rho,
// v, p, log rho, log p, 7 rows, whose rho/p, ke and vent0, or sqrt(rho)
// for hll/hllc, are taken per face frame by the same operations; from
// field rows: the rows as they are), and walks each pencil, evaluating
// each of its interfaces once; the faces beyond the pencil's ends come
// from the side layers, or inside the element from the planes beyond the
// slab, whose fields come by the same code as their own block's (the
// face between two slabs is evaluated by both, the same bits, and both
// elements of a mesh face get the same bits).  D lives in a shared tile
// between axes; the stage update is one pass over the tile, elements
// fastest.  State input: 16 elements and one thread per pencil, 256
// threads, 111,616 bytes of shared memory, two blocks per SM, 91
// registers (kepes).  Field input: 8 elements and two threads per pencil
// (each pencil walked in two segments, the face between them by both),
// 256 threads, 70,144 bytes (kepes, 96 registers) or 65,536 (hll/hllc,
// 94 and 92), two blocks per SM.  At the flagship the field-input stage
// is slower than the one-thread-per-cell kernel it replaced, which read
// whole 128-byte rows and evaluated every interface twice: about half of
// its time is the staging and the update pass, whose 32-byte runs of a
// cell row (E = 4374 puts most of them across two sectors) move the
// bytes at ~1.2 TB/s, and the walks do not overlap them (PERF.md has the
// ablations and the variants that lost).  An element's speed max combines
// its slabs' by one atomicMax on the bits of the non-negative float into
// a zero-filled [E] (order-free, bit-reproducible); no float atomics.
// The extras are read in the update pass, one 5-row value per boundary
// cell of each side that has them (sides 0 and 1 meet only the first and
// last slab); a launch without extras runs an instantiation without that
// code (EXTRAS = false: the kernel of a uniform mesh).  Every
// instantiation's resources: t8_fused_rk_stage_attributes,
// t8_fused_rk_stage_fields_attributes.
//
// Built without --use_fast_math and with --fmad=false: IEEE division and
// sqrt, no contraction, as the plain PyTorch versions, which the kernels
// follow bit for bit.  torch divides by a Python scalar on CUDA as a
// product with the scalar's float reciprocal, so vent0's "/ (gamma - 1)"
// and the recovered energy's are that product here too.

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
  static constexpr bool FIELDS = false;
  static constexpr int RIN = LOGS ? 7 : 5;
  static constexpr int RS = 7, RD = 5;
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
                                               float, const Consts& k, float f[5]) {
    return kepes_flux<A>(L, R, k, f);
  }
};

// hll or hllc on the hll fields of each cell (cell_fields_tuple "hll"):
// rho, v[3], p, h and c staged, sqrt(rho) taken per face frame (the same
// bits); ke is not needed, the fluxes do not read it.
template <int FLUX>
struct Hll {
  static constexpr bool FIELDS = false;
  static constexpr int RIN = 5;
  static constexpr int RS = 7, RD = 5;
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
                                               float, const Consts& k, float f[5]) {
    return hll_family_flux<FLUX, A>(L, R, k, f);
  }
};

// The field-input stage: the staged rows are the caller's field rows of
// flux FLUX (ops/euler.cell_fields_tuple), read, not derived; cell<A>
// picks them into the flux's fields, and the stage state is recovered
// from them (_recover_state_rows).
template <int FLUX>
struct FieldRows {
  static constexpr bool FIELDS = true;
  static constexpr int RIN = FLUX == KEPES ? 10 : 9;
  static constexpr int RS = RIN, RD = 5;
  using Params = Consts;
  using Cell = std::conditional_t<FLUX == KEPES, Fields, HllFields>;

  __device__ static __forceinline__ void convert(const float* r, float s[RS],
                                                 const Consts&) {
#pragma unroll
    for (int i = 0; i < RS; ++i) s[i] = r[i];
  }

  // kepes: the fields as they are (the flux rotates); hll/hllc: in the
  // +A face frame
  template <int A>
  __device__ static __forceinline__ Cell cell(const float s[RS], const Consts&) {
    if constexpr (FLUX == KEPES) {
      return {s[0], {s[1], s[2], s[3]}, s[4], s[5], s[6], s[7], s[8], s[9]};
    } else {
      using Fr = Frame<A>;
      return {s[0], s[1 + Fr::n], s[1 + Fr::t1], s[1 + Fr::t2], s[4], s[5], s[6], s[7], s[8]};
    }
  }

  template <int A>
  __device__ static __forceinline__ float flux(const Cell& L, const Cell& R,
                                               float, const Consts& k, float f[5]) {
    if constexpr (FLUX == KEPES)
      return kepes_flux<A>(L, R, k, f);
    else
      return hll_family_flux<FLUX, A>(L, R, k, f);
  }

  // the stage state of a cell from its field rows q(i): m = rho v, e =
  // p / (gamma - 1) + rho ke (kepes) or rho h - p (hll/hllc)
  template <class Row>
  __device__ static __forceinline__ void recover(const Row& q, const Consts& k,
                                                 float u[5]) {
    const float rho = q(0);
    u[0] = rho;
    u[1] = rho * q(1);
    u[2] = rho * q(2);
    u[3] = rho * q(3);
    u[4] = FLUX == KEPES ? q(4) * k.inv_km1 + rho * q(9) : rho * q(5) - q(4);
  }
};

// A block takes a slab of PL planes along axis 0 (2 at 3D extent 8, else
// the whole element) of as many elements as its threads leave, with
// registers for two blocks per SM.  State input: 256 threads, one per
// pencil (16 elements at 3D extent 8).  Field input: FIELDS_SLOTS / T
// elements (T pencils of a slab along the other axes), FIELDS_SPLIT
// threads per pencil (8 elements and 256 threads at 3D extent 8).
constexpr int FIELDS_SLOTS = 128, FIELDS_SPLIT = 2;

__host__ __device__ constexpr int stage_planes(int dim, int ext) {
  return dim == 3 && ext == 8 ? 2 : ext;
}

template <class P, int DIM, int EXT>
struct StageShape {
  static constexpr int PL = stage_planes(DIM, EXT);
  static constexpr int T = PL * t8pencil::ipow(EXT, DIM - 1) / EXT;  // pencils
  using Blk = std::conditional_t<
      P::FIELDS,
      t8pencil::Block<FIELDS_SLOTS / T, FIELDS_SPLIT, 2>,
      t8pencil::Block<256 / T, 1, 2>>;
};

// The staged tile holds each cell's fields, the divergence tile D.
template <class P, int DIM, int EXT>
using StageTile = t8pencil::Tile<P::RS, DIM, EXT, typename StageShape<P, DIM, EXT>::Blk,
                                 StageShape<P, DIM, EXT>::PL, P::RD>;

// The extras operand: the 2*DIM sides' additive layers, null where a side
// has none; an empty stand-in for the instantiations without extras.
struct Extras {
  const float* x[6];
};
struct NoExtras {};
template <bool EXTRAS>
using ExtrasArg = std::conditional_t<EXTRAS, Extras, NoExtras>;

// Per side k, the offset t * E + e of tile cell c (slab `slab`, element
// e) in x_k when x_k is given and c lies on side k's boundary layer, else
// -1: t is c's index over the axes other than k / 2, in increasing order.
template <int DIM, int EXT, int B>
__device__ __forceinline__ void extras_offsets(const Extras& xs, int slab, int c,
                                               long long Es, int e,
                                               long long off[2 * DIM]) {
  const int gc = slab * B + c;  // the cell's index in the element's block
  int i[DIM];
#pragma unroll
  for (int a = DIM - 1, rem = gc; a >= 0; --a, rem /= EXT) i[a] = rem % EXT;
#pragma unroll
  for (int k = 0; k < 2 * DIM; ++k) {
    const int a = k / 2;
    int t = 0;
#pragma unroll
    for (int b = 0; b < DIM; ++b)
      if (b != a) t = t * EXT + i[b];
    const bool on = xs.x[k] != nullptr && i[a] == (k % 2 == 0 ? EXT - 1 : 0);
    off[k] = on ? (long long)t * Es + e : -1;
  }
}

// One stage for a block: it walks its slab of its elements' cells
// (walk1_slab; from the state, the fields derived as they are staged),
// then the stage update (a u_prev + b u) + c w[7] (D + extras) in one
// pass, u the state rows of g.u or recovered from the staged field rows,
// and the per-element speed max.  up == nullptr (SHARE_PREV) means
// u_prev is u.
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
__device__ __forceinline__ void stage(const t8pencil::Args& g,
                                      const float* __restrict__ up,
                                      const Consts& k, float ca, float cb,
                                      float cc, const ExtrasArg<EXTRAS>& xs) {
  using Tl = StageTile<P, DIM, EXT>;
  constexpr int NSLAB = EXT / StageShape<P, DIM, EXT>::PL;
  extern __shared__ float smem[];
  float* st = smem;             // fields
  float* sd = st + Tl::TILE;    // D
  float* red = sd + Tl::DTILE;  // [SLOTS][TE] speeds

  const int slab = blockIdx.x % NSLAB;
  const int e0 = (blockIdx.x / NSLAB) * Tl::TE;
  const float spd = t8pencil::walk1_slab<P, Tl, DIM, EXT>(g, st, sd, slab, e0, k);

  // the stage update, in _stage_update's operation order
  constexpr int B = Tl::B;
  const long long Es = g.E;
  const long long rs = (long long)t8pencil::ipow(EXT, DIM) * Es;  // row stride
  t8pencil::for_cells<Tl, B>(e0, g.E, [&](int c, int ee, int cx) {
    const long long off = (long long)(slab * B + c) * Es + ee;
    const float cdt = cc * __ldg(g.w + 7 * Es + ee);
    float uf[5];
    if constexpr (P::FIELDS)
      P::recover([&](int i) { return st[Tl::at(i, c, cx)]; }, k, uf);
    [[maybe_unused]] long long xo[2 * DIM];
    if constexpr (EXTRAS) extras_offsets<DIM, EXT, B>(xs, slab, c, Es, ee, xo);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float ur = P::FIELDS ? uf[r] : __ldg(g.u + r * rs + off);
      const float upr = SHARE_PREV ? ur : __ldg(up + r * rs + off);
      float d = sd[Tl::at(r, c, cx)];
      if constexpr (EXTRAS) {
        // the sides in increasing k, the plain version's order
        constexpr long long T = t8pencil::ipow(EXT, DIM - 1);
#pragma unroll
        for (int s = 0; s < 2 * DIM; ++s)
          if (xo[s] >= 0) d = d + __ldg(xs.x[s] + r * T * Es + xo[s]);
      }
      g.D[r * rs + off] = (ca * upr + cb * ur) + cdt * d;
    }
  });
  const int e = e0 + threadIdx.x;
  t8pencil::element_speed<Tl, (NSLAB > 1)>(red, spd, e < g.E, g.speed, e);
}

// The stage on 5-row states or 7-row states with their log rows.
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
__global__ void __launch_bounds__(StageTile<P, DIM, EXT>::THREADS,
                                  StageShape<P, DIM, EXT>::Blk::MIN_BLOCKS)
    fused_rk_stage_kernel(t8pencil::Args g, const float* __restrict__ up,
                          Consts k, float ca, float cb, float cc,
                          ExtrasArg<EXTRAS> xs) {
  stage<P, DIM, EXT, SHARE_PREV, EXTRAS>(g, up, k, ca, cb, cc, xs);
}

// The stage on cell-field rows (g.u is q).
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
__global__ void __launch_bounds__(StageTile<P, DIM, EXT>::THREADS,
                                  StageShape<P, DIM, EXT>::Blk::MIN_BLOCKS)
    fused_rk_stage_fields_kernel(t8pencil::Args g, const float* __restrict__ up,
                                 Consts k, float ca, float cb, float cc,
                                 ExtrasArg<EXTRAS> xs) {
  stage<P, DIM, EXT, SHARE_PREV, EXTRAS>(g, up, k, ca, cb, cc, xs);
}

// The case's kernel: state or field input.
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
auto stage_kernel() {
  if constexpr (P::FIELDS)
    return fused_rk_stage_fields_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS>;
  else
    return fused_rk_stage_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS>;
}

// What the stage reads: the 5-row state, the 7-row state with its log
// rows (kepes only), or the flux's cell-field rows.
enum Input { STATE = 0, LOGS = 1, FIELD_ROWS = 2 };

// Call fn.template run<P, DIM, EXT, SHARE_PREV, EXTRAS>() for the
// instantiation of the case; cudaErrorInvalidValue for a case none takes.
template <class Fn>
int with_case(int dim, int ext, int flux, int input, bool share_prev,
              bool extras, const Fn& fn) {
  auto by_shape = [&](auto physics) -> int {
    using P = decltype(physics);
    auto by_prev = [&](auto d, auto x) -> int {
      constexpr int D = decltype(d)::value, X = decltype(x)::value;
      if (extras)
        return share_prev ? fn.template run<P, D, X, true, true>()
                          : fn.template run<P, D, X, false, true>();
      return share_prev ? fn.template run<P, D, X, true, false>()
                        : fn.template run<P, D, X, false, false>();
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
  if (input == FIELD_ROWS) {
    if (flux == KEPES) return by_shape(FieldRows<KEPES>{});
    if (flux == HLL) return by_shape(FieldRows<HLL>{});
    if (flux == HLLC) return by_shape(FieldRows<HLLC>{});
    return (int)cudaErrorInvalidValue;
  }
  if (flux == KEPES) return input == LOGS ? by_shape(Kepes<true>{}) : by_shape(Kepes<false>{});
  if (input == LOGS) return (int)cudaErrorInvalidValue;  // the log rows: kepes only
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
  const Extras& xs;
  cudaStream_t stream;
  template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
  int run() const {
    using Tl = StageTile<P, DIM, EXT>;
    auto kern = stage_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS>();
    static bool raised[64] = {};
    const int err = t8pencil::raise_smem((const void*)kern, Tl::SMEM, device, raised);
    if (err != 0) return err;
    const dim3 block(Tl::TE, Tl::SLOTS);
    const dim3 grid((g.E + Tl::TE - 1) / Tl::TE * (EXT / stage_planes(DIM, EXT)));
    if constexpr (EXTRAS)
      kern<<<grid, block, Tl::SMEM, stream>>>(g, up, k, ca, cb, cc, xs);
    else
      kern<<<grid, block, Tl::SMEM, stream>>>(g, up, k, ca, cb, cc, NoExtras{});
    return (int)cudaGetLastError();
  }
};

struct Attributes {
  int* out;
  template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
  int run() const {
    using Tl = StageTile<P, DIM, EXT>;
    return t8pencil::kernel_attributes(
        (const void*)stage_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS>(),
        Tl::THREADS, Tl::SMEM, out);
  }
};

int launch(int device, int dim, int ext, int E, int flux, int input,
           const float* u, const float* up, const float* w,
           const float* const o[6], const float* const x[6], float* out,
           unsigned int* speed, double gamma, float ca, float cb, float cc,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const t8pencil::Args g{u, w, {o[0], o[1], o[2], o[3], o[4], o[5]}, out, speed, E};
  const Consts k = make_consts(gamma);
  const Extras xs{{x[0], x[1], x[2], x[3], x[4], x[5]}};
  bool any = false;
  for (int s = 0; s < 6; ++s) {
    if (x[s] == nullptr) continue;
    if (s >= 2 * dim) return (int)cudaErrorInvalidValue;  // no such side
    any = true;
  }
  return with_case(dim, ext, flux, input, up == nullptr, any,
                   Launcher{device, g, up, k, ca, cb, cc, xs,
                            static_cast<cudaStream_t>(stream)});
}

int attributes(int device, int dim, int ext, int flux, int input,
               int share_prev, int extras, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, flux, input, share_prev != 0, extras != 0,
                   Attributes{out});
}

}  // namespace

// Launch one stage on `stream`.  flux is 0 kepes, 1 hll, 2 hllc; logs != 0
// (kepes only) means u and the side layers have 7 rows; up == nullptr
// means u_prev == the state rows of u (stage 1); x0 .. x5 are the sides'
// extras, nullptr where a side has none (all null: the instantiation
// without extras).  speed must be a zero-filled [E]; it receives the
// uint32 bits of each element's float max.  Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
extern "C" int t8_fused_rk_stage(int device, int dim, int ext, int E, int flux,
                                 int logs, const float* u, const float* up,
                                 const float* w, const float* o0,
                                 const float* o1, const float* o2,
                                 const float* o3, const float* o4,
                                 const float* o5, const float* x0,
                                 const float* x1, const float* x2,
                                 const float* x3, const float* x4,
                                 const float* x5, float* out,
                                 unsigned int* speed, double gamma, float ca,
                                 float cb, float cc, void* stream) {
  const float* const o[6] = {o0, o1, o2, o3, o4, o5};
  const float* const x[6] = {x0, x1, x2, x3, x4, x5};
  return launch(device, dim, ext, E, flux, logs != 0 ? LOGS : STATE, u, up, w,
                o, x, out, speed, gamma, ca, cb, cc, stream);
}

// Launch one stage from cell-field rows q (flux 0 kepes: 10 rows, 1 hll
// or 2 hllc: 9 rows; the side layers too) on `stream`; up == nullptr
// means u_prev == the state recovered from q (stage 1); x0 .. x5 and speed
// as t8_fused_rk_stage's.  Returns the cudaError_t of the launch.
extern "C" int t8_fused_rk_stage_fields(int device, int dim, int ext, int E,
                                        int flux, const float* q,
                                        const float* up, const float* w,
                                        const float* o0, const float* o1,
                                        const float* o2, const float* o3,
                                        const float* o4, const float* o5,
                                        const float* x0, const float* x1,
                                        const float* x2, const float* x3,
                                        const float* x4, const float* x5,
                                        float* out, unsigned int* speed,
                                        double gamma, float ca, float cb,
                                        float cc, void* stream) {
  const float* const o[6] = {o0, o1, o2, o3, o4, o5};
  const float* const x[6] = {x0, x1, x2, x3, x4, x5};
  return launch(device, dim, ext, E, flux, FIELD_ROWS, q, up, w, o, x, out,
                speed, gamma, ca, cb, cc, stream);
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel (extras != 0: the
// instantiation with extras), into out[0..3].  Returns a cudaError_t.
extern "C" int t8_fused_rk_stage_attributes(int device, int dim, int ext,
                                            int flux, int logs, int share_prev,
                                            int extras, int* out) {
  return attributes(device, dim, ext, flux, logs != 0 ? LOGS : STATE,
                    share_prev, extras, out);
}

// The same for the field-input stage's case.
extern "C" int t8_fused_rk_stage_fields_attributes(int device, int dim,
                                                   int ext, int flux,
                                                   int share_prev, int extras,
                                                   int* out) {
  return attributes(device, dim, ext, flux, FIELD_ROWS, share_prev, extras,
                    out);
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
