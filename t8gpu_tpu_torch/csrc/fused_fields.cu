// The first-order Euler flux divergence from precomputed cell fields, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_flux_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:193, body _fused_kernel :170 over
// _tile_flux_divergence :97) for the fluxes kepes, hll and hllc and no
// hanging-face extras:
//   D(c)  = sum over axes a of  w_lo(c,a) F(c-1 -> c) - w_hi(c,a) F(c -> c+1)
//   speed = per-element max wave speed over the masked interfaces.
// F is fields_flux of ops/euler.py on the fields: the KEPES flux
// (euler_kepes.cuh) or hll_fields_flux / hllc_fields_flux (euler_hll.cuh),
// the flux a template parameter.  The fields are read, not derived, so the
// kernel has no log and no per-cell divide; the caller computes them once
// per cell (ops/euler.cell_fields_tuple) and gathers the side layers of
// field rows (ops/subgrid.pallas_side_inputs; a wall side carries the
// mirrored own layer, an open side the farfield ghost's fields, so
// boundaries need no code here).  The stage kernel on the same field rows
// (fused_rk_stage_fields_pallas) is fused_rk_stage.cu's
// fused_rk_stage_fields_kernel.
//
// Layout (element-minor): q is [10, EXT^DIM, E] (kepes rows rho, v_x, v_y,
// v_z, p, rho/p, log rho, log p, vent0, ke) or [9, EXT^DIM, E] (hll/hllc
// rows rho, v_x, v_y, v_z, p, h, c, sqrt(rho), ke); D [5, EXT^DIM, E]; w
// [8, E] (row 0 the interior face area, rows 1 + k side k's face weight);
// side layer k [10 or 9, EXT^(DIM-1), E]; speed [E] (float bits).
//
// Bound on this card: at the flagship shape (DIM 3, EXT 8, E 4374) the
// kepes divergence moves ~202 MB (q 89.6, side layers 67.2, D 44.8): 60 us
// at 3.35 TB/s, hll/hllc's nine rows ~186 MB, 56 us.  Its arithmetic,
// ~180 float operations and ~300 instructions per interface evaluation
// (two IEEE divisions and a square root in kepes, --fmad=false), is of
// the same order: at 3 evaluations per cell the instructions alone take
// ~0.06-0.07 ms at the card's instruction rate, so the kernel is bound by
// its instruction count as much as by its bytes, and the number of
// interface evaluations per cell is what moves it.
//
// Design: one thread per cell and element; a block a tile of TE = 32
// elements (each cell row a 128-byte run) by a band of BC = 16 cells of one
// plane (two rows of i1 at 3D extent 8), 512 threads, two blocks per SM
// (50-64 registers, 67,840 B of shared memory in kepes).  Each thread stages its cell's rows in shared memory
// and evaluates the faces of the tile once, as the +a face of the lower
// cell, into a face buffer per axis; the tile's first cells along axes 1
// and 2 also take their -a face.  Only the faces that leave the tile are
// evaluated twice, once by each tile: the two axis-0 faces of each cell
// (the planes x - 1 and x + 1, or the axis-0 side layers, from device
// memory, where L2 keeps them for the neighbouring planes' blocks, which
// run at the same time), the axis-1 faces between bands; 4.6 evaluations
// per cell at 3D extent 8, against 6 when each cell evaluates both of its
// faces on every axis.  D is combined per cell from the face buffers in
// the plain version's order (ops/kernels._first_order_divergence: axis 0
// first, D = (D + w_lo F_lo) - w_hi F_hi; a face's weighted flux is the
// same bits from either side), so with --fmad=false the kernel is
// bit-identical to it.  The ragged last element run is masked.  The speed
// is a max over the tile's cells per element and one atomicMax on the
// non-negative float bits per element and block (order-free).  At E 4374
// the grid is 137 runs x 8 planes x 4 bands = 4 384 blocks, 16.6 waves of
// 264.  A plane march (each interface once, the next plane's rows copied
// in by cp.async during the current one's faces) needed 80 or more
// registers a thread and lost to this tile (PERF.md, Findings).  Every
// instantiation's resources and grid: t8_fused_fields_attributes.

#include "euler_hll.cuh"

namespace {

using t8pencil::ipow;

constexpr int FLUX_TE = 32;  // elements per tile
constexpr int FLUX_BC = 16;  // cells of a plane per tile (whole rows; at most)

struct Args {
  const float* q;
  const float* w;
  const float* sides[6];
  float* out;
  unsigned int* speed;
  int E;
};

// The field rows of one flux (ops/euler.cell_fields_tuple): load reads a
// cell's rows from the staged tile (rows rs floats apart), ldg from device
// memory (rows rs floats apart), cell<A> turns them
// into the flux's fields in the +A face frame (kepes: as they are, its
// flux rotates), flux<A> is the interface flux with f in x, y, z rows.
// hll and hllc: nine rows.
template <int FLUX>
struct Rows {
  static constexpr int C = 9;
  struct Raw {
    float r[9];
  };
  __device__ static __forceinline__ Raw load(const float* p, int rs) {
    Raw q;
#pragma unroll
    for (int i = 0; i < 9; ++i) q.r[i] = p[i * rs];
    return q;
  }
  __device__ static __forceinline__ Raw ldg(const float* p, long long rs) {
    Raw q;
#pragma unroll
    for (int i = 0; i < 9; ++i) q.r[i] = __ldg(p + i * rs);
    return q;
  }
  template <int A>
  __device__ static __forceinline__ HllFields cell(const Raw& q) {
    using Fr = Frame<A>;
    return {q.r[0], q.r[1 + Fr::n], q.r[1 + Fr::t1], q.r[1 + Fr::t2], q.r[4],
            q.r[5], q.r[6], q.r[7], q.r[8]};
  }
  template <int A>
  __device__ static __forceinline__ float flux(const HllFields& L,
                                               const HllFields& R,
                                               const Consts& k, float f[5]) {
    return hll_family_flux<FLUX, A>(L, R, k, f);
  }
};

// kepes: ten rows.
template <>
struct Rows<KEPES> {
  static constexpr int C = 10;
  using Raw = Fields;
  __device__ static __forceinline__ Fields load(const float* p, int rs) {
    Fields q;
    q.rho = p[0];
    q.v[0] = p[rs];
    q.v[1] = p[2 * rs];
    q.v[2] = p[3 * rs];
    q.p = p[4 * rs];
    q.rhop = p[5 * rs];
    q.lrho = p[6 * rs];
    q.lp = p[7 * rs];
    q.vent0 = p[8 * rs];
    q.ke = p[9 * rs];
    return q;
  }
  __device__ static __forceinline__ Fields ldg(const float* p, long long rs) {
    Fields q;
    q.rho = __ldg(p);
    q.v[0] = __ldg(p + rs);
    q.v[1] = __ldg(p + 2 * rs);
    q.v[2] = __ldg(p + 3 * rs);
    q.p = __ldg(p + 4 * rs);
    q.rhop = __ldg(p + 5 * rs);
    q.lrho = __ldg(p + 6 * rs);
    q.lp = __ldg(p + 7 * rs);
    q.vent0 = __ldg(p + 8 * rs);
    q.ke = __ldg(p + 9 * rs);
    return q;
  }
  template <int A>
  __device__ static __forceinline__ const Fields& cell(const Fields& q) {
    return q;
  }
  template <int A>
  __device__ static __forceinline__ float flux(const Fields& L, const Fields& R,
                                               const Consts& k, float f[5]) {
    return kepes_flux<A>(L, R, k, f);
  }
};

// The weighted flux wgt F(ql|qr) across a +A face into slot `at` of the face
// buffer fb ([5][slots][TE], element e), and the masked speed into spd.
template <class R, int A, int TE>
__device__ __forceinline__ void face_to(const typename R::Raw& ql,
                                        const typename R::Raw& qr, float wgt,
                                        float ok, const Consts& k, float* fb,
                                        int slots, int at, int e, float& spd) {
  float f[5];
  const float sp = R::template flux<A>(R::template cell<A>(ql),
                                       R::template cell<A>(qr), k, f);
  spd = fmaxf(spd, sp * ok);
#pragma unroll
  for (int i = 0; i < 5; ++i) fb[(i * slots + at) * TE + e] = f[i] * wgt;
}

// The tile of one instantiation: a band of BC cells (whole rows of i1) of
// one plane of TE elements.  A plane's cell c is i1 SE + i2 (3D; the
// axis-1 stride SE = EXT, axis 2 stride 1), or i1 (2D).  The face buffers
// hold each face of the tile once: axis 0 slot bc the -0 face of tile cell
// bc, slot BC + bc its +0 face; axis 1 slot bc + SE the +1 face, slot
// bc < SE the first row's -1 face; axis 2 slot r (EXT + 1) + i2 + 1 the +2
// face of row r's cell i2, slot r (EXT + 1) the row's -2 face.
template <int FLUX, int DIM, int EXT>
struct Tile {
  static constexpr int C = Rows<FLUX>::C;
  static constexpr int TE = FLUX_TE;
  static constexpr int P = ipow(EXT, DIM - 1);
  static constexpr int B = EXT * P;
  static constexpr int SE = ipow(EXT, DIM - 2);
  static constexpr int BC = P >= FLUX_BC ? FLUX_BC : P;
  static constexpr int ROWS = BC / SE;           // rows of i1 in a band
  static constexpr int BANDS = P / BC;
  static constexpr int THREADS = BC * TE;
  static constexpr int RSTR = BC * TE;           // row stride of the tile
  static constexpr int F0 = 2 * BC;              // axis-0 face slots
  static constexpr int F1 = BC + SE;             // axis-1 face slots
  static constexpr int F2 = DIM == 3 ? BC + ROWS : 0;  // axis-2 face slots
  static constexpr size_t SMEM =
      sizeof(float) * (C * BC + 5 * (F0 + F1 + F2)) * TE;
  static_assert(BC % SE == 0 && P % BC == 0, "bands of whole rows");
  static_assert(THREADS <= 1024 && 1024 % THREADS == 0, "block size");
};

template <int FLUX, int DIM, int EXT>
__global__ void __launch_bounds__(Tile<FLUX, DIM, EXT>::THREADS,
                                  1024 / Tile<FLUX, DIM, EXT>::THREADS)
    fused_fields_kernel(const Args a, const Consts k) {
  using Tl = Tile<FLUX, DIM, EXT>;
  using R = Rows<FLUX>;
  constexpr int TE = Tl::TE, P = Tl::P, SE = Tl::SE, BC = Tl::BC;
  constexpr int F0 = Tl::F0, F1 = Tl::F1, F2 = Tl::F2, RSTR = Tl::RSTR;
  extern __shared__ __align__(16) float smem[];
  float* const st = smem;                        // [C][BC][TE]
  float* const fb0 = st + Tl::C * RSTR;          // [5][F0][TE]
  float* const fb1 = fb0 + 5 * F0 * TE;          // [5][F1][TE]
  float* const fb2 = fb1 + 5 * F1 * TE;          // [5][F2][TE]
  const int e = threadIdx.x % TE, bc = threadIdx.x / TE;
  int blk = blockIdx.x;
  const int band = blk % Tl::BANDS;
  blk /= Tl::BANDS;
  const int x = blk % EXT, e0 = blk / EXT * TE;
  const int ee = min(e0 + e, a.E - 1);
  const int c = band * BC + bc;
  const long long Es = a.E, rs = (long long)Tl::B * Es, ls = (long long)P * Es;
  const float* qc = a.q + (long long)(x * P + c) * Es + ee;
  auto wt = [&](int r) { return __ldg(a.w + r * Es + ee); };
  auto mask = [](float w) { return w > 0.0f ? 1.0f : 0.0f; };
  float spd = 0.0f;

  // stage the cell; its axis-0 faces, to planes x - 1 and x + 1 (or the
  // axis-0 side layers) in device memory
  {
    const typename R::Raw own = R::ldg(qc, rs);
    const float* o = reinterpret_cast<const float*>(&own);
#pragma unroll
    for (int i = 0; i < Tl::C; ++i) st[i * RSTR + bc * TE + e] = o[i];
    const float wl = wt(x == 0 ? 2 : 0);
    face_to<R, 0, TE>(x > 0 ? R::ldg(qc - P * Es, rs)
                            : R::ldg(a.sides[1] + c * Es + ee, ls),
                      own, wl, mask(wl), k, fb0, F0, bc, e, spd);
    const float wh = wt(x == EXT - 1 ? 1 : 0);
    face_to<R, 0, TE>(own,
                      x < EXT - 1 ? R::ldg(qc + P * Es, rs)
                                  : R::ldg(a.sides[0] + c * Es + ee, ls),
                      wh, mask(wh), k, fb0, F0, BC + bc, e, spd);
  }
  __syncthreads();

  const float* cur = st + bc * TE + e;
  {  // axis 1: the neighbours past the band from device memory
    const int i1 = c / SE, j1 = c % SE, r1 = bc / SE;
    const float* lay = (i1 == EXT - 1 ? a.sides[2] : a.sides[3]) +
                       (long long)(x * SE + j1) * Es + ee;
    const float wh = wt(i1 == EXT - 1 ? 3 : 0);
    face_to<R, 1, TE>(R::load(cur, RSTR),
                      i1 == EXT - 1 ? R::ldg(lay, ls)
                      : r1 < Tl::ROWS - 1 ? R::load(cur + SE * TE, RSTR)
                                          : R::ldg(qc + SE * Es, rs),
                      wh, mask(wh), k, fb1, F1, bc + SE, e, spd);
    if (r1 == 0) {
      const float wl = wt(i1 == 0 ? 4 : 0);
      face_to<R, 1, TE>(i1 == 0 ? R::ldg(lay, ls) : R::ldg(qc - SE * Es, rs),
                        R::load(cur, RSTR), wl, mask(wl), k, fb1, F1, bc, e,
                        spd);
    }
  }
  if constexpr (DIM == 3) {  // axis 2: rows are whole in the band
    const int i1 = c / EXT, i2 = c % EXT, at = bc / SE * (EXT + 1) + i2;
    const float* lay = (i2 == EXT - 1 ? a.sides[4] : a.sides[5]) +
                       (long long)(x * EXT + i1) * Es + ee;
    const float wh = wt(i2 == EXT - 1 ? 5 : 0);
    face_to<R, 2, TE>(R::load(cur, RSTR),
                      i2 == EXT - 1 ? R::ldg(lay, ls) : R::load(cur + TE, RSTR),
                      wh, mask(wh), k, fb2, F2, at + 1, e, spd);
    if (i2 == 0) {
      const float wl = wt(6);
      face_to<R, 2, TE>(R::ldg(lay, ls), R::load(cur, RSTR), wl, mask(wl), k,
                        fb2, F2, at, e, spd);
    }
  }
  __syncthreads();

  // D in the plain version's order: axis 0 first, (D + w_lo F_lo) - w_hi F_hi
  float D[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    D[i] = (0.0f + fb0[(i * F0 + bc) * TE + e]) -
           fb0[(i * F0 + BC + bc) * TE + e];
    D[i] = (D[i] + fb1[(i * F1 + bc) * TE + e]) -
           fb1[(i * F1 + bc + SE) * TE + e];
  }
  if constexpr (DIM == 3) {
    const int at = bc / SE * (EXT + 1) + c % EXT;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      D[i] = (D[i] + fb2[(i * F2 + at) * TE + e]) -
             fb2[(i * F2 + at + 1) * TE + e];
  }
  const bool live = e0 + e < a.E;
  if (live) {
    float* o = a.out + (long long)(x * P + c) * Es + e0 + e;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i * rs] = D[i];
  }
  // the block's speed per element: a max over its cells, one atomicMax
  st[threadIdx.x] = spd;
  __syncthreads();
  if (bc == 0 && live) {
    float m = st[e];
    for (int j = 1; j < BC; ++j) m = fmaxf(m, st[j * TE + e]);
    m = m > 0.0f ? m : 0.0f;  // +0 for zero and NaN: the bits order as floats
    atomicMax(a.speed + e0 + e, __float_as_uint(m));
  }
}

// Blocks per SM of one instantiation on a device (queried once; raises its
// dynamic shared-memory limit first).
template <int FLUX, int DIM, int EXT>
int occupancy(int device, int& per_sm) {
  using Tl = Tile<FLUX, DIM, EXT>;
  static int cached[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    static bool raised[64] = {};
    const void* kern = (const void*)fused_fields_kernel<FLUX, DIM, EXT>;
    int err = t8pencil::raise_smem(kern, Tl::SMEM, device, raised);
    if (err != 0) return err;
    int n = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, Tl::THREADS, Tl::SMEM);
    if (err != 0) return err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    cached[device] = n;
  }
  per_sm = cached[device];
  return 0;
}

// Blocks of the grid at E elements: one per element run, plane and band.
template <int FLUX, int DIM, int EXT>
long long grid_blocks(int E) {
  using Tl = Tile<FLUX, DIM, EXT>;
  return (long long)(E + Tl::TE - 1) / Tl::TE * EXT * Tl::BANDS;
}

// Call fn.template run<FLUX, DIM, EXT>() for the case; cudaErrorInvalidValue
// for a case none takes.
template <int FLUX, class Fn>
int with_shape(int dim, int ext, const Fn& fn) {
  if (dim == 3 && ext == 8) return fn.template run<FLUX, 3, 8>();
  if (dim == 3 && ext == 4) return fn.template run<FLUX, 3, 4>();
  if (dim == 2 && ext == 8) return fn.template run<FLUX, 2, 8>();
  if (dim == 2 && ext == 4) return fn.template run<FLUX, 2, 4>();
  return (int)cudaErrorInvalidValue;
}

template <class Fn>
int with_case(int flux, int dim, int ext, const Fn& fn) {
  switch (flux) {
    case KEPES: return with_shape<KEPES>(dim, ext, fn);
    case HLL: return with_shape<HLL>(dim, ext, fn);
    case HLLC: return with_shape<HLLC>(dim, ext, fn);
  }
  return (int)cudaErrorInvalidValue;
}

struct Launcher {
  int device;
  const Args& a;
  const Consts& k;
  cudaStream_t stream;
  template <int FLUX, int DIM, int EXT>
  int run() const {
    using Tl = Tile<FLUX, DIM, EXT>;
    int per_sm = 0;
    const int err = occupancy<FLUX, DIM, EXT>(device, per_sm);
    if (err != 0) return err;
    fused_fields_kernel<FLUX, DIM, EXT>
        <<<(unsigned)grid_blocks<FLUX, DIM, EXT>(a.E), Tl::THREADS, Tl::SMEM,
           stream>>>(a, k);
    return (int)cudaGetLastError();
  }
};

struct Attributes {
  int device, E;
  int* out;
  template <int FLUX, int DIM, int EXT>
  int run() const {
    using Tl = Tile<FLUX, DIM, EXT>;
    int err = t8pencil::kernel_attributes(
        (const void*)fused_fields_kernel<FLUX, DIM, EXT>, Tl::THREADS,
        Tl::SMEM, out);
    if (err != 0) return err;
    err = occupancy<FLUX, DIM, EXT>(device, out[4]);
    out[5] = (int)grid_blocks<FLUX, DIM, EXT>(E);
    return err;
  }
};

}  // namespace

// Launch the divergence (out is D [5, ...]) on `stream`; flux is 0 kepes
// (q and the side layers 10 field rows), 1 hll or 2 hllc (9 rows).  speed
// must be zero-filled [E] (each block takes its elements' max by
// atomicMax).  Returns the cudaError_t of the launch (0 on success); never
// synchronizes.
extern "C" int t8_fused_fields(int device, int dim, int ext, int E, int flux,
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
  const Args a{q, w, {o0, o1, o2, o3, o4, o5}, out, speed, E};
  return with_case(flux, dim, ext,
                   Launcher{device, a, k, static_cast<cudaStream_t>(stream)});
}

// Registers, spilled (local) bytes per thread, threads per block, shared
// memory per block, blocks per SM and the grid's blocks at E elements of
// the case's kernel, into out[0..5].  Returns a cudaError_t.
extern "C" int t8_fused_fields_attributes(int device, int dim, int ext,
                                          int flux, int E, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  return with_case(flux, dim, ext, Attributes{device, E, out});
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
