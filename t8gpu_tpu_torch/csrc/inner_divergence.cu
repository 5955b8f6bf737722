// The interior faces' flux divergence of a subgrid block state, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel inner_divergence_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:1425, body _kernel :1394) for flux
// "kepes": per element e and cell c of its [EXT]^DIM block, EXT in 2, 4, 8,
// 16,
//   D(c)  = sum over axes a of  s F(c-1 -> c) - s F(c -> c+1)
// over the faces inside the block only (the mesh faces and walls are the
// caller's: ops/subgrid.outer_apply, boundary_apply), s the element's
// interior face area (given per element, ops/kernels.interior_surface, 0
// on dead slots), and the max wave speed over all interior faces of the
// live elements, one scalar.  F is the state-form entropy-stable KEPES
// flux (kepes_es_flux of t8gpu_tpu_torch/ops/euler.py, the same arithmetic
// in the same order): per face two logarithmic means with one log each and
// the entropy variables of both states with two logs each, evaluated per
// face as the TPU kernel does (the rotation into the face frame reorders
// the kinetic-energy sum, so they cannot be taken per cell).
//
// Layout (element-minor): u and D are [5, EXT^DIM, E]; surface [E]; speed
// one uint32 (float bits).
//
// Bound on this card: at Subgrid<16,16,16> with E 576 (512 live) the kernel
// moves ~94 MB (u 47.2 read, D 47.2 written): 28 us at 3.35 TB/s; its
// arithmetic, ~290 operations per interface with 6 logs and 8 divides over
// 6.6M interfaces (1.9 GFLOP), takes ~29 us at the 67 TFLOP/s fp32 peak.
// The two bounds meet.
//
// Design: the first-order pencil walk of muscl_pencil.cuh (walk1) over the
// interior faces: a block loads its elements' states into shared memory
// (all of a thread's loads in flight at once) and walks each pencil along
// each axis in two segments, evaluating each interior face once (the face
// between two segments by both, the same bits); D goes out in one pass
// over the tile, elements fastest.  At extent 16 in 3D an element's state
// and D take 174 KB, so a block takes a slab of 2 of its 16 planes along
// axis 0 of 8 elements (512 threads, 176,128 bytes of shared memory, one
// block per SM; 8 elements give whole 32-byte sectors of each cell row);
// its axis-0 pencils read the planes beyond the slab in device memory, so
// the face between two slabs is evaluated by both, by the same code from
// the same two states (the same bits).  The slabs of an element group are
// neighbours in the launch order, so those reads find L2.  The other
// shapes take whole elements, 512 threads per block.  The speed is a block
// max and one atomicMax on non-negative float bits per block: order-free,
// so the scalar is bit-reproducible.  Every instantiation's resources:
// t8_inner_divergence_attributes.

#include <cuda_runtime.h>

#include "euler_kepes.cuh"
#include "muscl_pencil.cuh"

namespace {

// ln_mean of ops/euler.py: the stable logarithmic mean.
__device__ __forceinline__ float ln_mean(float a_l, float a_r) {
  const float xi = a_r / a_l;
  const float u = (xi * (xi - 2.0f) + 1.0f) / (xi * (xi + 2.0f) + 1.0f);
  const bool near = u < 1.0e-4f;
  const float series = (a_l + a_r) * 52.5f / series_den(u);
  const float exact = (a_r - a_l) / logf(near ? 2.0f : xi);
  return near ? series : exact;
}

// Entropy variables of a face-frame state (_entropy_variables).
__device__ __forceinline__ void entropy_variables(const float s[5],
                                                  const Consts& k,
                                                  float v[5]) {
  const float s_rho = 1.0f / s[0];
  const float v0 = s[1] * s_rho, v1 = s[2] * s_rho, v2 = s[3] * s_rho;
  const float kinetic = 0.5f * (s[1] * v0 + s[2] * v1 + s[3] * v2);
  const float p = k.km1 * (s[4] - kinetic);
  const float ent = logf(p) - k.gamma * logf(s[0]);
  const float rho_p = s[0] / p;
  v[0] = (k.gamma - ent) / k.km1 - 0.5f * rho_p * (v0 * v0 + v1 * v1 + v2 * v2);
  v[1] = rho_p * v0;
  v[2] = rho_p * v1;
  v[3] = rho_p * v2;
  v[4] = -rho_p;
}

// kepes_es_flux of face-frame states L, R (row 1 the normal momentum):
// the face-frame flux f and the wave speed |u_hat| + a_hat.
__device__ __forceinline__ float kepes_es_flux(const float L[5],
                                               const float R[5],
                                               const Consts& k, float f[5]) {
  // kepes_flux: the central part
  const float s_rho_l = 1.0f / L[0];
  const float vl0 = L[1] * s_rho_l, vl1 = L[2] * s_rho_l, vl2 = L[3] * s_rho_l;
  const float s_rho_r = 1.0f / R[0];
  const float vr0 = R[1] * s_rho_r, vr1 = R[2] * s_rho_r, vr2 = R[3] * s_rho_r;
  const float vel2s2_l = 0.5f * (vl0 * vl0 + vl1 * vl1 + vl2 * vl2);
  const float vel2s2_r = 0.5f * (vr0 * vr0 + vr1 * vr1 + vr2 * vr2);
  const float p_l = k.km1 * (L[4] - L[0] * vel2s2_l);
  const float p_r = k.km1 * (R[4] - R[0] * vel2s2_r);
  const float beta_l = 0.5f * L[0] / p_l;
  const float beta_r = 0.5f * R[0] / p_r;
  const float rho_mean = 0.5f * (L[0] + R[0]);
  const float rho_hat = ln_mean(L[0], R[0]);
  const float beta_mean = 0.5f * (beta_l + beta_r);
  const float beta_hat = ln_mean(beta_l, beta_r);
  const float uh = 0.5f * (vl0 + vr0);
  const float vh = 0.5f * (vl1 + vr1);
  const float wh = 0.5f * (vl2 + vr2);
  const float ah = sqrtf(k.half_gamma * (p_l + p_r) / rho_hat);
  const float hh = k.gamma / (k.two_km1 * beta_hat) +
                   0.5f * (vl0 * vr0 + vl1 * vr1 + vl2 * vr2);
  const float p1h = 0.5f * rho_mean / beta_mean;
  const float vel2_m = vel2s2_l + vel2s2_r;
  const float f0 = rho_hat * uh;
  const float f1 = f0 * uh + p1h;
  const float f2 = f0 * vh;
  const float f3 = f0 * wh;
  const float f4 = f0 * 0.5f * (1.0f / (k.km1 * beta_hat) - vel2_m) + uh * f1 +
                   vh * f2 + wh * f3;

  // the dissipation R diag(D) R^T [[v]]
  const float d0 = 0.5f * fabsf(uh - ah) * rho_hat / k.gamma;
  const float d1 = fabsf(uh) * k.km1_over_g * rho_hat;
  const float d2 = fabsf(uh) * p1h;
  const float d3 = d2;
  const float d4 = 0.5f * fabsf(uh + ah) * rho_hat / k.gamma;
  float el[5], er[5], dv[5];
  entropy_variables(L, k, el);
  entropy_variables(R, k, er);
#pragma unroll
  for (int r = 0; r < 5; ++r) dv[r] = er[r] - el[r];
  const float ek = 0.5f * (uh * uh + vh * vh + wh * wh);
  const float w0 = dv[0] + (uh - ah) * dv[1] + vh * dv[2] + wh * dv[3] +
                   (hh - uh * ah) * dv[4];
  const float w1 = dv[0] + uh * dv[1] + vh * dv[2] + wh * dv[3] + ek * dv[4];
  const float w2 = dv[2] + vh * dv[4];
  const float w3 = dv[3] + wh * dv[4];
  const float w4 = dv[0] + (uh + ah) * dv[1] + vh * dv[2] + wh * dv[3] +
                   (hh + uh * ah) * dv[4];
  const float g0 = d0 * w0, g1 = d1 * w1, g2 = d2 * w2, g3 = d3 * w3,
              g4 = d4 * w4;
  const float diss0 = g0 + g1 + g4;
  const float diss1 = (uh - ah) * g0 + uh * g1 + (uh + ah) * g4;
  const float diss2 = vh * g0 + vh * g1 + g2 + vh * g4;
  const float diss3 = wh * g0 + wh * g1 + g3 + wh * g4;
  const float diss4 = (hh - uh * ah) * g0 + ek * g1 + vh * g2 + wh * g3 +
                      (hh + uh * ah) * g4;
  f[0] = f0 - 0.5f * diss0;
  f[1] = f1 - 0.5f * diss1;
  f[2] = f2 - 0.5f * diss2;
  f[3] = f3 - 0.5f * diss3;
  f[4] = f4 - 0.5f * diss4;
  return fabsf(uh) + ah;
}

// The state-form flux on staged states: a cell's five state rows, rotated
// into the +A face frame for each face.
struct StateForm {
  static constexpr int RIN = 5, RS = 5, RD = 5;
  using Params = Consts;
  struct Cell {
    float s[5];
  };

  __device__ static __forceinline__ void convert(const float* r, float s[5],
                                                 const Consts&) {
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = r[i];
  }

  template <int A>
  __device__ static __forceinline__ Cell cell(const float s[5], const Consts&) {
    Cell q;
#pragma unroll
    for (int i = 0; i < 5; ++i) q.s[i] = s[t8pencil::frame_row(A, i)];
    return q;
  }

  template <int A>
  __device__ static __forceinline__ float flux(const Cell& L, const Cell& R,
                                               float, const Consts& k, float f[5]) {
    float fr[5];
    const float sp = kepes_es_flux(L.s, R.s, k, fr);
#pragma unroll
    for (int i = 0; i < 5; ++i) f[t8pencil::frame_row(A, i)] = fr[i];
    return sp;
  }
};

// A block: 512 threads, two per pencil (each pencil walked in two
// segments), of a slab of PL planes along axis 0 (2 at 3D extent 16, else
// the whole element) of as many elements as that leaves (8 at 3D extent
// 16); one block per SM.
__host__ __device__ constexpr int slab_planes(int dim, int ext) {
  return dim == 3 && ext == 16 ? 2 : ext;
}

template <int DIM, int EXT>
using InnerBlock = t8pencil::Block<
    256 * EXT / (slab_planes(DIM, EXT) * t8pencil::ipow(EXT, DIM - 1)), 2, 1>;

template <int DIM, int EXT>
using InnerTile = t8pencil::Tile<5, DIM, EXT, InnerBlock<DIM, EXT>,
                                 slab_planes(DIM, EXT), 5>;

template <int DIM, int EXT>
__global__ void __launch_bounds__(InnerTile<DIM, EXT>::THREADS,
                                  InnerBlock<DIM, EXT>::MIN_BLOCKS)
    inner_divergence_kernel(const float* __restrict__ u,
                            const float* __restrict__ surf,
                            float* __restrict__ D_out,
                            unsigned int* __restrict__ speed, int E,
                            Consts k) {
  using Tl = InnerTile<DIM, EXT>;
  using t8pencil::End;
  constexpr int TE = Tl::TE;
  constexpr int NSLAB = EXT / slab_planes(DIM, EXT);
  constexpr int T0 = t8pencil::ipow(EXT, DIM - 1);  // cells of a plane
  static_assert(Tl::THREADS % 32 == 0, "whole warps");
  extern __shared__ float smem[];
  float* st = smem;             // staged states
  float* sd = st + Tl::TILE;    // divergence
  float* red = sd + Tl::DTILE;  // per-warp speeds

  const int x = threadIdx.x, y = threadIdx.y;
  const int slab = blockIdx.x % NSLAB;
  const int e0 = (blockIdx.x / NSLAB) * TE;
  const int e = e0 + x;
  const bool live = e < E;
  const long long Es = E;
  const long long rs = (long long)t8pencil::ipow(EXT, DIM) * Es;
  const int cbase = slab * Tl::B;  // the slab's first cell in the element

  t8pencil::load_cells<Tl, Tl::B, 5>(
      e0, E,
      [&](int c, int ee, float* v) {
#pragma unroll
        for (int r = 0; r < 5; ++r) v[r] = __ldg(u + r * rs + (long long)(cbase + c) * Es + ee);
      },
      [&](int c, int, int cx, const float* v) {
#pragma unroll
        for (int r = 0; r < 5; ++r) st[Tl::at(r, c, cx)] = v[r];
      });
  __syncthreads();

  float spd = 0.0f;
  const float surface = live ? __ldg(surf + e) : 0.0f;
  // axis 0: pencil t is cell t of each plane of the slab; its neighbours
  // are the planes beyond the slab's ends, where the element has them
  auto planes = [&](int t, End& lo, End& hi) {
    const float* cell = u + (long long)(cbase + t) * Es + e;
    lo = slab > 0 ? End{cell - T0 * Es, rs, surface, 1.0f} : End{nullptr, 0, 0.0f, 0.0f};
    hi = slab < NSLAB - 1 ? End{cell + Tl::B * Es, rs, surface, 1.0f}
                          : End{nullptr, 0, 0.0f, 0.0f};
  };
  auto none = [](int, End& lo, End& hi) { lo = hi = End{nullptr, 0, 0.0f, 0.0f}; };
  if (live)
    t8pencil::walk1_axis<StateForm, Tl, DIM, EXT, 0>(st, sd, x, y, planes, surface,
                                                     1.0f, 0.0f, k, spd);
  __syncthreads();
  if (live)
    t8pencil::walk1_axis<StateForm, Tl, DIM, EXT, 1>(st, sd, x, y, none, surface,
                                                     1.0f, 0.0f, k, spd);
  if constexpr (DIM == 3) {
    __syncthreads();
    if (live)
      t8pencil::walk1_axis<StateForm, Tl, DIM, EXT, 2>(st, sd, x, y, none, surface,
                                                       1.0f, 0.0f, k, spd);
  }
  __syncthreads();
  t8pencil::for_cells<Tl, Tl::B>(e0, E, [&](int c, int ee, int cx) {
    const long long off = (long long)(cbase + c) * Es + ee;
#pragma unroll
    for (int r = 0; r < 5; ++r) D_out[r * rs + off] = sd[Tl::at(r, c, cx)];
  });

  // the block's max over its live elements: a max across each warp, then
  // one atomicMax on the bits of a non-negative float (order-free); a NaN
  // propagates
  float m = surface > 0.0f ? spd : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = t8pencil::nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int tid = y * TE + x;
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    for (int j = 1; j < Tl::THREADS / 32; ++j) m = t8pencil::nan_max(m, red[j]);
    m = (m > 0.0f || m != m) ? m : 0.0f;  // +0 for zero and -0
    atomicMax(speed, __float_as_uint(m));
  }
}

// Call fn.template run<DIM, EXT>() for the case; cudaErrorInvalidValue
// for a case none takes.
template <class Fn>
int with_case(int dim, int ext, const Fn& fn) {
  if (dim == 3) {
    switch (ext) {
      case 2: return fn.template run<3, 2>();
      case 4: return fn.template run<3, 4>();
      case 8: return fn.template run<3, 8>();
      case 16: return fn.template run<3, 16>();
    }
  } else if (dim == 2) {
    switch (ext) {
      case 2: return fn.template run<2, 2>();
      case 4: return fn.template run<2, 4>();
      case 8: return fn.template run<2, 8>();
      case 16: return fn.template run<2, 16>();
    }
  }
  return (int)cudaErrorInvalidValue;
}

struct Launcher {
  int device;
  const float* u;
  const float* surf;
  float* D;
  unsigned int* speed;
  int E;
  const Consts& k;
  cudaStream_t stream;
  template <int DIM, int EXT>
  int run() const {
    using Tl = InnerTile<DIM, EXT>;
    auto kern = inner_divergence_kernel<DIM, EXT>;
    static bool raised[64] = {};
    const int err = t8pencil::raise_smem((const void*)kern, Tl::SMEM, device, raised);
    if (err != 0) return err;
    const dim3 block(Tl::TE, Tl::SLOTS);
    const dim3 grid((E + Tl::TE - 1) / Tl::TE * (EXT / slab_planes(DIM, EXT)));
    kern<<<grid, block, Tl::SMEM, stream>>>(u, surf, D, speed, E, k);
    return (int)cudaGetLastError();
  }
};

struct Attributes {
  int* out;
  template <int DIM, int EXT>
  int run() const {
    using Tl = InnerTile<DIM, EXT>;
    return t8pencil::kernel_attributes((const void*)inner_divergence_kernel<DIM, EXT>,
                                       Tl::THREADS, Tl::SMEM, out);
  }
};

}  // namespace

// Launch the interior divergence on `stream`.  speed must be one zero-filled
// uint32 (the float bits of the max).  Returns the cudaError_t of the
// launch (0 on success); never synchronizes.
extern "C" int t8_inner_divergence(int device, int dim, int ext, int E,
                                   const float* u, const float* surface,
                                   float* D, unsigned int* speed,
                                   double gamma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(gamma);
  return with_case(dim, ext, Launcher{device, u, surface, D, speed, E, k,
                                      static_cast<cudaStream_t>(stream)});
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel, into out[0..3].  Returns
// a cudaError_t.
extern "C" int t8_inner_divergence_attributes(int device, int dim, int ext,
                                              int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, Attributes{out});
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
