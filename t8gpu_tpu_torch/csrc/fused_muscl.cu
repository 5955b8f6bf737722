// Second-order MUSCL flux divergence of the subgrid compressible-Euler
// scheme, fused into one kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fused_muscl_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:848, body _fused_muscl_kernel :827 and
// _tile_muscl_divergence :427).  Per element, cell i of a pencil along
// axis a, in the +a face frame:
//
//   s_i  = lim(u_i - u_{i-1}, u_{i+1} - u_i)      (lim: minmod or central)
//   uL_i = guard(u_i + s_i/2, u_i),  uR_i = guard(u_i - s_i/2, u_i)
//   F(i|i+1) = the interface flux from uL_i to uR_{i+1}: KEPES
//              (kepes_pair_flux of ops/euler.py, conserved or primitive
//              reconstruction) or, in conserved space, hll / hllc
//              (hll_fields_flux / hllc_fields_flux over cell_fields_tuple)
//   D_i  = (D_i + w(i-1|i) F(i-1|i)) - w(i|i+1) F(i|i+1),  axis 0 first
//   speed = per-element max wave speed over the masked interfaces
//
// The walk, the block-edge masks and the mesh-face reconstructions are
// muscl_pencil.cuh's, the hll and hllc fluxes euler_hll.cuh's (shared
// with the stage kernel); this file holds the rest of the Euler physics.
// The guard keeps the cell's own state where the reconstruction has rho
// <= 0 or p <= 0 (cons: p recomputed from the reconstruction; prim: two
// compares).  In prim space each cell and side-layer cell becomes (rho,
// v, p) by prim_rows once, in the unrotated row order, as it is staged.
//
// Bound on this card: at the flagship shape (DIM 3, EXT 8, E 4374) one
// launch must read u (44.8 MB), six side slabs (67.2 MB) and the weights,
// and write D (44.8 MB): ~157 MB, 47 us at 3.35 TB/s.  The necessary
// arithmetic (one pair flux, ~220 operations with two logs, four divides,
// a sqrt and a rsqrt, per interface, 7.6M interfaces; one reconstruction
// per cell and axis) is ~1.7 GFLOP, 25 us at the fp32 peak, so the bytes
// bound it.
//
// Design: a block owns TE elements and stages their states into shared
// memory once, converted once; one thread per pencil and axis walks
// positions -2..EXT+1 with a window of three states in registers,
// computing each slope and each guarded reconstruction once and each of
// the EXT+1 interfaces once.  D lives in a shared tile between axes, each
// cell touched by one thread per axis, and goes to device memory on the
// last axis.  No atomics: a block owns its elements, so each one's speed
// max is one store.  At 3D extent 8 a block holds 4 elements: 256
// threads, 93,184 bytes of shared memory, so that two blocks share an SM;
// 95 registers in conserved space, 90 in primitive space, no spills
// (sm_90a, CUDA 12.8).  8 elements (one 32-byte sector per cell row) fit
// one block per SM and ran slower, 2 and 3 elements slower still.  Every
// instantiation's resources: t8_fused_muscl_attributes (chip_smoke.py
// prints the timed ones).
//
// Built without --use_fast_math and with --fmad=false (IEEE division and
// sqrt, no contraction), so the kernel can follow its plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

#include <type_traits>

#include "euler_hll.cuh"
#include "muscl_pencil.cuh"

namespace {

// kepes_pair_fields / prim_pair_fields: (rho, v[3], p, rho/p, 1/rho, 1/p, ke)
struct Pair {
  float rho, v[3], p, rhop, irho, ip, ke;
};

// inv_rho: 1 / s[0]
template <bool PRIM>
__device__ __forceinline__ Pair pair_fields(const float s[5], float inv_rho,
                                            const Consts& k) {
  Pair q;
  q.rho = s[0];
  if (PRIM) {
    q.irho = inv_rho;
    q.ip = 1.0f / s[4];
    q.rhop = s[0] * q.ip;
    q.v[0] = s[1];
    q.v[1] = s[2];
    q.v[2] = s[3];
    q.ke = 0.5f * ((s[1] * s[1] + s[2] * s[2]) + s[3] * s[3]);
    q.p = s[4];
  } else {
    q.irho = inv_rho;
    q.v[0] = s[1] * q.irho;
    q.v[1] = s[2] * q.irho;
    q.v[2] = s[3] * q.irho;
    q.ke = 0.5f * ((q.v[0] * q.v[0] + q.v[1] * q.v[1]) + q.v[2] * q.v[2]);
    q.p = k.km1 * (s[4] - s[0] * q.ke);
    q.ip = 1.0f / q.p;
    q.rhop = s[0] * q.ip;
  }
  return q;
}

// KEPES pair flux (kepes_pair_flux of ops/euler.py) in the face frame: f in
// frame rows (rho, normal, t1, t2, energy).  Returns the wave speed.
__device__ __forceinline__ float kepes_pair_flux(const Pair& L, const Pair& R,
                                                 const Consts& k, float f[5]) {
  const float u_l = L.v[0], v_l = L.v[1], w_l = L.v[2];
  const float u_r = R.v[0], v_r = R.v[1], w_r = R.v[2];

  const float dlrho = logf(R.rho * L.irho);  // log(rho_r / rho_l)
  const float dlp = logf(R.p * L.ip);        // log(p_r / p_l)

  const float d_r = R.rho - L.rho;
  const float s_r = L.rho + R.rho;
  const float d_b = R.rhop - L.rhop;
  const float s_b = L.rhop + R.rhop;
  const float s_r2 = s_r * s_r;
  const float s_b2 = s_b * s_b;
  const float q2 = 1.0f / (s_r2 * s_b2);
  const float vsq_r = (d_r * d_r) * s_b2 * q2;
  const float vsq_b = (d_b * d_b) * s_r2 * q2;
  const bool c_r = vsq_r < 1.0e-4f;
  const bool c_b = vsq_b < 1.0e-4f;
  const float num_r = c_r ? s_r * 52.5f : d_r;
  const float den_r = c_r ? series_den(vsq_r) : dlrho;
  const float num_b = c_b ? s_b * 52.5f : d_b;
  const float den_b = c_b ? series_den(vsq_b) : dlrho - dlp;
  const float Q = 1.0f / (den_r * num_b * s_b);
  const float nbsb = num_b * s_b;
  const float rho_hat = num_r * nbsb * Q;
  const float inv_bh = (2.0f * den_b * den_r * s_b) * Q;
  const float p1_hat = s_r * den_r * num_b * Q;

  const float u_hat = 0.5f * (u_l + u_r);
  const float v_hat = 0.5f * (v_l + v_r);
  const float w_hat = 0.5f * (w_l + w_r);
  const float a_hat = sqrtf(k.half_gamma * (L.p + R.p)) * rsqrtf(rho_hat);
  const float h_hat = k.h_coef * inv_bh + 0.5f * (u_l * u_r + v_l * v_r + w_l * w_r);
  const float vel2_m = L.ke + R.ke;

  const float f0 = rho_hat * u_hat;
  const float f1 = f0 * u_hat + p1_hat;
  const float f2 = f0 * v_hat;
  const float f3 = f0 * w_hat;
  const float f4 = f0 * 0.5f * (k.inv_km1 * inv_bh - vel2_m) + u_hat * f1 +
                   v_hat * f2 + w_hat * f3;

  const float d0 = k.half_over_g * fabsf(u_hat - a_hat) * rho_hat;
  const float d1 = fabsf(u_hat) * k.km1_over_g * rho_hat;
  const float d2 = fabsf(u_hat) * p1_hat;
  const float d4 = k.half_over_g * fabsf(u_hat + a_hat) * rho_hat;

  const float dv0 = -(dlp - k.gamma * dlrho) * k.inv_km1 -
                    (R.rhop * R.ke - L.rhop * L.ke);
  const float dv1 = R.rhop * u_r - L.rhop * u_l;
  const float dv2 = R.rhop * v_r - L.rhop * v_l;
  const float dv3 = R.rhop * w_r - L.rhop * w_l;
  const float dv4 = -(R.rhop - L.rhop);

  const float ek = 0.5f * (u_hat * u_hat + v_hat * v_hat + w_hat * w_hat);
  const float w0 = dv0 + (u_hat - a_hat) * dv1 + v_hat * dv2 + w_hat * dv3 +
                   (h_hat - u_hat * a_hat) * dv4;
  const float w1 = dv0 + u_hat * dv1 + v_hat * dv2 + w_hat * dv3 + ek * dv4;
  const float w2 = dv2 + v_hat * dv4;
  const float w3 = dv3 + w_hat * dv4;
  const float w4 = dv0 + (u_hat + a_hat) * dv1 + v_hat * dv2 + w_hat * dv3 +
                   (h_hat + u_hat * a_hat) * dv4;

  const float g0 = d0 * w0, g1 = d1 * w1, g2 = d2 * w2, g3 = d2 * w3, g4 = d4 * w4;

  const float diss0 = g0 + g1 + g4;
  const float diss1 = (u_hat - a_hat) * g0 + u_hat * g1 + (u_hat + a_hat) * g4;
  const float diss2 = v_hat * (g0 + g1 + g4) + g2;
  const float diss3 = w_hat * (g0 + g1 + g4) + g3;
  const float diss4 = (h_hat - u_hat * a_hat) * g0 + ek * g1 + v_hat * g2 +
                      w_hat * g3 + (h_hat + u_hat * a_hat) * g4;

  f[0] = f0 - 0.5f * diss0;
  f[1] = f1 - 0.5f * diss1;
  f[2] = f2 - 0.5f * diss2;
  f[3] = f3 - 0.5f * diss3;
  f[4] = f4 - 0.5f * diss4;
  return fabsf(u_hat) + a_hat;
}

// The Euler physics of the pencil walk (muscl_pencil.cuh).
template <bool PRIM, bool POS, int FLUX>
struct Euler {
  static constexpr int R = 5;
  using Params = Consts;
  // a guarded reconstruction and its 1 / rho
  struct Face {
    float s[5];
    float inv_rho;
  };

  // prim_rows on the unrotated rows in prim space; nothing in cons space
  __device__ static __forceinline__ void convert(float r[5], const Consts& k) {
    if (!PRIM) return;
    const float inv_rho = 1.0f / r[0];
    const float v1 = r[1] * inv_rho, v2 = r[2] * inv_rho, v3 = r[3] * inv_rho;
    const float p = k.km1 * (r[4] - 0.5f * ((r[1] * v1 + r[2] * v2) + r[3] * v3));
    r[1] = v1;
    r[2] = v2;
    r[3] = v3;
    r[4] = p;
  }

  // guard(rec, base): keep base where rec has rho <= 0 or p <= 0.  In cons
  // space the guard's 1/rho is the flux fields' 1/rho of an admissible rec
  // (the same division), so it rides along.
  __device__ static __forceinline__ Face face(float rec[5], const float base[5],
                                              const Consts& k) {
    Face q;
    bool have_inv = false;
    bool ok = true;
    if (POS) {
      if (PRIM) {
        ok = (rec[0] > 0.0f) & (rec[4] > 0.0f);
      } else {
        q.inv_rho = 1.0f / rec[0];
        const float kinetic =
            0.5f * ((rec[1] * rec[1] + rec[2] * rec[2]) + rec[3] * rec[3]) * q.inv_rho;
        const float p = k.km1 * (rec[4] - kinetic);
        ok = (rec[0] > 0.0f) & (p > 0.0f);
        have_inv = ok;
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) q.s[i] = ok ? rec[i] : base[i];
    if (!have_inv) q.inv_rho = 1.0f / q.s[0];
    return q;
  }

  __device__ static __forceinline__ float flux(const Face& L, const Face& Rf,
                                               float, const Consts& k, float f[5]) {
    if constexpr (FLUX == KEPES) {
      return kepes_pair_flux(pair_fields<PRIM>(L.s, L.inv_rho, k),
                             pair_fields<PRIM>(Rf.s, Rf.inv_rho, k), k, f);
    } else {
      const HllFields a = hll_fields(L.s, L.inv_rho, k), b = hll_fields(Rf.s, Rf.inv_rho, k);
      return FLUX == HLL ? hll_flux(a, b, k, f) : hllc_flux(a, b, k, f);
    }
  }
};

// Elements per block: one pencil slot per tangent index, 256 threads.
__host__ __device__ constexpr int tile_elements(int dim, int ext) {
  return dim == 3 ? (ext == 8 ? 4 : 16) : (ext == 8 ? 32 : 64);
}

// Call fn.template run<Physics, DIM, EXT, Block, MINMOD>() for the
// instantiation of the case; cudaErrorInvalidValue for a case none takes.
template <class Fn>
int with_case(int dim, int ext, int flux, bool prim, bool minmod, bool pos, const Fn& fn) {
  auto by_shape = [&](auto physics) -> int {
    using P = decltype(physics);
    auto by_lim = [&](auto d, auto x) -> int {
      constexpr int D = decltype(d)::value, X = decltype(x)::value;
      using Blk = t8pencil::Block<tile_elements(D, X), 1, 1>;
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
  if (flux == KEPES) {
    if (prim)
      return pos ? by_shape(Euler<true, true, KEPES>{}) : by_shape(Euler<true, false, KEPES>{});
    return pos ? by_shape(Euler<false, true, KEPES>{}) : by_shape(Euler<false, false, KEPES>{});
  }
  if (prim) return (int)cudaErrorInvalidValue;  // hll/hllc: conserved space only
  if (flux == HLL)
    return pos ? by_shape(Euler<false, true, HLL>{}) : by_shape(Euler<false, false, HLL>{});
  if (flux == HLLC)
    return pos ? by_shape(Euler<false, true, HLLC>{}) : by_shape(Euler<false, false, HLLC>{});
  return (int)cudaErrorInvalidValue;
}

struct Launcher {
  int device;
  const t8pencil::Args& g;
  const Consts& k;
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

// Launch one MUSCL divergence on `stream`; speed [E] receives the uint32
// bits of each element's float max.  flux is 0 kepes, 1 hll, 2 hllc (hll and
// hllc with prim 0 only); prim / minmod / positivity are 0 or 1.  Returns
// the cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int t8_fused_muscl(int device, int dim, int ext, int E, int flux,
                              int prim, int minmod, int positivity,
                              const float* u, const float* w, const float* o0,
                              const float* o1, const float* o2,
                              const float* o3, const float* o4,
                              const float* o5, float* D, unsigned int* speed,
                              double gamma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const t8pencil::Args g{u, w, {o0, o1, o2, o3, o4, o5}, D, speed, E};
  const Consts k = make_consts(gamma);
  return with_case(dim, ext, flux, prim != 0, minmod != 0, positivity != 0,
                   Launcher{device, g, k, static_cast<cudaStream_t>(stream)});
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel, into out[0..3].  Returns
// a cudaError_t.
extern "C" int t8_fused_muscl_attributes(int device, int dim, int ext, int flux,
                                         int prim, int minmod, int positivity,
                                         int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, flux, prim != 0, minmod != 0, positivity != 0,
                   Attributes{out});
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
