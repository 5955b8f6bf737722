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
// The kernels' code is in stage.cuh, which fused_rk_stage_viscous.cu
// and fused_rk_stage_gravity.cu instantiate with the Navier-Stokes
// divergence and the gravity source (mu > 0 or a gravity vector); this
// source instantiates the stage without them, the kernels of a launch
// with mu = 0 and no gravity.
//
// Built without --use_fast_math and with --fmad=false: IEEE division and
// sqrt, no contraction, as the plain PyTorch versions, which the kernels
// follow bit for bit.  torch divides by a Python scalar on CUDA as a
// product with the scalar's float reciprocal, so vent0's "/ (gamma - 1)"
// and the recovered energy's are that product here too.

#include "stage.cuh"

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
  return launch<INVISCID>(device, dim, ext, E, flux, logs != 0 ? LOGS : STATE,
                          u, up, w, o, x, out, speed, gamma, ca, cb, cc, {},
                          stream);
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
  return launch<INVISCID>(device, dim, ext, E, flux, FIELD_ROWS, q, up, w, o,
                          x, out, speed, gamma, ca, cb, cc, {}, stream);
}

// Registers, spilled (local) bytes per thread, threads per block and
// shared memory per block of the case's kernel (extras != 0: the
// instantiation with extras), into out[0..3].  Returns a cudaError_t.
extern "C" int t8_fused_rk_stage_attributes(int device, int dim, int ext,
                                            int flux, int logs, int share_prev,
                                            int extras, int* out) {
  return attributes<INVISCID>(device, dim, ext, flux, logs != 0 ? LOGS : STATE,
                              share_prev, extras, out);
}

// The same for the field-input stage's case.
extern "C" int t8_fused_rk_stage_fields_attributes(int device, int dim,
                                                   int ext, int flux,
                                                   int share_prev, int extras,
                                                   int* out) {
  return attributes<INVISCID>(device, dim, ext, flux, FIELD_ROWS, share_prev,
                              extras, out);
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
