// The SSP-RK stage of fused_rk_stage.cu on the state input (5 rows, or 7
// with the log rows) with the Navier-Stokes divergence, and the gravity
// source as a runtime switch, for NVIDIA Hopper (sm_90a).
//
// Replaces the viscous branch of fused_rk_stage_pallas
// (t8gpu_tpu/ops/pallas_kernels.py:1190; _tile_viscous_divergence :914,
// entered at :1127 and added at :1149-1152) and its gravity branch
// (:1160-1178):
//
//   D      = D_adv + D_visc, then the side extras in increasing side
//            order, then + S v_cell where gravity is on
//   out(c) = (ca u_prev(c) + cb u(c)) + (cc w[7]) D(c)
//
// D_visc is the compact normal derivatives, the mask-aware tangent
// centrals and the mesh faces' within-layer derivatives of the plain
// version, 1/h taken once.  Design (stage.cuh's viscous_walk): the TPU
// kernel's order, the fields once and both tile maths from them.  Its
// stencil reaches the planes on both sides of a cell and a mesh face
// reads the facing layer's in-plane neighbours, so a block takes whole
// elements: 4 at 3D extent 8, two threads per pencil, 512 threads, one
// block per SM (207,872 bytes of shared memory; at most 128 registers,
// the launch bound, no spills).  It stages each cell and each side-layer
// cell once, all of a thread's loads in flight at once, as its fields and
// T, the side layers' cells beside the tile's in each staged row; then it
// walks each axis once, and at each face evaluates the advective flux
// (walk1's) and the viscous flux from the same staged rows, into D_adv
// and D_visc kept apart in the plain version's orders and added on the
// last axis (the centrals' quotients by 2 or 1 taken as the exact
// products); then the physics stages' update.
//
// Bound on this card at the flagship shape (3, 8, 4374): the bytes of the
// inviscid stage plus the viscous weights' 8 E floats, ~123 MB (stage 1)
// or ~168 MB (stages 2-3), 37-50 us at 3.35 TB/s; the viscous arithmetic
// (chip_smoke.stage_cost) does not reach that at the fp32 peak.  What
// keeps it ~8x above: one block per SM leaves the staging loads and the
// update's memory traffic (short runs of 4 elements) with nothing to
// overlap them, about half the time, and the walk is issue- and
// latency-bound (PERF.md has the ablations).  Built with --fmad=false and
// IEEE division and sqrt, as the plain version
// (ops/kernels.fused_rk_stage_reference), which it follows bit for bit.

#include "stage.cuh"

// Launch one viscous stage on `stream`: t8_fused_rk_stage's arguments
// (fused_rk_stage.cu), then the viscous weights wv [8, E] (null for the
// gravity stage), mu and kappa, gravity != 0 to add the gravity source
// and its vector g.  Returns the cudaError_t of the launch.
extern "C" int t8_fused_rk_stage_viscous(
    int device, int dim, int ext, int E, int flux, int logs, const float* u,
    const float* up, const float* w, const float* o0, const float* o1,
    const float* o2, const float* o3, const float* o4, const float* o5,
    const float* x0, const float* x1, const float* x2, const float* x3,
    const float* x4, const float* x5, float* out, unsigned int* speed,
    double gamma, float ca, float cb, float cc, const float* wv, float mu,
    float kappa, int gravity, float gx, float gy, float gz, void* stream) {
  const float* const o[6] = {o0, o1, o2, o3, o4, o5};
  const float* const x[6] = {x0, x1, x2, x3, x4, x5};
  const Physics ph{wv, mu, kappa, gravity, {gx, gy, gz}};
  return launch<VISCOUS>(device, dim, ext, E, flux, logs != 0 ? LOGS : STATE, u,
                         up, w, o, x, out, speed, gamma, ca, cb, cc, ph,
                         stream);
}

// Registers, spilled bytes per thread, threads and shared memory per block
// of the case's viscous kernel, into out[0..3].  Returns a cudaError_t.
extern "C" int t8_fused_rk_stage_viscous_attributes(int device, int dim,
                                                    int ext, int flux,
                                                    int logs, int share_prev,
                                                    int extras, int* out) {
  return attributes<VISCOUS>(device, dim, ext, flux, logs != 0 ? LOGS : STATE,
                             share_prev, extras, out);
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
