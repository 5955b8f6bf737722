// The SSP-RK stage of fused_rk_stage.cu on the state input with the
// gravity source, for NVIDIA Hopper (sm_90a): the gravity branch of
// fused_rk_stage_pallas (t8gpu_tpu/ops/pallas_kernels.py:1160-1178) for
// mu = 0.  The update pass adds S v_cell after the side extras, S = (0,
// rho g, m . g) (the rows of a zero component zero), v_cell = s s (2D) or
// s sqrt(s) (3D) from the interior face area s = w[0], 0 on guard slots.
// The walk and its tiles are the inviscid stage's (stage.cuh); a launch
// without gravity runs fused_rk_stage.cu's kernels, which have no gravity
// code.  Bound: the inviscid stage's bytes.

#include "stage.cuh"

// Launch one gravity stage on `stream`: t8_fused_rk_stage's arguments
// (fused_rk_stage.cu), then the viscous weights wv [8, E] (null for the
// gravity stage), mu and kappa, gravity != 0 to add the gravity source
// and its vector g.  Returns the cudaError_t of the launch.
extern "C" int t8_fused_rk_stage_gravity(
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
  return launch<GRAVITY>(device, dim, ext, E, flux, logs != 0 ? LOGS : STATE, u,
                         up, w, o, x, out, speed, gamma, ca, cb, cc, ph,
                         stream);
}

// Registers, spilled bytes per thread, threads and shared memory per block
// of the case's gravity kernel, into out[0..3].  Returns a cudaError_t.
extern "C" int t8_fused_rk_stage_gravity_attributes(int device, int dim,
                                                    int ext, int flux,
                                                    int logs, int share_prev,
                                                    int extras, int* out) {
  return attributes<GRAVITY>(device, dim, ext, flux, logs != 0 ? LOGS : STATE,
                             share_prev, extras, out);
}

extern "C" const char* t8_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
