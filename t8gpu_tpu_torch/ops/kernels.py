"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Counterpart of t8gpu_tpu/ops/pallas_kernels.py.  Each wrapper launches
its kernel for CUDA tensors and runs the plain version only for tensors
that lie on the CPU; for a CUDA input the kernel does not take it raises
ValueError, never falls back.  Each wrapper counts its launches in a
plain integer attribute (`fused_rk_stage.launches`).

fused_rk_stage — replaces fused_rk_stage_pallas
(t8gpu_tpu/ops/pallas_kernels.py:1190): one whole SSP-RK stage per
element (cell fields, KEPES interface fluxes, weighted divergence, stage
update, per-element max wave speed) in one pass over the state.  Bound on
an H100: the bytes it must move, ~123 MB for stage 1 and ~168 MB for
stages 2-3 at the flagship shape (37-50 us at 3.35 TB/s).  The kernel is
the simple one-thread-per-cell design that evaluates every interface
twice (csrc/fused_rk_stage.cu has the details and PERF.md its times).
"""

from __future__ import annotations

import ctypes

import torch

from t8gpu_tpu_torch.ops.euler import (cell_fields_tuple, fields_axis_rotate,
                                       fields_flux, flux_axis_unrotate)

KERNEL_DIMS = (2, 3)
KERNEL_EXTENTS = (4, 8)


def _stage_tensors(u_stage, u_prev, weights, others) -> list:
    return [u_stage, weights, *others] + ([] if u_prev is None else [u_prev])


def _check_stage_shapes(u_stage, u_prev, weights, others, extras):
    """Raise ValueError on inputs no version of the stage takes.
    Returns (dim, ext, E)."""
    if extras:
        raise ValueError("hanging-face side extras are not ported yet")
    if u_stage.shape[0] != 5:
        raise ValueError(f"u_stage must have 5 state rows, got "
                         f"{tuple(u_stage.shape)} (the 7-row log input is "
                         "not ported)")
    dim = u_stage.dim() - 2
    ext = u_stage.shape[1]
    E = u_stage.shape[-1]
    if dim not in KERNEL_DIMS or ext not in KERNEL_EXTENTS \
            or tuple(u_stage.shape[1:-1]) != (ext,) * dim:
        raise ValueError(f"u_stage must be [5, *(ext,)*dim, E] with dim in "
                         f"{KERNEL_DIMS} and ext in {KERNEL_EXTENTS}, got "
                         f"{tuple(u_stage.shape)}")
    if u_prev is not None and u_prev.shape != u_stage.shape:
        raise ValueError(f"u_prev {tuple(u_prev.shape)} != u_stage "
                         f"{tuple(u_stage.shape)}")
    if tuple(weights.shape) != (8, E):
        raise ValueError(f"weights must be [8, {E}], got "
                         f"{tuple(weights.shape)}")
    lay = (5,) + (ext,) * (dim - 1) + (E,)
    if len(others) != 2 * dim or any(tuple(o.shape) != lay for o in others):
        raise ValueError(f"others must be {2 * dim} side layers of shape "
                         f"{lay}, got {[tuple(o.shape) for o in others]}")
    tensors = _stage_tensors(u_stage, u_prev, weights, others)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"stage inputs lie on several devices: {devices}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"stage inputs have several dtypes: {dtypes}")
    return dim, ext, E


def _check_kernel_inputs(u_stage, u_prev, weights, others, flux: str):
    """Raise ValueError on what the CUDA kernel does not take."""
    if flux != "kepes":
        raise ValueError(f"the stage kernel computes the kepes flux, not "
                         f"{flux!r}")
    for t in _stage_tensors(u_stage, u_prev, weights, others):
        if t.dtype != torch.float32:
            raise ValueError(f"the stage kernel is float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the stage kernel takes contiguous tensors")


def fused_rk_stage(u_stage: torch.Tensor, u_prev, weights: torch.Tensor,
                   others, gamma: float, flux: str, coeffs, extras=()):
    """One SSP-RK stage: (u_next, speed) with
    u_next = a*u_prev + b*u_stage + c*w[7]*D(u_stage) and speed [E] the
    per-element max interface wave speed.

    u_stage, u_prev: [5, *(ext,)*dim, E] (u_prev None means u_stage, the
    first stage); weights [8, E] (row 0 interior cell-face area, rows
    1+k side k's face weight, row 7 = dt * inv_cell_volume); others:
    2*dim side layers [5, *(ext,)*(dim-1), E], side k = 2*axis + (0 hi,
    1 lo).  CUDA tensors launch the kernel, CPU tensors run
    fused_rk_stage_reference."""
    dim, ext, E = _check_stage_shapes(u_stage, u_prev, weights, others,
                                      extras)
    dev = u_stage.device
    if dev.type == "cpu":
        return fused_rk_stage_reference(u_stage, u_prev, weights, others,
                                        gamma=gamma, flux=flux, coeffs=coeffs)
    if dev.type != "cuda":
        raise ValueError(f"no stage kernel for device {dev}")
    _check_kernel_inputs(u_stage, u_prev, weights, others, flux)

    lib = _stage_library()
    out = torch.empty_like(u_stage)
    speed_bits = torch.zeros(E, dtype=torch.int32, device=dev)
    sides = [o.data_ptr() for o in others] + [None] * (6 - len(others))
    a_c, b_c, c_c = (float(x) for x in coeffs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t8_fused_rk_stage(
            dev.index, dim, ext, E, u_stage.data_ptr(),
            None if u_prev is None else u_prev.data_ptr(),
            weights.data_ptr(), *sides, out.data_ptr(),
            speed_bits.data_ptr(), float(gamma), a_c, b_c, c_c, stream)
    if rc != 0:
        msg = lib.t8_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_rk_stage launch failed: {msg} ({rc})")
    fused_rk_stage.launches += 1
    return out, speed_bits.view(torch.float32)


fused_rk_stage.launches = 0


def _stage_library() -> ctypes.CDLL:
    """The stage kernel's library (built at first use) with its C
    signatures declared: every pointer and the stream as c_void_p."""
    from t8gpu_tpu_torch.ops import _build
    lib = _build.load("fused_rk_stage")
    fn = lib.t8_fused_rk_stage
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
                       + [ctypes.c_double] + [ctypes.c_float] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.t8_cuda_error_string.argtypes = [ctypes.c_int]
        lib.t8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_rk_stage_reference(u_stage: torch.Tensor, u_prev,
                             weights: torch.Tensor, others, gamma: float,
                             flux: str, coeffs):
    """Plain PyTorch version of the stage: the tile math of the TPU
    kernel (_fused_rk_kernel / _tile_flux_divergence) over the whole
    element axis, for kepes, hll and hllc.  Same signature and result as
    fused_rk_stage; runs on any device and dtype."""
    dim = u_stage.dim() - 2
    ext = u_stage.shape[1]
    dtype = u_stage.dtype
    blk = tuple(u_stage.shape[1:])
    q = cell_fields_tuple(tuple(u_stage[i] for i in range(5)), gamma, flux)
    others_q = [cell_fields_tuple(tuple(o[i] for i in range(5)), gamma, flux)
                for o in others]
    surface = weights[0]
    interior_ok = (surface > 0).to(dtype)
    D = torch.zeros((5,) + blk, dtype=dtype, device=u_stage.device)
    speed = torch.zeros(blk, dtype=dtype, device=u_stage.device)

    for a in range(dim):
        qa = fields_axis_rotate(q, a)
        hi = fields_axis_rotate(others_q[2 * a], a)
        lo = fields_axis_rotate(others_q[2 * a + 1], a)
        w_hi = weights[1 + 2 * a]
        w_lo = weights[2 + 2 * a]
        idx = torch.arange(ext, device=u_stage.device).view(
            (ext,) + (1,) * (dim - a))           # broadcasts along axis a
        at_end = idx == ext - 1

        # next state along a: shift by one, last slot <- hi side layer
        nxt = tuple(torch.cat([r.narrow(a, 1, ext - 1), h.unsqueeze(a)], dim=a)
                    for r, h in zip(qa, hi))
        f, sp = fields_flux(qa, nxt, gamma=gamma, flux=flux)
        wgt = torch.where(at_end, w_hi, surface)
        f = flux_axis_unrotate(f, a) * wgt
        sp_ok = torch.where(at_end, (w_hi > 0).to(dtype), interior_ok)
        speed = torch.maximum(speed, sp * sp_ok)

        # low-side mesh face of the first slot
        q0 = tuple(r.narrow(a, 0, 1) for r in qa)
        lo_e = tuple(h.unsqueeze(a) for h in lo)
        f_lo, sp_lo = fields_flux(lo_e, q0, gamma=gamma, flux=flux)
        f_lo = flux_axis_unrotate(f_lo, a) * w_lo
        speed = torch.maximum(
            speed, torch.where(idx == 0, sp_lo * (w_lo > 0), 0.0).to(dtype))

        # divergence: D[c] += f[c-1] - f[c]; f[-1] is the low-side flux
        prev = torch.cat([f_lo, f.narrow(1 + a, 0, ext - 1)], dim=1 + a)
        D = D + prev - f

    a_c, b_c, c_c = coeffs
    up = u_stage if u_prev is None else u_prev
    u_next = a_c * up + b_c * u_stage + c_c * weights[7] * D
    return u_next, speed.amax(dim=tuple(range(dim)))
