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

fused_muscl — replaces fused_muscl_pallas
(t8gpu_tpu/ops/pallas_kernels.py:848): the order-2 MUSCL flux divergence
of the interior and equal-level mesh faces (per-axis minmod or unlimited
slopes, positivity guard, conserved or primitive reconstruction, KEPES
pair flux) and the per-element max wave speed.  Bound on an H100: the
bytes it must move, ~157 MB at the flagship shape (47 us at 3.35 TB/s).
The kernel is the simple one-thread-per-cell design that evaluates every
interface twice (csrc/fused_muscl.cu).
"""

from __future__ import annotations

import ctypes

import torch

from t8gpu_tpu_torch.ops.euler import (cell_fields_tuple, fields_axis_rotate,
                                       fields_flux, flux_axis_unrotate,
                                       kepes_pair_fields, kepes_pair_flux,
                                       prim_pair_fields, prim_rows)

KERNEL_DIMS = (2, 3)
KERNEL_EXTENTS = (4, 8)
MUSCL_LIMITERS = ("minmod", "none")
MUSCL_SPACES = ("cons", "prim")


def _stage_tensors(u_stage, u_prev, weights, others) -> list:
    return [u_stage, weights, *others] + ([] if u_prev is None else [u_prev])


def _check_block(u: torch.Tensor, name: str):
    """(dim, ext, E) of a block state [5, *(ext,)*dim, E]; raises
    ValueError on a shape no kernel takes."""
    dim = u.dim() - 2
    ext = u.shape[1]
    E = u.shape[-1]
    if dim not in KERNEL_DIMS or ext not in KERNEL_EXTENTS \
            or tuple(u.shape[1:-1]) != (ext,) * dim:
        raise ValueError(f"{name} must be [5, *(ext,)*dim, E] with dim in "
                         f"{KERNEL_DIMS} and ext in {KERNEL_EXTENTS}, got "
                         f"{tuple(u.shape)}")
    return dim, ext, E


def _check_sides(weights, others, rows: int, dim: int, ext: int, E: int):
    if tuple(weights.shape) != (8, E):
        raise ValueError(f"weights must be [8, {E}], got "
                         f"{tuple(weights.shape)}")
    lay = (rows,) + (ext,) * (dim - 1) + (E,)
    if len(others) != 2 * dim or any(tuple(o.shape) != lay for o in others):
        raise ValueError(f"others must be {2 * dim} side layers of shape "
                         f"{lay}, got {[tuple(o.shape) for o in others]}")


def _check_one_device_dtype(tensors, what: str):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs lie on several devices: {devices}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"{what} inputs have several dtypes: {dtypes}")


def _check_stage_shapes(u_stage, u_prev, weights, others, extras):
    """Raise ValueError on inputs no version of the stage takes.
    Returns (dim, ext, E)."""
    if extras:
        raise ValueError("hanging-face side extras are not ported yet")
    if u_stage.shape[0] != 5:
        raise ValueError(f"u_stage must have 5 state rows, got "
                         f"{tuple(u_stage.shape)} (the 7-row log input is "
                         "not ported)")
    dim, ext, E = _check_block(u_stage, "u_stage")
    if u_prev is not None and u_prev.shape != u_stage.shape:
        raise ValueError(f"u_prev {tuple(u_prev.shape)} != u_stage "
                         f"{tuple(u_stage.shape)}")
    _check_sides(weights, others, 5, dim, ext, E)
    _check_one_device_dtype(_stage_tensors(u_stage, u_prev, weights, others),
                            "stage")
    return dim, ext, E


def _check_cuda_tensors(tensors, flux: str, what: str):
    """Raise ValueError on what a CUDA kernel does not take: another flux
    than kepes, another dtype than float32, strided tensors."""
    if flux != "kepes":
        raise ValueError(f"the {what} kernel computes the kepes flux, not "
                         f"{flux!r}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"the {what} kernel is float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors")


def _check_kernel_inputs(u_stage, u_prev, weights, others, flux: str):
    """Raise ValueError on what the CUDA stage kernel does not take."""
    _check_cuda_tensors(_stage_tensors(u_stage, u_prev, weights, others),
                        flux, "stage")


def _library(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """Kernel library `name` (built at first use) with the C signature of
    its entry point declared: an undeclared ctypes argument is a 32-bit
    int and would cut a pointer."""
    from t8gpu_tpu_torch.ops import _build
    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.t8_cuda_error_string.argtypes = [ctypes.c_int]
        lib.t8_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on_error(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.t8_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


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
    _raise_on_error(lib, rc, "fused_rk_stage")
    fused_rk_stage.launches += 1
    return out, speed_bits.view(torch.float32)


fused_rk_stage.launches = 0


def _stage_library() -> ctypes.CDLL:
    """The stage kernel's library: device, dim, ext, E as int; every
    pointer and the stream as c_void_p; gamma double, coefficients float."""
    return _library("fused_rk_stage", "t8_fused_rk_stage",
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
                    + [ctypes.c_double] + [ctypes.c_float] * 3
                    + [ctypes.c_void_p])


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


def _check_muscl_inputs(u, weights, others, flux, limiter, space):
    """Raise ValueError on inputs no version of the MUSCL divergence
    takes.  Returns (dim, ext, E)."""
    if u.shape[0] != 5:
        raise ValueError(f"u must have 5 state rows, got {tuple(u.shape)}")
    dim, ext, E = _check_block(u, "u")
    _check_sides(weights, others, 10, dim, ext, E)
    _check_one_device_dtype([u, weights, *others], "MUSCL")
    if limiter not in MUSCL_LIMITERS:
        raise ValueError(f"unknown fused-MUSCL limiter {limiter!r}; "
                         f"expected one of {MUSCL_LIMITERS}")
    if space not in MUSCL_SPACES:
        raise ValueError(f"unknown reconstruction space {space!r}; "
                         f"expected one of {MUSCL_SPACES}")
    if space == "prim" and flux != "kepes":
        raise ValueError("primitive-space MUSCL ('<lim>-prim') supports the "
                         f"kepes flux, not {flux!r}")
    return dim, ext, E


def fused_muscl(u: torch.Tensor, weights: torch.Tensor, others, gamma: float,
                flux: str, limiter: str = "minmod", positivity: bool = True,
                space: str = "cons"):
    """Order-2 MUSCL flux divergence of the interior and equal-level mesh
    faces: (D [5, *(ext,)*dim, E], speed [E]), speed the per-element max
    interface wave speed.

    u: [5, *(ext,)*dim, E] states; weights [8, E] (row 0 the interior
    cell-face area, rows 1+k side k's equal-level face weight, whose
    sign is also the slope mask of the block edge); others: 2*dim side
    slabs [10, *(ext,)*(dim-1), E], rows 0-4 the equal-level neighbour's
    facing layer and rows 5-9 its second layer, side k = 2*axis + (0 hi,
    1 lo).  Hanging faces and walls are the caller's first-order closure.
    CUDA tensors launch the kernel, CPU tensors run fused_muscl_reference."""
    dim, ext, E = _check_muscl_inputs(u, weights, others, flux, limiter,
                                      space)
    dev = u.device
    if dev.type == "cpu":
        return fused_muscl_reference(u, weights, others, gamma=gamma,
                                     flux=flux, limiter=limiter,
                                     positivity=positivity, space=space)
    if dev.type != "cuda":
        raise ValueError(f"no MUSCL kernel for device {dev}")
    _check_cuda_tensors([u, weights, *others], flux, "MUSCL")

    lib = _muscl_library()
    D = torch.empty_like(u)
    speed_bits = torch.zeros(E, dtype=torch.int32, device=dev)
    sides = [o.data_ptr() for o in others] + [None] * (6 - len(others))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.t8_fused_muscl(
            dev.index, dim, ext, E, int(space == "prim"),
            int(limiter == "minmod"), int(bool(positivity)), u.data_ptr(),
            weights.data_ptr(), *sides, D.data_ptr(), speed_bits.data_ptr(),
            float(gamma), stream)
    _raise_on_error(lib, rc, "fused_muscl")
    fused_muscl.launches += 1
    return D, speed_bits.view(torch.float32)


fused_muscl.launches = 0


def _muscl_library() -> ctypes.CDLL:
    """The MUSCL kernel's library: device, dim, ext, E, prim, minmod,
    positivity as int; every pointer and the stream as c_void_p; gamma
    double."""
    return _library("fused_muscl", "t8_fused_muscl",
                    [ctypes.c_int] * 7 + [ctypes.c_void_p] * 10
                    + [ctypes.c_double, ctypes.c_void_p])


def _minmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minmod slope limiter: 0 at sign changes, the smaller-magnitude
    one-sided difference otherwise."""
    return torch.where(a * b > 0.0,
                       torch.sign(a) * torch.minimum(torch.abs(a), torch.abs(b)),
                       torch.zeros_like(a))


def _central(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unlimited central slope.  Where one difference is masked to zero (a
    wall or dead side) it keeps half the other one."""
    return 0.5 * (a + b)


def fused_muscl_reference(u: torch.Tensor, weights: torch.Tensor, others,
                          gamma: float, flux: str, limiter: str = "minmod",
                          positivity: bool = True, space: str = "cons"):
    """Plain PyTorch version of the MUSCL divergence: the tile math of the
    TPU kernel (_tile_muscl_divergence) over the whole element axis, for
    kepes in conserved or primitive space and for hll/hllc in conserved
    space.  Same signature and result as fused_muscl; runs on any device
    and dtype."""
    _check_muscl_inputs(u, weights, others, flux, limiter, space)
    dim = u.dim() - 2
    ext = u.shape[1]
    dtype, device = u.dtype, u.device
    blk = tuple(u.shape[1:])
    lim = _minmod if limiter == "minmod" else _central
    prim = space == "prim"
    kappa_m1 = gamma - 1.0

    rows = tuple(u[i] for i in range(5))
    if prim:
        # prim_rows once per cell and side-layer cell, before the rotation
        rows = prim_rows(rows, gamma)

        def cvt(t):
            return prim_rows(t, gamma)

        def iface(l_states, r_states):
            return kepes_pair_flux(prim_pair_fields(l_states),
                                   prim_pair_fields(r_states), gamma)
    else:
        def cvt(t):
            return t

        if flux == "kepes":
            def iface(l_states, r_states):
                return kepes_pair_flux(kepes_pair_fields(l_states, gamma),
                                       kepes_pair_fields(r_states, gamma),
                                       gamma)
        else:
            def iface(l_states, r_states):
                return fields_flux(cell_fields_tuple(l_states, gamma, flux),
                                   cell_fields_tuple(r_states, gamma, flux),
                                   gamma=gamma, flux=flux)

    def guard(rec, base):
        """Keep the cell's own state where the reconstruction is not
        admissible (rho <= 0 or p <= 0)."""
        if not positivity:
            return rec
        if prim:
            ok = (rec[0] > 0.0) & (rec[4] > 0.0)
        else:
            rho, m1, m2, m3, e = rec
            s_rho = 1.0 / rho
            kinetic = 0.5 * (m1 * m1 + m2 * m2 + m3 * m3) * s_rho
            p = kappa_m1 * (e - kinetic)
            ok = (rho > 0.0) & (p > 0.0)
        return tuple(torch.where(ok, r, b) for r, b in zip(rec, base))

    surface = weights[0]
    interior_ok = (surface > 0).to(dtype)
    D = torch.zeros((5,) + blk, dtype=dtype, device=device)
    speed = torch.zeros(blk, dtype=dtype, device=device)

    for a in range(dim):
        va = fields_axis_rotate(rows, a)
        o_hi, o_lo = others[2 * a], others[2 * a + 1]

        def side(o, first):
            return fields_axis_rotate(
                cvt(tuple(o[first + i] for i in range(5))), a)
        nb0_hi, nb1_hi = side(o_hi, 0), side(o_hi, 5)
        nb0_lo, nb1_lo = side(o_lo, 0), side(o_lo, 5)
        w_hi = weights[1 + 2 * a]
        w_lo = weights[2 + 2 * a]
        eq_hi = (w_hi > 0).to(dtype)
        eq_lo = (w_lo > 0).to(dtype)
        idx = torch.arange(ext, device=device).view(
            (ext,) + (1,) * (dim - a))           # broadcasts along axis a
        at_end = idx == ext - 1
        at_lo = idx == 0

        def shift_next(r, h):
            return torch.cat([r.narrow(a, 1, ext - 1), h.unsqueeze(a)], dim=a)

        def shift_prev(r, h):
            return torch.cat([h.unsqueeze(a), r.narrow(a, 0, ext - 1)], dim=a)

        # one-sided differences per cell; the outward ones at the block
        # edge come from the neighbour layer, masked by the face weight
        slope = []
        for r, h0, l0 in zip(va, nb0_hi, nb0_lo):
            dh = shift_next(r, h0) - r
            dh = torch.where(at_end, dh * eq_hi, dh)
            dl = r - shift_prev(r, l0)
            dl = torch.where(at_lo, dl * eq_lo, dl)
            slope.append(lim(dl, dh))

        u_l_t = guard(tuple(r + 0.5 * s for r, s in zip(va, slope)), va)
        u_r_t = guard(tuple(r - 0.5 * s for r, s in zip(va, slope)), va)

        # the neighbours' edge-cell reconstructions toward us, from the
        # same four layers both elements see (exact conservation)
        my_hi = tuple(r.select(a, ext - 1) for r in va)
        my_lo = tuple(r.select(a, 0) for r in va)
        s_nbr_hi = tuple(lim(h0 - m, h1 - h0)
                         for m, h0, h1 in zip(my_hi, nb0_hi, nb1_hi))
        s_nbr_lo = tuple(lim(l0 - l1, m - l0)
                         for m, l0, l1 in zip(my_lo, nb0_lo, nb1_lo))
        hi_sub = guard(tuple(h0 - 0.5 * s
                             for h0, s in zip(nb0_hi, s_nbr_hi)), nb0_hi)
        lo_sub = guard(tuple(l0 + 0.5 * s
                             for l0, s in zip(nb0_lo, s_nbr_lo)), nb0_lo)

        # interior and hi mesh-face interfaces in one evaluation
        nxt = tuple(shift_next(r, h) for r, h in zip(u_r_t, hi_sub))
        f, sp = iface(u_l_t, nxt)
        wgt = torch.where(at_end, w_hi, surface)
        f = flux_axis_unrotate(f, a) * wgt
        sp_ok = torch.where(at_end, (w_hi > 0).to(dtype), interior_ok)
        speed = torch.maximum(speed, sp * sp_ok)

        # low-side mesh face of the first slot
        u_rf0 = tuple(r.narrow(a, 0, 1) for r in u_r_t)
        lo_e = tuple(h.unsqueeze(a) for h in lo_sub)
        f_lo, sp_lo = iface(lo_e, u_rf0)
        f_lo = flux_axis_unrotate(f_lo, a) * w_lo
        speed = torch.maximum(
            speed, torch.where(at_lo, sp_lo * (w_lo > 0), 0.0).to(dtype))

        # divergence: D[c] += f[c-1] - f[c]; f[-1] is the low-side flux
        prev = torch.cat([f_lo, f.narrow(1 + a, 0, ext - 1)], dim=1 + a)
        D = D + prev - f

    return D, speed.amax(dim=tuple(range(dim)))
