"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Counterpart of t8gpu_tpu/ops/pallas_kernels.py.  Each wrapper launches
its kernel for CUDA tensors and runs the plain version only for tensors
that lie on the CPU; for a CUDA input the kernel does not take it raises
ValueError, never falls back.  Each wrapper counts its launches in a
plain integer attribute (`fused_rk_stage.launches`).

fused_rk_stage — replaces fused_rk_stage_pallas
(t8gpu_tpu/ops/pallas_kernels.py:1190): one whole SSP-RK stage per
element (cell fields, kepes, hll or hllc interface fluxes, weighted
divergence, stage update, per-element max wave speed) in one pass over
the state.  Bound on an H100: the bytes it must move, ~123 MB for stage 1
and ~168 MB for stages 2-3 at the flagship shape (37-50 us at 3.35
TB/s).  The kernel is the first-order pencil walk of
csrc/muscl_pencil.cuh over slabs of elements in shared memory: each
cell's fields derived once, each interface evaluated once (once more at
a slab boundary; csrc/fused_rk_stage.cu has the details and PERF.md its
times).

fused_muscl — replaces fused_muscl_pallas
(t8gpu_tpu/ops/pallas_kernels.py:848): the order-2 MUSCL flux divergence
of the interior and equal-level mesh faces (per-axis minmod or unlimited
slopes, positivity guard, conserved or primitive reconstruction, KEPES
pair flux, or hll/hllc in conserved space) and the per-element max wave
speed.  Bound on an H100: the bytes it must move, ~157 MB at the flagship
shape (47 us at 3.35 TB/s).  The kernel stages a tile of elements in
shared memory and walks each pencil once per axis, so that every
interface is evaluated once (csrc/muscl_pencil.cuh, csrc/fused_muscl.cu).

fused_mhd_flux — replaces fused_mhd_flux_pallas
(t8gpu_tpu/ops/pallas_kernels.py:365): the first-order GLM-MHD flux
divergence (Rusanov with the exact 2x2 GLM interface solve, c_h read from
weight row 7) of the interior faces, the equal-level mesh faces and the
conductor walls (their ghosts ride in as side layers), and the
per-element max speed.  Bound on an H100: the bytes it must move, ~128
MB at the Orszag-Tang shape (38 us at 3.35 TB/s; csrc/fused_mhd_flux.cu).

fused_rk_stage with a 7-row u_stage — the "logs" stage input of the same
TPU kernel: rows 5-6 carry log rho and log p, computed once per cell
before the launch (ops/subgrid.append_log_rows), so the kernel derives
every field log-free.  Counted apart, in `fused_rk_stage.launches_logs`.

fused_flux — replaces fused_flux_pallas
(t8gpu_tpu/ops/pallas_kernels.py:193): the first-order flux divergence D
and the per-element max wave speed from precomputed cell-field rows (the
interior faces, the equal-level mesh faces and the walls, whose mirrored
field layers ride in as side layers).  fused_rk_stage_fields — replaces
fused_rk_stage_fields_pallas (:1329): the same divergence, the stage state
recovered from the field rows, and the stage update.  Both in
csrc/fused_fields.cu; bound: the bytes, ~202 MB (D) and ~246 MB (stages
2-3) at the flagship shape (60 and 74 us at 3.35 TB/s).

inner_divergence — replaces inner_divergence_pallas (:1425): the interior
faces' divergence of a 5-row state through the state-form KEPES flux (six
logs per face) at extents 2, 4, 8 and 16, and the scalar max wave speed of
the live elements: the same pencil walk over the interior faces, each
evaluated once, in slabs of 2 planes at 3D extent 16
(csrc/inner_divergence.cu).

fused_mhd_muscl — replaces fused_mhd_muscl_pallas
(t8gpu_tpu/ops/pallas_kernels.py:777): the order-2 GLM-MHD divergence of
the interior and equal-level faces (per-axis minmod or unlimited slopes,
the thermal-pressure positivity guard, the same Rusanov/GLM flux).  Bound:
the bytes, ~154 MB at the Orszag-Tang shape (46 us;
csrc/fused_mhd_muscl.cu): the pencil walk of fused_muscl on 9 rows.  The
first-order MHD kernel is a one-thread-per-cell design, as the
field-input kernels.
"""

from __future__ import annotations

import ctypes

import torch

from t8gpu_tpu_torch.models.mhd import N_ROWS as MHD_ROWS
from t8gpu_tpu_torch.models.mhd import (_rusanov_rows, axis_rotate9,
                                        axis_unrotate9)
from t8gpu_tpu_torch.ops.euler import (AXIS_ROTATE, N_FIELDS,
                                       cell_fields_tuple, fields_axis_rotate,
                                       fields_flux, flux_axis_unrotate,
                                       kepes_pair_fields, kepes_pair_flux,
                                       numerical_flux, prim_pair_fields,
                                       prim_rows)

KERNEL_DIMS = (2, 3)
KERNEL_EXTENTS = (4, 8)
INNER_EXTENTS = (2, 4, 8, 16)     # the inner-only kernel's block extents
MUSCL_LIMITERS = ("minmod", "none")
MUSCL_SPACES = ("cons", "prim")
# the fluxes of the stage and MUSCL kernels, by their index in the C entry
# points (MUSCL: hll/hllc in "cons" only; stage: the 7-row input kepes only)
CUDA_FLUXES = ("kepes", "hll", "hllc")


def _stage_tensors(u_stage, u_prev, weights, others) -> list:
    return [u_stage, weights, *others] + ([] if u_prev is None else [u_prev])


def _check_block(u: torch.Tensor, name: str, extents=KERNEL_EXTENTS):
    """(dim, ext, E) of a block state [C, *(ext,)*dim, E]; raises
    ValueError on a shape no kernel takes."""
    dim = u.dim() - 2
    ext = u.shape[1] if u.dim() > 1 else 0
    E = u.shape[-1]
    if dim not in KERNEL_DIMS or ext not in extents \
            or tuple(u.shape[1:-1]) != (ext,) * dim:
        raise ValueError(f"{name} must be [C, *(ext,)*dim, E] with dim in "
                         f"{KERNEL_DIMS} and ext in {extents}, got "
                         f"{tuple(u.shape)}")
    return dim, ext, E


def _check_rows(u: torch.Tensor, rows: int, name: str):
    if u.dim() < 1 or u.shape[0] != rows:
        raise ValueError(f"{name} must have {rows} state rows, got "
                         f"{tuple(u.shape)}")


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


def _check_stage_shapes(u_stage, u_prev, weights, others, extras, flux,
                        rows=(5, 7)):
    """Raise ValueError on inputs no version of the stage takes: u_stage
    with `rows` rows (7: the state and its log rho, log p rows, kepes
    only; a field stage: the flux's field rows), u_prev [5, ...].
    Returns (dim, ext, E)."""
    if extras:
        raise ValueError("hanging-face side extras are not ported yet")
    C = u_stage.shape[0] if u_stage.dim() else 0
    if C not in rows:
        raise ValueError(f"u_stage must have {' or '.join(map(str, rows))} "
                         f"rows, got {tuple(u_stage.shape)}")
    if C == 7 and flux != "kepes":
        raise ValueError(f"the 7-row log input is kepes only, not {flux!r}")
    dim, ext, E = _check_block(u_stage, "u_stage")
    if u_prev is not None and u_prev.shape != (5,) + u_stage.shape[1:]:
        raise ValueError(f"u_prev {tuple(u_prev.shape)} must be the "
                         f"5-row state of u_stage {tuple(u_stage.shape)}")
    _check_sides(weights, others, C, dim, ext, E)
    _check_one_device_dtype(_stage_tensors(u_stage, u_prev, weights, others),
                            "stage")
    return dim, ext, E


def _check_f32_contiguous(tensors, what: str):
    """Raise ValueError on what every CUDA kernel refuses: another dtype
    than float32, strided tensors."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"the {what} kernel is float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors")


def _check_cuda_tensors(tensors, flux: str, what: str, fluxes=("kepes",)):
    """Raise ValueError on what an Euler CUDA kernel does not take: a flux
    outside `fluxes` (kepes alone, but for the MUSCL kernel), another dtype
    than float32, strided tensors."""
    if flux not in fluxes:
        raise ValueError(f"the {what} kernel computes the "
                         f"{'/'.join(fluxes)} flux, not {flux!r}")
    _check_f32_contiguous(tensors, what)


def _check_kernel_inputs(u_stage, u_prev, weights, others, flux: str):
    """Raise ValueError on what the CUDA stage kernel does not take."""
    _check_cuda_tensors(_stage_tensors(u_stage, u_prev, weights, others),
                        flux, "stage", CUDA_FLUXES)


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


def _side_pointers(others) -> list:
    """The 2*dim side-layer pointers, padded with None to the six of the C
    entry points."""
    return [o.data_ptr() for o in others] + [None] * (6 - len(others))


def _speed_bits(E: int, dev, zero: bool = True) -> torch.Tensor:
    """[E] buffer for a kernel's per-element speed max: zero-filled for the
    kernels that take it by atomicMax on the bits of non-negative floats
    (the stage kernel's blocks each hold a slab of an element at 3D extent
    8), uninitialised (zero=False) for the MUSCL kernels, whose blocks own
    their elements and store each max once."""
    make = torch.zeros if zero else torch.empty
    return make(E, dtype=torch.int32, device=dev)


def _launch(lib, entry: str, dev, args, what: str):
    """Call the C entry point with the device index first and PyTorch's
    current stream last; raises on a refused launch."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(dev.index, *args, stream)
    _raise_on_error(lib, rc, what)


def _axis_update(D, speed, a: int, ext: int, unrotate, f, sp, f_lo, sp_lo,
                 surface, w_hi, w_lo, interior_ok):
    """D and the per-cell speed after axis a's interfaces, the shift
    structure of the TPU kernels' tiles: f/sp are the face-frame flux
    [C, *blk] and speed [*blk] of every cell's +a interface (the last
    cell's against the hi side), f_lo/sp_lo those of cell 0's -a mesh
    face.  Interior faces carry `surface`, the +a face of the last cell
    w_hi, the -a face of cell 0 w_lo; D[c] += f[c-1] - f[c]."""
    dtype = D.dtype
    idx = torch.arange(ext, device=D.device).view(
        (ext,) + (1,) * (D.dim() - 2 - a))       # broadcasts along axis a
    at_end = idx == ext - 1
    f = unrotate(f, a) * torch.where(at_end, w_hi, surface)
    sp_ok = torch.where(at_end, (w_hi > 0).to(dtype), interior_ok)
    speed = torch.maximum(speed, sp * sp_ok)
    f_lo = unrotate(f_lo, a) * w_lo
    speed = torch.maximum(
        speed, torch.where(idx == 0, sp_lo * (w_lo > 0), 0.0).to(dtype))
    prev = torch.cat([f_lo, f.narrow(1 + a, 0, ext - 1)], dim=1 + a)
    return D + prev - f, speed


def _shift_next(r, h, a: int, ext: int):
    """Rows of the next cell along a: shift by one, the last slot from the
    side layer h."""
    return torch.cat([r.narrow(a, 1, ext - 1), h.unsqueeze(a)], dim=a)


def _shift_prev(r, h, a: int, ext: int):
    """Rows of the previous cell along a, the first slot from h."""
    return torch.cat([h.unsqueeze(a), r.narrow(a, 0, ext - 1)], dim=a)


def _first_order_divergence(rows, sides, weights, n_rows: int, rotate,
                            unrotate, iface):
    """Plain first-order divergence of a block: rows a tuple of n_rows
    block rows [*blk]; sides 2*dim tuples of n_rows side-layer rows
    [*t_ext, E]; iface(l, r) -> (stacked face-frame flux, speed) on
    rotated row tuples.  Returns (D [n_rows, *blk], per-cell speed)."""
    dim = rows[0].dim() - 1
    ext = rows[0].shape[0]
    dtype, device = rows[0].dtype, rows[0].device
    blk = tuple(rows[0].shape)
    surface = weights[0]
    interior_ok = (surface > 0).to(dtype)
    D = torch.zeros((n_rows,) + blk, dtype=dtype, device=device)
    speed = torch.zeros(blk, dtype=dtype, device=device)
    for a in range(dim):
        qa = rotate(rows, a)
        hi = rotate(sides[2 * a], a)
        lo = rotate(sides[2 * a + 1], a)
        nxt = tuple(_shift_next(r, h, a, ext) for r, h in zip(qa, hi))
        f, sp = iface(qa, nxt)
        q0 = tuple(r.narrow(a, 0, 1) for r in qa)
        f_lo, sp_lo = iface(tuple(h.unsqueeze(a) for h in lo), q0)
        D, speed = _axis_update(D, speed, a, ext, unrotate, f, sp, f_lo,
                                sp_lo, surface, weights[1 + 2 * a],
                                weights[2 + 2 * a], interior_ok)
    return D, speed


def _muscl_divergence(rows, sides, weights, n_rows: int, rotate, unrotate,
                      iface, guard, lim):
    """Plain order-2 MUSCL divergence of the interior and equal-level
    faces of a block, row-generic: rows a tuple of n_rows block rows
    [*blk]; sides 2*dim pairs (facing, second) of n_rows side-layer row
    tuples, in the rows' space and unrotated; guard(rec, base) and
    iface(l, r) act on rotated row tuples; lim the slope limiter.
    Returns (D [n_rows, *blk], speed [E])."""
    dim = rows[0].dim() - 1
    ext = rows[0].shape[0]
    dtype, device = rows[0].dtype, rows[0].device
    blk = tuple(rows[0].shape)
    surface = weights[0]
    interior_ok = (surface > 0).to(dtype)
    D = torch.zeros((n_rows,) + blk, dtype=dtype, device=device)
    speed = torch.zeros(blk, dtype=dtype, device=device)

    for a in range(dim):
        va = rotate(rows, a)
        nb0_hi, nb1_hi = (rotate(t, a) for t in sides[2 * a])
        nb0_lo, nb1_lo = (rotate(t, a) for t in sides[2 * a + 1])
        w_hi = weights[1 + 2 * a]
        w_lo = weights[2 + 2 * a]
        eq_hi = (w_hi > 0).to(dtype)
        eq_lo = (w_lo > 0).to(dtype)
        idx = torch.arange(ext, device=device).view(
            (ext,) + (1,) * (dim - a))           # broadcasts along axis a
        at_end = idx == ext - 1
        at_lo = idx == 0

        # one-sided differences per cell; the outward ones at the block
        # edge come from the neighbour layer, masked by the face weight
        slope = []
        for r, h0, l0 in zip(va, nb0_hi, nb0_lo):
            dh = _shift_next(r, h0, a, ext) - r
            dh = torch.where(at_end, dh * eq_hi, dh)
            dl = r - _shift_prev(r, l0, a, ext)
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

        # interior and hi mesh-face interfaces in one evaluation, then the
        # low-side mesh face of the first slot
        nxt = tuple(_shift_next(r, h, a, ext) for r, h in zip(u_r_t, hi_sub))
        f, sp = iface(u_l_t, nxt)
        u_rf0 = tuple(r.narrow(a, 0, 1) for r in u_r_t)
        f_lo, sp_lo = iface(tuple(h.unsqueeze(a) for h in lo_sub), u_rf0)
        D, speed = _axis_update(D, speed, a, ext, unrotate, f, sp, f_lo,
                                sp_lo, surface, w_hi, w_lo, interior_ok)

    return D, speed.amax(dim=tuple(range(dim)))


def _rows(t: torch.Tensor, first: int = 0, n: int = 5) -> tuple:
    return tuple(t[first + i] for i in range(n))


# -- the RK-stage kernel -----------------------------------------------------


def fused_rk_stage(u_stage: torch.Tensor, u_prev, weights: torch.Tensor,
                   others, gamma: float, flux: str, coeffs, extras=()):
    """One SSP-RK stage: (u_next, speed) with
    u_next = a*u_prev + b*u_stage + c*w[7]*D(u_stage) and speed [E] the
    per-element max interface wave speed.

    u_stage: [5, *(ext,)*dim, E], or [7, ...] with rows 5-6 log rho and
    log p (the "logs" input, kepes: the fields are then derived
    log-free); flux "kepes", "hll" or "hllc"; u_prev: [5, ...] (None
    means the state rows of u_stage, the first stage); weights [8, E]
    (row 0 interior cell-face area, rows 1+k side k's face weight, row 7
    = dt * inv_cell_volume); others:
    2*dim side layers [5 or 7, *(ext,)*(dim-1), E] (as many rows as
    u_stage), side k = 2*axis + (0 hi, 1 lo).  CUDA tensors launch the
    kernel (a 7-row launch counts in `launches_logs`, a 5-row one in
    `launches`), CPU tensors run fused_rk_stage_reference."""
    dim, ext, E = _check_stage_shapes(u_stage, u_prev, weights, others,
                                      extras, flux)
    dev = u_stage.device
    if dev.type == "cpu":
        return fused_rk_stage_reference(u_stage, u_prev, weights, others,
                                        gamma=gamma, flux=flux, coeffs=coeffs)
    if dev.type != "cuda":
        raise ValueError(f"no stage kernel for device {dev}")
    _check_kernel_inputs(u_stage, u_prev, weights, others, flux)

    logs = u_stage.shape[0] == 7
    out = torch.empty((5,) + u_stage.shape[1:], dtype=u_stage.dtype,
                      device=dev)
    speed = _speed_bits(E, dev)
    a_c, b_c, c_c = (float(x) for x in coeffs)
    _launch(_stage_library(), "t8_fused_rk_stage", dev,
            [dim, ext, E, CUDA_FLUXES.index(flux), int(logs),
             u_stage.data_ptr(),
             None if u_prev is None else u_prev.data_ptr(),
             weights.data_ptr(), *_side_pointers(others), out.data_ptr(),
             speed.data_ptr(), float(gamma), a_c, b_c, c_c],
            "fused_rk_stage")
    if logs:
        fused_rk_stage.launches_logs += 1
    else:
        fused_rk_stage.launches += 1
    return out, speed.view(torch.float32)


fused_rk_stage.launches = 0
fused_rk_stage.launches_logs = 0


def _stage_library() -> ctypes.CDLL:
    """The stage kernel's library: device, dim, ext, E, flux (the index in
    CUDA_FLUXES), logs as int; every pointer and the stream as c_void_p;
    gamma double, coefficients float."""
    return _library("fused_rk_stage", "t8_fused_rk_stage",
                    [ctypes.c_int] * 6 + [ctypes.c_void_p] * 11
                    + [ctypes.c_double] + [ctypes.c_float] * 3
                    + [ctypes.c_void_p])


def fused_rk_stage_attributes(dim: int, ext: int, flux: str = "kepes",
                              logs: bool = False, share_prev: bool = True,
                              device: int = 0) -> dict:
    """The resources of the stage kernel of one case on a card (builds the
    library), as fused_muscl_attributes."""
    return _attributes(_stage_library(), "t8_fused_rk_stage_attributes",
                       device, [dim, ext, CUDA_FLUXES.index(flux),
                                int(bool(logs)), int(bool(share_prev))])


def _stage_update(u_rows, up_rows, weights, D, coeffs) -> torch.Tensor:
    """a*u_prev + b*u + c*w[7]*D per state row, in the TPU kernels'
    operation order; up_rows None means u_rows."""
    a_c, b_c, c_c = coeffs
    if up_rows is None:
        up_rows = u_rows
    cdt = c_c * weights[7]
    return torch.stack([a_c * up_rows[i] + b_c * u_rows[i] + cdt * D[i]
                        for i in range(5)])


def fused_rk_stage_reference(u_stage: torch.Tensor, u_prev,
                             weights: torch.Tensor, others, gamma: float,
                             flux: str, coeffs):
    """Plain PyTorch version of the stage: the tile math of the TPU
    kernel (_fused_rk_kernel / _tile_flux_divergence) over the whole
    element axis, for kepes, hll and hllc, from a 5-row state or (kepes)
    a 7-row state with its log rows.  Same signature and result as
    fused_rk_stage; runs on any device and dtype."""
    dim, _, _ = _check_stage_shapes(u_stage, u_prev, weights, others, (),
                                    flux)
    logs7 = u_stage.shape[0] == 7

    def fields(t):
        return cell_fields_tuple(_rows(t), gamma, flux,
                                 logs=(t[5], t[6]) if logs7 else None)

    def iface(l, r):
        return fields_flux(l, r, gamma=gamma, flux=flux)
    D, speed = _first_order_divergence(fields(u_stage),
                                       [fields(o) for o in others], weights,
                                       5, fields_axis_rotate,
                                       flux_axis_unrotate, iface)
    u_next = _stage_update(_rows(u_stage),
                           None if u_prev is None else _rows(u_prev),
                           weights, D, coeffs)
    return u_next, speed.amax(dim=tuple(range(dim)))


# -- the field-input kernels (kernels 2 and 6) -------------------------------


def _check_fields_inputs(q, u_prev, weights, others, flux, extras=()):
    """Raise ValueError on inputs no version of the field-input kernels
    takes: q [C, ...] with the flux's C field rows.  Returns (dim, ext,
    E)."""
    if flux not in N_FIELDS:
        raise ValueError(f"unknown flux family: {flux}")
    return _check_stage_shapes(q, u_prev, weights, others, extras, flux,
                               rows=(N_FIELDS[flux],))


def _recover_state_rows(q, gamma: float, flux: str) -> tuple:
    """Conservative state rows from cell-field rows (exact up to ~1-ulp
    rounding: the fields are algebraic in the state).  kepes rows [rho,
    v1, v2, v3, p, rho/p, log rho, log p, vent0, ke]; hll rows [rho, v1,
    v2, v3, p, h, c, sqrt(rho), ke]."""
    rho = q[0]
    m1, m2, m3 = rho * q[1], rho * q[2], rho * q[3]
    if flux == "kepes":
        e = q[4] * (1.0 / (gamma - 1.0)) + rho * q[9]
    else:                                     # hll: h = (e + p) / rho
        e = rho * q[5] - q[4]
    return (rho, m1, m2, m3, e)


def _fields_divergence(q, weights, others, gamma, flux):
    """The plain first-order divergence of field rows: (D [5, ...],
    per-cell speed)."""
    C = q.shape[0]

    def iface(l, r):
        return fields_flux(l, r, gamma=gamma, flux=flux)
    return _first_order_divergence(_rows(q, n=C),
                                   [_rows(o, n=C) for o in others], weights,
                                   5, fields_axis_rotate, flux_axis_unrotate,
                                   iface)


def fused_flux(q: torch.Tensor, weights: torch.Tensor, others, gamma: float,
               flux: str):
    """First-order flux divergence from cell-field rows: (D [5, *(ext,)*dim,
    E], speed [E]), speed the per-element max interface wave speed.

    q: [C, *(ext,)*dim, E] stacked cell fields (ops/euler.cell_fields_tuple,
    C = 10 kepes, 9 hll/hllc); weights [8, E] (row 0 interior cell-face
    area, rows 1+k side k's face weight with the wall area on wall sides,
    row 7 unused); others: 2*dim field side layers [C, *(ext,)*(dim-1), E]
    (the neighbour's facing layer, or the mirrored own layer on a wall
    side), side k = 2*axis + (0 hi, 1 lo).  CUDA tensors launch the kernel
    (kepes), CPU tensors run fused_flux_reference."""
    dim, ext, E = _check_fields_inputs(q, None, weights, others, flux)
    dev = q.device
    if dev.type == "cpu":
        return fused_flux_reference(q, weights, others, gamma=gamma,
                                    flux=flux)
    if dev.type != "cuda":
        raise ValueError(f"no flux kernel for device {dev}")
    _check_cuda_tensors([q, weights, *others], flux, "flux")

    D = torch.empty((5,) + q.shape[1:], dtype=q.dtype, device=dev)
    speed = _speed_bits(E, dev)
    _launch(_fields_library(), "t8_fused_fields", dev,
            [dim, ext, E, 0, q.data_ptr(), None, weights.data_ptr(),
             *_side_pointers(others), D.data_ptr(), speed.data_ptr(),
             float(gamma), 0.0, 0.0, 0.0], "fused_flux")
    fused_flux.launches += 1
    return D, speed.view(torch.float32)


fused_flux.launches = 0


def fused_flux_reference(q: torch.Tensor, weights: torch.Tensor, others,
                         gamma: float, flux: str):
    """Plain PyTorch version of the field-input divergence: the tile math
    of the TPU kernel (_fused_kernel / _tile_flux_divergence) over the
    whole element axis, for kepes, hll and hllc.  Same signature and
    result as fused_flux; runs on any device and dtype."""
    dim, _, _ = _check_fields_inputs(q, None, weights, others, flux)
    D, speed = _fields_divergence(q, weights, others, gamma, flux)
    return D, speed.amax(dim=tuple(range(dim)))


def fused_rk_stage_fields(q: torch.Tensor, u_prev, weights: torch.Tensor,
                          others, gamma: float, flux: str, coeffs,
                          extras=()):
    """One SSP-RK stage from cell-field rows: (u_next [5, *(ext,)*dim, E],
    speed [E]) with u_next = a*u_prev + b*u + c*w[7]*D, where D is
    fused_flux's divergence and u the state recovered from q.

    q, weights, others as fused_flux, with weight row 7 = dt *
    inv_cell_volume; u_prev: [5, ...] state, or None (the first stage:
    the recovered state stands for it).  CUDA tensors launch the kernel
    (kepes), CPU tensors run fused_rk_stage_fields_reference."""
    dim, ext, E = _check_fields_inputs(q, u_prev, weights, others, flux,
                                       extras)
    dev = q.device
    if dev.type == "cpu":
        return fused_rk_stage_fields_reference(q, u_prev, weights, others,
                                               gamma=gamma, flux=flux,
                                               coeffs=coeffs)
    if dev.type != "cuda":
        raise ValueError(f"no stage kernel for device {dev}")
    _check_cuda_tensors(_stage_tensors(q, u_prev, weights, others), flux,
                        "field stage")

    out = torch.empty((5,) + q.shape[1:], dtype=q.dtype, device=dev)
    speed = _speed_bits(E, dev)
    a_c, b_c, c_c = (float(x) for x in coeffs)
    _launch(_fields_library(), "t8_fused_fields", dev,
            [dim, ext, E, 1, q.data_ptr(),
             None if u_prev is None else u_prev.data_ptr(),
             weights.data_ptr(), *_side_pointers(others), out.data_ptr(),
             speed.data_ptr(), float(gamma), a_c, b_c, c_c],
            "fused_rk_stage_fields")
    fused_rk_stage_fields.launches += 1
    return out, speed.view(torch.float32)


fused_rk_stage_fields.launches = 0


def _fields_library() -> ctypes.CDLL:
    """The field-input kernels' library: device, dim, ext, E, rk as int;
    every pointer and the stream as c_void_p; gamma double, coefficients
    float."""
    return _library("fused_fields", "t8_fused_fields",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 11
                    + [ctypes.c_double] + [ctypes.c_float] * 3
                    + [ctypes.c_void_p])


def fused_rk_stage_fields_reference(q: torch.Tensor, u_prev,
                                    weights: torch.Tensor, others,
                                    gamma: float, flux: str, coeffs):
    """Plain PyTorch version of the field-input stage: the tile math of
    the TPU kernel (_fused_rk_fields_kernel) over the whole element axis,
    for kepes, hll and hllc.  Same signature and result as
    fused_rk_stage_fields; runs on any device and dtype."""
    dim, _, _ = _check_fields_inputs(q, u_prev, weights, others, flux)
    D, speed = _fields_divergence(q, weights, others, gamma, flux)
    C = q.shape[0]
    u_next = _stage_update(_recover_state_rows(_rows(q, n=C), gamma, flux),
                           None if u_prev is None else _rows(u_prev),
                           weights, D, coeffs)
    return u_next, speed.amax(dim=tuple(range(dim)))


# -- the inner-only kernel (kernel 7) ----------------------------------------


def _check_inner_inputs(u, volumes):
    """Raise ValueError on inputs no version of the inner-only divergence
    takes.  Returns (dim, ext, E)."""
    _check_rows(u, 5, "u")
    dim, ext, E = _check_block(u, "u", INNER_EXTENTS)
    if tuple(volumes.shape) != (E,):
        raise ValueError(f"volumes must be [{E}], got "
                         f"{tuple(volumes.shape)}")
    _check_one_device_dtype([u, volumes], "inner divergence")
    return dim, ext, E


def _state_rotate(u: torch.Tensor, axis: int) -> torch.Tensor:
    """State rows [rho, m_x, m_y, m_z, e] into the +axis face frame."""
    return u if axis == 0 else u[list(AXIS_ROTATE[axis])]


def interior_surface(volumes: torch.Tensor, dim: int, ext: int):
    """Per element, the area of one interior cell face: (V^(1/dim) /
    ext)^(dim-1), 0 on dead slots (volume 0)."""
    h_cell = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim) / ext
    return (h_cell ** (dim - 1)) * (volumes > 0)


def interior_face_divergence(D: torch.Tensor, f: torch.Tensor, a: int):
    """D plus the divergence of the ext-1 interior face fluxes f along
    axis a: D[i] += f[i-1] - f[i], the missing end faces zero."""
    zero = torch.zeros_like(f.narrow(1 + a, 0, 1))
    return (D + torch.cat([zero, f], dim=1 + a)
            - torch.cat([f, zero], dim=1 + a))


def inner_divergence(u: torch.Tensor, volumes: torch.Tensor, gamma: float,
                     flux: str):
    """Interior-face flux divergence of a block state through the
    state-form flux (ops/euler.numerical_flux): (D [5, *(ext,)*dim, E],
    max wave speed over the interior faces of live elements, a 0-d
    tensor).  u: [5, *(ext,)*dim, E] with ext in 2, 4, 8, 16; volumes
    [E] (0 on dead slots).  Mesh faces and walls are the caller's.  CUDA
    tensors launch the kernel (kepes), CPU tensors run
    inner_divergence_reference."""
    dim, ext, E = _check_inner_inputs(u, volumes)
    dev = u.device
    if dev.type == "cpu":
        return inner_divergence_reference(u, volumes, gamma=gamma, flux=flux)
    if dev.type != "cuda":
        raise ValueError(f"no inner-divergence kernel for device {dev}")
    surface = interior_surface(volumes, dim, ext)
    _check_cuda_tensors([u, surface], flux, "inner divergence")

    D = torch.empty_like(u)
    speed = _speed_bits(1, dev)
    _launch(_inner_library(), "t8_inner_divergence", dev,
            [dim, ext, E, u.data_ptr(), surface.data_ptr(), D.data_ptr(),
             speed.data_ptr(), float(gamma)], "inner_divergence")
    inner_divergence.launches += 1
    return D, speed.view(torch.float32)[0]


inner_divergence.launches = 0


def _inner_library() -> ctypes.CDLL:
    """The inner-only kernel's library: device, dim, ext, E as int; every
    pointer and the stream as c_void_p; gamma double."""
    return _library("inner_divergence", "t8_inner_divergence",
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                    + [ctypes.c_double, ctypes.c_void_p])


def inner_divergence_attributes(dim: int, ext: int, device: int = 0) -> dict:
    """The resources of the inner-only kernel at one shape on a card
    (builds the library), as fused_muscl_attributes."""
    return _attributes(_inner_library(), "t8_inner_divergence_attributes",
                       device, [dim, ext])


def inner_divergence_reference(u: torch.Tensor, volumes: torch.Tensor,
                               gamma: float, flux: str):
    """Plain PyTorch version of the inner-only divergence: the TPU
    kernel's math (_kernel, pallas_kernels.py:1394) over the whole element
    axis, for kepes, hll and hllc.  Same signature and result as
    inner_divergence; runs on any device and dtype."""
    dim, ext, E = _check_inner_inputs(u, volumes)
    surface = interior_surface(volumes, dim, ext)
    D = torch.zeros_like(u)
    speed = torch.zeros_like(volumes)
    for a in range(dim):
        u_l = u.narrow(1 + a, 0, ext - 1)
        u_r = u.narrow(1 + a, 1, ext - 1)
        f, sp = numerical_flux(_state_rotate(u_l, a), _state_rotate(u_r, a),
                               gamma=gamma, flux=flux)
        D = interior_face_divergence(D, flux_axis_unrotate(f, a) * surface,
                                     a)
        speed = torch.maximum(speed, sp.amax(dim=tuple(range(dim))))
    return D, (speed * (volumes > 0)).max()


# -- the Euler MUSCL kernel ---------------------------------------------------


def _check_muscl_inputs(u, weights, others, flux, limiter, space):
    """Raise ValueError on inputs no version of the MUSCL divergence
    takes.  Returns (dim, ext, E)."""
    if u.shape[0] != 5:
        raise ValueError(f"u must have 5 state rows, got {tuple(u.shape)}")
    dim, ext, E = _check_block(u, "u")
    _check_sides(weights, others, 10, dim, ext, E)
    _check_one_device_dtype([u, weights, *others], "MUSCL")
    _check_limiter(limiter)
    if space not in MUSCL_SPACES:
        raise ValueError(f"unknown reconstruction space {space!r}; "
                         f"expected one of {MUSCL_SPACES}")
    if space == "prim" and flux != "kepes":
        raise ValueError("primitive-space MUSCL ('<lim>-prim') supports the "
                         f"kepes flux, not {flux!r}")
    return dim, ext, E


def _check_limiter(limiter):
    if limiter not in MUSCL_LIMITERS:
        raise ValueError(f"unknown fused-MUSCL limiter {limiter!r}; "
                         f"expected one of {MUSCL_LIMITERS}")


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
    _check_cuda_tensors([u, weights, *others], flux, "MUSCL",
                        CUDA_FLUXES)

    D = torch.empty_like(u)
    speed = _speed_bits(E, dev, zero=False)
    _launch(_muscl_library(), "t8_fused_muscl", dev,
            [dim, ext, E, CUDA_FLUXES.index(flux), int(space == "prim"),
             int(limiter == "minmod"), int(bool(positivity)), u.data_ptr(),
             weights.data_ptr(), *_side_pointers(others), D.data_ptr(),
             speed.data_ptr(), float(gamma)], "fused_muscl")
    fused_muscl.launches += 1
    return D, speed.view(torch.float32)


fused_muscl.launches = 0


def _muscl_library() -> ctypes.CDLL:
    """The MUSCL kernel's library: device, dim, ext, E, flux (the index in
    CUDA_FLUXES), prim, minmod, positivity as int; every pointer and
    the stream as c_void_p; gamma double."""
    return _library("fused_muscl", "t8_fused_muscl",
                    [ctypes.c_int] * 8 + [ctypes.c_void_p] * 10
                    + [ctypes.c_double, ctypes.c_void_p])


def _attributes(lib, entry: str, device: int, case) -> dict:
    """Registers, spilled bytes per thread, threads and shared memory per
    block of the kernel instantiation that `case` (the int arguments after
    the device) selects."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * (1 + len(case))
                       + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _raise_on_error(lib, fn(device, *case, out), entry)
    return dict(zip(("registers", "spill_bytes", "threads", "smem_bytes"),
                    out))


def fused_muscl_attributes(dim: int, ext: int, flux: str = "kepes",
                           space: str = "cons", limiter: str = "minmod",
                           positivity: bool = True, device: int = 0) -> dict:
    """The resources of the MUSCL kernel of one case on a card (builds the
    library): registers and spilled bytes per thread, threads and shared
    memory (bytes) per block."""
    return _attributes(_muscl_library(), "t8_fused_muscl_attributes", device,
                       [dim, ext, CUDA_FLUXES.index(flux),
                        int(space == "prim"), int(limiter == "minmod"),
                        int(bool(positivity))])


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
    lim = _minmod if limiter == "minmod" else _central
    prim = space == "prim"
    kappa_m1 = gamma - 1.0

    if prim:
        # prim_rows once per cell and side-layer cell, before the rotation
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

    sides = [(cvt(_rows(o)), cvt(_rows(o, 5))) for o in others]
    return _muscl_divergence(cvt(_rows(u)), sides, weights, 5,
                             fields_axis_rotate, flux_axis_unrotate, iface,
                             guard, lim)


# -- the GLM-MHD kernels ------------------------------------------------------


def _check_mhd_inputs(u, weights, others, side_rows: int, what: str):
    """Raise ValueError on inputs no version of an MHD kernel takes.
    Returns (dim, ext, E)."""
    _check_rows(u, MHD_ROWS, "u")
    dim, ext, E = _check_block(u, "u")
    _check_sides(weights, others, side_rows, dim, ext, E)
    _check_one_device_dtype([u, weights, *others], what)
    return dim, ext, E


def _mhd_iface(gamma: float, ch):
    """The Rusanov + exact-GLM interface flux on rotated row tuples:
    (stacked face-frame flux [9, ...], speed)."""
    def iface(l_rows, r_rows):
        f, sp = _rusanov_rows(l_rows, r_rows, gamma, ch)
        return torch.stack(f), sp
    return iface


def fused_mhd_flux(u: torch.Tensor, weights: torch.Tensor, others,
                   gamma: float):
    """First-order GLM-MHD flux divergence of the interior faces, the
    equal-level mesh faces and the conductor walls: (D [9, *(ext,)*dim,
    E], speed [E]), speed the per-element max signal speed.

    u: [9, *(ext,)*dim, E] states; weights [8, E] (row 0 the interior
    cell-face area, rows 1+k side k's face weight, wall area on wall
    sides, row 7 the cleaning speed c_h of every element); others: 2*dim
    side layers [9, *(ext,)*(dim-1), E], the neighbour's facing layer or
    the wall's conductor ghost, unrotated, side k = 2*axis + (0 hi, 1 lo).
    CUDA tensors launch the kernel, CPU tensors run
    fused_mhd_flux_reference."""
    dim, ext, E = _check_mhd_inputs(u, weights, others, MHD_ROWS, "MHD flux")
    dev = u.device
    if dev.type == "cpu":
        return fused_mhd_flux_reference(u, weights, others, gamma=gamma)
    if dev.type != "cuda":
        raise ValueError(f"no MHD flux kernel for device {dev}")
    _check_f32_contiguous([u, weights, *others], "MHD flux")

    D = torch.empty_like(u)
    speed = _speed_bits(E, dev)
    _launch(_mhd_flux_library(), "t8_fused_mhd_flux", dev,
            [dim, ext, E, u.data_ptr(), weights.data_ptr(),
             *_side_pointers(others), D.data_ptr(), speed.data_ptr(),
             float(gamma)], "fused_mhd_flux")
    fused_mhd_flux.launches += 1
    return D, speed.view(torch.float32)


fused_mhd_flux.launches = 0


def _mhd_flux_library() -> ctypes.CDLL:
    """The MHD flux kernel's library: device, dim, ext, E as int; every
    pointer and the stream as c_void_p; gamma double."""
    return _library("fused_mhd_flux", "t8_fused_mhd_flux",
                    [ctypes.c_int] * 4 + [ctypes.c_void_p] * 10
                    + [ctypes.c_double, ctypes.c_void_p])


def fused_mhd_flux_reference(u: torch.Tensor, weights: torch.Tensor, others,
                             gamma: float):
    """Plain PyTorch version of the MHD flux divergence: the tile math of
    the TPU kernel (_tile_mhd_divergence) over the whole element axis.
    Same signature and result as fused_mhd_flux; runs on any device and
    dtype."""
    dim, _, _ = _check_mhd_inputs(u, weights, others, MHD_ROWS, "MHD flux")
    D, speed = _first_order_divergence(
        _rows(u, n=MHD_ROWS), [_rows(o, n=MHD_ROWS) for o in others],
        weights, MHD_ROWS, axis_rotate9, axis_unrotate9,
        _mhd_iface(gamma, weights[7]))
    return D, speed.amax(dim=tuple(range(dim)))


def fused_mhd_muscl(u: torch.Tensor, weights: torch.Tensor, others,
                    gamma: float, limiter: str = "minmod",
                    positivity: bool = True):
    """Order-2 GLM-MHD divergence of the interior and equal-level mesh
    faces: (D [9, *(ext,)*dim, E], speed [E]).

    u: [9, *(ext,)*dim, E]; weights [8, E] (row 0 the interior cell-face
    area, rows 1+k side k's equal-level face weight, whose sign is also
    the slope mask of the block edge, row 7 c_h); others: 2*dim side slabs
    [18, *(ext,)*(dim-1), E], rows 0-8 the equal-level neighbour's facing
    layer, rows 9-17 its second layer.  Walls and hanging faces are the
    caller's first-order closure.  positivity keeps the cell's own state
    where a reconstruction has rho <= 0 or thermal p <= 0.  CUDA tensors
    launch the kernel, CPU tensors run fused_mhd_muscl_reference."""
    dim, ext, E = _check_mhd_inputs(u, weights, others, 2 * MHD_ROWS,
                                    "MHD MUSCL")
    _check_limiter(limiter)
    dev = u.device
    if dev.type == "cpu":
        return fused_mhd_muscl_reference(u, weights, others, gamma=gamma,
                                         limiter=limiter,
                                         positivity=positivity)
    if dev.type != "cuda":
        raise ValueError(f"no MHD MUSCL kernel for device {dev}")
    _check_f32_contiguous([u, weights, *others], "MHD MUSCL")

    D = torch.empty_like(u)
    speed = _speed_bits(E, dev, zero=False)
    _launch(_mhd_muscl_library(), "t8_fused_mhd_muscl", dev,
            [dim, ext, E, int(limiter == "minmod"), int(bool(positivity)),
             u.data_ptr(), weights.data_ptr(), *_side_pointers(others),
             D.data_ptr(), speed.data_ptr(), float(gamma)],
            "fused_mhd_muscl")
    fused_mhd_muscl.launches += 1
    return D, speed.view(torch.float32)


fused_mhd_muscl.launches = 0


def _mhd_muscl_library() -> ctypes.CDLL:
    """The MHD MUSCL kernel's library: device, dim, ext, E, minmod,
    positivity as int; every pointer and the stream as c_void_p; gamma
    double."""
    return _library("fused_mhd_muscl", "t8_fused_mhd_muscl",
                    [ctypes.c_int] * 6 + [ctypes.c_void_p] * 10
                    + [ctypes.c_double, ctypes.c_void_p])


def fused_mhd_muscl_attributes(dim: int, ext: int, limiter: str = "minmod",
                               positivity: bool = True,
                               device: int = 0) -> dict:
    """The resources of the MHD MUSCL kernel of one case on a card, as
    fused_muscl_attributes."""
    return _attributes(_mhd_muscl_library(), "t8_fused_mhd_muscl_attributes",
                       device, [dim, ext, int(limiter == "minmod"),
                                int(bool(positivity))])


def fused_mhd_muscl_reference(u: torch.Tensor, weights: torch.Tensor, others,
                              gamma: float, limiter: str = "minmod",
                              positivity: bool = True):
    """Plain PyTorch version of the MHD MUSCL divergence: the tile math of
    the TPU kernel (_tile_mhd_muscl_divergence) over the whole element
    axis.  Same signature and result as fused_mhd_muscl; runs on any
    device and dtype."""
    _check_mhd_inputs(u, weights, others, 2 * MHD_ROWS, "MHD MUSCL")
    _check_limiter(limiter)
    kappa_m1 = gamma - 1.0

    def guard(rec, base):
        """Thermal-pressure positivity: the magnetic pressure is >= 0 and
        must not mask a negative p."""
        if not positivity:
            return rec
        rho, m1, m2, m3, e, b1, b2, b3, _ = rec
        s_rho = 1.0 / rho
        ke = 0.5 * (m1 * m1 + m2 * m2 + m3 * m3) * s_rho
        b2s = b1 * b1 + b2 * b2 + b3 * b3
        p = kappa_m1 * (e - ke - 0.5 * b2s)
        ok = (rho > 0.0) & (p > 0.0)
        return tuple(torch.where(ok, r, b) for r, b in zip(rec, base))

    n = MHD_ROWS
    sides = [(_rows(o, 0, n), _rows(o, n, n)) for o in others]
    return _muscl_divergence(_rows(u, n=n), sides, weights, n, axis_rotate9,
                             axis_unrotate9, _mhd_iface(gamma, weights[7]),
                             guard, _minmod if limiter == "minmod"
                             else _central)
