"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Counterpart of t8gpu_tpu/ops/pallas_kernels.py.  Each wrapper launches
its kernel for CUDA tensors and runs the plain version only for tensors
that lie on the CPU; for a CUDA input the kernel does not take it raises
ValueError, never falls back.  Each wrapper counts its launches in a
plain integer attribute (`fused_rk_stage.launches`).

fused_rk_stage — replaces fused_rk_stage_pallas
(t8gpu_tpu/ops/pallas_kernels.py:1190): one whole SSP-RK stage per
element (cell fields, kepes, hll or hllc interface fluxes, weighted
divergence, the side extras that carry an AMR mesh's hanging-fine faces
(:1154-1158), stage update, per-element max wave speed) in one pass over
the state.  Bound on an H100: the bytes it must move, ~123 MB for stage 1
and ~168 MB for stages 2-3 at the flagship shape (37-50 us at 3.35
TB/s).  The kernel is the first-order pencil walk of
csrc/muscl_pencil.cuh over slabs of elements in shared memory: each
cell's fields derived once, each interface evaluated once (once more at
a slab boundary; csrc/fused_rk_stage.cu has the details and PERF.md its
times).

fused_rk_stage with mu > 0 or a gravity vector — the viscous
(_tile_viscous_divergence, :914) and gravity (:1160-1178) branches of the
same TPU kernel: csrc/fused_rk_stage_viscous.cu adds the Navier-Stokes
divergence of the interior and equal-level faces (on the same walk over
whole elements, both fluxes of each face at once) and the gravity
source as a runtime switch, csrc/fused_rk_stage_gravity.cu the source
alone; a launch with mu = 0 and no gravity runs the inviscid kernel.
Counted in `launches_viscous` and `launches_gravity`.  Bound: the bytes,
the inviscid stage's plus the viscous weights [8, E].

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
MB at the Orszag-Tang shape (38 us at 3.35 TB/s).  The kernel is the
stage kernel's pencil walk on the 9 state rows (csrc/fused_mhd_flux.cu).

fused_rk_stage with a 7-row u_stage — the "logs" stage input of the same
TPU kernel: rows 5-6 carry log rho and log p, computed once per cell
before the launch (ops/subgrid.append_log_rows), so the kernel derives
every field log-free.  Counted apart, in `fused_rk_stage.launches_logs`.

fused_flux — replaces fused_flux_pallas
(t8gpu_tpu/ops/pallas_kernels.py:193): the first-order flux divergence D
and the per-element max wave speed from precomputed kepes, hll or hllc
cell-field rows (the interior faces, the equal-level mesh faces and the
walls or open boundaries, whose mirrored or farfield field layers ride in
as side layers); one thread per cell (csrc/fused_fields.cu, the flux a
template parameter).  Bound: the bytes, ~202 MB at the flagship shape in
kepes, ~184 MB in hll/hllc (60 and 55 us at 3.35 TB/s).

fused_rk_stage_fields — replaces fused_rk_stage_fields_pallas (:1329):
the same divergence from kepes, hll or hllc field rows, the side extras
(:1309-1313), the stage state recovered from the field rows, and the
stage update: the stage kernel's pencil walk on the field rows as they
are (csrc/fused_rk_stage.cu).  A launch with side extras runs the
kernels' instantiation with the extras code, one without them that of a
uniform mesh.
Bound: the bytes, ~202 MB (stage 1) and ~246 MB (stages 2-3) at the
flagship shape (60 and 74 us at 3.35 TB/s).

inner_divergence — replaces inner_divergence_pallas (:1425): the interior
faces' divergence of a 5-row state through the state-form flux (KEPES, six
logs per face; hll; hllc) at extents 2, 4, 8 and 16, and the scalar max
wave speed of the live elements: the same pencil walk over the interior
faces, each evaluated once, in slabs of 2 planes at 3D extent 16
(csrc/inner_divergence.cu, the flux a template parameter).

fused_mhd_muscl — replaces fused_mhd_muscl_pallas
(t8gpu_tpu/ops/pallas_kernels.py:777): the order-2 GLM-MHD divergence of
the interior and equal-level faces (per-axis minmod or unlimited slopes,
the thermal-pressure positivity guard, the same Rusanov/GLM flux).  Bound:
the bytes, ~154 MB at the Orszag-Tang shape (46 us;
csrc/fused_mhd_muscl.cu): the pencil walk of fused_muscl on 9 rows.
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
# the fluxes of the Euler kernels, by their index in the C entry points
# (MUSCL: hll/hllc in "cons" only; stage: the 7-row input kepes only)
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


def _check_extras(extra_sides, extras, dim: int, ext: int, E: int):
    """Raise ValueError unless extras holds one 5-row layer [5,
    *(ext,)*(dim-1), E] per side of extra_sides, the sides increasing in
    range(2 * dim)."""
    sides = tuple(int(k) for k in extra_sides)
    if len(sides) != len(extras):
        raise ValueError(f"extras must hold one layer per side of "
                         f"extra_sides, got {len(extras)} for {sides}")
    if any(k < 0 or k >= 2 * dim for k in sides) \
            or any(a >= b for a, b in zip(sides, sides[1:])):
        raise ValueError(f"extra_sides must increase within range({2 * dim}),"
                         f" got {sides}")
    lay = (5,) + (ext,) * (dim - 1) + (E,)
    if any(tuple(x.shape) != lay for x in extras):
        raise ValueError(f"extras must be 5-row side layers of shape {lay}, "
                         f"got {[tuple(x.shape) for x in extras]}")


def _check_stage_shapes(u_stage, u_prev, weights, others, flux, rows=(5, 7),
                        extra_sides=(), extras=()):
    """Raise ValueError on inputs no version of the stage takes: u_stage
    with `rows` rows (7: the state and its log rho, log p rows, kepes
    only; a field stage: the flux's field rows), u_prev [5, ...], extras
    (`_check_extras`).  Returns (dim, ext, E)."""
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
    _check_extras(extra_sides, extras, dim, ext, E)
    _check_one_device_dtype(_stage_tensors(u_stage, u_prev, weights, others)
                            + list(extras), "stage")
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
    outside `fluxes` (the kernels pass CUDA_FLUXES), another dtype than
    float32, strided tensors."""
    if flux not in fluxes:
        raise ValueError(f"the {what} kernel computes the "
                         f"{'/'.join(fluxes)} flux, not {flux!r}")
    _check_f32_contiguous(tensors, what)


def _check_kernel_inputs(u_stage, u_prev, weights, others, flux: str,
                         extras=()):
    """Raise ValueError on what the CUDA stage kernel does not take."""
    _check_cuda_tensors(_stage_tensors(u_stage, u_prev, weights, others)
                        + list(extras), flux, "stage", CUDA_FLUXES)


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


def _extras_pointers(extra_sides, extras) -> list:
    """The six sides' extras pointers of the stage entry points, None
    where a side has none."""
    ptrs = [None] * 6
    for k, x in zip(extra_sides, extras):
        ptrs[int(k)] = x.data_ptr()
    return ptrs


def _add_extras(D: torch.Tensor, extra_sides, extras) -> torch.Tensor:
    """D [5, *(ext,)*dim, E] with each side's extras added onto its
    boundary layer (side k: the cells at ext - 1, k even, or 0, k odd,
    along axis k // 2), the sides in extra_sides order, as the TPU
    kernels add them (_fused_rk_kernel :1154-1158)."""
    ext = D.shape[1]
    for k, x in zip(extra_sides, extras):
        a = int(k) // 2
        D.select(1 + a, ext - 1 if int(k) % 2 == 0 else 0).add_(x)
    return D


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


def _check_physics(viscous_weights, mu: float, prandtl: float, gravity,
                   E: int):
    """Raise ValueError on viscous or gravity arguments no version of the
    stage takes; returns (viscous, gravity as a 3-tuple of floats)."""
    viscous = float(mu) > 0.0
    g = tuple(float(c) for c in gravity)
    if len(g) != 3:
        raise ValueError(f"gravity must have 3 components, got {gravity}")
    if viscous:
        shape = None if viscous_weights is None else viscous_weights.shape
        if shape is None or tuple(shape) != (8, E):
            raise ValueError(f"mu > 0 needs viscous_weights [8, {E}], got "
                             f"{shape}")
        if not float(prandtl) > 0.0:
            raise ValueError(f"prandtl must be positive, got {prandtl}")
    return viscous, g


def fused_rk_stage(u_stage: torch.Tensor, u_prev, weights: torch.Tensor,
                   others, gamma: float, flux: str, coeffs, extra_sides=(),
                   extras=(), viscous_weights=None, mu: float = 0.0,
                   prandtl: float = 0.72, gravity=(0.0, 0.0, 0.0)):
    """One SSP-RK stage: (u_next, speed) with
    u_next = a*u_prev + b*u_stage + c*w[7]*(D(u_stage) + extras + S) and
    speed [E] the per-element max interface wave speed.

    u_stage: [5, *(ext,)*dim, E], or [7, ...] with rows 5-6 log rho and
    log p (the "logs" input, kepes: the fields are then derived
    log-free); flux "kepes", "hll" or "hllc"; u_prev: [5, ...] (None
    means the state rows of u_stage, the first stage); weights [8, E]
    (row 0 interior cell-face area, rows 1+k side k's face weight, row 7
    = dt * inv_cell_volume); others:
    2*dim side layers [5 or 7, *(ext,)*(dim-1), E] (as many rows as
    u_stage), side k = 2*axis + (0 hi, 1 lo); extras: per side of
    extra_sides (increasing) an additive layer [5, *(ext,)*(dim-1), E]
    onto that side's boundary cell layer (the hanging-fine faces of AMR
    meshes, ops/subgrid.fine_side_extras, and the viscous hanging and
    no-slip wall fluxes).  mu > 0 adds the Navier-Stokes divergence of
    the interior and equal-level faces (viscous_weights [8, E],
    ops/subgrid.viscous_weight_rows: row 0 the cell size h, rows 1+k
    side k's equal-level weight; prandtl the Prandtl number); a nonzero
    gravity adds the source S = (0, rho g, m . g) times the cell volume
    (w[0]^(dim/(dim-1))).  CUDA tensors launch the kernel (a 7-row
    launch counts in `launches_logs`, a 5-row one in `launches`, a
    launch with extras in `launches_extras` too, one with mu > 0 in
    `launches_viscous` and one with gravity in `launches_gravity`), CPU
    tensors run fused_rk_stage_reference."""
    dim, ext, E = _check_stage_shapes(u_stage, u_prev, weights, others, flux,
                                      extra_sides=extra_sides, extras=extras)
    viscous, g = _check_physics(viscous_weights, mu, prandtl, gravity, E)
    dev = u_stage.device
    if dev.type == "cpu":
        return fused_rk_stage_reference(
            u_stage, u_prev, weights, others, gamma=gamma, flux=flux,
            coeffs=coeffs, extra_sides=extra_sides, extras=extras,
            viscous_weights=viscous_weights, mu=mu, prandtl=prandtl,
            gravity=g)
    if dev.type != "cuda":
        raise ValueError(f"no stage kernel for device {dev}")
    _check_kernel_inputs(u_stage, u_prev, weights, others, flux,
                         list(extras) + ([viscous_weights] if viscous else []))
    if viscous and viscous_weights.device != dev:
        raise ValueError("viscous_weights lie on another device")

    logs = u_stage.shape[0] == 7
    out = torch.empty((5,) + u_stage.shape[1:], dtype=u_stage.dtype,
                      device=dev)
    speed = _speed_bits(E, dev)
    a_c, b_c, c_c = (float(x) for x in coeffs)
    grav = any(c != 0.0 for c in g)
    args = [dim, ext, E, CUDA_FLUXES.index(flux), int(logs),
            u_stage.data_ptr(),
            None if u_prev is None else u_prev.data_ptr(),
            weights.data_ptr(), *_side_pointers(others),
            *_extras_pointers(extra_sides, extras), out.data_ptr(),
            speed.data_ptr(), float(gamma), a_c, b_c, c_c]
    if viscous:
        kappa = float(mu) * gamma / ((gamma - 1.0) * float(prandtl))
        _launch(_stage_physics_library("viscous"), "t8_fused_rk_stage_viscous",
                dev, args + [viscous_weights.data_ptr(), float(mu), kappa,
                             int(grav), *g], "fused_rk_stage")
    elif grav:
        _launch(_stage_physics_library("gravity"), "t8_fused_rk_stage_gravity",
                dev, args + [None, 0.0, 0.0, 1, *g], "fused_rk_stage")
    else:
        _launch(_stage_library(), "t8_fused_rk_stage", dev, args,
                "fused_rk_stage")
    if logs:
        fused_rk_stage.launches_logs += 1
    else:
        fused_rk_stage.launches += 1
    if extras:
        fused_rk_stage.launches_extras += 1
    if viscous:
        fused_rk_stage.launches_viscous += 1
    if grav:
        fused_rk_stage.launches_gravity += 1
    return out, speed.view(torch.float32)


fused_rk_stage.launches = 0
fused_rk_stage.launches_logs = 0
fused_rk_stage.launches_extras = 0
fused_rk_stage.launches_viscous = 0
fused_rk_stage.launches_gravity = 0

_STAGE_ARGTYPES = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 17
                   + [ctypes.c_double] + [ctypes.c_float] * 3)


def _stage_library() -> ctypes.CDLL:
    """The stage kernel's library: device, dim, ext, E, flux (the index in
    CUDA_FLUXES), logs as int; every pointer (u, u_prev, w, six sides, six
    sides' extras, out, speed) and the stream as c_void_p; gamma double,
    coefficients float."""
    return _library("fused_rk_stage", "t8_fused_rk_stage",
                    _STAGE_ARGTYPES + [ctypes.c_void_p])


def _stage_physics_library(which: str) -> ctypes.CDLL:
    """The library of the stage's viscous ("viscous": mu > 0, gravity as
    a runtime switch) or gravity-only ("gravity") instantiations: the
    stage kernel's arguments, then the viscous weights' pointer, mu and
    kappa (float), gravity on (int), g_x, g_y, g_z (float) and the
    stream."""
    return _library(f"fused_rk_stage_{which}", f"t8_fused_rk_stage_{which}",
                    _STAGE_ARGTYPES + [ctypes.c_void_p, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_int]
                    + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def fused_rk_stage_attributes(dim: int, ext: int, flux: str = "kepes",
                              logs: bool = False, share_prev: bool = True,
                              extras: bool = False, viscous: bool = False,
                              gravity: bool = False, device: int = 0) -> dict:
    """The resources of the stage kernel of one case on a card (builds the
    library), as fused_muscl_attributes; `extras`: the instantiation that
    adds side extras; `viscous`: the one with the Navier-Stokes divergence
    (and the runtime gravity switch); `gravity` alone: the inviscid one
    with the gravity source."""
    case = [dim, ext, CUDA_FLUXES.index(flux), int(bool(logs)),
            int(bool(share_prev)), int(bool(extras))]
    if viscous or gravity:
        which = "viscous" if viscous else "gravity"
        return _attributes(_stage_physics_library(which),
                           f"t8_fused_rk_stage_{which}_attributes", device,
                           case)
    return _attributes(_stage_library(), "t8_fused_rk_stage_attributes",
                       device, case)


def _stage_update(u_rows, up_rows, weights, D, coeffs) -> torch.Tensor:
    """a*u_prev + b*u + c*w[7]*D per state row, in the TPU kernels'
    operation order; up_rows None means u_rows."""
    a_c, b_c, c_c = coeffs
    if up_rows is None:
        up_rows = u_rows
    cdt = c_c * weights[7]
    return torch.stack([a_c * up_rows[i] + b_c * u_rows[i] + cdt * D[i]
                        for i in range(5)])


def _lay_dt(row: torch.Tensor, d: int, inv_h: torch.Tensor) -> torch.Tensor:
    """Within-layer derivative of a layer row [*(ext,)*(dim-1), E] along
    layer axis d: central inside, one-sided at the layer borders."""
    n = row.shape[d]
    dif = row.narrow(d, 1, n - 1) - row.narrow(d, 0, n - 1)
    zpad = torch.zeros_like(row.narrow(d, 0, 1))
    d_hi = torch.cat([dif, zpad], dim=d)
    d_lo = torch.cat([zpad, dif], dim=d)
    li = torch.arange(n, device=row.device).reshape(
        (n,) + (1,) * (row.dim() - 1 - d))
    w_hi = (li < n - 1).to(row.dtype)
    w_lo = (li > 0).to(row.dtype)
    return (d_hi * w_hi + d_lo * w_lo) / (w_hi + w_lo) * inv_h


def _tile_viscous_divergence(q, others_q, wv, surface, dim: int, ext: int,
                             flux: str, mu: float, prandtl: float,
                             gamma: float) -> list:
    """The stage's Navier-Stokes divergence rows (a list of 5 [*blk]) to
    add to the advective divergence: the tile math of the TPU kernel
    (_tile_viscous_divergence, t8gpu_tpu/ops/pallas_kernels.py:914) over
    the whole element axis.  q: the cell-field rows [*blk]; others_q: per
    side the facing layer's field rows [*t_ext, E]; wv [8, E] the viscous
    weights; surface [E] the interior face area.  The scheme is
    ops/subgrid_viscous.viscous_divergence's with 1/h taken once and T =
    1/(rho/p) (kepes) or p/rho (hll/hllc) from the fields."""
    dtype = q[0].dtype
    blk = tuple(q[0].shape)
    kappa = mu * gamma / ((gamma - 1.0) * prandtl)
    inv_h = 1.0 / wv[0]
    eq = [wv[1 + k] for k in range(2 * dim)]

    def phi_rows(f):
        T = 1.0 / f[5] if flux == "kepes" else f[4] / f[0]
        return (f[1], f[2], f[3], T)

    phi = phi_rows(q)
    lay = [phi_rows(o) for o in others_q]

    def iota(a):
        return torch.arange(ext, device=q[0].device).reshape(
            (ext,) + (1,) * (dim - a))            # broadcasts along axis a

    def cell_dt(r, hi_row, lo_row, w_hi, w_lo, t):
        # mask-aware central derivative along block axis t; the outward
        # edge differences use the facing layers, eq-masked
        d_hi = _shift_next(r, hi_row, t, ext) - r
        d_lo = r - _shift_prev(r, lo_row, t, ext)
        it = iota(t)
        m_hi = torch.where(it == ext - 1, w_hi, 1.0)
        m_lo = torch.where(it == 0, w_lo, 1.0)
        return (d_hi * m_hi + d_lo * m_lo) / (m_hi + m_lo) * inv_h

    cell_d = [[cell_dt(phi[j], lay[2 * t][j], lay[2 * t + 1][j],
                       eq[2 * t], eq[2 * t + 1], t)
               for j in range(dim)] for t in range(dim)]

    zero_lay = torch.zeros(blk[1:], dtype=dtype, device=q[0].device)
    D = [torch.zeros(blk, dtype=dtype, device=q[0].device) for _ in range(5)]
    for a in range(dim):
        t_axes = [t for t in range(dim) if t != a]
        hi_lay, lo_lay = lay[2 * a], lay[2 * a + 1]
        w_hi_f = eq[2 * a] * surface                 # [E] face weights
        w_lo_f = eq[2 * a + 1] * surface
        at_end = iota(a) == ext - 1
        my_hi = [phi[j].select(a, ext - 1) for j in range(4)]
        my_lo = [phi[j].select(a, 0) for j in range(4)]

        # interfaces i+1/2 (i = ext-1: the hi mesh face)
        nxt = [_shift_next(phi[j], hi_lay[j], a, ext) for j in range(4)]
        dn = [(nxt[j] - phi[j]) * inv_h for j in range(4)]
        v_f = [0.5 * (phi[j] + nxt[j]) for j in range(dim)]
        face_dt = {}
        for t in t_axes:
            d_lay = t_axes.index(t)          # layer axis of tangent axis t
            rows = {}
            for j in {t, a}:
                interior = 0.5 * (cell_d[t][j]
                                  + _shift_next(cell_d[t][j], zero_lay, a,
                                                ext))
                mesh = 0.5 * (_lay_dt(my_hi[j], d_lay, inv_h).unsqueeze(a)
                              + _lay_dt(hi_lay[j], d_lay, inv_h).unsqueeze(a))
                rows[j] = torch.where(at_end, mesh, interior)
            face_dt[t] = rows

        div_f = dn[a] + sum(face_dt[t][t] for t in t_axes)
        tau = {a: mu * (2.0 * dn[a] - (2.0 / 3.0) * div_f)}
        for t in t_axes:
            tau[t] = mu * (dn[t] + face_dt[t][a])
        work = sum(v_f[j] * tau[j] for j in range(dim))
        heat = kappa * dn[3]
        wgt = torch.where(at_end, w_hi_f, surface)
        f = [torch.zeros(blk, dtype=dtype, device=q[0].device)]
        for j in range(3):
            f.append(tau[j] * wgt if j < dim else torch.zeros_like(f[0]))
        f.append((work + heat) * wgt)

        # the lo mesh face (layer-shaped)
        dn_lo = [(my_lo[j] - lo_lay[j]) * inv_h for j in range(4)]
        v_lo = [0.5 * (lo_lay[j] + my_lo[j]) for j in range(dim)]
        fdt_lo = {}
        for t in t_axes:
            d_lay = t_axes.index(t)
            fdt_lo[t] = {j: 0.5 * (_lay_dt(my_lo[j], d_lay, inv_h)
                                   + _lay_dt(lo_lay[j], d_lay, inv_h))
                         for j in {t, a}}
        div_lo = dn_lo[a] + sum(fdt_lo[t][t] for t in t_axes)
        tau_lo = {a: mu * (2.0 * dn_lo[a] - (2.0 / 3.0) * div_lo)}
        for t in t_axes:
            tau_lo[t] = mu * (dn_lo[t] + fdt_lo[t][a])
        work_lo = sum(v_lo[j] * tau_lo[j] for j in range(dim))
        heat_lo = kappa * dn_lo[3]
        f_lo = [torch.zeros_like(div_lo)]
        for j in range(3):
            f_lo.append(tau_lo[j] * w_lo_f if j < dim
                        else torch.zeros_like(div_lo))
        f_lo.append((work_lo + heat_lo) * w_lo_f)

        # D_visc[i] += f[i] - f[i-1]; f[-1] is the lo mesh-face flux (the
        # opposite sign pattern of the advective divergence)
        for i in range(5):
            prev = _shift_prev(f[i], f_lo[i], a, ext)
            D[i] = D[i] + f[i] - prev
    return D


def _cell_volume(surface: torch.Tensor, dim: int) -> torch.Tensor:
    """The cell volume from the interior face area w[0] (0 on guard
    slots): s*s in 2D, s*sqrt(s) in 3D."""
    return surface * surface if dim == 2 else surface * torch.sqrt(surface)


def fused_rk_stage_reference(u_stage: torch.Tensor, u_prev,
                             weights: torch.Tensor, others, gamma: float,
                             flux: str, coeffs, extra_sides=(), extras=(),
                             viscous_weights=None, mu: float = 0.0,
                             prandtl: float = 0.72,
                             gravity=(0.0, 0.0, 0.0)):
    """Plain PyTorch version of the stage: the tile math of the TPU
    kernel (_fused_rk_kernel / _tile_flux_divergence /
    _tile_viscous_divergence) over the whole element axis, for kepes, hll
    and hllc, from a 5-row state or (kepes) a 7-row state with its log
    rows: D = D_adv + D_visc (mu > 0), the side extras in side order,
    the gravity source times the cell volume, the update.  Same
    signature and result as fused_rk_stage; runs on any device and
    dtype."""
    dim, ext, E = _check_stage_shapes(u_stage, u_prev, weights, others,
                                      flux, extra_sides=extra_sides,
                                      extras=extras)
    viscous, g = _check_physics(viscous_weights, mu, prandtl, gravity, E)
    logs7 = u_stage.shape[0] == 7

    def fields(t):
        return cell_fields_tuple(_rows(t), gamma, flux,
                                 logs=(t[5], t[6]) if logs7 else None)

    def iface(l, r):
        return fields_flux(l, r, gamma=gamma, flux=flux)
    q = fields(u_stage)
    others_q = [fields(o) for o in others]
    D, speed = _first_order_divergence(q, others_q, weights, 5,
                                       fields_axis_rotate,
                                       flux_axis_unrotate, iface)
    if viscous:
        D = D + torch.stack(_tile_viscous_divergence(
            q, others_q, viscous_weights, weights[0], dim, ext, flux,
            float(mu), float(prandtl), gamma))
    D = _add_extras(D, extra_sides, extras)
    if any(c != 0.0 for c in g):
        from t8gpu_tpu_torch.ops.source import gravity_source
        D = D + gravity_source(_rows(u_stage), g) * _cell_volume(weights[0],
                                                                 dim)
    u_next = _stage_update(_rows(u_stage),
                           None if u_prev is None else _rows(u_prev),
                           weights, D, coeffs)
    return u_next, speed.amax(dim=tuple(range(dim)))


# -- the field-input kernels (kernels 2 and 6) -------------------------------


def _check_fields_inputs(q, u_prev, weights, others, flux, extra_sides=(),
                         extras=()):
    """Raise ValueError on inputs no version of the field-input kernels
    takes: q [C, ...] with the flux's C field rows.  Returns (dim, ext,
    E)."""
    if flux not in N_FIELDS:
        raise ValueError(f"unknown flux family: {flux}")
    return _check_stage_shapes(q, u_prev, weights, others, flux,
                               rows=(N_FIELDS[flux],),
                               extra_sides=extra_sides, extras=extras)


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
    (the neighbour's facing layer, the mirrored own layer on a wall side
    or the farfield ghost's fields on an open one), side k = 2*axis + (0
    hi, 1 lo).  CUDA tensors launch the kernel (kepes, hll, hllc), CPU
    tensors run fused_flux_reference."""
    dim, ext, E = _check_fields_inputs(q, None, weights, others, flux)
    dev = q.device
    if dev.type == "cpu":
        return fused_flux_reference(q, weights, others, gamma=gamma,
                                    flux=flux)
    if dev.type != "cuda":
        raise ValueError(f"no flux kernel for device {dev}")
    _check_cuda_tensors([q, weights, *others], flux, "flux", CUDA_FLUXES)

    D = torch.empty((5,) + q.shape[1:], dtype=q.dtype, device=dev)
    speed = _speed_bits(E, dev)
    _launch(_fields_library(), "t8_fused_fields", dev,
            [dim, ext, E, CUDA_FLUXES.index(flux), q.data_ptr(),
             weights.data_ptr(),
             *_side_pointers(others), D.data_ptr(), speed.data_ptr(),
             float(gamma)], "fused_flux")
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
                          extra_sides=(), extras=()):
    """One SSP-RK stage from cell-field rows: (u_next [5, *(ext,)*dim, E],
    speed [E]) with u_next = a*u_prev + b*u + c*w[7]*(D + extras), where D
    is fused_flux's divergence and u the state recovered from q.

    q, weights, others as fused_flux, with weight row 7 = dt *
    inv_cell_volume; flux "kepes" (10 field rows), "hll" or "hllc" (9);
    u_prev: [5, ...] state, or None (the first stage: the recovered state
    stands for it); extra_sides, extras as fused_rk_stage's.  CUDA
    tensors launch the kernel (a launch with extras counts in
    `launches_extras` too), CPU tensors run
    fused_rk_stage_fields_reference."""
    dim, ext, E = _check_fields_inputs(q, u_prev, weights, others, flux,
                                       extra_sides, extras)
    dev = q.device
    if dev.type == "cpu":
        return fused_rk_stage_fields_reference(q, u_prev, weights, others,
                                               gamma=gamma, flux=flux,
                                               coeffs=coeffs,
                                               extra_sides=extra_sides,
                                               extras=extras)
    if dev.type != "cuda":
        raise ValueError(f"no stage kernel for device {dev}")
    _check_cuda_tensors(_stage_tensors(q, u_prev, weights, others)
                        + list(extras), flux, "field stage", CUDA_FLUXES)

    out = torch.empty((5,) + q.shape[1:], dtype=q.dtype, device=dev)
    speed = _speed_bits(E, dev)
    a_c, b_c, c_c = (float(x) for x in coeffs)
    _launch(_stage_fields_library(), "t8_fused_rk_stage_fields", dev,
            [dim, ext, E, CUDA_FLUXES.index(flux), q.data_ptr(),
             None if u_prev is None else u_prev.data_ptr(),
             weights.data_ptr(), *_side_pointers(others),
             *_extras_pointers(extra_sides, extras), out.data_ptr(),
             speed.data_ptr(), float(gamma), a_c, b_c, c_c],
            "fused_rk_stage_fields")
    fused_rk_stage_fields.launches += 1
    if extras:
        fused_rk_stage_fields.launches_extras += 1
    return out, speed.view(torch.float32)


fused_rk_stage_fields.launches = 0
fused_rk_stage_fields.launches_extras = 0


def _fields_library() -> ctypes.CDLL:
    """The field-input divergence kernel's library: device, dim, ext, E,
    flux (the index in CUDA_FLUXES) as int; every pointer and the stream as
    c_void_p; gamma double."""
    return _library("fused_fields", "t8_fused_fields",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 10
                    + [ctypes.c_double, ctypes.c_void_p])


def _stage_fields_library() -> ctypes.CDLL:
    """The stage kernel's library with its field-input entry point:
    device, dim, ext, E, flux (the index in CUDA_FLUXES) as int; every
    pointer (q, u_prev, w, six sides, six sides' extras, out, speed) and
    the stream as c_void_p; gamma double, coefficients float."""
    return _library("fused_rk_stage", "t8_fused_rk_stage_fields",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 17
                    + [ctypes.c_double] + [ctypes.c_float] * 3
                    + [ctypes.c_void_p])


def fused_rk_stage_fields_attributes(dim: int, ext: int, flux: str = "kepes",
                                     share_prev: bool = True,
                                     extras: bool = False,
                                     device: int = 0) -> dict:
    """The resources of the field-input stage kernel of one case on a card
    (builds the library), as fused_rk_stage_attributes."""
    return _attributes(_stage_fields_library(),
                       "t8_fused_rk_stage_fields_attributes", device,
                       [dim, ext, CUDA_FLUXES.index(flux),
                        int(bool(share_prev)), int(bool(extras))])


def fused_rk_stage_fields_reference(q: torch.Tensor, u_prev,
                                    weights: torch.Tensor, others,
                                    gamma: float, flux: str, coeffs,
                                    extra_sides=(), extras=()):
    """Plain PyTorch version of the field-input stage: the tile math of
    the TPU kernel (_fused_rk_fields_kernel) over the whole element axis,
    for kepes, hll and hllc, with the side extras.  Same signature and
    result as fused_rk_stage_fields; runs on any device and dtype."""
    dim, _, _ = _check_fields_inputs(q, u_prev, weights, others, flux,
                                     extra_sides, extras)
    D, speed = _fields_divergence(q, weights, others, gamma, flux)
    D = _add_extras(D, extra_sides, extras)
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
    [E] (0 on dead slots).  Mesh faces and boundaries are the caller's.
    CUDA tensors launch the kernel (kepes, hll, hllc), CPU tensors run
    inner_divergence_reference."""
    dim, ext, E = _check_inner_inputs(u, volumes)
    dev = u.device
    if dev.type == "cpu":
        return inner_divergence_reference(u, volumes, gamma=gamma, flux=flux)
    if dev.type != "cuda":
        raise ValueError(f"no inner-divergence kernel for device {dev}")
    surface = interior_surface(volumes, dim, ext)
    _check_cuda_tensors([u, surface], flux, "inner divergence",
                        CUDA_FLUXES)

    D = torch.empty_like(u)
    speed = _speed_bits(1, dev)
    _launch(_inner_library(), "t8_inner_divergence", dev,
            [dim, ext, E, CUDA_FLUXES.index(flux), u.data_ptr(),
             surface.data_ptr(), D.data_ptr(), speed.data_ptr(),
             float(gamma)], "inner_divergence")
    inner_divergence.launches += 1
    return D, speed.view(torch.float32)[0]


inner_divergence.launches = 0


def _inner_library() -> ctypes.CDLL:
    """The inner-only kernel's library: device, dim, ext, E, flux (the
    index in CUDA_FLUXES) as int; every pointer and the stream as
    c_void_p; gamma double."""
    return _library("inner_divergence", "t8_inner_divergence",
                    [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                    + [ctypes.c_double, ctypes.c_void_p])


def inner_divergence_attributes(dim: int, ext: int, flux: str = "kepes",
                                device: int = 0) -> dict:
    """The resources of the inner-only kernel of one case on a card (builds
    the library), as fused_muscl_attributes."""
    return _attributes(_inner_library(), "t8_inner_divergence_attributes",
                       device, [dim, ext, CUDA_FLUXES.index(flux)])


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


def fused_mhd_flux_attributes(dim: int, ext: int, device: int = 0) -> dict:
    """The resources of the first-order MHD kernel at one shape on a card
    (builds the library), as fused_muscl_attributes."""
    return _attributes(_mhd_flux_library(), "t8_fused_mhd_flux_attributes",
                       device, [dim, ext])


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
