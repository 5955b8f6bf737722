"""Morton (z-order) codes, vectorized NumPy (copy of t8gpu_tpu/mesh/morton.py).

Codes interleave coordinate bits x fastest: bit k of x lands at bit
dim*k of the code, matching z-order child numbering
child_id = x_bit + 2*y_bit + 4*z_bit.
"""

from __future__ import annotations

import numpy as np

_MAX_LEVEL = 21  # 21 bits/axis in 3D fits in 63 bits


def _part_bits(x: np.ndarray, dim: int) -> np.ndarray:
    """Spread the bits of x so consecutive bits are `dim` apart."""
    x = x.astype(np.uint64)
    if dim == 1:
        return x
    if dim == 2:
        x &= np.uint64(0x00000000FFFFFFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x
    if dim == 3:
        x &= np.uint64(0x00000000001FFFFF)
        x = (x | (x << np.uint64(32))) & np.uint64(0x001F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x001F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x
    raise ValueError(f"dim must be 1, 2 or 3, got {dim}")


def _compact_bits(x: np.ndarray, dim: int) -> np.ndarray:
    x = x.astype(np.uint64)
    if dim == 1:
        return x
    if dim == 2:
        x &= np.uint64(0x5555555555555555)
        x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
        x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
        return x
    if dim == 3:
        x &= np.uint64(0x1249249249249249)
        x = (x | (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x >> np.uint64(8))) & np.uint64(0x001F0000FF0000FF)
        x = (x | (x >> np.uint64(16))) & np.uint64(0x001F00000000FFFF)
        x = (x | (x >> np.uint64(32))) & np.uint64(0x00000000001FFFFF)
        return x
    raise ValueError(f"dim must be 1, 2 or 3, got {dim}")


def morton_encode(coords: np.ndarray, dim: int) -> np.ndarray:
    """[N, dim] integer coords -> [N] uint64 z-order codes."""
    coords = np.asarray(coords, np.uint64)
    code = np.zeros(coords.shape[0], np.uint64)
    for axis in range(dim):
        code |= _part_bits(coords[:, axis], dim) << np.uint64(axis)
    return code


def morton_decode(codes: np.ndarray, dim: int) -> np.ndarray:
    """[N] uint64 codes -> [N, dim] integer coords."""
    codes = np.asarray(codes, np.uint64)
    out = np.empty((len(codes), dim), np.int64)
    for axis in range(dim):
        out[:, axis] = _compact_bits(codes >> np.uint64(axis), dim).astype(np.int64)
    return out
