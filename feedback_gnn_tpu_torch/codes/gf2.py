"""GF(2) linear algebra on the host.

The port of ``feedback_gnn_tpu/codes/gf2.py``: vectorised NumPy Gaussian
elimination, one masked XOR over all rows per pivot, and, for matrices of
64 x 64 entries or more, the bit-packed C++ core of ``native/`` (built with
g++ at first use; the same pivot choices and outputs, about 64x fewer word
operations), which ``use_native=False`` turns off.

These run once at code-construction time; nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["row_echelon", "rank", "kernel", "row_basis", "compute_code_distance", "inverse", "int2bin"]

NATIVE_MIN_ENTRIES = 64 * 64  # the JAX package's threshold for the C++ core


def row_echelon(mat: np.ndarray, reduced: bool = False, use_native: bool = True):
    """Gaussian elimination over GF(2); rank-deficient safe, no column swaps.

    Returns ``[row_ech_form, rank, transform, pivot_cols]`` with
    ``transform @ mat % 2 == row_ech_form``.  Matrices of at least
    NATIVE_MIN_ENTRIES entries go to the C++ core unless ``use_native`` is
    False; it raises RuntimeError where it cannot be built.
    """
    m, n = mat.shape
    if use_native and m * n >= NATIVE_MIN_ENTRIES:
        from .. import native

        return native.row_echelon_native(mat, reduced)
    mat = mat.astype(bool).copy()
    transform = np.eye(m, dtype=bool)
    pivot_row = 0
    pivot_cols = []

    for col in range(n):
        if not mat[pivot_row, col]:
            # bring a 1 (if any) from below up to the pivot row
            swap_row = pivot_row + int(np.argmax(mat[pivot_row:, col]))
            if mat[swap_row, col]:
                mat[[swap_row, pivot_row]] = mat[[pivot_row, swap_row]]
                transform[[swap_row, pivot_row]] = transform[[pivot_row, swap_row]]

        if mat[pivot_row, col]:
            # eliminate every other row holding a 1 in this column at once
            sel = mat[:, col].copy()
            if reduced:
                sel[pivot_row] = False
            else:
                sel[: pivot_row + 1] = False
            if sel.any():
                mat[sel] ^= mat[pivot_row]
                transform[sel] ^= transform[pivot_row]
            pivot_row += 1
            pivot_cols.append(col)

        if pivot_row >= m:
            break

    return [mat.astype(int), pivot_row, transform.astype(int), pivot_cols]


def rank(mat: np.ndarray) -> int:
    """Rank of a binary matrix over GF(2)."""
    return row_echelon(mat)[1]


def kernel(mat: np.ndarray):
    """Kernel of ``mat`` over GF(2): ``(ker, rank, pivot_cols)``, where the
    rows of ``ker`` span ``{x : mat @ x = 0 (mod 2)}`` and ``pivot_cols``
    indexes a row basis of ``mat``."""
    transpose = mat.T
    m = transpose.shape[0]
    _, rk, transform, pivot_cols = row_echelon(transpose)
    return transform[rk:m], rk, pivot_cols


def row_basis(mat: np.ndarray) -> np.ndarray:
    """Rows of ``mat`` forming a basis of its row space."""
    return mat[row_echelon(mat.T)[3]]


def compute_code_distance(mat: np.ndarray, is_pcm: bool = True, is_basis: bool = False):
    """Minimum weight of a nonzero codeword; with ``is_basis=True`` the
    minimum row weight of the given basis (the stabilizer-distance
    estimate ``CSSCode`` uses)."""
    gen = mat
    if is_pcm:
        gen = kernel(mat)[0]
    if len(gen) == 0:
        return np.inf
    cw = gen
    if not is_basis:
        cw = row_basis(gen)
    return int(np.min(np.sum(cw, axis=1)))


def inverse(mat: np.ndarray) -> np.ndarray:
    """Left inverse of a full-(column-)rank binary matrix."""
    m, n = mat.shape
    reduced_row_ech, rk, transform, _ = row_echelon(mat, reduced=True)
    if m == n and rk == m:
        return transform
    if m > rk and n == rk:
        return reduced_row_ech.T @ transform % 2
    raise ValueError(
        "Matrix is not invertible: need a full-rank square matrix or a "
        "rectangular matrix with full column rank."
    )


def int2bin(num: int, length: int) -> list:
    """Binary representation of ``num`` in ``length`` bits, most significant
    first (the column order of the Hamming constructor)."""
    if num < 0 or length < 0:
        raise ValueError(f"int2bin needs num >= 0 and length >= 0, got {num}, {length}")
    bin_str = format(num, f"0{length}b")[-length:] if length else ""
    return [int(x) for x in bin_str]
