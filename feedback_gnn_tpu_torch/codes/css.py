"""CSS quantum code construction (host-side, NumPy).

The constructors of ``feedback_gnn_tpu/codes/css.py``: the ``CSSCode``
container, generalized-bicycle, hypergraph-product, Hamming, surface,
rotated-surface and checkerboard-toric, the quasi-cyclic generalized
hypergraph-product codes of the paper ([[882,24]] and [[1270,28]]),
bivariate-bicycle codes, an alist reader, and the two GB codes with
overcomplete check matrices, whose matrices the JAX package ships in
``feedback_gnn_tpu/codes/data/`` (read there by path).
"""

from __future__ import annotations

import os
from functools import reduce as _reduce

import numpy as np
from scipy.sparse import csr_matrix, hstack, identity, kron

from .. import REPO_ROOT
from .gf2 import compute_code_distance, int2bin, inverse, kernel, row_echelon

__all__ = [
    "CSSCode",
    "create_circulant_matrix",
    "create_generalized_bicycle_codes",
    "hypergraph_product",
    "hamming_code",
    "rep_code",
    "create_surface_codes",
    "create_rotated_surface_codes",
    "create_checkerboard_toric_codes",
    "create_QC_GHP_codes",
    "create_cyclic_permuting_matrix",
    "create_bivariate_QC_codes",
    "read_alist",
    "gb_n48_k6_d8_oc",
    "gb_n46_k2_d9_oc",
    "ghp_882_24",
    "ghp_1270_28",
]


class CSSCode:
    """Container for a CSS code defined by X/Z parity-check matrices:
    ``hx, hz, hx_perp, hz_perp, hx_basis, hz_basis, rank_hx, rank_hz,
    pivot_hx, pivot_hz, lx, lz, N, K, D, L, Q, name``."""

    def __init__(
        self,
        hx: np.ndarray = np.array([[]]),
        hz: np.ndarray = np.array([[]]),
        code_distance=np.nan,
        name: str | None = None,
        name_prefix: str = "",
        check_css: bool = False,
    ):
        self.hx = np.asarray(hx, dtype=np.int64)
        self.hz = np.asarray(hz, dtype=np.int64)

        _, nx = self.hx.shape
        _, nz = self.hz.shape
        if nx != nz:
            raise ValueError("hx and hz should have equal number of columns")
        if nx == 0:
            raise ValueError("number of variable nodes should not be zero")
        if check_css and np.any(self.hx @ self.hz.T % 2):
            raise ValueError("CSS constraint not satisfied")

        self.N = nx
        # orthogonal complements: hx_perp = ker(hx) ⊇ Im(hz^T) ∪ logicals
        self.hx_perp, self.rank_hx, self.pivot_hx = kernel(self.hx)
        self.hz_perp, self.rank_hz, self.pivot_hz = kernel(self.hz)
        self.hx_basis = self.hx[self.pivot_hx]
        self.hz_basis = self.hz[self.pivot_hz]
        self.K = self.N - self.rank_hx - self.rank_hz

        self.L = int(max(np.max(np.sum(self.hx, axis=0)), np.max(np.sum(self.hz, axis=0))))
        self.Q = int(max(np.max(np.sum(self.hx, axis=1)), np.max(np.sum(self.hz, axis=1))))
        self._compute_logicals()

        self.D = code_distance
        if isinstance(code_distance, float) and np.isnan(code_distance):
            # distance of the *stabilizers*, as in the JAX package
            dx = compute_code_distance(self.hx_perp, is_pcm=False, is_basis=True)
            dz = compute_code_distance(self.hz_perp, is_pcm=False, is_basis=True)
            self.D = min(dx, dz)

        self.name = f"{name_prefix}_n{self.N}_k{self.K}" if name is None else name

    def _compute_logicals(self):
        # row reduce [Im(h^T); ker] and keep the pivots landing in the kernel block
        def compute_log_ops(ker_h, im_hT):
            log_stack = np.vstack([im_hT, ker_h])
            pivots = row_echelon(log_stack.T)[3]
            log_op_indices = [i for i in range(im_hT.shape[0], log_stack.shape[0]) if i in pivots]
            return log_stack[log_op_indices]

        self.lx = compute_log_ops(self.hz_perp, self.hx_basis)
        self.lz = compute_log_ops(self.hx_perp, self.hz_basis)

    def canonical_logicals(self):
        """Make lx @ lz.T == I (mod 2)."""
        self.lx = inverse(self.lx @ self.lz.T % 2) @ self.lx % 2

    def __repr__(self):
        return f"CSSCode(name={self.name!r}, N={self.N}, K={self.K}, D<={self.D})"


def create_circulant_matrix(l: int, pows) -> np.ndarray:
    """l x l circulant with ones at (i+c) % l for each shift c."""
    h = np.zeros((l, l), dtype=int)
    for i in range(l):
        for c in pows:
            h[(i + c) % l, i] = 1
    return h


def create_generalized_bicycle_codes(l, a, b, name=None) -> CSSCode:
    """hx=[A,B], hz=[B^T,A^T] from circulants."""
    A = create_circulant_matrix(l, a)
    B = create_circulant_matrix(l, b)
    return CSSCode(np.hstack((A, B)), np.hstack((B.T, A.T)), name=name, name_prefix="GB")


def hypergraph_product(h1, h2, name=None) -> CSSCode:
    """Hypergraph product of two classical PCMs via Kronecker products."""
    h1s = csr_matrix(np.asarray(h1))
    h2s = csr_matrix(np.asarray(h2))
    m1, n1 = h1s.shape
    m2, n2 = h2s.shape
    hx = hstack([kron(h1s, identity(n2, dtype=int)), kron(identity(m1, dtype=int), h2s.T)])
    hz = hstack([kron(identity(n1, dtype=int), h2s), kron(h1s.T, identity(m2, dtype=int))])
    return CSSCode(hx.toarray(), hz.toarray(), name=name, name_prefix="HP")


def hamming_code(r: int) -> np.ndarray:
    """[2^r - 1, 2^r - 1 - r] Hamming PCM: column i is i + 1 in binary."""
    r = int(r)
    num_cols = (2**r) - 1
    pcm = np.zeros((num_cols, r), dtype=int)
    for i in range(num_cols):
        pcm[i] = int2bin(i + 1, r)
    return pcm.T


def rep_code(d: int) -> np.ndarray:
    """(d-1) x d repetition-code PCM."""
    pcm = np.zeros((d - 1, d), dtype=int)
    for i in range(d - 1):
        pcm[i, i] = 1
        pcm[i, i + 1] = 1
    return pcm


def create_surface_codes(n: int) -> CSSCode:
    """[n^2 + (n-1)^2, 1, n] surface code as HGP of repetition codes."""
    h = rep_code(n)
    return hypergraph_product(h, h, f"Surface_n{n**2 + (n - 1) ** 2}_k{1}_d{n}")


def _set_pcm_row(n, pcm, row_idx, i, j):
    """The weight-4 check on the plaquette at (i, j) of an n x n torus."""
    i1, j1 = (i + 1) % n, (j + 1) % n
    pcm[row_idx][i * n + j] = pcm[row_idx][i1 * n + j1] = 1
    pcm[row_idx][i1 * n + j] = pcm[row_idx][i * n + j1] = 1


def create_rotated_surface_codes(n: int, name=None) -> CSSCode:
    """Rotated surface code of distance n (odd)."""
    if n % 2 != 1:
        raise ValueError("n should be odd")
    n2 = n * n
    m = (n2 - 1) // 2
    hx = np.zeros((m, n2), dtype=int)
    hz = np.zeros((m, n2), dtype=int)
    x_idx = z_idx = 0
    for i in range(n - 1):
        for j in range(n - 1):
            if (i + j) % 2 == 0:  # Z check
                _set_pcm_row(n, hz, z_idx, i, j)
                z_idx += 1
            else:  # X check
                _set_pcm_row(n, hx, x_idx, i, j)
                x_idx += 1
    # upper and lower boundary, weight-2 X checks
    for j in range(n - 1):
        if j % 2 == 0:
            hx[x_idx][j] = hx[x_idx][j + 1] = 1
        else:
            hx[x_idx][(n - 1) * n + j] = hx[x_idx][(n - 1) * n + (j + 1)] = 1
        x_idx += 1
    # left and right boundary, weight-2 Z checks
    for i in range(n - 1):
        if i % 2 == 0:
            hz[z_idx][i * n + (n - 1)] = hz[z_idx][(i + 1) * n + (n - 1)] = 1
        else:
            hz[z_idx][i * n] = hz[z_idx][(i + 1) * n] = 1
        z_idx += 1
    return CSSCode(hx, hz, name=name, name_prefix="Rotated_Surface")


def create_checkerboard_toric_codes(n: int, name=None) -> CSSCode:
    """Checkerboard toric code on an n x n torus (n even)."""
    if n % 2 != 0:
        raise ValueError("n should be even")
    n2 = n * n
    hx = np.zeros((n2 // 2, n2), dtype=int)
    hz = np.zeros((n2 // 2, n2), dtype=int)
    x_idx = z_idx = 0
    for i in range(n):
        for j in range(n):
            if (i + j) % 2 == 0:
                _set_pcm_row(n, hz, z_idx, i, j)
                z_idx += 1
            else:
                _set_pcm_row(n, hx, x_idx, i, j)
                x_idx += 1
    return CSSCode(hx, hz, name=name, name_prefix="Toric")


def create_QC_GHP_codes(l, a, b, name=None) -> CSSCode:
    """Quasi-cyclic generalized hypergraph product codes: hx = [A, B],
    hz = [B^T, A^T] with A from the shift matrix ``a`` (-1 = zero block)
    and B = I (x) circ(b)."""
    a = np.asarray(a)
    m, n = a.shape
    zero = np.zeros((l, l), dtype=int)
    A = np.block([[create_circulant_matrix(l, [s]) if s >= 0 else zero for s in row] for row in a])
    temp_b = create_circulant_matrix(l, b)
    hx = np.hstack((A, np.kron(np.identity(m, dtype=int), temp_b)))
    hz = np.hstack((np.kron(np.identity(n, dtype=int), temp_b.T), A.T))
    return CSSCode(hx, hz, name=name, name_prefix="GHP")


def create_cyclic_permuting_matrix(n, shifts) -> np.ndarray:
    """Shift matrix for the QC-GHP construction."""
    A = np.full((n, n), -1, dtype=int)
    for i, s in enumerate(shifts):
        for j in range(n):
            A[j, (j - i) % n] = s
    return A


def create_bivariate_QC_codes(l, m, A_x_pows, A_y_pows, B_x_pows, B_y_pows, name=None) -> CSSCode:
    """Bivariate-bicycle codes: A and B sums of powers of x = S_l (x) I_m
    and y = I_l (x) S_m, hx = [A, B], hz = [B^T, A^T]."""
    S_l = create_circulant_matrix(l, [-1])
    S_m = create_circulant_matrix(m, [-1])
    x = kron(csr_matrix(S_l), identity(m, dtype=int))
    y = kron(identity(l, dtype=int), csr_matrix(S_m))
    A = _reduce(lambda u, v: u + v, [x**p for p in A_x_pows] + [y**p for p in A_y_pows]).toarray()
    B = _reduce(lambda u, v: u + v, [x**p for p in B_x_pows] + [y**p for p in B_y_pows]).toarray()
    return CSSCode(np.hstack((A, B)), np.hstack((B.T, A.T)), name=name, name_prefix="IBM")


def read_alist(path: str) -> np.ndarray:
    """A PCM in alist format, as a 0/1 int array."""
    with open(path, "r") as f:
        lines = [list(map(int, line.rstrip().split(" "))) for line in f.readlines()]
    n_cols, n_rows = lines[0]
    start = 4 if len(lines[2]) == n_cols and len(lines[3]) == n_rows else 2
    mat = np.zeros((n_rows, n_cols), dtype=int)
    for col, nonzeros in enumerate(lines[start : start + n_cols]):
        for row_index in nonzeros:
            if row_index != 0:
                mat[row_index - 1, col] = 1
    return mat


def _load_data_pcm(name: str) -> np.ndarray:
    """A check matrix the JAX package ships (feedback_gnn_tpu/codes/data/)."""
    path = os.path.join(REPO_ROOT, "feedback_gnn_tpu", "codes", "data", name + ".npz")
    with np.load(path) as data:
        return data["pcm"].astype(int)


def gb_n48_k6_d8_oc() -> CSSCode:
    """[[48,6,8]] GB code with the overcomplete 2000-row check matrices of
    Panteleev and Kalachev."""
    pcm = _load_data_pcm("GB_48_6_H_2000")
    return CSSCode(pcm[:1000], pcm[1000:], name="GB_n48_k6_d8_oc")


def gb_n46_k2_d9_oc() -> CSSCode:
    """[[46,2,9]] GB code with the overcomplete 800-row check matrices."""
    pcm = _load_data_pcm("GB_46_2_H_800")
    return CSSCode(pcm[:400], pcm[400:], name="GB_n46_k2_d9_oc")


def ghp_882_24() -> CSSCode:
    """The [[882,24]] QC-GHP code of arXiv:2310.17758."""
    return create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]), [0, 1, 6])


def ghp_1270_28() -> CSSCode:
    """The [[1270,28]] QC-GHP code of arXiv:2310.17758."""
    a = np.array(
        [
            [0, -1, 51, 52, -1],
            [-1, 0, -1, 111, 20],
            [0, -1, 98, -1, 122],
            [0, 80, -1, 119, -1],
            [-1, 0, 5, -1, 106],
        ]
    )
    return create_QC_GHP_codes(127, a, [0, 1, 7])
