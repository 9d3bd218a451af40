"""Device GF(2) matrix product.

``mod2_matmul(h, v)`` is ``(h @ v) mod 2`` of a [m, n] 0/1 matrix and a
[n, B] 0/1 batch, as int32 {0, 1}.  On a card it is one hand-written kernel
(``csrc/gf2mat.cu``): a block packs 32 samples of every row of ``v`` into
one 32-bit word a row with warp ballots in shared memory, and each output
word is the XOR of the packed words of its row's nonzero columns, read from
the matrix's sliced row lists (``row_lists``, built on the card once a
matrix and kept while the matrix lives).  So the products read ``v`` once
and write the result once, whatever the row weights, and are exact whatever
the row sums.  ``v`` is read by its low bit as int32, uint8 or bool (other
dtypes convert first) and through its row stride where its samples are
contiguous.  A CUDA call launches the kernel or raises ValueError (a matrix
that is not 0/1, more than ``MAX_COLUMNS`` columns, mismatched shapes or
devices); there is no fallback.  CPU tensors take ``mod2_matmul_plain``, a
float32 matmul, which is also the kernel's oracle.  The counter
``gf2.launches`` (``obs``; always on) counts the card's calls, keyed by path
(``"kernel"``) and (rows, columns, batch).
"""

from __future__ import annotations

import weakref

import torch

from .. import obs

__all__ = ["mod2_matmul", "mod2_matmul_plain", "row_lists"]

SHARED_LIMIT = 232_448  # bytes of shared memory a block can have on sm_90 (227 KB)
MAX_COLUMNS = SHARED_LIMIT // 4 - 1  # the block's tile: a word a column and the zero word

# (id of the matrix's base tensor, view geometry) -> (weak reference to the
# base, its version when built, (slices, cols)): built once a matrix, dying
# with it; a bare data_ptr could name a freed matrix's reused memory
_ROWS: dict = {}


def mod2_matmul_plain(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(h @ v) mod 2`` as a float32 matmul, on any device: the CPU's path
    and the kernel's oracle.

    The product runs and accumulates in float32, as the JAX package's does
    (``preferred_element_type=float32``): sums of 0/1 products stay
    integer-exact up to 2^24.  A bfloat16 result would be exact only up to
    256, which the accounting products over the ``hx_perp``/``hz_perp`` rows
    can exceed.
    """
    prod = torch.matmul(h.to(torch.float32), v.to(torch.float32))
    return prod.to(torch.int32) & 1


def row_lists(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sliced row lists of a [m, n] 0/1 matrix, on its device: the rows
    in slices of 32, slice t as a [width_t, 32] table of columns, column k
    of its lane-th row at ``slices[t] + 32 k + lane`` (ascending along k;
    ``n``, the kernel's zero word, where the row holds fewer than the
    slice's heaviest row).  ``slices`` [ceil(m / 32) + 1] int32 offsets,
    ``cols`` int16 holding each column's uint16 bit pattern (the kernel
    reads uint16).  Raises ValueError for entries other than 0 and 1 or
    65536 columns or more.  Synchronises (the nonzeros' count)."""
    m, n = h.shape
    if n >= 1 << 16:
        raise ValueError(f"a matrix of {n} columns: the row lists hold uint16 columns and pads (at most 65535)")
    nz = h != 0
    if bool((nz & (h != 1)).any()):
        raise ValueError("a matrix with entries other than 0 and 1: the GF(2) product takes 0/1 matrices")
    dev = h.device
    weights = nz.sum(dim=1)
    count = -(-m // 32)
    widths = torch.nn.functional.pad(weights, (0, 32 * count - m)).view(count, 32).amax(dim=1)
    slices = torch.zeros(count + 1, dtype=torch.int64, device=dev)
    slices[1:] = torch.cumsum(32 * widths, dim=0)
    rows, columns = nz.nonzero(as_tuple=True)  # row-major: each row's columns ascending
    starts = torch.cumsum(weights, dim=0) - weights
    rank = torch.arange(rows.shape[0], device=dev) - starts[rows]
    cols = torch.full((int(slices[-1]),), n, dtype=torch.int32, device=dev)
    cols[slices[rows // 32] + 32 * rank + rows % 32] = columns.to(torch.int32)
    return slices.to(torch.int32), cols.to(torch.int16)


def _cached_rows(h: torch.Tensor):
    """``row_lists(h)``, built at h's first call and reused while h (or the
    tensor it views) lives and is not written in place."""
    base = h if h._base is None else h._base
    key = (id(base), h.storage_offset(), tuple(h.shape), tuple(h.stride()))
    hit = _ROWS.get(key)
    if hit is not None and hit[0]() is base and hit[1] == base._version:
        return hit[2]
    rows = row_lists(h)
    _ROWS[key] = (weakref.ref(base, lambda _, key=key: _ROWS.pop(key, None)), base._version, rows)
    return rows


def _launch(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The product as one kernel (csrc/gf2mat.cu) on the current stream.
    Raises ValueError for a call the kernel cannot take."""
    from .._build import load_kernels

    m, n = h.shape
    bsz = v.shape[1]
    if n > MAX_COLUMNS:
        raise ValueError(f"a product over {n} columns: the kernel's tile holds at most {MAX_COLUMNS}")
    if v.dtype == torch.bool:
        v = v.view(torch.uint8)
    elif v.dtype not in (torch.int32, torch.uint8):
        v = v.to(torch.int32)
    if v.stride(1) != 1 and bsz > 1:
        v = v.contiguous()
    out = torch.empty((m, bsz), dtype=torch.int32, device=v.device)
    if m == 0 or bsz == 0:
        return out
    if n == 0:
        return out.zero_()
    slices, cols = _cached_rows(h)
    lib = load_kernels()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.fgt_gf2_matmul_launch(v.data_ptr(), v.stride(0), v.element_size(), slices.data_ptr(),
                                        cols.data_ptr(), out.data_ptr(), m, n, bsz, stream)
    if err != 0:
        raise RuntimeError(f"GF(2) product kernel launch failed: {lib.fgt_cuda_error_string(err).decode()}")
    obs.count("gf2.launches", key=("kernel", m, n, bsz))
    return out


def mod2_matmul(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(h @ v) mod 2`` with ``h`` a [m, n] 0/1 matrix and ``v`` [n, B]:
    int32 in {0, 1}, on the card by the kernel, on the CPU by
    ``mod2_matmul_plain`` (the module docstring)."""
    if h.dim() != 2 or v.dim() != 2 or h.shape[1] != v.shape[0]:
        raise ValueError(f"a GF(2) product of shapes {tuple(h.shape)} and {tuple(v.shape)}: "
                         "it takes [m, n] and [n, B]")
    if h.device != v.device:
        raise ValueError(f"a GF(2) product of a matrix on {h.device} and a batch on {v.device}")
    if v.is_cuda:
        return _launch(h, v)
    return mod2_matmul_plain(h, v)
